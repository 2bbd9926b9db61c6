// Fill the shared memory of every SM with NaN: a check, not a kernel of
// any model path.
//
// A kernel that reads a word of shared memory it did not write (a copy
// whose zero-fill did not happen, an index past what was staged) reads
// whatever the SM's last block left there, which is usually a finite
// number and so hard to see.  Launched just before a kernel under test,
// this leaves NaN in every word a block of that kernel can be given, so
// such a read shows as a non-finite output.  One block per SM: each
// block takes the largest dynamic shared memory a block may have on this
// card, so no two fit on one SM, and twice as many blocks as SMs are
// launched so that every SM runs at least one.  The stores are volatile:
// nothing reads them back, and plain stores could be dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void smem_poison_kernel(int words) {
  extern __shared__ uint32_t smem_words[];
  volatile uint32_t* w = smem_words;
  for (int k = threadIdx.x; k < words; k += blockDim.x) w[k] = 0x7fc00000u;
  __syncthreads();
}

}  // namespace

// Launch the fill on `stream` over the current device; returns the
// cudaError_t of the launch.
extern "C" int rt_smem_poison(void* stream) {
  int dev = 0, bytes = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(smem_poison_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  smem_poison_kernel<<<2 * sms, 1024, bytes,
                       static_cast<cudaStream_t>(stream)>>>(bytes / 4);
  return (int)cudaGetLastError();
}
