// Tiled online-softmax attention for Hopper (sm_90a), forward only: the
// entry point.  Both kernels run on the tensor cores with tiles of their
// own at every S: bf16 inputs go to flash_attention_tc.cu (bf16 mma),
// f32 inputs to flash_attention_f32.cu (three TF32 mma per f32 product).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (the Pallas kernel behind flash_attention_bhsd /
// ops.flash_attention).
// Computes: softmax(q k^T / sqrt(hd) [+ causal mask]) v per (batch, head)
// without ever writing the S x S scores to device memory.  q/k/v/o:
// (B, S, H, hd), K/V already repeated to the query heads.
#include <cuda_runtime.h>

// flash_attention_tc.cu
cudaError_t rt_flash_tc_launch(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int hd,
                               int causal, cudaStream_t stream);
int rt_flash_tc_smem(int hd);
// flash_attention_f32.cu
cudaError_t rt_flash_f32_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int H, int hd,
                                int causal, cudaStream_t stream);
int rt_flash_f32_smem(int hd);

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int H, int hd,
                                  int causal, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? rt_flash_tc_launch(q, k, v, o, B, S, H, hd, causal,
                                            s)
                       : rt_flash_f32_launch(q, k, v, o, B, S, H, hd, causal,
                                             s));
}

// Shared memory one block of the kernel for (hd, dtype) asks for, in
// bytes; -1 for an hd that no kernel takes.
extern "C" int rt_flash_attention_smem(int hd, int is_bf16) {
  return is_bf16 ? rt_flash_tc_smem(hd) : rt_flash_f32_smem(hd);
}
