// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (the
// Pallas kernel behind rmsnorm_2d / ops.rmsnorm).
// Computes: y = x * rsqrt(mean(x^2) + eps) * scale, math in f32, output
// in x's dtype.  x is f32 or bf16; scale is f32 or bf16 independently.
//
// Bound on this card: bytes.  About 3 operations per element against
// 2 * sizeof(x) bytes moved, far below the card's operations-per-byte
// ridge, so the least time is (read x once + write y once) / bandwidth.
//
// Design: one warp owns one row, so the reduction is five shuffles and
// needs no shared memory or block barrier; a block carries several
// warps (rows) only to fill the SM.  Rows are independent, so any row
// count works (the row block of the reference has no counterpart
// here).  Loads and stores are 16 bytes per lane when d and the
// pointers allow it (d = 576 in bf16 is 72 such loads per row), else
// scalar.  x is read from device memory once; the second pass over the
// row comes out of L1/L2, the row having just been read by the same
// warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// VEC: elements of X per 16-byte access (4 for f32, 8 for bf16); 1 = scalar.
template <typename X, typename S, int VEC>
__global__ void rmsnorm_kernel(const X* __restrict__ x,
                               const S* __restrict__ scale,
                               X* __restrict__ y, int rows, int d,
                               float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together; no barrier below
  const X* xr = x + (size_t)row * d;
  X* yr = y + (size_t)row * d;

  float ss = 0.f;
  if (VEC > 1) {
    const int nvec = d / VEC;
    for (int i = lane; i < nvec; i += 32) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + (size_t)i * VEC);
      const X* e = reinterpret_cast<const X*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)d + eps);

  if (VEC > 1) {
    const int nvec = d / VEC;
    for (int i = lane; i < nvec; i += 32) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + (size_t)i * VEC);
      const X* e = reinterpret_cast<const X*>(&raw);
      uint4 outv;
      X* o = reinterpret_cast<X*>(&outv);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        from_f32(to_f32(e[j]) * inv * to_f32(scale[i * VEC + j]), o + j);
      *reinterpret_cast<uint4*>(yr + (size_t)i * VEC) = outv;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      from_f32(to_f32(xr[i]) * inv * to_f32(scale[i]), yr + i);
  }
}

template <typename X, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(X);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const bool aligned = (d % kVec == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (aligned)
    rmsnorm_kernel<X, S, kVec><<<grid, block, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const S*>(scale),
        static_cast<X*>(y), rows, d, eps);
  else
    rmsnorm_kernel<X, S, 1><<<grid, block, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const S*>(scale),
        static_cast<X*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, int rows,
                          int d, float eps, int x_is_bf16, int scale_is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_is_bf16) {
    return (int)(scale_is_bf16
                     ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows,
                                                            d, eps, s)
                     : launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps,
                                                    s));
  }
  return (int)(scale_is_bf16
                   ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, s)
                   : launch<float, float>(x, scale, y, rows, d, eps, s));
}
