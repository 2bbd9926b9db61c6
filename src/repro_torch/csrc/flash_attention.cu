// Tiled online-softmax attention for Hopper (sm_90a), forward only.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (the Pallas kernel behind flash_attention_bhsd /
// ops.flash_attention).
// Computes: softmax(q k^T / sqrt(hd) [+ causal mask]) v per (batch, head)
// without ever writing the S x S scores to device memory.  Inputs are
// cast to f32, q is scaled first, masked scores are -1e30, the running
// (m, l, acc) are f32 and the denominator is clamped at 1e-20 -- the
// constants of the reference.  q/k/v/o: (B, S, H, hd), K/V already
// repeated to the query heads, f32 or bf16.
//
// Bound on this card: operations.  4*S*S*hd flops per (batch, head)
// (half of that when causal) against 4*S*hd elements moved; at S = 1024,
// hd = 64 that is hundreds of flops per byte.  All math is f32 on the
// CUDA cores, as the reference computes in f32, so the rate to hold it
// against is the card's f32 rate, not the tensor cores'.
//
// Design.  The reference keeps (m, l, acc) in scratch memory across a
// sequential last grid axis; blocks here run in no order, so one block
// owns a (batch, head, q-tile) and LOOPS over the KV tiles up to the
// causal limit.  A KV tile (block_kv rows of K and of V, in their stored
// dtype) is staged through shared memory once per pass and read by every
// thread of the block.  The q rows, (m, l) and acc live in registers: a
// query row is split over TPR neighbouring lanes (16 dims each, the dot
// product finished with xor shuffles), and each thread carries 2 rows.
// TPR is hd/16 rounded up to a power of two, so the shuffles pair lanes
// of one row at every head dim that is a multiple of 16 up to 256: at hd
// 112 a row has 8 lanes, of which the 8th holds dims 112..127, which do
// not exist -- such a lane loads nothing, contributes 0 to the dot
// product and stores nothing (hd 192: 16 lanes, 4 idle).  256 threads
// cover a pass of 512/TPR query rows; a logical q tile larger than that
// is walked in such passes.  Scores are formed 8 keys at a time so acc
// is rescaled once per 8 keys.  Ragged edges are masked here: any S >= 1
// and any tile size >= 1 is right.  Warps whose rows all lie before a
// chunk of keys skip it (causal).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kDims = 16;   // head dims per thread
constexpr int kRows = 2;    // query rows per thread
constexpr int kChunk = 8;   // keys per softmax update

__device__ __forceinline__ void load16(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v = reinterpret_cast<const float4*>(p)[i];
    out[4 * i + 0] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[8 * i + j] = __bfloat162float(e[j]);
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[8 * i + j]);
    reinterpret_cast<uint4*>(p)[i] = raw;
  }
}

// Lanes per query row: hd/16 rounded up to a power of two.
__host__ __device__ constexpr int lanes_per_row(int hd) {
  int t = 1;
  while (t * kDims < hd) t *= 2;
  return t;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int block_q, int block_kv, int causal, float scale) {
  constexpr int TPR = lanes_per_row(HD);     // lanes per query row
  constexpr int GROUPS = kThreads / TPR;     // row groups per block
  constexpr int PASS = GROUPS * kRows;       // query rows per pass
  constexpr int VPR = HD * sizeof(T) / 16;   // 16-byte vectors per row

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)block_kv * HD;

  const int tid = threadIdx.x;
  const int slice = tid % TPR;
  const int group = tid / TPR;
  const bool active = slice * kDims < HD;    // this lane's dims exist
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = ((size_t)b * S * H + h) * HD;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* ob = o + base;

  const int tile_start = blockIdx.x * block_q;
  const int tile_end = min(S, tile_start + block_q);

  for (int pass_start = tile_start; pass_start < tile_end;
       pass_start += PASS) {
    const int pass_end = min(pass_start + PASS, tile_end);
    const int r0 = pass_start + group * kRows;
    // last query row held by this warp: chunks of keys after it are skipped
    const int warp_last =
        min(pass_end, pass_start + (warp + 1) * (32 / TPR) * kRows) - 1;

    float qf[kRows][kDims], acc[kRows][kDims], m[kRows], l[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
      if (r0 + r < pass_end && active) {
        load16(qb + (size_t)(r0 + r) * row_stride + slice * kDims, qf[r]);
      } else {
#pragma unroll
        for (int d = 0; d < kDims; ++d) qf[r][d] = 0.f;
      }
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        qf[r][d] *= scale;
        acc[r][d] = 0.f;
      }
    }

    // keys [0, kv_end) can be seen by some row of this pass
    const int kv_end = causal ? pass_end : S;
    for (int t0 = 0; t0 < kv_end; t0 += block_kv) {
      const int tn = min(block_kv, kv_end - t0);
      __syncthreads();   // the previous tile is no longer being read
      for (int i = tid; i < tn * VPR; i += kThreads) {
        const int r = i / VPR, c = i % VPR;
        const size_t src = (size_t)(t0 + r) * row_stride;
        reinterpret_cast<uint4*>(ks)[i] =
            reinterpret_cast<const uint4*>(kb + src)[c];
        reinterpret_cast<uint4*>(vs)[i] =
            reinterpret_cast<const uint4*>(vb + src)[c];
      }
      __syncthreads();

      for (int j0 = 0; j0 < tn; j0 += kChunk) {
        if (causal && t0 + j0 > warp_last) break;   // warp-uniform
        const int cnt = min(kChunk, tn - j0);
        float s[kRows][kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          float s0 = 0.f, s1 = 0.f;
          if (c < cnt && active) {
            float kf[kDims];
            load16(ks + (size_t)(j0 + c) * HD + slice * kDims, kf);
#pragma unroll
            for (int d = 0; d < kDims; ++d) {
              s0 = fmaf(qf[0][d], kf[d], s0);
              s1 = fmaf(qf[1][d], kf[d], s1);
            }
          }
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          const int col = t0 + j0 + c;
          const bool live = c < cnt;
          s[0][c] = (live && (!causal || col <= r0)) ? s0 : kNegInf;
          s[1][c] = (live && (!causal || col <= r0 + 1)) ? s1 : kNegInf;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float mx = s[r][0];
#pragma unroll
          for (int c = 1; c < kChunk; ++c) mx = fmaxf(mx, s[r][c]);
          const float m_new = fmaxf(m[r], mx);
          const float corr = expf(m[r] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            s[r][c] = expf(s[r][c] - m_new);
            psum += s[r][c];
          }
          l[r] = corr * l[r] + psum;
          m[r] = m_new;
#pragma unroll
          for (int d = 0; d < kDims; ++d) acc[r][d] *= corr;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (c < cnt && active) {
            float vf[kDims];
            load16(vs + (size_t)(j0 + c) * HD + slice * kDims, vf);
#pragma unroll
            for (int d = 0; d < kDims; ++d) {
              acc[0][d] = fmaf(s[0][c], vf[d], acc[0][d]);
              acc[1][d] = fmaf(s[1][c], vf[d], acc[1][d]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r < pass_end && active) {
        const float inv = 1.f / fmaxf(l[r], 1e-20f);
        float out[kDims];
#pragma unroll
        for (int d = 0; d < kDims; ++d) out[d] = acc[r][d] * inv;
        store16(ob + (size_t)(r0 + r) * row_stride + slice * kDims, out);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int block_q, int block_kv, int causal,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block_kv * HD * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + block_q - 1) / block_q, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, block_q, block_kv,
      causal, scale);
  return cudaGetLastError();
}

// hd: any multiple of 16 up to 256, each its own instantiation.
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int hd, int block_q,
                        int block_kv, int causal, cudaStream_t stream) {
  switch (hd) {
#define RT_HD(D)                                                          \
  case D:                                                                 \
    return launch<T, D>(q, k, v, o, B, S, H, block_q, block_kv, causal, \
                        stream);
    RT_HD(16) RT_HD(32) RT_HD(48) RT_HD(64) RT_HD(80) RT_HD(96) RT_HD(112)
    RT_HD(128) RT_HD(144) RT_HD(160) RT_HD(176) RT_HD(192) RT_HD(208)
    RT_HD(224) RT_HD(240) RT_HD(256)
#undef RT_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int H, int hd,
                                  int block_q, int block_kv, int causal,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || block_q <= 0 || block_kv <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, hd,
                                                    block_q, block_kv, causal,
                                                    s)
                       : dispatch_hd<float>(q, k, v, o, B, S, H, hd, block_q,
                                            block_kv, causal, s));
}
