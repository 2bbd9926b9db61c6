// Tiled online-softmax attention for Hopper (sm_90a), forward only:
// the f32 path and the entry point.  The bf16 path, on the tensor cores,
// is flash_attention_tc.cu.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (the Pallas kernel behind flash_attention_bhsd /
// ops.flash_attention).
// Computes: softmax(q k^T / sqrt(hd) [+ causal mask]) v per (batch, head)
// without ever writing the S x S scores to device memory.  q is scaled
// first, masked scores are -1e30, the running (m, l, acc) are f32 and the
// denominator is clamped at 1e-20 -- the constants of the reference.
// q/k/v/o: (B, S, H, hd), K/V already repeated to the query heads.
//
// The entry point dispatches on the dtype: bf16 goes to the tensor-core
// kernel, f32 to the CUDA-core kernel below (the reference computes in
// f32, and the tensor cores have no f32 operands; TF32 would not hold
// the 2e-5 of the f32 checks).
//
// Bound of the f32 kernel on this card: operations.  4*S*S*hd flops per
// (batch, head) (half of that when causal) against 4*S*hd elements
// moved; all math is f32 on the CUDA cores, so the rate to hold it
// against is the card's f32 rate.
//
// Design of the f32 kernel.  The reference keeps (m, l, acc) in scratch
// memory across a sequential last grid axis; blocks here run in no
// order, so one block owns a (batch, head, q-tile) and LOOPS over the KV
// tiles up to the causal limit.  A KV tile (block_kv rows of K and of V)
// is staged through shared memory once per pass and read by every thread
// of the block.  The q rows, (m, l) and acc live in registers: a query
// row is split over TPR neighbouring lanes (16 dims each, the dot
// product finished with xor shuffles), and each thread carries 2 rows.
// TPR is hd/16 rounded up to a power of two, so the shuffles pair lanes
// of one row at every head dim that is a multiple of 16 up to 256: at hd
// 112 a row has 8 lanes, of which the 8th holds dims 112..127, which do
// not exist -- such a lane loads nothing, contributes 0 to the dot
// product and stores nothing (hd 192: 16 lanes, 4 idle).  256 threads
// cover a pass of 512/TPR query rows; a q tile larger than that is
// walked in such passes.  Scores are formed 8 keys at a time so acc is
// rescaled once per 8 keys.  Ragged edges are masked here: any S >= 1
// and any tile size >= 1 is right.  Warps whose rows all lie before a
// chunk of keys skip it (causal).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// flash_attention_tc.cu
cudaError_t rt_flash_tc_launch(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int hd,
                               int causal, cudaStream_t stream);
int rt_flash_tc_smem(int hd);

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

__device__ __forceinline__ void store16(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Lanes per query row: hd/16 rounded up to a power of two.
__host__ __device__ constexpr int lanes_per_row(int hd) {
  int t = 1;
  while (t * kDims < hd) t *= 2;
  return t;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S,
             int H, int block_q, int block_kv, int causal, float scale) {
  constexpr int TPR = lanes_per_row(HD);     // lanes per query row
  constexpr int GROUPS = kThreads / TPR;     // row groups per block
  constexpr int PASS = GROUPS * kRows;       // query rows per pass
  constexpr int VPR = HD * sizeof(float) / 16;   // 16-byte vectors per row

  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)block_kv * HD;

  const int tid = threadIdx.x;
  const int slice = tid % TPR;
  const int group = tid / TPR;
  const bool active = slice * kDims < HD;    // this lane's dims exist
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = ((size_t)b * S * H + h) * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* ob = o + base;

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

size_t f32_smem(int block_kv, int hd) {
  return 2 * (size_t)block_kv * hd * sizeof(float);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int block_q, int block_kv,
                       int causal, cudaStream_t stream) {
  const size_t smem = f32_smem(block_kv, HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + block_q - 1) / block_q, H, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, block_q,
      block_kv, causal, scale);
  return cudaGetLastError();
}

// hd: any multiple of 16 up to 256, each its own instantiation.
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int hd, int block_q,
                         int block_kv, int causal, cudaStream_t stream) {
  switch (hd) {
#define RT_HD(D)                                                          \
  case D:                                                                 \
    return launch_f32<D>(q, k, v, o, B, S, H, block_q, block_kv, causal,  \
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

// block_q / block_kv are the f32 kernel's tiles; the bf16 kernel runs its
// own (flash_attention_tc.cu) and does not read them.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int H, int hd,
                                  int block_q, int block_kv, int causal,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || block_q <= 0 || block_kv <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? rt_flash_tc_launch(q, k, v, o, B, S, H, hd, causal,
                                            s)
                       : dispatch_f32(q, k, v, o, B, S, H, hd, block_q,
                                      block_kv, causal, s));
}

// Shared memory one block of the kernel for (hd, dtype) asks for, in
// bytes (block_kv is read by the f32 kernel only); -1 for an hd that no
// kernel takes.
extern "C" int rt_flash_attention_smem(int hd, int block_kv, int is_bf16) {
  if (hd < 16 || hd > 256 || hd % 16 != 0) return -1;
  return is_bf16 ? rt_flash_tc_smem(hd) : (int)f32_smem(block_kv, hd);
}
