// Causal / full attention for f32 q, k, v on Hopper's tensor cores
// (sm_90a), forward only, with three TF32 products standing for each f32
// product.  Entered through rt_flash_attention (flash_attention.cu),
// which sends f32 inputs here.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel, for f32 inputs.
// Computes: softmax(q k^T / sqrt(hd) [+ causal mask]) v per (batch,
// head); q/k/v/o (B, S, H, hd) f32, K/V already repeated to the query
// heads; masked scores -1e30, running (m, l, acc) f32, denominator
// clamped at 1e-20.
//
// Bound on this card: operations.  4*S*S*hd flops per (batch, head), half
// of that when causal, against 16*S*hd bytes moved: at S 1024, hd 64
// about 250 flops per byte.  Each f32 product is three TF32 products
// here, so the rate to hold it against is a third of the TF32 tensor
// rate (495e12 / 3 = 165e12 flop/s), which is still 2.5 times the card's
// f32 rate on the CUDA cores (67e12).
//
// Design: the tiling of the bf16 kernel (flash_attention_tc.cu), with
// f32 operands.
// - Products on the tensor cores: Q.K^T and P.V are mma.sync m16n8k8 with
//   TF32 operands and f32 accumulation.  One TF32 product keeps about 10
//   bits and does not hold the 2e-5 of the f32 checks, so every operand
//   x is split into hi = tf32(x) and lo = tf32(x - hi) (tf32: the 13 low
//   mantissa bits cleared, a bit mask), and a product is lo.hi + hi.lo +
//   hi.hi (the lo.lo term and the cut of lo, about 2^-20 relative, are
//   dropped): about the precision of an f32 product.  The inner loop is
//   bound by the tensor cores, not by shared-memory reads: every fragment
//   loaded feeds 3 mma of 1024 multiply-adds.
// - One block of 4 warps owns 64 query rows of one (batch, head); each
//   warp owns one 16-row m-tile.  Q stays in shared memory (its split
//   fragments would take hd registers a thread) and is read with ldmatrix
//   once per KV tile; scores (16 x BKV) and the output (16 x hd) live in
//   registers.  The P.V operand A is the score accumulator as it stands:
//   a thread's accumulator holds keys 2t and 2t+1 of a key tile of 8,
//   where the A fragment wants keys t and t+4, so the keys of each tile
//   of 8 are taken in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides
//   of P.V (V rows 2t and 2t+1 as the B fragment): the sum is the same.
// - Rows of hd + 4 floats: ldmatrix's 8 row addresses fall in 8
//   different bank groups ((hd + 4) / 4 is odd), and the V fragments'
//   scalar loads (rows 2t, columns g) hit 32 different banks (2 (hd + 4)
//   = 8 mod 32).
// - K/V tiles of BKV keys (64 to hd 64, else 32, for the registers) go
//   through a two-stage cp.async ring, one __syncthreads per tile.  Rows
//   past S are zero-filled by the copy (src-size 0) and masked.
// - Causal: KV tiles wholly after the block's last query row are never
//   loaded; a warp skips a tile wholly after its own rows; only tiles
//   that cross the diagonal or the ragged edge at S are masked.  Blocks
//   are issued heaviest first.
// - Ragged S: the tiles are the kernel's own at every S, the ragged edge
//   masked, so a prime S runs the same tiles as S 1024.  The knob's
//   block_q / block_kv are not read here.
// - Online softmax once per KV tile, in base 2: the row max is taken of
//   the raw scores (the scale is positive), m is kept for
//   s * scale * log2(e), and p = 2^(s * scale * log2(e) - m) is one FFMA
//   and one ex2.approx.
// - Shared memory: Q (later the output rows, staged for 16-byte stores),
//   then 2 stages x (K + V) x BKV rows, all of hd + 4 floats: at most
//   199,680 bytes (hd 256), so it fits at every hd.
//
// What differs from the reference.  The reference scales q before the
// product; here the score q.k is scaled by scale * log2(e) inside the
// exponent and raised with exp2 (ex2.approx: relative error about
// 2^-22).  Each product carries the split's error (about 2^-20 relative)
// and the tensor cores add in their own order.  Within the 2e-5 of the
// f32 checks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int HD> struct Tiles {
  static constexpr int BKV = HD <= 64 ? 64 : 32;    // keys per stage
  static constexpr int STAGES = 2;
  static constexpr int BQ = 16 * kWarps;            // query rows per block
  static constexpr int LD = HD + 4;                 // row stride, floats
  static constexpr int STAGE = 2 * BKV * LD;        // K and V of one stage
  static constexpr int SMEM = (BQ * LD + STAGES * STAGE) * (int)sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int causal, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, LD = T::LD;
  constexpr int KS = HD / 8;      // k-steps of Q.K^T
  constexpr int NT = BKV / 8;     // key tiles of 8 in a score row block
  constexpr int DT = HD / 8;      // dim tiles of 8 in an output row block
  constexpr int VPR = HD / 4;     // 16-byte vectors per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma row group, lane in quad
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = ((size_t)b * S * H + h) * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* ob = o + base;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  const int warp_first = q0 + warp * 16;    // this warp's 16 rows
  const int warp_last = warp_first + 15;

  float* qs = smem;                   // BQ rows of Q, later of the output
  float* ring = smem + BQ * LD;       // STAGES x (K, V) x BKV rows
  auto load_kv = [&](int t) {
    float* ks = ring + (t % T::STAGES) * T::STAGE;
    float* vs = ks + BKV * LD;
    const int k0 = t * BKV;
    for (int i = tid; i < BKV * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      const bool ok = k0 + r < S;
      const size_t src = (size_t)(ok ? k0 + r : 0) * row_stride + c * 4;
      cp_async16(smem_addr(ks + r * LD + c * 4), kb + src, ok);
      cp_async16(smem_addr(vs + r * LD + c * 4), vb + src, ok);
    }
  };

  for (int i = tid; i < BQ * VPR; i += kThreads) {
    const int r = i / VPR, c = i % VPR;
    const bool ok = q0 + r < S;
    cp_async16(smem_addr(qs + r * LD + c * 4),
               qb + (size_t)(ok ? q0 + r : 0) * row_stride + c * 4, ok);
  }
  for (int t = 0; t < T::STAGES - 1; ++t) {
    if (t < n_kv) load_kv(t);
    cp_async_commit();
  }

  float acc[DT][4];
  float m0 = kNegInf, m1 = kNegInf;   // rows g and g + 8, base-2 units
  float l0 = 0.f, l1 = 0.f;           // this lane's share of the row sums
#pragma unroll
  for (int d = 0; d < DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // lane offsets (floats) of the ldmatrix addresses: Q as the A operand
  // (rows lane % 16, columns 4 (lane / 16)); K as the B operand (keys
  // lane % 8 + 8 (lane / 16), dims 4 ((lane / 8) % 2))
  const int q_off = (warp * 16 + (lane & 15)) * LD + ((lane >> 4) << 2);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    (((lane >> 3) & 1) << 2);

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<T::STAGES - 2>();   // tile j (and Q) have landed
    __syncthreads();                  // ... for all; tile j-1 is released
    if (j + T::STAGES - 1 < n_kv) load_kv(j + T::STAGES - 1);
    cp_async_commit();

    const int k0 = j * BKV;
    if (causal && k0 > warp_last) continue;   // warp-uniform
    const float* ks = ring + (j % T::STAGES) * T::STAGE;
    const float* vs = ks + BKV * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], a_hi[4], a_lo[4];
      ldmatrix_x4(a, smem_addr(qs + q_off + kk * 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), a_hi[e],
                                             a_lo[e]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4], b_hi[4], b_lo[4];
        ldmatrix_x4(bfr, smem_addr(ks + np * 16 * LD + kk * 8 + k_off));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(bfr[e]), b_hi[e], b_lo[e]);
        mma_3xtf32(s[2 * np], a_hi, a_lo, b_hi, b_lo);
        mma_3xtf32(s[2 * np + 1], a_hi, a_lo, b_hi + 2, b_lo + 2);
      }
    }

    const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > warp_first);
    const int row0 = warp_first + g, row1 = row0 + 8;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= S || (causal && col > row)) s[n][e] = kNegInf;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    const float c0 = exp2_approx(m0 - mx0);
    const float c1 = exp2_approx(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2_approx(fmaf(s[n][0], scale_log2, -mx0));
      s[n][1] = exp2_approx(fmaf(s[n][1], scale_log2, -mx0));
      s[n][2] = exp2_approx(fmaf(s[n][2], scale_log2, -mx1));
      s[n][3] = exp2_approx(fmaf(s[n][3], scale_log2, -mx1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= c0;
      acc[d][1] *= c0;
      acc[d][2] *= c1;
      acc[d][3] *= c1;
    }

    // P.V, keys of each tile of 8 in the order (0, 2, 4, 6, 1, 3, 5, 7):
    // A = {P[g][2t], P[g+8][2t], P[g][2t+1], P[g+8][2t+1]}, B = {V[2t][d],
    // V[2t+1][d]}
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_tf32(s[kk][0], a_hi[0], a_lo[0]);
      split_tf32(s[kk][2], a_hi[1], a_lo[1]);
      split_tf32(s[kk][1], a_hi[2], a_lo[2]);
      split_tf32(s[kk][3], a_hi[3], a_lo[3]);
      const float* vrow = vs + (kk * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(vrow[d * 8], b_hi[0], b_lo[0]);
        split_tf32(vrow[d * 8 + LD], b_hi[1], b_lo[1]);
        mma_3xtf32(acc[d], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }

  // finish the row sums over the quad, normalise, stage this warp's rows
  // where its Q rows were, store 16 bytes a lane
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-20f);
  const float inv1 = 1.f / fmaxf(l1, 1e-20f);
  float* os = qs + warp * 16 * LD;
  __syncwarp();   // the warp's last ldmatrix of its Q rows is done
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t4;
    *reinterpret_cast<float2*>(os + g * LD + col) =
        make_float2(acc[d][0] * inv0, acc[d][1] * inv0);
    *reinterpret_cast<float2*>(os + (g + 8) * LD + col) =
        make_float2(acc[d][2] * inv1, acc[d][3] * inv1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR, c = i % VPR;
    if (warp_first + r < S)
      *reinterpret_cast<float4*>(ob + (size_t)(warp_first + r) * row_stride +
                                 c * 4) =
          *reinterpret_cast<const float4*>(os + r * LD + c * 4);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int causal, cudaStream_t stream) {
  using T = Tiles<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::BQ - 1) / T::BQ, H, B);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  flash_f32_kernel<HD><<<grid, kThreads, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

#define RT_HD_LIST(X)                                                      \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) \
  X(192) X(208) X(224) X(240) X(256)

// hd: any multiple of 16 up to 256, each its own instantiation.
cudaError_t rt_flash_f32_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int S, int H, int hd,
                                int causal, cudaStream_t stream) {
  switch (hd) {
#define RT_CASE(D) \
  case D:          \
    return launch<D>(q, k, v, o, B, S, H, causal, stream);
    RT_HD_LIST(RT_CASE)
#undef RT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int rt_flash_f32_smem(int hd) {
  switch (hd) {
#define RT_CASE(D) \
  case D:          \
    return Tiles<D>::SMEM;
    RT_HD_LIST(RT_CASE)
#undef RT_CASE
    default:
      return -1;
  }
}
