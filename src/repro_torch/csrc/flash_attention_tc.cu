// Causal / full attention for bf16 q, k, v on Hopper's tensor cores
// (sm_90a), forward only.  Entered through rt_flash_attention
// (flash_attention.cu), which sends bf16 inputs here.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel, for bf16 inputs.
// Computes: softmax(q k^T / sqrt(hd) [+ causal mask]) v per (batch,
// head); q/k/v/o (B, S, H, hd) bf16, K/V already repeated to the query
// heads; masked scores -1e30, running (m, l, acc) f32, denominator
// clamped at 1e-20, output rounded to bf16 once.
//
// Bound on this card: operations.  4*S*S*hd flops per (batch, head), half
// of that when causal, against 4*S*hd bf16 elements moved: at S 1024,
// hd 64 about 500 flops per byte, above the card's ridge (about 295 for
// bf16), so the bound is the tensor cores' bf16 rate.
//
// Design.
// - Products on the tensor cores: Q.K^T and P.V are mma.sync m16n8k16
//   with bf16 operands and f32 accumulation, the operands fed by
//   ldmatrix (.trans for V) from shared memory whose rows are padded by
//   16 bytes, so the 8 row addresses of every 8x8 matrix fall in 8
//   different bank groups (a row of hd bf16 is hd/8 16-byte units; hd/8
//   + 1 is odd for every hd that is a multiple of 16).  mma.sync rather
//   than wgmma: it takes every head dim and ragged tile with one code
//   path, its fragments map onto the online softmax lane by lane, and it
//   needs no TMA descriptors or producer warp; wgmma is the next step.
// - One block of 4 warps owns BQ query rows of one (batch, head); each
//   warp owns MT m-tiles of 16 of them (Tiles below: MT = 2 from hd 80 to
//   128, so every K/V fragment loaded from shared memory serves two
//   m-tiles; else 1).  Its Q rows are loaded once as mma A fragments and
//   stay in registers for the whole KV loop; its scores (16 x BKV per
//   m-tile) and its output (16 x hd per m-tile) live in registers as
//   accumulators.  P is turned into A fragments in registers (the m16n8
//   accumulator layout of two key tiles is the m16n8k16 A layout), so
//   scores never touch shared memory.
// - K/V tiles of BKV keys (64 to hd 64, else 32, to hold the registers)
//   go through a two-stage cp.async ring: tile j+1 is in flight while
//   tile j is multiplied; one __syncthreads per tile.  Q and tile 0 load
//   together.  Rows past S are zero-filled by the copy (src-size 0) and
//   masked.
// - Causal: KV tiles wholly after the block's last query row are never
//   loaded; a warp skips a tile wholly after its own rows; only tiles
//   that cross the diagonal or the ragged edge at S are masked.  Blocks
//   are issued heaviest first.
// - Ragged S: the kernel's tiles are its own at every S; the ragged edge
//   is masked, so a prime S runs the same tiles as S 1024.  The knob's
//   block_q/block_kv are not read here.
// - Online softmax once per KV tile, in base 2: the row max is taken of
//   the raw scores (the scale is positive), m is kept for
//   s * scale * log2(e), and p = 2^(s * scale * log2(e) - m) is one FFMA
//   and one ex2.approx; the row max and row sum are finished over the 4
//   lanes that share a row.
// - Shared memory: the block's Q rows (later its output rows, staged for
//   16-byte stores), then 2 stages x (K + V) x BKV rows, all of (hd + 8)
//   bf16.  At most 101,376 bytes (hd 256): it fits at every hd, and
//   nothing is refused.
//
// What differs from the reference.  The reference scales q in f32 before
// the product; here the f32 score q.k (products of bf16 values are exact
// in f32) is scaled by scale * log2(e) inside the exponent and raised
// with exp2: the same value up to f32 rounding (and ex2.approx's relative
// error of about 2^-22).  The reference multiplies the f32 P by the f32 V;
// here P is rounded to bf16 as the operand of P.V (V is bf16 already),
// while l sums the f32 P.  The tensor cores add in their own order.
// Within the 2e-2 of the bf16 checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ptx;
typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;            // bf16 elements of padding per row

// Per head dim: 16-row m-tiles per warp (MT) and keys per stage (BKV), as
// measured on the H100 (PERF.md): up to hd 64 one m-tile and 64 keys; to
// hd 128 two m-tiles (the K/V fragments serve both) and 32 keys, so the
// registers hold them; above, one m-tile and 32 keys.
template <int HD> struct Tiles {
  static constexpr int MT = HD > 64 && HD <= 128 ? 2 : 1;
  static constexpr int BKV = HD <= 64 ? 64 : 32;
  static constexpr int STAGES = 2;   // a third stage measured slower
  static constexpr int BQ = 16 * MT * kWarps;       // query rows per block
  static constexpr int LD = HD + kPad;              // row stride, elements
  static constexpr int STAGE = 2 * BKV * LD;        // K and V of one stage
  // Q rows (then the output rows), then the ring
  static constexpr int SMEM = (BQ * LD + STAGES * STAGE) * (int)sizeof(bf16);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                int H, int causal, float scale_log2) {
  using T = Tiles<HD>;
  constexpr int MT = T::MT, BQ = T::BQ, BKV = T::BKV, LD = T::LD;
  constexpr int KS = HD / 16;     // k-steps of Q.K^T
  constexpr int NT = BKV / 8;     // key tiles of 8 in a score row block
  constexpr int DT = HD / 8;      // dim tiles of 8 in an output row block
  constexpr int VPR = HD / 8;     // 16-byte vectors per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma row group, lane in quad
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = ((size_t)b * S * H + h) * HD;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  bf16* ob = o + base;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  // this warp's rows: warp_first .. warp_first + 16 * MT - 1
  const int warp_first = q0 + warp * 16 * MT;
  const int warp_last = warp_first + 16 * MT - 1;

  bf16* qs = smem;                    // BQ rows of Q, later of the output
  bf16* ring = smem + BQ * LD;        // STAGES x (K, V) x BKV rows
  auto load_kv = [&](int t) {
    bf16* ks = ring + (t % T::STAGES) * T::STAGE;
    bf16* vs = ks + BKV * LD;
    const int k0 = t * BKV;
    for (int i = tid; i < BKV * VPR; i += kThreads) {
      const int r = i / VPR, c = i % VPR;
      const bool ok = k0 + r < S;
      const size_t src = (size_t)(ok ? k0 + r : 0) * row_stride + c * 8;
      cp_async16(smem_addr(ks + r * LD + c * 8), kb + src, ok);
      cp_async16(smem_addr(vs + r * LD + c * 8), vb + src, ok);
    }
  };

  // Q and the first KV tiles in flight together; Q then goes into
  // registers as mma A fragments for the whole KV loop
  for (int i = tid; i < BQ * VPR; i += kThreads) {
    const int r = i / VPR, c = i % VPR;
    const bool ok = q0 + r < S;
    cp_async16(smem_addr(qs + r * LD + c * 8),
               qb + (size_t)(ok ? q0 + r : 0) * row_stride + c * 8, ok);
  }
  for (int t = 0; t < T::STAGES - 1; ++t) {
    if (t < n_kv) load_kv(t);
    cp_async_commit();
  }
  cp_async_wait<T::STAGES - 2>();   // Q and tile 0 have landed
  __syncthreads();
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = warp * 16 * MT + mt * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[mt][kk],
                  smem_addr(qs + r * LD + kk * 16 + (lane >> 4) * 8));
  }

  float acc[MT][DT][4];
  float m[MT][2], l[MT][2];   // rows g and g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DT; ++d)
      acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;   // base-2 units
    l[mt][0] = l[mt][1] = 0.f;       // this lane's share of the row sums
  }

  // lane offsets of the ldmatrix addresses (elements)
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    (((lane >> 3) & 1) << 3);
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    ((lane >> 4) << 3);

  for (int j = 0; j < n_kv; ++j) {
    if (j > 0) {
      cp_async_wait<T::STAGES - 2>();   // tile j has landed
      __syncthreads();                  // ... for all; tile j-1 is released
    }
    if (j + T::STAGES - 1 < n_kv) load_kv(j + T::STAGES - 1);
    cp_async_commit();

    const int k0 = j * BKV;
    if (causal && k0 > warp_last) continue;   // warp-uniform
    const bf16* ks = ring + (j % T::STAGES) * T::STAGE;
    const bf16* vs = ks + BKV * LD;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_addr(ks + np * 16 * LD + kk * 16 + k_off));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], bfr[0], bfr[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bfr[2], bfr[3]);
        }
      }
    }

    const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > warp_first);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row0 = warp_first + mt * 16 + g, row1 = row0 + 8;
      // the row max of the raw scores (the scale is positive), then
      // p = 2^(s * scale * log2(e) - m) in one FFMA and one MUFU op
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (edge) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t4 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= S || (causal && col > row)) s[mt][n][e] = kNegInf;
          }
        }
        mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      mx0 = fmaxf(m[mt][0], mx0 * scale_log2);
      mx1 = fmaxf(m[mt][1], mx1 * scale_log2);
      const float c0 = exp2_approx(m[mt][0] - mx0);
      const float c1 = exp2_approx(m[mt][1] - mx1);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[mt][n][0] = exp2_approx(fmaf(s[mt][n][0], scale_log2, -mx0));
        s[mt][n][1] = exp2_approx(fmaf(s[mt][n][1], scale_log2, -mx0));
        s[mt][n][2] = exp2_approx(fmaf(s[mt][n][2], scale_log2, -mx1));
        s[mt][n][3] = exp2_approx(fmaf(s[mt][n][3], scale_log2, -mx1));
        ps0 += s[mt][n][0] + s[mt][n][1];
        ps1 += s[mt][n][2] + s[mt][n][3];
      }
      l[mt][0] = l[mt][0] * c0 + ps0;
      l[mt][1] = l[mt][1] * c1 + ps1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[mt][d][0] *= c0;
        acc[mt][d][1] *= c0;
        acc[mt][d][2] *= c1;
        acc[mt][d][3] *= c1;
      }
    }

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr,
                          smem_addr(vs + kk * 16 * LD + dp * 16 + v_off));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], bfr[2], bfr[3]);
        }
      }
    }
  }

  // finish the row sums over the quad, normalise, stage this warp's rows
  // where its Q rows were, store 16 bytes a lane
  bf16* os = qs + warp * 16 * MT * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-20f);
    const float inv1 = 1.f / fmaxf(l1, 1e-20f);
    bf16* om = os + mt * 16 * LD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(om + g * LD + col) =
          pack_bf16(acc[mt][d][0] * inv0, acc[mt][d][1] * inv0);
      *reinterpret_cast<uint32_t*>(om + (g + 8) * LD + col) =
          pack_bf16(acc[mt][d][2] * inv1, acc[mt][d][3] * inv1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * VPR; i += 32) {
    const int r = i / VPR, c = i % VPR;
    if (warp_first + r < S)
      *reinterpret_cast<uint4*>(ob + (size_t)(warp_first + r) * row_stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int causal, cudaStream_t stream) {
  using T = Tiles<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::BQ - 1) / T::BQ, H, B);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  flash_tc_kernel<HD><<<grid, kThreads, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

#define RT_HD_LIST(X)                                                      \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) \
  X(192) X(208) X(224) X(240) X(256)

// hd: any multiple of 16 up to 256, each its own instantiation.
cudaError_t rt_flash_tc_launch(const void* q, const void* k, const void* v,
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

int rt_flash_tc_smem(int hd) {
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
