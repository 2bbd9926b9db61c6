// Chunked Mamba2 / SSD scan for Hopper (sm_90a), forward only, on the
// tensor cores.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, _ssd_kernel (the
// Pallas kernel behind ssm_scan_grid / ops.ssm_scan).
// Computes, for each (batch, head) and each chunk of positions, with cum
// the inclusive cumulative sum of la over the chunk and h the (P x N)
// state carried from the chunks before:
//   y_t = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j X_j      (within)
//       + exp(cum_t) C_t . h                                      (carried)
//   h  <- exp(cum_last) h + sum_j dt_j exp(cum_last - cum_j) X_j B_j^T
// which is the per-token recurrence h_t = exp(la_t) h_{t-1} +
// dt_t X_t B_t^T, y_t = C_t . h_t of the reference's oracle, taken a
// chunk at a time.  Every chunking is the same recurrence (only the
// rounding differs), so the kernel runs chunks of its own, kQ = 64 rows,
// at every S and masks the ragged last chunk: the knob's chunk (which
// the reference fits to a divisor of S, down to 1 at a prime S) is not
// read here.  Layouts are the model's: X, Y (B, S, H, P) in f32 or bf16
// (Y in X's dtype); Bm, Cm (B, S, N) f32; dt, la (B, S, H) f32; h_final
// (B, H, P, N) f32.  P and N: multiples of 8 up to 64.
//
// Bound on this card: bytes, at both X dtypes.  Per (batch, head) and
// chunk of 64 the four products (C.B^T shared by the block's heads, the
// causal half of scores.X, C.h^T, X^T.(w B)) are about (32 + 2 N) P
// multiply-adds per position, against 2 * sizeof(X) * P bytes of X and Y:
// about 70 flops per byte at bf16 X, under the 295 at which bf16
// tensor-core products would take longer than the bytes (and 38 at f32
// X, under the 49 of three TF32 products).  The kernel issues more than
// that: the split state path below is about 180 TF32 flops per byte at
// bf16 X, near the 148 at which TF32 products match the bytes.
//
// Design.
// - Products on the tensor cores: mma.sync m16n8k8 with TF32 operands and
//   f32 accumulation.  An f32 operand x that needs f32 precision is split
//   into hi = tf32(x) and lo = tf32(x - hi), and a product is lo.hi +
//   hi.lo + hi.hi: about the precision of an f32 product (tf32: the 13
//   low mantissa bits cleared), where one TF32 product is about 2^-10.
//   The state path is split at both X dtypes: h_final is f32 and decode
//   carries it through the rest of generation, so the state update X^T
//   (w B) and the carried term C h^T keep f32 precision (bf16 X is exact
//   in TF32, so X^T (w B) takes two products there, hi.lo + hi.hi).
//   G = C.B^T and the within-chunk S X feed only Y: for bf16 X one TF32
//   product each (C, B and the decayed scores cut to TF32 only as
//   operands, under Y's own bf16 rounding), for f32 X three, since one
//   does not hold 1e-4.
// - Work unit: one block per (batch, chunk, group of kHG = 8 heads), 8
//   warps.  The block forms G = C.B^T of its chunk once and keeps it in
//   shared memory for its heads (B and C have no head axis), then walks
//   its heads: per head the decayed scores S = G o exp(cum_t - cum_j) o
//   dt_j (t >= j) go to shared memory, and the head's state contribution
//   X^T (w o B), its carried term C h^T and its within-chunk term S X are
//   64 x 64 products of 8 warps of 2 x 2 m16n8 tiles.  A warp's two
//   m-tiles are (0, 3) or (1, 2) of the chunk's four, so the causal S.X
//   (row tile m needs key tiles 0..m) is balanced across warps.
// - The chunks in parallel, the state passed along: the state h entering
//   chunk c is the state leaving chunk c - 1.  A block computes its
//   head's state contribution first, then waits until the block of chunk
//   c - 1 has published that head's state, reads it from L2, publishes
//   its own (exp(cum_last) h + contribution) and only then forms the
//   head's outputs.  So the sequential part is one 64 x 64 update per
//   head and chunk, and the blocks of successive chunks follow one
//   another head by head.  Blocks take their (chunk, batch, group) from
//   a ticket in the order they start, chunk-major: a block waits only on
//   one that started before it, so the waits cannot deadlock however
//   many blocks are resident.  States live in two slots per (batch,
//   head) (chunk c writes slot c % 2): chunk c + 1 overwrites the state
//   chunk c read only after chunk c has published, by which time chunk c
//   holds it in shared memory.  The last block to finish sets the
//   tickets and flags back to zero for the next call.
// - The hand-off is an acquire / release pair (PTX ISA, chapter "Memory
//   Consistency Model", sections "Release and Acquire Patterns" and
//   "Ordering of memory operations": "Memory synchronization" and
//   "Causality Order").  Producer: every thread stores its part of the
//   state (weak __stcg stores), then bar.sync, then thread 0 writes the
//   flag with st.release.gpu.  Consumer: thread 0 spins on the flag with
//   ld.acquire.gpu until it reads the producer's value, then bar.sync,
//   then every thread reads the state (weak __ldcg loads).  The argument:
//   a bar.sync synchronizes with the bar.sync of the CTA's other threads;
//   a release that an acquire of the same location at the same (.gpu)
//   scope observes synchronizes with it; base causality order is the
//   transitive closure of program order and synchronizes-with.  So each
//   producer thread's store precedes (program order) its bar.sync, which
//   synchronizes with thread 0's, which precedes its release, which
//   synchronizes with the consumer's acquire, which precedes the
//   consumer's bar.sync, which synchronizes with every consumer thread's,
//   which precedes its load: the store precedes the load in causality
//   order, so the load cannot read the slot's older value.  The release
//   is cumulative over the barrier in this sense, and no thread but 0
//   needs a fence of its own.  The same chain orders chunk c's loads of
//   a slot before chunk c + 1's stores to it (the slot two chunks share).
//   The count of finished blocks is an atom.acq_rel.gpu, so the block
//   that resets the flags comes after every block's last read of them.
// - Fill: B * ceil(S / 64) * ceil(H / 8) blocks -- 896 at zamba2-7b's B 4,
//   S 1024, H 112, and 224 at B 1 -- two resident per SM for bf16 X
//   (112,896 B of shared memory each), one for f32 X (131,328 B).
// - Copies overlapped with the math: X of head i + 1 is staged by
//   cp.async into a two-stage ring while head i is computed; B and C of
//   the chunk and X of the first head load together.  Rows past S and
//   columns past P and N are zero-filled by the copy (src-size 0).
// - The cumulative sum of la over a chunk is taken and differenced in
//   f64 (one warp per head, shuffles): an f32 cum at |cum| ~ 10^2 is off
//   by ~1e-5, and exp(cum_t - cum_j) turns that into a relative error of
//   every near-diagonal term (two f32 orders disagreed by 6.4e-4 at
//   S = 1000).
// - Shared memory layouts are chosen so every fragment load hits 32
//   banks: operands read as A[m][k] or B[n][k] have rows of 68 floats,
//   those read as A[k][m] or B[k][n] rows of 72 elements.
//
// What differs from the reference.  The reference runs the fitted chunk;
// here the chunk is 64 rows at every S (the same recurrence; rounding
// differs).  The operands of G and S X are TF32 at bf16 X; every other
// product runs on split operands; the tensor cores add in their own
// order.  Within 1e-4 (f32 X) and 5e-2 (bf16 X) of the plain version,
// and h_final within 1e-4 at both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ptx;

constexpr int kQ = 64;          // rows of a chunk; also the largest P, N
constexpr int kHG = 8;          // heads per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdR = 68;        // row stride of A[m][k] / B[n][k] tiles
constexpr int kLdC = 72;        // row stride of A[k][m] / B[k][n] tiles
constexpr int kTile = kQ * kLdR;
constexpr long long kSpinLimit = 1LL << 32;   // clocks: seconds on this card

template <typename T> struct Smem {
  // cs, gs, ss, hs (kLdR rows), bs (kLdC), the X ring, then cum (f64),
  // dt, w
  static constexpr int kRing = 2 * kQ * kLdC;
  static constexpr int kBytes = 4 * kTile * 4 + kQ * kLdC * 4 +
                                kRing * (int)sizeof(T) +
                                kHG * kQ * 8 + kHG * kQ * 4 + kQ * 4;
};

__device__ __forceinline__ float val(const float* p) { return *p; }
__device__ __forceinline__ float val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The operands of one m16n8k8 product, TF32; A's split into (hi, lo)
// when SA, B's when SB.  Fragment positions (g = lane / 4, t = lane % 4):
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}.
// A product is lo.hi + hi.lo + hi.hi of the split operands; the terms of
// an operand that is not split (lo = 0) are left out.
template <bool SA, bool SB> struct Frag {
  uint32_t a_hi[2][4], a_lo[2][4];   // two m-tiles
  uint32_t b_hi[2][2], b_lo[2][2];   // two n-tiles
  __device__ __forceinline__ void set_a(int mt, int e, float x) {
    if (SA) split_tf32(x, a_hi[mt][e], a_lo[mt][e]);
    else a_hi[mt][e] = tf32(x);
  }
  __device__ __forceinline__ void set_b(int nt, int e, float x) {
    if (SB) split_tf32(x, b_hi[nt][e], b_lo[nt][e]);
    else b_hi[nt][e] = tf32(x);
  }
  __device__ __forceinline__ void mma(float (*acc)[2][4], int mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if (SA) mma_tf32(acc[mt][nt], a_lo[mt], b_hi[nt][0], b_hi[nt][1]);
      if (SB) mma_tf32(acc[mt][nt], a_hi[mt], b_lo[nt][0], b_lo[nt][1]);
      mma_tf32(acc[mt][nt], a_hi[mt], b_hi[nt][0], b_hi[nt][1]);
    }
  }
};

// A[m][k] at base[k * ld + m]
template <typename F, typename E>
__device__ __forceinline__ void load_a_km(F& f, int mt,
                                          const E* base, int ld, int m0,
                                          int k0, int g, int t) {
  const E* p = base + (k0 + t) * ld + m0 + g;
  f.set_a(mt, 0, val(p));
  f.set_a(mt, 1, val(p + 8));
  f.set_a(mt, 2, val(p + 4 * ld));
  f.set_a(mt, 3, val(p + 4 * ld + 8));
}
// B[k][n] at base[k * ld + n], row k scaled by scale[k] if given
template <typename F, typename E>
__device__ __forceinline__ void load_b_kn(F& f, int nt,
                                          const E* base, int ld, int k0,
                                          int n0, int g, int t,
                                          const float* scale = nullptr) {
  const E* p = base + (k0 + t) * ld + n0 + g;
  float b0 = val(p), b1 = val(p + 4 * ld);
  if (scale) {
    b0 *= scale[k0 + t];
    b1 *= scale[k0 + t + 4];
  }
  f.set_b(nt, 0, b0);
  f.set_b(nt, 1, b1);
}
// A[m][k] at base[m * ld + k], f32, by one ldmatrix: its four 8 x 8
// matrices of 16-bit pairs are the fragment's (rows m0.., m0+8..) x
// (columns k0.., k0+4..)
template <typename F>
__device__ __forceinline__ void ldsm_a(F& f, int mt,
                                       const float* base, int ld, int m0,
                                       int k0, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, smem_addr(base + (m0 + (lane & 15)) * ld + k0 +
                           ((lane >> 4) << 2)));
#pragma unroll
  for (int e = 0; e < 4; ++e) f.set_a(mt, e, __uint_as_float(r[e]));
}
// B[k][n] at base[n * ld + k], f32, for the n-tiles n0 and n0 + 8 by one
// ldmatrix
template <typename F>
__device__ __forceinline__ void ldsm_b(F& f, const float* base,
                                       int ld, int n0, int k0, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, smem_addr(base + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                                      ld + k0 + (((lane >> 3) & 1) << 2)));
#pragma unroll
  for (int e = 0; e < 4; ++e) f.set_b(e >> 1, e & 1, __uint_as_float(r[e]));
}

__device__ __forceinline__ void zero(float (*acc)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Ticket (sync[0]) and finished-block count (sync[1]), then one publish
// counter per (chunk, batch, head group): block (c, bg) sets its own to
// i + 1 once it has published the state of its head i, and the block of
// chunk c + 1 reads it.  Each counter has one writer.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(kThreads, SPLIT ? 1 : 2)
ssd_kernel(const T* __restrict__ X, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ dt,
           const float* __restrict__ la, T* __restrict__ Y,
           float* __restrict__ h_out, float* __restrict__ slots,
           int* __restrict__ sync, int Bsz, int S, int H, int P, int N,
           int nc, int ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);   // C [t][n]
  float* gs = cs + kTile;                            // G [t][j]
  float* ss = gs + kTile;                            // scores [t][j]
  float* hs = ss + kTile;                            // h entering [p][n]
  float* bs = hs + kTile;                            // B [j][n]
  T* xring = reinterpret_cast<T*>(bs + kQ * kLdC);   // 2 x X [j][p]
  double* cum = reinterpret_cast<double*>(xring + Smem<T>::kRing);
  float* dts = reinterpret_cast<float*>(cum + kHG * kQ);
  float* ws = dts + kHG * kQ;                        // w_j of one head
  __shared__ int s_ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) s_ticket = atomicAdd(&sync[0], 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int per_chunk = Bsz * ng;
  const int c = ticket / per_chunk, bg = ticket % per_chunk;
  const int b = bg / ng, h0 = (bg % ng) * kHG;
  const int nh = min(kHG, H - h0);
  const int c0 = c * kQ, qn = min(kQ, S - c0);
  int* pub = sync + 2 + ticket;                  // this block's counter
  const int* prev_pub = pub - per_chunk;          // chunk c - 1's

  // this warp's output tiles: m-tiles (0, 3) or (1, 2), n-tiles n0, n0 + 8
  const int mt0 = (warp >> 2) ? 1 : 0;
  const int mrow[2] = {mt0 * 16, (3 - mt0) * 16};
  const int n0 = (warp & 3) * 16;

  const size_t xrow = (size_t)H * P;   // X / Y row stride
  auto load_x = [&](int i) {
    T* xs = xring + (i & 1) * kQ * kLdC;
    const T* src = X + ((size_t)b * S + c0) * xrow + (size_t)(h0 + i) * P;
    constexpr int V = 16 / sizeof(T);   // elements per 16-byte copy
    for (int k = tid; k < kQ * (kQ / V); k += kThreads) {
      const int r = k / (kQ / V), col = (k % (kQ / V)) * V;
      const bool ok = r < qn && col < P;
      cp_async16(smem_addr(xs + r * kLdC + col),
                 ok ? src + (size_t)r * xrow + col : src, ok);
    }
  };

  // C, B and the first head's X in flight together
  {
    const float* cb = Cm + ((size_t)b * S + c0) * N;
    const float* bb = Bm + ((size_t)b * S + c0) * N;
    for (int k = tid; k < kQ * (kQ / 4); k += kThreads) {
      const int r = k / (kQ / 4), col = (k % (kQ / 4)) * 4;
      const bool ok = r < qn && col < N;
      const size_t off = ok ? (size_t)r * N + col : 0;
      cp_async16(smem_addr(cs + r * kLdR + col), cb + off, ok);
      cp_async16(smem_addr(bs + r * kLdC + col), bb + off, ok);
    }
    load_x(0);
    cp_async_commit();
  }
  // dt and the cumulative sum of la (f64), one warp per head; rows past
  // S get dt = la = 0, so they add nothing and cum_last = cum[qn - 1]
  if (warp < nh) {
    const size_t at = ((size_t)b * S + c0) * H + h0 + warp;
    double v[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half;
      const bool ok = r < qn;
      v[half] = ok ? (double)la[at + (size_t)r * H] : 0.0;
      dts[warp * kQ + r] = ok ? dt[at + (size_t)r * H] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v[half], off);
        if (lane >= off) v[half] += u;
      }
    }
    v[1] += __shfl_sync(0xffffffffu, v[0], 31);
    cum[warp * kQ + lane] = v[0];
    cum[warp * kQ + lane + 32] = v[1];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int kn = N / 8;                 // k-steps over the state dim
  const int kj = (qn + 7) / 8;          // k-steps over the chunk's rows
  float acc[2][2][4];

  // G = C . B^T, once for the block's heads
  {
    Frag<SPLIT, SPLIT> f;
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < kQ / 8; ++kk) {
      if (kk >= kn) break;
      ldsm_b(f, bs, kLdC, n0, kk * 8, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_a(f, mt, cs, kLdR, mrow[mt], kk * 8, lane);
        f.mma(acc, mt);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* p = gs + (mrow[mt] + g) * kLdR + n0 + nt * 8 + 2 * t;
        st2(p, acc[mt][nt][0], acc[mt][nt][1]);
        st2(p + 8 * kLdR, acc[mt][nt][2], acc[mt][nt][3]);
      }
  }

  for (int i = 0; i < nh; ++i) {
    const int hh = h0 + i;
    if (i + 1 < nh) load_x(i + 1);   // its stage was freed by head i - 1
    cp_async_commit();
    cp_async_wait<1>();                // X of head i has landed
    __syncthreads();                   // ... for all; G is written
    const T* xs = xring + (i & 1) * kQ * kLdC;
    const double* cm = cum + i * kQ;
    const float* dm = dts + i * kQ;

    // decayed scores S[t][j] = G[t][j] exp(cum_t - cum_j) dt_j, t >= j,
    // and w_j = dt_j exp(cum_last - cum_j)
    for (int k = tid; k < kQ * kQ; k += kThreads) {
      const int r = k / kQ, j = k % kQ;
      ss[r * kLdR + j] = (j <= r && r < qn)
          ? gs[r * kLdR + j] * expf((float)(cm[r] - cm[j])) * dm[j] : 0.f;
    }
    if (tid < kQ) ws[tid] = dm[tid] * expf((float)(cm[kQ - 1] - cm[tid]));
    __syncthreads();

    // this head's state contribution St[p][n] = sum_j X_j[p] w_j B_j[n]
    float st[2][2][4];
    {
      Frag<SPLIT, true> f;   // X exact in TF32 at bf16
      zero(st);
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        if (kk >= kj) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b_kn(f, nt, bs, kLdC, kk * 8, n0 + nt * 8, g, t, ws);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          load_a_km(f, mt, xs, kLdC, mrow[mt], kk * 8, g, t);
          f.mma(st, mt);
        }
      }
    }

    // wait for the state entering this chunk (published by the block of
    // chunk c - 1), publish the state leaving it, keep the entering one
    // in shared memory for the carried term
    if (c > 0 && tid == 0) {
      const long long t0 = clock64();
      while (ld_acquire_gpu(prev_pub) <= i) {
        __nanosleep(32);
        // a publish that never comes (a fault) traps instead of hanging
        if (clock64() - t0 > kSpinLimit) __trap();
      }
    }
    __syncthreads();   // the acquire, extended to the block's threads
    {
      const float a_chunk = expf((float)cm[kQ - 1]);
      const size_t hb = ((size_t)b * H + hh) * kQ * kQ;
      const float* prev = slots + (size_t)((c + 1) & 1) * Bsz * H * kQ * kQ + hb;
      float* next = slots + (size_t)(c & 1) * Bsz * H * kQ * kQ + hb;
      const bool last = c == nc - 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = mrow[mt] + g + 8 * half;
            const int n = n0 + nt * 8 + 2 * t;
            float2 hp = make_float2(0.f, 0.f);
            if (c > 0)
              hp = __ldcg(reinterpret_cast<const float2*>(prev + p * kQ + n));
            const float2 hn =
                make_float2(a_chunk * hp.x + st[mt][nt][2 * half],
                            a_chunk * hp.y + st[mt][nt][2 * half + 1]);
            if (!last) {
              __stcg(reinterpret_cast<float2*>(next + p * kQ + n), hn);
            } else if (p < P && n < N) {
              float* ho = h_out + (((size_t)b * H + hh) * P + p) * N + n;
              *reinterpret_cast<float2*>(ho) = hn;
            }
            st2(hs + p * kLdR + n, hp.x, hp.y);
          }
    }
    // the block's stores, then the barrier, then the flag written with
    // release semantics (cumulative over the barrier: header)
    __syncthreads();
    if (tid == 0 && c < nc - 1) st_release_gpu(pub, i + 1);

    // outputs: Y = diag(exp(cum_t)) C h^T + S X
    zero(acc);
    if (c > 0) {
      Frag<true, true> f;
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        if (kk >= kn) break;
        ldsm_b(f, hs, kLdR, n0, kk * 8, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldsm_a(f, mt, cs, kLdR, mrow[mt], kk * 8, lane);
          f.mma(acc, mt);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float e0 = expf((float)cm[mrow[mt] + g]);
        const float e1 = expf((float)cm[mrow[mt] + g + 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc[mt][nt][0] *= e0;
          acc[mt][nt][1] *= e0;
          acc[mt][nt][2] *= e1;
          acc[mt][nt][3] *= e1;
        }
      }
    }
    {
      // causal: row tile m needs the key tiles up to its own (2 (m + 1)
      // k-steps); warp-uniform bounds
      Frag<SPLIT, SPLIT> f;
      const int kend = min(kj, 2 * (mrow[1] / 16 + 1));
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        if (kk >= kend) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b_kn(f, nt, xs, kLdC, kk * 8, n0 + nt * 8, g, t);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (kk < 2 * (mrow[mt] / 16 + 1)) {
            ldsm_a(f, mt, ss, kLdR, mrow[mt], kk * 8, lane);
            f.mma(acc, mt);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mrow[mt] + g + 8 * half;
        if (r >= qn) continue;
        T* yrow = Y + ((size_t)b * S + c0 + r) * xrow + (size_t)hh * P;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int p = n0 + nt * 8 + 2 * t;
          if (p < P)
            st2(yrow + p, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    __syncthreads();   // ss, hs and this head's X stage are free
  }

  // the last block to finish sets the tickets and flags back to zero
  cp_async_wait<0>();
  const int total = nc * per_chunk;
  if (tid == 0) s_ticket = atom_add_acq_rel_gpu(&sync[1], 1) == total - 1;
  __syncthreads();
  if (s_ticket) {
    for (int k = tid; k < total; k += kThreads) sync[2 + k] = 0;
    if (tid == 0) sync[0] = sync[1] = 0;
  }
}

template <typename T, bool SPLIT>
cudaError_t launch(const void* X, const float* Bm, const float* Cm,
                   const float* dt, const float* la, void* Y, float* h_out,
                   float* slots, int* sync, int B, int S, int H, int P,
                   int N, cudaStream_t stream) {
  constexpr int smem = Smem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int nc = (S + kQ - 1) / kQ, ng = (H + kHG - 1) / kHG;
  const long long blocks = (long long)nc * B * ng;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_kernel<T, SPLIT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(X), Bm, Cm, dt, la, static_cast<T*>(Y), h_out,
      slots, sync, B, S, H, P, N, nc, ng);
  return cudaGetLastError();
}

}  // namespace

// The rows of the kernel's own chunk, and the ints of the sync buffer a
// call of (B, S, H) needs: a ticket, a count of finished blocks and a flag
// per block.
extern "C" int rt_ssm_scan_chunk() { return kQ; }
extern "C" long long rt_ssm_scan_sync_len(int B, int S, int H) {
  return 2 + (long long)((S + kQ - 1) / kQ) * B * ((H + kHG - 1) / kHG);
}

// slots: 2 * B * H * 64 * 64 f32 of scratch; sync: at least
// rt_ssm_scan_sync_len(B, S, H) ints, zero before the first call, left
// at zero by every call.
extern "C" int rt_ssm_scan(const void* X, const void* Bm, const void* Cm,
                           const void* dt, const void* la, void* Y,
                           void* h_out, void* slots, void* sync,
                           long long sync_len, int B, int S, int H, int P,
                           int N, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kQ || P % 8 != 0 ||
      N <= 0 || N > kQ || N % 8 != 0 ||
      sync_len < rt_ssm_scan_sync_len(B, S, H))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(Bm);
  const float* c = static_cast<const float*>(Cm);
  const float* d = static_cast<const float*>(dt);
  const float* l = static_cast<const float*>(la);
  float* ho = static_cast<float*>(h_out);
  float* sl = static_cast<float*>(slots);
  int* sy = static_cast<int*>(sync);
  return (int)(x_is_bf16
                   ? launch<__nv_bfloat16, false>(X, b, c, d, l, Y, ho, sl,
                                                  sy, B, S, H, P, N, s)
                   : launch<float, true>(X, b, c, d, l, Y, ho, sl, sy, B, S,
                                         H, P, N, s));
}
