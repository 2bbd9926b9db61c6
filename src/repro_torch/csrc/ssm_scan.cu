// Chunked Mamba2 / SSD scan for Hopper (sm_90a), forward only.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, _ssd_kernel (the
// Pallas kernel behind ssm_scan_grid / ops.ssm_scan).
// Computes, for each (batch, head) and each chunk of Q positions, with
// cum the inclusive cumulative sum of la over the chunk and h the
// (P x N) state carried from the chunks before:
//   y_t = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j X_j      (within)
//       + exp(cum_t) C_t . h                                      (carried)
//   h  <- exp(cum_last) h + sum_j dt_j exp(cum_last - cum_j) X_j B_j^T
// which is the per-token recurrence h_t = exp(la_t) h_{t-1} +
// dt_t X_t B_t^T, y_t = C_t . h_t of the reference's oracle, taken a
// chunk at a time.  All math is f32, as in the reference, but for the
// cumulative sum of la over a chunk, which is taken and differenced in
// f64: cum reaches |cum| ~ 10^2 within a chunk of 256, where an f32 cum
// is off by ~1e-5, and exp(cum_t - cum_j) turns that into a relative
// error of every near-diagonal term; two f32 cumsums taken in different
// orders then disagree by ~1e-3 on outputs near 0 (6.4e-4 measured at
// S = 1000, chunk 250).  Layouts are the model's: X, Y (B, S, H, P) in
// f32 or bf16 (Y in X's dtype); Bm, Cm (B, S, N) f32; dt, la (B, S, H)
// f32; h_final (B, H, P, N) f32.
//
// Bound on this card: operations.  Per (batch, head) and chunk the
// causal half of the Q x Q scores times X, C h^T and the state update
// are about (Q/2 + 2N) * P multiply-adds per position against
// 2 * sizeof(X) * P bytes of X and Y per position: at Q = 256, P = N = 64
// that is some 100 flops per byte, and the operands (B, C, the decayed
// scores) are f32, so the rate to hold it against is the card's f32 rate.
//
// Design.  The TPU kernel walks the chunks as a sequential grid axis and
// carries h in VMEM scratch; blocks here run in no order, so ONE block
// owns a (batch, head) and LOOPS over the chunks, h staying in shared
// memory (64 x 64 f32).  The Q x Q score matrix (256 KB of f32 at
// Q = 256) does not fit a block's shared memory: it is formed a 64 x 64
// tile at a time -- rows t of a row tile against keys j of a key tile,
// only the key tiles at or before the row tile -- decayed and masked in
// registers, put in shared memory and multiplied by the key tile's X at
// once.  The row tile's carried-state term starts its accumulator; the
// last row tile also accumulates the state update while it has each key
// tile's B and X in shared memory, so every tile of B, C and X is read
// from device memory once per (head, row tile).  256 threads each own a
// 4 x 4 piece of every 64 x 64 product.  P and N up to 64 and any chunk
// Q >= 1 up to 1024 are right: tiles are zero-padded past P, N and the
// chunk's end.  A small Q (the wrapper fits the chunk to a divisor of S,
// so a prime S gives Q = 1) costs whole 64-row tiles per chunk.
// Fill: B * H blocks of 256 threads, two resident per SM (shared memory
// 98,816 B each); at B = 4, H = 112 that is 448 blocks for 264 places.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // tile edge; also the largest P and N
constexpr int kPad = kT + 1;      // row stride of the transposed tiles
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxChunk = 1024;
constexpr size_t kSmemBytes = sizeof(double) * kMaxChunk +
                              sizeof(float) * (2 * kT * kPad + 3 * kT * kT +
                                               2 * kMaxChunk);

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(const T* __restrict__ X, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ dt,
           const float* __restrict__ la, T* __restrict__ Y,
           float* __restrict__ h_out, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);  // cumulative la, f64
  float* cs = reinterpret_cast<float*>(cum + kMaxChunk);  // C, [n][t]
  float* bs = cs + kT * kPad;      // B of the key tile, [n][j]
  float* xs = bs + kT * kPad;      // X of the key tile, [j][p]
  float* ss = xs + kT * kT;        // decayed scores, [j][t]
  float* hs = ss + kT * kT;        // carried state, [n][p]
  float* dts = hs + kT * kT;       // dt over the chunk
  float* ws = dts + kMaxChunk;     // dt_j exp(cum_last - cum_j)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nc = S / Q;
  const int nt = (Q + kT - 1) / kT;
  const size_t xrow = (size_t)H * P;   // X / Y row stride
  const T* xb = X + (size_t)b * S * xrow + (size_t)h * P;
  T* yb = Y + (size_t)b * S * xrow + (size_t)h * P;
  const float* bb = Bm + (size_t)b * S * N;
  const float* cb = Cm + (size_t)b * S * N;
  const float* dtb = dt + (size_t)b * S * H + h;
  const float* lab = la + (size_t)b * S * H + h;

  for (int i = tid; i < kT * kT; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();   // the previous chunk is done with cum, dts, ws, hs
    for (int i = tid; i < Q; i += kThreads) {
      cum[i] = lab[(size_t)(c0 + i) * H];
      dts[i] = dtb[(size_t)(c0 + i) * H];
    }
    __syncthreads();
    if (tid < 32) {    // inclusive prefix sum of la, 32 at a time
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        double v = i < Q ? cum[i] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (i < Q) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double cum_last = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads)
      ws[i] = dts[i] * expf((float)(cum_last - cum[i]));

    float hacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) hacc[i][m] = 0.f;

    for (int rt = 0; rt < nt; ++rt) {
      const int r0 = rt * kT;
      const int rn = min(kT, Q - r0);
      __syncthreads();   // cs is free, ws is written
      for (int i = tid; i < kT * kT; i += kThreads) {
        const int t = i / kT, n = i % kT;
        cs[n * kPad + t] =
            (t < rn && n < N) ? cb[(size_t)(c0 + r0 + t) * N + n] : 0.f;
      }
      __syncthreads();

      // carried-state term: acc[t][p] = exp(cum_t) * sum_n C_t[n] h[p][n]
      // (thread: t = ty + 16 i, p = tx + 16 m)
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[n * kPad + ty + 16 * i];
#pragma unroll
        for (int m = 0; m < 4; ++m) hv[m] = hs[n * kT + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[i][m] = fmaf(cv[i], hv[m], acc[i][m]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = t < rn ? expf((float)cum[r0 + t]) : 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[i][m] *= e;
      }

      const bool last = rt == nt - 1;
      for (int kt = 0; kt <= rt; ++kt) {
        const int j0 = kt * kT;
        const int jn = min(kT, Q - j0);
        __syncthreads();   // bs, xs, ss are free
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int j = i / kT, n = i % kT;
          const size_t pos = (size_t)(c0 + j0 + j);
          bs[n * kPad + j] = (j < jn && n < N) ? bb[pos * N + n] : 0.f;
          xs[j * kT + n] = (j < jn && n < P) ? ld(xb + pos * xrow + n) : 0.f;
        }
        __syncthreads();

        // decayed scores, transposed: ss[j][t] = (B_j . C_t) *
        // exp(cum_t - cum_j) * dt_j for t >= j, else 0
        // (thread: j = ty + 16 i, t = tx + 16 m)
        {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) s[i][m] = 0.f;
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            float bv[4], cv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) bv[i] = bs[n * kPad + ty + 16 * i];
#pragma unroll
            for (int m = 0; m < 4; ++m) cv[m] = cs[n * kPad + tx + 16 * m];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int m = 0; m < 4; ++m) s[i][m] = fmaf(bv[i], cv[m], s[i][m]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = ty + 16 * i, jg = j0 + j;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int t = tx + 16 * m, tg = r0 + t;
              float val = 0.f;
              if (j < jn && t < rn && tg >= jg)
                val = s[i][m] * expf((float)(cum[tg] - cum[jg])) * dts[jg];
              ss[j * kT + t] = val;
            }
          }
        }
        __syncthreads();

        // within-chunk term: acc[t][p] += sum_j ss[j][t] * X_j[p]
#pragma unroll 4
        for (int j = 0; j < jn; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = ss[j * kT + ty + 16 * i];
#pragma unroll
          for (int m = 0; m < 4; ++m) xv[m] = xs[j * kT + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m)
              acc[i][m] = fmaf(sv[i], xv[m], acc[i][m]);
        }
        // state update: hacc[n][p] += sum_j (ws_j B_j[n]) X_j[p]
        // (thread: n = ty + 16 i, p = tx + 16 m)
        if (last) {
#pragma unroll 4
          for (int j = 0; j < jn; ++j) {
            const float w = ws[j0 + j];
            float bv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              bv[i] = bs[(ty + 16 * i) * kPad + j] * w;
#pragma unroll
            for (int m = 0; m < 4; ++m) xv[m] = xs[j * kT + tx + 16 * m];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int m = 0; m < 4; ++m)
                hacc[i][m] = fmaf(bv[i], xv[m], hacc[i][m]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t < rn) {
          T* yrow = yb + (size_t)(c0 + r0 + t) * xrow;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int p = tx + 16 * m;
            if (p < P) st(yrow + p, acc[i][m]);
          }
        }
      }
    }

    __syncthreads();   // every row tile has read h
    const float a_chunk = expf((float)cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float* hp = hs + (ty + 16 * i) * kT + tx + 16 * m;
        *hp = a_chunk * *hp + hacc[i][m];
      }
  }

  __syncthreads();
  float* ho = h_out + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    ho[i] = hs[n * kT + p];
  }
}

template <typename T>
cudaError_t launch(const void* X, const float* Bm, const float* Cm,
                   const float* dt, const float* la, void* Y, float* h_out,
                   int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(X), Bm, Cm, dt, la, static_cast<T*>(Y), h_out, S,
      H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_ssm_scan(const void* X, const void* Bm, const void* Cm,
                           const void* dt, const void* la, void* Y,
                           void* h_out, int B, int S, int H, int P, int N,
                           int Q, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || P <= 0 || P > kT ||
      N <= 0 || N > kT || Q <= 0 || Q > kMaxChunk || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(Bm);
  const float* c = static_cast<const float*>(Cm);
  const float* d = static_cast<const float*>(dt);
  const float* l = static_cast<const float*>(la);
  float* ho = static_cast<float*>(h_out);
  return (int)(x_is_bf16
                   ? launch<__nv_bfloat16>(X, b, c, d, l, Y, ho, B, S, H, P,
                                           N, Q, s)
                   : launch<float>(X, b, c, d, l, Y, ho, B, S, H, P, N, Q,
                                   s));
}
