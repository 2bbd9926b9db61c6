// One-token attention over a KV cache for Hopper (sm_90a), forward only.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, _decode_kernel
// (the Pallas kernel behind flash_decode_bhsd / ops.flash_decode).
// Computes: for each (batch, query head) softmax(q k^T / sqrt(hd)) v over
// the first `length` cache positions; GQA maps query head h to KV head
// h / n_rep; an int8 cache is dequantised with its per-(token, kv-head)
// f32 scale as it is loaded; f32 math, running (m, l, acc), denominator
// clamped at 1e-20, output f32.  q: (B, 1, H, hd) f32 or bf16; cache:
// (B, Smax, Hkv, hd) f32 / bf16 / int8 (+ scales (B, Smax, Hkv, 1) f32).
//
// Bound on this card: bytes.  Every cache element is used for 2*n_rep
// multiply-adds and read once, so the least time is the LIVE part of the
// cache (B * length * Hkv * hd elements of K and of V, plus the scales)
// over the memory bandwidth.
//
// Design, and what differs from the reference.  (1) The reference maps
// the same KV tile to each of the n_rep query heads of a group and so
// reads it n_rep times; here one block serves up to 4 query heads of a
// group from ONE read of K/V (a group wider than 4 takes ceil(n_rep/4)
// blocks, the re-reads then coming mostly from L2).  (2) The reference
// streams all Smax positions and masks the dead ones; here the grid has
// ceil(length / block_kv) KV tiles and positions >= length are never
// read (they carry weight exp(-1e30 - m) = 0 in the reference).  (3) The
// reference walks the KV axis sequentially with (m, l, acc) in scratch;
// here the KV tiles run as parallel blocks -- B * Hkv blocks alone would
// leave most of the SMs idle -- each writing a partial (m, l, acc), and a
// second small kernel merges the partials.  Loads are 16 bytes per lane:
// a row of hd elements is spread over LPR neighbouring lanes, LPR being
// the row's count of 16-byte vectors rounded up to a power of two (so
// the xor shuffles pair lanes of one row) and capped at 32; an f32 row
// of more than 128 dims gives each lane two vectors (VPL = 2).  At hd
// 112 a bf16 row is 14 vectors on 16 lanes, an int8 row 7 on 8 lanes:
// a vector past hd is never loaded, holds 0 and is never stored.  A warp
// reads several rows per instruction, and two rows per lane group are
// in flight.  `length` is a plain integer argument: the cache position
// lives on the host, so no step reads it back from the device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kHeads = 4;    // query heads of one GQA group per block
constexpr int kUnroll = 2;   // cache rows in flight per lane group
constexpr int kMaxHD = 256;  // largest head dim a row may have

template <typename KV> struct Elems { static constexpr int n = 16 / sizeof(KV); };

__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = e[i];
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const int8_t*) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)e[i];
}

// Partial attention of up to kHeads query heads over one KV tile.
template <typename KV, int LPR, int VPL>
__global__ void __launch_bounds__(32 * kWarps)
decode_partial_kernel(const void* __restrict__ q, int q_is_bf16,
                      const KV* __restrict__ k, const KV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Smax, int H, int Hkv,
                      int HD, int length, int block_kv, int n_tiles,
                      float scale) {
  constexpr int EPL = Elems<KV>::n;   // elements per 16-byte vector
  constexpr int EPT = EPL * VPL;      // elements per lane
  constexpr int RPW = 32 / LPR;       // rows per warp per load
  constexpr int RPI = kWarps * RPW;   // rows per block per load
  constexpr bool kQuant = sizeof(KV) == 1;
  static_assert(LPR >= 1 && LPR <= 32 && (LPR & (LPR - 1)) == 0,
                "a row is a power-of-two lane group within a warp");

  const int n_rep = H / Hkv;
  const int n_chunks = (n_rep + kHeads - 1) / kHeads;
  const int tile = blockIdx.x;
  const int kvh = blockIdx.y / n_chunks;
  const int chunk = blockIdx.y % n_chunks;
  const int b = blockIdx.z;
  const int h0 = kvh * n_rep + chunk * kHeads;
  const int nh = min(kHeads, n_rep - chunk * kHeads);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, sl = lane % LPR;
  // first dim of this lane's vector u; the vector exists if dim0 < HD
  int dim0[VPL];
  bool on[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    dim0[u] = (u * LPR + sl) * EPL;
    on[u] = dim0[u] < HD;
  }

  float qf[kHeads][EPT], acc[kHeads][EPT], m[kHeads], l[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float val = 0.f;
        if (hh < nh && on[u]) {
          const size_t idx = ((size_t)b * H + h0 + hh) * HD + dim0[u] + e;
          val = q_is_bf16
                    ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(q)[idx])
                    : static_cast<const float*>(q)[idx];
        }
        qf[hh][u * EPL + e] = val * scale;
        acc[hh][u * EPL + e] = 0.f;
      }
    }
  }

  const int start = tile * block_kv;
  const int end = min(length, start + block_kv);
  const size_t row_stride = (size_t)Hkv * HD;              // elements
  const KV* kb = k + ((size_t)b * Smax * Hkv + kvh) * HD;
  const KV* vb = v + ((size_t)b * Smax * Hkv + kvh) * HD;
  const size_t sc_base = (size_t)b * Smax * Hkv + kvh;     // + j * Hkv

  // `base` is uniform over the warp, so every lane runs every shuffle
  for (int base = start + warp * RPW; base < end; base += RPI * kUnroll) {
    uint4 kraw[kUnroll][VPL], vraw[kUnroll][VPL];
    float ksc[kUnroll], vsc[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int j = base + grp + r * RPI;
      live[r] = j < end;
      ksc[r] = 1.f;
      vsc[r] = 1.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        kraw[r][u] = make_uint4(0, 0, 0, 0);
        vraw[r][u] = make_uint4(0, 0, 0, 0);
        if (live[r] && on[u]) {
          const size_t off = (size_t)j * row_stride + dim0[u];
          kraw[r][u] = *reinterpret_cast<const uint4*>(kb + off);
          vraw[r][u] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
      if (kQuant && live[r]) {
        ksc[r] = k_scale[sc_base + (size_t)j * Hkv];
        vsc[r] = v_scale[sc_base + (size_t)j * Hkv];
      }
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      float kf[EPT], vf[EPT];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        unpack(kraw[r][u], kf + u * EPL, static_cast<const KV*>(nullptr));
        unpack(vraw[r][u], vf + u * EPL, static_cast<const KV*>(nullptr));
      }
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          kf[e] *= ksc[r];
          vf[e] *= vsc[r];
        }
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh < nh) {   // uniform over the block
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) s = fmaf(qf[hh][e], kf[e], s);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (live[r]) {
            const float m_new = fmaxf(m[hh], s);
            const float corr = expf(m[hh] - m_new);
            const float p = expf(s - m_new);
            l[hh] = l[hh] * corr + p;
            m[hh] = m_new;
#pragma unroll
            for (int e = 0; e < EPT; ++e)
              acc[hh][e] = fmaf(p, vf[e], acc[hh][e] * corr);
          }
        }
      }
    }
  }

  // merge the lane groups of a warp (they hold the same dims, other rows)
  __shared__ float sm_m[kWarps][kHeads], sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][kMaxHD];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hh], off);
      const float m_new = fmaxf(m[hh], m_o);
      const float ca = expf(m[hh] - m_new), cb = expf(m_o - m_new);
      l[hh] = l[hh] * ca + l_o * cb;
      m[hh] = m_new;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[hh][e], off);
        acc[hh][e] = acc[hh][e] * ca + a_o * cb;
      }
    }
    if (grp == 0) {
      if (sl == 0) {
        sm_m[warp][hh] = m[hh];
        sm_l[warp][hh] = l[hh];
      }
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        if (on[u]) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            sm_acc[warp][hh][dim0[u] + e] = acc[hh][u * EPL + e];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps; thread d writes dim d (and d + 128) of this tile's
  // partial result
  for (int d = threadIdx.x; d < HD; d += 32 * kWarps) {
    for (int hh = 0; hh < nh; ++hh) {
      float mm = sm_m[0][hh];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][hh]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w][hh] - mm);
        ll += sm_l[w][hh] * c;
        aa += sm_acc[w][hh][d] * c;
      }
      const size_t p = ((size_t)b * H + h0 + hh) * n_tiles + tile;
      part_acc[p * HD + d] = aa;
      if (d == 0) {
        part_m[p] = mm;
        part_l[p] = ll;
      }
    }
  }
}

// Merge the per-tile partials of one (batch, head): thread d owns dim d.
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    float* __restrict__ out, int n_tiles,
                                    int hd) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * n_tiles;
  const float* pl = part_l + bh * n_tiles;
  float mm = kNegInf;
  for (int t = 0; t < n_tiles; ++t) mm = fmaxf(mm, pm[t]);
  float ll = 0.f, aa = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const float c = expf(pm[t] - mm);
    ll += pl[t] * c;
    aa += part_acc[(bh * n_tiles + t) * hd + d] * c;
  }
  out[bh * hd + d] = aa / fmaxf(ll, 1e-20f);
}

template <typename KV, int LPR, int VPL>
cudaError_t launch(const void* q, int q_is_bf16, const void* k, const void* v,
                   const void* k_scale, const void* v_scale, float* part_m,
                   float* part_l, float* part_acc, float* out, int B, int Smax,
                   int H, int Hkv, int hd, int length, int block_kv,
                   int n_tiles, cudaStream_t stream) {
  const int n_rep = H / Hkv;
  const int n_chunks = (n_rep + kHeads - 1) / kHeads;
  const dim3 grid(n_tiles, Hkv * n_chunks, B);
  const float scale = 1.0f / sqrtf((float)hd);
  decode_partial_kernel<KV, LPR, VPL><<<grid, 32 * kWarps, 0, stream>>>(
      q, q_is_bf16, static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      part_m, part_l, part_acc, Smax, H, Hkv, hd, length, block_kv, n_tiles,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<B * H, hd, 0, stream>>>(part_m, part_l, part_acc, out,
                                                n_tiles, hd);
  return cudaGetLastError();
}

// hd: any multiple of 16 up to 256.  The lane group of a row is the
// row's count of 16-byte vectors rounded up to a power of two; only the
// group sizes a cache type can need are instantiated.
template <typename KV>
cudaError_t dispatch_hd(const void* q, int q_is_bf16, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, float* part_m, float* part_l,
                        float* part_acc, float* out, int B, int Smax, int H,
                        int Hkv, int hd, int length, int block_kv, int n_tiles,
                        cudaStream_t stream) {
  if (hd < 16 || hd > kMaxHD || hd % 16 != 0) return cudaErrorInvalidValue;
  constexpr int EPL = Elems<KV>::n;
  const int vecs = hd / EPL;   // 16-byte vectors in a row
#define RT_DECODE(LPR, VPL)                                                  \
  return launch<KV, LPR, VPL>(q, q_is_bf16, k, v, k_scale, v_scale, part_m,  \
                              part_l, part_acc, out, B, Smax, H, Hkv, hd,    \
                              length, block_kv, n_tiles, stream)
  if constexpr (EPL == 16) {
    if (vecs <= 1) RT_DECODE(1, 1);
  }
  if constexpr (EPL >= 8) {
    if (vecs <= 2) RT_DECODE(2, 1);
  }
  if (vecs <= 4) RT_DECODE(4, 1);
  if (vecs <= 8) RT_DECODE(8, 1);
  if (vecs <= 16) RT_DECODE(16, 1);
  if constexpr (EPL <= 8) {
    if (vecs <= 32) RT_DECODE(32, 1);
  }
  if constexpr (EPL == 4) {
    if (vecs <= 64) RT_DECODE(32, 2);
  }
#undef RT_DECODE
  return cudaErrorInvalidValue;
}

}  // namespace

// kv_kind: 0 = f32 cache, 1 = bf16 cache, 2 = int8 cache with f32 scales.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               void* part_m, void* part_l, void* part_acc,
                               void* out, int B, int Smax, int H, int Hkv,
                               int hd, int length, int block_kv, int n_tiles,
                               int kv_kind, int q_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      length < 1 || length > Smax || block_kv < 1 ||
      n_tiles != (length + block_kv - 1) / block_kv)
    return (int)cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  switch (kv_kind) {
    case 0:
      return (int)dispatch_hd<float>(q, q_is_bf16, k, v, k_scale, v_scale, pm,
                                     pl, pa, o, B, Smax, H, Hkv, hd, length,
                                     block_kv, n_tiles, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(q, q_is_bf16, k, v, k_scale,
                                             v_scale, pm, pl, pa, o, B, Smax,
                                             H, Hkv, hd, length, block_kv,
                                             n_tiles, s);
    case 2:
      if (k_scale == nullptr || v_scale == nullptr)
        return (int)cudaErrorInvalidValue;
      return (int)dispatch_hd<int8_t>(q, q_is_bf16, k, v, k_scale, v_scale,
                                      pm, pl, pa, o, B, Smax, H, Hkv, hd,
                                      length, block_kv, n_tiles, s);
    default:
      return cudaErrorInvalidValue;
  }
}
