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
// a row of hd elements is spread over hd*sizeof/16 neighbouring lanes, a
// warp reads several rows per instruction, and two rows per lane group
// are in flight.  `length` is a plain integer argument: the cache
// position lives on the host, so no step reads it back from the device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kHeads = 4;    // query heads of one GQA group per block
constexpr int kUnroll = 2;   // cache rows in flight per lane group

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
template <typename KV, int HD>
__global__ void __launch_bounds__(32 * kWarps)
decode_partial_kernel(const void* __restrict__ q, int q_is_bf16,
                      const KV* __restrict__ k, const KV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Smax, int H, int Hkv,
                      int length, int block_kv, int n_tiles, float scale) {
  constexpr int EPL = Elems<KV>::n;   // elements per lane (one 16-byte load)
  constexpr int LPR = HD / EPL;       // lanes per cache row
  constexpr int RPW = 32 / LPR;       // rows per warp per load
  constexpr int RPI = kWarps * RPW;   // rows per block per load
  constexpr bool kQuant = sizeof(KV) == 1;
  static_assert(LPR >= 1 && LPR <= 32, "row must fit a warp");

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

  float qf[kHeads][EPL], acc[kHeads][EPL], m[kHeads], l[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float val = 0.f;
      if (hh < nh) {
        const size_t idx = ((size_t)b * H + h0 + hh) * HD + sl * EPL + e;
        val = q_is_bf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[idx])
                  : static_cast<const float*>(q)[idx];
      }
      qf[hh][e] = val * scale;
      acc[hh][e] = 0.f;
    }
  }

  const int start = tile * block_kv;
  const int end = min(length, start + block_kv);
  const size_t row_stride = (size_t)Hkv * HD;              // elements
  const KV* kb = k + ((size_t)b * Smax * Hkv + kvh) * HD + sl * EPL;
  const KV* vb = v + ((size_t)b * Smax * Hkv + kvh) * HD + sl * EPL;
  const size_t sc_base = (size_t)b * Smax * Hkv + kvh;     // + j * Hkv

  // `base` is uniform over the warp, so every lane runs every shuffle
  for (int base = start + warp * RPW; base < end; base += RPI * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + grp + u * RPI;
      live[u] = j < end;
      kraw[u] = make_uint4(0, 0, 0, 0);
      vraw[u] = make_uint4(0, 0, 0, 0);
      ksc[u] = 1.f;
      vsc[u] = 1.f;
      if (live[u]) {
        kraw[u] = *reinterpret_cast<const uint4*>(kb + (size_t)j * row_stride);
        vraw[u] = *reinterpret_cast<const uint4*>(vb + (size_t)j * row_stride);
        if (kQuant) {
          ksc[u] = k_scale[sc_base + (size_t)j * Hkv];
          vsc[u] = v_scale[sc_base + (size_t)j * Hkv];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[EPL], vf[EPL];
      unpack(kraw[u], kf, static_cast<const KV*>(nullptr));
      unpack(vraw[u], vf, static_cast<const KV*>(nullptr));
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[e] *= ksc[u];
          vf[e] *= vsc[u];
        }
      }
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh < nh) {   // uniform over the block
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qf[hh][e], kf[e], s);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (live[u]) {
            const float m_new = fmaxf(m[hh], s);
            const float corr = expf(m[hh] - m_new);
            const float p = expf(s - m_new);
            l[hh] = l[hh] * corr + p;
            m[hh] = m_new;
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[hh][e] = fmaf(p, vf[e], acc[hh][e] * corr);
          }
        }
      }
    }
  }

  // merge the lane groups of a warp (they hold the same dims, other rows)
  __shared__ float sm_m[kWarps][kHeads], sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][HD];
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
      for (int e = 0; e < EPL; ++e) {
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
      for (int e = 0; e < EPL; ++e) sm_acc[warp][hh][sl * EPL + e] = acc[hh][e];
    }
  }
  __syncthreads();

  // merge the warps; thread d writes dim d of this tile's partial result
  const int d = threadIdx.x;
  if (d < HD) {
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

template <typename KV, int HD>
cudaError_t launch(const void* q, int q_is_bf16, const void* k, const void* v,
                   const void* k_scale, const void* v_scale, float* part_m,
                   float* part_l, float* part_acc, float* out, int B, int Smax,
                   int H, int Hkv, int length, int block_kv, int n_tiles,
                   cudaStream_t stream) {
  const int n_rep = H / Hkv;
  const int n_chunks = (n_rep + kHeads - 1) / kHeads;
  const dim3 grid(n_tiles, Hkv * n_chunks, B);
  const float scale = 1.0f / sqrtf((float)HD);
  decode_partial_kernel<KV, HD><<<grid, 32 * kWarps, 0, stream>>>(
      q, q_is_bf16, static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      part_m, part_l, part_acc, Smax, H, Hkv, length, block_kv, n_tiles,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<<<B * H, HD, 0, stream>>>(part_m, part_l, part_acc, out,
                                                n_tiles, HD);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t dispatch_hd(const void* q, int q_is_bf16, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, float* part_m, float* part_l,
                        float* part_acc, float* out, int B, int Smax, int H,
                        int Hkv, int hd, int length, int block_kv, int n_tiles,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<KV, 32>(q, q_is_bf16, k, v, k_scale, v_scale, part_m,
                            part_l, part_acc, out, B, Smax, H, Hkv, length,
                            block_kv, n_tiles, stream);
    case 64:
      return launch<KV, 64>(q, q_is_bf16, k, v, k_scale, v_scale, part_m,
                            part_l, part_acc, out, B, Smax, H, Hkv, length,
                            block_kv, n_tiles, stream);
    case 128:
      return launch<KV, 128>(q, q_is_bf16, k, v, k_scale, v_scale, part_m,
                             part_l, part_acc, out, B, Smax, H, Hkv, length,
                             block_kv, n_tiles, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
