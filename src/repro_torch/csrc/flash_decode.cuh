// Shared by flash_decode*.cu: the one-launch decode kernel and its
// launcher, templated on the cache type; see flash_decode.cu for what
// it computes and how.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt_decode {

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  float *part_m, *part_l, *part_acc;
  int* tickets;
  void* out;
  int q_is_bf16, B, Smax, H, Hkv, hd, length, span, n_split, warps,
      stages;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxWarps = 8;   // warps per block: 4 or 8, the wrapper's
constexpr int kMergeFloats = 16384;   // n_split * NH * hd the merge reads

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's groups are in flight (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a 16-byte chunk of a cache row widened to f32
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = e[i];
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const bf16*) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// int8 b: the float with bits 0x4B0000uu, uu = b + 128 as a byte, is
// 2^23 + 128 + b; one byte permute and one subtraction per element
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const int8_t*) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t biased = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + j)) -
          8388736.f;
  }
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int q_is_bf16) {
  if (q_is_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// Rows a lane group takes per tile: 8; 4 where a lane holds two chunks
// of a row (f32 over 128 dims) or widens 16 int8 values per chunk, so a
// tile costs about the same work at every cache type.
template <typename KV, int VPL>
__host__ __device__ constexpr int tile_steps() {
  return (sizeof(KV) == 1 ? 4 : 8) / VPL;
}

struct Layout {   // shared memory of one block, offsets in bytes
  int row_bytes, stage, ring, red, w, blk, total;
  // rows: cache rows in a warp tile; slots: query heads of the block
  __host__ __device__ Layout(int hd, int kv_bytes, int rows, int slots,
                             int warps, int stages) {
    row_bytes = hd * kv_bytes + 16;   // padded: rows start in other banks
    stage = 2 * rows * (row_bytes + 4);        // K and V rows, their scales
    ring = stages * stage;                     // one ring per warp
    red = warps * ring;                        // warps' acc, m, l
    w = red + warps * slots * (hd + 2) * 4;    // merge weights
    blk = w + (kMergeFloats / hd) * 4;         // block's m, l
    total = blk + 2 * slots * 4;
  }
};

template <typename KV, int L, int VPL, int NH>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_kernel(const void* __restrict__ q, int q_is_bf16,
              const KV* __restrict__ k, const KV* __restrict__ v,
              const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc,
              int* __restrict__ tickets, void* __restrict__ out, int Smax,
              int H, int Hkv, int HD, int length, int span, int n_split,
              int stages, float scale_log2) {
  constexpr int EPC = 16 / sizeof(KV);   // elements per 16-byte chunk
  constexpr int EPL = EPC * VPL;         // elements per lane
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int G = 32 / L;              // lane groups (rows) in a warp
  constexpr int U = tile_steps<KV, VPL>();   // rows per lane group per tile
  constexpr int T = G * U;               // rows per warp tile
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0,
                "a row is a power-of-two lane group within a warp");
  const int n_warps = blockDim.x >> 5, n_threads = blockDim.x;
  const Layout lay(HD, sizeof(KV), T, NH, n_warps, stages);

  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* wts = reinterpret_cast<float*>(smem + lay.w);
  float* blk_m = reinterpret_cast<float*>(smem + lay.blk);
  float* blk_l = blk_m + NH;
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / L, sl = lane % L;
  const int n_rep = H / Hkv;
  const int n_chunks = (n_rep + NH - 1) / NH;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_chunks, chunk = blockIdx.y % n_chunks;
  const int b = blockIdx.z;
  const int nh = min(NH, n_rep - chunk * NH);    // query heads served
  const int start = split * span;
  const int end = min(length, start + span);
  const int cpr = HD / EPC;                      // 16-byte chunks per row
  const size_t row_stride = (size_t)Hkv * HD;    // elements
  const size_t kv0 = ((size_t)b * Smax * Hkv + kvh) * HD;
  const size_t sc0 = (size_t)b * Smax * Hkv + kvh;   // + j * Hkv
  const size_t gh = (size_t)b * H + (size_t)kvh * n_rep + chunk * NH;

  // this lane's chunks of a row: sl, sl + L, ...; those past cpr are off
  bool on[VPL];
#pragma unroll
  for (int u = 0; u < VPL; ++u) on[u] = sl + u * L < cpr;

  // q, pre-scaled by log2(e)/sqrt(hd), for this lane's dims (slots past
  // nh hold 0)
  float qf[NH][EPL], acc[NH][EPL], m[NH], l[NH];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        float val = 0.f;
        if (hh < nh && on[u]) {
          const size_t idx = (gh + hh) * HD + (sl + u * L) * EPC + e;
          val = q_is_bf16
                    ? __bfloat162float(static_cast<const bf16*>(q)[idx])
                    : static_cast<const float*>(q)[idx];
        }
        qf[hh][u * EPC + e] = val * scale_log2;
        acc[hh][u * EPC + e] = 0.f;
      }
    }
  }

  // this warp's tiles: w, w + n_warps, ... of the span's tiles of T rows
  const int n_tiles = (end - start + T - 1) / T;
  const int n_mine =
      n_tiles > warp ? (n_tiles - warp + n_warps - 1) / n_warps : 0;
  unsigned char* ring = smem + warp * lay.ring;
  auto load_tile = [&](int i) {
    unsigned char* st = ring + (i % stages) * lay.stage;
    unsigned char* scl = st + 2 * T * lay.row_bytes;
    const int j0 = start + (warp + n_warps * i) * T;
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int r = s * G + grp;
      const bool ok = j0 + r < end;
      const size_t src = kv0 + (size_t)(ok ? j0 + r : start) * row_stride;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        if (on[u]) {
          const int c = sl + u * L;
          cp_async16(smem_addr(st + r * lay.row_bytes + c * 16),
                     k + src + c * EPC, ok);
          cp_async16(smem_addr(st + (T + r) * lay.row_bytes + c * 16),
                     v + src + c * EPC, ok);
        }
      }
      if (kQuant && sl == 0) {
        const size_t sc = sc0 + (size_t)(ok ? j0 + r : start) * Hkv;
        cp_async4(smem_addr(scl + r * 4), k_scale + sc, ok);
        cp_async4(smem_addr(scl + (T + r) * 4), v_scale + sc, ok);
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_mine) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait(stages - 2);   // tile i has landed (this lane's copies)
    __syncwarp();                // ... every lane's; tile i-1 is released
    if (i + stages - 1 < n_mine) load_tile(i + stages - 1);
    cp_async_commit();

    const unsigned char* st = ring + (i % stages) * lay.stage;
    const float* scl =
        reinterpret_cast<const float*>(st + 2 * T * lay.row_bytes);
    const int j0 = start + (warp + n_warps * i) * T;
    // scores (base 2) of this lane group's U rows, for every query head
    float p[NH][U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int r = s * G + grp;
      float dot[NH];
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) dot[hh] = 0.f;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        float kf[EPC];
        unpack(on[u] ? *reinterpret_cast<const uint4*>(
                           st + r * lay.row_bytes + (sl + u * L) * 16)
                     : make_uint4(0, 0, 0, 0),
               kf, static_cast<const KV*>(nullptr));
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            dot[hh] = fmaf(qf[hh][u * EPC + e], kf[e], dot[hh]);
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], off);
        if (kQuant) dot[hh] *= scl[r];
        p[hh][s] = j0 + r < end ? dot[hh] : kNegInf;
      }
    }
    // one online-softmax update per query head for the U rows
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int s = 0; s < U; ++s) mx = fmaxf(mx, p[hh][s]);
      const float corr = exp2f(m[hh] - mx);
      float psum = 0.f;
#pragma unroll
      for (int s = 0; s < U; ++s) {
        p[hh][s] = exp2f(p[hh][s] - mx);
        psum += p[hh][s];
        if (kQuant) p[hh][s] *= scl[T + s * G + grp];   // V's scale
      }
      l[hh] = l[hh] * corr + psum;
      m[hh] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[hh][e] *= corr;
    }
    // acc += P.V
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int r = T + s * G + grp;
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        if (!on[u]) continue;
        float vf[EPC];
        unpack(*reinterpret_cast<const uint4*>(
                   st + r * lay.row_bytes + (sl + u * L) * 16),
               vf, static_cast<const KV*>(nullptr));
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[hh][u * EPC + e] =
                fmaf(p[hh][s], vf[e], acc[hh][u * EPC + e]);
      }
    }
  }

  // merge the lane groups (same dims, other rows) ...
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hh], off);
      const float m_new = fmaxf(m[hh], m_o);
      const float ca = exp2f(m[hh] - m_new), cb = exp2f(m_o - m_new);
      l[hh] = l[hh] * ca + l_o * cb;
      m[hh] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[hh][e], off);
        acc[hh][e] = acc[hh][e] * ca + a_o * cb;
      }
    }
  }
  // ... then the warps: red holds each warp's acc (NH x hd), m, l
  float* mine = red + warp * NH * (HD + 2);
  if (grp == 0) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        if (on[u])
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            mine[hh * HD + (sl + u * L) * EPC + e] = acc[hh][u * EPC + e];
      if (sl == 0) {
        mine[NH * HD + hh] = m[hh];
        mine[NH * HD + NH + hh] = l[hh];
      }
    }
  }
  __syncthreads();
  if (tid < nh) {
    float mm = kNegInf;
    for (int w = 0; w < n_warps; ++w)
      mm = fmaxf(mm, red[w * NH * (HD + 2) + NH * HD + tid]);
    float ll = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* rw = red + w * NH * (HD + 2) + NH * HD;
      ll += rw[NH + tid] * exp2f(rw[tid] - mm);
    }
    blk_m[tid] = mm;
    blk_l[tid] = ll;
  }
  __syncthreads();
  for (int i = tid; i < nh * HD; i += n_threads) {
    const int hh = i / HD;
    float a = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* rw = red + w * NH * (HD + 2);
      a += rw[i] * exp2f(rw[NH * HD + hh] - blk_m[hh]);
    }
    if (n_split == 1)
      store_out(out, gh * HD + i, a / fmaxf(blk_l[hh], 1e-20f), q_is_bf16);
    else
      part_acc[((gh + hh) * n_split + split) * HD + i % HD] = a;
  }
  if (n_split == 1) return;
  if (tid < nh) {
    part_m[(gh + tid) * n_split + split] = blk_m[tid];
    part_l[(gh + tid) * n_split + split] = blk_l[tid];
  }

  // the last block of the group to get here merges the spans
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((size_t)b * gridDim.y + blockIdx.y);
  if (tid == 0) last_block = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid == 0) *ticket = 0;   // ready for the next call

  // per head: the largest m, each span's weight exp2(m_s - m), the sum l
  for (int hh = warp; hh < nh; hh += n_warps) {
    const float* pm = part_m + (gh + hh) * n_split;
    const float* pl = part_l + (gh + hh) * n_split;
    float mm = kNegInf;
    for (int s = lane; s < n_split; s += 32) mm = fmaxf(mm, __ldcg(pm + s));
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float wv = exp2f(__ldcg(pm + s) - mm);
      wts[s * NH + hh] = wv;
      ll += __ldcg(pl + s) * wv;
    }
    ll = warp_sum(ll);
    if (lane == 0) blk_l[hh] = 1.f / fmaxf(ll, 1e-20f);
  }
  __syncthreads();
  for (int i = tid; i < nh * HD; i += n_threads) {
    const int hh = i / HD, d = i % HD;
    const float* pa = part_acc + (gh + hh) * n_split * HD + d;
    const float* wv = wts + hh;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int s = 0;
    for (; s + 4 <= n_split; s += 4) {
      a0 = fmaf(__ldcg(pa + (size_t)s * HD), wv[s * NH], a0);
      a1 = fmaf(__ldcg(pa + (size_t)(s + 1) * HD), wv[(s + 1) * NH], a1);
      a2 = fmaf(__ldcg(pa + (size_t)(s + 2) * HD), wv[(s + 2) * NH], a2);
      a3 = fmaf(__ldcg(pa + (size_t)(s + 3) * HD), wv[(s + 3) * NH], a3);
    }
    for (; s < n_split; ++s)
      a0 = fmaf(__ldcg(pa + (size_t)s * HD), wv[s * NH], a0);
    store_out(out, gh * HD + i, ((a0 + a1) + (a2 + a3)) * blk_l[hh],
              q_is_bf16);
  }
}


template <typename KV, int L, int VPL, int NH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n_split > 1 && (long long)a.n_split * NH * a.hd > kMergeFloats)
    return cudaErrorInvalidValue;
  const Layout lay(a.hd, sizeof(KV), 32 / L * tile_steps<KV, VPL>(), NH,
                   a.warps, a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<KV, L, VPL, NH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.H / a.Hkv + NH - 1) / NH;
  const dim3 grid(a.n_split, a.Hkv * n_chunks, a.B);
  decode_kernel<KV, L, VPL, NH><<<grid, 32 * a.warps, lay.total, stream>>>(
      a.q, a.q_is_bf16, static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), a.part_m, a.part_l, a.part_acc,
      a.tickets, a.out, a.Smax, a.H, a.Hkv, a.hd, a.length, a.span,
      a.n_split, a.stages, kLog2e / sqrtf((float)a.hd));
  return cudaGetLastError();
}

template <typename KV, int L, int VPL>
cudaError_t dispatch_nh(int nh, const Args& a, cudaStream_t stream) {
  switch (nh) {
    case 1: return launch<KV, L, VPL, 1>(a, stream);
    case 4: return launch<KV, L, VPL, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dispatch on the lane-group size.  hd: any multiple of 16 up to 256.  The
// lane group of a row is its count of 16-byte chunks rounded up to a power
// of two, at most 32 (an f32 row over 128 dims gives a lane two chunks);
// only the groups a cache type can need are instantiated.
template <typename KV>
cudaError_t dispatch_lanes(int nh, const Args& a, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(KV);
  const int chunks = a.hd / EPC;
  if constexpr (EPC == 16) {
    if (chunks <= 1) return dispatch_nh<KV, 1, 1>(nh, a, stream);
  }
  if constexpr (EPC >= 8) {
    if (chunks <= 2) return dispatch_nh<KV, 2, 1>(nh, a, stream);
  }
  if (chunks <= 4) return dispatch_nh<KV, 4, 1>(nh, a, stream);
  if (chunks <= 8) return dispatch_nh<KV, 8, 1>(nh, a, stream);
  if (chunks <= 16) return dispatch_nh<KV, 16, 1>(nh, a, stream);
  if constexpr (EPC <= 8) {
    if (chunks <= 32) return dispatch_nh<KV, 32, 1>(nh, a, stream);
  }
  if constexpr (EPC == 4) {
    if (chunks <= 64) return dispatch_nh<KV, 32, 2>(nh, a, stream);
  }
  return cudaErrorInvalidValue;
}

// Each cache type is instantiated in a source of its own
// (flash_decode_{f32,bf16,int8}.cu), so the three compile in parallel.
extern template cudaError_t dispatch_lanes<float>(int, const Args&,
                                                  cudaStream_t);
extern template cudaError_t dispatch_lanes<bf16>(int, const Args&,
                                                 cudaStream_t);
extern template cudaError_t dispatch_lanes<int8_t>(int, const Args&,
                                                   cudaStream_t);

}  // namespace rt_decode
