// RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (the
// Pallas kernel behind rmsnorm_2d / ops.rmsnorm).
// Computes: y = x * rsqrt(mean(x^2) + eps) * scale, math in f32, output
// in x's dtype.  x is f32 or bf16; scale is f32 or bf16 independently;
// any d and any row count.
//
// Bound on this card: bytes.  About 3 operations per element against
// 2 * sizeof(x) bytes moved, far below the card's operations-per-byte
// ridge, so the least time is (read x once + write y once) / bandwidth.
// The design reads each row from device memory exactly once and keeps
// many 16-byte loads in flight.
//
// Width classes (rmsnorm_rows<X, S, TPR, VPT>): a row belongs to TPR
// threads, each of which holds VPT 16-byte vectors of it in registers
// from the load to the store.  The per-thread loop is unrolled, so a
// thread issues all of its row's loads before its sum starts.  Rows of
// at most 32 threads share a warp and sum by shuffles among their own
// lanes; a row of TPR >= 64 spans TPR / 32 warps whose partial sums
// meet in shared memory behind one barrier (two buffers, so one barrier
// a row).  A persistent grid, as many blocks as fit on the SMs, walks
// the row groups; a block loads its columns of scale once, as 16-byte
// vectors converted to f32 registers, and loads its next row group
// before it reduces the current one.  f32 rows run faster as one block
// per row group (the plan's `persistent` is then 0, and the loop runs
// once a block).  kernels/rmsnorm/ops.plan picks the class from (d,
// dtype), where the CPU tests reach it; the classes instantiated here
// are RMSNORM_CLASSES, and another is refused.
//
// General path (rmsnorm_staged): any d and any alignment (577, 4099, a
// view at an odd offset, or rows wider than the classes, such as 18432
// in f32).  A block takes one row at a time: 16-byte vector loads from
// the row's first 16-byte boundary, a scalar head and tail, each value
// written to dynamic shared memory as it is summed; after the block's
// sum the row is read back from shared memory, scaled and stored with
// y's own head, body and tail.  Only a row too wide for shared memory
// (beyond 58,000 f32 values; no configuration has one) is read twice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// (threads per row, 16-byte vectors per thread): the classes ops.plan
// can return (kernels/rmsnorm/ops.py, CLASSES)
#define RMSNORM_CLASSES(C)                                               \
  C(8, 1) C(8, 2) C(8, 3) C(8, 4) C(16, 3) C(16, 4) C(32, 3) C(32, 4)    \
  C(64, 3) C(64, 4) C(128, 3) C(128, 4) C(256, 3) C(256, 4) C(512, 3)    \
  C(512, 4)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRowBlock = 128;          // threads of a block of narrow rows
constexpr int kStagedMaxThreads = 1024;
// the general path's dynamic shared memory: a block's 232,448 bytes less
// its static partial sums
constexpr int kStagedSmem = 232448 - kStagedMaxThreads / 32 * 4;

// 16 bytes of T as f32 values, and back
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kPer16 = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float to_f32(float v) { return v; }
  __device__ __forceinline__ static float from_f32(float v) { return v; }
};

template <>
struct Pack<bf16> {
  static constexpr int kPer16 = 8;
  // a bf16 value is the upper half of the f32 with the same bits
  __device__ __forceinline__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
    unpack2(r.z, f + 4);
    unpack2(r.w, f + 6);
  }
  // 8 bytes: the four bf16 scale values beside one vector of f32 x
  __device__ __forceinline__ static void unpack(const uint2& r, float* f) {
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
  }
  __device__ __forceinline__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // RNE, a low
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  __device__ __forceinline__ static float to_f32(bf16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static bf16 from_f32(float v) {
    return __float2bfloat16(v);
  }
};

// the N scale values beside one vector of x, as f32 (N * sizeof(S) is
// 8, 16 or 32 bytes; scale is 16-byte aligned on this path)
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* p, float* f) {
  constexpr int kBytes = N * (int)sizeof(S);
  if constexpr (kBytes == 8) {
    Pack<S>::unpack(__ldg(reinterpret_cast<const uint2*>(p)), f);
  } else {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      Pack<S>::unpack(__ldg(reinterpret_cast<const uint4*>(p) + c),
                      f + c * Pack<S>::kPer16);
  }
}

// butterfly sum over aligned groups of W (<= 32) lanes: every lane of a
// group ends with the same bits
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int TPR>
__host__ __device__ constexpr int block_threads() {
  return TPR >= kRowBlock ? TPR : kRowBlock;
}

// Two blocks of 512 f32 threads fit an SM in 64 registers a thread; bf16
// rows with an f32 scale need more (its data alone is 64) and take one.
template <typename X, typename S, int TPR, int VPT>
__global__ void __launch_bounds__(
    block_threads<TPR>(), block_threads<TPR>() >= 512 && sizeof(X) == 4 ? 2
                                                                          : 1)
    rmsnorm_rows(const X* __restrict__ x, const S* __restrict__ scale,
                 X* __restrict__ y, int rows, int d, float eps) {
  constexpr int kVec = Pack<X>::kPer16;
  constexpr int kRows = block_threads<TPR>() / TPR;  // rows a block step
  constexpr int kWarps = TPR / 32;   // warps a row (0: part of a warp)
  __shared__ float part[2][kRows][kWarps > 1 ? kWarps : 1];
  const int t = threadIdx.x % TPR;      // thread within the row
  const int slot = threadIdx.x / TPR;   // row within the block step
  const int nvec = d / kVec;

  float sc[VPT][kVec];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = i * TPR + t;
    if (v < nvec) {
      load_scale<S, kVec>(scale + (size_t)v * kVec, sc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) sc[i][j] = 0.f;
    }
  }

  const int groups = (rows + kRows - 1) / kRows;
  auto load = [&](uint4 (&buf)[VPT], int g) {
    const int row = g * kRows + slot;
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + (size_t)min(row, rows - 1) * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = i * TPR + t;
      buf[i] = (row < rows && v < nvec) ? __ldg(xr + v)
                                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  uint4 cur[VPT], nxt[VPT];
  int g = blockIdx.x;   // the grid is at most `groups` blocks
  load(cur, g);
  int buf = 0;
  for (; g < groups; g += gridDim.x) {
    if (g + (int)gridDim.x < groups) load(nxt, g + gridDim.x);

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      float f[kVec];
      Pack<X>::unpack(cur[i], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ss = fmaf(f[j], f[j], ss);
    }
    ss = group_sum<(TPR < 32 ? TPR : 32)>(ss);
    if constexpr (kWarps > 1) {
      if ((threadIdx.x & 31) == 0) part[buf][slot][t / 32] = ss;
      __syncthreads();
      ss = part[buf][slot][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) ss += part[buf][slot][w];
      buf ^= 1;
    }
    const float inv = rsqrtf(ss / (float)d + eps);

    const int row = g * kRows + slot;
    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = i * TPR + t;
        if (v < nvec) {
          float f[kVec];
          Pack<X>::unpack(cur[i], f);
#pragma unroll
          for (int j = 0; j < kVec; ++j) f[j] = f[j] * inv * sc[i][j];
          yr[v] = Pack<X>::pack(f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

// Head, 16-byte body and tail of a row at address p: `head` values up to
// the first 16-byte boundary (0 if p is on one), then `body` vectors.
struct Split {
  int shift, head, body;
};

template <typename X>
__device__ __forceinline__ Split split_row(const X* p, int d) {
  constexpr int kVec = Pack<X>::kPer16;
  Split s;
  s.shift = (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(X));
  s.head = min((kVec - s.shift) % kVec, d);
  s.body = (d - s.head) / kVec;
  return s;
}

template <typename X, typename S>
__global__ void __launch_bounds__(kStagedMaxThreads)
    rmsnorm_staged(const X* __restrict__ x, const S* __restrict__ scale,
                   X* __restrict__ y, int rows, int d, float eps,
                   int staged) {
  constexpr int kVec = Pack<X>::kPer16;
  extern __shared__ uint4 smem[];
  __shared__ float part[kStagedMaxThreads / 32];
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const X* xr = x + (size_t)row * d;
    X* yr = y + (size_t)row * d;
    const Split xs = split_row(xr, d);
    // value j of the row at rs[j]: 16-byte aligned wherever xr + j is
    X* rs = reinterpret_cast<X*>(smem) + xs.shift;
    const int tail = xs.head + xs.body * kVec;

    float ss = 0.f;
#pragma unroll 4
    for (int i = tid; i < xs.body; i += nthr) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(xr + xs.head) + i);
      if (staged) reinterpret_cast<uint4*>(rs + xs.head)[i] = r;
      float f[kVec];
      Pack<X>::unpack(r, f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ss = fmaf(f[j], f[j], ss);
    }
    // the scalar head and tail, fewer than kVec values each
    auto scalar = [&](int j) {
      const X v = xr[j];
      if (staged) rs[j] = v;
      const float f = Pack<X>::to_f32(v);
      ss = fmaf(f, f, ss);
    };
    if (tid < xs.head) scalar(tid);
    if (tid < d - tail) scalar(tail + tid);
    ss = group_sum<32>(ss);
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();   // also publishes the staged row
    ss = part[0];
    for (int w = 1; w < nthr / 32; ++w) ss += part[w];
    const float inv = rsqrtf(ss / (float)d + eps);

    const X* src = staged ? rs : xr;   // the same alignment either way
    const Split ys = split_row(yr, d);
    const int ytail = ys.head + ys.body * kVec;
    for (int i = tid; i < ys.body; i += nthr) {
      const int j0 = ys.head + i * kVec;
      float f[kVec];
      if (ys.shift == xs.shift) {
        Pack<X>::unpack(*reinterpret_cast<const uint4*>(src + j0), f);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) f[j] = Pack<X>::to_f32(src[j0 + j]);
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        f[j] = f[j] * inv * Pack<S>::to_f32(__ldg(scale + j0 + j));
      *reinterpret_cast<uint4*>(yr + j0) = Pack<X>::pack(f);
    }
    auto put = [&](int j) {
      yr[j] = Pack<X>::from_f32(Pack<X>::to_f32(src[j]) * inv *
                                Pack<S>::to_f32(__ldg(scale + j)));
    };
    if (tid < ys.head) put(tid);
    if (tid < d - ytail) put(ytail + tid);
    __syncthreads();   // the row and `part` are free for the next row
  }
}

// the current device, the index of the per-device caches below
constexpr int kMaxDevices = 64;
int device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < kMaxDevices ? dev : 0;
}

int sm_count(int dev) {
  static int cache[kMaxDevices];
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 1;
  }
  return cache[dev];
}

template <typename X, typename S, int TPR, int VPT>
cudaError_t launch_rows(const void* x, const void* scale, void* y, int rows,
                        int d, float eps, bool persistent,
                        cudaStream_t stream) {
  constexpr int kBlock = block_threads<TPR>();
  constexpr int kRows = kBlock / TPR;
  const int dev = device();
  static int per_sm[kMaxDevices];   // blocks of this class on one SM
  if (per_sm[dev] == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rmsnorm_rows<X, S, TPR, VPT>, kBlock, 0);
    per_sm[dev] = n > 0 ? n : 1;
  }
  const int groups = (rows + kRows - 1) / kRows;
  const int grid =
      persistent ? min(groups, per_sm[dev] * sm_count(dev)) : groups;
  rmsnorm_rows<X, S, TPR, VPT><<<grid, kBlock, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const S*>(scale),
      static_cast<X*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename X, typename S>
cudaError_t launch_staged(const void* x, const void* scale, void* y,
                          int rows, int d, float eps, int threads,
                          cudaStream_t stream) {
  constexpr int kVec = Pack<X>::kPer16;
  const int dev = device();
  // shared memory beyond 48 KB allowed (an attribute of each device)
  static bool opened[kMaxDevices];
  if (!opened[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_staged<X, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStagedSmem);
    if (e != cudaSuccess) return e;
    opened[dev] = true;
  }
  const size_t need = ((size_t)(d + kVec) * sizeof(X) + 15) / 16 * 16;
  const int staged = need <= (size_t)kStagedSmem;
  const int smem = staged ? (int)need : 0;
  // blocks resident on one SM at the device's last (threads, shared
  // memory) asked
  static int last_threads[kMaxDevices], last_smem[kMaxDevices],
      last_per_sm[kMaxDevices];
  if (threads != last_threads[dev] || smem != last_smem[dev] ||
      last_per_sm[dev] == 0) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, rmsnorm_staged<X, S>, threads, smem);
    last_per_sm[dev] = n > 0 ? n : 1;
    last_threads[dev] = threads;
    last_smem[dev] = smem;
  }
  const int grid = min(rows, last_per_sm[dev] * sm_count(dev));
  rmsnorm_staged<X, S><<<grid, threads, smem, stream>>>(
      static_cast<const X*>(x), static_cast<const S*>(scale),
      static_cast<X*>(y), rows, d, eps, staged);
  return cudaGetLastError();
}

template <typename X, typename S>
cudaError_t dispatch(const void* x, const void* scale, void* y, int rows,
                     int d, float eps, int tpr, int vpt, bool persistent,
                     cudaStream_t stream) {
  if (vpt == 0) {
    if (tpr < 32 || tpr > kStagedMaxThreads || tpr % 32 != 0)
      return cudaErrorInvalidValue;
    return launch_staged<X, S>(x, scale, y, rows, d, eps, tpr, stream);
  }
  constexpr int kVec = Pack<X>::kPer16;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(scale);
  // a class holds whole 16-byte vectors of 16-byte aligned rows and scale
  if (d % kVec != 0 || (addr & 15) != 0 || (long long)tpr * vpt * kVec < d)
    return cudaErrorInvalidValue;
#define RMSNORM_CASE(T, V)                                             \
  if (tpr == T && vpt == V)                                            \
    return launch_rows<X, S, T, V>(x, scale, y, rows, d, eps, persistent, \
                                   stream);
  RMSNORM_CLASSES(RMSNORM_CASE)
#undef RMSNORM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// plan: ops.plan_code's packing of the plan and the dtypes, threads per
// row | vectors per thread << 16 | x_is_bf16 << 24 | scale_is_bf16 << 25
// | persistent << 26 (vectors per thread 0: the general path with that
// many threads a block, always persistent)
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, int rows,
                          int d, float eps, int plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int t = plan & 0xffff, v = (plan >> 16) & 0xff;
  const bool x_bf16 = (plan >> 24) & 1, scale_bf16 = (plan >> 25) & 1;
  const bool p = (plan >> 26) & 1;
  if (x_bf16)
    return (int)(scale_bf16 ? dispatch<bf16, bf16>(x, scale, y, rows, d, eps,
                                                   t, v, p, s)
                            : dispatch<bf16, float>(x, scale, y, rows, d, eps,
                                                    t, v, p, s));
  return (int)(scale_bf16 ? dispatch<float, bf16>(x, scale, y, rows, d, eps,
                                                  t, v, p, s)
                          : dispatch<float, float>(x, scale, y, rows, d, eps,
                                                   t, v, p, s));
}
