// One-token attention over a KV cache for Hopper (sm_90a), forward only,
// in one launch.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, _decode_kernel
// (the Pallas kernel behind flash_decode_bhsd / ops.flash_decode).
// Computes: for each (batch, query head) softmax(q k^T / sqrt(hd)) v over
// the first `length` cache positions; GQA maps query head h to KV head
// h / n_rep; an int8 cache is dequantised with its per-(token, kv-head)
// f32 scale; f32 math, running (m, l, acc), denominator clamped at 1e-20,
// the f32 result rounded once to q's dtype.  q: (B, 1, H, hd) f32 or
// bf16; cache: (B, Smax, Hkv, hd) f32 / bf16 / int8 (+ scales
// (B, Smax, Hkv, 1) f32); out: (B, 1, H, hd) in q's dtype.
//
// Bound on this card: bytes.  Every cache element is used for 2*n_rep
// multiply-adds and read once, so the least time is the LIVE part of the
// cache (B * length * Hkv * hd elements of K and of V, plus the scales)
// over the memory bandwidth.
//
// Design, and what differs from the reference.
// - One launch per call.  Blocks split the live cache into `n_split`
//   spans of `span` rows (the wrapper plans them from the fitted
//   block_kv, in whole tiles of it); positions >= length are never read
//   (they carry weight exp(-1e30 - m) = 0 in the reference).  Each block
//   writes its partial (m, l, acc); the last block of a (batch, head
//   group) to finish -- it knows from an atomic ticket taken after a
//   __threadfence() -- merges the n_split partials and writes the output
//   in q's dtype.  It puts the ticket back to 0, so the counters
//   (allocated once per device and stream by the wrapper) need no memset
//   between calls.  With one span the block writes the output itself.
// - A block serves one KV head and NH query heads of its GQA group (NH =
//   1 at n_rep = 1, so no slot idles there; else 4, a wider group taking
//   ceil(n_rep / 4) blocks per span, the re-reads coming mostly from L2)
//   from ONE read of K/V; the reference maps the KV tile to each query
//   head and reads it n_rep times.
// - A cache row of hd elements is L neighbouring lanes, one 16-byte chunk
//   each (L = the row's chunk count rounded up to a power of two; an f32
//   row over 128 dims gives a lane two chunks); chunks past hd are never
//   copied and count 0.  A warp's 32/L lane groups hold 32/L rows at a
//   time, and a warp tile is 8 such steps (4 with two chunks a lane or
//   with int8 rows, whose 16 values a chunk cost twice the work).
// - Each of a block's warps (8 where the blocks fit on the SMs in one
//   wave, else 4: the wrapper's plan) streams every n_warps-th tile of
//   the span through a ring of its own (2-4 cp.async stages): it waits
//   on nothing but its own copies, no block barrier inside the loop.
//   Rows past the span are zero-filled and masked.  Per tile a lane
//   group forms the scores of its rows in base 2 (q is pre-scaled by
//   log2(e)/sqrt(hd); int8: the row's scale multiplies the dot product,
//   and the bytes are widened by a byte permute and a subtraction rather
//   than the slower int-to-float unit), updates its (m, l, acc) ONCE for
//   those rows, then adds P.V (int8: V's scale folded into P).  The lane groups, then the warps,
//   then the spans are merged with weights exp2(m - max m).
// - The reference walks the KV axis sequentially with (m, l, acc) in
//   scratch memory and exponentiates with base e; here the sums are
//   taken in another order and exp2 of log2(e)-scaled scores is the same
//   value up to f32 rounding.
// - `length` is a plain integer argument: the cache position lives on
//   the host, so no step reads it back from the device.
#include "flash_decode.cuh"

using rt_decode::Args;
using rt_decode::bf16;
using rt_decode::dispatch_lanes;


// kv_kind: 0 = f32 cache, 1 = bf16 cache, 2 = int8 cache with f32 scales.
// nh: query-head slots per block (1 or 4); the live cache is split into
// n_split spans of `span` rows, each read by a block of `warps` (1-8)
// warps whose tiles stream through `stages` (2-4) cp.async stages.
// part_* (f32, n_split partials of every (batch, head)) and tickets
// (B * Hkv * ceil(n_rep / nh) ints, 0 on entry, 0 again on exit) are used
// only when n_split > 1.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               void* part_m, void* part_l, void* part_acc,
                               void* tickets, void* out, int B, int Smax,
                               int H, int Hkv, int hd, int length, int nh,
                               int span, int n_split, int warps, int stages,
                               int kv_kind, int q_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      hd < 16 || hd > 256 || hd % 16 != 0 || length < 1 || length > Smax ||
      span < 1 || n_split != (length + span - 1) / span || warps < 1 ||
      warps > 8 || stages < 2 || stages > 4 ||
      (kv_kind == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), static_cast<int*>(tickets),
               out, q_is_bf16, B, Smax, H, Hkv, hd, length, span, n_split,
               warps, stages};
  switch (kv_kind) {
    case 0: return (int)dispatch_lanes<float>(nh, a, s);
    case 1: return (int)dispatch_lanes<bf16>(nh, a, s);
    case 2: return (int)dispatch_lanes<int8_t>(nh, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory one block asks for (Layout in flash_decode.cuh), so the
// wrapper's mirror of it can be checked.
extern "C" int rt_flash_decode_smem(int hd, int kv_bytes, int nh, int warps,
                                    int stages) {
  const int chunks = hd * kv_bytes / 16;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int steps = kv_bytes == 1 || chunks > 32 ? 4 : 8;   // tile_steps
  return rt_decode::Layout(hd, kv_bytes, 32 / lanes * steps, nh, warps,
                           stages).total;
}
