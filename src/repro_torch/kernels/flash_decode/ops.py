"""Public wrapper: model-zoo layout (B,1,H,hd) q + (B,S,Hkv,hd) cache
-> (B,1,H,hd).

A CUDA tensor goes to the hand-written kernel (csrc/flash_decode.cu, one
launch per call) or raises; a CPU tensor takes the plain version
(ref.py), and only because it lies on the CPU.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, forward_only
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.tiling import fit_block

HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 up to 256
MAX_HEAD_SLOTS = 4        # query heads of one GQA group per block
MERGE_FLOATS = 16384      # floats of partials the merging block reads
BLOCKS_PER_SM = 2         # blocks the split aims to give every SM
WARP_RING_BYTES = 24576   # budget of one warp's cp.async ring
ONE_WAVE_WARPS = 8        # warps per block where the blocks fit one wave
SMEM_LIMIT = 232_448      # dynamic shared memory one block can have
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
launches = 0    # kernel launches made by this wrapper (one per call)
# merge tickets per (device, stream): calls on one stream run one after
# another, so each finds its buffer back at zero
_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


class Split(NamedTuple):
    slots: int     # query heads of one GQA group per block (1 or 4)
    span: int      # cache rows per block: whole tiles of the fitted block_kv
    n_split: int   # spans over the live cache
    warps: int     # warps per block: 8 if the blocks fit in one wave, else 4
    stages: int    # cp.async stages in each warp's ring


def head_slots(n_rep: int) -> int:
    """Query heads a block serves per KV head: 1 at n_rep 1 (no idle
    slot), else 4 (a wider group takes several blocks)."""
    return 1 if n_rep == 1 else MAX_HEAD_SLOTS


def lane_groups(hd: int, kv_bytes: int) -> int:
    """Rows a warp holds at a time: a cache row is L lanes of one 16-byte
    chunk each, L its chunk count rounded up to a power of two, at most 32
    (an f32 row over 128 dims gives a lane two chunks)."""
    chunks = int(hd) * int(kv_bytes) // 16
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    return 32 // lanes


def warp_tile_rows(hd: int, kv_bytes: int) -> int:
    """Cache rows in one warp's tile: 8 rows per lane group, 4 with two
    chunks a lane or with int8 rows (16 values a chunk)."""
    two = int(hd) * int(kv_bytes) // 16 > 32
    return lane_groups(hd, kv_bytes) * (4 if two or kv_bytes == 1 else 8)


def ring_stages(hd: int, kv_bytes: int) -> int:
    """Stages of each warp's ring: as many as ``WARP_RING_BYTES`` holds, 2
    to 4.  A stage is a warp tile of K and of V (rows padded by 16 bytes)
    and their int8 scales."""
    stage = 2 * warp_tile_rows(hd, kv_bytes) * (int(hd) * int(kv_bytes)
                                                + 16 + 4)
    return max(2, min(4, WARP_RING_BYTES // stage))


def plan_split(B: int, Hkv: int, n_rep: int, hd: int, length: int,
               block_kv: int, n_sm: int, kv_bytes: int = 2) -> Split:
    """How the kernel splits the live cache among blocks.  Each span is a
    whole number of ``block_kv`` tiles.  Where the (batch, KV head, slot
    group) blocks alone give at least half the SMs a block, the whole
    live cache is one span: the merge of split partials costs more time
    than the SMs left idle.  Otherwise spans are one tile each while that
    gives at most ``BLOCKS_PER_SM`` blocks per SM, longer where it would
    give more, or more partials than the merging block reads quickly
    (``n_split * slots * hd <= MERGE_FLOATS``).  Blocks that fit on the
    SMs in one wave get ``ONE_WAVE_WARPS`` warps where their shared memory
    fits, else 4 (more blocks resident per SM)."""
    slots = head_slots(n_rep)
    groups = B * Hkv * -(-n_rep // slots)
    n_tiles = -(-length // block_kv)
    if 2 * groups >= n_sm:
        tiles = n_tiles
    else:
        fill = -(-n_tiles * groups // (BLOCKS_PER_SM * n_sm))
        merge = -(-n_tiles // max(1, MERGE_FLOATS // (slots * hd)))
        tiles = max(1, fill, merge)
    span = tiles * block_kv
    n_split = -(-length // span)
    stages = ring_stages(hd, kv_bytes)
    warps = 4
    if groups * n_split <= n_sm and smem_bytes(
            hd, kv_bytes, slots, ONE_WAVE_WARPS, stages) <= SMEM_LIMIT:
        warps = ONE_WAVE_WARPS
    return Split(slots, span, n_split, warps, stages)


def smem_bytes(hd: int, kv_bytes: int, slots: int, warps: int,
               stages: int) -> int:
    """Shared memory of one block (csrc/flash_decode.cuh, Layout): the
    warps' rings, their partial (acc, m, l), the merge weights and the
    block's (m, l)."""
    stage = 2 * warp_tile_rows(hd, kv_bytes) * (hd * kv_bytes + 16 + 4)
    return (warps * stages * stage + warps * slots * (hd + 2) * 4
            + MERGE_FLOATS // hd * 4 + 2 * slots * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ticket_buffer(device: torch.device, stream: int,
                   n: int) -> torch.Tensor:
    """Zeroed ints that the kernel leaves at zero: allocated once per
    device and stream (again only when a call needs more of them).  Calls
    on two streams at once would otherwise share tickets, and a merging
    block could fire early or never."""
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def flash_decode(q, k_cache, v_cache, length, k_scale=None, v_scale=None,
                 *, block_kv: int = 512):
    """q: (B,1,H,hd); caches: (B,S,Hkv,hd) [+ (B,S,Hkv,1) scales];
    length: live length, a host integer shared by the batch (the port's
    cache keeps its position on the host, so nothing is read back from
    the device per step).  ``block_kv`` is fitted to a divisor of S as in
    the reference; here the kernel splits the live cache into spans of
    whole fitted tiles (``plan_split``) and merges them in the same
    launch."""
    global launches
    forward_only("flash_decode", q, k_cache, v_cache, k_scale, v_scale)
    length = int(length)
    if not q.is_cuda:
        ks = k_scale.transpose(1, 2) if k_scale is not None else None
        vs = v_scale.transpose(1, 2) if v_scale is not None else None
        o = decode_ref(q.transpose(1, 2), k_cache.transpose(1, 2),
                       v_cache.transpose(1, 2), ks, vs, length)
        return o.transpose(1, 2).to(q.dtype)
    B, one, H, hd = q.shape
    _, S, Hkv, _ = k_cache.shape
    if one != 1 or k_cache.shape != (B, S, Hkv, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not go with "
                         f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode kernel takes f32/bf16 q, got {q.dtype}")
    if k_cache.dtype not in _KV_KINDS or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"flash_decode kernel takes f32/bf16/int8 caches of "
                        f"one dtype, got {k_cache.dtype} / {v_cache.dtype}")
    if hd not in HEAD_DIMS or H % Hkv:
        raise ValueError("flash_decode kernel runs hd a multiple of 16 up "
                         f"to 256 and H a multiple of Hkv, got hd={hd}, "
                         f"H={H}, Hkv={Hkv}")
    if not 1 <= length <= S:
        raise ValueError(f"flash_decode: length {length} outside [1, {S}]")
    quant = k_cache.dtype == torch.int8
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise ValueError("flash_decode: scales go with an int8 cache, and "
                         "only with one")
    tensors = [q, k_cache, v_cache]
    if quant:
        for s in (k_scale, v_scale):
            if s.shape != (B, S, Hkv, 1) or s.dtype != torch.float32:
                raise ValueError("flash_decode: scales must be "
                                 f"({B},{S},{Hkv},1) f32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_decode kernel needs contiguous tensors "
                             "on one device")
    n_rep = H // Hkv
    plan = plan_split(B, Hkv, n_rep, hd, length, fit_block(block_kv, S),
                      _sm_count(q.device), k_cache.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _ticket_buffer(q.device, stream,
                             B * Hkv * -(-n_rep // plan.slots))
    # one scratch buffer for the per-span partials: m, l (B,H,n_split)
    # and acc (B,H,n_split,hd), all f32; unused with one span
    n_part = B * H * plan.n_split if plan.n_split > 1 else 0
    scratch = torch.empty(n_part * (hd + 2), dtype=torch.float32,
                          device=q.device)
    part_m = scratch.data_ptr()
    part_l = part_m + 4 * n_part
    part_acc = part_l + 4 * n_part
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    err = _build.lib().rt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        part_m, part_l, part_acc, tickets.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, hd, length, plan.slots, plan.span, plan.n_split,
        plan.warps, plan.stages, _KV_KINDS[k_cache.dtype],
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out
