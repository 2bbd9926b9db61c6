"""Public wrapper: model-zoo layout (B,1,H,hd) q + (B,S,Hkv,hd) cache
-> (B,1,H,hd).

A CUDA tensor goes to the hand-written kernels (csrc/flash_decode.cu)
or raises; a CPU tensor takes the plain version (ref.py), and only
because it lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.tiling import fit_block

HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 up to 256
_KV_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
launches = 0    # kernel launches (partial + merge pair) made by this wrapper


def flash_decode(q, k_cache, v_cache, length, k_scale=None, v_scale=None,
                 *, block_kv: int = 512):
    """q: (B,1,H,hd); caches: (B,S,Hkv,hd) [+ (B,S,Hkv,1) scales];
    length: live length, a host integer shared by the batch (the port's
    cache keeps its position on the host, so nothing is read back from
    the device per step).  ``block_kv`` is fitted to a divisor of S as in
    the reference; here it is the span of cache positions one block
    reduces before the partial results are merged."""
    global launches
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
    bkv = fit_block(block_kv, S)
    n_tiles = -(-length // bkv)
    f32 = dict(dtype=torch.float32, device=q.device)
    # one scratch buffer for the per-tile partials: m, l (B,H,n_tiles)
    # and acc (B,H,n_tiles,hd), all f32
    n_part = B * H * n_tiles
    scratch = torch.empty(n_part * (hd + 2), **f32)
    part_m = scratch.data_ptr()
    part_l = part_m + 4 * n_part
    part_acc = part_l + 4 * n_part
    out = torch.empty((B, 1, H, hd), **f32)
    err = _build.lib().rt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        part_m, part_l, part_acc,
        out.data_ptr(), B, S, H, Hkv, hd, length, bkv, n_tiles,
        _KV_KINDS[k_cache.dtype], int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    launches += 1
    return out.to(q.dtype)
