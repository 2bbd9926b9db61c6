"""Public wrapper: (B, S, H, hd) layout used by the model zoo.

A CUDA tensor goes to the hand-written kernels or raises: bf16 to the
tensor-core kernel (csrc/flash_attention_tc.cu), f32 to the CUDA-core
kernel (csrc/flash_attention.cu).  A CPU tensor takes the plain version
(ref.py), and only because it lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tiling import fit_block

SMEM_LIMIT = 232_448      # dynamic shared memory one block can have
HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 up to 256
TC_STAGES = 2             # K/V stages in the bf16 kernel's ring
launches = 0              # kernel launches made by this wrapper


def tc_tiles(hd: int) -> tuple:
    """(query rows, keys per stage) of one block of the bf16 kernel: 4
    warps of one 16-row m-tile and 64 keys up to hd 64; of two m-tiles and
    32 keys to hd 128; of one m-tile and 32 keys above."""
    if hd <= 64:
        return 64, 64
    return (128, 32) if hd <= 128 else (64, 32)


def smem_bytes(block_kv: int, hd: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel for ``dtype`` asks for.

    bf16: the block's Q rows and ``TC_STAGES`` stages of K and V, rows
    padded by 8 elements; the kernel's own tiles (``tc_tiles``), whatever
    the knob -- at most 101,376 bytes, at hd 256: it always fits.  f32:
    one KV tile of ``block_kv`` rows of K and of V."""
    if dtype == torch.bfloat16:
        bq, bkv = tc_tiles(hd)
        return (bq + TC_STAGES * 2 * bkv) * (int(hd) + 8) * 2
    return 2 * int(block_kv) * int(hd) * dtype.itemsize


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_kv: int = 128):
    """q/k/v: (B, S, H, hd) (kv already GQA-repeated) -> (B, S, H, hd).

    Blocks are fitted to the largest divisor of S <= the request, as in
    the reference, so a knob value names the same logical tile in both
    packages.  The f32 kernel runs the fitted tiles; a (block_kv, hd)
    whose f32 KV tile does not fit the block's shared memory raises with
    the byte count and is never refitted.  The bf16 kernel runs its own
    tiles (``tc_tiles``, ragged edges masked) whatever the knob, and fits
    at every head dim."""
    global launches
    if not q.is_cuda:
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)
    B, S, H, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes f32/bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError("flash_attention kernel runs hd a multiple of 16 "
                         f"up to 256, got {hd}")
    if S < 1 or B < 1:
        raise ValueError("flash_attention kernel needs B >= 1 and S >= 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    bq, bkv = fit_block(block_q, S), fit_block(block_kv, S)
    need = smem_bytes(bkv, hd, q.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"flash_attention: KV tile block_kv={bkv} x hd={hd} in {q.dtype} "
            f"needs {need} bytes of shared memory, a block has {SMEM_LIMIT}")
    o = torch.empty_like(q)
    err = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, hd,
        bq, bkv, int(bool(causal)), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return o
