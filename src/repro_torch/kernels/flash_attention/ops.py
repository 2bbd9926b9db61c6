"""Public wrapper: (B, S, H, hd) layout used by the model zoo.

A CUDA tensor goes to the hand-written kernels or raises: bf16 to the
bf16 tensor-core kernel (csrc/flash_attention_tc.cu), f32 to the TF32
tensor-core kernel with split operands (csrc/flash_attention_f32.cu).  A
CPU tensor takes the plain version (ref.py), and only because it lies on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

SMEM_LIMIT = 232_448      # dynamic shared memory one block can have
HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 up to 256
STAGES = 2                # K/V stages in each kernel's ring
launches = 0              # kernel launches made by this wrapper


def tc_tiles(hd: int) -> tuple:
    """(query rows, keys per stage) of one block of the bf16 kernel: 4
    warps of one 16-row m-tile and 64 keys up to hd 64; of two m-tiles and
    32 keys to hd 128; of one m-tile and 32 keys above."""
    if hd <= 64:
        return 64, 64
    return (128, 32) if hd <= 128 else (64, 32)


def f32_tiles(hd: int) -> tuple:
    """(query rows, keys per stage) of one block of the f32 kernel: 4
    warps of one 16-row m-tile; 64 keys up to hd 64, 32 above."""
    return 64, 64 if hd <= 64 else 32


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel for ``dtype`` asks for: the
    block's Q rows and ``STAGES`` stages of K and V, of the kernel's own
    tiles, whatever the knob.  bf16: rows padded by 8 elements, at most
    101,376 bytes (hd 256).  f32: rows padded by 4 floats, at most
    199,680 bytes (hd 256).  Both fit at every head dim."""
    if dtype == torch.bfloat16:
        (bq, bkv), pad = tc_tiles(hd), 8
    else:
        (bq, bkv), pad = f32_tiles(hd), 4
    return (bq + STAGES * 2 * bkv) * (int(hd) + pad) * dtype.itemsize


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_kv: int = 128):
    """q/k/v: (B, S, H, hd) (kv already GQA-repeated) -> (B, S, H, hd).

    ``block_q`` / ``block_kv`` are the knob's logical tiles, which the
    reference fits to a divisor of S; they change neither what is
    computed nor how.  Both kernels run tiles of their own (``tc_tiles``,
    ``f32_tiles``) at every S, the ragged edge masked, so a prime S does
    not shrink them, and both fit at every head dim."""
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
    o = torch.empty_like(q)
    err = _build.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, hd,
        int(bool(causal)), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return o
