"""Public wrapper: accepts (..., d), flattens leading dims.

A CUDA tensor goes to the hand-written kernel (csrc/rmsnorm.cu) or
raises; a CPU tensor takes the plain version (ref.py), and only because
it lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
launches = 0    # kernel launches made by this wrapper


def rmsnorm(x, scale, *, eps: float = 1e-5, block_rows: int = 256):
    """x: (..., d) f32 or bf16; scale: (d,) f32 or bf16 -> x's shape and
    dtype.  ``block_rows`` is accepted for signature parity with the
    reference: the kernel gives each row a warp of its own, so no row
    block has to divide the row count."""
    global launches
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps=eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32/bf16, got x {x.dtype}, "
                        f"scale {scale.dtype}")
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"scale must be ({d},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if x.numel() == 0:
        raise ValueError("rmsnorm kernel needs at least one row")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    rows = x.numel() // d
    y = torch.empty_like(x)
    err = _build.lib().rt_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm")
    launches += 1
    return y
