"""Public wrapper: accepts (..., d), flattens leading dims.

A CUDA tensor goes to the hand-written kernel (csrc/rmsnorm.cu) or
raises; a CPU tensor takes the plain version (ref.py), and only because
it lies on the CPU.  ``plan`` chooses how the kernel lays a row over its
threads; it runs here, on any host, so the CPU tests hold the tiling.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, forward_only
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16          # one vector load or store
MIN_THREADS = 8         # fewest threads a row is given
MAX_THREADS = 512       # most threads of a width class's row
MAX_VECS = 4            # most vectors a thread holds of a row
ROW_BLOCK = 128         # threads of a block whose rows are narrower
STAGED_VECS = 4         # vectors per thread the general path aims at
STAGED_THREADS = (128, 1024)   # fewest and most threads of its blocks
# 32-bit registers a thread may spend on its share of x (the current
# and the next row, 16-byte vectors) and of scale (held as f32)
REG_BUDGET = 64
# (threads per row, vectors per thread) of the classes the kernel
# instantiates (csrc/rmsnorm.cu, RMSNORM_CLASSES): what ``plan`` can give
CLASSES = tuple([(MIN_THREADS, v) for v in range(1, MAX_VECS + 1)] + [
    (t, v) for t in (16, 32, 64, 128, 256, 512) for v in (3, 4)])
launches = 0    # kernel launches made by this wrapper (one per call)
_launch = None      # the entry point, bound at the first CUDA call
_raw_stream = None  # device index -> the current stream's handle


class Plan(NamedTuple):
    kind: str               # "class": rows in registers; "general": staged
    threads_per_row: int    # threads that share a row (a block's, general)
    vecs_per_thread: int    # 16-byte vectors of a row a thread holds (0: general)
    persistent: bool        # as many blocks as fit walk the rows; else one
                            # block per row group


def vec_len(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in one 16-byte vector."""
    return VEC_BYTES // dtype.itemsize


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype: torch.dtype) -> Plan:
    """The width class of rows of ``d`` values of ``dtype``: the fewest
    threads a row (a power of two from ``MIN_THREADS`` to
    ``MAX_THREADS``) that hold it in at most ``MAX_VECS`` vectors each,
    the last vector masked where d stops short.  A block is
    ``ROW_BLOCK`` threads, or one row's where a row has more.  bf16 rows
    are walked by a persistent grid, which loads scale once a block and
    the next row group before reducing the current one; f32 rows take one
    block per row group, which ran faster at widths 3584 and 7168 and
    level at 576 on an H100 (PERF.md §6).  A d that is no whole number of
    vectors, or wider than the widest class, takes the general path."""
    vec = vec_len(dtype)
    if d % vec == 0:
        tpr = MIN_THREADS
        while tpr <= MAX_THREADS:
            vpt = -(-(d // vec) // tpr)
            if vpt <= MAX_VECS:
                return Plan("class", tpr, vpt, dtype == torch.bfloat16)
            tpr *= 2
    return general_plan(d, dtype)


@functools.lru_cache(maxsize=None)
def general_plan(d: int, dtype: torch.dtype) -> Plan:
    """The general path, for any d and any alignment: one row a block of
    a power of two of threads in ``STAGED_THREADS``, about
    ``STAGED_VECS`` vectors a thread."""
    lo, hi = STAGED_THREADS
    threads = lo
    while threads < hi and threads * STAGED_VECS * vec_len(dtype) < d:
        threads *= 2
    return Plan("general", threads, 0, True)


@functools.lru_cache(maxsize=None)
def plan_code(d: int, x_dtype: torch.dtype, scale_dtype: torch.dtype,
              aligned: bool) -> int:
    """The plan and the dtypes packed into the C entry point's one int:
    threads per row | vectors per thread << 16 | x is bf16 << 24 | scale
    is bf16 << 25 | persistent << 26.  ``aligned``: x and scale start on
    16-byte boundaries (else the general path, whatever d is)."""
    p = plan(d, x_dtype) if aligned else general_plan(d, x_dtype)
    return (p.threads_per_row | p.vecs_per_thread << 16
            | (x_dtype == torch.bfloat16) << 24
            | (scale_dtype == torch.bfloat16) << 25 | p.persistent << 26)


def data_registers(p: Plan, dtype: torch.dtype) -> int:
    """Registers a thread of class ``p`` holds its data in: the current
    and the next row's vectors (4 each) and scale as f32 values."""
    return p.vecs_per_thread * (2 * VEC_BYTES // 4 + vec_len(dtype))


def _bind() -> None:
    global _launch, _raw_stream
    _launch = _build.lib().rt_rmsnorm
    # the handle of the device's current stream without building a
    # torch.cuda.Stream; a capture stream while a CUDA graph records
    _raw_stream = torch._C._cuda_getCurrentRawStream


def rmsnorm(x, scale, *, eps: float = 1e-5, block_rows: int = 256):
    """x: (..., d) f32 or bf16; scale: (d,) f32 or bf16 -> x's shape and
    dtype.  ``block_rows`` is accepted for signature parity with the
    reference: the kernel lays rows over threads by ``plan``, so no row
    block has to divide the row count."""
    global launches
    forward_only("rmsnorm", x, scale)
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps=eps)
    xd, sd = x.dtype, scale.dtype
    if xd not in _DTYPES or sd not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32/bf16, got x {xd}, "
                        f"scale {sd}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    d = x.shape[-1]
    dev = x.get_device()
    if scale.shape != (d,) or scale.get_device() != dev:
        raise ValueError(f"scale must be ({d},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    n = x.numel()
    if n == 0:
        raise ValueError("rmsnorm kernel needs at least one row")
    if _launch is None:
        _bind()
    xp, sp = x.data_ptr(), scale.data_ptr()
    # a view off a 16-byte boundary takes the general path
    code = plan_code(d, xd, sd, not (xp | sp) & (VEC_BYTES - 1))
    y = torch.empty_like(x)
    _build.check(_launch(xp, sp, y.data_ptr(), n // d, d, eps, code,
                         _raw_stream(dev)), "rmsnorm")
    launches += 1
    return y
