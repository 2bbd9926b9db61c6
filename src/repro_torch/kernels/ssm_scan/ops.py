"""Public wrapper: model-zoo layout X (B,S,H,P), Bm/Cm (B,S,N),
dt/la (B,S,H) -> (Y (B,S,H,P), h_final (B,H,P,N) f32).

A CUDA tensor goes to the hand-written kernel (csrc/ssm_scan.cu) or
raises; a CPU tensor takes the plain chunked version (ref.py), and only
because it lies on the CPU.  Both run chunks of ``KERNEL_CHUNK`` rows at
every S, the ragged last chunk masked.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_tiled

MAX_STATE = 64       # largest P (head dim) and N (state size)
# rows of the kernel's own chunk (kQ in csrc/ssm_scan.cu, which reports it
# as rt_ssm_scan_chunk()): the chunk of the plain version on the CPU
KERNEL_CHUNK = 64
launches = 0         # kernel launches made by this wrapper

# the kernel's tickets and flags per (device, stream): calls on one stream
# run one after another, and each call leaves them at zero for the next
_sync: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _sync_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _sync.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _sync[(device, stream)] = buf
    return buf


def ssm_scan(X, Bm, Cm, dt, la, *, chunk: int = 256):
    """X: (B,S,H,P) f32/bf16; Bm/Cm: (B,S,N); dt/la: (B,S,H) ->
    (Y in X's dtype, h_final f32).

    ``chunk`` is the knob's logical chunk, which the reference fits to a
    divisor of S.  Every chunking computes the same recurrence (only the
    rounding differs), so it changes neither what is computed nor how:
    the kernel and the plain version run ``KERNEL_CHUNK`` rows at every S,
    never a 1- or 2-row chunk at a prime or near-prime S.  Bm, Cm, dt and
    la are read in f32, as the reference's kernel reads them
    (``astype(float32)``); they are converted only if they come in
    another dtype.  On the card P and N are multiples of 8 up to 64."""
    global launches
    if not X.is_cuda:
        return ssm_scan_tiled(X, Bm, Cm, dt, la, KERNEL_CHUNK)
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssm_scan kernel takes f32/bf16 X, got {X.dtype}")
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N) \
            or dt.shape != (B, S, H) or la.shape != (B, S, H):
        raise ValueError(f"ssm_scan: X {tuple(X.shape)} does not go with "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
                         f"dt {tuple(dt.shape)}, la {tuple(la.shape)}")
    if not (8 <= P <= MAX_STATE and 8 <= N <= MAX_STATE
            and P % 8 == 0 and N % 8 == 0):
        raise ValueError(f"ssm_scan kernel runs P and N multiples of 8 up "
                         f"to {MAX_STATE}, got P={P}, N={N}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError("ssm_scan kernel needs B, S, H >= 1")
    ins = [X] + [t.to(torch.float32) for t in (Bm, Cm, dt, la)]
    for t in ins:
        if t.device != X.device or not t.is_contiguous():
            raise ValueError("ssm_scan kernel needs contiguous tensors on "
                             "one device")
    Y = torch.empty_like(X)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=X.device)
    # the states passed from chunk to chunk: two slots per (batch, head)
    slots = torch.empty((2, B, H, MAX_STATE, MAX_STATE), dtype=torch.float32,
                        device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    lib = _build.lib()
    sync = _sync_buffer(X.device, stream, lib.rt_ssm_scan_sync_len(B, S, H))
    err = lib.rt_ssm_scan(
        *(t.data_ptr() for t in ins), Y.data_ptr(), h_final.data_ptr(),
        slots.data_ptr(), sync.data_ptr(), sync.numel(), B, S, H, P, N,
        int(X.dtype == torch.bfloat16), stream)
    _build.check(err, "ssm_scan")
    launches += 1
    return Y, h_final
