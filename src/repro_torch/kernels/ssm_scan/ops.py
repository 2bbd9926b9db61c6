"""Public wrapper: model-zoo layout X (B,S,H,P), Bm/Cm (B,S,N),
dt/la (B,S,H) -> (Y (B,S,H,P), h_final (B,H,P,N) f32).

A CUDA tensor goes to the hand-written kernel (csrc/ssm_scan.cu) or
raises; a CPU tensor takes the plain chunked version (ref.py), and only
because it lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked
from repro_torch.kernels.tiling import fit_block

MAX_STATE = 64       # largest P (head dim) and N (state size) of a tile
MAX_CHUNK = 1024     # largest chunk the kernel keeps its decay table for
launches = 0         # kernel launches made by this wrapper


def ssm_scan(X, Bm, Cm, dt, la, *, chunk: int = 256):
    """X: (B,S,H,P) f32/bf16; Bm/Cm: (B,S,N); dt/la: (B,S,H) ->
    (Y in X's dtype, h_final f32).

    The chunk is fitted to the largest divisor of S <= the request, as in
    the reference, so a chunk value means the same thing in both
    packages.  Bm, Cm, dt and la are read in f32, as the reference's
    kernel reads them (``astype(float32)``); they are converted only if
    they come in another dtype."""
    global launches
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    Q = fit_block(chunk, S)
    if not X.is_cuda:
        return ssm_scan_chunked(X, Bm, Cm, dt, la, Q)
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssm_scan kernel takes f32/bf16 X, got {X.dtype}")
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N) \
            or dt.shape != (B, S, H) or la.shape != (B, S, H):
        raise ValueError(f"ssm_scan: X {tuple(X.shape)} does not go with "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
                         f"dt {tuple(dt.shape)}, la {tuple(la.shape)}")
    if not (1 <= P <= MAX_STATE and 1 <= N <= MAX_STATE):
        raise ValueError(f"ssm_scan kernel runs P and N up to {MAX_STATE}, "
                         f"got P={P}, N={N}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError("ssm_scan kernel needs B, S, H >= 1")
    if Q > MAX_CHUNK:
        raise ValueError(f"ssm_scan kernel runs chunks up to {MAX_CHUNK}, "
                         f"got {Q}")
    ins = [X] + [t.to(torch.float32) for t in (Bm, Cm, dt, la)]
    for t in ins:
        if t.device != X.device or not t.is_contiguous():
            raise ValueError("ssm_scan kernel needs contiguous tensors on "
                             "one device")
    Y = torch.empty_like(X)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=X.device)
    err = _build.lib().rt_ssm_scan(
        *(t.data_ptr() for t in ins), Y.data_ptr(), h_final.data_ptr(),
        B, S, H, P, N, Q, int(X.dtype == torch.bfloat16),
        torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "ssm_scan")
    launches += 1
    return Y, h_final
