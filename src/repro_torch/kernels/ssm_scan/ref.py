"""Plain PyTorch versions of the chunked SSD scan kernel.

``ssm_scan_ref`` is the exact per-token recurrence (the oracle of the
tests):  h_t = exp(la_t) * h_{t-1} + dt_t * X_t (x) B_t ;  y_t = C_t . h_t.

``ssm_scan_chunked`` computes what the kernel computes, chunk by chunk:
the within-chunk term, the carried-state term and the state update of
the reference's ``_ssd_kernel``, all in f32 but for the cumulative sum of
``la`` over a chunk, which is taken and differenced in f64 before each
exp (as the kernel does: an f32 cumsum at |cum| ~ 10^2 is off by ~1e-5,
and the exp of its differences carries that to every near-diagonal
term).  ``ssm_scan_tiled`` runs it at the kernel's own chunk at any S:
the sequence is padded to a whole number of chunks with rows that have
dt = la = 0, which add nothing to the state, and the padded rows' outputs
are dropped -- the ragged last chunk masked, as the kernel masks it.  The
kernel's wrapper uses it for CPU tensors, and the kernel is held against
it (and against ``ssm_scan_chunked`` at the reference's fitted chunk) on
the card.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(X, Bm, Cm, dt, la):
    """X: (B,S,H,P); Bm/Cm: (B,S,N); dt/la: (B,S,H).

    Returns (Y (B,S,H,P) in X's dtype, h_final (B,H,P,N) f32)."""
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    Xf, Bf, Cf = X.float(), Bm.float(), Cm.float()
    dtf, laf = dt.float(), la.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=X.device)
    ys = []
    for t in range(S):
        h = (torch.exp(laf[:, t])[:, :, None, None] * h
             + torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], Xf[:, t], Bf[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(X.dtype), h


def ssm_scan_chunked(X, Bm, Cm, dt, la, chunk: int):
    """The kernel's algorithm; ``chunk`` must divide S (the wrapper fits
    it).  Same layouts and results as ``ssm_scan_ref``."""
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    Q = int(chunk)
    if Q < 1 or S % Q:
        raise ValueError(f"ssm_scan_chunked: chunk {Q} does not divide S={S}")
    f32 = torch.float32
    Xf, Bf, Cf = X.to(f32), Bm.to(f32), Cm.to(f32)
    dtf, laf = dt.to(f32), la.to(f32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=X.device))
    h = torch.zeros((B, H, P, N), dtype=f32, device=X.device)
    ys = []
    for c0 in range(0, S, Q):
        Xc = Xf[:, c0:c0 + Q]                           # (B,Q,H,P)
        Bc, Cc = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]     # (B,Q,N)
        dtc = dtf[:, c0:c0 + Q]                         # (B,Q,H)
        cum = torch.cumsum(laf[:, c0:c0 + Q].double(), dim=1)   # (B,Q,H)
        # within-chunk: scores[t, j] = (C_t . B_j) exp(cum_t - cum_j) dt_j
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).to(f32)  # (B,t,j,H)
        decay = torch.where(tri[None, :, :, None], torch.exp(diff),
                            torch.zeros_like(diff))
        G = torch.einsum("btn,bjn->btj", Cc, Bc)
        scores = G[..., None] * decay * dtc[:, None, :, :]
        y = torch.einsum("btjh,bjhp->bthp", scores, Xc)
        # carried state: y_t += exp(cum_t) C_t . h
        y = y + torch.exp(cum.to(f32))[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, h)
        ys.append(y)
        # state update: h = exp(cum_last) h + sum_j w_j X_j (x) B_j
        w = dtc * torch.exp((cum[:, -1:, :] - cum).to(f32))     # (B,Q,H)
        h = (torch.exp(cum[:, -1].to(f32))[:, :, None, None] * h
             + torch.einsum("bjh,bjhp,bjn->bhpn", w, Xc, Bc))
    return torch.cat(ys, dim=1).to(X.dtype), h


def ssm_scan_tiled(X, Bm, Cm, dt, la, chunk: int):
    """``ssm_scan_chunked`` at ``chunk`` rows for any S, the ragged last
    chunk padded with rows that change nothing (dt = la = 0, X = B = C =
    0).  Same layouts and results as ``ssm_scan_ref``."""
    S = X.shape[1]
    pad = -S % int(chunk)
    if pad == 0:
        return ssm_scan_chunked(X, Bm, Cm, dt, la, chunk)
    grow = lambda t: torch.cat(
        [t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], dim=1)
    Y, h = ssm_scan_chunked(*(grow(t) for t in (X, Bm, Cm, dt, la)), chunk)
    return Y[:, :S], h
