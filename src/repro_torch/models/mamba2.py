"""Mamba2 (SSD) blocks — chunked state-space duality algorithm.

Prefill uses the chunkwise-parallel SSD form (within-chunk quadratic
term + sequential cross-chunk state scan); decode is the O(1) recurrent
update.  With ``rt.attn_impl == "pallas"`` the scan goes through the
hand-written ``ssm_scan`` kernel (which runs chunks of its own at every
S, the ragged last chunk masked; the config's chunk names the logical
tile only); with ``"xla"`` it is ``ssd_chunked`` here, in eager torch ops
(which pads S to a multiple of the chunk), as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L


def mamba_spec(cfg) -> Dict[str, L.PSpec]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    return {
        "ln": L.rmsnorm_spec(d),
        "wx": L.PSpec((d, d_in), ("embed", "ssm_inner")),
        "wz": L.PSpec((d, d_in), ("embed", "ssm_inner")),
        "conv": L.PSpec((4, d_in), (None, "ssm_inner"), 0.2),
        "wB": L.PSpec((d, N), ("embed", None)),
        "wC": L.PSpec((d, N), ("embed", None)),
        "wdt": L.PSpec((d, H), ("embed", "ssm_heads")),
        "dt_bias": L.PSpec((H,), ("ssm_heads",), "zeros"),
        "A_log": L.PSpec((H,), ("ssm_heads",), "zeros"),
        "D": L.PSpec((H,), ("ssm_heads",), "ones"),
        "gln": L.PSpec((d_in,), ("ssm_inner",), "ones"),
        "wo": L.PSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, kernel 4.  x: (B,S,C), w: (4,C).

    state: (B,3,C) previous inputs for decode; returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if S >= 1 else state
    return y, new_state


def _gates(p, x, cfg, rt):
    """Common projections.  x:(B,S,d) -> (xin(B,S,d_in), z, Bm, Cm, dt, a).

    ``dt_bias`` and ``A_log`` are read in their master dtype (f32), as the
    reference reads them; ``cast_params`` leaves them uncast."""
    z = x @ L.cast(p["wz"], rt)
    xin = x @ L.cast(p["wx"], rt)
    Bm = (x @ L.cast(p["wB"], rt)).float()
    Cm = (x @ L.cast(p["wC"], rt)).float()
    dt = F.softplus((x @ L.cast(p["wdt"], rt)).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    loga = dt * A                    # (B,S,H) log decay <= 0
    return xin, z, Bm, Cm, dt, loga


def ssd_chunked(X, Bm, Cm, dt, loga, chunk: int, h0=None):
    """Chunkwise SSD.  X:(B,S,H,P), Bm/Cm:(B,S,N), dt/loga:(B,S,H).

    Returns (Y:(B,S,H,P), h_final:(B,H,P,N))."""
    Bsz, S, H, P = X.shape
    N = Bm.shape[-1]
    if S % chunk:
        # pad with no-op tokens: dt=0 (no input), loga=0 (no decay)
        pad = chunk - S % chunk
        pz = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        Y, h = ssd_chunked(pz(X), pz(Bm), pz(Cm), pz(dt), pz(loga),
                           chunk, h0)
        return Y[:, :S], h
    nc = S // chunk
    Q = chunk
    f32 = torch.float32
    Xc = X.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    lac = loga.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(lac, dim=2)                      # (B,nc,Q,H)
    # within-chunk.  Above the diagonal the exponent is a sum of decays
    # (>= 0) that overflows f32 over a long chunk; it is masked to -inf
    # before the exp, so those entries are 0 as in the reference and the
    # gradient there is 0 (exp, then a mask, would give 0 * inf = NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = L.replicated_like(torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                                  device=X.device)), diff)
    Lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # shared across heads
    scores = G[..., None] * Lmat * dtc[:, :, None, :, :]
    Y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores.to(f32), Xc.to(f32))
    # per-chunk state contribution
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    Sc = torch.einsum("bckh,bckhp,bckn->bchpn", (dtc * dec_last).to(f32),
                      Xc.to(f32), Bc)
    a_chunk = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    # sequential cross-chunk state scan
    h = L.replicated_like(torch.zeros((Bsz, H, P, N), dtype=f32,
                                      device=X.device), Sc) \
        if h0 is None else h0
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqn,bqh,bhpn->bqhp", Cc[:, c],
                                    torch.exp(cum[:, c]), h))
        h = a_chunk[:, c][:, :, None, None] * h + Sc[:, c]
    Y_inter = torch.stack(y_inter, dim=1)               # (B,nc,Q,H,P)
    Y = (Y_intra + Y_inter).reshape(Bsz, S, H, P)
    return Y.to(X.dtype), h


def mamba_block(p, x, cfg, rt: TunableConfig, rules, want_state: bool = False):
    """Full Mamba2 block (prefill).  x: (B,S,d) -> (B,S,d).

    want_state=True additionally returns the decode cache entry."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = L.rmsnorm(x, p["ln"], rt, cfg.norm_eps)
    xin, z, Bm, Cm, dt, loga = _gates(p, h, cfg, rt)
    xin, conv_state = _causal_conv(xin, L.cast(p["conv"], rt))
    xin = F.silu(xin)
    if rules is not None:
        xin = rules.constrain(xin, "batch", None, "ssm_inner")
    X = xin.reshape(B, S, H, P)
    if rt.attn_impl == "pallas":
        from repro_torch.kernels.ssm_scan import ops as ssm_ops
        Y, h_final = ssm_ops.ssm_scan(X, Bm, Cm, dt, loga,
                                      chunk=cfg.ssm_chunk)
    else:
        Y, h_final = ssd_chunked(X, Bm, Cm, dt, loga, cfg.ssm_chunk)
    Y = Y + p["D"].to(Y.dtype)[None, None, :, None] * X
    y = Y.reshape(B, S, d_in)
    y = L.rmsnorm(y * F.silu(z), p["gln"], rt, cfg.norm_eps)
    if rules is not None:
        y = rules.constrain(y, "batch", None, "ssm_inner")
    out = x + y @ L.cast(p["wo"], rt)
    if want_state:
        return out, {"ssm": h_final, "conv": conv_state.float()}
    return out


# ------------------------------------------------------------- decode
def mamba_cache_shapes(cfg, batch: int, layers: int):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    shp = {
        "ssm": L.ShapeDtype(
            (layers, batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "conv": L.ShapeDtype((layers, batch, 3, d_in), torch.float32),
    }
    lg = {"ssm": ("layers", "batch", "ssm_heads", None, None),
          "conv": ("layers", "batch", None, "ssm_inner")}
    return shp, lg


def mamba_decode_block(p, x, layer_cache, cfg, rt: TunableConfig, rules):
    """One-token recurrent update.  x: (B,1,d).  Returns (out, new state);
    the given state is not modified."""
    B, _, d = x.shape
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    h = L.rmsnorm(x, p["ln"], rt, cfg.norm_eps)
    xin, z, Bm, Cm, dt, loga = _gates(p, h, cfg, rt)
    xin, conv_state = _causal_conv(xin, L.cast(p["conv"], rt),
                                   state=layer_cache["conv"])
    xin = F.silu(xin)
    X = xin.reshape(B, H, P).float()
    a = torch.exp(loga[:, 0, :])                        # (B,H)
    hs = layer_cache["ssm"]                             # (B,H,P,N)
    hs = (a[:, :, None, None] * hs
          + torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], X, Bm[:, 0]))
    Y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], hs)
    Y = Y + p["D"].to(Y.dtype)[None, :, None] * X
    y = Y.reshape(B, 1, d_in).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["gln"], rt, cfg.norm_eps)
    if rules is not None:
        y = rules.constrain(y, "batch", None, "ssm_inner")
    out = x + y @ L.cast(p["wo"], rt)
    return out, {"ssm": hs, "conv": conv_state.float()}
