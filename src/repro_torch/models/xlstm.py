"""xLSTM: alternating mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly sequential) blocks, layout [slstm_every-1 : 1].

The reference's deviations from the paper stand: the mLSTM input gate
uses sigmoid stabilisation (instead of the running-max exponential-gate
stabiliser) so the chunkwise form shares the SSD machinery; sLSTM
recurrent weights are diagonal (element-wise) rather than block-diagonal.
No kernel is on this path: the mLSTM's chunkwise form and the sLSTM's
recurrence are eager ops, as in the reference; the norms go through
``rmsnorm`` (the kernel under ``attn_impl="pallas"``).

The cache is ``{"m_h", "m_n", "s", "pos"}``: the mLSTM states stacked
``(groups, mLSTM blocks a group, B, H, hd, hd)`` and ``(..., B, H, hd)``
f32, the sLSTM state a tuple of four ``(groups, B, d)`` f32 tensors (c,
n, m, h) and ``pos`` a host integer, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.runtime import remat
from repro_torch.runtime.loops import scan_layers


# ----------------------------------------------------------- mLSTM
def mlstm_spec(cfg) -> Dict[str, L.PSpec]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "ln": L.rmsnorm_spec(d),
        "wq": L.PSpec((d, H, hd), ("embed", None, None)),
        "wk": L.PSpec((d, H, hd), ("embed", None, None)),
        "wv": L.PSpec((d, H, hd), ("embed", None, "ssm_inner")),
        "wi": L.PSpec((d, H), ("embed", None)),
        "wf": L.PSpec((d, H), ("embed", None)),
        "wog": L.PSpec((d, d), ("embed", None)),
        "wo": L.PSpec((d, d), ("ssm_inner", "embed")),
    }


def _mlstm_chunked(q, k, v, ig, lf, chunk: int, state=None):
    """Chunkwise mLSTM.  q/k/v: (B,S,H,hd); ig (input gate, (B,S,H)),
    lf (log forget, (B,S,H)).  Returns (y, (h_state, n_state))."""
    Bsz, S, H, hd = q.shape
    f32 = torch.float32
    if S % chunk:
        # pad with no-op tokens: input gate 0, log-forget 0 (no decay)
        pad = chunk - S % chunk
        pz = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])
        y, st = _mlstm_chunked(pz(q), pz(k), pz(v), pz(ig), pz(lf),
                               chunk, state)
        return y[:, :S], st
    nc, Q = S // chunk, chunk
    rs = lambda t: t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))
    qc, kc, vc = rs(q).to(f32), rs(k).to(f32), rs(v).to(f32)
    igc, lfc = rs(ig).to(f32), rs(lf).to(f32)
    cum = torch.cumsum(lfc, dim=2)                        # (B,nc,Q,H)
    # Above the diagonal the exponent is a sum of -log forget gates (>= 0):
    # about 200 over a chunk of 256 at unit-scale gates, past f32's exp
    # range.  It is masked to -inf before the exp, so those entries are 0
    # as in the reference and their gradient is 0 (the reference takes
    # the exp first and masks after: 0 * inf = NaN in its gradient)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = L.replicated_like(torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                                  device=q.device)), diff)
    Lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    G = torch.einsum("bcqhn,bckhn->bcqkh", qc, kc)
    W = Lmat * igc[:, :, None, :, :]        # decay-gate weights (no q.k)
    scores = G * W
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, vc)
    n_intra = torch.einsum("bcqkh,bckhn->bcqhn", W, kc)
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)
    Sc = torch.einsum("bckh,bckhp,bckhn->bchpn", igc * dec_last, vc, kc)
    Nc = torch.einsum("bckh,bckhn->bchn", igc * dec_last, kc)
    a_chunk = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    # the reference's inter-chunk scan, a loop over the chunks
    if state is None:
        h = L.replicated_like(torch.zeros((Bsz, H, hd, hd), dtype=f32,
                                          device=q.device), Sc)
        n = L.replicated_like(torch.zeros((Bsz, H, hd), dtype=f32,
                                          device=q.device), Sc)
    else:
        h, n = state
    y_inter, nn_inter = [], []
    for c in range(nc):
        dec = torch.exp(cum[:, c])                        # (B,Q,H)
        y_inter.append(torch.einsum("bqhn,bqh,bhpn->bqhp", qc[:, c], dec,
                                    h))
        nn_inter.append(torch.einsum("bqhn,bqh,bhn->bqh", qc[:, c], dec, n))
        h = a_chunk[:, c][:, :, None, None] * h + Sc[:, c]
        n = a_chunk[:, c][:, :, None] * n + Nc[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)             # (B,nc,Q,H,hd)
    # normalizer: q . n  (intra part from n_intra, inter part nn_inter)
    qn = torch.einsum("bcqhn,bcqhn->bcqh", qc, n_intra) \
        + torch.stack(nn_inter, dim=1)
    denom = torch.clamp(torch.abs(qn), min=1.0)[..., None]
    y = (y / denom).reshape(Bsz, S, H, hd)
    return y.to(q.dtype), (h, n)


def mlstm_block(p, x, cfg, rt: TunableConfig, rules, want_state=False,
                state=None, decode=False):
    B, S, d = x.shape
    h = L.rmsnorm(x, p["ln"], rt, cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, L.cast(p["wq"], rt)) \
        / (cfg.hd ** 0.5)
    k = torch.einsum("bsd,dhk->bshk", h, L.cast(p["wk"], rt))
    v = torch.einsum("bsd,dhk->bshk", h, L.cast(p["wv"], rt))
    if rules is not None:
        v = rules.constrain(v, "batch", None, None, "ssm_inner")
    ig = torch.sigmoid((h @ L.cast(p["wi"], rt)).float())
    lf = _logsigmoid((h @ L.cast(p["wf"], rt)).float())
    og = torch.sigmoid(h @ L.cast(p["wog"], rt))
    if decode:
        hs, ns = state
        f32 = torch.float32
        q0, k0, v0 = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
        a = torch.exp(lf[:, 0])                           # (B,H)
        hs = (a[:, :, None, None] * hs
              + torch.einsum("bh,bhp,bhn->bhpn", ig[:, 0], v0, k0))
        ns = a[:, :, None] * ns + ig[:, 0, :, None] * k0
        yq = torch.einsum("bhn,bhpn->bhp", q0, hs)
        qn = torch.einsum("bhn,bhn->bh", q0, ns)
        y = (yq / torch.clamp(torch.abs(qn), min=1.0)[:, :, None])[:, None]
        new_state = (hs, ns)
    else:
        y, new_state = _mlstm_chunked(q, k, v, ig, lf, cfg.ssm_chunk, state)
    y = y.reshape(B, S, d).to(x.dtype) * og
    out = x + y @ L.cast(p["wo"], rt)
    if want_state or decode:
        return out, new_state
    return out


# ----------------------------------------------------------- sLSTM
def slstm_spec(cfg) -> Dict[str, L.PSpec]:
    d = cfg.d_model
    return {
        "ln": L.rmsnorm_spec(d),
        "wi": L.PSpec((d, d), ("embed", None)),
        "wf": L.PSpec((d, d), ("embed", None)),
        "wz": L.PSpec((d, d), ("embed", None)),
        "wog": L.PSpec((d, d), ("embed", None)),
        "ri": L.PSpec((d,), (None,), "zeros"),
        "rf": L.PSpec((d,), (None,), "zeros"),
        "rz": L.PSpec((d,), (None,), "zeros"),
        "ro": L.PSpec((d,), (None,), "zeros"),
        "wo": L.PSpec((d, d), ("embed", None)),
    }


def _slstm_step(p, carry, zi, zf, zz, zo):
    """One sLSTM timestep.  carry: (c, n, m, h) each (B,d) f32."""
    c, n, m, h = carry
    zi = zi + h * p["ri"]
    zf = zf + h * p["rf"]
    zz = torch.tanh(zz + h * p["rz"])
    zo = torch.sigmoid(zo + h * p["ro"])
    lf = _logsigmoid(zf)
    m_new = torch.maximum(lf + m, zi)
    keep = torch.exp(lf + m - m_new)
    write = torch.exp(zi - m_new)
    c = keep * c + write * zz
    n = keep * n + write
    h = zo * c / torch.clamp(n, min=1.0)
    return (c, n, m_new, h)


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor elementwise on each rank's block
    (DTensor has no sharding rule for its backward)."""
    return L.sharded_kernel(F.logsigmoid, 0, x)


def init_slstm_state(B: int, d: int, device):
    """The sLSTM state before the first token: c, n, h zero, the
    stabiliser m at -1e30 (an -inf surrogate)."""
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return (z, z, torch.full((B, d), -1e30, dtype=torch.float32,
                             device=device), z)


def slstm_block(p, x, cfg, rt: TunableConfig, rules, want_state=False,
                state=None, decode=False):
    """The sLSTM block.  Prefill is a loop over S of ``_slstm_step`` (the
    reference's ``lax.scan``), eager: about thirty small ops a token."""
    B, S, d = x.shape
    hn = L.rmsnorm(x, p["ln"], rt, cfg.norm_eps)
    zi = (hn @ L.cast(p["wi"], rt)).float()
    zf = (hn @ L.cast(p["wf"], rt)).float()
    zz = (hn @ L.cast(p["wz"], rt)).float()
    zo = (hn @ L.cast(p["wog"], rt)).float()
    pf = {k2: p[k2].float() for k2 in ("ri", "rf", "rz", "ro")}
    if state is None:
        state = tuple(L.replicated_like(t, zi)
                      for t in init_slstm_state(B, d, x.device))
    if decode:
        new_state = _slstm_step(pf, state, zi[:, 0], zf[:, 0], zz[:, 0],
                                zo[:, 0])
        y = new_state[3][:, None, :]
    else:
        carry, ys = state, []
        for t in zip(zi.unbind(1), zf.unbind(1), zz.unbind(1),
                     zo.unbind(1)):
            carry = _slstm_step(pf, carry, *t)
            ys.append(carry[3])
        new_state = carry
        y = torch.stack(ys, dim=1)
    out = x + y.to(x.dtype) @ L.cast(p["wo"], rt)
    if want_state or decode:
        return out, new_state
    return out


# ----------------------------------------------------------- model
def _layout(cfg):
    g = cfg.n_layers // cfg.slstm_every
    m_per_group = cfg.slstm_every - 1
    return g, m_per_group


def spec(cfg) -> Dict:
    g, mpg = _layout(cfg)
    return {
        "embed": L.embed_spec(cfg),
        "mblocks": L.stacked(g, L.stacked(mpg, mlstm_spec(cfg))),
        "sblocks": L.stacked(g, slstm_spec(cfg)),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def forward(p, h, cfg, rt: TunableConfig, rules):
    """The block stack on (B,S,d) -> final-normed (B,S,d): each group
    (its mLSTM blocks, then its sLSTM block) runs under the remat policy,
    the residual between groups carried in ``remat.carry_dtype``, as in
    the reference."""
    def inner(xc, mpp):
        return mlstm_block(mpp, xc, cfg, rt, rules), None

    def group(x, gp):
        mp, sp = gp
        x = remat.from_carry(x, rt)
        x, _ = scan_layers(inner, x, mp, unroll=rt.unroll_layers)
        x = slstm_block(sp, x, cfg, rt, rules)
        return remat.to_carry(x, rt), None

    h, _ = scan_layers(remat.wrap_layer(group, rt), remat.to_carry(h, rt),
                       (p["mblocks"], p["sblocks"]),
                       unroll=rt.unroll_layers)
    return L.rmsnorm(remat.from_carry(h, rt), p["final_norm"], rt,
                     cfg.norm_eps)


def loss_fn(p, batch, cfg, rt: TunableConfig, rules):
    """Mean next-token cross-entropy -> (loss, {})."""
    h = L.embed(p["embed"], batch["tokens"], rt)
    if rules is not None:
        h = rules.constrain(h, "batch", None, None)
    h = forward(p, h, cfg, rt, rules)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return L.xent_loss(logits, batch["labels"], cfg), {}


# ------------------------------------------------------------- serving
def cache_shapes(cfg, batch: int, max_seq: int, rt: TunableConfig):
    """A fixed-size state: ``max_seq`` does not enter it."""
    g, mpg = _layout(cfg)
    H, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    f32 = torch.float32
    shp = {
        "m_h": L.ShapeDtype((g, mpg, batch, H, hd, hd), f32),
        "m_n": L.ShapeDtype((g, mpg, batch, H, hd), f32),
        "s": tuple(L.ShapeDtype((g, batch, d), f32) for _ in range(4)),
        "pos": L.ShapeDtype((), torch.int32),
    }
    lg = {"m_h": ("layers", "layers", "batch", None, "ssm_inner", None),
          "m_n": ("layers", "layers", "batch", None, None),
          "s": tuple(("layers", "batch", None) for _ in range(4)),
          "pos": ()}
    return shp, lg


def init_cache(cfg, batch: int, max_seq: int, rt: TunableConfig,
               device="cuda"):
    shp, _ = cache_shapes(cfg, batch, max_seq, rt)
    zeros = lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device)
    s = [zeros(t) for t in shp["s"]]
    s[2] -= 1e30                     # sLSTM m-state: an -inf surrogate
    return {"m_h": zeros(shp["m_h"]), "m_n": zeros(shp["m_n"]),
            "s": tuple(s), "pos": 0}


def prefill_fn(p, batch, cfg, rt: TunableConfig, rules, max_seq: int):
    """Run the full prompt, build every block's state, return last-token
    logits."""
    h = L.embed(p["embed"], batch["tokens"], rt)
    if rules is not None:
        h = rules.constrain(h, "batch", None, None)

    def inner(xc, mpp):
        return mlstm_block(mpp, xc, cfg, rt, rules, want_state=True)

    def group(x, gp):
        mp, sp = gp
        x, mstates = scan_layers(inner, x, mp, unroll=rt.unroll_layers)
        x, sstate = slstm_block(sp, x, cfg, rt, rules, want_state=True)
        return x, (mstates, sstate)

    h, (mstates, sstates) = scan_layers(group, h,
                                        (p["mblocks"], p["sblocks"]),
                                        unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h[:, -1:], cfg, rt, rules)
    cache = {"m_h": mstates[0], "m_n": mstates[1], "s": tuple(sstates),
             "pos": int(batch["tokens"].shape[1])}
    return logits, cache


def decode_fn(p, cache, tokens, cfg, rt: TunableConfig, rules):
    """One decode step.  tokens: (B,1) integers.  Returns (logits, cache).

    ``rt.donate_buffers`` keeps the meaning ``transformer.decode_fn``
    gives it: when true the given state tensors are updated in place and
    returned; when false the step works on a copy and the given cache is
    left as it was.  The results are the same either way."""
    h = L.embed(p["embed"], tokens, rt)
    new = {"m_h": cache["m_h"], "m_n": cache["m_n"], "s": tuple(cache["s"])}
    if not rt.donate_buffers:
        new = {"m_h": new["m_h"].clone(), "m_n": new["m_n"].clone(),
               "s": tuple(t.clone() for t in new["s"])}

    def inner(xc, margs):
        mpp, hh, nn = margs
        xc, (h2, n2) = mlstm_block(mpp, xc, cfg, rt, rules, state=(hh, nn),
                                   decode=True)
        # the block's state slices are views of the cache: write in place
        hh.copy_(h2)
        nn.copy_(n2)
        return xc, None

    def group(x, args):
        mp, sp, m_h, m_n, s_st = args
        x, _ = scan_layers(inner, x, (mp, m_h, m_n),
                           unroll=rt.unroll_layers)
        x, s_new = slstm_block(sp, x, cfg, rt, rules, state=tuple(s_st),
                               decode=True)
        for dst, src in zip(s_st, s_new):
            dst.copy_(src)
        return x, None

    h, _ = scan_layers(group, h, (p["mblocks"], p["sblocks"], new["m_h"],
                                  new["m_n"], new["s"]),
                       unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return logits, dict(new, pos=int(cache["pos"]) + 1)
