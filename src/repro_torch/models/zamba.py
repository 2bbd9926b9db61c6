"""Zamba2-style hybrid: Mamba2 backbone + ONE shared attention block.

81 Mamba2 blocks; a single shared transformer block (attn + MLP, weights
shared) is invoked after every ``attn_every``-th Mamba2 block.  Decode
carries SSM/conv states for every Mamba2 block plus a KV cache per shared-
block invocation.  This slice carries prefill and decode; ``loss_fn`` is
the training slice's (ROADMAP.md, queue A).

The cache is ``{"groups": {"ssm", "conv"}, "kv": {"k", "v"[, scales]},
"pos": int[, "rem": {"ssm", "conv"}]}`` with the reference's stacked
shapes: ``groups`` tensors lead with (groups, attn_every), ``kv`` with
(groups,), ``rem`` with (remainder blocks,).  ``pos`` is a host integer,
so no decode step reads the position back from the device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.runtime import remat
from repro_torch.runtime.loops import scan_layers


def _shared_spec(cfg) -> Dict[str, L.PSpec]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def _split(cfg):
    g = cfg.n_layers // cfg.attn_every        # full groups
    rem = cfg.n_layers - g * cfg.attn_every
    return g, rem


def spec(cfg) -> Dict:
    g, rem = _split(cfg)
    out = {
        "embed": L.embed_spec(cfg),
        "groups": L.stacked(g, L.stacked(cfg.attn_every,
                                         mamba2.mamba_spec(cfg))),
        "shared": _shared_spec(cfg),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if rem:
        out["rem"] = L.stacked(rem, mamba2.mamba_spec(cfg))
    return out


def _shared_block(sp, x, positions, cfg, rt, rules):
    h = L.rmsnorm(x, sp["ln1"], rt, cfg.norm_eps)
    x = x + L.attention_block(sp["attn"], h, cfg=cfg, rt=rt, rules=rules,
                              positions=positions)
    h = L.rmsnorm(x, sp["ln2"], rt, cfg.norm_eps)
    return x + L.mlp_block(sp["mlp"], h, cfg=cfg, rt=rt, rules=rules)


def forward(p, h, positions, cfg, rt: TunableConfig, rules):
    """The layer stack on (B,S,d) -> final-normed (B,S,d), carrying the
    residual between groups in ``remat.carry_dtype`` as the reference
    does (its recompute wrapper belongs to the training slice)."""
    def inner(xc, mp):
        return mamba2.mamba_block(mp, xc, cfg, rt, rules), None

    def group(x, gp):
        x = remat.from_carry(x, rt)
        x, _ = scan_layers(inner, x, gp, unroll=rt.unroll_layers)
        x = _shared_block(p["shared"], x, positions, cfg, rt, rules)
        return remat.to_carry(x, rt), None

    h, _ = scan_layers(group, remat.to_carry(h, rt), p["groups"],
                       unroll=rt.unroll_layers)
    h = remat.from_carry(h, rt)
    if "rem" in p:
        h, _ = scan_layers(inner, h, p["rem"], unroll=rt.unroll_layers)
    return L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)


def loss_fn(p, batch, cfg, rt: TunableConfig, rules):
    raise NotImplementedError(
        "loss_fn is not ported yet (ROADMAP.md queue A, training: loss_fn, "
        "runtime/stepfn.py, optim/)")


# ------------------------------------------------------------- serving
def cache_shapes(cfg, batch: int, max_seq: int, rt: TunableConfig):
    g, rem = _split(cfg)
    mg, mg_lg = mamba2.mamba_cache_shapes(cfg, batch, g * cfg.attn_every)
    mg = {k: L.ShapeDtype((g, cfg.attn_every) + s.shape[1:], s.dtype)
          for k, s in mg.items()}
    mg_lg = {k: ("layers",) + t for k, t in mg_lg.items()}
    kv, kv_lg = L.attn_cache_shapes(cfg, batch, max_seq, rt, layers=g)
    shp = {"groups": mg, "kv": kv, "pos": L.ShapeDtype((), torch.int32)}
    lg = {"groups": mg_lg, "kv": kv_lg, "pos": ()}
    if rem:
        mr, mr_lg = mamba2.mamba_cache_shapes(cfg, batch, rem)
        shp["rem"] = mr
        lg["rem"] = mr_lg
    return shp, lg


def init_cache(cfg, batch: int, max_seq: int, rt: TunableConfig,
               device="cuda"):
    shp, _ = cache_shapes(cfg, batch, max_seq, rt)
    zeros = lambda part: {k: torch.zeros(s.shape, dtype=s.dtype,
                                         device=device)
                          for k, s in part.items()}
    cache = {"groups": zeros(shp["groups"]), "kv": zeros(shp["kv"]),
             "pos": 0}
    if "rem" in shp:
        cache["rem"] = zeros(shp["rem"])
    return cache


def prefill_fn(p, batch, cfg, rt: TunableConfig, rules, max_seq: int):
    """Run the full prompt, build the SSM/conv states and the KV cache,
    return last-token logits."""
    L.require_no_rules(rules)
    h = L.embed(p["embed"], batch["tokens"], rt)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    sp = p["shared"]

    def inner(xc, mp):
        return mamba2.mamba_block(mp, xc, cfg, rt, rules, want_state=True)

    def group(x, gp):
        x, states = scan_layers(inner, x, gp, unroll=rt.unroll_layers)
        hn = L.rmsnorm(x, sp["ln1"], rt, cfg.norm_eps)
        # k/v recomputed once for cache storage (cheap vs attention itself)
        k = torch.einsum("bsd,dhk->bshk", hn, L.cast(sp["attn"]["wk"], rt))
        v = torch.einsum("bsd,dhk->bshk", hn, L.cast(sp["attn"]["wv"], rt))
        k = L.rope(k, positions, cfg.rope_theta)
        x = _shared_block(sp, x, positions, cfg, rt, rules)
        kq, ks = L.quantize_kv(k, rt.kv_cache_dtype)
        vq, vs = L.quantize_kv(v, rt.kv_cache_dtype)
        extras = (kq, vq) if ks is None else (kq, vq, ks, vs)
        return x, (states, extras)

    h, (gstates, extras) = scan_layers(group, h, p["groups"],
                                       unroll=rt.unroll_layers)
    pad = max_seq - S

    def pad_seq(t):        # (g,B,S,Hkv,x) -> zero-padded to max_seq
        return F.pad(t, (0, 0, 0, 0, 0, pad)).contiguous()
    kv = {"k": pad_seq(extras[0]), "v": pad_seq(extras[1])}
    if len(extras) == 4:
        kv["k_scale"] = pad_seq(extras[2])
        kv["v_scale"] = pad_seq(extras[3])
    cache = {"groups": gstates, "kv": kv, "pos": S}
    if "rem" in p:
        h, cache["rem"] = scan_layers(inner, h, p["rem"],
                                      unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h[:, -1:], cfg, rt, rules)
    return logits, cache


def decode_fn(p, cache, tokens, cfg, rt: TunableConfig, rules):
    """One decode step.  tokens: (B,1) integers.  Returns (logits, cache).

    ``rt.donate_buffers`` keeps the meaning ``transformer.decode_fn``
    gives it, for the SSM and conv states as for the KV cache: when true
    the given cache's tensors are updated in place and returned (the
    caller's cache is consumed, as a donated buffer is); when false the
    step works on a copy and the given cache is left as it was.  The
    results are the same either way."""
    L.require_no_rules(rules)
    h = L.embed(p["embed"], tokens, rt)
    pos = int(cache["pos"])
    parts = ("groups", "kv", "rem")
    new = {k: dict(cache[k]) for k in parts if k in cache}
    if not rt.donate_buffers:
        new = {k: {n: t.clone() for n, t in part.items()}
               for k, part in new.items()}
    sp = p["shared"]

    def inner(xc, margs):
        mp, mstate = margs
        out, st = mamba2.mamba_decode_block(mp, xc, mstate, cfg, rt, rules)
        # the layer's state slices are views of the cache: write in place
        mstate["ssm"].copy_(st["ssm"])
        mstate["conv"].copy_(st["conv"])
        return out, None

    def group(x, args):
        gp, gstate, gkv = args
        x, _ = scan_layers(inner, x, (gp, gstate), unroll=rt.unroll_layers)
        hn = L.rmsnorm(x, sp["ln1"], rt, cfg.norm_eps)
        # the layer's KV slices are views: the new K/V are written in place
        a, _ = L.decode_attention_block(sp["attn"], hn, gkv, pos, cfg=cfg,
                                        rt=rt, rules=rules)
        x = x + a
        hn = L.rmsnorm(x, sp["ln2"], rt, cfg.norm_eps)
        return x + L.mlp_block(sp["mlp"], hn, cfg=cfg, rt=rt,
                               rules=rules), None

    h, _ = scan_layers(group, h, (p["groups"], new["groups"], new["kv"]),
                       unroll=rt.unroll_layers)
    if "rem" in p:
        h, _ = scan_layers(inner, h, (p["rem"], new["rem"]),
                           unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return logits, dict(new, pos=pos + 1)
