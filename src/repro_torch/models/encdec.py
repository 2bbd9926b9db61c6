"""Encoder-decoder transformer (Seamless-M4T backbone).

The encoder consumes precomputed frame embeddings from the (stubbed)
audio frontend; the decoder is a causal transformer with
cross-attention.  Decode carries a self-attention KV cache plus a fixed
cross-attention cache computed at prefill.  Every norm is ``rmsnorm``.

Kernels under ``attn_impl="pallas"``: ``rmsnorm`` everywhere, the
decoder's causal self-attention through ``flash_attention`` (prefill)
and ``flash_decode`` (decode).  The encoder's self-attention (not
causal) and the cross-attention take the eager path of
``layers.full_attention``, as the reference's do.

The cache is ``{"self": {"k", "v"[, "k_scale", "v_scale"]}, "cross_k",
"cross_v", "pos"}``: the self cache stacked ``(L, B, Smax, Hkv, hd)`` in
``kv_cache_dtype``, the cross K/V ``(L, B, enc_len, Hkv, hd)`` in the
compute dtype, ``pos`` a host integer.  On a mesh (``rules``) the
cache's tensors are DTensors on the placements of their logical names
(``cache_shapes``), the cross K/V split like the self cache.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.runtime import remat
from repro_torch.runtime.loops import scan_layers


def _enc_block_spec(cfg) -> Dict[str, L.PSpec]:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_spec(cfg),
    }


def _dec_block_spec(cfg) -> Dict[str, L.PSpec]:
    out = _enc_block_spec(cfg)
    out["lnx"] = L.rmsnorm_spec(cfg.d_model)
    out["xattn"] = L.attn_spec(cfg)
    return out


def spec(cfg) -> Dict:
    return {
        "embed": L.embed_spec(cfg),
        "enc_blocks": L.stacked(cfg.enc_layers, _enc_block_spec(cfg)),
        "dec_blocks": L.stacked(cfg.n_layers, _dec_block_spec(cfg)),
        "enc_norm": L.rmsnorm_spec(cfg.d_model),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def encode(p, frames, cfg, rt: TunableConfig, rules):
    """frames: (B, S_enc, d) stub frontend embeddings -> encoder output.
    Each layer runs under the remat policy, the residual between layers
    carried in ``remat.carry_dtype``, as in the reference (in prefill
    too)."""
    h = L.cast(frames, rt)
    if rules is not None:
        h = rules.constrain(h, "batch", None, None)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)

    def body(x, bp):
        x = remat.from_carry(x, rt)
        hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
        x = x + L.attention_block(bp["attn"], hn, cfg=cfg, rt=rt,
                                  rules=rules, positions=positions,
                                  causal=False)
        hn = L.rmsnorm(x, bp["ln2"], rt, cfg.norm_eps)
        x = x + L.mlp_block(bp["mlp"], hn, cfg=cfg, rt=rt, rules=rules)
        return remat.to_carry(x, rt), None

    h, _ = scan_layers(remat.wrap_layer(body, rt), remat.to_carry(h, rt),
                       p["enc_blocks"], unroll=rt.unroll_layers)
    return L.rmsnorm(remat.from_carry(h, rt), p["enc_norm"], rt,
                     cfg.norm_eps)


def _dec_block(bp, x, enc_out, positions, cfg, rt, rules):
    hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
    x = x + L.attention_block(bp["attn"], hn, cfg=cfg, rt=rt, rules=rules,
                              positions=positions)
    hn = L.rmsnorm(x, bp["lnx"], rt, cfg.norm_eps)
    x = x + L.attention_block(bp["xattn"], hn, cfg=cfg, rt=rt, rules=rules,
                              positions=positions, kv_x=enc_out)
    hn = L.rmsnorm(x, bp["ln2"], rt, cfg.norm_eps)
    return x + L.mlp_block(bp["mlp"], hn, cfg=cfg, rt=rt, rules=rules)


def _positions(h):
    B, S, _ = h.shape
    return torch.arange(S, device=h.device).expand(B, S)


def loss_fn(p, batch, cfg, rt: TunableConfig, rules):
    """Mean next-token cross-entropy of the decoder -> (loss, {})."""
    enc_out = encode(p, batch["frames"], cfg, rt, rules)
    h = L.embed(p["embed"], batch["tokens"], rt, rules)
    if rules is not None:
        h = rules.constrain(h, "batch", None, None)
    positions = _positions(h)

    def body(x, bp):
        x = remat.from_carry(x, rt)
        x = _dec_block(bp, x, enc_out, positions, cfg, rt, rules)
        return remat.to_carry(x, rt), None

    h, _ = scan_layers(remat.wrap_layer(body, rt), remat.to_carry(h, rt),
                       p["dec_blocks"], unroll=rt.unroll_layers)
    h = L.rmsnorm(remat.from_carry(h, rt), p["final_norm"], rt,
                  cfg.norm_eps)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return L.xent_loss(logits, batch["labels"], cfg), {}


# ------------------------------------------------------------- serving
def cache_shapes(cfg, batch: int, max_seq: int, rt: TunableConfig,
                 enc_len: int = None):
    if enc_len is None:
        enc_len = max_seq // cfg.enc_seq_ratio
    self_kv, self_lg = L.attn_cache_shapes(cfg, batch, max_seq, rt)
    xshape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    xlg = ("layers", "batch", None, "kv_heads", None)
    shp = {"self": self_kv,
           "cross_k": L.ShapeDtype(xshape, L.dt(rt)),
           "cross_v": L.ShapeDtype(xshape, L.dt(rt)),
           "pos": L.ShapeDtype((), torch.int32)}
    lg = {"self": self_lg, "cross_k": xlg, "cross_v": xlg, "pos": ()}
    return shp, lg


def init_cache(cfg, batch: int, max_seq: int, rt: TunableConfig,
               device="cuda", enc_len: int = None):
    shp, _ = cache_shapes(cfg, batch, max_seq, rt, enc_len)
    zeros = lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device)
    return {"self": {k: zeros(s) for k, s in shp["self"].items()},
            "cross_k": zeros(shp["cross_k"]),
            "cross_v": zeros(shp["cross_v"]), "pos": 0}


def prefill_fn(p, batch, cfg, rt: TunableConfig, rules, max_seq: int):
    """Encode the frames, run the full prompt, build the self and cross
    caches, return last-token logits.  As in the reference, each block
    norms ``ln1`` and projects the cross K/V twice: once for the cache,
    once inside the block."""
    enc_out = encode(p, batch["frames"], cfg, rt, rules)
    h = L.embed(p["embed"], batch["tokens"], rt, rules)
    if rules is not None:
        h = rules.constrain(h, "batch", None, None)
    B, S, _ = h.shape
    positions = _positions(h)

    def body(x, bp):
        hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
        k = L.heads_in(hn, bp["attn"]["wk"], rt, rules)
        v = L.heads_in(hn, bp["attn"]["wv"], rt, rules)
        k = L.rope(k, positions, cfg.rope_theta)
        xk = L.heads_in(enc_out, bp["xattn"]["wk"], rt, rules)
        xv = L.heads_in(enc_out, bp["xattn"]["wv"], rt, rules)
        x = _dec_block(bp, x, enc_out, positions, cfg, rt, rules)
        kq, ks = L.quantize_kv(k, rt.kv_cache_dtype)
        vq, vs = L.quantize_kv(v, rt.kv_cache_dtype)
        extras = (kq, vq) if ks is None else (kq, vq, ks, vs)
        return x, (extras, xk, xv)

    h, (extras, xk, xv) = scan_layers(body, h, p["dec_blocks"],
                                      unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h[:, -1:], cfg, rt, rules)
    pad = max_seq - S

    def pad_seq(t):        # (L,B,S,Hkv,x) -> zero-padded to max_seq
        return L.pad_rows(t, 2, pad)
    self_kv = {"k": pad_seq(extras[0]), "v": pad_seq(extras[1])}
    if len(extras) == 4:
        self_kv["k_scale"] = pad_seq(extras[2])
        self_kv["v_scale"] = pad_seq(extras[3])
    cache = {"self": self_kv, "cross_k": xk, "cross_v": xv, "pos": S}
    if rules is not None:
        cache = L.constrain_tree(rules, cache, cache_shapes(
            cfg, B, max_seq, rt, enc_len=xk.shape[2])[1])
    return logits, cache


def decode_fn(p, cache, tokens, cfg, rt: TunableConfig, rules):
    """One decode step.  tokens: (B,1) integers.  Returns (logits, cache).

    ``rt.donate_buffers`` keeps the meaning ``transformer.decode_fn``
    gives it for the self cache (in place when true, on a copy when
    false); the cross cache is only read."""
    h = L.embed(p["embed"], tokens, rt, rules)
    pos = int(cache["pos"])
    if rules is not None:
        xk = cache["cross_k"]
        cache = L.constrain_tree(rules, cache, cache_shapes(
            cfg, xk.shape[1], cache["self"]["k"].shape[2], rt,
            enc_len=xk.shape[2])[1])
    self_kv = cache["self"]
    if not rt.donate_buffers:
        self_kv = {k: t.clone() for k, t in self_kv.items()}
    n_rep = cfg.n_heads // cfg.n_kv_heads

    def body(x, args):
        bp, layer_cache, xk, xv = args
        hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
        # the layer's cache slices are views: the new K/V are written in
        # place
        a, _ = L.decode_attention_block(bp["attn"], hn, layer_cache, pos,
                                        cfg=cfg, rt=rt, rules=rules)
        x = x + a
        # cross-attention against the fixed encoder cache
        hn = L.rmsnorm(x, bp["lnx"], rt, cfg.norm_eps)
        q = L.heads_in(hn, bp["xattn"]["wq"], rt, rules)
        kf = L._repeat_kv(xk.to(L.dt(rt)), n_rep)
        vf = L._repeat_kv(xv.to(L.dt(rt)), n_rep)
        if rules is not None:
            q, kf, vf = (rules.constrain(t, "batch", None, "heads", None)
                         for t in (q, kf, vf))
        o = L.full_attention(q, kf, vf, causal=False, rt=rt)
        if rules is not None:
            o = rules.constrain(o, "batch", None, "heads", None)
        x = x + L.residual(L.heads_out(o, bp["xattn"]["wo"], rt, rules),
                           hn)
        hn = L.rmsnorm(x, bp["ln2"], rt, cfg.norm_eps)
        return x + L.mlp_block(bp["mlp"], hn, cfg=cfg, rt=rt,
                               rules=rules), None

    h, _ = scan_layers(body, h, (p["dec_blocks"], self_kv, cache["cross_k"],
                                 cache["cross_v"]), unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return logits, {"self": self_kv, "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"], "pos": pos + 1}
