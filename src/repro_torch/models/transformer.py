"""Dense decoder-only transformer (llama-style): the serving functions.

The layer stack is a Python loop over stacked parameters (leading
'layers' dim).  This slice carries prefill and decode for the dense
family; ``loss_fn`` and the MoE / VLM branches are later slices
(ROADMAP.md, queue A).

The KV cache is ``{"layers": {"k", "v"[, "k_scale", "v_scale"]},
"pos": int}`` with tensors stacked ``(L, B, Smax, Hkv, hd)`` as in the
reference; ``pos`` is a host integer, so no decode step reads the
position back from the device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.runtime import remat
from repro_torch.runtime.loops import scan_layers


def block_spec(cfg) -> Dict[str, L.PSpec]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue A, "
            "the other model families)")
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attn_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def spec(cfg) -> Dict:
    return {
        "embed": L.embed_spec(cfg),
        "blocks": L.stacked(cfg.n_layers, block_spec(cfg)),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }


def _ffn(bp, h, cfg, rt, rules):
    """FFN sub-block -> (y, aux_loss)."""
    if "moe" in bp:
        raise NotImplementedError(
            "the MoE FFN is not ported yet (ROADMAP.md queue A, the other "
            "model families: models/moe.py)")
    return L.mlp_block(bp["mlp"], h, cfg=cfg, rt=rt, rules=rules), 0.0


def _block(bp, x, positions, cfg, rt: TunableConfig, rules):
    h = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
    x = x + L.attention_block(bp["attn"], h, cfg=cfg, rt=rt, rules=rules,
                              positions=positions)
    h = L.rmsnorm(x, bp["ln2"], rt, cfg.norm_eps)
    y, aux = _ffn(bp, h, cfg, rt, rules)
    return x + y, aux


def embed_inputs(p, batch, cfg, rt: TunableConfig, rules):
    """tokens -> (B,S,d)."""
    L.require_no_rules(rules)
    if "frontend_embeds" in batch:
        raise NotImplementedError(
            "frontend embeddings are not ported yet (ROADMAP.md queue A, "
            "the other model families: vlm)")
    return L.embed(p["embed"], batch["tokens"], rt)


def loss_fn(p, batch, cfg, rt: TunableConfig, rules):
    raise NotImplementedError(
        "loss_fn is not ported yet (ROADMAP.md queue A, training: loss_fn, "
        "runtime/stepfn.py, optim/)")


# ------------------------------------------------------------- serving
def cache_shapes(cfg, batch: int, max_seq: int, rt: TunableConfig):
    shp, lg = L.attn_cache_shapes(cfg, batch, max_seq, rt)
    return ({"layers": shp, "pos": L.ShapeDtype((), torch.int32)},
            {"layers": lg, "pos": ()})


def init_cache(cfg, batch: int, max_seq: int, rt: TunableConfig,
               device="cuda"):
    shp, _ = cache_shapes(cfg, batch, max_seq, rt)
    layers = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
              for k, s in shp["layers"].items()}
    return {"layers": layers, "pos": 0}


def prefill_fn(p, batch, cfg, rt: TunableConfig, rules, max_seq: int):
    """Run the full prompt, build the KV cache, return last-token logits."""
    h = embed_inputs(p, batch, cfg, rt, rules)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)

    def body(x, bp):
        x = remat.from_carry(x, rt)
        hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
        # k/v recomputed once for cache storage (cheap vs attention itself)
        k = torch.einsum("bsd,dhk->bshk", hn, L.cast(bp["attn"]["wk"], rt))
        v = torch.einsum("bsd,dhk->bshk", hn, L.cast(bp["attn"]["wv"], rt))
        k = L.rope(k, positions, cfg.rope_theta)
        x, _ = _block(bp, x, positions, cfg, rt, rules)
        kq, ks = L.quantize_kv(k, rt.kv_cache_dtype)
        vq, vs = L.quantize_kv(v, rt.kv_cache_dtype)
        extras = (kq, vq) if ks is None else (kq, vq, ks, vs)
        return remat.to_carry(x, rt), extras

    h, extras = scan_layers(body, remat.to_carry(h, rt), p["blocks"],
                            unroll=rt.unroll_layers)
    h = remat.from_carry(h, rt)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h[:, -1:], cfg, rt, rules)

    pad = max_seq - S

    def pad_seq(t):        # (L,B,S,Hkv,x) -> zero-padded to max_seq
        return F.pad(t, (0, 0, 0, 0, 0, pad)).contiguous()
    cache = {"k": pad_seq(extras[0]), "v": pad_seq(extras[1])}
    if len(extras) == 4:
        cache["k_scale"] = pad_seq(extras[2])
        cache["v_scale"] = pad_seq(extras[3])
    return logits, {"layers": cache, "pos": S}


def decode_fn(p, cache, tokens, cfg, rt: TunableConfig, rules):
    """One decode step.  tokens: (B,1) integers.  Returns (logits, cache).

    ``rt.donate_buffers`` keeps its meaning: when true the given cache's
    tensors are updated in place and returned (the caller's cache is
    consumed, as a donated buffer is); when false the step works on a
    copy and the given cache is left as it was.  The results are the
    same either way."""
    h = L.embed(p["embed"], tokens, rt)
    pos = int(cache["pos"])
    layers = cache["layers"]
    if not rt.donate_buffers:
        layers = {k: t.clone() for k, t in layers.items()}

    def body(x, args):
        bp, layer_cache = args
        hn = L.rmsnorm(x, bp["ln1"], rt, cfg.norm_eps)
        a, _ = L.decode_attention_block(
            bp["attn"], hn, layer_cache, pos, cfg=cfg, rt=rt, rules=rules)
        x = x + a
        hn = L.rmsnorm(x, bp["ln2"], rt, cfg.norm_eps)
        y, _ = _ffn(bp, hn, cfg, rt, rules)
        # the layer's cache slices are views: they were written in place
        return x + y, None

    h, _ = scan_layers(body, h, (p["blocks"], layers),
                       unroll=rt.unroll_layers)
    h = L.rmsnorm(h, p["final_norm"], rt, cfg.norm_eps)
    logits = L.unembed(p["embed"], h, cfg, rt, rules)
    return logits, {"layers": layers, "pos": pos + 1}
