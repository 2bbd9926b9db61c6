"""Plain reference of the port's decoder-only transformer with a
mixture-of-experts FFN (OLMoE-style), in float32.

Each layer: rmsnorm, causal self-attention with RoPE, rmsnorm, then the
exact top-k MoE: a softmax router over all experts, the k largest gates
renormalised to sum to 1, and the gated sum of the chosen experts'
SwiGLU FFNs (no capacity, no token dropped).  Embedding, final rmsnorm
and an unembedding over the padded vocabulary.  The weights are a tree
laid out as the configuration's ``param_shapes`` (``embed``, ``blocks``
(L, ...), ``final_norm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C


def moe(prec, p, x, arch):
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    gates = torch.softmax(prec.mm(xt, p["router"]), dim=-1)
    top, idx = torch.topk(gates, arch["top_k"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(gates.shape[-1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xt[rows]
        he = F.silu(prec.mm(xe, p["wg"][e])) * prec.mm(xe, p["wu"][e])
        y.index_add_(0, rows, prec.mm(he, p["wd"][e]) * top[rows, slot, None])
    return y.view(B, S, d)


def hidden(w, tokens, arch, prec):
    """Final-normed hidden states (B, S, d) of tokens (B, S)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    eps = arch["norm_eps"]
    x = w["embed"]["embedding"][tokens.long()].float()
    for i in range(w["blocks"]["ln1"].shape[0]):
        p = C.layer(w["blocks"], i)
        x = x + C.attention(prec, p["attn"], C.rmsnorm(x, p["ln1"], eps),
                            positions, arch["rope_theta"], arch["n_heads"],
                            arch["n_kv_heads"])
        x = x + moe(prec, p["moe"], C.rmsnorm(x, p["ln2"], eps), arch)
    return C.rmsnorm(x, w["final_norm"], eps)


def unembed(w, h, prec):
    u = w["embed"].get("unembed")
    if u is None:
        u = w["embed"]["embedding"].T
    return prec.mm(h, u)


def flops_terms(arch):
    """Model FLOPs of one token, as ``(a, b, u)``: ``a`` for the layers
    apart from attention's context (the router and the top-k experts
    only), ``b`` for each key attended, ``u`` for the unembedding."""
    d, E, k, ff = (arch["d_model"], arch["n_experts"], arch["top_k"],
                   arch["d_ff"])
    H, Hkv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    layer = (2 * (2 * d * H * hd + 2 * d * Hkv * hd) + 2 * d * E
             + k * 2 * 3 * d * ff)
    return (arch["n_layers"] * layer, arch["n_layers"] * 4 * H * hd,
            2 * d * arch["vocab"])
