"""Mixture-of-Experts FFN, single device.

The PyTorch port of the reference's ``models/moe.py`` dense path: exact
top-k routing with no capacity drops.  The reference's expert-parallel
paths (``ep_alltoall`` for training and prefill, ``ep_gather`` for
decode) need a mesh; they come with the multi-device slice, and a
non-``None`` ``rules`` raises until then.

The reference computes each slot ``j`` of the top-k as a product of the
tokens with their gathered expert weights, ``wg[gi[:, j]]`` of shape
(T, d, ff): at olmoe-1b-7b's prefill (T 4096, d 2048, ff 1024) that is
17 GB in bf16 per weight and slot.  The port computes the same function
without forming per-token weights: the (token, slot) pairs are sorted
by expert (stably, so each expert sees its tokens in pair order), each
expert runs its FFN on its rows with one product per weight, and the
rows are put back in pair order as a (T, k, d) buffer that is weighted
by the gates and summed over k in the reference's order (Python's
``sum``: ``0 + out_0 + out_1 + ...``, each add in the compute dtype).
The number of rows per expert is read back to the host once per call,
so the expert loop launches work only for the experts that have rows.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L

EXPERT_PARALLEL = "ROADMAP.md queue A, slice 7: multi-device"


def moe_spec(cfg) -> Dict[str, L.PSpec]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": L.PSpec((d, E), ("embed", "expert"), 0.02),
        "wg": L.PSpec((E, d, ff), ("expert", "embed", "mlp")),
        "wu": L.PSpec((E, d, ff), ("expert", "embed", "mlp")),
        "wd": L.PSpec((E, ff, d), ("expert", "mlp", "embed")),
    }


def top_k(x, k: int):
    """The ``k`` largest values along the last dim and their indices, in
    ``jax.lax.top_k``'s order: descending, and among equal values the
    lower index first (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt, router_w, cfg):
    """xt: (T,d) -> (gate_vals (T,k) renormalized, gate_idx (T,k), aux)."""
    logits = (xt @ router_w).float()
    gates = torch.softmax(logits, dim=-1)
    gv, gi = top_k(gates, cfg.top_k)
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    me = gates.mean(0)
    ce = F.one_hot(gi, cfg.n_experts).float().sum(1).mean(0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return gv.to(xt.dtype), gi, aux


def _expert_ffn(x, wg, wu, wd, cfg):
    """One expert's FFN on its rows x: (n, d) -> (n, d)."""
    if cfg.mlp_act == "silu":
        h = F.silu(x @ wg) * (x @ wu)
    else:   # the reference's gelu is the tanh approximation
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd


def _dense_moe(p, x, cfg, rt):
    """Exact (no-capacity) top-k MoE on one device -> (y, aux)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    gv, gi, aux = _route(xt, L.cast(p["router"], rt), cfg)
    # one view per expert, by unbind: its backward stacks the experts'
    # gradients once (indexing expert by expert would add a zero-filled
    # gradient of the whole (E, d, ff) weight per expert)
    wg, wu, wd = (L.cast(p[n], rt).unbind(0) for n in ("wg", "wu", "wd"))
    T, k = gi.shape
    pair_e = gi.reshape(-1)                 # pair t*k + j -> its expert
    order = torch.argsort(pair_e, stable=True)
    rows = torch.bincount(pair_e, minlength=cfg.n_experts).tolist()
    xs = xt.index_select(0, order // k)     # each pair's token, by expert
    outs, start = [], 0
    for e, n in enumerate(rows):
        if n:
            outs.append(_expert_ffn(xs[start:start + n], wg[e], wu[e],
                                    wd[e], cfg))
            start += n
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    out = torch.cat(outs).index_select(0, back).view(T, k, d)
    out = out * gv[:, :, None]              # each slot by its gate
    y = out[:, 0]
    for j in range(1, k):
        y = y + out[:, j]
    return y.reshape(B, S, d), aux


def moe_mlp(p, x, cfg, rt: TunableConfig, rules):
    """MoE FFN sub-block.  x: (B,S,d) -> (y, aux_loss)."""
    if rules is not None:
        raise NotImplementedError(
            "the expert-parallel MoE paths (ep_alltoall, ep_gather) are "
            f"not ported yet ({EXPERT_PARALLEL}); pass rules=None")
    return _dense_moe(p, x, cfg, rt)
