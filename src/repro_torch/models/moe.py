"""Mixture-of-Experts FFN with expert parallelism.

The PyTorch port of the reference's ``models/moe.py``.  Three paths,
chosen per workload shape:

  * ``ep_alltoall`` — training/prefill on a mesh with a model axis:
    tokens seq-sharded over the model axis, capacity-based dispatch,
    ``all_to_all`` to the expert shards and back (the paper's
    "shuffle").  The wire dtype is the ``comm_codec`` knob.
  * ``ep_gather`` — decode (few tokens): replicated dispatch,
    expert-sharded FFN, ``all_gather`` combine.
  * ``dense`` — exact top-k MoE with no capacity drops: the path with
    no rules and on a mesh whose model axis is 1 or does not divide the
    experts (there every rank runs it on its own tokens, and the aux is
    the global batch's).

The expert-parallel paths run under ``local_map`` (the reference's
``shard_map``) on local blocks with explicit collectives on the mesh's
``model`` group; their capacity ``C`` is the reference's, so their
shapes are static.  The collectives are differentiable (an all-to-all's
gradient is the opposite all-to-all, an fsdp all-gather's a
reduce-scatter), so a train step runs through ``ep_alltoall``.  The aux
loss there is the mean of the shards' Switch estimators, as in the
reference.

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

import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L
from repro_torch.runtime.remat import torch_dtype


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


def _route(xt, router_w, cfg, mean=None):
    """xt: (T,d) -> (gate_vals (T,k) renormalized, gate_idx (T,k), aux).
    ``mean`` maps a per-expert mean over these tokens to the mean over
    the global batch (tokens split over ranks); None: these are all."""
    logits = (xt @ router_w).float()
    gates = torch.softmax(logits, dim=-1)
    gv, gi = top_k(gates, cfg.top_k)
    gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    me = gates.mean(0)
    ce = F.one_hot(gi, cfg.n_experts).float().sum(1).mean(0)
    if mean is not None:
        me, ce = mean(me), mean(ce)
    aux = cfg.n_experts * torch.sum(me * ce)
    return gv.to(xt.dtype), gi, aux


def _expert_ffn(x, wg, wu, wd, cfg):
    """One expert's FFN on its rows x: (n, d) -> (n, d)."""
    if cfg.mlp_act == "silu":
        h = F.silu(x @ wg) * (x @ wu)
    else:   # the reference's gelu is the tanh approximation
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd


def _dense_moe(p, x, cfg, rt, mean=None):
    """Exact (no-capacity) top-k MoE on one device -> (y, aux); ``mean``
    as in :func:`_route`."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    gv, gi, aux = _route(xt, L.cast(p["router"], rt), cfg, mean)
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


def _expert_ffn_stacked(tokens, wg, wu, wd, cfg):
    """tokens: (E_local, C, d); weights: (E_local, ...)."""
    if cfg.mlp_act == "silu":
        h = (F.silu(torch.einsum("ecd,edf->ecf", tokens, wg))
             * torch.einsum("ecd,edf->ecf", tokens, wu))
    else:   # the reference's gelu is the tanh approximation
        h = F.gelu(torch.einsum("ecd,edf->ecf", tokens, wu),
                   approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, wd)


def _encode_wire(x, codec: str):
    """comm_codec knob: cast/quantize before putting bytes on the wire."""
    if codec == "int8":
        xf = x.float()
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-6) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127)
        return q.to(torch.int8), scale.float()
    return x.to(torch_dtype(codec)), None


def _decode_wire(x, scale, out_dtype):
    if scale is None:
        return x.to(out_dtype)
    return (x.float() * scale).to(out_dtype)


def _dispatch(xt, gv, gi, E: int, C: int):
    """Capacity-based dispatch.  Returns (buf (E,C,d), keep, slot, flat_e):
    each (token, slot) pair takes the next free row of its expert, in
    pair order; pairs past the capacity are dropped."""
    T, d = xt.shape
    k = gv.shape[1]
    flat_e = gi.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    slot = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = slot < C
    src = torch.repeat_interleave(xt, k, dim=0) * keep[:, None].to(xt.dtype)
    idx = torch.where(keep, flat_e * C + slot, torch.zeros_like(slot))
    buf = torch.zeros((E * C, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_add(0, idx, src)
    return buf.view(E, C, d), keep, slot, flat_e


def _combine(back, gv, keep, slot, flat_e, T: int, k: int, d: int):
    C = back.shape[1]
    idx = torch.where(keep, flat_e * C + slot, torch.zeros_like(slot))
    g = back.reshape(-1, d).index_select(0, idx)
    g = g * keep[:, None].to(g.dtype) * gv.reshape(-1)[:, None]
    return g.reshape(T, k, d).sum(dim=1)


# ------------------------------------------- differentiable collectives
def _a2a_raw(x, group, split: int, concat: int):
    """The reference's tiled ``all_to_all(x, axis, split, concat)``:
    ``x`` cut into n blocks along ``split``, block j sent to rank j, the
    blocks received laid side by side along ``concat`` in rank order."""
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=split))          # (n, ...)
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts.contiguous(), group=group)
    return torch.cat(out.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _a2a_raw(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _a2a_raw(g.contiguous(), group, concat, split), None, None, \
            None


def _all_to_all(x, group, split: int, concat: int):
    if not x.is_floating_point():       # an int8 wire carries no gradient
        return _a2a_raw(x, group, split, concat)
    return _AllToAll.apply(x, group, split, concat)


class _GatherSum(torch.autograd.Function):
    """Tiled all-gather along ``dim`` whose gradient is the
    reduce-scatter (an fsdp weight gathered for use)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        from repro_torch.runtime.gradsync import all_gather_dim
        ctx.args = (group, dim)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime.gradsync import reduce_scatter_dim
        group, dim = ctx.args
        return reduce_scatter_dim(g, dim, group), None, None


class _GatherNoGrad(torch.autograd.Function):
    """ep_gather's combine all-gather: a serving path, not differentiated
    (its input's gradient would be split between the experts' ranks and
    the routing that every rank repeats)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        from repro_torch.runtime.gradsync import all_gather_dim
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the gradient of the ep_gather MoE path is not ported "
            "(ROADMAP.md queue A, slice 7b); train with a sequence the "
            "model axis divides (ep_alltoall)")


def _gather_combine(x, group):
    if x.requires_grad:
        return _GatherNoGrad.apply(x, group, 0)
    from repro_torch.runtime.gradsync import all_gather_dim
    return all_gather_dim(x, 0, group)


class _MeanOver(torch.autograd.Function):
    """The mean over ``n`` ranks of a per-rank value whose result every
    rank holds (the reference's ``pmean``): its gradient is 1/n of the
    (replicated) incoming one."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


# ---------------------------------------------------------------- paths
def _ep_paths_applicable(cfg, rules, S):
    if rules is None:
        return None
    ep = rules.model_axis_size()
    if ep <= 1 or cfg.n_experts % ep != 0:
        return None
    if S > 1 and S % ep == 0:
        return "ep_alltoall"
    return "ep_gather"


def moe_mlp(p, x, cfg, rt: TunableConfig, rules):
    """MoE FFN sub-block.  x: (B,S,d) -> (y, aux_loss)."""
    path = _ep_paths_applicable(cfg, rules, x.shape[1])
    if path is None:
        if rules is None or not L.is_dtensor(x):
            return _dense_moe(p, x, cfg, rt)
        return _dense_on_mesh(p, x, cfg, rt, rules)
    return _ep_moe(p, x, cfg, rt, rules, path)


def _grad_placements(rules, spec):
    """A gradient's placements under ``local_map``: split where the
    input is split, partial (a sum over the ranks' tokens) elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if not pl.is_shard() else pl
                 for pl in rules.placements(spec))


def _dense_on_mesh(p, x, cfg, rt, rules):
    """The dense path on a mesh: each rank runs it on its own tokens (x's
    placements in and out, the weights gathered whole), and the aux is
    the global batch's, as the reference's dense path under SPMD gives
    it: the per-expert router statistics are averaged over the ranks
    that hold other tokens before the product."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = rules.mesh
    split = [i for i, pl in enumerate(x.placements) if pl.is_shard()]
    groups = [mesh.get_group(i) for i in split]
    n = math.prod(mesh.size(i) for i in split)
    mean = (lambda v: _MeanOver.apply(v, groups, n)) if split else None
    rep = (Replicate(),) * mesh.ndim
    # a weight's gradient sums the ranks' tokens where they differ
    w_grad = tuple(Partial() if pl.is_shard() else Replicate()
                   for pl in x.placements)
    names = ("router", "wg", "wu", "wd")

    def body(xl, *wl):
        return _dense_moe(dict(zip(names, wl)), xl, cfg, rt, mean)

    return local_map(body, out_placements=(x.placements, rep),
                     in_placements=(x.placements,) + (rep,) * 4,
                     in_grad_placements=(x.placements,) + (w_grad,) * 4,
                     device_mesh=mesh, redistribute_inputs=True)(
                         x, *(p[n] for n in names))


def _ep_moe(p, x, cfg, rt, rules, path: str):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = rules.mesh
    names = list(mesh.mesh_dim_names)
    ep = rules.model_axis_size()
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    B, S, _ = x.shape
    batch_axes = rules.batch_axes
    dp = rules.data_axis_size()
    fsdp_in_mesh = tuple(a for a in rules.fsdp_axes if a in names) \
        if rules.fsdp else ()
    comp = L.dt(rt)
    model_group = mesh.get_group("model")
    all_groups = [mesh.get_group(a) for a in names if mesh.size(
        names.index(a)) > 1]

    def gather_w(w, dim):
        """FSDP all-gather of an expert weight's embed dim."""
        for a in reversed(sorted(fsdp_in_mesh, key=names.index)):
            w = _GatherSum.apply(w, mesh.get_group(a), dim)
        return w

    def experts(toks, wg, wu, wd):
        return _expert_ffn_stacked(toks, gather_w(wg, 1).to(comp),
                                   gather_w(wu, 1).to(comp),
                                   gather_w(wd, 2).to(comp), cfg)

    def aux_mean(aux):
        return _MeanOver.apply(aux, all_groups, mesh.size())

    if path == "ep_alltoall":
        T = (B // dp) * (S // ep)
        C = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))

        def body(xs, rw, wg, wu, wd):
            Bl, Sl, _ = xs.shape
            xt = xs.reshape(T, d)
            gv, gi, aux = _route(xt, rw, cfg)
            buf, keep, slot, fe = _dispatch(xt, gv, gi, E, C)
            wire, scale = _encode_wire(buf, rt.comm_codec)
            recv = _all_to_all(wire, model_group, 0, 1)
            rscale = (_all_to_all(scale, model_group, 0, 1)
                      if scale is not None else None)
            out = experts(_decode_wire(recv, rscale, comp), wg, wu, wd)
            wire2, scale2 = _encode_wire(out, rt.comm_codec)
            back = _all_to_all(wire2, model_group, 1, 0)
            bscale = (_all_to_all(scale2, model_group, 1, 0)
                      if scale2 is not None else None)
            back = _decode_wire(back, bscale, comp)
            y = _combine(back, gv, keep, slot, fe, T, k, d)
            return y.reshape(Bl, Sl, d), aux_mean(aux)

        xspec = (batch_axes or None, "model", None)
        fn = body
    else:
        # ep_gather: decode-time few-token path
        T = max(1, B // dp) * S
        C = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))

        def body_g(xs, rw, wg, wu, wd):
            Bl = xs.shape[0]
            xt = xs.reshape(T, d)
            gv, gi, aux = _route(xt, rw, cfg)
            buf, keep, slot, fe = _dispatch(xt, gv, gi, E, C)
            e_local = E // ep
            ridx = mesh.get_local_rank("model")
            mine = buf[ridx * e_local:(ridx + 1) * e_local]
            out = experts(mine, wg, wu, wd)
            wire, scale = _encode_wire(out, rt.comm_codec)
            full = _gather_combine(wire, model_group)
            fscale = (_gather_combine(scale, model_group)
                      if scale is not None else None)
            back = _decode_wire(full, fscale, comp)
            y = _combine(back, gv, keep, slot, fe, T, k, d)
            return y.reshape(Bl, S, d), aux_mean(aux)

        xspec = (batch_axes or None, None, None)
        fn = body_g

    w_in = ("model", fsdp_in_mesh or None, None)
    wd_in = ("model", None, fsdp_in_mesh or None)
    specs = (xspec, (None, None), w_in, w_in, wd_in)
    rep = (Replicate(),) * mesh.ndim
    y, aux = local_map(
        fn, out_placements=(rules.placements(xspec), rep),
        in_placements=tuple(rules.placements(s) for s in specs),
        in_grad_placements=(rules.placements(xspec),)
        + tuple(_grad_placements(rules, s) for s in specs[1:]),
        device_mesh=mesh, redistribute_inputs=True)(
            x, L.cast(p["router"], rt), p["wg"], p["wu"], p["wd"])
    return y, aux
