"""Explicit-collective gradient synchronization (the full-manual path).

The PyTorch port of the reference's ``runtime/gradsync.py``.  This path
makes the paper's shuffle knobs real on the wire:

  * ``grad_comm_dtype`` (spark.shuffle.compress) — the wire dtype of the
    gradient all-reduce / reduce-scatter;
  * ``fuse_grad_collectives`` (spark.shuffle.consolidateFiles) — one
    flat bucket for all the plain all-reduces.

It supports ``dp`` (replicated params, all-reduce grads) and ``fsdp``
(hand-rolled ZeRO-3: all-gather params on entry, reduce-scatter grads),
for families without an inner expert-parallel region (not moe).  The
functions run on local tensors (this rank's blocks); an axis name means
the process group of that mesh dimension (``mesh.get_group(axis)``).

Where a dim is split over several mesh axes, its blocks are in mesh
order (the major axis first), as DTensor lays them out: a reduce-scatter
goes major axis first and an all-gather undoes it minor axis first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.params import TunableConfig
from repro_torch.runtime.loops import tree_leaves, tree_unflatten
from repro_torch.runtime.remat import torch_dtype
from repro_torch.runtime.sharding import spec_axes


def explicit_applicable(family: str, rt: TunableConfig) -> bool:
    return rt.shard_strategy in ("dp", "fsdp") and family != "moe"


def _fsdp_dim(spec) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dim index, mesh axes) of the fsdp-sharded dim of a param spec."""
    for i, ax in enumerate(spec):
        axes = spec_axes(ax)
        if axes:
            return i, axes
    return None


def _mesh_order(mesh, axes) -> List[str]:
    names = list(mesh.mesh_dim_names)
    return sorted(axes, key=names.index)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Blocks of every rank of ``group`` concatenated along ``dim`` (the
    reference's ``all_gather(tiled=True)``)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group``, this rank's block of it along ``dim`` (the
    reference's ``psum_scatter(tiled=True)``)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over the mesh axes ``axes`` (one all-reduce per axis)."""
    x = x.contiguous()
    for ax in axes:
        dist.all_reduce(x, group=mesh.get_group(ax))
    return x


def gather_params(params, specs, mesh):
    """All-gather fsdp-sharded local params to full."""
    flat = tree_leaves(params)
    spec_flat = _spec_leaves(specs)
    out = []
    for p, spec in zip(flat, spec_flat):
        hit = _fsdp_dim(spec)
        if hit is not None:
            i, axes = hit
            for ax in reversed(_mesh_order(mesh, axes)):
                p = all_gather_dim(p, i, mesh.get_group(ax))
        out.append(p)
    return tree_unflatten(params, out)


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    return [specs]


def quantize_ef(g, state):
    """int8 error-feedback compression for gradient all-reduce.

    Adds the residual from the previous step before quantizing and keeps
    the new residual (EF-SGD): unbiased in the long run even at 8 bits.
    Returns (int8 payload, f32 scale, new residual)."""
    g = g.float() + (state if state is not None else 0.0)
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    residual = g - q.float() * scale
    return q, scale, residual


def dequantize_ef(q, scale):
    return q.float() * scale


def int8_allreduce_ef(flat, resid, group, n: int):
    """2-phase int8 all-reduce with error feedback over one mesh axis.

    Phase 1: quantize (EF), all-to-all the int8 chunks, all-gather the
    scales, dequantize + sum in f32.  Phase 2: requantize the reduced
    chunk, all-gather the int8 result and its scales.  Wire bytes ~= 2 x
    N x 1B vs the f32 ring's 2 x N x 4B.  The second-stage quantization
    error is not fed back (first-stage EF dominates).  flat: (N,) f32;
    resid: (N,) f32.  Returns (sum, resid)."""
    N = flat.shape[0]
    pad = (-N) % n
    fp = torch.nn.functional.pad(flat, (0, pad))
    rp = torch.nn.functional.pad(resid, (0, pad))
    q, scale, new_resid = quantize_ef(fp, rp)
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)       # (n, m) flattened
    recv = recv.reshape(n, -1)
    scales = torch.empty(n, dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    partial = torch.sum(recv.float() * scales[:, None], dim=0)
    amax = torch.clamp(torch.max(torch.abs(partial)), min=1e-12)
    s2 = amax / 127.0
    q2 = torch.clamp(torch.round(partial / s2), -127, 127).to(torch.int8)
    all_q = torch.empty(n * q2.numel(), dtype=torch.int8, device=q2.device)
    dist.all_gather_into_tensor(all_q, q2, group=group)
    all_q = all_q.reshape(n, -1)
    all_s = torch.empty(n, dtype=torch.float32, device=q2.device)
    dist.all_gather_into_tensor(all_s, s2.reshape(1), group=group)
    out = (all_q.float() * all_s[:, None]).reshape(-1)
    return out[:N], new_resid[:N]


def reduce_grads(grads, specs, rt: TunableConfig, data_axes: Tuple[str, ...],
                 scale: float, mesh):
    """Reduce local grads across the data axes with the comm-dtype knob.

    fsdp params: reduce-scatter back to the shard, all-reduce over the
    rest; others: all-reduce.  ``fuse_grad_collectives``: one flat bucket
    for all the plain all-reduces."""
    comm = torch_dtype(rt.grad_comm_dtype)
    flat = tree_leaves(grads)
    sdims = [_fsdp_dim(s) for s in _spec_leaves(specs)]

    out: List[Any] = [None] * len(flat)
    # fsdp leaves: reduce-scatter back to the shard, all-reduce the rest
    for i, (g, sd) in enumerate(zip(flat, sdims)):
        if sd is None:
            continue
        dim, axes = sd
        g = g.to(comm)
        for ax in _mesh_order(mesh, axes):
            g = reduce_scatter_dim(g, dim, mesh.get_group(ax))
        rest = tuple(a for a in data_axes if a not in axes)
        if rest:
            g = psum(g, mesh, rest)
        out[i] = g.float() * scale

    plain = [(i, g) for i, (g, sd) in enumerate(zip(flat, sdims))
             if sd is None]
    if plain:
        if rt.fuse_grad_collectives:
            buf = psum(torch.cat([g.to(comm).reshape(-1) for _, g in plain]),
                       mesh, data_axes)
            off = 0
            for i, g in plain:
                n = g.numel()
                out[i] = buf[off:off + n].reshape(g.shape).float() * scale
                off += n
        else:
            for i, g in plain:
                out[i] = psum(g.to(comm), mesh, data_axes).float() * scale
    return tree_unflatten(grads, out)


def reduce_grads_int8_ef(grads, rt: TunableConfig,
                         data_axes: Tuple[str, ...],
                         axis_sizes: Dict[str, int], ef_state, scale: float,
                         mesh):
    """Bucketed int8-EF gradient reduction (dp strategy: every leaf is
    replicated).  ef_state: (1, N_total) this rank's residual.  Returns
    (grad tree, new ef_state)."""
    flat = tree_leaves(grads)
    buf = torch.cat([g.float().reshape(-1) for g in flat])
    resid = ef_state.reshape(-1)
    for ax in data_axes:
        buf, resid = int8_allreduce_ef(buf, resid, mesh.get_group(ax),
                                       axis_sizes[ax])
    outs, off = [], 0
    for g in flat:
        n = g.numel()
        outs.append(buf[off:off + n].reshape(g.shape) * scale)
        off += n
    return tree_unflatten(grads, outs), resid.reshape(ef_state.shape)
