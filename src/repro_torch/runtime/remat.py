"""Activation-checkpointing policies — the memoryFraction knob — and the
dtype of the residual stream carried between layers.

``remat_policy`` (``wrap_layer``): 'dots' (balanced: the outputs of the
matrix products are kept for the backward pass, everything else is
recomputed), 'none' (keep everything), 'full' (keep only each layer's
input, recompute the layer).  In PyTorch these are
``torch.utils.checkpoint`` granularities around one layer of the layer
loop.
``remat_save_dtype``: dtype the saved residual stream is kept in between
layers (spark.shuffle.spill.compress analogue) — the layer-loop carry
itself is held in this dtype when remat is active, so the serving
functions' results depend on it when it is narrower than
``compute_dtype``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core.params import TunableConfig

# The ops whose outputs 'dots' keeps.  Every product of the model zoo is
# a torch.einsum or an @: an einsum lowers to aten.bmm (its batch dims
# folded into one) at every shape the models use, an @ of an activation
# and a 2-D weight to aten.mm, and addmm is mm with a bias, so these
# three are every matrix product.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def wrap_layer(fn, rt: TunableConfig):
    """Apply the remat policy to a layer-loop body function: 'none'
    returns it as it is, 'full' checkpoints it whole, 'dots' checkpoints
    it saving the matrix products' outputs."""
    if rt.remat_policy == "none":
        return fn
    if rt.remat_policy == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if rt.remat_policy == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    raise ValueError(f"unknown remat_policy {rt.remat_policy!r}")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a knob value names."""
    return _DTYPES[name]


def carry_dtype(rt: TunableConfig) -> torch.dtype:
    """Dtype of the saved residual stream between layers."""
    comp = torch_dtype(rt.compute_dtype)
    if rt.remat_policy == "none":
        return comp
    save = torch_dtype(rt.remat_save_dtype)
    return save if save.itemsize < comp.itemsize else comp


def to_carry(x, rt: TunableConfig):
    return x.to(carry_dtype(rt))


def from_carry(x, rt: TunableConfig):
    return x.to(torch_dtype(rt.compute_dtype))
