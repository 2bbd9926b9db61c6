"""Dtype of the residual stream carried between layers.

``remat_save_dtype``: dtype the saved residual stream is kept in between
layers (spark.shuffle.spill.compress analogue) — the layer-loop carry
itself is held in this dtype when remat is active, so the serving
functions' results depend on it when it is narrower than
``compute_dtype``.

``wrap_layer`` (the ``remat_policy`` recompute policies) belongs to the
training slice and is not in this module yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

import torch

from repro_torch.core.params import TunableConfig

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
