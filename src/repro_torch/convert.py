"""Carry the reference package's parameters into this package.

``from_jax_params`` takes the reference's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, model.init(key))``) and returns this
package's parameter tree.  Both packages keep the same layout — stacked
``blocks`` with a leading layer dim, ``wq (d,H,hd)``, ``wk/wv
(d,Hkv,hd)``, ``wo (H,hd,d)``, ``embedding (Vpad,d)``, optional
``unembed (d,Vpad)`` — so the conversion is a copy, leaf by leaf.  It
takes numpy only and imports nothing of JAX; the parity tests use it so
that both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree):
    """Nested dict of numpy arrays -> nested dict of CPU tensors of the
    same dtypes (move them with ``.to(device)`` where needed)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: no torch counterpart
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    # np.array keeps a 0-d leaf 0-d (np.ascontiguousarray makes it 1-d)
    return torch.from_numpy(np.array(arr, order="C", copy=True))
