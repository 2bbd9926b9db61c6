"""Layer-stack iteration: a Python loop over the stacked layer dim.

The reference chooses between ``lax.scan`` and an unrolled loop; eager
PyTorch has only the loop, so ``unroll`` is accepted and has no effect.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def scan_layers(body, carry, xs, *, unroll: bool = False, length=None):
    """``body(carry, x_i) -> (carry, y_i)`` over the leading dim of every
    tensor in ``xs``; returns the last carry and the stacked ``y``s (or
    None when every ``y_i`` is None).  Slices are views of ``xs``."""
    n = length if length is not None else tree_leaves(xs)[0].shape[0]
    ys = []
    for i in range(n):
        xi = tree_map(lambda a: a[i], xs) if xs is not None else None
        carry, y = body(carry, xi)
        ys.append(y)
    if not ys or all(y is None for y in ys):
        return carry, None
    return carry, _stack(ys)
