"""Random weights for a configuration, made on the device from the seed.

Names and shapes come from the model's ``param_shapes()``; the values
are drawn here, by the rule the configuration's ``init`` gives each
leaf (keyed by its last two names, ``"attn.wo"``, else by its last,
``"wo"``, else ``"default"``), in a few large calls: one standard-normal
draw for every leaf of one dtype, viewed leaf by leaf and scaled in
place.  Rules:

* ``"fan_in"`` (the default): normal, std 1 / sqrt(the second-to-last
  dim, or the last of a vector): a matrix that contracts its rows;
* ``{"fan_in": [dims]}``: normal, std 1 / sqrt(the product of those
  dims): a head-shaped weight, (d, H, hd) contracting d is ``[-3]``, and
  (H, hd, d) contracting H and hd is ``[-3, -2]``;
* a number: normal with that std;
* ``"ones"``: a norm scale, made in float32.

Every other leaf is made in ``dtype``, the type it is served in.  The
same configuration, seed and device give the same bits.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from portbench.traffic import sub_seed


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(shapes, init: Dict[str, Any], seed: int, device, dtype) -> Dict:
    """The weight tree for ``shapes`` (a tree of objects with ``.shape``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights", 64) & (2 ** 63 - 1))
    leaves = _leaves(shapes)
    out: Dict = {}
    for path, _ in leaves:          # the shapes' key order, kept
        _put(out, path, None)
    normal: Dict[torch.dtype, List] = {}
    for path, s in leaves:
        name = path[-1]
        rule = init.get(".".join(path[-2:]),
                        init.get(name, init.get("default", "fan_in")))
        shape = tuple(s.shape)
        if rule == "ones":
            _put(out, path, torch.ones(shape, dtype=torch.float32,
                                       device=device))
        elif isinstance(rule, dict):
            std = 1.0 / math.sqrt(math.prod(shape[i] for i in rule["fan_in"]))
            normal.setdefault(dtype, []).append((path, shape, std))
        else:
            if rule == "fan_in":
                fan = shape[-2] if len(shape) >= 2 else shape[-1]
                std = 1.0 / math.sqrt(max(1, fan))
            else:
                std = float(rule)
            normal.setdefault(dtype, []).append((path, shape, std))
    for dt, items in normal.items():
        total = sum(math.prod(shape) for _, shape, _ in items)
        flat = torch.empty(total, dtype=dt, device=device)
        flat.normal_(generator=gen)
        off = 0
        for path, shape, std in items:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            leaf.mul_(std)
            _put(out, path, leaf)
            off += n
    return out
