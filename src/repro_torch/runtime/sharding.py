"""Sharding rules: logical axis names -> mesh axes, per shard strategy.

The PyTorch port of the reference's ``runtime/sharding.py``.  The four
strategies map to the paper's shuffle managers: ``dp`` (replicate
params, all-reduce grads), ``fsdp`` (shard params over the data axis,
all-gather on use), ``tp`` (Megatron column/row parallel over the model
axis), ``fsdp_tp`` (2D).

Every mapping is divisibility-guarded: a logical dim that does not
divide the mesh axis product falls back (recorded in ``notes``, in the
reference's words) instead of failing.  Attention's fallback is itself
a tunable (``attn_tp_fallback``).

A spec is a plain tuple with one entry per tensor dim: an axis name, a
tuple of axis names (major to minor) or None, as the reference's
``PartitionSpec`` holds them, so the two compare as tuples.  The spec
functions read only the mesh's axis sizes: ``mesh`` may be a
``DeviceMesh``, a ``launch.mesh.AbstractMesh`` or any object whose
``shape`` maps axis names to sizes.  Only ``placements``, ``constrain``,
``sharding`` and ``shard_tree`` need a real ``DeviceMesh``: they turn a
spec into DTensor placements (``Shard(dim)`` on every mesh dim the
tensor dim is split over, ``Replicate()`` on the others) and move
tensors onto them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.runtime.loops import tree_map

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]

# logical dim names used by the model zoo when annotating parameters
PARAM_LOGICAL = ("layers", "vocab", "embed", "heads", "kv_heads", "mlp",
                 "expert", "ssm_heads", "ssm_inner", "state", None)


def spec_axes(ax: AxisName) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def is_logical(x) -> bool:
    """A tuple of logical names (a leaf of a logical tree)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _canonical(ax: AxisName) -> AxisName:
    """One spec entry as ``PartitionSpec`` keeps it: a single axis as
    its name, no axis as None."""
    axes = spec_axes(ax)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axes_size(sizes: Dict[str, int], axes: AxisName) -> int:
    n = 1
    for a in spec_axes(axes):
        n *= sizes[a]
    return n


@dataclasses.dataclass
class ShardingRules:
    mesh: object
    strategy: str                       # dp | fsdp | tp | fsdp_tp
    fsdp_axes: Tuple[str, ...] = ("data",)
    attn_tp_fallback: str = "replicate"  # replicate | batch_shard
    notes: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.strategy not in ("dp", "fsdp", "tp", "fsdp_tp"):
            raise ValueError(f"unknown strategy {self.strategy}")
        self.sizes = axis_sizes(self.mesh)
        # fsdp axes that exist in this mesh (single-pod mesh has no 'pod')
        self.fsdp_axes = tuple(a for a in self.fsdp_axes if a in self.sizes)
        self._batch_axes = tuple(a for a in ("pod", "data")
                                 if a in self.sizes)

    # -------------------------------------------------- helpers
    def _fit(self, dim: Optional[int], axes: AxisName, what: str) -> AxisName:
        """Return ``axes`` if ``dim`` divides their product, else None."""
        if axes is None:
            return None
        n = _axes_size(self.sizes, axes)
        if dim is not None and dim % n != 0:
            self.notes.append(
                f"{what}: dim {dim} not divisible by {axes} "
                f"({n}); left unsharded")
            return None
        return axes

    @property
    def tp(self) -> bool:
        return self.strategy in ("tp", "fsdp_tp")

    @property
    def fsdp(self) -> bool:
        return self.strategy in ("fsdp", "fsdp_tp")

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self._batch_axes

    def data_axis_size(self) -> int:
        return _axes_size(self.sizes, self._batch_axes)

    def model_axis_size(self) -> int:
        return self.sizes.get("model", 1)

    # -------------------------------------------------- parameters
    def param_spec(self, logical: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Spec:
        """Spec of a parameter annotated with logical dim names."""
        assert len(logical) == len(shape), (logical, shape)
        out: List[AxisName] = [None] * len(shape)
        # the model axis goes to at most ONE dim per param; priority:
        # experts (EP) > heads (attention TP) > column/row dims
        priority = ("expert", "heads", "kv_heads", "mlp", "vocab",
                    "ssm_heads", "ssm_inner")
        if self.tp:
            for want in priority:
                placed = False
                for i, (name, dim) in enumerate(zip(logical, shape)):
                    if name == want and out[i] is None:
                        got = self._fit(dim, "model", f"param.{name}")
                        if got is not None:
                            out[i] = got
                            placed = True
                            break
                if placed:
                    break
        model_placed = any("model" in spec_axes(ax) for ax in out)
        if self.fsdp:
            for i, (name, dim) in enumerate(zip(logical, shape)):
                if name == "embed" and out[i] is None:
                    out[i] = self._fit(dim, self.fsdp_axes, "param.embed")
        # TP couldn't shard ANY dim of an attention weight: fold the
        # model axis into the embed dim (fully-sharded, all-gather on use)
        if (self.tp and not model_placed
                and any(n in ("heads", "kv_heads") for n in logical)):
            for i, (name, dim) in enumerate(zip(logical, shape)):
                if name == "embed":
                    cand = spec_axes(out[i]) + ("model",)
                    out[i] = self._fit(dim, cand, "param.embed+model")
        return tuple(_canonical(a) for a in out)

    # -------------------------------------------------- activations
    def act_spec(self, logical: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """Spec of an activation (batch/seq/heads/embed dims)."""
        out: List[AxisName] = [None] * len(shape)
        for i, (name, dim) in enumerate(zip(logical, shape)):
            if name == "batch":
                out[i] = self._fit(dim, self._batch_axes, "act.batch")
            elif name == "heads" and self.tp:
                out[i] = self._fit(dim, "model", "act.heads")
            elif name == "kv_heads" and self.tp:
                out[i] = self._fit(dim, "model", "act.kv_heads")
            elif name in ("mlp", "vocab", "expert", "ssm_heads",
                          "ssm_inner") and self.tp:
                out[i] = self._fit(dim, "model", f"act.{name}")
            elif name == "seq_model" and self.tp:   # explicit seq-sharding
                out[i] = self._fit(dim, "model", "act.seq")
            elif name == "seq_data":
                out[i] = self._fit(dim, self._batch_axes, "act.seq")
        return tuple(_canonical(a) for a in out)

    # attention fallback: batch-shard the attention op over the model axis
    def attn_batch_spec(self, batch: int) -> Optional[Spec]:
        if self.attn_tp_fallback != "batch_shard" or not self.tp:
            return None
        axes = self._batch_axes + ("model",)
        if batch % _axes_size(self.sizes, axes) == 0:
            return (_canonical(axes),)
        self.notes.append(f"attn batch_shard: batch {batch} does not divide "
                          f"{axes}; using replicate fallback")
        return None

    # -------------------------------------------------- DTensor placements
    def placements(self, spec: Spec):
        """DTensor placements of ``spec`` on this (real) mesh."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, ax in enumerate(spec):
            for a in spec_axes(ax):
                out[names.index(a)] = Shard(dim)
        return tuple(out)

    def sharding(self, spec: Spec):
        """(mesh, placements) of ``spec``: the counterpart of the
        reference's ``NamedSharding``."""
        return self.mesh, self.placements(spec)

    def constrain(self, x, *logical: Optional[str]):
        """Redistribute a DTensor onto the placements of its logical names
        (the reference's ``with_sharding_constraint``); a plain tensor is
        returned as it is."""
        if not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, self.placements(
            self.act_spec(logical, x.shape)))

    def param_sharding_tree(self, logical_tree, shape_tree):
        """Map parallel trees of logical names and shapes to specs."""
        return _map_logical(lambda lg, sd: self.param_spec(lg, sd.shape),
                            logical_tree, shape_tree)


def _map_logical(fn, logical_tree, other):
    if is_logical(logical_tree):
        return fn(logical_tree, other)
    if isinstance(logical_tree, dict):
        return {k: _map_logical(fn, v, other[k])
                for k, v in logical_tree.items()}
    return fn(logical_tree, other)


def map_specs(fn, spec_tree, *others):
    """``fn(spec, *leaves)`` over a tree of specs and trees of the same
    structure (a spec, a tuple, is a leaf)."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(o[k] for o in others))
                for k, v in spec_tree.items()}
    return fn(spec_tree, *others)


# ------------------------------------------------------------------ DTensor
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under DTensor
    ``placements`` (no communication: every rank holds ``t``).  A dim
    split over several mesh dims is split in mesh order, as DTensor
    splits it."""
    coord = mesh.get_coordinate()
    for k, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(k)
            step = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[k] * step, step)
    return t.contiguous()


def from_full(t: torch.Tensor, mesh, placements):
    """The DTensor on ``placements`` whose full value is ``t`` (which
    every rank holds)."""
    from torch.distributed.tensor import DTensor
    placements = tuple(placements)
    loc = local_block(t, mesh, placements)
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def wrap_local(local: torch.Tensor, like):
    """``local`` as this rank's block of a DTensor laid out as ``like``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def to_dtensor(t, rules: ShardingRules, spec: Spec):
    """``t`` on ``spec``'s placements: a DTensor is redistributed, a full
    tensor that every rank holds is cut to this rank's block."""
    from torch.distributed.tensor import DTensor
    if not torch.is_tensor(t):
        return t
    placements = rules.placements(spec)
    if isinstance(t, DTensor):
        if tuple(t.placements) == placements:
            return t
        return t.redistribute(rules.mesh, placements)
    return from_full(t, rules.mesh, placements)


def shard_tree(tree, spec_tree, rules: ShardingRules):
    """Every tensor of ``tree`` on the placements of its spec."""
    return map_specs(lambda s, t: to_dtensor(t, rules, s), spec_tree, tree)


def full_tree(tree):
    """Every DTensor of ``tree`` gathered to a full tensor on every rank."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def local_tree(tree):
    """Every DTensor of ``tree`` as this rank's local block."""
    return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)
