"""Count one step on fake tensors: what one rank computes, moves, sends
and holds (the source of ``core/costmodel``'s roofline).

:func:`count` runs a :class:`~repro_torch.runtime.stepfn.StepBundle`'s
step once under ``FakeTensorMode`` (shapes and dtypes, no data) on the
CPU device type, so no kernel wrapper launches and a step of any size
runs on a host without a card.  On a mesh (a ``DeviceMesh`` of the fake
process group, ``launch/mesh.fake_production_mesh``) every argument is
made directly as rank 0's local block of its spec and wrapped as a
DTensor: nothing is ever built whole.

:class:`StepCounter` is a dispatch mode.  It declines every op on
DTensors (returns ``NotImplemented``), so DTensor runs it and the mode
sees the local ops DTensor runs on the rank's blocks, and the
collectives its redistributes issue: each count is the rank's, as
XLA's per-partition ``cost_analysis`` is in the reference.  DTensor's
sharding propagation runs each op once more on fake tensors at the
global shapes to learn the output's shape; those ops are no rank's work
and are not counted (``compat.sharding_propagation`` marks them).  Counts
run one at a time in a process (the fake group and the mark are the
process's).

A fake step has no data, so nothing that reads values to the host can
run: ``bincount`` (the MoE FFN's rows per expert) is answered with an
even split of its input over its bins, which gives the experts the
FLOPs of any routing (each (token, slot) pair's FFN costs the same
wherever it goes).  The sLSTM's loop over the tokens is counted as its
step run once over all of them (:func:`_slstm_scan_at_once`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import compat
from repro_torch.core.costmodel import CollectiveOp, _DTYPE_NAMES, HW
from repro_torch.models import layers as L
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.loops import tree_map

# op name (without overload) -> the reference's collective kind
_KINDS = {
    # torch.distributed.*: in place, outputs in the first argument
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
    # functional collectives (DTensor): outputs returned
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    """The reference's (HLO's) name of a torch dtype."""
    name = str(dtype).replace("torch.", "")
    return _DTYPE_NAMES.get(name, name)


class StepCounter(TorchDispatchMode):
    """Counts the local ops run under it: ``flops`` (by
    ``torch.utils.flop_counter``'s formulas), ``bytes`` (operands and
    results of every op that is not a view or a query of metadata),
    ``collectives`` (:class:`~repro_torch.core.costmodel.CollectiveOp`,
    output bytes per rank) and ``peak_bytes``, the most bytes of live
    storages at once among the tensors it saw made and the ones
    :meth:`hold` registered.

    A storage is live while a tensor it was seen with is: each such
    tensor carries a weak reference whose callback releases it, so the
    live total is exact at every op (tensors the autograd graph saves
    stay alive with it).  With ``square`` = S, ``square_free_peak`` is
    the same peak with the (S, S) attention squares left out: the
    eager attention's scores and probabilities, each (B, H, S, S), and
    its (S, S) causal mask, which the flash kernel never makes."""

    def __init__(self, square: Optional[int] = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[CollectiveOp] = []
        self._formulas = compat.flop_registry()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._square = None if square is None else (square, square)
        # storage -> [bytes, tensors alive, an attention square]
        self._live: Dict[int, list] = {}
        # by id: two refs compare by their tensors (==), not by identity
        self._refs: Dict[int, weakref.ref] = {}
        self.live_bytes = self.square_bytes = 0
        self.peak_bytes = self.square_free_peak = 0

    def hold(self, tree) -> int:
        """Register the storages of ``tree``'s tensors (a DTensor's local
        block) as live; returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(compat.local_tensor(t) if SH.is_dtensor(t) else t)
        return self.live_bytes - before

    def _is_square(self, t: torch.Tensor) -> bool:
        # (B, H, S, S), or (B*H, S, S) as the einsum's product makes it;
        # the mask (S, S) of booleans
        return (self._square is not None
                and tuple(t.shape[-2:]) == self._square
                and (t.dim() in (3, 4) or t.dtype == torch.bool))

    def _track(self, t: torch.Tensor) -> None:
        key = compat.storage_key(t)
        entry = self._live.get(key)
        if entry is None:
            entry = [t.untyped_storage().nbytes(), 0, self._is_square(t)]
            self._live[key] = entry
            self.live_bytes += entry[0]
            if entry[2]:
                self.square_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self.square_free_peak = max(self.square_free_peak,
                                        self.live_bytes - self.square_bytes)
        entry[1] += 1
        ref = weakref.ref(t, lambda r, k=key: self._release(r, k))
        self._refs[id(ref)] = ref

    def _release(self, ref, key: int) -> None:
        self._refs.pop(id(ref), None)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live_bytes -= entry[0]
            if entry[2]:
                self.square_bytes -= entry[0]

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _KINDS.get(name)
        if kind is None:            # wait_tensor, barrier, ...
            return
        if func.namespace == "c10d":
            moved = _tensors(args[0])
            group = compat.process_group_arg(args)
        else:
            moved = _tensors(out)
            gname = kwargs.get("group_name", args[-1])
            group = compat.resolve_process_group(gname)
        ranks = dist.get_process_group_ranks(group)
        nodes = {r // HW["node_size"] for r in ranks}
        self.collectives.append(CollectiveOp(
            kind, sum(_nbytes(t) for t in moved), len(ranks),
            _dtype_name(moved[0].dtype) if moved else "",
            node_local=len(nodes) == 1))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, self._dtensor) for t in ins):
            return NotImplemented
        if func is torch.ops.aten.bincount.default:
            return _even_bins(*args, **kwargs)
        out = func(*args, **kwargs)
        if compat.propagating():
            return out              # DTensor learning a global shape
        seen = ins + _tensors(out)
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, kwargs, out)
        else:
            formula = self._formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            # a view moves nothing, nor does a query of a tensor's
            # metadata (``prim.device``, ``prim.layout``)
            if not func.is_view and func.namespace != "prim":
                self.bytes += sum(_nbytes(t) for t in seen)
        for t in _tensors(out):
            self._track(t)
        return out


@dataclasses.dataclass
class StepCount:
    flops: float
    bytes: float
    collectives: List[CollectiveOp]
    argument_bytes: int
    peak_bytes: int
    square_free_peak: int       # the peak without the (S, S) squares


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _fake_args(bundle):
    """The bundle's arguments as fake tensors (call under the fake mode).
    On a mesh each is a DTensor on its spec's placements whose local
    tensor is the rank's block, made at the block's shape."""
    from torch.distributed.tensor import DTensor

    def make(sd, spec=None):
        if not isinstance(sd, L.ShapeDtype):
            return sd                       # a host integer (a position)
        if spec is None:
            return torch.empty(sd.shape, dtype=sd.dtype)
        mesh = bundle.rules.mesh
        placements = bundle.rules.placements(spec)
        local = list(sd.shape)
        for k, pl in enumerate(placements):
            if pl.is_shard():
                local[pl.dim] //= mesh.size(k)
        return DTensor.from_local(
            torch.empty(local, dtype=sd.dtype), mesh, placements,
            run_check=False, shape=torch.Size(sd.shape),
            stride=_contiguous_stride(sd.shape))

    if bundle.specs is None:
        return tree_map(make, bundle.args)
    return tuple(SH.map_specs(lambda s, a: make(a, s), spec, arg)
                 for spec, arg in zip(bundle.specs, bundle.args))


_ONE_AT_A_TIME = threading.Lock()
_counting = threading.local()


# blocks of tokens the sLSTM's loop is counted in (_slstm_scan_at_once)
SLSTM_BLOCKS = 64


def _slstm_scan_at_once(zi, zf, zz, zo, ri, rf, rz, ro, *state):
    """The sLSTM's loop over the tokens (``models/xlstm._slstm_scan``) as
    a count sees it: its step run once on each of ``SLSTM_BLOCKS`` blocks
    of the tokens, (B, S / blocks, d) in place of S steps on (B, d).  A
    count of the loop takes some thirty ops on fake tensors a token,
    hours at 32,768 tokens and 48 blocks; this takes thirty a block.
    What the count reads comes to about the same: the step has no
    products (no FLOPs) and no collective (it runs on each rank's
    block), its results and the tensors autograd saves for its backward
    add up to the same bytes, and a block's temporaries are a
    ``SLSTM_BLOCKS``-th of the sequence's; the previous token's state it
    reads is stood in for by the gates, tensors of the same shape that
    are live anyway.  ``tests/test_torch_stepcount.py`` holds the two
    counts together."""
    from repro_torch.models import xlstm
    pf = {"ri": ri, "rf": rf, "rz": rz, "ro": ro}
    size = -(-zi.shape[1] // SLSTM_BLOCKS)
    ys = []
    # split (not tensor_split): its backward concatenates the blocks'
    # gradients once, where a slice's adds a zero-filled whole per block
    for z in zip(*(t.split(size, dim=1) for t in (zi, zf, zz, zo))):
        carry = xlstm._slstm_step(pf, z, *z)
        ys.append(carry[3])
    # the loop stacks its outputs into a new tensor; its last state is
    # its last step's
    return (torch.cat(ys, dim=1),) + tuple(t[:, -1].clone() for t in carry)


@contextlib.contextmanager
def _token_loops_at_once():
    """While inside, this thread's calls of the sLSTM's loop run
    :func:`_slstm_scan_at_once`; every other thread's, the loop."""
    from repro_torch.models import xlstm
    loop = xlstm._slstm_scan

    def scan(*args):
        if getattr(_counting, "on", False):
            return _slstm_scan_at_once(*args)
        return loop(*args)

    xlstm._slstm_scan = scan
    _counting.on = True
    try:
        yield
    finally:
        _counting.on = False
        xlstm._slstm_scan = loop


def _even_bins(x, weights=None, minlength: int = 0):
    """``bincount`` of a fake ``x`` over ``minlength`` bins, split evenly
    (a real tensor: its values are read to the host)."""
    n, bins = x.numel(), max(1, minlength)
    with compat.unfaked():
        return torch.tensor([n // bins + (b < n % bins) for b in range(bins)],
                            dtype=torch.int64)


def count(bundle, square: Optional[int] = None) -> StepCount:
    """Run ``bundle``'s step once on fake arguments and count it;
    ``square``: the sequence length whose (S, S) attention squares
    ``StepCount.square_free_peak`` leaves out."""
    with _ONE_AT_A_TIME, _token_loops_at_once():
        mode = compat.fake_tensor_mode()
        counter = StepCounter(square)
        with mode:
            args = _fake_args(bundle)
        arg_bytes = counter.hold(args)
        with compat.sharding_propagation(), mode, counter:
            out = bundle.fn(*args)
        del out
    return StepCount(flops=float(counter.flops), bytes=float(counter.bytes),
                     collectives=counter.collectives,
                     argument_bytes=arg_bytes,
                     peak_bytes=counter.peak_bytes,
                     square_free_peak=counter.square_free_peak)



def count_cell(cfg, shape, rt, mesh=None):
    """(count, the bundle's notes) of the step of ``cfg`` at ``shape``
    under ``rt`` on ``mesh`` (``runtime/stepfn.build_step``); a
    prefill's count carries the peak without its (S, S) attention
    squares."""
    from repro_torch.runtime.stepfn import build_step
    bundle = build_step(cfg, shape, rt, mesh)
    square = shape.seq_len if shape.kind == "prefill" else None
    return count(bundle, square=square), bundle.notes
