"""Version compatibility shims for the installed PyTorch.

The port's counterpart of the reference's ``compat.py``, which smooths
over JAX releases (``axis_types_kw``, ``shard_map``); this module is not
a JAX shim and carries neither: the port runs on torch alone.  It
resolves the names the port uses that move between torch releases or
live under private modules (the port runs on torch 2.11 on the card and
2.13 on the CPU hosts), so a move breaks this file and not its callers:

  * ``local_map`` — ``torch.distributed.tensor.experimental`` (the
    ``_tensor`` spelling of older releases as a fallback);
  * ``FakeStore`` — the store of the ``"fake"`` process-group backend,
    which lives under ``torch.testing._internal``;
  * ``FakeTensorMode`` and ``unfaked`` (``torch._subclasses.fake_tensor``),
    ``flop_registry`` (``torch.utils.flop_counter``: the FLOP formula of
    each op), ``storage_key`` and ``local_tensor`` (a DTensor's block),
    which the cost model's step counter reads;
  * ``resolve_process_group`` and ``process_group_arg`` — the
    ``ProcessGroup`` of a functional collective's group name, and of a
    ``torch.distributed`` op's boxed argument;
  * ``sharding_propagation`` — marks DTensor's sharding propagation,
    whose ops (run at global shapes, to learn an op's output) are no
    rank's work; ``clear_sharding_cache`` drops its cached decisions
    and ``outside_modes`` sets every dispatch mode aside.

Every import happens when a function is called, never when this module
is imported.
"""
from __future__ import annotations

import contextlib
import threading


def local_map(*args, **kwargs):
    """``torch.distributed.tensor.experimental.local_map``."""
    try:
        from torch.distributed.tensor.experimental import local_map as lm
    except ImportError:                         # older releases
        from torch.distributed._tensor.experimental import local_map as lm
    return lm(*args, **kwargs)


def fake_store():
    """A store for ``init_process_group("fake", ...)``: the backend that
    runs every collective as a no-op, so one process can stand for any
    rank of a group of any size."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def fake_tensor_mode():
    """A new ``FakeTensorMode`` that takes real tensors met on the way
    (module constants) as they are."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def flop_registry():
    """``{op packet: formula}`` of ``torch.utils.flop_counter``; a formula
    takes the op's arguments and ``out_val`` and returns its FLOPs."""
    from torch.utils.flop_counter import flop_registry as reg
    return reg


def unfaked():
    """A context in which the active fake mode is set aside: tensors made
    inside are real."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


def outside_modes():
    """A context in which every active dispatch mode (a fake mode, a
    counting mode) is set aside: a process group made inside is made as
    outside any step."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


def clear_sharding_cache():
    """Drop DTensor's cached sharding propagation (this thread's, and the
    native dispatch cache where the release has one): its entries carry
    the meshes of the op schemas they were made for."""
    import torch
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for cached in (prop.propagate_op_sharding,
                   getattr(prop, "_propagate_tensor_meta_cached", None)):
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


def storage_key(t) -> int:
    """An integer that identifies ``t``'s storage while it lives."""
    return t.untyped_storage()._cdata


def local_tensor(t):
    """A DTensor's local block, the tensor object the DTensor holds (not
    a view of it, as ``to_local`` returns where autograd records)."""
    return t._local_tensor


def resolve_process_group(name: str):
    """The ``ProcessGroup`` registered under a functional collective's
    group name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def process_group_arg(args):
    """The ``ProcessGroup`` among a ``torch.distributed`` op's arguments,
    which the dispatcher passes boxed as a ``torch.ScriptObject``."""
    import torch
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("no process group among the op's arguments")


_propagating = threading.local()


def propagating() -> bool:
    """True while DTensor propagates an op's sharding on this thread,
    inside :func:`sharding_propagation`."""
    return getattr(_propagating, "depth", 0) > 0


def _marked(fn, unfake: bool):
    def wrapped(*args, **kwargs):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        _propagating.depth = getattr(_propagating, "depth", 0) + 1
        try:
            if not unfake:
                return fn(*args, **kwargs)
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _propagating.depth -= 1
    return wrapped


def _patch(owner, name: str, unfake: bool, undo: list) -> None:
    """Mark ``owner.name`` (a method, static method or attribute) for its
    call's duration; ``undo`` gets what puts it back."""
    import inspect
    static = inspect.getattr_static(owner, name)
    fn = static.__func__ if isinstance(static, staticmethod) else \
        getattr(owner, name)
    in_dict = name in vars(owner)
    new = _marked(fn, unfake)
    setattr(owner, name,
            staticmethod(new) if isinstance(static, staticmethod) else new)
    undo.append(lambda: setattr(owner, name, static) if in_dict
                else delattr(owner, name))


@contextlib.contextmanager
def sharding_propagation():
    """While inside, :func:`propagating` says whether DTensor is working
    out a placement rather than doing a rank's work: choosing an op's
    output placements, running the op once at its global shapes to
    learn its output's shape (on fake tensors: nothing else tells those
    ops apart from the rank's own), or reckoning a strided shard's
    offsets.  The active fake mode is set aside while placements are
    chosen and offsets reckoned, so that index arithmetic, read to the
    host, runs on real tensors; the shape run makes a fake mode of its
    own."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    # the cached entry point is an attribute of the one propagator, bound
    # when it was made; the others are methods of their classes
    prop = DTensor._op_dispatcher.sharding_propagator
    undo: list = []
    _patch(ShardingPropagator, "_propagate_tensor_meta_non_cached", False,
           undo)
    _patch(prop, "propagate_op_sharding", True, undo)
    _patch(prop, "propagate_op_sharding_non_cached", True, undo)
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and hasattr(strided,
                                       "local_shard_size_and_offset"):
        _patch(strided, "local_shard_size_and_offset", True, undo)
    try:
        yield
    finally:
        for fn in reversed(undo):
            fn()
