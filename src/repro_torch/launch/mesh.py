"""Device meshes over ``torch.distributed`` ranks.

The PyTorch port of the reference's ``launch/mesh.py``.  Every function
here is called, never run at import: importing this module starts no
process group and touches no device.  A mesh is a ``DeviceMesh`` whose
``mesh_dim_names`` are the reference's axis names; the single-pod
production mesh is (data=16, model=16) = 256 ranks, the multi-pod one
adds a leading ``pod`` axis.

``init_distributed`` starts the process group a mesh needs: gloo on the
CPU, NCCL on the card, through a ``FileStore`` (tests, the smoke: no
port is bound, so several jobs run side by side on one host) or through
the environment that ``torchrun`` sets (``env://``).

``AbstractMesh`` is a mesh that no process holds: axis names and sizes
only.  ``runtime.sharding.ShardingRules`` computes its specs from it,
so a 16x16 mesh's rules can be asked on one process.  To build and run
a step for such a mesh (the dry run, the analytic evaluator),
``fake_mesh`` starts the ``"fake"`` process-group backend at rank 0 of
a world of the mesh's size, whose collectives do nothing, and returns a
``DeviceMesh`` on the CPU device type over it; the step then runs on
fake tensors (``core/stepcount``).  ``fake_production_mesh`` is the
production mesh built that way.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


class AbstractMesh:
    """Axis names and sizes of a mesh, with no ranks behind them.
    ``shape`` is the ``{axis: size}`` mapping the reference's
    ``Mesh.shape`` is."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)
        self.size = math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, an ``AbstractMesh`` or a
    mapping of axis sizes; of no mesh (one device), ``{}``."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = getattr(mesh, "shape", mesh)
    return {k: int(v) for k, v in dict(shape).items()}


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(device_type: str = "cpu", *, store_path=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Start this process's group (once): gloo for the CPU, NCCL for the
    card.  With ``store_path`` the ranks meet through a ``FileStore`` at
    that path (``rank`` and ``world_size`` given); without it, through
    the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  On the card each rank takes the
    device ``LOCAL_RANK`` (or its rank) names."""
    if dist.is_initialized():
        return
    backend = backend_for(device_type)
    if store_path is not None:
        if rank is None or world_size is None:
            raise ValueError("a FileStore needs rank and world_size")
        store = dist.FileStore(str(store_path), int(world_size))
        kw = dict(store=store, rank=int(rank), world_size=int(world_size))
    else:
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, **kw)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if dist.is_initialized() and \
        dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks (its
    product must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if n != world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world_size()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if world_size() != n:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {n} ranks "
            f"(launch {n} processes, e.g. torchrun across hosts); this "
            f"process group has {world_size()}")
    return make_mesh(shape, axes, device_type)


def host_mesh_shape(n: int, model: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) for ``n`` ranks, factored as the reference factors
    its local device count: the largest of 16, 8, 4, 2 that divides
    ``n`` is the model extent."""
    if model is None:
        model = 1
        for cand in (16, 8, 4, 2):
            if n % cand == 0 and n >= cand:
                model = cand
                break
    return n // model, model


def make_host_mesh(model: Optional[int] = None,
                   device_type: Optional[str] = None):
    """A (data, model) mesh over every rank of the process group."""
    data, model = host_mesh_shape(world_size(), model)
    return make_mesh((data, model), ("data", "model"), device_type)


def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` on the CPU device type that no
    process holds: this process is rank 0 of a ``"fake"`` process group
    of ``prod(shape)`` ranks (started here; restarted at another size
    when a mesh of another size is asked for).  Refuses in a process
    whose group is a real one."""
    from repro_torch import compat
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "a mesh that no process holds needs the fake process "
                f"group, and this process runs a real one "
                f"({dist.get_backend()}, {dist.get_world_size()} ranks)")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
            # DTensor's cached sharding decisions hold the old group's
            # meshes (meshes of one layout compare equal): a DTensor made
            # from them would name groups the restart took down
            compat.clear_sharding_cache()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=compat.fake_store(), rank=0,
                                world_size=n)
    return make_mesh(tuple(shape), tuple(axes), "cpu")


def fake_production_mesh(multi_pod: bool = False):
    """The production mesh, (data=16, model=16) or (pod=2, data=16,
    model=16), over a fake process group (:func:`fake_mesh`)."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def as_device_mesh(mesh):
    """``mesh`` itself where it is a ``DeviceMesh`` (or None, or holds one
    device); a mesh that no process holds (an ``AbstractMesh`` or a
    mapping of axis sizes) of more than one device as the same shape
    over the fake process group (:func:`fake_mesh`)."""
    if mesh is None or hasattr(mesh, "mesh_dim_names"):
        return mesh
    sizes = axis_sizes(mesh)
    if math.prod(sizes.values()) <= 1:
        return mesh
    return fake_mesh(tuple(sizes.values()), tuple(sizes))
