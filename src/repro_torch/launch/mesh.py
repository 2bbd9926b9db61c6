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
so a 16x16 mesh's rules can be asked on one process.
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
    mapping of axis sizes."""
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
