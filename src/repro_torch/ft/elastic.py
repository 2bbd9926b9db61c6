"""Elastic scaling: rebuild the mesh for a changed device count and
reshard the training state from the (mesh-agnostic) checkpoint.

The PyTorch port of the reference's ``ft/elastic.py``.  Checkpoints
store full host arrays, so a job that loses (or gains) ranks restarts
with a new mesh factorization; only the data-parallel extent changes —
the model-axis extent is kept when it divides, halved otherwise, so
TP/EP layouts stay valid.

A mesh here is the ``DeviceMesh`` of the running process group when it
has exactly the new mesh's ranks, and otherwise an ``AbstractMesh`` (the
shape a restart launches with: ``torchrun --nproc-per-node`` its size).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import mesh as M


def _count(devices) -> int:
    if devices is None:
        return M.world_size()
    return devices if isinstance(devices, int) else len(devices)


def remesh(n_devices: int, model_axis: int, devices=None):
    """Largest (data x model) mesh fitting n_devices, model extent fixed
    (halved until it divides).  ``devices``: the ranks there are (a count
    or a sequence; default the process group's)."""
    have = _count(devices)
    if n_devices > have:
        raise ValueError(f"asked for {n_devices}, have {have}")
    while model_axis > 1 and n_devices % model_axis != 0:
        model_axis //= 2
    data = n_devices // model_axis
    shape, axes = (data, model_axis), ("data", "model")
    if data * model_axis > 0 and data * model_axis == M.world_size() \
            and M.world_size() > 1:
        return M.make_mesh(shape, axes)
    return M.AbstractMesh(shape, axes)


def restore_resharded(directory: str, step: int, target_tree,
                      new_shardings, device=None):
    """Restore a checkpoint onto a different mesh (a tree of new
    ``(mesh, placements)``; None restores full tensors)."""
    return ckpt.restore(directory, step, target_tree, device,
                        shardings=new_shardings)


def survivors_mesh(old_mesh, lost: int) -> Tuple[object, int]:
    """Mesh after losing ``lost`` devices (keeps model axis if possible)."""
    sizes = M.axis_sizes(old_mesh)
    old = math.prod(sizes.values())
    n = old - lost
    model = sizes.get("model", 1)
    new = remesh(n - (n % model) if n % model else n, model, devices=old)
    return new, math.prod(M.axis_sizes(new).values())
