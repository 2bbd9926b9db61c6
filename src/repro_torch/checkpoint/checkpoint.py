"""Atomic, async checkpoints of trees of tensors.

Layout:  <dir>/step_<N>/  manifest.json  +  one .npy per leaf.
Writes go to ``<dir>/.tmp_step_<N>`` and are committed with an atomic
rename, so a preemption mid-save never corrupts the latest checkpoint.

This is the PyTorch port of the reference's ``checkpoint/checkpoint.py``
with the same layout, leaf keys (the tree path, ``/``-joined: dict keys,
sequence indices) and manifest, so a checkpoint written by either
package restores in the other, leaf for leaf.  Leaves are numpy arrays
on disk in their own dtype.  A bf16 leaf (numpy has no bf16) is stored
as its 16 bits, a uint16 ``.npy`` with ``"dtype": "bfloat16"`` in the
manifest, and restored from them; no configuration the port trains has
a bf16 leaf (master weights and optimizer state are f32).  ``restore``
places every leaf on the device it is given (the device a run is on).

On a mesh the layout stays mesh-agnostic: ``save`` gathers each DTensor
leaf to a full tensor (a collective: every rank calls ``save``) and
rank 0 writes it; ``restore`` takes new placements (``shardings``, a
tree of ``(mesh, placements)`` as ``ShardingRules.sharding`` gives them)
and hands each rank its block.  A checkpoint written on one mesh so
restores on another mesh, or on one device, and the other way round
(``ft/elastic.restore_resharded``).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.runtime.loops import tree_map

BF16 = "bfloat16"


def _flatten(tree, prefix: str = "", leaf=lambda x: False
             ) -> Dict[str, Any]:
    """Leaves by path key, as the reference's ``jax.tree_util`` paths
    spell them (dict keys, then sequence indices, joined by ``/``)."""
    if leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/", leaf))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", leaf))
        return out
    return {prefix[:-1]: tree}


def _is_dtensor(x) -> bool:
    if not torch.is_tensor(x) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _writer() -> bool:
    """Rank 0 writes (every process writes when there is no group)."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def gather_full(tree):
    """Every DTensor leaf gathered to a full tensor (a collective)."""
    return tree_map(lambda x: x.full_tensor() if _is_dtensor(x) else x,
                    tree)


def _to_host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return BF16
    return str(arr.dtype)


def save(directory, step: int, tree, extra: Optional[Dict] = None
         ) -> pathlib.Path:
    directory = pathlib.Path(directory)
    tmp = directory / f".tmp_step_{step:08d}"
    final = directory / f"step_{step:08d}"
    tree = gather_full(tree)
    if not _writer():
        return final
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        arr = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf, arr)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)        # atomic commit
    return final


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")]
    return max(steps) if steps else None


def _load(path: pathlib.Path, meta: Dict, device) -> torch.Tensor:
    arr = np.load(path)
    if meta.get("dtype") == BF16:
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore(directory, step: int, target_tree, device=None,
            shardings=None) -> Any:
    """Restore into the structure of ``target_tree`` (shapes verified;
    its leaves need only a ``shape``).  Each leaf goes to ``device``,
    or, where that is None, to the device of the target's leaf (the CPU
    for a leaf that is not a tensor).  With ``shardings`` (a tree like
    the target's of ``(mesh, placements)``, or None for a leaf left
    whole) each leaf becomes a DTensor on its placements."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_target = _flatten(target_tree)
    if set(manifest["leaves"]) != set(flat_target):
        missing = set(flat_target) ^ set(manifest["leaves"])
        raise ValueError(
            f"checkpoint/target tree mismatch: {sorted(missing)[:5]}")
    out = {}
    for key, meta in manifest["leaves"].items():
        want = flat_target[key]
        if tuple(meta["shape"]) != tuple(want.shape):
            raise ValueError(f"{key}: shape {tuple(meta['shape'])} != "
                             f"{tuple(want.shape)}")
        dev = device if device is not None else (
            want.device if torch.is_tensor(want) else "cpu")
        out[key] = _load(d / meta["file"], meta, dev)
    if shardings is not None:
        from repro_torch.runtime.sharding import from_full
        for key, sh in _flatten(shardings, leaf=_is_sharding).items():
            if sh is not None and torch.is_tensor(out.get(key)):
                out[key] = from_full(out[key], *sh)
    return _rebuild(target_tree, out)


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        hasattr(x[0], "mesh_dim_names")


def _rebuild(target, out: Dict[str, Any], prefix: str = ""):
    if isinstance(target, dict):
        return {k: _rebuild(v, out, f"{prefix}{k}/")
                for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(v, out, f"{prefix}{i}/")
                            for i, v in enumerate(target))
    return out[prefix[:-1]]


def manifest_extra(directory, step: int) -> Dict:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    return json.loads((d / "manifest.json").read_text())["extra"]


class CheckpointManager:
    """Periodic + on-demand checkpoints, keep-N retention, async commit."""

    def __init__(self, directory, interval: int = 100, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.interval = interval
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self._lock = threading.Lock()

    def maybe_save(self, step: int, tree, extra=None, force: bool = False):
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return None
        return self.save_async(step, tree, extra)

    def save_async(self, step: int, tree, extra=None) -> cf.Future:
        # snapshot to the host NOW (a donating step updates these tensors
        # in place at the next step); DTensors are gathered on every rank
        tree = gather_full(tree)
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if torch.is_tensor(x) else x, tree)
        self.wait()
        with self._lock:
            self._pending = self._pool.submit(self._save_and_gc, step,
                                              host_tree, extra)
        return self._pending

    def _save_and_gc(self, step, host_tree, extra):
        path = save(self.directory, step, host_tree, extra)
        if not _writer():
            return path
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
        return path

    def wait(self):
        with self._lock:
            pending = self._pending
        if pending is not None:
            pending.result()

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, target_tree, device=None):
        s = self.latest_step()
        if s is None:
            return None, None
        return restore(self.directory, s, target_tree, device), s
