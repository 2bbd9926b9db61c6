"""Deterministic synthetic-token pipeline.

The batch at step *t* is a pure function of (seed, t) — no iterator
state — so checkpoint/restart resumes the exact data order by saving
only the step counter (ft/ relies on this).

Tokens are Zipf-distributed (text-like marginals) with a deterministic
per-(step, row) stream; labels are next-token shifted.  This is the
PyTorch port of the reference's ``data/pipeline.py``: the rows come from
the same ``np.random.RandomState`` per row, so the tokens are bit for bit
the reference's.  The batch is placed on one explicit device; with a
``mesh`` it is a DTensor split by rows over the data axes (``pod``,
``data``) where they divide the batch, as the reference shards it, and
each rank draws only its own rows of the same global batch, so a sharded
run sees exactly the one-device run's data.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.params import TunableConfig
from repro_torch.models.model import input_specs


def _tokens_for(seed: int, step: int, lo: int, hi: int, seq: int,
                vocab: int, zipf_a: float = 1.3) -> np.ndarray:
    """Rows [lo, hi) of the global (B, seq+1) token matrix at ``step``."""
    out = np.empty((hi - lo, seq + 1), np.int32)
    for r in range(lo, hi):
        rng = np.random.RandomState(
            (seed * 1_000_003 + step * 8_191 + r) % (2**31 - 1))
        z = rng.zipf(zipf_a, size=seq + 1).astype(np.int64)
        out[r - lo] = (z % vocab).astype(np.int32)
    return out


@dataclasses.dataclass
class SyntheticLM:
    """batch_at(step) -> {tokens, labels[, frontend_embeds | frames]}
    matching ``input_specs``, on ``device``; a vlm's frontend embeddings
    and an encdec's frames are the reference's, 0.02 times a normal draw
    seeded by the step.  With ``mesh`` every tensor is a DTensor split by
    rows over the data axes."""
    cfg: ArchConfig
    shape: ShapeConfig
    rt: TunableConfig
    device: torch.device
    seed: int = 0
    mesh: Optional[Any] = None

    def __post_init__(self):
        self.specs = input_specs(self.cfg, self.shape, self.rt)
        self.device = torch.device(self.device)
        self._placements = None
        if self.mesh is not None:
            from torch.distributed.tensor import Replicate, Shard
            names = list(self.mesh.mesh_dim_names)
            axes = [names.index(a) for a in ("pod", "data") if a in names]
            B = self.specs["tokens"].shape[0]
            split = math.prod(self.mesh.size(k) for k in axes)
            self._placements = tuple(
                Shard(0) if k in axes and B % split == 0 else Replicate()
                for k in range(len(names)))

    def _rows(self, B: int):
        """The rows [lo, hi) of the global batch this rank holds."""
        if self._placements is None:
            return 0, B
        from repro_torch.runtime.sharding import local_block
        idx = local_block(torch.arange(B), self.mesh, self._placements)
        return int(idx[0]), int(idx[-1]) + 1

    def _place(self, t: torch.Tensor, B: int) -> torch.Tensor:
        t = t.contiguous().to(self.device)
        if self._placements is None:
            return t
        from torch.distributed.tensor import DTensor
        shape = (B,) + tuple(t.shape[1:])
        return DTensor.from_local(t, self.mesh, self._placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        B, seq = self.specs["tokens"].shape
        lo, hi = self._rows(B)
        toks = torch.from_numpy(_tokens_for(self.seed, step, lo, hi, seq,
                                            self.cfg.vocab))
        out = {"tokens": self._place(toks[:, :-1], B)}
        if "labels" in self.specs:
            out["labels"] = self._place(toks[:, 1:], B)
        # the stubbed frontends' outputs: vlm patch embeddings, encdec
        # audio frames
        for extra in ("frontend_embeds", "frames"):
            if extra in self.specs:
                s = self.specs[extra]
                rng = np.random.RandomState(
                    (self.seed * 31 + step * 7 + 13) % (2**31 - 1))
                emb = torch.from_numpy(rng.standard_normal(s.shape)).to(
                    s.dtype)
                out[extra] = self._place((emb * 0.02)[lo:hi], B)
        return out


class Prefetcher:
    """Background-thread prefetch queue over ``batch_at`` (depth N)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._source.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
