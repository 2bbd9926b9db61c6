"""Deterministic synthetic-token pipeline.

The batch at step *t* is a pure function of (seed, t) — no iterator
state — so checkpoint/restart resumes the exact data order by saving
only the step counter (ft/ relies on this).

Tokens are Zipf-distributed (text-like marginals) with a deterministic
per-(step, row) stream; labels are next-token shifted.  This is the
PyTorch port of the reference's ``data/pipeline.py``: the rows come from
the same ``np.random.RandomState`` per row, so the tokens are bit for bit
the reference's; the batch is placed on one explicit device (there is no
mesh to shard it over).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

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
    """batch_at(step) -> {tokens, labels} matching ``input_specs``, on
    ``device``."""
    cfg: ArchConfig
    shape: ShapeConfig
    rt: TunableConfig
    device: torch.device
    seed: int = 0

    def __post_init__(self):
        self.specs = input_specs(self.cfg, self.shape, self.rt)
        self.device = torch.device(self.device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        B, seq = self.specs["tokens"].shape
        toks = torch.from_numpy(_tokens_for(self.seed, step, 0, B, seq,
                                            self.cfg.vocab))
        out = {"tokens": toks[:, :-1].contiguous().to(self.device)}
        if "labels" in self.specs:
            out["labels"] = toks[:, 1:].contiguous().to(self.device)
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
