"""Batched serving scheduler: request queue -> prefill waves -> decode.

Iteration-level wave batching: requests are admitted from the queue until
the wave is full (or ``max_wait_s`` passes), prefilled together (padded to
the wave's max prompt length), then decoded step-by-step; finished lanes
(EOS or token budget) are masked out and the wave retires when all lanes
finish or the step budget is hit.  Tracks TTFT / throughput / queue-delay
metrics per request.

This is the serving-path integration point for the tuner: the scheduler
takes a TunableConfig, so kv_cache_dtype / donate_buffers trials apply to
a live serving workload.

Prompts are left-padded with token 0 and no padding mask, exactly as in
the reference: pad tokens are attended to, and positions run over the
padded length.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.params import TunableConfig
from repro_torch.models.model import Model, build_model, resolve_device
from repro_torch.runtime.loops import tree_map
from repro_torch.runtime.remat import torch_dtype


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # None = "stamp at submit"; an explicit value (virtual-clock replay)
    # is preserved even when it is exactly 0.0
    t_submit: Optional[float] = None
    # outputs
    generated: List[int] = dataclasses.field(default_factory=list)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        # explicit None checks: a first token at timestamp 0.0 (virtual
        # clocks start there) is a served token, not an unserved request
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit


@dataclasses.dataclass
class ServeMetrics:
    requests: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    wall_s: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        # every ratio is guarded: a drained-empty scheduler (zero
        # completed requests, zero wall time) summarizes to zeros
        # instead of dividing by zero
        if self.ttft_s:
            ordered = sorted(self.ttft_s)
            mean_ttft = sum(ordered) / len(ordered)
            p95_ttft = ordered[min(len(ordered) - 1,
                                   int(0.95 * len(ordered)))]
        else:
            mean_ttft = p95_ttft = 0.0
        return {
            "requests": self.requests,
            "decode_tok_per_s": (self.decode_tokens / self.wall_s
                                 if self.wall_s > 0 else 0.0),
            "prefill_tokens": self.prefill_tokens,
            "mean_ttft_s": mean_ttft,
            "p95_ttft_s": p95_ttft,
        }


class BatchScheduler:
    def __init__(self, cfg: ArchConfig, rt: TunableConfig, params,
                 wave_size: int = 4, max_seq: int = 128,
                 max_wait_s: float = 0.0,
                 pad_to: Optional[int] = None,
                 pad_wave: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.rt = rt
        self.device = resolve_device(device)
        self.model: Model = build_model(cfg)
        # placed on the device and cast to the compute dtype once, here,
        # instead of at every use inside the step functions; only the cast
        # tree is kept, so a master tree the caller drops is freed
        self.params = self.model.cast_params(
            tree_map(lambda t: t.to(self.device), params), rt)
        self.wave_size = wave_size
        self.max_seq = max_seq
        self.max_wait_s = max_wait_s
        # pad_to fixes the padded prompt length across waves; None keeps
        # the per-wave max.  pad_wave additionally pads the batch
        # dimension to wave_size with filler lanes (excluded from all
        # metrics), fixing the step geometry entirely.
        self.pad_to = pad_to
        self.pad_wave = pad_wave
        self.queue: Deque[Request] = collections.deque()
        self.metrics = ServeMetrics()

    # rt.donate_buffers reaches the decode path inside decode_fn: the
    # cache is updated in place when it is set and on a copy when not
    @torch.no_grad()
    def _prefill(self, params, batch):
        return self.model.prefill_fn(params, batch, self.rt,
                                     max_seq=self.max_seq)

    @torch.no_grad()
    def _decode(self, params, cache, tok):
        return self.model.decode_fn(params, cache, tok, self.rt)

    def submit(self, req: Request):
        if req.t_submit is None:     # preserve explicit virtual clocks,
            req.t_submit = time.time()   # including a legitimate 0.0
        self.queue.append(req)

    # ------------------------------------------------------------ waves
    def _admit_wave(self) -> List[Request]:
        if not self.queue and self.max_wait_s <= 0:
            return []
        deadline = time.time() + self.max_wait_s
        while (len(self.queue) < self.wave_size
               and time.time() < deadline):
            time.sleep(0.001)
        wave = []
        while self.queue and len(wave) < self.wave_size:
            wave.append(self.queue.popleft())
        return wave

    def _pad_prompts(self, wave: List[Request]):
        # left-pad to a common length so last prompt token aligns
        L = max(len(r.tokens) for r in wave)
        if self.pad_to is not None:
            L = max(L, int(self.pad_to))
        B = max(len(wave), self.wave_size) if self.pad_wave else len(wave)
        toks = np.zeros((B, L), np.int32)
        for i, r in enumerate(wave):
            toks[i, L - len(r.tokens):] = r.tokens
        return torch.from_numpy(toks).to(self.device)

    def run_wave(self) -> List[Request]:
        wave = self._admit_wave()
        if not wave:
            return []
        t0 = time.time()
        tokens = self._pad_prompts(wave)
        batch = {"tokens": tokens}
        if self.cfg.family == "encdec":
            # the reference's frames: zeros, so the encoder's output and
            # every cross-attention are exactly 0 on this path
            S = tokens.shape[1]
            batch["frames"] = torch.zeros(
                (tokens.shape[0], max(1, S // self.cfg.enc_seq_ratio),
                 self.cfg.d_model), dtype=torch_dtype(self.rt.compute_dtype),
                device=self.device)
        logits, cache = self._prefill(self.params, batch)
        # filler lanes (pad_wave) never count toward metrics
        self.metrics.prefill_tokens += int(len(wave) * tokens.shape[1])
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        host = tok[:, 0].tolist()    # one device->host read per step
        now = time.time()
        for i, r in enumerate(wave):
            r.t_first_token = now
            r.generated.append(int(host[i]))
        done = np.array([r.eos_id is not None
                         and r.generated[-1] == r.eos_id for r in wave])
        budget = max(r.max_new_tokens for r in wave) - 1
        steps = min(budget, self.max_seq - tokens.shape[1] - 1)
        for _ in range(max(0, steps)):
            if done.all():
                break
            logits, cache = self._decode(self.params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            host = tok[:, 0].tolist()
            self.metrics.decode_tokens += int((~done).sum())
            for i, r in enumerate(wave):
                if done[i]:
                    continue
                t = int(host[i])
                r.generated.append(t)
                if ((r.eos_id is not None and t == r.eos_id)
                        or len(r.generated) >= r.max_new_tokens):
                    done[i] = True
                    r.t_done = time.time()
        now = time.time()
        for r in wave:
            if r.t_done is None:
                r.t_done = now
            ttft = r.ttft_s
            self.metrics.ttft_s.append(ttft if ttft is not None else 0.0)
        self.metrics.requests += len(wave)
        self.metrics.wall_s += now - t0
        return wave

    def run_until_drained(self) -> List[Request]:
        out = []
        while self.queue:
            wave = self.run_wave()
            if not wave:         # guard: an empty admission must not
                break            # spin the drain loop forever
            out.extend(wave)
        return out

