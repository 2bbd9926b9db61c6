"""Model dispatch: one uniform API over the model families.

``build_model(cfg)`` returns a :class:`Model` whose functions close over
the architecture config; ``input_specs`` gives the shapes of every
workload cell's inputs.  Every family of the reference is ported:
``dense``, ``moe`` and ``vlm`` (the transformer backbone), ``hybrid``
(zamba), ``ssm`` (xlstm) and ``encdec``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.params import TunableConfig
from repro_torch.models import (encdec, layers as L, transformer, xlstm,
                                zamba)
from repro_torch.runtime.remat import torch_dtype

_FAMILY_MODULES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": transformer,
    "hybrid": zamba,
    "ssm": xlstm,
    "encdec": encdec,
}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  The default is the card; with
    no card and no explicit request for the CPU this raises — nothing
    carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU on purpose")
    return dev


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    mod: Any

    # ---- parameters
    def spec(self):
        return self.mod.spec(self.cfg)

    def init(self, seed: int, dtype=None, device="cuda"):
        """Random parameters from an integer seed, drawn on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return L.init_params(self.spec(), gen,
                             dtype or torch_dtype(self.cfg.param_dtype), dev)

    def param_shapes(self, dtype=None):
        return L.param_shapes(self.spec(),
                              dtype or torch_dtype(self.cfg.param_dtype))

    def logical(self):
        return L.logical_tree(self.spec())

    def cast_params(self, params, rt: TunableConfig):
        """Matrices cast to the compute dtype once (see L.cast_params)."""
        return L.cast_params(params, self.spec(), rt)

    # ---- steps
    def loss_fn(self, params, batch, rt: TunableConfig, rules=None):
        return self.mod.loss_fn(params, batch, self.cfg, rt, rules)

    def prefill_fn(self, params, batch, rt: TunableConfig, rules=None,
                   max_seq: Optional[int] = None):
        ms = max_seq or batch["tokens"].shape[1]
        return self.mod.prefill_fn(params, batch, self.cfg, rt, rules, ms)

    def decode_fn(self, params, cache, tokens, rt: TunableConfig,
                  rules=None):
        return self.mod.decode_fn(params, cache, tokens, self.cfg, rt, rules)

    # ---- caches
    def cache_shapes(self, batch: int, max_seq: int, rt: TunableConfig):
        return self.mod.cache_shapes(self.cfg, batch, max_seq, rt)

    def init_cache(self, batch: int, max_seq: int, rt: TunableConfig,
                   device="cuda"):
        return self.mod.init_cache(self.cfg, batch, max_seq, rt,
                                   resolve_device(device))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg, _FAMILY_MODULES[cfg.family])


# ------------------------------------------------------------- inputs
def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                rt: TunableConfig) -> Dict[str, L.ShapeDtype]:
    """Shape/dtype stand-ins for one workload cell (no allocation).

    train  -> {tokens, labels [, frontend_embeds | frames]}
    prefill-> {tokens [, frontend_embeds | frames]}
    decode -> {tokens (B,1)}   (cache comes from Model.cache_shapes)

    vlm: ``frontend_embeds`` (B, F, d) in the compute dtype take the
    first F of the S positions; tokens and labels cover the other S - F.
    encdec: ``frames`` (B, S // enc_seq_ratio, d) in the compute dtype,
    the stubbed audio frontend's output; tokens and labels cover S.
    """
    B, S = shape.global_batch, shape.seq_len
    tok = lambda s: L.ShapeDtype((B, s), torch.int32)
    if shape.kind == "decode":
        return {"tokens": tok(1)}
    out = {}
    if cfg.family == "vlm":
        F = cfg.frontend_tokens
        out["frontend_embeds"] = L.ShapeDtype((B, F, cfg.d_model), L.dt(rt))
        S = S - F
    elif cfg.family == "encdec":
        out["frames"] = L.ShapeDtype((B, S // cfg.enc_seq_ratio,
                                      cfg.d_model), L.dt(rt))
    out["tokens"] = tok(S)
    if shape.kind == "train":
        out["labels"] = tok(S)
    return out


def synth_inputs(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Materialized random inputs matching ``input_specs``, drawn on the
    generator's device: tokens uniform over the vocabulary, embeddings
    standard normal."""
    out = {}
    for name, s in input_specs(cfg, shape, rt).items():
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=generator,
                                    device=generator.device, dtype=s.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, s.shape,
                                      generator=generator,
                                      device=generator.device, dtype=s.dtype)
    return out
