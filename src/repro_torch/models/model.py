"""Model dispatch: one uniform API over the model families.

``build_model(cfg)`` returns a :class:`Model` whose functions close over
the architecture config; ``input_specs`` gives the shapes of every
workload cell's inputs.  The ``dense`` and ``hybrid`` families are
ported so far; the others raise (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.params import TunableConfig
from repro_torch.models import layers as L, transformer, zamba
from repro_torch.runtime.remat import torch_dtype

_FAMILY_MODULES = {
    "dense": transformer,
    "hybrid": zamba,
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
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            "(ROADMAP.md queue A, the other model families); only "
            f"{sorted(_FAMILY_MODULES)} can be built")
    return Model(cfg, _FAMILY_MODULES[cfg.family])


# ------------------------------------------------------------- inputs
def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                rt: TunableConfig) -> Dict[str, L.ShapeDtype]:
    """Shape/dtype stand-ins for one workload cell (no allocation).

    train  -> {tokens, labels}
    prefill-> {tokens}
    decode -> {tokens (B,1)}   (cache comes from Model.cache_shapes)
    """
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"inputs of family {cfg.family!r} are not ported yet "
            "(ROADMAP.md queue A, the other model families)")
    B, S = shape.global_batch, shape.seq_len
    tok = lambda s: L.ShapeDtype((B, s), torch.int32)
    if shape.kind == "decode":
        return {"tokens": tok(1)}
    out = {"tokens": tok(S)}
    if shape.kind == "train":
        out["labels"] = tok(S)
    return out


def synth_inputs(cfg: ArchConfig, shape: ShapeConfig, rt: TunableConfig,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Materialized random inputs matching ``input_specs``, drawn on the
    generator's device."""
    out = {}
    for name, s in input_specs(cfg, shape, rt).items():
        out[name] = torch.randint(0, cfg.vocab, s.shape, generator=generator,
                                  device=generator.device, dtype=s.dtype)
    return out
