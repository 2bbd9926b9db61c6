"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, shape_applicable

_ARCH_MODULES: Dict[str, str] = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "nemotron-4-340b": "nemotron_4_340b",
    "smollm-135m": "smollm_135m",
    "glm4-9b": "glm4_9b",
    "llava-next-34b": "llava_next_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


def all_cells():
    """Every (arch, shape) cell with its applicability verdict."""
    out = []
    for a in list_archs():
        cfg = get_config(a)
        for s, shp in SHAPES.items():
            ok, reason = shape_applicable(cfg, shp)
            out.append((a, s, ok, reason))
    return out


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "list_archs", "get_config", "get_reduced", "get_shape", "all_cells"]
