"""nemotron-4-340b — dense, GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
Largest dense arch: FSDP spans (data, pod) so optimizer state fits 512 chips.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    head_dim=192,
    mlp_act="relu2",
    optimizer="adafactor",       # Adam state (12 B/param) exceeds one pod
    fsdp_axes=("data", "pod"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="nemotron-4-340b-reduced", n_layers=2,
                          d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
                          d_ff=768, vocab=512, fsdp_axes=("data",))
