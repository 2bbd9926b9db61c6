"""deepseek-coder-33b — dense llama-arch [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    head_dim=128,
    mlp_act="silu",
    rope_theta=100000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="deepseek-coder-33b-reduced", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                          d_ff=256, vocab=512)
