"""glm4-9b — dense, RoPE, GQA kv=2, large vocab [hf:THUDM/glm-4-9b].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    head_dim=128,
    mlp_act="silu",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="glm4-9b-reduced", n_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384,
                          vocab=512)
