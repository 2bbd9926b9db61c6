"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=1024(per expert) vocab=50304.
Also the all-to-all-dominated sensitivity workload (pure-shuffling
analogue of the paper's Sec. 4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    mlp_act="silu",
    n_experts=64,
    top_k=8,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="olmoe-1b-7b-reduced", n_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=4, head_dim=32, d_ff=64,
                          vocab=512, n_experts=8, top_k=2)
