"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840.
~1.03T total / ~32B active parameters.  Optimizer is Adafactor and FSDP
spans (data, pod): Adam state for 1T params (12 B/param) exceeds 512x16GB
HBM, factored second moments fit.  Documented in DESIGN.md §4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    mlp_act="silu",
    n_experts=384,
    top_k=8,
    optimizer="adafactor",
    param_dtype="bfloat16",      # 1T f32 masters exceed fleet HBM
    fsdp_axes=("data", "pod"),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="kimi-k2-1t-a32b-reduced", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                          d_ff=64, vocab=512, n_experts=8, top_k=2,
                          optimizer="adamw", fsdp_axes=("data",))
