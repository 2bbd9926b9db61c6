"""llava-next-34b — VLM backbone with anyres tiling frontend stub
[hf:llava-hf/llava-v1.6].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision tower is a STUB: ``input_specs()`` provides precomputed anyres
patch embeddings (frontend_tokens per image) that are prepended to the
text sequence; the transformer backbone is fully implemented.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    mlp_act="silu",
    frontend_tokens=576,     # one 24x24 anyres base tile of patch embeddings
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="llava-next-34b-reduced", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                          d_ff=256, vocab=512, frontend_tokens=16)
