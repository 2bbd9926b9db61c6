"""smollm-135m — dense llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Also the compute-bound sensitivity workload (k-means analogue) and the
end-to-end CPU training example model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    head_dim=64,
    mlp_act="silu",
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="smollm-135m-reduced", n_layers=2, d_model=96,
                          n_heads=3, n_kv_heads=3, head_dim=32, d_ff=256,
                          vocab=512)
