"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].

12L(enc)+12L(dec) d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206.
The audio frontend (fbank -> conformer feature extractor) is a STUB:
``input_specs()`` provides precomputed frame embeddings at
seq_len // enc_seq_ratio frames.  Decode shapes run (it has a decoder:
self-attn KV cache + fixed cross-attn cache).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    mlp_act="gelu",
    enc_layers=12,
    enc_seq_ratio=4,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="seamless-m4t-medium-reduced", n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                          d_ff=256, vocab=512, enc_layers=2)
