"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242].

81L d_model=3584 (attn: 32H kv=32, d_ff=14336) vocab=32000 ssm_state=64.
81 Mamba2 blocks; ONE shared full transformer block (attn + MLP) is
invoked after every 6th Mamba2 block (13 invocations, weights shared),
following the Zamba2 shared-block design.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    mlp_act="gelu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="zamba2-7b-reduced", n_layers=4, d_model=128,
                          n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                          vocab=512, ssm_state=16, ssm_head_dim=32,
                          ssm_chunk=32, attn_every=2)
