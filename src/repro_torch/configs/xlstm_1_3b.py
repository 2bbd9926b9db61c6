"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 vocab=50304.
xLSTM[7:1] layout: every 8th block is an sLSTM (scalar-memory, sequential
recurrence), the rest are mLSTM (matrix-memory, chunkwise-parallel linear
attention).  d_ff=0 per the paper: blocks carry their own up/down
projections instead of a separate FFN.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    mlp_act="gelu",
    ssm_chunk=256,
    slstm_every=8,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="xlstm-1.3b-reduced", n_layers=4, d_model=128,
                          n_heads=4, n_kv_heads=4, head_dim=32, vocab=512,
                          ssm_chunk=32, slstm_every=2)
