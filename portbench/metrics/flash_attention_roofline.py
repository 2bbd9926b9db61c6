"""The prefill attention kernel's share of its roofline, in %: the least
time of every ``kernels/flash_attention/ops.flash_attention`` call in
the window (the larger of its bytes at the HBM rate and its operations
at the operands' rate), summed, over the device time of every kernel
those calls launched.

Counts from q, k, v (B, S, H, hd): q, k and v read once and the output
written once; QK^T and PV, 4 hd operations per (query, key) pair, over
the causal triangle S (S + 1) / 2 per (batch, head) when causal."""
from portbench.readers import nbytes, roofline_pct

KERNEL = "flash_attention"


def count(call):
    q, k, v = call["args"][:3]
    B, S, H, hd = q["shape"]
    pairs = S * (S + 1) // 2 if call["kw"].get("causal", True) else S * S
    moved = nbytes(q) + nbytes(k) + nbytes(v) + nbytes(q)
    return 4 * hd * pairs * B * H, moved, q["dtype"]


def read(run):
    return roofline_pct(run, "pb.k.flash_attention", count)
