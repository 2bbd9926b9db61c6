"""Serving every family on a mesh, held against the port's one-device
serve path on CPU ranks (gloo): one spawn of 4 ranks (a module
fixture) on a (2, 2) mesh runs every case of the file.

The hybrid (zamba2-7b: Mamba2 and its scan under ``local_map``), ssm
(xlstm-1.3b: the mLSTM and the sLSTM on each rank's block) and encdec
(seamless-m4t-medium: the encoder, cross-attention and its cached K/V)
families serve under dp, tp and fsdp_tp with both ``attn_impl`` values
("pallas": the kernels' wrappers, plain versions on CPU tensors, under
``local_map``; "xla": the eager ops), prefill and three decode steps
through ``stepfn``'s serve steps.  At batch 1 the KV cache is split
along its sequence on the data axis: smollm-135m and zamba2-7b decode
against it with a bf16 and an int8 cache.
"""
import pytest

from _torch_dist import run_ranks
from _torch_spmd_ranks import _serve_all

FAMILIES = ("zamba2-7b", "xlstm-1.3b", "seamless-m4t-medium")
STRATEGIES = ("dp", "tp", "fsdp_tp")
SEQ_PLAN = [(a, kv) for a in ("smollm-135m", "zamba2-7b")
            for kv in ("bfloat16", "int8")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Rank 0's results of every case, from one spawn of 4 ranks."""
    return run_ranks(_serve_all, 4, tmp_path_factory.mktemp("serve"),
                     FAMILIES, STRATEGIES, SEQ_PLAN)


# a bound below one rounding unit's own movement cannot be held
FLOOR_MULTIPLE = 5


def _within(diffs, tol, what, floor=None):
    """Each difference (over the largest magnitude, at least 1) within
    ``tol``, or within FLOOR_MULTIPLE times its floor where that lies
    above ``tol``."""
    floor = floor or [0.0] * len(diffs)
    for i, (d, f) in enumerate(zip(diffs, floor)):
        assert d <= max(tol, FLOOR_MULTIPLE * f), (what, i, d, f)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_serves_on_the_mesh(served, arch, impl):
    """Prefill (B 4, a prompt of 8) and three decode steps on (2, 2)
    under dp, tp and fsdp_tp, f32, each step fed the one-device path's
    greedy token: every call's logits and every leaf of the returned
    cache within 1e-4 of the one-device serve path (of the largest
    magnitude where it passes 1; the cache holds values near 25), the
    position a host integer one past the last token.  Where one rounding
    unit of the parameters moves a value on one device by more than
    that (the floor, measured here over two draws), within five times
    the floor: the reduced zamba2-7b's second decode step moves 1e-3
    under it (random weights carry f32 rounding through its blocks);
    xlstm-1.3b and seamless-m4t-medium hold 1e-4 throughout."""
    res = served[(arch, impl)]
    for strat in STRATEGIES:
        r = res[strat]
        _within(r["logits"], 1e-4, (arch, impl, strat, "logits"),
                res["floor"]["logits"])
        _within(r["cache"], 1e-4, (arch, impl, strat, "cache"),
                res["floor"]["cache"])
        assert r["pos"][0] == r["pos"][1], (arch, impl, strat)
    if arch != "zamba2-7b":
        assert all(max(res[s]["logits"] + res[s]["cache"]) <= 1e-4
                   for s in STRATEGIES), (arch, impl)


@pytest.mark.parametrize("arch,kv", SEQ_PLAN)
def test_decode_against_a_sequence_split_cache(served, arch, kv):
    """Batch 1 on (2, 2) under tp: the KV cache (16 rows) split along its
    sequence on the data axis, a prompt of 13 (its live prefix crosses
    the split) and three decode steps, whose rows 13-15 the second data
    rank writes.  Logits and cache against one-device decode: a bf16
    cache within 2e-2, an int8 cache within tests/test_kernels.py's 2e-2
    (of the largest magnitude, at least 1).  Every rank holds only its
    block of the sequence: 8 of the 16 rows."""
    r = served[("seq", arch, kv)]["tp"]
    _within(r["logits"], 2e-2, (arch, kv, "logits"))
    _within(r["cache"], 2e-2, (arch, kv, "cache"))
    assert r["pos"][0] == r["pos"][1] == 16
    # K is (layers, B, Smax, Hkv, hd): dim 2 split on the data axis
    assert r["full"][2] == 16, r["full"]
    for shape, placements in r["local"]:
        assert shape[2] == 8, (shape, placements)
        assert placements.startswith("(Shard(dim=2)"), placements
