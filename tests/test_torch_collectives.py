"""Collective bytes per rank: the port's auto path against the
reference's XLA partitioner.  Each family's reduced train step on
(4, 2) under tp and fsdp_tp, and the dry run of smollm-135m at full
width on pod_16x16 (train_4k, decode_32k).

The port's counts come from the fake process group in a subprocess
(``_torch_fake_jobs``, jax and the reference blocked there); the
reference's from its partitioned HLO on 8 host devices
(``costmodel.parse_collectives``) and from its own dry run
(``launch/dryrun``, which sets its own host-device count), each in a
subprocess.  All three start together, once for this file.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from _torch_fake_group import ROOT, run_jobs

FAMILIES = ("smollm-135m", "olmoe-1b-7b", "llava-next-34b", "zamba2-7b",
            "xlstm-1.3b", "seamless-m4t-medium")
STRATEGIES = ("tp", "fsdp_tp")
BAND = (0.5, 1.3)          # port / reference

REF_FAMILIES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
from repro.configs import get_reduced
from repro.configs.base import ShapeConfig
from repro.core import costmodel
from repro.core.params import default_config
from repro.launch.mesh import make_mesh
from repro.runtime.stepfn import build_step
mesh = make_mesh((4, 2), ("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    for strategy in ("tp", "fsdp_tp"):
        rt = default_config(shard_strategy=strategy, unroll_layers=True)
        bundle = build_step(get_reduced(arch),
                            ShapeConfig("t", 64, 8, "train"), rt, mesh)
        with mesh:
            compiled = bundle.lower().compile()
        st = costmodel.parse_collectives(compiled.as_text())
        out[f"{arch}:{strategy}"] = {"summary": st.summary(),
                                     "total": st.total_bytes()}
print(json.dumps(out))
"""

REF_DRYRUN = r"""
import json
from repro.launch import dryrun
out = {}
for shape in ("train_4k", "decode_32k"):
    rec = dryrun.run_cell("smollm-135m", shape, False, save=False)
    out[shape] = rec["roofline"]["collective_bytes"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """The port's fake-group jobs and the reference's two subprocesses,
    run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    refs = {name: subprocess.Popen(
        [sys.executable, "-c", code] + args, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name, code, args in (("families", REF_FAMILIES,
                                  [",".join(FAMILIES)]),
                                 ("dryrun", REF_DRYRUN, []))}
    try:
        port = run_jobs("family_collectives", "full_width_collectives",
                        "one_collective_over_both_axes")
        for name, proc in refs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            port[f"reference_{name}"] = json.loads(
                out.strip().splitlines()[-1])
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
    return port


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_collective_bytes_against_the_reference(arch, strategy, runs):
    """Per rank, the reduced train step (B 8, S 64) on (4, 2) moves
    within 0.5-1.3x the reference's bytes: every product takes its
    weight gathered over the fsdp axes (``layers.use``) and the
    activations sit where the reference constrains them, so DTensor
    gathers no batch and splits no all-reduce into a reduce-scatter and
    an all-gather."""
    key = f"{arch}:{strategy}"
    got = runs["family_collectives"][key]["total"]
    want = runs["reference_families"][key]["total"]
    assert BAND[0] <= got / want <= BAND[1], (got, want)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_full_width_collective_bytes_against_the_reference(shape, runs):
    """The dry run of smollm-135m on pod_16x16, per chip, against the
    reference's dry run: train_4k within 0.5-1.3x; decode_32k at most
    1.3x (its few tokens move, where the reference also moves them, and
    the weights stay where they lie)."""
    rec = runs["full_width_collectives"][shape]
    assert rec["status"] == "ok", rec["error"]
    ratio = rec["collective_bytes"] / runs["reference_dryrun"][shape]
    assert ratio <= BAND[1], ratio
    if shape == "train_4k":
        assert ratio >= BAND[0], ratio


@pytest.mark.parametrize("case, kind, local", [
    ("partial", "all-reduce", [16, 8]), ("split", "all-gather", [16, 8]),
    ("scatter", "reduce-scatter", [2, 8])])
def test_two_axes_moved_by_one_collective(case, kind, local, runs):
    """A sum pending over both mesh dims made whole is one all-reduce over
    all 8 ranks, a dim split over both made whole one all-gather, and a
    sum pending over both split over both one reduce-scatter, as the
    reference issues them (DTensor alone takes one a mesh dim)."""
    r = runs["one_collective_over_both_axes"][case]
    assert r["collectives"] == [[kind, 8]]
    assert r["local"] == local
