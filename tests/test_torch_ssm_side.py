"""The ``ssm_scan`` kernel cell's yardstick and its checks, on CPU
tensors.  The kernel cell is held to the scan's plain version computed
in f64 (``chip_smoke.plain_output``): on the card's host the f32 plain
version once read 2.73e-4 from the f64 recurrence where the kernel read
2.10e-5 (ROADMAP.md queue C).  ``chip_smoke.side_report`` names which
side of the comparison moved, with the (chunk, row, head, p) of its first
differing element and each side's error against the per-token
recurrence in f64; ``chip_smoke.assert_sync_zero``, run after every scan
call on the card, catches a sync counter left non-zero."""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core.kernel_cell import KERNELS  # noqa: E402
from repro_torch.core.params import default_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402


def _tiny():
    """The tuner's tiny scan cell's inputs and plain outputs, as the
    kernel-cell phase builds them."""
    spec = KERNELS["ssm_scan"]
    fn, args = spec.build(spec.shapes["tiny"], default_config(),
                          torch.device("cpu"))
    return fn, args, fn(*args)


@pytest.mark.parametrize("side", ["got", "want", "inputs"])
def test_side_report_names_the_side_that_moved(side):
    fn, args, out = _tiny()
    prev = {"label": "64", "got": [t.clone() for t in out],
            "want": [t.clone() for t in out],
            "inputs": [a.clone() for a in args]}
    got, want = [t.clone() for t in out], [t.clone() for t in out]
    args = [a.clone() for a in args]
    # row 70 is row 6 of chunk 1 at the kernel's chunk of 64
    if side == "got":
        got[0][0, 70, 1, 3] += 1e-3
    elif side == "want":
        want[0][0, 70, 1, 3] += 1e-3
    else:
        args[0][0, 70, 1, 3] += 1.0
    rep = cs.side_report("ssm_scan", "tiny", "128", args, got, want, prev,
                         1e-4)
    assert rep["moved"] == [side]
    at = rep["first_differing_place"][side]
    assert at == {"b": 0, "chunk": 1, "row": 6, "head": 1, "p": 3}
    if side == "inputs":
        assert rep["first_miss"] == [None, None]
    else:
        assert rep["first_miss_place"] == at
    assert rep["threads"] == torch.get_num_threads()
    assert rep["f32_matmul_precision"] == torch.get_float32_matmul_precision()
    assert rep["mkldnn"]["enabled"] == torch.backends.mkldnn.enabled
    assert rep["previous_tiles"] == "64"


def test_side_report_measures_both_sides_against_the_f64_recurrence():
    fn, args, out = _tiny()
    got = [t.clone() for t in out]
    got[0][0, 3, 0, 0] += 2e-4
    rep = cs.side_report("ssm_scan", "tiny", "64", args, got, list(out),
                         None, 1e-4)
    f64 = rep["err_vs_f64_ref"]
    assert max(f64["want"]) < 1e-5
    assert f64["got"][0] == pytest.approx(2e-4, rel=0.05)
    assert rep["moved"] == [] and rep["previous_tiles"] is None


def test_ssm_scan_tiled_in_f64_is_the_recurrence_in_f64():
    """The yardstick: at the tiny cell's seeded inputs the plain version
    at the kernel's chunk, in f64, is the exact recurrence in f64 to
    1e-12, and the f32 one lies within 1e-4 of it."""
    fn, args, _ = _tiny()
    Y64, h64 = ref.ssm_scan_ref(*(a.double() for a in args),
                                dtype=torch.float64)
    Yt, ht = ref.ssm_scan_tiled(*(a.double() for a in args),
                                ops.KERNEL_CHUNK, dtype=torch.float64)
    assert Yt.dtype == ht.dtype == torch.float64
    assert float((Yt - Y64).abs().max()) < 1e-12
    assert float((ht - h64).abs().max()) < 1e-12
    Y32, h32 = ref.ssm_scan_tiled(*args, ops.KERNEL_CHUNK)
    assert Y32.dtype == h32.dtype == torch.float32
    assert float((Y32.double() - Yt).abs().max()) < 1e-4
    assert float((h32.double() - ht).abs().max()) < 1e-4
    # a ragged S (the padded last chunk) in f64 too
    Yr, hr = ref.ssm_scan_tiled(*(a[:, :100].double() for a in args),
                                ops.KERNEL_CHUNK, dtype=torch.float64)
    Yr64, hr64 = ref.ssm_scan_ref(*(a[:, :100].double() for a in args),
                                  dtype=torch.float64)
    assert float((Yr - Yr64).abs().max()) < 1e-12
    assert float((hr - hr64).abs().max()) < 1e-12


def test_kernel_cells_hold_the_scan_to_its_f64_plain_version():
    """``plain_output`` gives the scan's cell its plain version in f64
    (its spec's ``plain``), and every other cell the wrapper's plain
    version on the CPU; only flash_decode's tile reaches its kernel."""
    assert [n for n, s in sorted(KERNELS.items()) if s.plain] == ["ssm_scan"]
    assert [n for n, s in sorted(KERNELS.items())
            if s.tile_reaches_kernel] == ["flash_decode"]
    fn, args, _ = _tiny()
    Y, h = cs.plain_output("ssm_scan", fn, args)
    assert Y.dtype == h.dtype == torch.float64
    want = ref.ssm_scan_tiled(*(a.double() for a in args), ops.KERNEL_CHUNK,
                              dtype=torch.float64)
    assert torch.equal(Y, want[0]) and torch.equal(h, want[1])
    spec = KERNELS["rmsnorm"]
    fn, args = spec.build(spec.shapes["tiny"], default_config(),
                          torch.device("cpu"))
    (out,) = cs.plain_output("rmsnorm", fn, args)
    assert torch.equal(out, fn(*args))


def test_ssm_scan_plain_version_holds_the_f64_recurrence():
    """The yardstick of the dump: at the tiny cell's inputs the plain
    version at the kernel's chunk (f32) is within 1e-4 of the exact
    recurrence in f64, and the recurrence in f32 within 1e-5."""
    fn, args, (Y, h) = _tiny()
    Y64, h64 = ref.ssm_scan_ref(*(a.double() for a in args),
                                dtype=torch.float64)
    assert Y64.dtype == h64.dtype == torch.float64
    assert float((Y.double() - Y64).abs().max()) < 1e-4
    assert float((h.double() - h64).abs().max()) < 1e-4
    Y32, h32 = ref.ssm_scan_ref(*args)
    assert h32.dtype == torch.float32
    assert float((Y32.double() - Y64).abs().max()) < 1e-5


def test_assert_sync_zero_catches_a_counter_left_set(monkeypatch):
    buf = torch.zeros(64, dtype=torch.int32)
    monkeypatch.setattr(ops, "_sync", {(torch.device("cpu"), 7): buf})
    cs.assert_sync_zero("tiny")
    buf[5] = 2
    with pytest.raises(AssertionError, match="stream 7.*1 non-zero.*5: 2"):
        cs.assert_sync_zero("tiny")


_FRESH = r"""
import json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
import torch
import chip_smoke as cs
from repro_torch.core.kernel_cell import KERNELS
from repro_torch.core.params import default_config
from repro_torch.kernels.ssm_scan import ops, ref
spec = KERNELS["ssm_scan"]
fn, args = spec.build(spec.shapes["tiny"], default_config(),
                      torch.device("cpu"))
Y, h = ref.ssm_scan_tiled(*args, ops.KERNEL_CHUNK)
Y64, h64 = ref.ssm_scan_ref(*(a.double() for a in args), dtype=torch.float64)
print(json.dumps({"shape": list(args[0].shape), "dtype": str(Y.dtype),
                  "err_y": float((Y.double() - Y64).abs().max()),
                  "err_h": float((h.double() - h64).abs().max()),
                  "host": cs.host_state()}))
"""


def test_tiled_f32_matches_f64_recurrence():
    """ROADMAP.md queue C item 1: the f32 CPU scan (``ssm_scan_tiled`` at
    the kernel's chunk, the wrappers' path on CPU tensors) against the
    f64 recurrence (``ssm_scan_ref``) at ``kernel:ssm_scan:tiny``'s
    seeded inputs (B 1, S 512, H 2, P = N = 8), in 20 fresh processes
    (the firings seen, 2.73e-4 on the card's host and 7.4e-4 on a CPU
    test host against the usual ~3e-6, were each in a fresh process: its
    first f32 ``torch.exp`` returned one thread's block of 2048 at
    ~1.5e-4 relative error; the plain scan now takes its exps in f64):
    each within 2e-5, in Y and in the final state.  A miss prints that
    process's host state."""
    import json
    import subprocess
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    runs = []
    for batch in range(5):            # four processes at a time
        procs = [subprocess.Popen([sys.executable, "-c", _FRESH, str(ROOT)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for _ in range(4)]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            runs.append(json.loads(out.strip().splitlines()[-1]))
    assert len(runs) == 20
    for r in runs:
        assert r["shape"] == [1, 512, 2, 8] and r["dtype"] == "torch.float32"
        assert r["err_y"] < 2e-5 and r["err_h"] < 2e-5, r
