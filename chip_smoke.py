#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ptxas]  # needs one CUDA device and nvcc

Drives the port's two serving paths (``repro_torch.launch.serve`` and
``repro_torch.serving.scheduler.BatchScheduler``) on smollm-135m (dense),
zamba2-7b (hybrid: Mamba2 + shared attention), olmoe-1b-7b (MoE: 64
experts, top 8), xlstm-1.3b (ssm: mLSTM and sLSTM blocks) and
seamless-m4t-medium (encoder-decoder with cross-attention), each at its
full width and depth with random weights from a seed, builds the four
hand-written CUDA kernels from ``src/repro_torch/csrc`` and holds each
against its plain PyTorch version on the card, and shows by the
wrappers' launch counters that each path went through its kernels.

Phases, one JSON line each: env, build, kernels, kernel_cells (each
kernel at the tuner's kernel-cell shapes and tiles, against its plain
version, the scan's computed in f64, every call after a NaN fill of the
SMs' shared memory), agree
(kernel path vs eager path of the whole model, per model; for olmoe
``agree_moe`` also counts the routing decisions that differ and holds
the MoE FFN alone against its expert-by-expert version; ``agree_xlstm``
and ``agree_encdec`` hold each number to a floor measured on the card),
agree_train (one f32 train step on the card against the CPU), then for
each model serve, scheduler and launches (every counter set to 0 just
before the path and read right after it; the paths of olmoe, xlstm and
seamless also profile a prefill and decode steps, ``serve_profile``),
then ``mesh`` (the sharded path at one NCCL rank in this process: a
(1, 1) ``DeviceMesh``, smollm-135m at full width and depth through
DTensors and ``local_map`` to the kernels, prefill, decode, a train step
on the auto path, the gradient collectives and a checkpoint, then
zamba2-7b, seamless-m4t-medium and xlstm-1.3b served at full width and
depth the same way, each against the one-device path; ``{"mesh": ...}``
line; its own counters, ``launches_by_path["mesh"]``),
then two campaigns of the port's tuner
(``repro_torch.launch.tune.tune_campaign``, strategy ``tree``, measured
re-rank of the top 1 in ``tune``, of the top 2 in ``tune_kernels``,
telemetry on), each a path of its own for the
counters: ``tune`` walks the serve cell ``serve:smollm-135m:poisson_card``
(smollm-135m at full width and depth) and ``tune_kernels`` the four
kernel cells ``kernel:{flash_attention,flash_decode,ssm_scan,rmsnorm}:tiny``;
then ``fabric``, the fleet through its entry points (``tune --workers 2
--device cuda`` as a subprocess over those four cells and
``serve:smollm-135m:poisson_tiny``, then a worker SIGKILLed mid-cell and
another that steals its lease; its workers' launches are counted in
their own processes, so ``launches_by_path["fabric"]`` is null);
then three more paths: ``train`` (``repro_torch.launch.train`` at full
width and depth, a stop and a resume; it launches no kernel),
``train_families`` (for olmoe-1b-7b, llava-next-34b, zamba2-7b,
xlstm-1.3b and seamless-m4t-medium at full width: one train step on the
card against the CPU at a cut depth, then timed steps at a cut depth;
no kernel) and ``tune_steps`` (single-cell mode on
``smollm-135m:decode_card``, ``olmoe-1b-7b:prefill_card`` and
``xlstm-1.3b:long_500k``, a campaign over smollm's ``prefill_card`` and
``train_card``), then ``roofline``: the analytic evaluator on one card
(``core/trial.RooflineEvaluator``, the step counted on fake tensors) on
each of those cells at its walk's baseline and winner, every term
finite and the roofline at most 1.05 times the measured cost (a
``{"roofline": [...]}`` line), and the dry run
(``python -m repro_torch.launch.dryrun --arch smollm-135m
--both-meshes --quiet``, a subprocess started after ``fabric`` with no
card visible, beside ``train`` and ``train_families``; every record
``ok`` or ``skip`` as ``shape_applicable`` says; its wall time in the
phase's line); no kernel launches there.
Checkpoints, timing
caches and telemetry go to a fresh temporary directory, so no trial is
replayed from an earlier run.  Any failure raises and the run exits
non-zero.
The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card's name and power limit; the line before
that is the ``{"kernels": [...]}`` record, whose ``launches`` sum every
path's counts (``launches_by_path`` keeps them apart).

Peak rates used for ``bound_ms`` (NVIDIA H100 SXM data sheet, dense;
``repro_torch/core/card.py``, the table the cost model reads too):
3.35e12 bytes/s device memory; for operations the card's peak rate for
the operands' type (``bound_rate`` in each record), whatever units the
kernel itself uses: 989e12 op/s on the tensor cores for bf16 operands
and for int8 caches read against a bf16 query (``bf16``: int8 values are
exact in bf16, the scale applies per row); for f32 operands 165e12, a
third of the TF32 rate of 495e12, since three TF32 products hold an f32
product's precision where one does not (``tf32x3``, above the CUDA
cores' 67e12); for rmsnorm, elementwise, 67e12 op/s on the CUDA cores
(``f32``).  The SSD scan's bf16-X record takes the bf16 rate (X bf16;
B and C f32) and its f32-X record ``tf32x3``.
``bound_ms`` is the larger of (bytes of each input read once + each
output written once) / memory rate and operations / that rate; for
causal attention and for decode the operations and bytes counted are
those this run's data needs (the causal half; the live part of the
cache); for the SSD scan, the products of the chunked algorithm at the
kernel's own chunk of 64 rows (the ragged last chunk at its length, no
carried term into the first chunk).

Timings (``ms``, ``plain_ms``, ``library_ms``): device time per call, from
CUDA events around the replay of a CUDA graph that holds repeated calls,
inputs left warm in L2 as the serving path leaves them; ``eager_ms`` is
the host's call-to-call time when the wrapper is called from Python
(the mean over one window of calls), ``eager_min_ms`` the least such
mean of 30 shorter windows, and ``library_eager_ms`` /
``library_eager_min_ms`` the same for the library call.  Every input of
a timed call is made before it is timed (rmsnorm's library call gets
scale already cast to x's dtype).  f32 comparisons run with TF32
switched off (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import card  # noqa: E402  (after the path above)

# the card's rates, from the one table the cost model reads too
# (core/card.py, with their sources)
MEM_BYTES_PER_S = card.HBM_BYTES_PER_S
PEAK_OPS = {"bf16": card.FLOPS_BF16, "tf32x3": card.FLOPS_TF32 / 3,
            "f32": card.FLOPS_F32}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.int8: 2e-2}
# flash_attention's two kernels, both on the tensor cores: bf16 operands,
# and f32 operands as three TF32 products (flash_attention.cu is the
# entry point)
BF16_SOURCE = "src/repro_torch/csrc/flash_attention_tc.cu"
F32_SOURCE = "src/repro_torch/csrc/flash_attention_f32.cu"


START = time.time()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.time() - START, 1),
                      **fields}), flush=True)


class GcPauses:
    """The garbage collector's pauses while the block runs (host clock):
    how many collections, their seconds in all, and the longest."""

    def __enter__(self):
        import gc
        self.n, self.seconds, self.longest, self._t0 = 0, 0.0, 0.0, None
        gc.callbacks.append(self._observe)
        return self

    def _observe(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.n, self.seconds = self.n + 1, self.seconds + dt
            self.longest = max(self.longest, dt)

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._observe)

    def summary(self) -> dict:
        return {"collections": self.n, "seconds": self.seconds,
                "longest_s": self.longest}


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls are captured into a CUDA
    graph and the graph's replay is timed with CUDA events, so the host's
    cost of enqueueing a call (tens of microseconds from Python, more
    than these kernels run) is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def eager_ms(fn, iters: int = 50) -> float:
    """Time from call to call when launched eagerly from Python: what the
    serving path pays per call while it is host-bound."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def eager_min_ms(fn, iters: int = 20, windows: int = 30) -> float:
    """``eager_ms`` over ``windows`` back-to-back windows of ``iters``
    calls, the least of them: the call's own cost without the stalls of
    a host shared with other work, which only ever add time."""
    return min(eager_ms(fn, iters) for _ in range(windows))


def rate_for(dtype) -> str:
    """The ``PEAK_OPS`` key for products of operands of ``dtype``."""
    return "bf16" if dtype in (torch.bfloat16, torch.int8) else "tf32x3"


def bound(nbytes: float, ops: float, rate: str) -> tuple:
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = max_err(got, want)
    # the tolerance of the reference's kernel tests: |a-b| <= tol + tol*|b|
    excess = float(((got.float() - want.float()).abs()
                    - tol * want.float().abs()).max())
    if excess > tol:
        raise AssertionError(f"{name}: max abs err {err} over tolerance {tol}")
    return err


# ------------------------------------------------------------------ phases
def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_env() -> str:
    from repro_torch.kernels import _build
    smi = nvidia_smi()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc[-2] if len(nvcc) > 1 else nvcc[-1],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build(ptxas: bool) -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.lib(verbose=ptxas)
    emit("build", seconds=round(time.time() - t0, 2),
         compiled=_build.build_seconds is not None,
         sources=[str(p.relative_to(ROOT)) for p in _build.sources()],
         flags=" ".join(_build.NVCC_FLAGS))


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)


# rmsnorm's timed shapes (rows, d, x dtype): the serving paths' prefill
# (4*1024 rows) and decode (4 rows) at smollm-135m's width 576,
# zamba2-7b's 3584 (d_model) and 7168 (the Mamba2 blocks' gated output)
# olmoe-1b-7b's and xlstm-1.3b's 2048 and seamless-m4t-medium's 1024,
# in bf16 and, at prefill, in f32 (the knob
# space's default compute dtype)
RMSNORM_TIMED = ((4 * 1024, 576, torch.bfloat16), (4, 576, torch.bfloat16),
                 (4 * 1024, 3584, torch.bfloat16),
                 (4 * 1024, 7168, torch.bfloat16),
                 (4, 3584, torch.bfloat16), (4, 7168, torch.bfloat16),
                 (4 * 1024, 576, torch.float32),
                 (4 * 1024, 3584, torch.float32),
                 (4 * 1024, 7168, torch.float32),
                 # olmoe-1b-7b (d_model 2048): prefill and decode
                 (4 * 1024, 2048, torch.bfloat16),
                 (4, 2048, torch.bfloat16),
                 (4 * 1024, 2048, torch.float32),
                 # seamless-m4t-medium (d_model 1024): decoder prefill
                 (4 * 1024, 1024, torch.bfloat16),
                 (4 * 1024, 1024, torch.float32))


def rmsnorm_timed(gen, ops, rows: int, d: int, dtype) -> dict:
    """One timed rmsnorm shape through ``ops.rmsnorm`` (this tree's, or
    another tree's for scripts/time_prefill_kernels.py), scale f32 as the
    model passes it.  The library's call takes scale in x's dtype, cast
    once before it is timed; ``library_cast_ms`` times it with the cast
    inside the timed call, as earlier records of this script did."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ref
    x = _randn(gen, (rows, d), dtype)
    s = torch.ones(d, device="cuda")
    s_lib = s.to(dtype)
    b_ms, by = bound(2 * rows * d * x.element_size() + 4 * d,
                     4 * rows * d, "f32")
    run = lambda: ops.rmsnorm(x, s)
    lib = lambda: F.rms_norm(x, (d,), s_lib, 1e-5)
    return {"shape": [rows, d], "dtype": str(dtype),
            "ms": time_ms(run), "eager_ms": eager_ms(run),
            "eager_min_ms": eager_min_ms(run),
            "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, s)),
            "library_ms": time_ms(lib), "library_eager_ms": eager_ms(lib),
            "library_eager_min_ms": eager_min_ms(lib),
            "library_cast_ms": time_ms(
                lambda: F.rms_norm(x, (d,), s.to(dtype), 1e-5)),
            "bound_ms": b_ms, "bound_by": by, "bound_rate": "f32"}


def kernels_rmsnorm(gen) -> dict:
    from repro_torch.kernels.rmsnorm import ops, ref
    worst = 0.0

    def held(name, x, s):
        nonlocal worst
        y = ops.rmsnorm(x, s)
        worst = max(worst, check(f"rmsnorm {name}", y,
                                 ref.rmsnorm_ref(x, s), TOL[x.dtype]))
        return y

    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        vec = ops.vec_len(dtype)
        # the configs' widths (d_model; zamba2-7b's gated 2 * 3584), and
        # on the general path odd widths and nemotron-4-340b's 18432
        for d in (576, 1024, 2048, 3584, 4096, 7168, 18432, 577, 4099):
            if (ops.plan(d, dtype).kind == "general") != (
                    d in (18432, 577, 4099)):
                raise AssertionError(f"rmsnorm plan {dtype} d={d}: "
                                     f"{ops.plan(d, dtype)}")
            for rows in ((4, 111) if d == 18432 else (4, 111, 4 * 1024)):
                held(f"{dtype} {rows}x{d}", _randn(gen, (rows, d), dtype),
                     _randn(gen, (d,), f32) * 0.1 + 1.0)
        # every class, at the narrowest d that takes it: 111 rows give
        # several row groups and a ragged last one
        widest = ops.MAX_THREADS * ops.MAX_VECS * vec
        for cls in ops.CLASSES:
            d = next((d for d in range(vec, widest + 1, vec)
                      if ops.plan(d, dtype)[1:3] == cls), None)
            if d is None:
                raise AssertionError(f"rmsnorm {dtype}: no width takes "
                                     f"class {cls}")
            held(f"{dtype} 111x{d} class {cls}",
                 _randn(gen, (111, d), dtype),
                 _randn(gen, (d,), f32) * 0.1 + 1.0)
        # a bf16 scale beside x of either dtype, on a class and the
        # general path
        for d in (3584, 577):
            held(f"{dtype} x, bf16 scale, d={d}",
                 _randn(gen, (111, d), dtype),
                 (_randn(gen, (d,), f32) * 0.1 + 1.0).to(bf16))
        # contiguous views off a 16-byte boundary (x, then scale) take
        # the general path at a class's width
        for d in (576, 3584):
            base = _randn(gen, (111 * d + 1,), dtype)
            sbase = _randn(gen, (d + 1,), f32) * 0.1 + 1.0
            held(f"{dtype} x at an odd offset, d={d}",
                 base[1:].view(111, d), sbase[:d])
            held(f"{dtype} scale at an odd offset, d={d}",
                 base[:111 * d].view(111, d), sbase[1:])
        # repeated calls give the same bits, on a class and the general
        # path
        for d in (7168, 4099):
            x = _randn(gen, (4 * 1024, d), dtype)
            s = _randn(gen, (d,), f32) * 0.1 + 1.0
            first = held(f"{dtype} repeat d={d}", x, s)
            if not all(torch.equal(first, ops.rmsnorm(x, s))
                       for _ in range(3)):
                raise AssertionError(f"rmsnorm {dtype} d={d}: repeated "
                                     f"calls differ")
    # a 3-D input as the model passes it, bf16 scale
    x = _randn(gen, (4, 37, 576), bf16)
    held("bf16 (4,37,576), bf16 scale", x,
         (_randn(gen, (576,), f32) * 0.1 + 1.0).to(bf16))

    shapes = []
    for rows, d, dtype in RMSNORM_TIMED:
        row = rmsnorm_timed(gen, ops, rows, d, dtype)
        row["plan"] = list(ops.plan(d, dtype))
        shapes.append(row)
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:34",
            "max_abs_err": worst, "tolerance": {"f32": 2e-5, "bf16": 2e-2},
            **{k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "bound_rate",
                                         "library_ms")},
            "timed_shape": "x (4096,576) bf16, scale f32 (prefill, B=4 S=1024)",
            "shapes": shapes}


def kernels_flash_attention(gen) -> dict:
    """bf16 runs the bf16 tensor-core kernel, f32 the three-TF32 one; each
    timed shape names the source of the kernel it ran."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref

    def plain(q, k, v, causal):
        return ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2),
                                 causal=causal).transpose(1, 2)

    worst = 0.0
    cases = [  # (B,S,H,hd), causal, (block_q, block_kv)
        ((4, 1024, 9, 64), True, (128, 128)),
        ((4, 1024, 9, 64), True, (256, 256)),
        ((1, 4096, 32, 128), True, (128, 128)),
        ((2, 300, 3, 64), True, (128, 128)),      # ragged: tiles fit to 100
        ((2, 257, 2, 32), True, (128, 128)),      # prime S: tiles fit to 1
        ((2, 192, 3, 64), False, (128, 64)),      # non-causal
        ((1, 1, 2, 64), True, (128, 128)),        # S = 1
        ((4, 1024, 32, 112), True, (128, 128)),   # zamba2-7b prefill
        ((2, 300, 3, 112), True, (128, 128)),     # hd 112, ragged
        ((1, 512, 4, 192), True, (128, 128)),     # nemotron-4-340b hd 192
        ((2, 257, 2, 192), False, (128, 64)),     # hd 192, prime S
        ((4, 919, 32, 112), True, (128, 128)),    # zamba smoke wave: prime S
        ((4, 746, 32, 112), True, (128, 128)),    # zamba smoke wave: 2 x 373
        ((4, 1000, 9, 64), True, (128, 128)),     # ragged: tiles fit to 125
        ((1, 300, 2, 256), True, (128, 128)),     # the largest hd
        ((2, 77, 2, 16), False, (128, 128)),      # the smallest hd
        ((4, 1024, 16, 128), True, (128, 128)),   # olmoe-1b-7b prefill
        ((4, 1024, 16, 64), True, (128, 128)),    # seamless-m4t-medium
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, causal, (bq, bkv) in cases:
            q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
            got = ops.flash_attention(q, k, v, causal=causal, block_q=bq,
                                      block_kv=bkv)
            err = check(f"flash_attention {dtype} {shape} causal={causal} "
                        f"tiles={bq}/{bkv}", got, plain(q, k, v, causal),
                        TOL[dtype])
            worst = max(worst, err)
    # nothing is refused: a knob tile of 512 keys runs the kernels' own
    # tiles at hd 128 and 192 in both dtypes and agrees
    accepted = []
    for hd in (128, 192):
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn(gen, (1, 512, 2, hd), dtype)
            got = ops.flash_attention(q, q, q, block_q=128, block_kv=512)
            worst = max(worst, check(
                f"flash_attention {dtype} hd{hd} block_kv 512", got,
                plain(q, q, q, True), TOL[dtype]))
            accepted.append(f"{dtype} hd {hd} block_kv 512: "
                            f"{ops.smem_bytes(hd, dtype)} B")

    # the wrapper's formula (the tests' table) must say what the library
    # asks for
    lib = _build.lib()
    for hd in ops.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            got = lib.rt_flash_attention_smem(hd, int(dtype == torch.bfloat16))
            if got != ops.smem_bytes(hd, dtype):
                raise AssertionError(
                    f"flash_attention smem {dtype} hd {hd}: kernel {got} B, "
                    f"wrapper {ops.smem_bytes(hd, dtype)}")

    def timed(shape, dtype, tiles=(128, 128)):
        B, S, H, hd = shape
        q, k, v = (_randn(gen, shape, dtype) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        el = q.element_size()
        pairs = B * H * S * (S + 1) / 2          # causal (row, col) pairs
        rate = rate_for(dtype)
        b_ms, by = bound(4 * B * S * H * hd * el, 4 * pairs * hd, rate)
        run = lambda: ops.flash_attention(q, k, v, block_q=tiles[0],
                                          block_kv=tiles[1])
        return {"shape": list(shape), "dtype": str(dtype),
                "source": BF16_SOURCE if dtype == torch.bfloat16
                else F32_SOURCE,
                "tiles": list(tiles), "ms": time_ms(run, iters=10),
                "eager_ms": eager_ms(run, iters=10),
                "plain_ms": time_ms(lambda: plain(q, k, v, True), iters=5),
                "library_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), iters=10),
                "bound_ms": b_ms, "bound_by": by, "bound_rate": rate}
    shapes = [timed((4, 1024, 9, 64), torch.bfloat16),
              timed((4, 1024, 9, 64), torch.float32),
              timed((4, 1024, 9, 64), torch.bfloat16, (256, 256)),
              timed((4, 1024, 9, 64), torch.bfloat16, (512, 512)),
              timed((4, 1024, 32, 112), torch.bfloat16),   # zamba2-7b
              # the zamba smoke trace's waves (prime S, 2 x 373) and a
              # ragged smollm length
              timed((4, 919, 32, 112), torch.bfloat16),
              timed((4, 746, 32, 112), torch.bfloat16),
              timed((4, 1000, 9, 64), torch.bfloat16),
              # zamba2-7b in f32 (the knob space's default compute dtype),
              # at S 1024 and at the smoke trace's waves
              timed((4, 1024, 32, 112), torch.float32),
              timed((4, 919, 32, 112), torch.float32),
              timed((4, 746, 32, 112), torch.float32),
              # olmoe-1b-7b (MHA, 16 heads of 128) in bf16 and f32
              timed((4, 1024, 16, 128), torch.bfloat16),
              timed((4, 1024, 16, 128), torch.float32),
              # seamless-m4t-medium's decoder (MHA, 16 heads of 64)
              timed((4, 1024, 16, 64), torch.bfloat16),
              timed((4, 1024, 16, 64), torch.float32)]
    # the headline shape is bf16: flash_tc_kernel; f32 runs flash_f32_kernel
    return {"name": "flash_attention", "route": "cuda",
            "source": BF16_SOURCE,
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:84",
            "max_abs_err": worst, "tolerance": {"f32": 2e-5, "bf16": 2e-2},
            **{k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "bound_rate",
                                         "library_ms")},
            "timed_shape": "q/k/v (4,1024,9,64) bf16 causal, tiles 128/128",
            "head_dims_checked": sorted({c[0][3] for c in cases}),
            "accepted": accepted, "shapes": shapes}


def kernels_flash_decode(gen) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops, ref
    from repro_torch.models.layers import quantize_kv

    def plain(q, kc, vc, ks, vs, length):
        tr = lambda t: None if t is None else t.transpose(1, 2)
        return ref.decode_ref(tr(q), tr(kc), tr(vc), tr(ks), tr(vs),
                              length).transpose(1, 2).to(q.dtype)

    def make(B, S, H, Hkv, hd, kv):
        qd = torch.float32 if kv == "float32" else torch.bfloat16
        q = _randn(gen, (B, 1, H, hd), qd)
        kc, ks = quantize_kv(_randn(gen, (B, S, Hkv, hd), qd), kv)
        vc, vs = quantize_kv(_randn(gen, (B, S, Hkv, hd), qd), kv)
        return q, kc, vc, ks, vs

    worst = 0.0
    for kv in ("bfloat16", "float32", "int8"):
        tol = TOL[torch.float32] if kv == "float32" else 2e-2
        q, kc, vc, ks, vs = make(4, 2048, 9, 3, 64, kv)
        for length in (1, 33, 2048):
            got = ops.flash_decode(q, kc, vc, length, ks, vs, block_kv=128)
            worst = max(worst, check(
                f"flash_decode {kv} smollm length={length}", got,
                plain(q, kc, vc, ks, vs, length), tol))
        # glm4-9b geometry: 16 query heads per KV head, hd 128, long cache
        q, kc, vc, ks, vs = make(2, 32768, 32, 2, 128, kv)
        for length, bkv in ((32768, 512), (20001, 128)):
            got = ops.flash_decode(q, kc, vc, length, ks, vs, block_kv=bkv)
            worst = max(worst, check(
                f"flash_decode {kv} glm4 length={length}", got,
                plain(q, kc, vc, ks, vs, length), tol))
        del q, kc, vc, ks, vs
    # hd 32 (the reduced configs) and a group of one head
    q, kc, vc, ks, vs = make(3, 96, 4, 4, 32, "int8")
    worst = max(worst, check("flash_decode hd32", ops.flash_decode(
        q, kc, vc, 77, ks, vs, block_kv=128),
        plain(q, kc, vc, ks, vs, 77), 2e-2))
    # hd 112 (zamba2-7b: H = Hkv = 32, the serving path's cache) and hd
    # 192 (nemotron-4-340b: 96 query heads on 8 KV heads)
    for kv in ("bfloat16", "float32", "int8"):
        tol = TOL[torch.float32] if kv == "float32" else 2e-2
        for (B, S, H, Hkv, hd), lengths in (
                ((4, 1088, 32, 32, 112), (1, 1025, 1088)),
                ((2, 640, 96, 8, 192), (333, 640))):
            q, kc, vc, ks, vs = make(B, S, H, Hkv, hd, kv)
            for length in lengths:
                got = ops.flash_decode(q, kc, vc, length, ks, vs,
                                       block_kv=128)
                worst = max(worst, check(
                    f"flash_decode {kv} hd{hd} length={length}", got,
                    plain(q, kc, vc, ks, vs, length), tol))
            # calls in a row give the same bits: the merge's tickets are
            # back at 0 after every call
            again = [ops.flash_decode(q, kc, vc, lengths[-1], ks, vs,
                                      block_kv=128) for _ in range(3)]
            if not all(torch.equal(a, got) for a in again):
                raise AssertionError(f"flash_decode {kv} hd{hd}: repeated "
                                     "calls differ")
    # olmoe-1b-7b: H = Hkv = 16 heads of 128, and seamless-m4t-medium:
    # 16 heads of 64; the serving path's cache of 1024 + 32 rows in a
    # 2048-row buffer, each cache type
    for name, hd in (("olmoe", 128), ("seamless", 64)):
        for kv in ("bfloat16", "float32", "int8"):
            tol = TOL[torch.float32] if kv == "float32" else 2e-2
            q, kc, vc, ks, vs = make(4, 2048, 16, 16, hd, kv)
            for length in (1, 1025, 1056, 2048):
                got = ops.flash_decode(q, kc, vc, length, ks, vs,
                                       block_kv=128)
                worst = max(worst, check(
                    f"flash_decode {kv} {name} length={length}", got,
                    plain(q, kc, vc, ks, vs, length), tol))
            del q, kc, vc, ks, vs
    # one query head per KV head (as zamba2-7b) at the other bf16 lane-group
    # sizes (hd 16, 32, 64, 128), with a ragged last tile and spans that
    # merge
    for hd in (16, 32, 64, 128):
        q, kc, vc, ks, vs = make(2, 300, 4, 4, hd, "bfloat16")
        for length in (1, 77, 300):
            got = ops.flash_decode(q, kc, vc, length, ks, vs, block_kv=64)
            worst = max(worst, check(
                f"flash_decode bfloat16 n_rep 1 hd{hd} length={length}", got,
                plain(q, kc, vc, ks, vs, length), 2e-2))

    # the wrapper's mirror of a block's shared memory (which picks the
    # warps per block) must say what the library asks for
    lib = _build.lib()
    for hd in ops.HEAD_DIMS:
        for kvb in (1, 2, 4):
            stages = ops.ring_stages(hd, kvb)
            for slots in (1, 4):
                for warps in (4, 8):
                    got = lib.rt_flash_decode_smem(hd, kvb, slots, warps,
                                                   stages)
                    want = ops.smem_bytes(hd, kvb, slots, warps, stages)
                    if got != want:
                        raise AssertionError(
                            f"flash_decode smem hd {hd} kv {kvb} B slots "
                            f"{slots} warps {warps}: kernel {got} B, "
                            f"wrapper {want}")

    def timed(kv, length, geometry=(4, 2048, 9, 3, 64)):
        B, S, H, Hkv, hd = geometry
        q, kc, vc, ks, vs = make(B, S, H, Hkv, hd, kv)
        live = 2 * B * length * Hkv * hd * kc.element_size()
        if ks is not None:
            live += 2 * B * length * Hkv * 4
        nbytes = live + 2 * B * H * hd * q.element_size()   # q in, o out
        # at the rate for the operands' type: a bf16 query against a bf16
        # or int8 cache takes the bf16 rate (the kernel's own math is on
        # the CUDA cores)
        rate = rate_for(q.dtype if q.dtype == torch.float32 else kc.dtype)
        b_ms, by = bound(nbytes, 4 * B * H * length * hd, rate)
        lib = None
        if ks is None:   # one library call: the group's heads as query rows
            qg = q.view(B, Hkv, H // Hkv, hd)
            kt = kc[:, :length].transpose(1, 2)
            vt = vc[:, :length].transpose(1, 2)
            lib = time_ms(lambda: F.scaled_dot_product_attention(qg, kt, vt))
        plan = ops.plan_split(   # the split this call runs
            B, Hkv, H // Hkv, hd, length, 128,
            torch.cuda.get_device_properties(0).multi_processor_count,
            kc.element_size())._asdict()
        return {"shape": {"B": B, "Smax": S, "H": H, "Hkv": Hkv, "hd": hd,
                          "length": length, "block_kv": 128},
                "cache": kv, "plan": plan,
                "ms": time_ms(lambda: ops.flash_decode(
                    q, kc, vc, length, ks, vs, block_kv=128)),
                "eager_ms": eager_ms(lambda: ops.flash_decode(
                    q, kc, vc, length, ks, vs, block_kv=128)),
                "plain_ms": time_ms(
                    lambda: plain(q, kc, vc, ks, vs, length)),
                "library_ms": lib, "bound_ms": b_ms, "bound_by": by,
                "bound_rate": rate}
    # the serving paths' shapes: B=4, cache grown to about 1056 positions
    # (olmoe-1b-7b's in a 2048-row buffer)
    zamba = (4, 1088, 32, 32, 112)
    glm4, nemotron = (2, 32768, 32, 2, 128), (2, 640, 96, 8, 192)
    olmoe = (4, 2048, 16, 16, 128)
    seamless = (4, 2048, 16, 16, 64)
    shapes = [timed("bfloat16", 1056), timed("int8", 1056),
              timed("bfloat16", 2048), timed("bfloat16", 1056, zamba),
              timed("int8", 1056, zamba), timed("bfloat16", 20001, glm4),
              timed("int8", 20001, glm4), timed("bfloat16", 640, nemotron),
              timed("bfloat16", 1056, olmoe), timed("int8", 1056, olmoe),
              timed("bfloat16", 1056, seamless),
              timed("int8", 1056, seamless)]
    # decode_kernel lives in the header; flash_decode.cu is its entry point
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cuh",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:84",
            "max_abs_err": worst,
            "tolerance": {"f32": 2e-5, "bf16": 2e-2, "int8": 2e-2},
            **{k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "bound_rate",
                                         "library_ms")},
            "timed_shape": "B=4 Smax=2048 H=9 Hkv=3 hd=64 bf16 cache, "
                           "length 1056, block_kv 128",
            "shapes": shapes}


def ssm_inputs(gen, B, S, H, P, N, xdtype):
    """The SSD scan's inputs, with the reference test's distributions:
    B/C/dt/la f32 as the model passes them, X in the compute dtype."""
    X = _randn(gen, (B, S, H, P), xdtype)
    Bm = _randn(gen, (B, S, N), torch.float32) * 0.5
    Cm = _randn(gen, (B, S, N), torch.float32) * 0.5
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, H), torch.float32))
    la = -dt * torch.exp(_randn(gen, (H,), torch.float32) * 0.2)
    return X, Bm, Cm, dt, la


def kernels_ssm_scan(gen) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops, ref
    from repro_torch.kernels.tiling import fit_block
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # tests/test_kernels.py
    Qk = ops.KERNEL_CHUNK
    if _build.lib().rt_ssm_scan_chunk() != Qk:
        raise AssertionError(f"ssm_scan: the kernel's chunk is "
                             f"{_build.lib().rt_ssm_scan_chunk()}, the "
                             f"plain version's {Qk}")

    # each case against the kernel's plain version (its own chunk, the
    # ragged last chunk masked) and against the plain chunked version at
    # the reference's fitted chunk
    # Y is held at its dtype's tolerance; h_final is f32 at both X dtypes
    # and decode carries it on, so it is held at f32's (a state path with
    # single TF32 products misses it by about 10x)
    worst, worst_h, checked = 0.0, {}, []
    cases = [((4, 1024, 112, 64, 64), 256),   # zamba2-7b prefill, B 4
             ((4, 1000, 112, 64, 64), 256),   # ragged: chunk fits to 250
             ((4, 919, 112, 64, 64), 256),    # zamba smoke wave: prime S
             ((4, 746, 112, 64, 64), 256),    # zamba smoke wave: 2 x 373
             ((1, 997, 8, 64, 64), 256),      # prime S: chunk fits to 1
             ((2, 130, 2, 8, 8), 32),         # tests/test_kernels.py ragged
             ((1, 64, 2, 16, 8), 16),
             ((3, 61, 11, 32, 16), 256)]      # zamba reduced P, N; 11 heads
    for (B, S, H, P, N), chunk in cases:
        for xdtype in (torch.bfloat16, torch.float32):
            ins = ssm_inputs(gen, B, S, H, P, N, xdtype)
            Y, h = ops.ssm_scan(*ins, chunk=chunk)
            name = f"ssm_scan {xdtype} {(B, S, H, P, N)} chunk={chunk}"
            for plain, Q in ((ref.ssm_scan_tiled, Qk),
                             (ref.ssm_scan_chunked, fit_block(chunk, S))):
                Yp, hp = plain(*ins, Q)
                err_h = check(f"{name} h vs chunk {Q}", h, hp,
                              tol[torch.float32])
                worst = max(worst, err_h, check(f"{name} Y vs chunk {Q}", Y,
                                                Yp, tol[xdtype]))
                worst_h[str(xdtype)] = max(worst_h.get(str(xdtype), 0.0),
                                           err_h)
            checked.append(name)
            # calls in a row give the same bits: the tickets and flags are
            # back at 0 after every call
            if not all(torch.equal(a, Y) for a, _ in
                       (ops.ssm_scan(*ins, chunk=chunk) for _ in range(2))):
                raise AssertionError(f"{name}: repeated calls differ")

    def timed(B, S, chunk=256, H=112, P=64, N=64, xdtype=torch.bfloat16):
        X, Bm, Cm, dt, la = ssm_inputs(gen, B, S, H, P, N, xdtype)
        el = X.element_size()
        nbytes = (2 * B * S * H * P * el + 2 * B * S * N * 4
                  + 2 * B * S * H * 4 + B * H * P * N * 4)
        # multiply-adds of the chunked algorithm at the kernel's chunk,
        # each chunk at its own length q: C.B^T over the causal half once
        # per (batch, chunk) -- the heads share it -- and per (batch,
        # head, chunk) the causal half of scores.X, the state update X^T.B
        # and, but for the first chunk, the carried term C.h^T
        macs = 0
        for c0 in range(0, S, Qk):
            q = min(Qk, S - c0)
            pairs = q * (q + 1) / 2
            macs += B * pairs * N + B * H * (
                pairs * P + q * P * N * (2 if c0 else 1))
        rate = rate_for(xdtype)
        b_ms, by = bound(nbytes, 2 * macs, rate)
        run = lambda: ops.ssm_scan(X, Bm, Cm, dt, la, chunk=chunk)
        return {"shape": {"B": B, "S": S, "H": H, "P": P, "N": N,
                          "chunk": chunk, "fitted_chunk": fit_block(chunk, S),
                          "kernel_chunk": Qk},
                "x_dtype": str(xdtype), "ms": time_ms(run, iters=10),
                "eager_ms": eager_ms(run, iters=10),
                "plain_ms": time_ms(lambda: ref.ssm_scan_tiled(
                    X, Bm, Cm, dt, la, Qk), iters=2),
                "library_ms": None, "bound_ms": b_ms, "bound_by": by,
                "bound_rate": rate}
    shapes = [timed(4, 1024), timed(4, 1024, xdtype=torch.float32),
              timed(1, 1024), timed(4, 1000), timed(4, 997),
              # the zamba smoke trace's waves
              timed(4, 919), timed(4, 746)]
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:73",
            "max_abs_err": worst, "max_abs_err_h": worst_h,
            "tolerance": {"f32": 1e-4, "bf16": 5e-2, "h_final": 1e-4},
            **{k: shapes[0][k] for k in ("ms", "eager_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "bound_rate", "library_ms")},
            "timed_shape": "X (4,1024,112,64) bf16, B/C (4,1024,64) f32, "
                           "dt/la (4,1024,112) f32, chunk 256",
            "library_note": "no single PyTorch call computes chunked SSD",
            "checked": checked, "shapes": shapes}


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = [kernels_rmsnorm(gen), kernels_flash_attention(gen),
               kernels_flash_decode(gen), kernels_ssm_scan(gen)]
    emit("kernels", kernels=records)
    return records


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_agree() -> None:
    """The model at full width: hand-written kernels (attn_impl=pallas)
    against eager torch ops (attn_impl=xla) on the same weights and
    prompt — prefill logits, one decode step's logits, every cache tensor.

    With random weights this model amplifies any perturbation about
    tenfold per layer (a 1e-6 change of the embedding alone decorrelates
    the logits of the 30-layer model), so the two paths are held together
    at a cut depth: 2 layers in f32, where they differ by summation order
    only, and 1 layer in bf16, where the eager path rounds probabilities
    to bf16 and the kernel path keeps f32, as in the reference.  At full
    depth the outputs are checked for shape and finiteness and the
    difference is reported, not bounded."""
    from repro_torch.configs import get_config
    from repro_torch.core.params import default_config
    from repro_torch.models.layers import dequantize_kv
    from repro_torch.models.model import build_model

    full = get_config("smollm-135m")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, full.vocab, (4, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)
    names = ("prefill_logits", "decode_logits", "k_cache", "v_cache")

    def differences(cfg, compute, kv):
        model = build_model(cfg)
        master = model.init(0, device="cuda")
        res = {}
        for impl in ("pallas", "xla"):
            rt = default_config(compute_dtype=compute, kv_cache_dtype=kv,
                                attn_impl=impl)
            params = model.cast_params(master, rt)
            with torch.no_grad():
                logits, cache = model.prefill_fn(params, {"tokens": tokens},
                                                 rt, max_seq=1088)
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                logits2, cache = model.decode_fn(params, cache, tok, rt)
            torch.cuda.synchronize()
            lay = cache["layers"]
            if tuple(logits.shape) != (4, 1, cfg.vocab) or \
                    logits.dtype != torch.float32 or cache["pos"] != 1025 or \
                    tuple(lay["k"].shape) != (cfg.n_layers, 4, 1088, 3, 64):
                raise AssertionError(f"agree: bad output {logits.shape} "
                                     f"{logits.dtype} {lay['k'].shape}")
            res[impl] = (logits, logits2,
                         dequantize_kv(lay["k"], lay.get("k_scale"),
                                       torch.float32),
                         dequantize_kv(lay["v"], lay.get("v_scale"),
                                       torch.float32))
            if not all(bool(torch.isfinite(t).all()) for t in res[impl]):
                raise AssertionError(f"agree: non-finite output ({impl})")
        return dict(zip(names, (_rel(a, b) for a, b in
                                zip(res["pallas"], res["xla"]))))

    out = {}
    for layers, compute, kv, tol in ((2, "float32", "float32", 1e-3),
                                     (1, "bfloat16", "bfloat16", 0.1),
                                     (1, "bfloat16", "int8", 0.1)):
        rels = differences(full.replace(n_layers=layers), compute, kv)
        out[f"{layers} layers {compute}/{kv}"] = dict(rels, tolerance=tol)
        if max(rels.values()) > tol:
            raise AssertionError(f"agree {layers} layers {compute}/{kv}: "
                                 f"relative differences {rels} over {tol}")
    out["30 layers bfloat16/bfloat16"] = dict(
        differences(full, "bfloat16", "bfloat16"), tolerance=None)

    # why the depth is cut: at full depth in f32, the K cache layer by
    # layer for (a) the kernel path against the eager path and (b) the
    # eager path against itself with the embedding scaled by 1 + 1e-6
    model = build_model(full)
    master = model.init(0, device="cuda")
    nudged = dict(master, embed={
        k: v * (1 + 1e-6) for k, v in master["embed"].items()})

    def k_cache(params, impl):
        rt = default_config(compute_dtype="float32", kv_cache_dtype="float32",
                            attn_impl=impl)
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, {"tokens": tokens}, rt,
                                             max_seq=1024)
        return logits, cache["layers"]["k"]

    base, kernel, moved = (k_cache(master, "xla"), k_cache(master, "pallas"),
                           k_cache(nudged, "xla"))
    growth = {}
    for name, (logits, k) in (("pallas_vs_xla", kernel),
                              ("xla_nudged_vs_xla", moved)):
        growth[name] = {"logits": _rel(logits, base[0]), **{
            f"k_layer_{i}": _rel(k[i], base[1][i]) for i in (0, 5, 10, 29)}}
    emit("agree", measure="||pallas - xla|| / ||xla||", results=out,
         growth_f32_30_layers=growth)


def phase_agree_zamba() -> None:
    """zamba2-7b at full width (d_model 3584, 112 SSM heads, attention hd
    112): hand-written kernels (attn_impl=pallas) against eager torch ops
    (attn_impl=xla) on the same weights, prompt and next token — prefill
    logits, one decode step's logits, and every cache tensor (SSM and
    conv states, K and V dequantised).

    Held at a cut depth that has a group and a remainder (3 Mamba2
    blocks, the shared block after the 2nd): f32 within 1e-3, where the
    two paths differ by summation order; bf16 within 0.1, or, where bf16
    rounding alone moves the eager path further than that from its own
    f32 result (the rounding is amplified through the blocks, as in
    tests/test_torch_hybrid_bf16.py), within twice that distance.  At
    full depth (81 blocks) the outputs are checked for shape and
    finiteness and the difference is reported, not bounded."""
    from repro_torch.configs import get_config
    from repro_torch.core.params import default_config
    from repro_torch.models.layers import dequantize_kv, padded_vocab
    from repro_torch.models.model import build_model

    full = get_config("zamba2-7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, full.vocab, (4, 1025), generator=gen,
                           device="cuda", dtype=torch.int32)
    # every run decodes the same next token: with a decay of about 0.45
    # per token the newest token dominates the SSM and conv states, so
    # each run's own argmax (which bf16 rounding can flip) would compare
    # states built from different inputs
    tokens, next_tok = tokens[:, :1024], tokens[:, 1024:]

    def run(model, master, compute, kv, impl, caches=True):
        cfg = model.cfg
        rt = default_config(compute_dtype=compute, kv_cache_dtype=kv,
                            attn_impl=impl)
        params = model.cast_params(master, rt)
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, {"tokens": tokens}, rt,
                                             max_seq=1088)
            logits2, cache = model.decode_fn(params, cache, next_tok, rt)
        torch.cuda.synchronize()
        del params
        g = cfg.n_layers // cfg.attn_every
        H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        want = {"ssm": (g, cfg.attn_every, 4, H, 64, 64),
                "conv": (g, cfg.attn_every, 4, 3, 2 * cfg.d_model)}
        if tuple(logits.shape) != (4, 1, padded_vocab(cfg)) or \
                logits.dtype != torch.float32 or cache["pos"] != 1025 or \
                tuple(cache["kv"]["k"].shape) != (g, 4, 1088, 32, 112) or \
                any(tuple(cache["groups"][k].shape) != v
                    for k, v in want.items()):
            raise AssertionError(f"agree zamba: bad output {logits.shape} "
                                 f"{logits.dtype} {cache['kv']['k'].shape}")
        out = {"prefill_logits": logits, "decode_logits": logits2}
        if caches:
            kvc = cache["kv"]
            out.update({
                f"{part}_{name}": cache[part][name]
                for part in ("groups", "rem") if part in cache
                for name in ("ssm", "conv")})
            out["k_cache"] = dequantize_kv(kvc["k"], kvc.get("k_scale"),
                                           torch.float32)
            out["v_cache"] = dequantize_kv(kvc["v"], kvc.get("v_scale"),
                                           torch.float32)
        if not all(bool(torch.isfinite(t).all()) for t in out.values()):
            raise AssertionError(f"agree zamba: non-finite output ({impl})")
        return out

    cut = build_model(full.replace(n_layers=3, attn_every=2))
    master = cut.init(0, device="cuda")
    eager32 = run(cut, master, "float32", "float32", "xla")
    out = {}
    for compute, kv in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("bfloat16", "int8")):
        kernel = run(cut, master, compute, kv, "pallas")
        eager = eager32 if compute == "float32" else \
            run(cut, master, compute, kv, "xla")
        rels = {n: _rel(kernel[n], eager[n]) for n in eager}
        if compute == "float32":
            tols = {n: 1e-3 for n in rels}
        else:
            drift = {n: _rel(eager[n], eager32[n]) for n in rels}
            tols = {n: max(0.1, 2 * drift[n]) for n in rels}
        key = f"3 layers (2+shared+1) {compute}/{kv}"
        out[key] = {n: {"rel": rels[n], "tolerance": tols[n]} for n in rels}
        bad = {n: r for n, r in rels.items() if r > tols[n]}
        if bad:
            raise AssertionError(f"agree zamba {key}: relative differences "
                                 f"{bad} over {tols}")
    del master, eager32, kernel, eager
    torch.cuda.empty_cache()

    model = build_model(full)
    master = model.init(0, device="cuda")
    runs = {impl: run(model, master, "bfloat16", "bfloat16", impl,
                      caches=False) for impl in ("pallas", "xla")}
    out["81 layers bfloat16/bfloat16"] = {
        n: {"rel": _rel(runs["pallas"][n], runs["xla"][n]),
            "tolerance": None} for n in runs["xla"]}
    del master, runs
    torch.cuda.empty_cache()
    emit("agree", arch="zamba2-7b", measure="||pallas - xla|| / ||xla||",
         results=out)


def agree_serving(arch: str, model, master, batch, next_toks, max_seq: int,
                  runs, states, bound_bf16: bool = True) -> dict:
    """Kernel path (attn_impl=pallas) against eager path (xla) of one
    model on the same weights, inputs and decode tokens, for each
    (compute, kv cache) of ``runs``: prefill logits, the logits of each
    decode step (every run decodes ``next_toks``, so no run's own argmax
    sends it elsewhere) and the tensors ``states(cache)`` names after the
    last step.  Both are measured on the card in this run beside a floor:
    random weights at the reference's initialisation amplify a rounding
    step through the blocks (at xlstm-1.3b's width one mLSTM block moves
    its output ~1e-4 under a 1e-7 move of its input).  f32 is held to
    1e-3, or to ``AGREE_TRAIN_FLOORS`` times the distance the eager path
    moves when every parameter moves by one rounding unit (the two paths
    differ by summation order); bf16 to 2e-2, or, where bf16 rounding
    alone moves the eager path further than 1e-2 from its own f32
    result, to twice that distance.  With ``bound_bf16`` false the bf16
    differences are reported beside that distance, not bounded (at a
    depth where bf16 rounding decorrelates the eager path from its own
    f32 result, no bound is left to hold)."""
    from repro_torch.core.params import default_config
    from repro_torch.runtime.loops import tree_map
    gen = torch.Generator(device="cuda").manual_seed(2)

    def one_ulp(t):
        signs = torch.randint(0, 2, t.shape, generator=gen,
                              device=t.device, dtype=torch.int8) * 2 - 1
        return t * (1 + 2.0 ** -23 * signs)

    def run(compute, kv, impl, weights=master):
        rt = default_config(compute_dtype=compute, kv_cache_dtype=kv,
                            attn_impl=impl)
        params = model.cast_params(weights, rt)
        with torch.no_grad():
            logits, cache = model.prefill_fn(params, batch, rt,
                                             max_seq=max_seq)
            out = {"prefill_logits": logits}
            for i in range(next_toks.shape[1]):
                logits, cache = model.decode_fn(params, cache,
                                                next_toks[:, i:i + 1], rt)
                out[f"decode_logits_{i}"] = logits
        torch.cuda.synchronize()
        out.update(states(cache))
        if not all(bool(torch.isfinite(t).all()) for t in out.values()):
            raise AssertionError(f"agree {arch}: non-finite output "
                                 f"({compute}/{kv} {impl})")
        return out

    eager32 = run("float32", "float32", "xla")
    moved = run("float32", "float32", "xla", tree_map(one_ulp, master))
    floor = {n: _rel(moved[n], eager32[n]) for n in eager32}
    del moved
    res = {"f32_one_ulp_floor": floor}
    for compute, kv in runs:
        kernel = run(compute, kv, "pallas")
        eager = eager32 if compute == "float32" else run(compute, kv, "xla")
        rels = {n: _rel(kernel[n], eager[n]) for n in eager}
        if compute == "float32":
            tols = {n: max(1e-3, AGREE_TRAIN_FLOORS * floor[n])
                    for n in rels}
        else:
            drift = {n: _rel(eager[n], eager32[n]) for n in rels}
            tols = {n: max(2e-2, 2 * drift[n]) if bound_bf16 else None
                    for n in rels}
        key = f"{compute}/{kv}"
        res[key] = {n: {"rel": rels[n], "tolerance": tols[n]} for n in rels}
        if compute != "float32":
            for n in rels:
                res[key][n]["bf16_drift"] = drift[n]
        bad = {n: r for n, r in rels.items()
               if tols[n] is not None and r > tols[n]}
        if bad:
            raise AssertionError(f"agree {arch} {key}: relative differences "
                                 f"{bad} over {tols}")
    return res


def phase_agree_xlstm() -> None:
    """xlstm-1.3b at full width (d 2048, 4 heads of 512, chunk 256):
    kernel path against eager path (``agree_serving``) at a prompt of
    (4, 1024) and 4 decode steps, f32 and bf16; the states compared are
    every mLSTM and sLSTM state.  The only kernel on this path is
    rmsnorm.  Two cuts: one mLSTM and one sLSTM block (layout [1:1]),
    every number bounded; and one group of the published layout (7 mLSTM
    blocks, then an sLSTM block), f32 bounded, bf16 reported beside its
    drift (bf16 rounding decorrelates the eager path from its own f32
    result over the group: ~100 %)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    full = get_config("xlstm-1.3b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, full.vocab, (4, 1028), generator=gen,
                           device="cuda", dtype=torch.int32)
    out = {}
    for label, cut, bound_bf16 in (
            ("2 blocks (1 mLSTM, 1 sLSTM)",
             {"n_layers": 2, "slstm_every": 2}, True),
            ("8 blocks (7 mLSTM, 1 sLSTM)", {"n_layers": 8}, False)):
        cfg = full.replace(**cut)
        model = build_model(cfg)
        master = model.init(0, device="cuda")
        mpg = cfg.slstm_every - 1

        def states(cache):
            if cache["pos"] != 1028 or tuple(cache["m_h"].shape) != (
                    1, mpg, 4, 4, 512, 512):
                raise AssertionError(f"agree xlstm: bad state "
                                     f"{cache['m_h'].shape} at "
                                     f"{cache['pos']}")
            return {"m_h": cache["m_h"], "m_n": cache["m_n"],
                    **{f"s_{n}": t for n, t in zip("cnmh", cache["s"])}}
        out[label] = agree_serving(
            "xlstm-1.3b", model, master, {"tokens": tokens[:, :1024]},
            tokens[:, 1024:], 1028,
            (("float32", "float32"), ("bfloat16", "bfloat16")), states,
            bound_bf16)
        del master
        torch.cuda.empty_cache()
    emit("agree_xlstm", arch="xlstm-1.3b",
         measure="||pallas - xla|| / ||xla||", results=out)


def phase_agree_encdec() -> None:
    """seamless-m4t-medium at full width (d 1024, 16 heads of 64, vocab
    256,206): kernel path against eager path (``agree_serving``) with
    seeded standard-normal frames (4, 256, 1024) and a prompt of (4,
    1024), 4 decode steps, in f32, bf16 and bf16 with an int8 self cache;
    the states compared are the self cache (dequantised) and the cross
    K/V.  Two cuts: 1 encoder and 1 decoder layer, every number bounded;
    2 + 2 layers, f32 bounded, bf16 reported beside its drift (~100 %:
    the encoder's nearly one-hot softmax over 256 frames)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import dequantize_kv
    from repro_torch.models.model import build_model
    full = get_config("seamless-m4t-medium")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, full.vocab, (4, 1028), generator=gen,
                           device="cuda", dtype=torch.int32)
    frames = torch.randn((4, 256, full.d_model), generator=gen,
                         device="cuda")
    out = {}
    for layers, bound_bf16 in ((1, True), (2, False)):
        cfg = full.replace(n_layers=layers, enc_layers=layers)
        model = build_model(cfg)
        master = model.init(0, device="cuda")

        def states(cache):
            kv = cache["self"]
            if cache["pos"] != 1028 or tuple(kv["k"].shape) != (
                    layers, 4, 1088, 16, 64) or tuple(
                    cache["cross_k"].shape) != (layers, 4, 256, 16, 64):
                raise AssertionError(f"agree encdec: bad cache "
                                     f"{kv['k'].shape} "
                                     f"{cache['cross_k'].shape}")
            return {"k_cache": dequantize_kv(kv["k"], kv.get("k_scale"),
                                             torch.float32),
                    "v_cache": dequantize_kv(kv["v"], kv.get("v_scale"),
                                             torch.float32),
                    "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"]}
        out[f"{layers} + {layers} layers"] = agree_serving(
            "seamless-m4t-medium", model, master,
            {"tokens": tokens[:, :1024], "frames": frames},
            tokens[:, 1024:], 1088,
            (("float32", "float32"), ("bfloat16", "bfloat16"),
             ("bfloat16", "int8")), states, bound_bf16)
        del master
        torch.cuda.empty_cache()
    emit("agree_encdec", arch="seamless-m4t-medium",
         frames="standard normal (4, 256, 1024)",
         measure="||pallas - xla|| / ||xla||", results=out)


# the near-tie margin of a routing comparison between the kernel path and
# the eager path, relative to the k-th gate: in f32 the two differ by
# summation order (~1e-6 of a logit); in bf16 by design (the eager
# attention rounds its probabilities to bf16), about 1e-2 of a logit
MOE_MARGIN = {"float32": 1e-3, "bfloat16": 5e-2}


def routing_flips(routes_a: list, routes_b: list, k: int, margin: float,
                  batch: int) -> dict:
    """Compare two runs' routing call by call (``moe._route``'s gates and
    top-k indices with the call's layer, one call per layer, a prefill
    pass and then decode passes): a token whose chosen experts differ is
    a flip.  A flip is ``downstream`` when the token's input may already
    differ by a whole expert's output: a token at or before it in its
    sequence flipped at an earlier layer of the same pass (causal
    attention carries the flipped token's state to every later token,
    whole where the softmax is nearly one-hot, as at the reference's
    initialisation), or, in a decode pass, any prompt token of its
    sequence flipped at an earlier layer of the prefill (the cache
    carries it).  Any other flip is ``near`` when the gap between its
    k-th and (k+1)-th gate, in either run, is below ``margin`` times the
    k-th, else ``far``.  Counts per call, in call order."""
    def gap(g):
        top = g.topk(k + 1, dim=-1).values
        return (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    calls, prefill, earlier = [], {}, []
    for (ga, ia, layer), (gb, ib, _) in zip(routes_a, routes_b):
        S = ia.shape[0] // batch
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        diff = diff.view(batch, S)
        if layer == 0:
            earlier = []
        tainted = torch.zeros_like(diff)
        for f in earlier:                    # this pass, earlier layers
            tainted |= f.cummax(dim=1).values
        if S == 1:                           # decode: the prompt's flips
            for lay, f in prefill.items():
                if lay < layer:
                    tainted |= f.any(dim=1, keepdim=True)
        g = torch.minimum(gap(ga), gap(gb)).view(batch, S)
        down = diff & tainted
        near = diff & ~tainted & (g < margin)
        far = diff & ~tainted & ~near
        calls.append({"layer": layer, "tokens": batch * S,
                      "flips": int(diff.sum()), "near": int(near.sum()),
                      "downstream": int(down.sum()), "far": int(far.sum()),
                      "largest_near_gap": float(g[near].max())
                      if bool(near.any()) else 0.0,
                      "far_gaps": [float(x) for x in g[far][:8]]})
        earlier.append(diff)
        if S > 1:
            prefill[layer] = diff
    return {"calls": calls,
            **{n: sum(c[n] for c in calls)
               for n in ("tokens", "flips", "near", "downstream", "far")}}


def moe_plain(mp, x, cfg, rt):
    """The MoE FFN expert by expert, as its definition reads: the router's
    choices (``moe._route``), then for each expert the rows that chose it
    in any slot, its FFN on them, each row's result weighted by its gate
    in a (T, k, d) buffer summed over k in slot order."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import moe
    xt = x.reshape(-1, x.shape[-1])
    gv, gi, aux = moe._route(xt, L.cast(mp["router"], rt), cfg)
    T, k = gi.shape
    out = torch.zeros(T, k, xt.shape[1], dtype=xt.dtype, device=xt.device)
    for e in range(cfg.n_experts):
        rows, slots = (gi == e).nonzero(as_tuple=True)
        if rows.numel():
            xe = xt[rows]
            h = F.silu(xe @ L.cast(mp["wg"][e], rt)) \
                * (xe @ L.cast(mp["wu"][e], rt))
            out[rows, slots] = h @ L.cast(mp["wd"][e], rt)
    out = out * gv[:, :, None]
    y = out[:, 0]
    for j in range(1, k):
        y = y + out[:, j]
    return y.reshape(x.shape), aux


def phase_agree_moe() -> None:
    """olmoe-1b-7b at full width (d 2048, 64 experts of 1024, top 8, 16
    heads of 128) cut to 2 layers: hand-written kernels (pallas) against
    eager ops (xla) on the same weights, prompt (4, 1024) and next token:
    prefill logits, one decode step's logits, K and V (dequantised).  f32
    within 1e-3; bf16 within 0.1, or twice the eager path's own bf16
    drift from its f32 result where that is larger (as for zamba).

    The routing of the two paths is compared call by call
    (``routing_flips``, margin ``MOE_MARGIN``): a flip is allowed at a
    near-tie and downstream of an earlier flip that attention or the
    cache carries to the token; a flip at a larger gap fails the run.  Then ``moe_mlp`` alone at full width
    on one seeded (4096, 2048) input against ``moe_plain`` (one input, so
    the routing is the same by construction), f32 within 2e-5 and bf16
    within 2e-2, with its host-clock time per call."""
    from repro_torch.configs import get_config
    from repro_torch.core.params import default_config
    from repro_torch.models import moe
    from repro_torch.models.layers import dequantize_kv
    from repro_torch.models.model import build_model
    from repro_torch.runtime.remat import torch_dtype

    full = get_config("olmoe-1b-7b")
    cfg = full.replace(n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 1025), generator=gen,
                           device="cuda", dtype=torch.int32)
    tokens, next_tok = tokens[:, :1024], tokens[:, 1024:]
    model = build_model(cfg)
    master = model.init(0, device="cuda")
    route = moe._route

    def run(compute, kv, impl):
        routes = []

        def recording(xt, router_w, c, mean=None):
            gv, gi, aux = route(xt, router_w, c, mean)
            gates = torch.softmax((xt @ router_w).float(), dim=-1)
            routes.append((gates, gi, len(routes) % cfg.n_layers))
            return gv, gi, aux
        rt = default_config(compute_dtype=compute, kv_cache_dtype=kv,
                            attn_impl=impl)
        params = model.cast_params(master, rt)
        moe._route = recording
        try:
            with torch.no_grad():
                logits, cache = model.prefill_fn(
                    params, {"tokens": tokens}, rt, max_seq=1088)
                logits2, cache = model.decode_fn(params, cache, next_tok, rt)
        finally:
            moe._route = route
        torch.cuda.synchronize()
        lay = cache["layers"]
        if tuple(logits.shape) != (4, 1, 50688) or cache["pos"] != 1025 \
                or tuple(lay["k"].shape) != (2, 4, 1088, 16, 128):
            raise AssertionError(f"agree moe: bad output {logits.shape} "
                                 f"{lay['k'].shape}")
        out = {"prefill_logits": logits, "decode_logits": logits2,
               "k_cache": dequantize_kv(lay["k"], lay.get("k_scale"),
                                        torch.float32),
               "v_cache": dequantize_kv(lay["v"], lay.get("v_scale"),
                                        torch.float32)}
        if not all(bool(torch.isfinite(t).all()) for t in out.values()):
            raise AssertionError(f"agree moe: non-finite output ({impl})")
        return out, routes

    eager32, routes32 = run("float32", "float32", "xla")
    results = {}
    for compute, kv in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("bfloat16", "int8")):
        kernel, kroutes = run(compute, kv, "pallas")
        eager, eroutes = (eager32, routes32) if compute == "float32" \
            else run(compute, kv, "xla")
        rels = {n: _rel(kernel[n], eager[n]) for n in eager}
        if compute == "float32":
            tols = {n: 1e-3 for n in rels}
        else:
            tols = {n: max(0.1, 2 * _rel(eager[n], eager32[n]))
                    for n in rels}
        flips = routing_flips(kroutes, eroutes, cfg.top_k,
                              MOE_MARGIN[compute], batch=4)
        key = f"2 layers {compute}/{kv}"
        results[key] = {"relative": {n: {"rel": rels[n],
                                         "tolerance": tols[n]}
                                     for n in rels},
                        "routing_flips": flips,
                        "margin": MOE_MARGIN[compute]}
        bad = {n: r for n, r in rels.items() if r > tols[n]}
        if bad or flips["far"]:
            raise AssertionError(f"agree moe {key}: relative differences "
                                 f"{bad} over {tols}; routing {flips}")
    del master, eager32, kernel, eager
    torch.cuda.empty_cache()

    # moe_mlp alone at full width, one seeded input, against the plain
    # expert-by-expert version
    mp = {k: v[0] for k, v in
          build_model(full.replace(n_layers=1)).init(
              2, device="cuda")["blocks"]["moe"].items()}
    x32 = _randn(gen, (4, 1024, full.d_model), torch.float32)
    alone = {}
    for compute, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        rt = default_config(compute_dtype=compute)
        x = x32.to(torch_dtype(compute))
        with torch.no_grad():
            y, aux = moe.moe_mlp(mp, x, full, rt, None)
            yp, auxp = moe_plain(mp, x, full, rt)
            err = check(f"moe_mlp {compute} (4096, 2048)", y, yp, tol)
            if float(aux) != float(auxp):
                raise AssertionError(f"moe_mlp {compute}: aux {aux} vs "
                                     f"{auxp}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                moe.moe_mlp(mp, x, full, rt, None)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 5
        alone[compute] = {"max_abs_err": err, "tolerance": tol,
                          "ms_host_clock": ms, "aux": float(aux)}
    del mp
    torch.cuda.empty_cache()
    emit("agree_moe", arch="olmoe-1b-7b", layers=2,
         measure="||pallas - xla|| / ||xla||", results=results,
         moe_mlp_alone=alone)


def _named_leaves(tree, prefix: str = "") -> list:
    """``[(path, tensor)]`` in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


# the agreement's relative tolerance, and the multiple of f32's own
# one-rounding floor that replaces it where that floor lies above it
AGREE_TRAIN_TOL, AGREE_TRAIN_FLOORS = 1e-4, 5


def agree_train(cfg, shape, device: str = "cuda", draws: int = 4) -> dict:
    """One train step on the card against the same step on the CPU:
    ``cfg``'s parameters from seed 0, the data pipeline's batch 0 of
    ``shape``, f32 compute (TF32 off), remat none, AdamW at a constant
    learning rate of 1e-2 with eps 1e-3: the CPU parity tests' optimizer
    (tests/test_torch_train.py).  At the default eps of 1e-8 a first
    update is about lr·sign(g) whatever the gradient's size, so it would
    hold signs, not values; at 1e-3 it is a smooth function of the
    clipped gradient.

    The loss is held to 1e-5 relative, the global gradient norm, each
    parameter's gradient (the one the step hands its optimizer) and the
    update of the parameters (after the step minus before, every leaf),
    in the relative Frobenius norm, to ``AGREE_TRAIN_TOL`` (1e-4); each
    of them, where f32's own floor at this point lies above a
    ``AGREE_TRAIN_FLOORS``-th of its bound, to ``AGREE_TRAIN_FLOORS``
    times the floor.  The floor is measured on the card, for each of
    these numbers on its own: the same step with every parameter moved
    by one rounding unit (2^-23 relative, random signs, ``draws``
    draws), against the unmoved step.  At the reference's initialisation
    the attention logits have a standard deviation of about 110 at
    smollm-135m's shapes and ~340 at llava-next-34b's (the attention
    projections take their fan-in from the head axis), so the softmax is
    nearly one-hot and one rounding unit at the inputs can move a
    gradient by more than 1e-4; in an MoE it also flips routing
    decisions.  A CPU that rounds differently at every operation cannot
    come closer than that floor.  The card's results stay on the card
    and the CPU's on the host until each leaf is compared: at full width
    a family's step holds ~2e9 parameters, and the host holds one CPU
    step with its optimizer state."""
    from repro_torch.core.params import default_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import (Optimizer, constant_schedule,
                                              make_optimizer)
    from repro_torch.runtime.loops import tree_leaves, tree_map
    from repro_torch.runtime.stepfn import build_train_step
    # remat none: the same numbers as any policy, without the recompute
    rt = default_config(attn_impl="xla", remat_policy="none")
    optimizer = make_optimizer(cfg.optimizer, constant_schedule(1e-2),
                               eps=1e-3)
    handed = {}

    def update(grads, state, params, inplace=False):
        handed["grads"] = tree_leaves(grads)
        return optimizer.update(grads, state, params, inplace=inplace)
    bundle = build_train_step(cfg, shape, rt, None,
                              Optimizer(optimizer.init, update))
    master = build_model(cfg).init(0, device=device)
    names = [n for n, _ in _named_leaves(master)]
    gen = torch.Generator(device=device)

    def one_ulp(t):
        signs = torch.randint(0, 2, t.shape, generator=gen,
                              device=t.device, dtype=torch.int8) * 2 - 1
        return t * (1 + 2.0 ** -23 * signs)

    def moved(seed):
        """The parameters moved by one rounding unit, the same each call
        (made again for a floor's update, not held beside its step)."""
        def make():
            gen.manual_seed(seed)
            return tree_map(one_ulp, master)
        return make

    def step(dev, params, before):
        """The step on ``dev`` from ``params`` (a tree of its own there,
        which the step updates in place) -> (loss, gradient norm,
        gradients, update), the tensors on ``dev``; ``before()`` gives
        the starting parameters again for the update."""
        batch = SyntheticLM(cfg, shape, rt, dev).batch_at(0)
        new, state, met = bundle.fn(params, optimizer.init(params), batch)
        del state, batch, params
        # the step updates its parameters in place (donate_buffers):
        # after minus before, in place
        update = [a.sub_(b.to(dev)) for a, b in zip(tree_leaves(new),
                                                    tree_leaves(before()))]
        return (float(met["loss"]), float(met["grad_norm"]),
                handed.pop("grads"), update)

    def copy_to(dev):
        return tree_map(lambda t: t.to(dev, copy=True), master)

    def fro(xs, ys):
        sq = lambda t: float(torch.linalg.vector_norm(
            t.flatten(), dtype=torch.float64)) ** 2
        diff = sum(sq(x.to(y.device) - y) for x, y in zip(xs, ys))
        norm = sum(sq(y) for y in ys)
        return (diff / norm) ** 0.5 if norm else diff ** 0.5

    def rel(a, b):
        (la, ga, da, ua), (lb, gb, db, ub) = a, b
        return {"loss": abs(la - lb) / abs(lb),
                "grad_norm": abs(ga - gb) / abs(gb),
                "update_frobenius": fro(ua, ub),
                "grad": {n: fro([x], [y]) for n, x, y in zip(names, da, db)}}

    seconds, t0 = {}, time.time()
    card = step(device, copy_to(device), lambda: master)
    seconds["card_step"] = time.time() - t0
    if not all(bool(torch.isfinite(t).all()) for t in card[2] + card[3]) \
            or not torch.isfinite(torch.tensor(card[:2])).all():
        raise AssertionError(f"agree_train {cfg.name}: non-finite output "
                             "on the card")
    floors = [rel(step(device, moved(1 + i)(), moved(1 + i)), card)
              for i in range(draws)]
    seconds["floors"] = time.time() - t0 - seconds["card_step"]
    cpu = step("cpu", copy_to("cpu"), lambda: master)
    got = rel(cpu, card)
    seconds["cpu_step"] = time.time() - t0 - sum(seconds.values())

    def tol(floor, bound=AGREE_TRAIN_TOL):
        return max(bound, AGREE_TRAIN_FLOORS * floor)
    floor = {k: max(f[k] for f in floors)
             for k in ("loss", "grad_norm", "update_frobenius")}
    floor["grad"] = {n: max(f["grad"][n] for f in floors) for n in names}
    tols = {"loss": tol(floor["loss"], 1e-5),
            "grad_norm": tol(floor["grad_norm"]),
            "update_frobenius": tol(floor["update_frobenius"]),
            "grad": {n: tol(f) for n, f in floor["grad"].items()}}
    over = [(k, got[k], tols[k]) for k in ("loss", "grad_norm",
                                           "update_frobenius")
            if got[k] > tols[k]]
    over += [(f"grad {n}", got["grad"][n], tols["grad"][n]) for n in names
             if got["grad"][n] > tols["grad"][n]]
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "batch": [shape.global_batch, shape.seq_len], "lr": 1e-2,
           "eps": 1e-3, "loss": {"cuda": card[0], "cpu": cpu[0]},
           "grad_norm": {"cuda": card[1], "cpu": cpu[1]},
           "relative": got, "one_ulp_floor": floor, "tolerance": tols,
           "draws": draws, "seconds": dict(seconds, all=time.time() - t0)}
    del master, card, cpu, floors
    torch.cuda.empty_cache()
    if over:
        raise AssertionError(f"agree_train {cfg.name}: over tolerance: "
                             f"{over}; {json.dumps(out)}")
    return out


def phase_agree_train(device: str = "cuda") -> None:
    """``agree_train`` on smollm-135m's seeded parameters cut to 2 layers
    at full width, a (1, 256) batch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    emit("agree_train", **agree_train(
        get_config("smollm-135m").replace(n_layers=2),
        ShapeConfig("agree_train", 256, 1, "train"), device))


def _train_run(argv: list) -> tuple:
    """``launch/train.py`` in this process (its launches reach the
    counters) -> (exit code, {step: logged numbers}, output lines)."""
    import contextlib
    import io

    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    lines = buf.getvalue().splitlines()
    steps = {}
    for line in lines:
        f = line.split()
        if f and f[0] == "step" and len(f) == 9:
            steps[int(f[1])] = {"loss": float(f[3]), "grad_norm": float(f[5]),
                                "lr": float(f[7]), "ms": float(f[8][:-2])}
    return rc, steps, lines


TRAIN_ARGS = ["--arch", "smollm-135m", "--seq", "2048", "--batch", "4",
              "--log-interval", "1", "--ckpt-interval", "6",
              "--device", "cuda"]


def train_busy_share(steps: int = 2) -> dict:
    """The train step of ``TRAIN_ARGS`` traced by ``torch.profiler`` over
    ``steps`` steps after one untimed step: device-busy share (the sum of
    the device kernels' time over the traced window's host time) and the
    kernels that take the most device time."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
    from repro_torch.runtime.stepfn import build_train_step
    cfg = get_config("smollm-135m")
    shape = ShapeConfig("cli", 2048, 4, "train")
    rt = default_config(compute_dtype="bfloat16", remat_policy="none")
    optimizer = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 10, 12))
    bundle = build_train_step(cfg, shape, rt, None, optimizer)
    params = build_model(cfg).init(0, device="cuda")
    state = [params, optimizer.init(params)]
    data = SyntheticLM(cfg, shape, rt, "cuda")
    batches = [data.batch_at(i) for i in range(steps + 1)]

    def step(i):
        state[0], state[1], _ = bundle.fn(state[0], state[1], batches[i])

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    del state, batches, bundle
    torch.cuda.empty_cache()
    return {"steps": steps, "wall_ms_traced": wall_ms,
            "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "kernels": [{"name": k[:90], "device_ms": t, "calls": c}
                        for k, t, c in rows[:10]],
            "median_kernel_ms": statistics.median(r[1] for r in rows)}


# the run whose loss must fall: at the reference's initialisation (the
# attention logits' standard deviation about 110, a nearly one-hot
# softmax) twelve steps at the default learning rate move the loss by
# batch noise only, so learning is shown over forty steps at 3e-3
LEARN_STEPS, LEARN_LR = 40, "3e-3"


def phase_train(root: pathlib.Path) -> dict:
    """``launch/train.py`` at full smollm-135m width and depth, seq 2048,
    batch 4, bf16 compute: 12 steps with a checkpoint every 6 in one
    directory; then, in a fresh directory, 6 steps and a second run of 12
    that resumes from the checkpoint of step 5; then ``LEARN_STEPS``
    steps at ``LEARN_LR``.  Every loss is finite, the mean loss of the
    last 5 steps of the long run is below that of its first 5, and the
    resumed run's step-12 loss is within 1e-3 relative of the
    uninterrupted run's (not bit for bit: the embedding's gradient is
    summed by atomics on the card).  Reports ms per step (median of steps
    2-12), tokens per second, peak device memory and the step's
    device-busy share."""
    import statistics
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc, straight, _ = _train_run(TRAIN_ARGS + [
        "--steps", "12", "--ckpt-dir", str(root / "straight")])
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    rc1, first, _ = _train_run(TRAIN_ARGS + [
        "--steps", "6", "--ckpt-dir", str(root / "resumed")])
    rc2, resumed, lines = _train_run(TRAIN_ARGS + [
        "--steps", "12", "--ckpt-dir", str(root / "resumed")])
    if (rc, rc1, rc2) != (0, 0, 0):
        raise AssertionError(f"train: exit codes {(rc, rc1, rc2)}")
    if sorted(straight) != list(range(12)) or sorted(first) != \
            list(range(6)) or sorted(resumed) != list(range(6, 12)):
        raise AssertionError(f"train: logged steps {sorted(straight)}, "
                             f"{sorted(first)}, {sorted(resumed)}")
    if "resuming from step 5" not in lines:
        raise AssertionError("train: the second run did not resume from "
                             "step 5")
    losses = [r["loss"] for run in (straight, first, resumed)
              for r in run.values()]
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train: non-finite loss in {losses}")
    rcl, longer, _ = _train_run(TRAIN_ARGS + [
        "--steps", str(LEARN_STEPS), "--lr", LEARN_LR, "--ckpt-interval",
        "0", "--ckpt-dir", str(root / "learn")])
    first5 = sum(longer[s]["loss"] for s in range(5)) / 5
    last5 = sum(longer[s]["loss"] for s in range(LEARN_STEPS - 5,
                                                 LEARN_STEPS)) / 5
    if rcl != 0 or not last5 < first5:
        raise AssertionError(f"train: the loss did not fall over "
                             f"{LEARN_STEPS} steps: mean of the first 5 "
                             f"{first5}, of the last 5 {last5}")
    rel = abs(resumed[11]["loss"] - straight[11]["loss"]) \
        / abs(straight[11]["loss"])
    if rel > 1e-3:
        raise AssertionError(f"train: resumed step-12 loss "
                             f"{resumed[11]['loss']} against "
                             f"{straight[11]['loss']} ({rel} relative)")
    ms = statistics.median(straight[s]["ms"] for s in range(1, 12))
    ms_resumed = statistics.median(resumed[s]["ms"] for s in range(7, 12))
    return {"steps": straight, "resumed_steps": resumed,
            "loss_step_1": straight[0]["loss"],
            "loss_step_12": straight[11]["loss"],
            "learn": {"steps": LEARN_STEPS, "lr": LEARN_LR,
                      "losses": [longer[s]["loss"] for s in sorted(longer)],
                      "mean_first_5": first5, "mean_last_5": last5},
            "resumed_loss_step_12": resumed[11]["loss"],
            "resumed_relative": rel, "ms_per_step": ms,
            "ms_per_step_resumed": ms_resumed,
            "tokens_per_s": 4 * 2048 / (ms / 1e3),
            "peak_bytes": peak, "wall_s": wall,
            "busy": train_busy_share()}


# the families trained beside smollm-135m, at full width and the depths
# one card's memory holds in f32 with AdamW (16 bytes a parameter):
# (arch, the agreement's config overrides, agreement batch (B, S), the
# timed steps' overrides, timed batch (B, S)).  Timed: olmoe-1b-7b 4 of
# 16 layers, ~1.9e9 parameters; llava-next-34b 2 of 60 layers (d 7168,
# 576 frontend tokens), ~2.0e9; zamba2-7b one group of two Mamba2
# blocks, the shared block and a remainder block, as in
# phase_agree_zamba; xlstm-1.3b at 16 of 48 blocks (two groups of
# seven mLSTM blocks and an sLSTM block: the cut that pays for the mesh
# phase) and seamless-m4t-medium (0.88e9) at full depth.  olmoe's
# agreement runs at 1 layer (its CPU
# step took 38-48 s at 4, and the smoke is to end within 900 s); llava's
# stays at 2 (at 1 its card and CPU steps differed past five times the
# floor).  An agreement batch holds one
# sequence (its CPU step takes the time), the vlm's 576 frontend
# positions and 64 of text
TRAIN_FAMILIES = (
    ("olmoe-1b-7b", {"n_layers": 1}, (1, 256), {"n_layers": 4}, (4, 1024)),
    ("llava-next-34b", {"n_layers": 2}, (1, 640), {"n_layers": 2},
     (2, 2048)),
    ("zamba2-7b", {"n_layers": 3, "attn_every": 2}, (1, 256),
     {"n_layers": 3, "attn_every": 2}, (4, 1024)),
    # the timed steps: xlstm at a third of its depth and 256 positions,
    # one full chunk; seamless at full depth.  The agreement at one mLSTM
    # and one sLSTM block: over a group of 8 the gradient norm is ~8e5
    # and one rounding unit moves it more than 100 %, so no bound is left
    # there
    ("xlstm-1.3b", {"n_layers": 2, "slstm_every": 2}, (1, 256),
     {"n_layers": 16}, (4, 256)),
    ("seamless-m4t-medium", {"n_layers": 2, "enc_layers": 2}, (1, 256), {},
     (4, 1024)),
)
TRAIN_TIMED_STEPS = 2


def train_steps_timed(cfg, batch: tuple) -> dict:
    """A few train steps of ``build_train_step`` on the card, bf16 compute,
    remat none, the default AdamW schedule, after one untimed step: ms
    per step (host clock around a step and a synchronize; the median),
    tokens per second and peak device memory.  Every loss finite."""
    import statistics

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
    from repro_torch.runtime.stepfn import build_train_step
    B, S = batch
    shape = ShapeConfig("train_families", S, B, "train")
    rt = default_config(compute_dtype="bfloat16", remat_policy="none")
    optimizer = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 10, 20))
    bundle = build_train_step(cfg, shape, rt, None, optimizer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(0, device="cuda")
    state = optimizer.init(params)
    data = SyntheticLM(cfg, shape, rt, "cuda")
    ms, losses = [], []
    for i in range(TRAIN_TIMED_STEPS + 1):
        batch_i = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = bundle.fn(params, state, batch_i)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    if not all(l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"train_families {cfg.name}: losses {losses}")
    peak = torch.cuda.max_memory_allocated()
    del params, state, bundle
    torch.cuda.empty_cache()
    med = statistics.median(ms)
    return {"batch": [B, S], "compute": "bfloat16", "remat": "none",
            "ms_per_step": med, "ms": ms, "tokens_per_s": B * S / (med / 1e3),
            "peak_bytes": peak, "losses": losses}


def phase_train_families(root: pathlib.Path) -> dict:
    """For each of ``TRAIN_FAMILIES``: ``agree_train`` (card against CPU,
    f32) at its cut depth, then ``train_steps_timed``.  The train step
    launches no kernel (the kernels are forward-only)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    out = {}
    for arch, cut, (ab, asq), timed_cut, timed in TRAIN_FAMILIES:
        agree = agree_train(get_config(arch).replace(**cut),
                            ShapeConfig("agree_train", asq, ab, "train"))
        out[arch] = {"cut": cut, "agree": agree, "timed_cut": timed_cut,
                     "timed": train_steps_timed(
                         get_config(arch).replace(**timed_cut), timed)}
        emit("train_family", **out[arch])
    return {"families": list(out)}


def phase_serve(arch: str, gen_tokens: int) -> dict:
    """The serve CLI at B 4, prompt 1024, with a bf16 and an int8 cache;
    the ssm family's state is fixed-size and f32, so a cache dtype
    reaches nothing there and it serves once."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    expect = {"prefills": 0, "decode_steps": 0}
    ssm = get_config(arch).family == "ssm"
    for kv in ("bfloat16",) if ssm else ("bfloat16", "int8"):
        t0 = time.time()
        rc = serve.main(["--arch", arch, "--batch", "4",
                         "--prompt-len", "1024", "--gen-tokens",
                         str(gen_tokens), "--kv-dtype", kv,
                         "--attn-impl", "pallas"])
        if rc != 0:
            raise AssertionError(f"serve.main returned {rc}")
        expect["prefills"] += 1
        expect["decode_steps"] += gen_tokens - 1
        torch.cuda.empty_cache()
        emit("serve", arch=arch, kv_cache=kv,
             seconds=round(time.time() - t0, 3))
    return expect


def phase_scheduler(arch: str, spec, max_seq: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.params import default_config
    from repro_torch.kernels.tiling import fit_block
    from repro_torch.models.model import build_model
    from repro_torch.serving import traffic
    from repro_torch.serving.scheduler import BatchScheduler, Request

    trace = traffic.generate(spec)
    n = len(trace.requests)
    cfg = get_config(arch)
    rt = default_config(compute_dtype="bfloat16", kv_cache_dtype="int8",
                        attn_impl="pallas")
    wave_size = 4
    # the f32 master tree lives only as this argument: it is dropped
    # once the scheduler has cast it
    sched = BatchScheduler(cfg, rt, build_model(cfg).init(0, device="cuda"),
                           wave_size=wave_size, max_seq=max_seq)
    for r in trace.requests:
        sched.submit(Request(rid=r.rid, tokens=traffic.request_tokens(r),
                             max_new_tokens=r.max_new_tokens))
    t0 = time.time()
    done = sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.time() - t0
    if len(done) != n:
        raise AssertionError(f"scheduler: {len(done)} of {n} requests done")
    expect = {"prefills": 0, "decode_steps": 0}
    waves = []
    for i in range(0, n, wave_size):
        wave = trace.requests[i:i + wave_size]
        S = max(r.prompt_len for r in wave)
        expect["prefills"] += 1
        expect["decode_steps"] += min(
            max(r.max_new_tokens for r in wave) - 1, max_seq - S - 1)
        # the SSM chunk the reference would fit to this wave's padded
        # length (the kernel runs its own chunk whatever it is)
        waves.append({"padded_prompt": S, "ssm_fitted_chunk": fit_block(
            cfg.ssm_chunk, S) if cfg.family == "hybrid" else None})
    for req, r in zip(done, trace.requests):
        if len(req.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab + 512 for t in req.generated):
            raise AssertionError(f"scheduler: request {req.rid} generated "
                                 f"{len(req.generated)} of "
                                 f"{r.max_new_tokens} tokens")
    emit("scheduler", arch=arch, trace=trace.key(), wall_s=round(wall, 3),
         waves=waves, decode_steps=expect["decode_steps"],
         summary=sched.metrics.summary())
    del sched
    torch.cuda.empty_cache()
    return expect


# decode steps of the serve profile's timed and traced windows: the
# profiler's summary of an MoE decode step (~4,500 launches) takes seconds
PROFILE_STEPS = 6


def phase_serve_profile(arch: str) -> dict:
    """``scripts/profile_torch_serve.profile``: one prefill (B 4, prompt
    1024) and ``PROFILE_STEPS`` decode steps timed on the host clock, then
    traced:
    prefill and decode ms, tokens per second, the device-busy share of
    each, the kernels by device time and the serving peak memory.
    Returns its prefills and decode steps for the launch counts."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_torch_serve import profile
    rep = profile(arch, steps=PROFILE_STEPS)
    emit("serve_profile", **rep)
    return {"prefills": rep["prefills"], "decode_steps": rep["decode_steps"]}


def counters() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssm_scan import ops as ssm
    return {"rmsnorm": rms, "flash_attention": fa, "flash_decode": fd,
            "ssm_scan": ssm}


def launches_per_unit(cfg) -> tuple:
    """Kernel launches of one prefill and of one decode step, derived
    from the model's path."""
    if cfg.family in ("dense", "moe", "vlm"):
        # the transformer backbone (the MoE FFN launches no kernel of
        # these): prefill norms ln1 twice a block (once for the K/V that go to the
        # cache, once inside the block), ln2 once, and the stack once at
        # the end; a decode step norms ln1 and ln2 once each and the stack
        n = cfg.n_layers
        return ({"rmsnorm": 3 * n + 1, "flash_attention": n,
                 "flash_decode": 0, "ssm_scan": 0},
                {"rmsnorm": 2 * n + 1, "flash_attention": 0,
                 "flash_decode": n, "ssm_scan": 0})
    if cfg.family == "ssm":
        # xlstm: every block (mLSTM and sLSTM) norms its input once, in
        # prefill and in a decode step, and the stack once at the end;
        # no attention and no SSD scan (the mLSTM's chunked form is eager)
        n = cfg.n_layers
        return ({"rmsnorm": n + 1, "flash_attention": 0, "flash_decode": 0,
                 "ssm_scan": 0},
                {"rmsnorm": n + 1, "flash_attention": 0, "flash_decode": 0,
                 "ssm_scan": 0})
    if cfg.family == "encdec":
        # each encoder layer norms ln1 and ln2 and the encoder once at the
        # end; in prefill each decoder layer norms ln1 twice (the cached
        # K/V, then inside the block), lnx and ln2 once, the stack once;
        # its causal self-attention is the kernel, the encoder's
        # (non-causal) and the cross-attention are eager.  A decode step
        # norms ln1, lnx and ln2 once a layer and the stack once
        n, e = cfg.n_layers, cfg.enc_layers
        return ({"rmsnorm": 4 * n + 2 * e + 2, "flash_attention": n,
                 "flash_decode": 0, "ssm_scan": 0},
                {"rmsnorm": 3 * n + 1, "flash_attention": 0,
                 "flash_decode": n, "ssm_scan": 0})
    # hybrid: every Mamba2 block norms its input and its gated output and
    # scans once in prefill; each of the g shared-block invocations norms
    # ln1 twice (cached K/V, then inside the block) and ln2 once in
    # prefill, ln1 and ln2 once in a decode step; the stack once at the end
    n, g = cfg.n_layers, cfg.n_layers // cfg.attn_every
    return ({"rmsnorm": 2 * n + 3 * g + 1, "flash_attention": g,
             "flash_decode": 0, "ssm_scan": n},
            {"rmsnorm": 2 * n + 2 * g + 1, "flash_attention": 0,
             "flash_decode": g, "ssm_scan": 0})


def phase_launches(arch: str, expects: list) -> dict:
    from repro_torch.configs import get_config
    prefills = sum(e["prefills"] for e in expects)
    steps = sum(e["decode_steps"] for e in expects)
    per_prefill, per_step = launches_per_unit(get_config(arch))
    want = {k: per_prefill[k] * prefills + per_step[k] * steps
            for k in per_prefill}
    got = {name: mod.launches for name, mod in counters().items()}
    emit("launches", arch=arch, counted=got, expected=want,
         prefills=prefills, decode_steps=steps, per_prefill=per_prefill,
         per_decode_step=per_step)
    for name in want:
        if got[name] != want[name] or (want[name] > 0 and got[name] < 1):
            raise AssertionError(f"launches {arch}: {name} counted "
                                 f"{got[name]}, the path implies "
                                 f"{want[name]}")
    return got


def main_paths() -> list:
    """(arch, run function) of each main path: serve CLI runs, then a trace
    through the BatchScheduler."""
    from repro_torch.serving import traffic

    # the registered *_tiny traces are sized for CPU tests; these have
    # prompts and budgets a card is used for
    smollm_trace = traffic.TraceSpec(
        name="poisson_smoke", pattern="poisson", n_requests=16,
        mean_rate=4.0, seed=2024, tenants=(
            traffic.Tenant("chat", 0.6, (128, 512), (32, 64)),
            traffic.Tenant("doc", 0.4, (512, 1024), (16, 48))))
    # two waves padded to ragged prompt lengths (the chunk fit at work)
    zamba_trace = traffic.TraceSpec(
        name="poisson_smoke_hybrid", pattern="poisson", n_requests=8,
        mean_rate=4.0, seed=2025, tenants=(
            traffic.Tenant("chat", 0.5, (128, 1024), (8, 24)),
            traffic.Tenant("doc", 0.5, (512, 1024), (8, 16))))
    # the MoE path: two waves of four at chat and document prompts
    olmoe_trace = traffic.TraceSpec(
        name="poisson_smoke_moe", pattern="poisson", n_requests=8,
        mean_rate=4.0, seed=2026, tenants=(
            traffic.Tenant("chat", 0.5, (128, 1024), (8, 24)),
            traffic.Tenant("doc", 0.5, (512, 1024), (8, 16))))
    # the two last families: two waves of four each
    xlstm_trace = traffic.TraceSpec(
        name="poisson_smoke_xlstm", pattern="poisson", n_requests=8,
        mean_rate=4.0, seed=2027, tenants=(
            traffic.Tenant("chat", 0.5, (128, 1024), (8, 24)),
            traffic.Tenant("doc", 0.5, (512, 1024), (8, 16))))
    seamless_trace = traffic.TraceSpec(
        name="poisson_smoke_encdec", pattern="poisson", n_requests=8,
        mean_rate=4.0, seed=2028, tenants=(
            traffic.Tenant("chat", 0.5, (128, 1024), (8, 24)),
            traffic.Tenant("doc", 0.5, (512, 1024), (8, 16))))
    return [
        ("smollm-135m", lambda: [phase_serve("smollm-135m", 64),
                                 phase_scheduler("smollm-135m", smollm_trace,
                                                 2048)]),
        ("zamba2-7b", lambda: [phase_serve("zamba2-7b", 32),
                               phase_scheduler("zamba2-7b", zamba_trace,
                                               1088)]),
        ("olmoe-1b-7b", lambda: [phase_serve("olmoe-1b-7b", 32),
                                 phase_scheduler("olmoe-1b-7b", olmoe_trace,
                                                 1088),
                                 phase_serve_profile("olmoe-1b-7b")]),
        ("xlstm-1.3b", lambda: [phase_serve("xlstm-1.3b", 32),
                                phase_scheduler("xlstm-1.3b", xlstm_trace,
                                                1088),
                                phase_serve_profile("xlstm-1.3b")]),
        ("seamless-m4t-medium", lambda: [
            phase_serve("seamless-m4t-medium", 32),
            phase_scheduler("seamless-m4t-medium", seamless_trace, 1088),
            phase_serve_profile("seamless-m4t-medium")]),
    ]


# the mesh phase: smollm-135m at full width and depth, bf16, (B, S) and
# decode steps; the train step at the same (B, S) in f32
MESH_ARCH, MESH_BATCH, MESH_DECODE_STEPS = "smollm-135m", (4, 1024), 8
# and the other families served at full width and depth, bf16: (arch,
# (B, prompt), encoder frames, decode steps); xlstm's prompt is one mLSTM
# chunk (its sLSTM runs token by token)
MESH_FAMILIES = (("zamba2-7b", (4, 1024), 0, 4),
                 ("seamless-m4t-medium", (4, 1024), 256, 4),
                 ("xlstm-1.3b", (4, 256), 0, 4))


def _host_ms(fn):
    """(result, host ms of one call with a synchronize after it)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _twice_ms(fn):
    """(result of the second call, [host ms of the first call, of the
    second]): the first call pays one-time costs (DTensor's sharding
    propagation is cached per operator and placements)."""
    _, first = _host_ms(fn)
    out, second = _host_ms(fn)
    return out, [first, second]


def mesh_serve(arch: str, batch: tuple, frames: int, steps: int, mesh,
               device: str = "cuda") -> dict:
    """One family served through DTensors on ``mesh`` (tp rules, bf16,
    the kernels under ``local_map``) against its one-device serve path,
    at full width and depth: a prefill, called twice (first and warm),
    and ``steps`` decode steps fed the tokens the one-device path picks.
    The launch counters are set to 0 just before the sharded calls and
    read right after them (the one-device calls run first).  Returns the
    largest differences (every call's logits, the last cache), the host
    ms of both paths (first call and warm; decode steps 2..n) and the
    launches beside those the path implies; fails on a difference over
    bf16's 2e-2 or on launches the path does not imply."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime import stepfn
    from repro_torch.runtime.loops import tree_leaves
    from repro_torch.runtime.sharding import full_tree, shard_tree
    cfg = get_config(arch)
    B, S = batch
    model = build_model(cfg)
    rt = default_config(compute_dtype="bfloat16", attn_impl="pallas",
                        shard_strategy="tp")
    rules = stepfn.build_rules(mesh, cfg, rt)
    cast = model.cast_params(model.init(0, device=device), rt)
    gen = torch.Generator(device=device).manual_seed(7)
    inputs = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                      device=device, dtype=torch.int32)}
    if frames:
        inputs["frames"] = torch.randn((B, frames, cfg.d_model),
                                       generator=gen, device=device,
                                       dtype=torch.bfloat16)
    max_seq = S + steps
    ms = {}
    with torch.no_grad():
        (lg0, c0), ms["prefill_one_device"] = _twice_ms(
            lambda: model.prefill_fn(cast, inputs, rt, None,
                                     max_seq=max_seq))
        want, feed, dec0 = [lg0], [], []
        for _ in range(steps):
            feed.append(want[-1].argmax(-1).to(torch.int32))
            (lg0, c0), t = _host_ms(
                lambda: model.decode_fn(cast, c0, feed[-1], rt, None))
            dec0.append(t)
            want.append(lg0)
        ms["decode_one_device"] = [dec0[0], sum(dec0[1:]) / (steps - 1)]
        dparams = shard_tree(cast, stepfn._param_specs(model, rules), rules)
        dinputs = shard_tree(inputs, stepfn._batch_specs(
            cfg, ShapeConfig("mesh", S, B, "prefill"), rt, rules), rules)
        for mod in counters().values():
            mod.launches = 0
        (lg1, c1), ms["prefill_mesh"] = _twice_ms(
            lambda: model.prefill_fn(dparams, dinputs, rt, rules,
                                     max_seq=max_seq))
        tol = TOL[torch.bfloat16]
        errs = {"prefill_logits": check(f"mesh {arch} prefill logits",
                                        lg1.full_tensor(), want[0], tol)}
        dec1 = []
        for i, nxt in enumerate(feed):
            (lg1, c1), t = _host_ms(
                lambda: model.decode_fn(dparams, c1, nxt, rt, rules))
            dec1.append(t)
            errs[f"decode_{i}"] = check(f"mesh {arch} decode {i}",
                                        lg1.full_tensor(), want[i + 1], tol)
        launches = {n: mod.launches for n, mod in counters().items()}
        ms["decode_mesh"] = [dec1[0], sum(dec1[1:]) / (steps - 1)]
        strip = lambda c: {k: v for k, v in c.items() if k != "pos"}
        errs["cache"] = max(
            check(f"mesh {arch} cache", a, b, tol) for a, b in zip(
                tree_leaves(full_tree(strip(c1))), tree_leaves(strip(c0))))
        if int(c1["pos"]) != int(c0["pos"]):
            raise AssertionError(f"mesh {arch}: position {c1['pos']} "
                                 f"against {c0['pos']}")
    del c0, c1, lg0, lg1, dparams, cast
    per_prefill, per_step = launches_per_unit(cfg)
    # the sharded prefill runs twice (first and warm)
    expected = {k: 2 * per_prefill[k] + steps * per_step[k]
                for k in per_prefill}
    if device == "cuda":
        torch.cuda.empty_cache()
        if launches != expected:
            raise AssertionError(f"mesh {arch}: launches {launches}, the "
                                 f"path implies {expected}")
    return {"arch": arch, "layers": cfg.n_layers, "batch": [B, S],
            "frames": frames, "decode_steps": steps, "max_abs_err": errs,
            "launches": launches, "expected_launches": expected,
            "host_ms": ms, "dispatch_cost_ms": {
                k: ms[f"{k}_mesh"][1] - ms[f"{k}_one_device"][1]
                for k in ("prefill", "decode")}}


def phase_mesh(device: str = "cuda", cfg=None, batch=MESH_BATCH,
               steps: int = MESH_DECODE_STEPS,
               families=MESH_FAMILIES) -> dict:
    """The sharded path at one rank: a process group of one (NCCL on the
    card, through a ``FileStore`` in a temporary directory) and a (1, 1)
    ``DeviceMesh`` ("data", "model") in this process, smollm-135m at
    full width and depth.

    (a) prefill at ``batch`` with ``ShardingRules(strategy="tp")`` and
    DTensor parameters, the kernels reached through ``local_map``: logits
    and cache against the one-device prefill, bf16's 2e-2; (b) ``steps``
    decode steps the same way (the tokens the one-device path picks);
    (c) one f32 train step on the auto path (DTensors;
    ``stepfn.build_mesh_train_step``, which takes a mesh of one device
    through it) against the one-device step: loss to 1e-5 and the
    updated ``final_norm`` to 1e-4 relative, the bounds of
    ``agree_train``; (d) ``reduce_grads`` and ``reduce_grads_int8_ef``
    over the step's gradients on the group's collectives: f32 gives the
    gradients times the scale bit for bit, bf16 (each leaf, fused, fsdp)
    each gradient rounded through bf16, int8_ef the quantize/dequantize
    round trip to one quantisation step and its residual bit for bit;
    (e) the step's DTensor state saved and restored on one device, bit
    for bit; (f) each of ``families`` served the same way at full width
    and depth (:func:`mesh_serve`: zamba2-7b, whose prefill reaches the
    scan under ``local_map``, seamless-m4t-medium and xlstm-1.3b).  The
    launch counters are set to 0 just before each sharded serve and read
    after its decode steps (the one-device calls that it is compared
    with run first); the path's launches are their sum.  Host ms of
    (a)-(c) and (f), each call's first and warm time (the prefills and
    the train step called twice, decode steps 2..n), beside the
    one-device ms of the same calls: the cost of DTensor dispatch at one
    rank.  A cache split along its sequence (batch 1 on a data axis
    above 1) cannot occur at one rank: the gloo tests hold it."""
    import torch.distributed as dist
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.params import default_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import constant_schedule, make_optimizer
    from repro_torch.runtime import gradsync, stepfn
    from repro_torch.runtime.loops import tree_leaves, tree_map, \
        tree_unflatten
    from repro_torch.runtime.sharding import full_tree, shard_tree
    cfg = cfg or get_config(MESH_ARCH)
    B, S = batch
    on_card = device == "cuda"
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [B, S],
           "decode_steps": steps}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        init_distributed(device, store_path=pathlib.Path(tmp) / "store",
                         rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device)
            out["backend"] = dist.get_backend()
            model = build_model(cfg)
            rt = default_config(compute_dtype="bfloat16", attn_impl="pallas",
                                shard_strategy="tp")
            rules = stepfn.build_rules(mesh, cfg, rt)
            master = model.init(0, device=device)
            cast = model.cast_params(master, rt)
            gen = torch.Generator(device=device).manual_seed(7)
            tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                   device=device, dtype=torch.int32)
            p_specs = stepfn._param_specs(model, rules)
            dparams = shard_tree(cast, p_specs, rules)
            dtok = shard_tree({"t": tokens}, {"t": rules.act_spec(
                ("batch", None), tokens.shape)}, rules)["t"]
            max_seq = S + steps
            ms = {}
            with torch.no_grad():
                # the one-device calls first: they are the comparison
                (lg0, c0), ms["prefill_one_device"] = _twice_ms(
                    lambda: model.prefill_fn(cast, {"tokens": tokens}, rt,
                                             None, max_seq=max_seq))
                want_logits, want_k = [lg0], c0["layers"]["k"].clone()
                feed, dec0 = [], []
                nxt = lg0.argmax(-1).to(torch.int32)
                for _ in range(steps):
                    feed.append(nxt)
                    (lg0, c0), t = _host_ms(
                        lambda: model.decode_fn(cast, c0, nxt, rt, None))
                    dec0.append(t)
                    want_logits.append(lg0)
                    nxt = lg0.argmax(-1).to(torch.int32)
                del c0
                ms["decode_one_device"] = [dec0[0], sum(dec0[1:]) /
                                           (steps - 1)]
                for mod in counters().values():
                    mod.launches = 0
                (lg1, c1), ms["prefill_mesh"] = _twice_ms(
                    lambda: model.prefill_fn(dparams, {"tokens": dtok}, rt,
                                             rules, max_seq=max_seq))
                errs = {"prefill_logits": check(
                    "mesh prefill logits", lg1.full_tensor(),
                    want_logits[0], TOL[torch.bfloat16]),
                    "prefill_cache_k": check(
                        "mesh prefill cache",
                        c1["layers"]["k"].full_tensor(), want_k,
                        TOL[torch.bfloat16])}
                dec1 = []
                for i, nxt in enumerate(feed):
                    (lg1, c1), t = _host_ms(
                        lambda: model.decode_fn(dparams, c1, nxt, rt, rules))
                    dec1.append(t)
                    errs[f"decode_{i}"] = check(
                        f"mesh decode {i}", lg1.full_tensor(),
                        want_logits[i + 1], TOL[torch.bfloat16])
                ms["decode_mesh"] = [dec1[0], sum(dec1[1:]) / (steps - 1)]
                launches = {n: mod.launches
                            for n, mod in counters().items()}
                del c1, lg1, dparams, cast
            per_prefill, per_step = launches_per_unit(cfg)
            # the sharded prefill runs twice (first and warm)
            want_launches = {k: 2 * per_prefill[k] + steps * per_step[k]
                             for k in per_prefill}
            if on_card and launches != want_launches:
                raise AssertionError(f"mesh: launches {launches}, the path "
                                     f"implies {want_launches}")
            out.update(max_abs_err=errs, launches=launches,
                       expected_launches=want_launches)

            # (c) one f32 train step on the auto path against the step
            rtt = default_config(shard_strategy="tp", remat_policy="none")
            shape = ShapeConfig("mesh", S, B, "train")
            opt = make_optimizer(cfg.optimizer, constant_schedule(1e-2),
                                 eps=1e-3)
            gen.manual_seed(8)
            toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                                 device=device, dtype=torch.int32)
            tb = {"tokens": toks[:, :-1].contiguous(),
                  "labels": toks[:, 1:].contiguous()}
            one = stepfn.build_train_step(cfg, shape, rtt, None, opt)
            auto = stepfn.build_mesh_train_step(cfg, shape, rtt, mesh, opt)
            fresh = lambda: tree_map(lambda t: t.clone(), master)
            (p1, s1, m1), ms["train_one_device"] = _twice_ms(
                lambda: one.fn(fresh(), opt.init(master), tb))
            (p2, s2, m2), ms["train_mesh"] = _twice_ms(
                lambda: auto.fn(fresh(), opt.init(master), tb))
            fn1 = p1["final_norm"]
            fn2 = p2["final_norm"].full_tensor()
            train = {"loss": [float(m1["loss"]), float(m2["loss"])],
                     "final_norm_rel": float(
                         (fn2 - fn1).norm() / fn1.norm()),
                     "explicit_comm": auto.notes["explicit_comm"]}
            train["loss_rel"] = abs(train["loss"][1] - train["loss"][0]) \
                / abs(train["loss"][0])
            if not (train["loss_rel"] <= 1e-5
                    and train["final_norm_rel"] <= 1e-4):
                raise AssertionError(f"mesh train step: {train}")
            out["train"] = train

            # (d) the gradient collectives on the group, over the one-
            # device step's gradients
            _, grads = stepfn._local_grads(model, rtt, master, tb)
            gtree = tree_unflatten(master, grads)
            sync = {}
            for name, kw, strategy in (
                    ("float32", {}, "dp"),
                    ("bfloat16", {"grad_comm_dtype": "bfloat16"}, "dp"),
                    ("fused", {"grad_comm_dtype": "bfloat16",
                               "fuse_grad_collectives": True}, "dp"),
                    ("fsdp_bfloat16", {"grad_comm_dtype": "bfloat16"},
                     "fsdp")):
                r = default_config(shard_strategy=strategy, **kw)
                specs = stepfn._param_specs(
                    model, stepfn.build_rules(mesh, cfg, r))
                red = gradsync.reduce_grads(gtree, specs, r, ("data",), 0.5,
                                            mesh)
                comm = torch.float32 if name == "float32" else torch.bfloat16
                bad = [i for i, (a, g) in enumerate(zip(tree_leaves(red),
                                                        grads))
                       if not torch.equal(a, g.to(comm).float() * 0.5)]
                if bad:
                    raise AssertionError(f"mesh reduce_grads {name}: "
                                         f"{len(bad)} leaves differ")
                sync[name] = "equal"
            flat = torch.cat([g.float().reshape(-1) for g in grads])
            r = default_config(shard_strategy="dp", grad_comm_dtype="int8_ef",
                               fuse_grad_collectives=True)
            ef0 = torch.zeros((1, flat.numel()), device=flat.device)
            red, ef1 = gradsync.reduce_grads_int8_ef(gtree, r, ("data",),
                                                     {"data": 1}, ef0, 1.0,
                                                     mesh)
            q, scale, resid = gradsync.quantize_ef(flat, None)
            got = torch.cat([g.reshape(-1) for g in tree_leaves(red)])
            step_err = float((got - gradsync.dequantize_ef(q, scale))
                             .abs().max())
            if step_err > float(scale) or not torch.equal(ef1.reshape(-1),
                                                          resid):
                raise AssertionError(f"mesh int8_ef: {step_err} against a "
                                     f"step of {float(scale)}")
            sync["int8_ef"] = {"max_abs_err": step_err,
                               "quantisation_step": float(scale),
                               "residual": "equal"}
            out["reduce_grads"] = sync
            del grads, gtree, red

            # (e) the DTensor state saved, restored on one device
            state = {"params": p2, "opt": s2}
            ckpt.save(pathlib.Path(tmp) / "ckpt", 1, state)
            meta = stepfn._meta_params(model)
            back = ckpt.restore(pathlib.Path(tmp) / "ckpt", 1,
                                {"params": meta, "opt": opt.init(meta)},
                                device=device)
            full = full_tree(state)
            bad = [i for i, (a, b) in enumerate(zip(tree_leaves(back),
                                                    tree_leaves(full)))
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"mesh checkpoint: {len(bad)} leaves "
                                     "differ")
            out["checkpoint"] = {"leaves": len(tree_leaves(full)),
                                 "equal": True}
            out["host_ms"] = ms
            # warm: the second prefill and train step, decode steps 2..n
            out["dispatch_cost_ms"] = {
                k: ms[f"{k}_mesh"][1] - ms[f"{k}_one_device"][1]
                for k in ("prefill", "decode", "train")}
            del state, back, full, p1, s1, p2, s2
            if on_card:
                torch.cuda.empty_cache()

            # (f) the other families, served
            out["families"] = []
            for arch, fb, frames, fsteps in families:
                res = mesh_serve(arch, fb, frames, fsteps, mesh, device)
                out["families"].append(res)
                for k, n in res["launches"].items():
                    launches[k] += n
            out["launches"] = launches
        finally:
            dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    return out


# (path, cells, kernels each must launch, measured re-rank of the top k):
# the serve walk re-ranks its winner alone (each serve trial is five
# replays of the trace), the kernel walk its top 2
TUNE_CAMPAIGNS = (
    ("tune", "serve:smollm-135m:poisson_card",
     ("rmsnorm", "flash_attention", "flash_decode"), 1),
    ("tune_kernels", "kernel:flash_attention:tiny,kernel:flash_decode:tiny,"
     "kernel:ssm_scan:tiny,kernel:rmsnorm:tiny",
     ("rmsnorm", "flash_attention", "flash_decode", "ssm_scan"), 2),
)


def tile_error(spec: str, config: dict):
    """The error the tuner gives a kernel cell's config whose tile does
    not fit the cell's sequence (``Knob.validate_tile``), else None:
    every other crash of a trial is a failure of the path."""
    from repro_torch.core.kernel_cell import KERNELS, KERNEL_ARCH_PREFIX
    from repro_torch.core.space import SPACE
    arch, shape_name = spec.split("__")[:2]
    if not arch.startswith(KERNEL_ARCH_PREFIX):
        return None
    ks = KERNELS[arch[len(KERNEL_ARCH_PREFIX):]]
    try:
        for knob in ks.knobs:
            SPACE[knob].validate_tile(config[knob],
                                      ks.shapes[shape_name].seq_len)
    except ValueError as e:
        return str(e)
    return None


def poison_shared_memory() -> None:
    """Fill every SM's shared memory with NaN (``csrc/smem_poison.cu``),
    so that a kernel launched next that reads shared memory it did not
    write gives a non-finite output."""
    from repro_torch.kernels import _build
    _build.check(_build.lib().rt_smem_poison(
        torch.cuda.current_stream().cuda_stream), "smem_poison")


def plain_output(name: str, fn, args) -> tuple:
    """What a kernel cell's output is held to: its spec's ``plain``
    (core/kernel_cell.KERNELS; ``ssm_scan``'s is its plain version in
    f64), else the wrapper on CPU copies of its inputs (the kernel's
    plain version)."""
    from repro_torch.core.kernel_cell import KERNELS
    plain = KERNELS[name].plain
    if plain is not None:
        return plain(args)
    out = fn(*(a.cpu() for a in args))
    return out if isinstance(out, tuple) else (out,)


def assert_sync_zero(where: str) -> None:
    """Every ``ssm_scan`` sync buffer (``ssm_scan/ops._sync``, one per
    device and stream) is back at all zeros, as the wrapper's contract
    says each call leaves it (``csrc/ssm_scan.cu``)."""
    from repro_torch.kernels.ssm_scan import ops
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for (device, stream), buf in ops._sync.items():
        nonzero = int(torch.count_nonzero(buf))
        if nonzero:
            first = int(torch.nonzero(buf)[0, 0])
            raise AssertionError(
                f"{where}: the ssm_scan sync buffer of stream {stream} on "
                f"{device} holds {nonzero} non-zero ints after a call "
                f"(first at {first}: {int(buf[first])})")


def first_diff(a: torch.Tensor, b: torch.Tensor):
    """The index of the first element where ``a`` and ``b`` differ (as a
    list), or None when they are equal bit for bit."""
    diff = torch.nonzero(a.cpu() != b.cpu())
    return None if len(diff) == 0 else [int(i) for i in diff[0]]


def scan_place(index) -> dict:
    """An index of the scan's Y (b, row, head, p) as (chunk, row within
    the chunk, head, p), at the kernel's chunk of 64."""
    from repro_torch.kernels.ssm_scan.ops import KERNEL_CHUNK
    if index is None:
        return None
    b, row, head, p = index
    return {"b": b, "chunk": row // KERNEL_CHUNK,
            "row": row % KERNEL_CHUNK, "head": head, "p": p}


def cpu_model() -> str:
    """The host's CPU: its architecture and /proc/cpuinfo's model name
    (or, on Arm, its implementer and part)."""
    import platform
    fields = {}
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("CPU implementer", "CPU part")
        if k in fields)
    return f"{platform.machine()} {model or 'unknown'}"


def host_state() -> dict:
    """The state of this process that the host's f32 CPU path may read:
    its threads, the CPU and the vector ISA PyTorch picked, the f32
    matmul precision, oneDNN's switches and the fpmath and thread
    settings of the environment."""
    mkldnn = torch.backends.mkldnn
    state = {"threads": torch.get_num_threads(),
             "interop_threads": torch.get_num_interop_threads(),
             "cpu": cpu_model(),
             "cpu_capability": torch.backends.cpu.get_cpu_capability(),
             "f32_matmul_precision": torch.get_float32_matmul_precision(),
             "mkldnn": {"available": mkldnn.is_available(),
                        "enabled": bool(mkldnn.enabled)},
             "env": {k: os.environ[k] for k in (
                 "ONEDNN_DEFAULT_FPMATH_MODE", "DNNL_DEFAULT_FPMATH_MODE",
                 "OMP_NUM_THREADS", "MKL_NUM_THREADS")
                 if k in os.environ}}
    fp32 = getattr(getattr(mkldnn, "matmul", None), "fp32_precision", None)
    if fp32 is not None:
        state["mkldnn"]["matmul_fp32_precision"] = fp32
    return state


def side_report(name: str, shape_name: str, label: str, args, got, want,
                prev, tol: float) -> dict:
    """Which side of a kernel cell's comparison moved from the previous
    tile's (the kernel's output ``got``, the plain version's ``want``,
    or the inputs), where each first differs, where ``got`` misses
    ``want``, the host's state (:func:`host_state`), and for
    ``ssm_scan`` the error of both sides of both tiles against the exact
    per-token recurrence in f64 on the CPU and the pointers of the
    wrapper's buffers."""
    cpu_got = [g.cpu() for g in got]
    moved = {}
    if prev is not None:
        for side, now, before in (("got", cpu_got, prev["got"]),
                                  ("want", want, prev["want"]),
                                  ("inputs", [a.cpu() for a in args],
                                   prev["inputs"])):
            moved[side] = [first_diff(a, b) for a, b in zip(now, before)]
    miss = [first_diff((g - w).abs() > tol + tol * w.abs(),
                       torch.zeros_like(w, dtype=torch.bool))
            for g, w in zip(cpu_got, want)]
    out = {"kernel": name, "shape": shape_name, "tiles": label,
           "previous_tiles": prev["label"] if prev else None,
           "max_abs_err": [max_err(g, w) for g, w in zip(cpu_got, want)],
           "first_miss": miss,
           "moved": [side for side, at in moved.items()
                     if any(i is not None for i in at)],
           "first_differing": moved,
           **host_state()}
    if name == "ssm_scan":
        from repro_torch.kernels.ssm_scan import ops, ref
        Y64, h64 = ref.ssm_scan_ref(*(a.cpu().double() for a in args),
                                    dtype=torch.float64)
        f64 = {"got": [max_err(cpu_got[0].double(), Y64),
                       max_err(cpu_got[1].double(), h64)],
               "want": [max_err(want[0].double(), Y64),
                        max_err(want[1].double(), h64)]}
        if prev is not None:
            f64["previous_got"] = [max_err(prev["got"][0].double(), Y64),
                                   max_err(prev["got"][1].double(), h64)]
            f64["previous_want"] = [max_err(prev["want"][0].double(), Y64),
                                    max_err(prev["want"][1].double(), h64)]
        out.update(
            err_vs_f64_ref=f64,
            first_miss_place=scan_place(miss[0]),
            first_differing_place={side: scan_place(at[0])
                                   for side, at in moved.items()},
            pointers=dict(ops.last_pointers))
    return out


def phase_kernel_cells(records: list, repeats: int = 2,
                       quiet: bool = False) -> list:
    """Each kernel through its tuner cell's builder (core/kernel_cell.py)
    on the card, at every registered shape and at every combination of
    its tile knobs' domains that the tuner runs (those ``validate_tile``
    accepts), against its plain version on the same inputs
    (:func:`plain_output`: the spec's ``plain``, else the wrapper on CPU
    copies of them), then called ``repeats`` times more: each
    output must be finite and equal the first bit for bit.  Every call
    on the card follows a fill of the SMs' shared memory with NaN
    (:func:`poison_shared_memory`), and every ``ssm_scan`` call is
    followed by a check that its sync buffers are back at zero
    (:func:`assert_sync_zero`).  On a miss, and whenever a tile's output
    or plain output differs bit for bit from the previous tile's (where
    the spec says the tile does not reach the kernel), one
    ``kernel_cells_side`` line says which side moved
    (:func:`side_report`).  Whether the output moves with the tile is
    reported.  Returns the rows it checked (and emits them unless
    ``quiet``)."""
    import itertools

    from repro_torch.core.kernel_cell import KERNELS
    from repro_torch.core.params import default_config
    from repro_torch.core.space import SPACE
    dev = torch.device("cuda")
    tols = {"ssm_scan": 1e-4}
    by_name = {rec["name"]: rec for rec in records}
    rows = []
    for name, spec in sorted(KERNELS.items()):
        after = (assert_sync_zero if name == "ssm_scan"
                 else lambda where: None)
        for shape_name, shape in sorted(spec.shapes.items()):
            outs, prev = [], None
            for tiles in itertools.product(
                    *(SPACE[k].domain for k in spec.knobs)):
                delta = dict(zip(spec.knobs, tiles))
                try:
                    for knob, tile in delta.items():
                        SPACE[knob].validate_tile(tile, shape.seq_len)
                except ValueError:
                    continue            # the tuner's deterministic crash
                label = ",".join(map(str, tiles))
                where = f"{name}:{shape_name} tiles {label}"
                fn, args = spec.build(shape, default_config(**delta), dev)
                poison_shared_memory()
                got = fn(*args)
                after(where)
                want = plain_output(name, fn, args)
                got = got if isinstance(got, tuple) else (got,)
                for _ in range(repeats):
                    poison_shared_memory()
                    again = fn(*args)
                    after(where)
                    again = again if isinstance(again, tuple) else (again,)
                    if not all(bool(torch.isfinite(a.float()).all())
                               for a in again):
                        raise AssertionError(
                            f"{where}: a non-finite output after the "
                            "shared-memory poison")
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(
                            f"{where}: the output changed between calls on "
                            "the same inputs")
                tol = tols.get(name, TOL[got[0].dtype])
                missed = any(
                    float(((g.cpu().float() - w.float()).abs()
                           - tol * w.float().abs()).max()) > tol
                    for g, w in zip(got, want))
                moved = prev is not None and (
                    not all(torch.equal(w, p)
                            for w, p in zip(want, prev["want"]))
                    or (not spec.tile_reaches_kernel and not all(
                        torch.equal(g.cpu(), p)
                        for g, p in zip(got, prev["got"]))))
                if missed or moved:
                    emit("kernel_cells_side", **side_report(
                        name, shape_name, label, args, got, want, prev, tol))
                err = max(check(where, g, w.to(dev, g.dtype),
                                tols.get(name, TOL[g.dtype]))
                          for g, w in zip(got, want))
                prev = {"label": label, "got": [g.cpu() for g in got],
                        "want": list(want),
                        "inputs": [a.cpu() for a in args]}
                outs.append(got)
                rec = by_name[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rows.append({"kernel": name, "shape": shape_name,
                             "tiles": delta, "max_abs_err": err})
            rows[-1]["same_output_across_tiles"] = all(
                bool(torch.equal(a, b)) for out in outs[1:]
                for a, b in zip(outs[0], out)) if len(outs) > 1 else None
    if not quiet:
        emit("kernel_cells", checked=rows, repeats=repeats,
             smem_poison=True, sync_checked=True)
    return rows


def crash_allowed(key: str, config: dict, error: str) -> bool:
    """Whether a trial's crash is one the walk may meet on the card: a
    tile that does not fit its cell (the tuner's deterministic crash), or
    a step that does not fit the card's memory (a CUDA out-of-memory
    error, classified as a crash of the config).  Any other crash is a
    failure of the path."""
    expected = tile_error(key, config)
    if expected is not None and expected in error:
        return True
    return error.startswith("OutOfMemoryError")


def walk_summary(path: str, ckpt: pathlib.Path, reports: dict,
                 report_dir: pathlib.Path) -> list:
    """The checks of a walk (``phase_tune``'s and ``phase_tune_steps``'s):
    every cell within the trial budget, no crashed baseline, no crash but
    an allowed one (:func:`crash_allowed`), a finite cost for every trial
    that did not crash, the reports written, one telemetry span per
    trial.  Returns one summary per cell: its trials (delta, cost,
    crashed, telemetry span, time held, each serve replay's cost, a step
    trial's peak device memory), walk time, winner."""
    from repro_torch.core import telemetry
    from repro_torch.core.history import config_from_dict
    from repro_torch.core.quarantine import config_key
    from repro_torch.core.tree import MAX_TRIALS
    events = telemetry.read_events(ckpt)
    spans, replays = {}, {}
    for e in events:
        if e["kind"] == "trial":
            spans.setdefault((e["cell"], e["config"]), []).append(e)
        elif e["kind"] == "serve.replays":
            replays.setdefault((e["cell"], e["config"]), []).append(
                e["costs"])
    marks = {(e["kind"], e.get("cell")): e["ts"] for e in events
             if e["kind"] in ("cell.activate", "cell.done")}
    out = []
    for key, rep in reports.items():
        if not (report_dir / f"{key}.json").exists() \
                or not (report_dir / f"{key}.md").exists():
            raise AssertionError(f"{path}: no report for {key}")
        if not 1 <= rep.n_trials <= MAX_TRIALS:
            raise AssertionError(f"{path}: {key} took {rep.n_trials} trials")
        base = rep.log[0]
        if base["name"] != "baseline" or base["result"]["crashed"]:
            raise AssertionError(f"{path}: {key} baseline crashed: "
                                 f"{base['result']['error']}")
        measured = rep.measured or {}
        rows = [(e["name"], e["delta"], e["config"], e["result"])
                for e in rep.log]
        rows += [("measured:" + c["name"], {}, c["config"], c)
                 for c in measured.get("candidates", [])]
        trials = []
        for name, delta, config, res in rows:
            cost = res["cost_s"]
            if not res["crashed"] and not 0 < cost < float("inf"):
                raise AssertionError(f"{path}: {key} {name} cost {cost}")
            if res["crashed"] and not crash_allowed(key, config,
                                                    res["error"]):
                raise AssertionError(f"{path}: {key} {name} crashed: "
                                     f"{res['error']}")
            ck = config_key(config_from_dict(config))
            if not spans.get((key, ck)):
                raise AssertionError(f"{path}: {key} {name}: no telemetry "
                                     "span for the trial")
            span = spans[(key, ck)].pop(0)
            trials.append({"name": name, "delta": delta, "cost_s": cost,
                           "crashed": res["crashed"],
                           "error": res.get("error") or None,
                           "span_s": span["dur_s"],
                           "held_s": res.get("compile_s"),
                           "peak_bytes": res.get("peak_bytes"),
                           "replay_costs": (replays.get((key, ck)) or
                                            [None]).pop(0)})
        final = rep.final_config
        walk = (marks[("cell.done", key)] - marks[("cell.activate", key)]
                if ("cell.done", key) in marks else None)
        out.append({
            "cell": key, "trials": trials, "walk_s": walk,
            "baseline_cost_s": rep.baseline_cost,
            "winner": {"delta": {k: v for k, v in final.items()
                                 if base["config"][k] != v},
                       "cost_s": rep.final_cost, "accepted": rep.accepted},
            "measured_winner": measured.get("winner_name"),
            "measured_winner_cost_s": measured.get("winner_cost_s")})
    if any(spans.values()):
        raise AssertionError(f"{path}: telemetry spans without a trial")
    return out


def phase_tune(path: str, specs: str, root: pathlib.Path,
               device: str = "cuda", measure_top_k: int = 2) -> dict:
    """One campaign of the port's tuner, as ``tune --cells <specs>
    --strategy tree --measure-top-k <k> --trace --fresh`` runs it, with
    checkpoints, timing caches and telemetry under ``root``.  Checks the
    walk's structure (:func:`walk_summary`; the winner may differ from
    run to run: the host clock spreads) and that campaign.md, the
    campaign's stats, events and metrics are written.  Each serve
    trial's replay costs are reported (``replay_costs``), with the
    garbage collector's pauses."""
    from repro_torch.core import telemetry
    from repro_torch.core.campaign import parse_cells
    from repro_torch.launch import tune
    ckpt = root / path
    cells = parse_cells(specs)
    t0 = time.time()
    try:
        with GcPauses() as gc_pauses:
            reports, stats = tune.tune_campaign(
                cells, fresh=True, checkpoint_dir=ckpt, strategy="tree",
                measure_top_k=measure_top_k, trace=True, device=device,
                timing_dir=ckpt / "timings")
    finally:
        telemetry.uninstall()
    wall = time.time() - t0
    out = walk_summary(path, ckpt, {c.key(): reports[c.key()]
                                    for c in cells}, ckpt / "reports")
    for name in ("campaign.md", "campaign_stats.json", "events.jsonl",
                 "metrics.json"):
        if not (ckpt / name).exists():
            raise AssertionError(f"{path}: {name} not written")
    return {"cells": out, "wall_s": wall, "gc": gc_pauses.summary(),
            "evaluated_trials": stats["evaluated_trials"],
            "measured_evaluations": stats.get("measured", {}).get(
                "evaluations", 0)}


def phase_tune_cell(path: str, arch: str, shape: str, root: pathlib.Path,
                    device: str = "cuda") -> dict:
    """Single-cell mode (``tune --arch <arch> --shape <shape>``): one
    tree walk of a step cell, every trial a measured step
    (``tune.tune_cell``), with telemetry recorded under ``root``, and
    :func:`walk_summary`'s checks."""
    from repro_torch.core import telemetry
    from repro_torch.launch import tune
    ckpt = root / path
    ckpt.mkdir(parents=True)
    telemetry.install(telemetry.Telemetry(ckpt))
    t0 = time.time()
    try:
        rep = tune.tune_cell(arch, shape, device=device,
                             timing_dir=ckpt / "timings",
                             out_dir=ckpt / "reports")
        telemetry.publish_metrics(ckpt)
    finally:
        telemetry.uninstall()
    wall = time.time() - t0
    return {"cells": walk_summary(path, ckpt, {rep.workload: rep},
                                  ckpt / "reports"),
            "wall_s": wall, "evaluated_trials": rep.n_trials}


# the step-cell walks of phase ``tune_steps``: single-cell mode on the
# decode cell, one campaign over the prefill and train cells; a re-rank
# by the reduced proxy would let a toy program overrule the full-width
# walk, so there is none
STEP_CELL = ("smollm-135m", "decode_card")
STEP_CAMPAIGN = "smollm-135m:prefill_card,smollm-135m:train_card"
MOE_STEP_CELL = ("olmoe-1b-7b", "prefill_card")
# the reference's own 500k-position decode cell: xlstm's state is fixed
# (the mLSTM's 176 MB a stream), so it fits the card as it stands
XLSTM_STEP_CELL = ("xlstm-1.3b", "long_500k")


def phase_tune_steps(root: pathlib.Path) -> dict:
    """The measured step cells at full smollm-135m width and depth,
    olmoe-1b-7b's prefill of one 32,768-token prompt and xlstm-1.3b's
    decode of one stream at position 524,288 (``long_500k``), each at
    full width and depth (single-cell mode)."""
    cell = phase_tune_cell("tune_cell", *STEP_CELL, root)
    torch.cuda.empty_cache()
    camp = phase_tune("tune_step_campaign", STEP_CAMPAIGN, root,
                      measure_top_k=0)
    torch.cuda.empty_cache()
    moe = phase_tune_cell("tune_cell_moe", *MOE_STEP_CELL, root)
    torch.cuda.empty_cache()
    xl = phase_tune_cell("tune_cell_xlstm", *XLSTM_STEP_CELL, root)
    torch.cuda.empty_cache()
    return {"single_cell": cell, "campaign": camp, "moe_single_cell": moe,
            "xlstm_single_cell": xl}


# a lower bound cannot be slower than the card: each one-card roofline of
# a measured step must read at most this share of the step's measured cost
ROOFLINE_SLACK = 1.05
# the dry run the smoke drives: one arch on both production meshes
DRYRUN_ARCH = "smollm-135m"


def phase_roofline(root: pathlib.Path) -> list:
    """The analytic evaluator on one card (``core/trial.RooflineEvaluator``
    with a mesh factory that gives no mesh) on each step cell that
    ``tune_steps`` walked, at the walk's baseline config and at its
    winner's, read from the walks' reports under ``root`` (no new
    measured trial).  Each row: the roofline's terms, its bottleneck and
    predicted peak, the cost and peak the walk measured for that config,
    and measured / roofline.  Fails on a term that is not finite, on a
    count that raised, or where the roofline reads more than
    ``ROOFLINE_SLACK`` times the measured cost."""
    import math

    from repro_torch.core.history import config_from_dict
    from repro_torch.core.trial import (CompileCache, RooflineEvaluator,
                                        Workload)
    ev = RooflineEvaluator(mesh_factory=lambda multi_pod=False: None,
                           compile_cache=CompileCache(root / "roofline"))
    rows = []
    for path in sorted(root.rglob("reports/*.json")):
        rep = json.loads(path.read_text())
        arch, shape, _ = rep["workload"].split("__")
        for role, config in (("baseline", rep["log"][0]["config"]),
                             ("winner", rep["final_config"])):
            measured = next(e["result"] for e in rep["log"]
                            if e["config"] == config
                            and not e["result"]["crashed"])
            t0 = time.time()
            res = ev(Workload(arch, shape), config_from_dict(config))
            if res.error:
                raise AssertionError(f"roofline: {rep['workload']} {role}: "
                                     f"{res.error}")
            rl = res.roofline
            terms = [rl["compute_s"], rl["memory_s"], rl["collective_s"],
                     res.peak_bytes]
            if not all(math.isfinite(t) for t in terms):
                raise AssertionError(f"roofline: {rep['workload']} {role}: "
                                     f"a term is not finite: {rl}")
            row = {"cell": rep["workload"], "config": role,
                   "compute_dtype": config["compute_dtype"],
                   "attn_impl": config["attn_impl"],
                   "total_s": rl["total_s"], "bottleneck": rl["bottleneck"],
                   "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
                   "collective_s": rl["collective_s"],
                   "flops_per_chip": rl["flops_per_chip"],
                   "predicted_peak_bytes": res.peak_bytes,
                   "measured_cost_s": measured["cost_s"],
                   "measured_peak_bytes": measured.get("peak_bytes"),
                   "measured_over_roofline":
                       measured["cost_s"] / rl["total_s"],
                   "compiles": res.compiles,
                   "s": round(time.time() - t0, 2)}
            rows.append(row)
            if rl["total_s"] > ROOFLINE_SLACK * measured["cost_s"]:
                raise AssertionError(
                    f"roofline: {rep['workload']} {role}: the bound "
                    f"{rl['total_s']} s is above {ROOFLINE_SLACK} x the "
                    f"measured {measured['cost_s']} s")
    cells = {r["cell"] for r in rows}
    if len(cells) != 5:
        raise AssertionError(f"roofline: {len(cells)} step cells, not 5: "
                             f"{sorted(cells)}")
    return rows


def start_dryrun(root: pathlib.Path):
    """Start ``python -m repro_torch.launch.dryrun --arch <DRYRUN_ARCH>
    --both-meshes --quiet`` as a user runs it, in a process of its own
    (its fake process group must not meet the ``mesh`` phase's NCCL
    group), on the host only (no card visible), its output to a file
    under ``root``.  It runs on one of the host's cores, at the lowest
    priority, beside the phases that follow it: ``train`` and
    ``train_families``, whose steps on the card are device-bound and
    whose steps on the CPU would otherwise share a core with it.  Run
    alone it would add its whole time to the smoke's.  Returns
    (process, start, output path)."""
    results = ROOT / "results" / "torch" / "dryrun"
    for old in results.glob(f"{DRYRUN_ARCH}__*.json"):
        old.unlink()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [x for x in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if x]))
    out = root / "dryrun.out"
    with open(out, "w") as f:
        proc = subprocess.Popen(
            ["nice", "-n", "19", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
             "--both-meshes", "--quiet"],
            stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    return proc, time.time(), out


def phase_dryrun(proc, t0: float, out: pathlib.Path,
                 timeout: float = 300) -> dict:
    """Wait for the dry run :func:`start_dryrun` started: it must exit 0
    with every record ``ok``, or ``skip`` where ``shape_applicable``
    says so.  Returns its wall time (its start to its last record) and
    the status of each record (an ``ok`` one with its roofline, peak,
    collective bytes per chip and their summary by kind)."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    try:
        proc.wait(timeout=max(1.0, t0 + timeout - time.time()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"dryrun: ran past {timeout} s: "
                             f"{out.read_text()[-2000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: exit {proc.returncode}: "
                             f"{out.read_text()[-3000:]}")
    cfg = get_config(DRYRUN_ARCH)
    results = ROOT / "results" / "torch" / "dryrun"
    statuses, last = {}, t0
    for shape in SHAPES:
        want = "ok" if shape_applicable(cfg, SHAPES[shape])[0] else "skip"
        for mesh in ("pod_16x16", "multipod_2x16x16"):
            path = results / f"{DRYRUN_ARCH}__{shape}__{mesh}.json"
            rec = json.loads(path.read_text())
            last = max(last, path.stat().st_mtime)
            if rec["status"] != want:
                raise AssertionError(f"dryrun: {shape} {mesh}: "
                                     f"{rec['status']}, not {want}: "
                                     f"{rec.get('error')}")
            statuses[f"{shape}/{mesh}"] = (
                rec["status"] if want == "skip" else
                {"status": "ok", "s": rec["compile_s"],
                 "total_s": rec["roofline"]["total_s"],
                 "bottleneck": rec["roofline"]["bottleneck"],
                 "peak_bytes": rec["memory_analysis"]["peak_bytes"],
                 "collective_bytes": rec["roofline"]["collective_bytes"],
                 "coll_summary": rec["roofline"]["coll_summary"]})
    return {"wall_s": round(last - t0, 1), "arch": DRYRUN_ARCH,
            "records": statuses}


# the fleet's cells (``fabric`` phase): the four kernel cells and the
# serve cell on the reduced config's tiny trace; (ii) kills a worker
# over the kernel cells and has another steal its lease
FABRIC_CELLS = TUNE_CAMPAIGNS[1][1] + ",serve:smollm-135m:poisson_tiny"
FABRIC_TTL_S = {"cli": 5.0, "steal": 3.0}


def _tune_cli(argv: list, timeout: float) -> subprocess.CompletedProcess:
    """``python -m repro_torch.launch.tune <argv>`` as a user runs it,
    the port's ``src`` on its PYTHONPATH, in a session of its own: on a
    timeout the whole group (the coordinator and its workers) is
    killed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [x for x in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if x]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.tune", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"fabric: tune {' '.join(argv)} ran past "
                             f"{timeout} s: {err[-2000:]}")
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _logs(d: pathlib.Path) -> str:
    """The tails of the workers' logs under ``d``, for a failure."""
    return "\n".join(f"--- {p.name}\n{p.read_text()[-1500:]}"
                     for p in sorted(d.rglob("*.log")))


def _span_overlap(events: list) -> float:
    """The longest time (s) two ``card`` spans (a trial's hold of the
    card, core/trial.hold_device) of different workers overlap; 0 when
    none does."""
    spans = [(e["ts"], e["ts"] + e["dur_s"], e["worker"]) for e in events
             if e["kind"] == "card"]
    return max([min(a1, b1) - max(a0, b0) for a0, a1, wa in spans
                for b0, b1, wb in spans if wa < wb] + [0.0])


def _fabric_reports(d: pathlib.Path, cells) -> dict:
    """Each cell's report from its checkpoint, which must say done."""
    from repro_torch.core.strategy import get_strategy
    out = {}
    for spec in cells:
        ck = json.loads((d / f"{spec.key()}.json").read_text())
        if not ck.get("done"):
            raise AssertionError(f"fabric: {spec.key()} is not done")
        out[spec.key()] = get_strategy("tree").load_report(ck["report"])
    return out


def _timing_keys(reports: dict, cells) -> set:
    """The timing-cache keys of every trial of ``reports`` that did not
    crash, as the workers' evaluators key them on the card (the key
    hashes ``cuda/<card name>``, ``measure.device_identity``)."""
    from repro_torch.core.history import config_from_dict
    from repro_torch.core.kernel_cell import (DispatchEvaluator,
                                              is_kernel_workload)
    ev = DispatchEvaluator(device="cuda")
    by_key = {spec.key(): spec for spec in cells}
    keys = set()
    for key, rep in reports.items():
        wl = by_key[key].workload()
        sub = ev.kernel if is_kernel_workload(wl) else ev.serve
        for e in rep.log:
            if not e["result"]["crashed"]:
                keys.add(sub._key(wl, config_from_dict(e["config"])))
    return keys


def phase_fabric(root: pathlib.Path) -> dict:
    """The fleet on the card, through its real entry points.

    (i) ``tune --workers 2 --device cuda --strategy tree --trace --fresh
    --dir <d> --worker-ttl 5 --cells FABRIC_CELLS`` as a subprocess: it
    exits 0; every cell is done in 1-10 trials whose only crashes are
    tiles that do not fit (:func:`tile_error`), with one telemetry span
    per trial (:func:`walk_summary`); no lease is left; both workers held
    the card, and no two of their holds (``card`` spans, one for each
    trial that reached the card, core/trial.hold_device) overlap; every
    timing-cache
    entry the workers wrote is keyed on this card; and ``tune --status
    --json`` reports 5 done, 0 claimed, no lease.

    (ii) Worker A alone (``spawn_worker``, TTL 3 s) over the four kernel
    cells, SIGKILLed once a checkpoint shows an absorbed trial in a cell
    that is not done; then worker B: it completes every cell, steals at
    least one lease (``lease.steal``), evaluates none of the configs A
    had absorbed, and starts its first trial on the card within TTL +
    30 s of the kill.

    The workers' kernel launches happen in their processes, not in this
    one's counters."""
    from repro_torch.core import fabric, telemetry
    from repro_torch.core.campaign import parse_cells
    from repro_torch.core.history import config_from_dict
    from repro_torch.core.quarantine import config_key
    t0 = time.time()
    d = root / "fabric"
    cells = parse_cells(FABRIC_CELLS)
    done = _tune_cli(
        ["--workers", "2", "--device", "cuda", "--strategy", "tree",
         "--trace", "--fresh", "--dir", str(d), "--worker-ttl",
         str(FABRIC_TTL_S["cli"]), "--cells", FABRIC_CELLS], timeout=600)
    if done.returncode:
        raise AssertionError(f"fabric: tune --workers 2 exited "
                             f"{done.returncode}: {done.stderr[-2000:]}\n"
                             + _logs(d))
    cli_s = time.time() - t0
    reports = _fabric_reports(d, cells)
    walks = walk_summary("fabric", d, reports, d / "reports")
    for key, rep in reports.items():
        for e in rep.log:
            tile = tile_error(key, e["config"])
            if e["result"]["crashed"] and not (
                    tile and tile in e["result"]["error"]):
                raise AssertionError(f"fabric: {key} {e['name']} crashed: "
                                     f"{e['result']['error']}")
    if fabric.LeaseBoard(d).held():
        raise AssertionError(f"fabric: leases left: "
                             f"{fabric.LeaseBoard(d).held()}")
    events = telemetry.read_events(d)
    holders = {e["worker"] for e in events if e["kind"] == "card"}
    overlap = _span_overlap(events)
    if len(holders) != 2 or overlap > 0:
        raise AssertionError(f"fabric: the card held by {sorted(holders)}; "
                             f"two workers' holds overlap by {overlap} s")
    wrote = {p.stem for p in (d / fabric.TIMINGS_DIR).glob("*.json")}
    want = _timing_keys(reports, cells)
    if not wrote or wrote - want or want - wrote:
        raise AssertionError(
            f"fabric: timing-cache entries not keyed on this card: "
            f"{sorted(wrote - want)[:4]}, missing {sorted(want - wrote)[:4]}")
    status = _tune_cli(["--status", "--json", "--dir", str(d), "--cells",
                        FABRIC_CELLS], timeout=120)
    view = json.loads(status.stdout)["queue"]
    if view["depth"] != {"pending": 0, "claimed": 0, "done": len(cells)} \
            or view["leases"]:
        raise AssertionError(f"fabric: --status says {view['depth']}, "
                             f"leases {view['leases']}")
    per_worker = {}
    for e in events:
        if e["kind"] == "trial":
            per_worker[e["worker"]] = per_worker.get(e["worker"], 0) + 1
    if len(per_worker) != 2:
        raise AssertionError(f"fabric: trials by {sorted(per_worker)}, not "
                             "by two workers")

    # (ii) kill one worker mid-cell; another steals its lease
    t1 = time.time()
    d2 = root / "fabric_steal"
    kcells = parse_cells(TUNE_CAMPAIGNS[1][1])
    ttl = FABRIC_TTL_S["steal"]

    def worker(name):
        return fabric.spawn_worker(kcells, d2, strategy="tree", ttl_s=ttl,
                                   worker_id=name, trace=True, device="cuda",
                                   log_path=d2 / "logs" / f"{name}.log")

    def checkpoints():
        out = []
        for spec in kcells:
            path = d2 / f"{spec.key()}.json"
            if path.exists():
                out.append(json.loads(path.read_text()))
        return out

    a = worker("A")
    try:
        deadline = time.time() + 300
        while not any(ck["log"] and not ck.get("done")
                      for ck in checkpoints()):
            if a.poll() is not None or time.time() > deadline:
                raise AssertionError(
                    f"fabric: worker A ended (rc {a.returncode}) or ran "
                    "out of time before a cell was half done\n" + _logs(d2))
            time.sleep(0.02)
    finally:
        a.send_signal(signal.SIGKILL)
        a.wait()
    killed = time.time()
    absorbed = {(ck["cell"], config_key(config_from_dict(e["config"])))
                for ck in checkpoints() for e in ck["log"]}
    b = worker("B")
    try:
        rc = b.wait(timeout=600)
    except subprocess.TimeoutExpired:
        b.send_signal(signal.SIGKILL)
        b.wait()
        raise AssertionError("fabric: worker B ran past 600 s\n" + _logs(d2))
    if rc:
        raise AssertionError(f"fabric: worker B exited {rc}\n" + _logs(d2))
    _fabric_reports(d2, kcells)
    events2 = telemetry.read_events(d2)
    steals = [e for e in events2 if e["kind"] == "lease.steal"]
    b_trials = [e for e in events2
                if e["kind"] == "trial" and e["worker"] == "B"]
    repaid = {(e["cell"], e["config"]) for e in b_trials} & absorbed
    on_card = [e["ts"] for e in events2
               if e["kind"] == "card" and e["worker"] == "B"]
    first = min(on_card) - killed if on_card else None
    if not steals or repaid or first is None or first > ttl + 30:
        raise AssertionError(
            f"fabric: {len(steals)} steal(s), {len(repaid)} absorbed "
            f"trial(s) evaluated again, B's first trial {first} s after "
            "the kill\n" + _logs(d2))
    a_trials = sum(1 for e in events2
                   if e["kind"] == "trial" and e["worker"] == "A")
    return {"wall_s": time.time() - t0, "cli_s": cli_s,
            "steal_s": time.time() - t1,
            "cells": [w["cell"] for w in walks],
            "trials": {w["cell"]: len(w["trials"]) for w in walks},
            "trials_per_worker": per_worker,
            "card_holds": sum(e["kind"] == "card" for e in events),
            "max_card_overlap_s": overlap,
            "timing_entries": len(wrote),
            "steal": {"absorbed_at_kill": len(absorbed),
                      "trials_A": a_trials, "trials_B": len(b_trials),
                      "steals": len(steals),
                      "steal_cells": [e["cell"] for e in steals],
                      "first_trial_after_kill_s": first,
                      "max_card_overlap_s": _span_overlap(events2)},
            "launches": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print the compiler's register/shared-memory "
                         "report for every kernel")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script does not fall back to the CPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    smi = phase_env()
    phase_build(args.ptxas)
    records = phase_kernels()
    phase_kernel_cells(records)
    phase_agree()
    phase_agree_zamba()
    phase_agree_moe()
    phase_agree_xlstm()
    phase_agree_encdec()
    phase_agree_train()
    # the main paths: every launch counter is set to 0 just before each
    # path and read right after it
    by_path = {}
    for arch, drive in main_paths():
        for mod in counters().values():
            mod.launches = 0
        by_path[arch] = phase_launches(arch, drive())
    # the sharded path at one rank (its counters are set to 0 inside,
    # after the one-device calls it is compared with)
    mesh = phase_mesh()
    by_path["mesh"] = mesh["launches"]
    print(json.dumps({"mesh": mesh}), flush=True)
    emit("mesh", seconds=round(time.time() - START, 1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as root:
        for path, specs, expect, top_k in TUNE_CAMPAIGNS:
            for mod in counters().values():
                mod.launches = 0
            result = phase_tune(path, specs, pathlib.Path(root),
                                measure_top_k=top_k)
            by_path[path] = got = {name: mod.launches
                                   for name, mod in counters().items()}
            emit(path, launches=got, **result)
            for name in expect:
                if got[name] < 1:
                    raise AssertionError(f"{path}: {name} was never "
                                         "launched")
            torch.cuda.empty_cache()
        # the fleet: its workers' launches are counted in their own
        # processes, not here
        result = phase_fabric(pathlib.Path(root))
        by_path["fabric"] = None
        emit("fabric", **result)
        # the dry run works on the host only: it runs beside the phases
        # that follow, and phase ``roofline`` waits for it
        dry = start_dryrun(pathlib.Path(root))
        try:
            # training launches no kernel (the step runs the eager ops:
            # the kernels are forward-only, as the reference's are); the
            # step cells' prefill and decode trials launch three
            for path, run, expect in (
                    ("train", phase_train,
                     {name: 0 for name in counters()}),
                    ("train_families", phase_train_families,
                     {name: 0 for name in counters()}),
                    ("tune_steps", phase_tune_steps,
                     {"rmsnorm": 1, "flash_attention": 1,
                      "flash_decode": 1})):
                for mod in counters().values():
                    mod.launches = 0
                result = run(pathlib.Path(root) / path)
                by_path[path] = got = {name: mod.launches
                                       for name, mod in counters().items()}
                emit(path, launches=got, **result)
                for name, want in expect.items():
                    if (got[name] != 0) if want == 0 \
                            else (got[name] < want):
                        raise AssertionError(f"{path}: {name} launched "
                                             f"{got[name]} times")
                torch.cuda.empty_cache()
            # the analytic evaluator on the step cells just measured
            # (counted on fake CPU tensors: it launches no kernel), then
            # the dry run
            for mod in counters().values():
                mod.launches = 0
            t_roof = time.time()
            rows = phase_roofline(pathlib.Path(root) / "tune_steps")
            roof_s = time.time() - t_roof
            dryrun = phase_dryrun(*dry)
            by_path["roofline"] = got = {
                name: mod.launches for name, mod in counters().items()}
            if any(got.values()):
                raise AssertionError(f"roofline: kernels launched: {got}")
            print(json.dumps({"roofline": rows}), flush=True)
            emit("roofline", launches=got, roofline_s=round(roof_s, 1),
                 waited_s=round(time.time() - t_roof - roof_s, 1),
                 dryrun=dryrun)
        finally:
            if dry[0].poll() is None:    # a phase failed before the wait
                dry[0].kill()
                dry[0].wait()
    for rec in records:
        rec["launches_by_path"] = {
            a: None if got is None else got[rec["name"]]
            for a, got in by_path.items()}
        rec["launches"] = sum(n for n in rec["launches_by_path"].values()
                              if n is not None)
    print(json.dumps({"kernels": records}), flush=True)
    emit("done", seconds=round(time.time() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
