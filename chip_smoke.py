#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ptxas]  # needs one CUDA device and nvcc

Drives the port's two serving paths (``repro_torch.launch.serve`` and
``repro_torch.serving.scheduler.BatchScheduler``) on smollm-135m (dense)
and zamba2-7b (hybrid: Mamba2 + shared attention), each at its full
width and depth with random weights from a seed, builds the four
hand-written CUDA kernels from ``src/repro_torch/csrc`` and holds each
against its plain PyTorch version on the card, and shows by the
wrappers' launch counters that each path went through its kernels.

Phases, one JSON line each: env, build, kernels, agree (kernel path vs
eager path of the whole model, per model), then for each model serve,
scheduler and launches (every counter set to 0 just before the path and
read right after it).  Any failure raises and the run exits non-zero.
The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the card's name and power limit; the line before
that is the ``{"kernels": [...]}`` record, whose ``launches`` sum both
paths' counts (``launches_by_path`` keeps them apart).

Peak rates used for ``bound_ms`` (NVIDIA H100 SXM data sheet, dense):
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
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32x3": 495e12 / 3, "f32": 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.int8: 2e-2}
# flash_attention's two kernels, both on the tensor cores: bf16 operands,
# and f32 operands as three TF32 products (flash_attention.cu is the
# entry point)
BF16_SOURCE = "src/repro_torch/csrc/flash_attention_tc.cu"
F32_SOURCE = "src/repro_torch/csrc/flash_attention_f32.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


# rmsnorm's timed shapes (rows, d, x dtype): the serving paths' prefill
# (4*1024 rows) and decode (4 rows) at smollm-135m's width 576 and
# zamba2-7b's 3584 (d_model) and 7168 (the Mamba2 blocks' gated output),
# in bf16 and, at prefill, in f32 (the knob space's default compute dtype)
RMSNORM_TIMED = ((4 * 1024, 576, torch.bfloat16), (4, 576, torch.bfloat16),
                 (4 * 1024, 3584, torch.bfloat16),
                 (4 * 1024, 7168, torch.bfloat16),
                 (4, 3584, torch.bfloat16), (4, 7168, torch.bfloat16),
                 (4 * 1024, 576, torch.float32),
                 (4 * 1024, 3584, torch.float32),
                 (4 * 1024, 7168, torch.float32))


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
              timed((4, 746, 32, 112), torch.float32)]
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
    zamba = (4, 1088, 32, 32, 112)
    glm4, nemotron = (2, 32768, 32, 2, 128), (2, 640, 96, 8, 192)
    shapes = [timed("bfloat16", 1056), timed("int8", 1056),
              timed("bfloat16", 2048), timed("bfloat16", 1056, zamba),
              timed("int8", 1056, zamba), timed("bfloat16", 20001, glm4),
              timed("int8", 20001, glm4), timed("bfloat16", 640, nemotron)]
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


def phase_serve(arch: str, gen_tokens: int) -> dict:
    from repro_torch.launch import serve
    expect = {"prefills": 0, "decode_steps": 0}
    for kv in ("bfloat16", "int8"):
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
    if cfg.family == "dense":
        # prefill norms ln1 twice a block (once for the K/V that go to the
        # cache, once inside the block), ln2 once, and the stack once at
        # the end; a decode step norms ln1 and ln2 once each and the stack
        n = cfg.n_layers
        return ({"rmsnorm": 3 * n + 1, "flash_attention": n,
                 "flash_decode": 0, "ssm_scan": 0},
                {"rmsnorm": 2 * n + 1, "flash_attention": 0,
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
    return [
        ("smollm-135m", lambda: [phase_serve("smollm-135m", 64),
                                 phase_scheduler("smollm-135m", smollm_trace,
                                                 2048)]),
        ("zamba2-7b", lambda: [phase_serve("zamba2-7b", 32),
                               phase_scheduler("zamba2-7b", zamba_trace,
                                               1088)]),
    ]


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
    phase_agree()
    phase_agree_zamba()
    # the main paths: every launch counter is set to 0 just before each
    # path and read right after it
    by_path = {}
    for arch, drive in main_paths():
        for mod in counters().values():
            mod.launches = 0
        by_path[arch] = phase_launches(arch, drive())
    for rec in records:
        rec["launches_by_path"] = {a: got[rec["name"]]
                                   for a, got in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    print(json.dumps({"kernels": records}), flush=True)
    emit("done", seconds=round(time.time() - t0, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
