"""KernelCell — kernel tile sweeps as first-class campaign cells.

Each kernel's tile knobs become a tuned cell per (kernel, shape), driven
through the campaign/strategy/quarantine machinery unchanged.  Kernel
cells are evaluated by :class:`KernelBenchEvaluator`, which times the
kernel itself, wrapped in the measured tier's disk-backed
:class:`~repro_torch.core.measure.TimingCache`.

This is the PyTorch port's copy of the reference's ``core/kernel_cell.py``:
the registry (kernels, knobs, shapes), the cell spellings, the stage and
the crash rules are the reference's, so cell keys, checkpoints and
history rows are interchangeable.  What differs is what a trial runs:
the port's wrapper of each hand-written CUDA kernel (its plain PyTorch
version on the CPU), on inputs drawn from a ``torch.Generator`` seeded
as the reference's builders seed ``jax.random`` (so the values differ
between the packages, the shapes and dtypes do not), timed with CUDA
events on the card.

Design decisions (the reference's):

  * every kernel's tile knobs are a **projection of the existing
    ``SPACE``** onto :class:`~repro_torch.core.params.TunableConfig`
    fields, so quarantine config keys, history records and every
    strategy work without a second config type.  Which field drives
    which tile follows the builders: ``attn_block_q``/``attn_block_kv``
    for flash_attention, ``attn_block_kv`` for flash_decode, and
    ``attn_block_q`` for ssm_scan's chunk and rmsnorm's row block;
  * a kernel cell is a :class:`~repro_torch.core.campaign.CellSpec`
    whose ``arch`` is ``kernel-<name>`` and whose shapes come from the
    :data:`KERNELS` registry — cell keys stay three ``__``-separated
    parts;
  * a tile that does not divide the shape's sequence length is a
    **clean deterministic-crash trial** (validated up front via
    ``Knob.validate_tile``), exactly like the paper's failed 0.1/0.7
    run.

In the port only flash_decode's tile reaches its kernel (the span plan
of ``kernels/flash_decode/ops.py``).  flash_attention, ssm_scan and
rmsnorm run tiles of their own and accept the knob's tile without
reading it, so a sweep over them times one program once per knob value:
measured no-ops, kept so the cells and their decisions stay the
reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.campaign import CellSpec
from repro_torch.core.params import TunableConfig
from repro_torch.core.space import SPACE
from repro_torch.core.tree import Stage
from repro_torch.core.trial import (FAILURE_TRANSIENT, TrialError,
                                    TrialResult, Workload,
                                    classify_exception, hold_device)

KERNEL_ARCH_PREFIX = "kernel-"


def is_kernel_workload(wl: Any) -> bool:
    return str(getattr(wl, "arch", "")).startswith(KERNEL_ARCH_PREFIX)


# ------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class KernelShape:
    """One benchmarked shape of a kernel.  ``seq_len`` is the dimension
    the tile knobs must divide; ``dims`` the full argument geometry."""
    name: str
    seq_len: int
    dims: Tuple[Tuple[str, int], ...]

    def dim(self, name: str) -> int:
        return dict(self.dims)[name]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One tunable kernel: its SPACE tile projection, its shapes, and
    a builder ``(shape, config, device) -> (fn, args)`` where ``fn``
    applies the kernel's wrapper with the config's tiles.
    ``tile_reaches_kernel`` says whether the tiles change what the card
    runs (the others' kernels run tiles of their own), and ``plain``,
    where set, gives from ``args`` the outputs the kernel is held to on
    the card in place of its wrapper on CPU copies of them."""
    name: str
    knobs: Tuple[str, ...]
    shapes: Dict[str, KernelShape]
    build: Callable[[KernelShape, TunableConfig, torch.device],
                    Tuple[Callable, Tuple]]
    tile_reaches_kernel: bool = False
    plain: Optional[Callable[[Tuple], Tuple]] = None


def _shape(name: str, seq_len: int, **dims: int) -> KernelShape:
    return KernelShape(name, seq_len, tuple(sorted(dims.items())))


def _normals(seed: int, device: torch.device, *shapes) -> List[torch.Tensor]:
    """Standard normal f32 tensors drawn on ``device`` from one seeded
    generator (the reference's builders seed ``jax.random`` 0-3)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device,
                        dtype=torch.float32) for s in shapes]


def _build_flash_attention(shape: KernelShape, rt: TunableConfig,
                           device: torch.device):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    B, H, S, hd = (shape.dim(n) for n in ("B", "H", "S", "hd"))
    q, k, v = _normals(0, device, *[(B, S, H, hd)] * 3)

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=True,
                               block_q=rt.attn_block_q,
                               block_kv=rt.attn_block_kv)
    return fn, (q, k, v)


def _build_flash_decode(shape: KernelShape, rt: TunableConfig,
                        device: torch.device):
    from repro_torch.kernels.flash_decode.ops import flash_decode
    B, H, Hkv, S, hd = (shape.dim(n)
                        for n in ("B", "H", "Hkv", "S", "hd"))
    q, kc, vc = _normals(1, device, (B, 1, H, hd), (B, S, Hkv, hd),
                         (B, S, Hkv, hd))
    length = shape.dim("length")

    def fn(q, kc, vc):
        return flash_decode(q, kc, vc, length, block_kv=rt.attn_block_kv)
    return fn, (q, kc, vc)


def _build_ssm_scan(shape: KernelShape, rt: TunableConfig,
                    device: torch.device):
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    B, S, H, P, N = (shape.dim(n) for n in ("B", "S", "H", "P", "N"))
    X, Bm, Cm, dt, la = _normals(2, device, (B, S, H, P), (B, S, N),
                                 (B, S, N), (B, S, H), (B, S, H))
    dt = torch.nn.functional.softplus(dt)
    la = -torch.nn.functional.softplus(la)

    def fn(X, Bm, Cm, dt, la):
        return ssm_scan(X, Bm, Cm, dt, la, chunk=rt.attn_block_q)
    return fn, (X, Bm, Cm, dt, la)


def _plain_ssm_scan(args) -> Tuple:
    """The scan's plain version at the kernel's chunk, computed in f64 on
    the CPU: on the card's host its f32 path once gave another answer
    for the same input (ROADMAP.md queue C)."""
    from repro_torch.kernels.ssm_scan import ops, ref
    return ref.ssm_scan_tiled(*(a.cpu().double() for a in args),
                              ops.KERNEL_CHUNK, dtype=torch.float64)


def _build_rmsnorm(shape: KernelShape, rt: TunableConfig,
                   device: torch.device):
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    rows, d = shape.dim("rows"), shape.dim("d")
    x, = _normals(3, device, (rows, d))
    scale = torch.ones((d,), dtype=torch.float32, device=device)

    def fn(x, scale):
        return rmsnorm(x, scale, block_rows=rt.attn_block_q)
    return fn, (x, scale)


#: the tunable kernels, at the reference's shapes.  "ragged" shapes make
#: some tiles *invalid* (non-dividing), producing the paper's
#: deterministic-crash trials inside an otherwise normal sweep.
KERNELS: Dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        "flash_attention", ("attn_block_q", "attn_block_kv"),
        {"tiny": _shape("tiny", 256, B=1, H=2, S=256, hd=64),
         "ragged": _shape("ragged", 384, B=1, H=2, S=384, hd=64)},
        _build_flash_attention),
    "flash_decode": KernelSpec(
        "flash_decode", ("attn_block_kv",),
        {"tiny": _shape("tiny", 512, B=1, H=4, Hkv=2, S=512, hd=64,
                        length=384)},
        _build_flash_decode, tile_reaches_kernel=True),
    "ssm_scan": KernelSpec(
        "ssm_scan", ("attn_block_q",),
        {"tiny": _shape("tiny", 512, B=1, S=512, H=2, P=8, N=8)},
        _build_ssm_scan, plain=_plain_ssm_scan),
    "rmsnorm": KernelSpec(
        "rmsnorm", ("attn_block_q",),
        {"tiny": _shape("tiny", 4096, rows=4096, d=512)},
        _build_rmsnorm),
}


# ---------------------------------------------------------------- cells
@dataclasses.dataclass
class KernelWorkload(Workload):
    """A kernel cell's workload: same key/identity contract as a step
    workload, but ``cfg``/``shp`` come from the kernel registry (the
    step-builder path is never taken — kernel cells are evaluated by
    :class:`KernelBenchEvaluator`)."""

    @property
    def kernel(self) -> str:
        return self.arch[len(KERNEL_ARCH_PREFIX):]

    @property
    def cfg(self):
        raise TrialError(f"kernel workload {self.key()} has no arch "
                         "config — route it to KernelBenchEvaluator")

    @property
    def shp(self) -> ShapeConfig:
        ks = KERNELS[self.kernel].shapes[self.shape]
        return ShapeConfig(self.shape, ks.seq_len, 1, "kernel")


@dataclasses.dataclass(frozen=True)
class KernelCell(CellSpec):
    """One (kernel, shape) tile-sweep cell.  ``arch`` is
    ``kernel-<name>`` so cell keys/checkpoints keep the three-part
    ``arch__shape__mesh`` layout everywhere."""

    @property
    def kernel(self) -> str:
        return self.arch[len(KERNEL_ARCH_PREFIX):]

    def workload(self) -> KernelWorkload:
        return KernelWorkload(self.arch, self.shape, self.multi_pod)

    def spec(self) -> str:
        return f"kernel:{self.kernel}:{self.shape}"


def kernel_cell(kernel: str, shape: str) -> KernelCell:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} "
                         f"(known: {', '.join(sorted(KERNELS))})")
    if shape not in KERNELS[kernel].shapes:
        raise ValueError(
            f"unknown shape {shape!r} for kernel {kernel!r} "
            f"(known: {', '.join(sorted(KERNELS[kernel].shapes))})")
    return KernelCell(KERNEL_ARCH_PREFIX + kernel, shape, False)


def parse_kernel_cell(item: str) -> KernelCell:
    """Parse one ``kernel:<name>:<shape>`` cell spec (the string
    :meth:`KernelCell.spec` emits)."""
    parts = item.strip().split(":")
    if len(parts) != 3 or parts[0] != "kernel":
        raise ValueError(f"bad kernel cell spec {item!r} "
                         "(want kernel:<name>:<shape>)")
    return kernel_cell(parts[1], parts[2])


def kernel_cells(kernels: Optional[List[str]] = None) -> List[KernelCell]:
    """Every registered (kernel, shape) cell."""
    return [kernel_cell(k, s)
            for k in (kernels or sorted(KERNELS))
            for s in sorted(KERNELS[k].shapes)]


def kernel_signature(arch: str, shape: str, multi_pod: bool = False
                     ) -> Dict:
    """Warm-start similarity features for a kernel cell (the kernel-side
    counterpart of :func:`repro_torch.core.history.cell_signature`)."""
    name = arch[len(KERNEL_ARCH_PREFIX):]
    ks = KERNELS.get(name)
    return {
        "arch": arch,
        "shape": shape,
        "kind": "kernel",
        "family": arch,
        "multi_pod": bool(multi_pod),
        "active_knobs": list(ks.knobs) if ks else [],
    }


# --------------------------------------------------------------- stages
def kernel_stages(spec: Any) -> List[Stage]:
    """The tile-sweep tree for one kernel cell: a single joint stage
    whose alternatives are every non-default combination of the
    kernel's tile projection (≤ 8 + baseline — inside the paper's
    ≤ 10-trial budget)."""
    ks = KERNELS[spec.arch[len(KERNEL_ARCH_PREFIX):]]
    defaults = {n: SPACE[n].default for n in ks.knobs}
    alts = []
    for combo in itertools.product(*(SPACE[n].domain for n in ks.knobs)):
        delta = {n: v for n, v in zip(ks.knobs, combo)
                 if v != defaults[n]}
        if delta:
            alts.append(delta)
    return [Stage("tiles", SPACE[ks.knobs[0]].spark, alts,
                  kinds=("kernel",))]


# ------------------------------------------------------------ evaluator
#: spin cycles queued ahead of a timed call (about 5 ms on an H100), so
#: the host has enqueued the call before the device reaches the window
_SPIN_CYCLES = 10_000_000


def _seconds(fn, args, device: torch.device) -> float:
    """One call's device time on the card: CUDA events around it, behind
    a spin that keeps the device busy while the host enqueues the start
    event, the call and the stop event, so neither the host's launch
    cost nor a wait for the interpreter lock (the campaign's other
    threads hold it for milliseconds) is in the window.  A window the
    device reached before the host had enqueued it all is measured again
    behind a longer spin.  The host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0
    spin = _SPIN_CYCLES
    for _ in range(3):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn(*args)
        stop.record()
        clean = not start.query()        # the spin was still running
        stop.synchronize()
        if clean:
            return start.elapsed_time(stop) / 1e3
        spin *= 4
    raise TrialError("the host did not enqueue one timed call within "
                     f"{spin // 4} spin cycles", failure=FAILURE_TRANSIENT)


class KernelBenchEvaluator:
    """Time the kernel itself: median of N repeats after one first call
    (build plus launch, reported as ``compile_s``), on ``device``.
    Hardened exactly like the other evaluators: tile divisibility is
    validated up front (clean deterministic crash), everything else goes
    through :func:`classify_exception`.  The device's lock is held
    around building the inputs, the first call and the timed repeats;
    the wait for it is in no reported time."""

    def __init__(self, repeats: int = 3, device="cuda"):
        self.repeats = repeats
        self.device = device

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        from repro_torch.models.model import resolve_device
        t0 = time.time()
        try:
            if not is_kernel_workload(wl):
                raise TrialError(f"{wl.key()} is not a kernel cell")
            name = wl.arch[len(KERNEL_ARCH_PREFIX):]
            ks = KERNELS.get(name)
            if ks is None or wl.shape not in ks.shapes:
                raise TrialError(f"unknown kernel cell {wl.key()}")
            shape = ks.shapes[wl.shape]
            SPACE.validate(rt)
            for knob in ks.knobs:
                SPACE[knob].validate_tile(getattr(rt, knob),
                                          shape.seq_len)
            dev = resolve_device(self.device)
            with hold_device(dev), torch.no_grad():
                t0 = time.time()
                fn, args = ks.build(shape, rt, dev)
                c0 = time.perf_counter()
                fn(*args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                compile_s = round(time.perf_counter() - c0, 2)
                ts = [_seconds(fn, args, dev) for _ in range(self.repeats)]
            return TrialResult(cost_s=float(statistics.median(ts)),
                               compiles=1, compile_s=compile_s)
        except Exception as e:
            err = str(e) if isinstance(e, TrialError) \
                else f"{type(e).__name__}: {e}"
            return TrialResult(cost_s=float("inf"), crashed=True,
                               error=err[:500],
                               failure=classify_exception(e),
                               compile_s=round(time.time() - t0, 2))


# a step sample's least length (s): shorter steps are timed in windows
# of back-to-back calls (WallClockEvaluator).  On the H100 a host-bound
# step's cost spreads less over longer samples (PERF.md, run v1:
# decode_card 101 % -> 65 % -> 43 % at one step, 0.25 s and 1 s)
STEP_MIN_SAMPLE_S = 1.0
STEP_REPEATS = 5


def step_evaluator(device="cuda", cache_dir=None) -> Callable:
    """The measured step evaluator of every walk over step cells, in a
    campaign and in single-cell mode: real full-width steps on
    ``device`` (:class:`~repro_torch.core.trial.WallClockEvaluator` on
    the bundle's own arguments), behind the timing cache, whose keys
    name the device and the sampling protocol."""
    from repro_torch.core.measure import (MEASURE_VERSION, CachedMeasure,
                                          TimingCache)
    from repro_torch.core.trial import WallClockEvaluator
    return CachedMeasure(
        WallClockEvaluator(None, STEP_REPEATS, device, STEP_MIN_SAMPLE_S),
        cache=TimingCache(cache_dir),
        tag=f"{MEASURE_VERSION}:step-window-{STEP_MIN_SAMPLE_S}")


class DispatchEvaluator:
    """The campaign's cell-kind-aware default evaluator: kernel
    workloads go to the (timing-cached) kernel bench, serve workloads
    to the (timing-cached) traffic-replay evaluator
    (serving/evaluator.py), step workloads to :func:`step_evaluator`
    unless ``step`` is given, all on ``device``; the timing caches'
    keys name the device.  ``cache_dir`` holds the timing caches
    (default: the port's ``results/torch/trials/timings``)."""

    def __init__(self, step: Optional[Callable] = None,
                 kernel: Optional[Callable] = None,
                 serve: Optional[Callable] = None,
                 slo_ttft: Optional[float] = None,
                 device="cuda", cache_dir=None):
        from repro_torch.core.measure import CachedMeasure, TimingCache
        from repro_torch.serving.evaluator import make_serve_evaluator
        self.step = step or step_evaluator(device, cache_dir)
        self.kernel = kernel or CachedMeasure(
            KernelBenchEvaluator(device=device), cache=TimingCache(cache_dir))
        self.serve = serve or make_serve_evaluator(
            slo_ttft=slo_ttft, cache=TimingCache(cache_dir), device=device)

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        if is_kernel_workload(wl):
            return self.kernel(wl, rt)
        if str(getattr(wl, "arch", "")).startswith("serve-"):
            return self.serve(wl, rt)
        return self.step(wl, rt)
