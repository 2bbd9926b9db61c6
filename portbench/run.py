#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``portbench/configs``) and a
mix (``portbench/mixes``, whose ``kind`` names the module that drives
it, ``serve``).  The run makes the weights on the card from the seed,
warms the cell's own
shapes, measures for ``--seconds``, judges what the timed path produced
against the plain reference, and prints as its last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last the compared numbers beside their limits (``checks``), which are
also the last lines of standard error.

It exits non-zero and prints no result when there is no CUDA device or
fewer than the cell asks for, when the program is missing, and when a
module of JAX or of the JAX package is loaded once the window has closed.
Kernel build and compile caches stay in ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T0 = time.time()            # the process's start, for setup_s

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _env():
    """Fixed cache directories inside the checkout; one thread a pool, on
    one CPU; no JAX by the way.  Runs before torch is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host's share of a step is the
    # main thread's dispatch, and idle pools only add to the noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # and on one CPU, the last this process may use, so that the
    # scheduler does not move that thread between CPUs mid-window
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    # the harness as the package ``portbench`` (never its files by their
    # bare names), the program from ``src``
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != here]
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


class Context(types.SimpleNamespace):
    """What a run knows: the cell, its configuration and mix, the program
    objects built from them, the seed, the window, the tracer."""

    def note(self, msg: str):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def context(bench, cell: str, seed: int, seconds: float, trace: bool,
            device) -> Context:
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.params import TunableConfig
    from repro_torch.models.model import build_model
    from portbench.tracing import Tracer
    w = bench.cell(cell)
    config = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    arch = dict(config["arch"])
    cfg = ArchConfig(**dict(arch, fsdp_axes=tuple(arch["fsdp_axes"])))
    rt = TunableConfig(**config["tunable"])
    dev = torch.device(device)
    return Context(bench=bench, cell=w, config=config, mix=mix, arch=arch,
                   cfg=cfg, rt=rt, model=build_model(cfg),
                   reference=bench.reference(config["reference"]),
                   seed=int(seed), seconds=float(seconds), trace=bool(trace),
                   tracer=Tracer(bool(trace), dev), device=dev)


def _kind(ctx):
    """The module that drives the mix's kind (``portbench/<kind>.py``)."""
    import importlib
    return importlib.import_module(f"portbench.{ctx.mix['kind']}")


def _wrap_kernels(ctx):
    """Spans around the kernel wrappers that the cell's per-layer metrics
    read (a metric file's ``KERNEL``), and no others."""
    import importlib
    if not ctx.trace:
        return
    for m in ctx.bench.per_layer(ctx.cell["name"]):
        name = getattr(ctx.bench.metric(m["name"]), "KERNEL", None)
        if name and f"pb.k.{name}" not in ctx.tracer.wrapped:
            mod = importlib.import_module(f"repro_torch.kernels.{name}.ops")
            ctx.tracer.kernel(mod, name, f"pb.k.{name}")


def execute(ctx):
    """One run: set-up, window, readings, judgement.  Returns the
    result's parts (``spec.result_line`` prints them)."""
    import torch
    from portbench import tracing
    kind = _kind(ctx)
    state = kind.build(ctx)
    ctx.tracer.warm()
    _wrap_kernels(ctx)
    ctx.sync()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    win = kind.window(ctx, state)
    setup_s = win["t0"] - ctx.t_start
    ctx.sync()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    fig = kind.figures(ctx, win)
    run = types.SimpleNamespace(ctx=ctx, win=win, fig=fig, trace=None,
                                tracer=ctx.tracer)
    metrics, breakdown, dev_extra = {}, None, {}
    if ctx.trace:
        t = time.perf_counter()
        run.trace = tracing.reduce(ctx.tracer)
        ctx.tracer.prof = None
        ctx.note(f"trace: stopped in {ctx.tracer.stop_s:.1f} s, read in "
                 f"{time.perf_counter() - t:.1f} s; " + str(
                     {k: run.trace[k] for k in
                      ("ops_in_window", "ops_matched", "spans")}))
        for m in ctx.bench.per_layer(ctx.cell["name"]):
            v = ctx.bench.metric(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {k: run.trace[k] for k in ("device_ops", "idle_gaps")}
        dev_extra = {"busy_s": run.trace["busy_s"],
                     "window_s": run.trace["window_s"]}
    else:
        values = dict(fig["e2e"], setup_s=setup_s)
        for m in ctx.bench.end_to_end(ctx.cell["name"]):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    del state
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    limits = ctx.bench.limits(ctx.cell["name"])
    got = ctx.readings = kind.check(ctx, win, fig)
    checks = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    correct = (fig["failed"] == 0 and fig["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": int(ctx.cell.get("chips", 1)),
              "memory_peak_bytes": int(peak), **dev_extra}
    return {"correct": correct, "attempted": fig["attempted"],
            "failed": fig["failed"], "metrics": metrics, "device": device,
            "checks": checks, "breakdown": breakdown}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch
    from portbench import spec
    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: cell {args.workload} needs {need} CUDA "
              f"device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = context(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda:0")
    ctx.t_start = T0
    out = execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(spec.result_line(out["correct"], out["attempted"], out["failed"],
                           out["metrics"], out["device"], out["checks"],
                           out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
