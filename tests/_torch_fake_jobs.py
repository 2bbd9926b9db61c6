"""Jobs that need the fake process group, run in a fresh interpreter by
``_torch_fake_group.run_jobs``: ``python -m _torch_fake_jobs <job>...``
prints one JSON object ``{job: result}`` as its last line.  Neither jax
nor the reference can be imported here (both are blocked before the
port is)."""
from __future__ import annotations

import json
import sys

for _blocked in ("jax", "jaxlib", "repro"):
    sys.modules[_blocked] = None

import torch  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costmodel, stepcount
from repro_torch.core.params import default_config
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.layers import ShapeDtype
from repro_torch.runtime.sharding import ShardingRules
from repro_torch.runtime.stepfn import StepBundle, build_step

F32 = torch.float32


def _product(mesh, x_shape, x_spec, w_shape, w_spec):
    """The count of ``x @ w`` with x and w on their specs of ``mesh``."""
    rules = ShardingRules(mesh=mesh, strategy="dp")
    args = (ShapeDtype(x_shape, F32),) if w_shape is None else \
        (ShapeDtype(x_shape, F32), ShapeDtype(w_shape, F32))
    specs = (x_spec,) if w_shape is None else (x_spec, w_spec)
    fn = (lambda a: a @ a) if w_shape is None else (lambda a, b: a @ b)
    return stepcount.count(StepBundle(fn, args, rules, "prefill",
                                      specs=specs))


def per_rank():
    """FLOPs per rank: the reference's own 4-device program
    (tests/test_optim_costmodel.py::test_cost_analysis_is_per_partition:
    x @ x, x (64, 64) split on its rows over 4 ranks), and a Shard x
    Shard product on (16, 16)."""
    four = _product(fake_mesh((4,), ("data",)), (64, 64), ("data", None),
                    None, None)
    big = _product(fake_mesh((16, 16), ("data", "model")), (4096, 2048),
                   ("data", None), (2048, 8192), (None, "model"))
    return {"four_ratio": four.flops / (2 * 64 ** 3),
            "four_collectives": [c.kind for c in four.collectives],
            "shard_ratio": big.flops / (2 * 4096 * 2048 * 8192),
            "shard_collectives": len(big.collectives),
            "shard_peak": big.peak_bytes, "shard_args": big.argument_bytes}


TRAIN = ShapeConfig("t", 64, 8, "train")


def _train_count(strategy: str, n_layers=None):
    cfg = get_reduced("smollm-135m")
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    rt = default_config(shard_strategy=strategy, unroll_layers=True)
    mesh = fake_mesh((4, 2), ("data", "model"))
    return stepcount.count(build_step(cfg, TRAIN, rt, mesh))


def extrapolation():
    """The reduced smollm train step (fsdp, (4, 2)) at 1, 3 and 6 layers:
    FLOPs, bytes and collective bytes per rank."""
    out = {}
    for n in (1, 3, 6):
        c = _train_count("fsdp", n)
        out[n] = {"flops": c.flops, "bytes": c.bytes,
                  "coll": sum(op.bytes_out for op in c.collectives)}
    return out


def collectives():
    """The reduced smollm train step on (4, 2) under each strategy: the
    collectives' summary per rank."""
    out = {}
    for strategy in ("dp", "tp", "fsdp", "fsdp_tp"):
        c = _train_count(strategy)
        stats = costmodel.CollectiveStats(c.collectives)
        out[strategy] = {"summary": stats.summary(),
                         "total": stats.total_bytes(),
                         "groups": sorted({op.group_size
                                           for op in c.collectives})}
    return out


FAMILIES = ("smollm-135m", "olmoe-1b-7b", "llava-next-34b", "zamba2-7b",
            "xlstm-1.3b", "seamless-m4t-medium")


def family_collectives():
    """Each family's reduced train step on (4, 2) under tp and fsdp_tp:
    collective bytes per rank, FLOPs per rank."""
    mesh = fake_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in FAMILIES:
        for strategy in ("tp", "fsdp_tp"):
            rt = default_config(shard_strategy=strategy, unroll_layers=True)
            c = stepcount.count(build_step(get_reduced(arch), TRAIN, rt,
                                           mesh))
            stats = costmodel.CollectiveStats(c.collectives)
            out[f"{arch}:{strategy}"] = {"total": stats.total_bytes(),
                                         "summary": stats.summary(),
                                         "flops": c.flops}
    return out


def full_width_collectives():
    """The dry run's records of smollm-135m on pod_16x16 (train_4k and
    decode_32k, the production shapes at full width): collective bytes
    per chip."""
    from repro_torch.launch import dryrun as dr
    out = {}
    for shape in ("train_4k", "decode_32k"):
        rec = dr.run_cell("smollm-135m", shape, False, save=False)
        out[shape] = {"status": rec["status"],
                      "error": rec.get("error"),
                      "collective_bytes": rec.get("roofline", {}).get(
                          "collective_bytes")}
    return out


def one_collective_over_both_axes():
    """``sharding.move`` of a DTensor on (4, 2) over both mesh dims at
    once: a sum pending on both made whole, a dim split over both made
    whole, and a sum pending on both split over both; the collectives a
    count sees."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.runtime import sharding as SH
    mesh = fake_mesh((4, 2), ("data", "model"))
    whole, split = (Replicate(), Replicate()), (Shard(0), Shard(0))
    out = {}
    for name, pl, local, to in (
            ("partial", (Partial(), Partial()), (16, 8), whole),
            ("split", split, (2, 8), whole),
            ("scatter", (Partial(), Partial()), (16, 8), split)):
        x = DTensor.from_local(torch.zeros(local), mesh, pl,
                               run_check=False, shape=torch.Size((16, 8)),
                               stride=(8, 1))
        counter = stepcount.StepCounter()
        with counter:
            y = SH.move(x, to)
        out[name] = {"collectives": [(op.kind, op.group_size)
                                     for op in counter.collectives],
                     "local": list(y.to_local().shape)}
    return out


def xlstm_wide_model_axis():
    """The reduced xlstm-1.3b (4 heads) trained on a model axis of 8:
    the mLSTM's output is flattened from heads that do not divide the
    axis, and its gradient must come back to rows it can unflatten."""
    cfg = get_reduced("xlstm-1.3b")
    mesh = fake_mesh((2, 8), ("data", "model"))
    rt = default_config(shard_strategy="fsdp_tp")
    c = stepcount.count(build_step(cfg, ShapeConfig("t", 16, 2, "train"),
                                   rt, mesh))
    return {"heads": cfg.n_heads, "flops": c.flops}


def evaluator():
    """RooflineEvaluator with its default mesh factory (the production
    mesh over the fake group): two counts, then the same trial from
    the cache; a second config that differs in an analytic knob only."""
    from repro_torch.core.trial import (CompileCache, RooflineEvaluator,
                                        Workload)
    ev = RooflineEvaluator(compile_cache=CompileCache(use_disk=False))
    wl = Workload("smollm-135m", "prefill_32k")
    rt = default_config(shard_strategy="fsdp_tp")
    first, again = ev(wl, rt), ev(wl, rt)
    tiles = ev(wl, rt.replace(attn_block_q=512))
    return {k: r.as_dict() for k, r in (("first", first), ("again", again),
                                        ("tiles", tiles))}


def dryrun():
    """``dryrun.run_cell`` for smollm-135m (cut to 2 layers) on every
    shape and both meshes; then the CLI on the cells that skip, writing
    its records to a temporary directory."""
    import pathlib
    import tempfile

    from repro_torch.core import trial
    from repro_torch.launch import dryrun as dr
    cut = lambda arch: get_config(arch).replace(n_layers=2)
    dr.get_config = trial.get_config = cut
    cells = [dr.run_cell("smollm-135m", shape, mp, save=False)
             for shape in ("train_4k", "prefill_32k", "decode_32k",
                           "long_500k") for mp in (False, True)]
    with tempfile.TemporaryDirectory() as d:
        dr.RESULTS_DIR = pathlib.Path(d)
        rc = dr.main(["--arch", "smollm-135m", "--shape", "long_500k",
                      "--both-meshes", "--quiet"])
        files = sorted(p.name for p in pathlib.Path(d).iterdir())
    return {"cells": cells, "cli_rc": rc, "cli_files": files}


def refuses_a_real_group():
    """A mesh that no process holds is refused in a process whose group
    is a real one (here gloo, one rank)."""
    import tempfile

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(f"{d}/s", 1),
                                rank=0, world_size=1)
        try:
            fake_mesh((4, 2), ("data", "model"))
            return "built"
        except RuntimeError as e:
            return str(e)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    import logging
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    result = {name: globals()[name]() for name in sys.argv[1:]}
    print(json.dumps(result, default=str))
