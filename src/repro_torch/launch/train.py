"""End-to-end training: data pipeline -> train step ->
checkpoints, preemption-safe restart, straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 4 --batch 4 --seq 32 --ckpt-interval 1 --log-interval 1
    PYTHONPATH=src python -m repro_torch.launch.train --seq 2048 --batch 4

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --device cpu \
        --reduced --steps 4 --batch 8 --seq 32 --shard-strategy fsdp

This is the PyTorch port of the reference's ``launch/train.py``:
``--device`` (default ``cuda``; with no card this raises unless
``--device cpu`` is given).  Without ``--reduced`` it trains the full
config.  The step is ``runtime/stepfn.build_train_step`` (attention and
norm on the eager ops: the kernels are forward-only).  Each logged step
prints the loss, the global gradient norm, the learning rate and the
step's milliseconds (host clock around the step and a synchronize).

A plain single-process run trains on one device.  Under ``torchrun``
with a world size above 1 each rank starts its process group (gloo on
the CPU, NCCL on the card, from torchrun's environment) and the step
runs on ``launch/mesh.make_host_mesh()`` with ``--shard-strategy``; the
batch is split by rows, every rank calls the checkpoint (rank 0 writes
it) and rank 0 prints.  ``--production-mesh`` builds the 16x16 mesh
and refuses any world size but 256.

Exit code 42 = preempted-after-checkpoint (relaunch with the same args;
this script always resumes from the latest checkpoint in --ckpt-dir if
one exists).
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.params import default_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft.preemption import PreemptionHandler, RESTART_EXIT_CODE
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.launch import mesh as M
from repro_torch.models.model import build_model, resolve_device
from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
from repro_torch.runtime.stepfn import build_train_step

CKPT_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch" / "train_ckpt"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR),
                    help="checkpoint directory (default: "
                         "results/torch/train_ckpt)")
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--log-interval", type=int, default=5)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--shard-strategy", default="dp")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.production_mesh and world != 256:
        raise SystemExit(
            f"--production-mesh: the 16x16 mesh needs 256 ranks (torchrun "
            f"across hosts, WORLD_SIZE=256); this launch has {world}")
    mesh = None
    if world > 1 or args.production_mesh:
        M.init_distributed(dev.type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = (M.make_production_mesh(device_type=dev.type)
                if args.production_mesh
                else M.make_host_mesh(device_type=dev.type))
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    rt = default_config(compute_dtype=args.compute_dtype,
                        shard_strategy=args.shard_strategy,
                        remat_policy=args.remat,
                        microbatches=args.microbatches)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"device: {name}  arch: {cfg.name}  "
        f"params≈{cfg.param_count()/1e6:.1f}M", flush=True)
    if mesh is not None:
        say(f"mesh: {M.axis_sizes(mesh)}  strategy: {rt.shard_strategy}",
            flush=True)

    optimizer = make_optimizer(cfg.optimizer,
                               cosine_schedule(args.lr, 10, args.steps))
    bundle = build_train_step(cfg, shape, rt, mesh, optimizer)
    model = build_model(cfg)

    pre = PreemptionHandler().install()
    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    watchdog = StragglerDetector(factor=3.0)
    try:
        start = mgr.latest_step()
        if start is not None:
            say(f"resuming from step {start}", flush=True)
            target = {"params": bundle.args[0], "opt": bundle.args[1]}
            state, _ = mgr.restore_latest(target, device=dev)
            params, opt_state = state["params"], state["opt"]
            start += 1
        else:
            params = model.init(args.seed, device=dev)
            opt_state = optimizer.init(params)
            start = 0

        data = SyntheticLM(cfg, shape, rt, dev, seed=args.seed, mesh=mesh)
        host = "host0"
        t_first = time.time()
        for step in range(start, args.steps):
            batch = data.batch_at(step)
            _sync(dev)
            t0 = time.time()
            params, opt_state, metrics = bundle.fn(params, opt_state, batch)
            _sync(dev)
            dt_step = time.time() - t0
            watchdog.heartbeat(host, step, dt_step)
            if step == start:
                say(f"first step (incl. allocation): "
                    f"{time.time()-t_first:.1f}s", flush=True)
            if step % args.log_interval == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {float(metrics['loss']):8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt_step*1e3:7.1f}ms",
                      flush=True)
            if watchdog.check():
                say(f"stragglers: {watchdog.flagged}", flush=True)
            mgr.maybe_save(step, {"params": params, "opt": opt_state},
                           extra={"step": step})
            if pre.requested():
                say("preemption requested -> checkpoint + exit", flush=True)
                mgr.maybe_save(step, {"params": params, "opt": opt_state},
                               extra={"step": step}, force=True)
                mgr.wait()
                return RESTART_EXIT_CODE
        mgr.maybe_save(args.steps - 1,
                       {"params": params, "opt": opt_state},
                       extra={"step": args.steps - 1}, force=True)
        mgr.wait()
    finally:
        pre.uninstall()
        if mesh is not None:
            torch.distributed.destroy_process_group()
    say("done.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
