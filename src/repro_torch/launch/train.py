"""End-to-end training: data pipeline -> train step ->
checkpoints, preemption-safe restart, straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
        --steps 4 --batch 4 --seq 32 --ckpt-interval 1 --log-interval 1
    PYTHONPATH=src python -m repro_torch.launch.train --seq 2048 --batch 4

This is the PyTorch port of the reference's ``launch/train.py``, on one
device: ``--device`` (default ``cuda``; with no card this raises unless
``--device cpu`` is given).  Without ``--reduced`` it trains the full
config.  The step is ``runtime/stepfn.build_train_step`` (attention and
norm on the eager ops: the kernels are forward-only).  Each logged step
prints the loss, the global gradient norm, the learning rate and the
step's milliseconds (host clock around the step and a synchronize).

Exit code 42 = preempted-after-checkpoint (relaunch with the same args;
this script always resumes from the latest checkpoint in --ckpt-dir if
one exists).  ``--production-mesh`` (a mesh of many devices) raises,
naming the multi-device slice of ROADMAP.md.
"""
from __future__ import annotations

import argparse
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
from repro_torch.models.model import build_model, resolve_device
from repro_torch.optim.optimizers import cosine_schedule, make_optimizer
from repro_torch.runtime.stepfn import MULTI_DEVICE, build_train_step

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

    if args.production_mesh:
        raise NotImplementedError(
            f"--production-mesh: training on a mesh of devices is not "
            f"ported yet ({MULTI_DEVICE})")
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    rt = default_config(compute_dtype=args.compute_dtype,
                        shard_strategy=args.shard_strategy,
                        remat_policy=args.remat,
                        microbatches=args.microbatches)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}  arch: {cfg.name}  "
          f"params≈{cfg.param_count()/1e6:.1f}M", flush=True)

    optimizer = make_optimizer(cfg.optimizer,
                               cosine_schedule(args.lr, 10, args.steps))
    bundle = build_train_step(cfg, shape, rt, None, optimizer)
    model = build_model(cfg)

    pre = PreemptionHandler().install()
    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    watchdog = StragglerDetector(factor=3.0)
    try:
        start = mgr.latest_step()
        if start is not None:
            print(f"resuming from step {start}", flush=True)
            target = {"params": bundle.args[0], "opt": bundle.args[1]}
            state, _ = mgr.restore_latest(target, device=dev)
            params, opt_state = state["params"], state["opt"]
            start += 1
        else:
            params = model.init(args.seed, device=dev)
            opt_state = optimizer.init(params)
            start = 0

        data = SyntheticLM(cfg, shape, rt, dev, seed=args.seed)
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
                print(f"first step (incl. allocation): "
                      f"{time.time()-t_first:.1f}s", flush=True)
            if step % args.log_interval == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {float(metrics['loss']):8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt_step*1e3:7.1f}ms",
                      flush=True)
            if watchdog.check():
                print(f"stragglers: {watchdog.flagged}", flush=True)
            mgr.maybe_save(step, {"params": params, "opt": opt_state},
                           extra={"step": step})
            if pre.requested():
                print("preemption requested -> checkpoint + exit",
                      flush=True)
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
    print("done.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
