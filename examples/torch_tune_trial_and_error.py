"""The paper's methodology on the PyTorch port: tune a runnable step
cell with the WALL-CLOCK evaluator, the Sec.-5 protocol (median of 5
runs, threshold accept, <= 10 trials), on a reduced model.

    PYTHONPATH=src python examples/torch_tune_trial_and_error.py [--device cpu]

Every trial is a measured train step on the CUDA device unless
``--device cpu`` is given.  (``python -m repro_torch.launch.tune --arch
<id> --shape <cell>`` walks a full-size cell the same way; ``--evaluator
repro_torch.core.trial:RooflineEvaluator`` prices it analytically for
the production mesh instead.)
"""
import argparse

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import report
from repro_torch.core.params import default_config
from repro_torch.core.tree import Stage, run_tuning
from repro_torch.core.trial import TrialRunner, WallClockEvaluator, Workload

ARCH = "smollm-135m"


class ReducedWorkload(Workload):
    """Same cell semantics, reduced config and a short train shape."""
    @property
    def cfg(self):
        return get_reduced(self.arch)

    @property
    def shp(self):
        return ShapeConfig("mini_train", 128, 8, "train")


# the stages that reach one device (sharding stages have nothing to do)
STAGES = [
    Stage("serializer", "spark.serializer",
          [dict(compute_dtype="bfloat16")]),
    Stage("memoryFraction", "spark.shuffle/storage.memoryFraction",
          [dict(remat_policy="dots"), dict(remat_policy="full")]),
    Stage("spill.compress", "spark.shuffle.spill.compress",
          [dict(remat_save_dtype="bfloat16")]),
    Stage("maxSizeInFlight", "spark.reducer.maxSizeInFlight",
          [dict(microbatches=2)]),
    Stage("directBufs", "spark.shuffle.io.preferDirectBufs",
          [dict(donate_buffers=False)]),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    wl = ReducedWorkload(ARCH, "train_4k")
    ev = WallClockEvaluator(repeats=args.repeats, device=args.device)
    runner = TrialRunner(wl, ev)
    rep = run_tuning(runner, default_config(), threshold=0.05,
                     stages=STAGES)
    print(report.tuning_markdown(rep))
    print(f"\n==> wall-clock speedup x{rep.speedup:.2f} "
          f"in {rep.n_trials} trials (cap 10)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
