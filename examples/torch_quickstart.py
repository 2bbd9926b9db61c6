"""Quickstart on the PyTorch port: train a small LM end to end.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 100] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given.  Uses the
public API only, through ``repro_torch.launch.train`` (config registry ->
model -> train step bundle -> data pipeline -> checkpointed loop);
checkpoints go to a temporary directory unless ``--ckpt-dir`` names one.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="torch_quickstart_") as tmp:
        return train_main([
            "--arch", args.arch, "--reduced", "--device", args.device,
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "128",
            "--ckpt-dir", args.ckpt_dir or tmp,
            "--ckpt-interval", "25",
        ])


if __name__ == "__main__":
    raise SystemExit(main())
