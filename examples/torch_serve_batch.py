"""Batched serving on the PyTorch port: prefill a prompt batch, stream
decode steps, compare a bf16 and an int8 KV cache (the
spark.rdd.compress analogue).

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

Runs on the CUDA device (through the hand-written kernels) unless
``--device cpu`` is given.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for kv in ("bfloat16", "int8"):
        print(f"\n=== kv_cache_dtype={kv} ===")
        rc = serve_main(["--arch", "glm4-9b", "--reduced", "--batch", "4",
                         "--prompt-len", "32", "--gen-tokens", "12",
                         "--kv-dtype", kv, "--device", args.device])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
