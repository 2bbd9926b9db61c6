"""Run a function on N CPU ranks (gloo) for the port's multi-device
tests: one ``torch.multiprocessing`` spawn, a ``FileStore`` under the
test's temporary directory (no port is bound, so tests run side by
side), one thread per rank.  ``fn(rank, *args)`` must be importable (a
module-level function of a module that imports no JAX, so that a rank
loads only torch and the port); ``args`` reach the ranks through a file
(handing arrays to the spawn itself is slow); rank 0's return value
comes back."""
from __future__ import annotations

import os
import pickle
import warnings


def _entry(rank, fn, n, store, out, args_path):
    import logging
    import torch
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", store_path=store, rank=rank, world_size=n)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    try:
        res = fn(rank, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(fn, n: int, tmp_path, *args):
    import torch.multiprocessing as mp
    d = tmp_path / f"ranks_{fn.__name__}_{n}"
    d.mkdir(parents=True, exist_ok=True)
    out = d / "rank0.pkl"
    with open(d / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ)
    os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    try:
        mp.start_processes(_entry, args=(fn, n, str(d / "store"), str(out),
                                         str(d / "args.pkl")),
                           nprocs=n, join=True, start_method="spawn")
    finally:
        os.environ.clear()
        os.environ.update(env)
    with open(out, "rb") as f:
        return pickle.load(f)
