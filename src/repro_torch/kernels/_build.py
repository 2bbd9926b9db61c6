"""Build and load the CUDA kernels of this package.

The sources under ``repro_torch/csrc/*.cu`` expose a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` — one
compiler process per source, all started together — linked into one
shared library under ``<repo root>/build/repro_torch/`` and loaded with
``ctypes``.  The library's file name carries a hash of the sources, so
an edited source is rebuilt and a finished build is reused.  Processes
(and threads) that build at once, as the fabric's workers do on a fresh
checkout, each compile into object files of their own and each land a
whole library by an atomic rename.

Nothing here runs when the module is imported: hosts without a CUDA
toolkit import the package and use the plain versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argument types (every one returns the
# cudaError_t of its launch as an int)
_SIGNATURES: Dict[str, List] = {
    # x, scale, y, rows, d, eps, plan (rmsnorm/ops.plan_code), stream
    "rt_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _P],
    # q, k, v, o, B, S, H, hd, causal, is_bf16, stream
    "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # hd, is_bf16 -> shared-memory bytes of one block (not an error code)
    "rt_flash_attention_smem": [_I, _I],
    # q, k, v, k_scale, v_scale, part_m, part_l, part_acc, tickets, out,
    # B, Smax, H, Hkv, hd, length, head slots, span, n_split, warps,
    # stages, kv_kind, q_is_bf16, stream
    "rt_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    # hd, kv_bytes, head slots, warps, stages -> shared-memory bytes of
    # one block (not an error code)
    "rt_flash_decode_smem": [_I, _I, _I, _I, _I],
    # X, Bm, Cm, dt, la, Y, h_final, slots, sync, sync_len, B, S, H, P, N,
    # x_is_bf16, stream
    "rt_ssm_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                    _I, _I, _I, _I, _I, _I, _P],
    # -> rows of the scan's own chunk (not an error code)
    "rt_ssm_scan_chunk": [],
    # B, S, H -> ints of the scan's sync buffer (a long long)
    "rt_ssm_scan_sync_len": [_I, _I, _I],
    # stream: fill every SM's shared memory with NaN (a check that a
    # kernel reads no shared memory it did not write; csrc/smem_poison.cu)
    "rt_smem_poison": [_P],
}
# entry points that return something other than an int
_RESTYPES = {"rt_ssm_scan_sync_len": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built on this host")


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: List[pathlib.Path]) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _compile(srcs: List[pathlib.Path], out: pathlib.Path,
             verbose: bool) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    # this build's own names: another process or thread may be building
    # the same digest into the same directory
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{out.stem}.{src.stem}.{tag}.o" for src in srcs]
    tmp = out.with_suffix(f".{tag}.tmp")
    try:
        procs = []
        for src, obj in zip(srcs, objs):
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        if verbose:
            print("".join(logs))
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n"
                               f"{done.stdout}")
        os.replace(tmp, out)     # concurrent builds each land a whole file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library; built from the sources at first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libkernels_{_digest(srcs)}.so"
    if not out.exists():
        t0 = time.time()
        _compile(srcs, out, verbose)
        build_seconds = time.time() - t0
    loaded = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _lib = loaded
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
