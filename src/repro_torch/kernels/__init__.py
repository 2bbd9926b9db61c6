# Hand-written CUDA kernels for the compute hot-spots, one sub-package
# each: ops.py (public wrapper), ref.py (plain PyTorch version); the
# CUDA sources live under repro_torch/csrc/ and are built at first use
# by kernels/_build.py.
