# Hand-written CUDA kernels for the compute hot-spots, one sub-package
# each: ops.py (public wrapper), ref.py (plain PyTorch version); the
# CUDA sources live under repro_torch/csrc/ and are built at first use
# by kernels/_build.py.
import torch


def _warm_host_exp() -> None:
    """One throwaway host ``torch.exp`` in f32 and in f64 over 2048
    elements per thread.  A process's first vector exp on the host
    (MKL's, run in blocks of 2048 over the threads) can return one block
    at ~1.5e-4 relative error in f32 (3.3e-9 in f64) while every later
    call is exact, so no exp of the port's plain versions and models
    (``models/layers`` imports this package) is a thread's first
    (``scripts/fresh_exp_probe.py`` counts it over fresh processes)."""
    n = 2048 * max(1, torch.get_num_threads())
    for dtype in (torch.float32, torch.float64):
        torch.exp(torch.linspace(-30.0, 30.0, n, dtype=dtype))


_warm_host_exp()


def forward_only(name: str, *tensors) -> None:
    """Raise if a kernel wrapper is asked for a result that would need a
    gradient.  The kernels are forward-only, as the reference's Pallas
    kernels are (they have no VJP): a step that needs gradients takes
    attention and norm through the eager ops, which
    runtime/stepfn.build_train_step arranges once, not a fallback inside
    the wrappers."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is forward-only and has no backward; a "
            "step that needs gradients runs attn_impl='xla' (eager ops)")
