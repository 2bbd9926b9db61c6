# Hand-written CUDA kernels for the compute hot-spots, one sub-package
# each: ops.py (public wrapper), ref.py (plain PyTorch version); the
# CUDA sources live under repro_torch/csrc/ and are built at first use
# by kernels/_build.py.
import torch


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
