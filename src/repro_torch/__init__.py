"""PyTorch/CUDA port of the tuning system, beside the JAX reference.

Same sub-package layout and the same module and function names as the
reference package, so the counterpart of a module is found by path.
Imports ``torch`` and numpy only.
"""
