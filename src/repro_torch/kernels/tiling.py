"""Shared tile fitting for the public kernel wrappers.

The reference kernels require their block size to divide the gridded
dimension, so each public wrapper fits the requested block to the
largest divisor of the dimension that is not larger than the request.
The CUDA kernels of this package mask ragged edges themselves and do
not need a dividing tile, but the wrappers still apply ``fit_block`` so
the logical tile a knob value stands for is the same in both packages.

The *tuner* is stricter on purpose: a tile knob that does not divide
the cell's sequence is a clean deterministic-crash trial
(``Knob.validate_tile``, core/space.py) — silent re-fitting during
tuning would alias distinct knob values to one measured config.
"""
from __future__ import annotations


def fit_block(block: int, n: int) -> int:
    """Largest divisor of ``n`` that is ``<= min(block, n)`` (and >= 1).

    Scans downward from the clamp; bounded by the clamp value itself,
    which for every kernel tile in the knob space is <= 512.
    """
    b = max(1, min(int(block), int(n)))
    while n % b:
        b -= 1
    return b
