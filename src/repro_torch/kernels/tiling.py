"""Shared tile fitting for the public kernel wrappers.

The reference kernels require their block size to divide the gridded
dimension, so each public wrapper fits the requested block to the
largest divisor of the dimension that is not larger than the request.
The wrappers of this package apply ``fit_block`` too, so the logical
tile a knob value stands for is the same in both packages.  What the
fitted tile does on the card differs by kernel: the f32 attention
kernel runs it as its physical tile, flash_decode splits the live cache
into spans of it, the SSD scan runs its chunk; the bf16 attention
kernel runs tiles of its own (64 query rows, 64 or 32 keys) with the
ragged edge masked, so a prime S does not shrink its tiles to 1.

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
