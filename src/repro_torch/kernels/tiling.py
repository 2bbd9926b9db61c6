"""Shared tile fitting for the public kernel wrappers.

The reference kernels require their block size to divide the gridded
dimension, so each public wrapper fits the requested block to the
largest divisor of the dimension that is not larger than the request.
The wrappers of this package apply ``fit_block`` too, so the logical
tile a knob value stands for is the same in both packages.  What the
fitted tile does on the card differs by kernel: flash_decode splits the
live cache into spans of it; the attention kernels (bf16 and f32) and the
SSD scan run tiles and chunks of their own at every length, the ragged
edge masked, so a prime S does not shrink them to 1 -- the fitted tile
names the logical tile only.

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
