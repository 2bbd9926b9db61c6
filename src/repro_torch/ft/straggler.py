"""Straggler mitigation: k-of-median step-time detection per host.

On a real fleet every host reports a heartbeat (host_id, step, seconds);
the detector flags hosts whose trailing-window median exceeds
``factor`` x the fleet median, and fires ``action`` (e.g. cordon +
respawn).  The PyTorch port's copy of the reference's
``ft/straggler.py``; it has no device code.  launch/train.py feeds it its
own step times (one host).
"""
from __future__ import annotations

import collections
import statistics
from typing import Callable, Deque, Dict, List, Optional


class StragglerDetector:
    def __init__(self, factor: float = 2.0, window: int = 16,
                 min_samples: int = 4,
                 action: Optional[Callable[[str, float, float], None]] = None):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.action = action
        self._times: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self.flagged: List[str] = []

    def heartbeat(self, host: str, step: int, seconds: float):
        self._times[host].append(seconds)

    def _host_median(self, host: str) -> Optional[float]:
        t = self._times[host]
        if len(t) < self.min_samples:
            return None
        return statistics.median(t)

    def check(self) -> List[str]:
        """Returns hosts currently flagged as stragglers."""
        meds = {h: m for h in self._times
                if (m := self._host_median(h)) is not None}
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        out = []
        for h, m in meds.items():
            if m > self.factor * fleet:
                out.append(h)
                if h not in self.flagged:
                    self.flagged.append(h)
                    if self.action:
                        self.action(h, m, fleet)
        return out
