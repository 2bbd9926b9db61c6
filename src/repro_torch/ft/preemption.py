"""Preemption handling: SIGTERM/SIGINT -> graceful checkpoint -> restart.

The training loop (launch/train.py) polls ``requested()`` each step;
on preemption it commits a final checkpoint and exits with
RESTART_EXIT_CODE, which the cluster launcher maps to a relaunch
(launch/train.py always resumes from the latest checkpoint).  The PyTorch port's copy of the reference's
``ft/preemption.py``; it has no device code.
"""
from __future__ import annotations

import signal
import threading

RESTART_EXIT_CODE = 42


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def _on_signal(self, signum, frame):
        self._flag.set()

    def requested(self) -> bool:
        return self._flag.is_set()

    def trigger(self):            # tests / simulated preemption
        self._flag.set()

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
