"""Straggler monitoring for long-running jobs
(``repro.training.fault_tolerance``): the part the train loop uses.

:class:`StragglerMonitor` keeps rolling step-time statistics with a
robust (median + MAD) threshold, flags slow steps, and its
``should_checkpoint_now`` hook asks for a checkpoint when step times
degrade persistently.  ``HeartbeatTracker`` and ``run_with_retries`` are
not ported.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    window: int = 64
    threshold: float = 3.0          # MADs above median = straggler
    degrade_patience: int = 8       # consecutive slow steps -> checkpoint

    _times: deque = field(default_factory=lambda: deque(maxlen=256))
    _slow_streak: int = 0
    flagged: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        self._times.append(seconds)
        if len(self._times) < 8:
            return False
        med = statistics.median(self._times)
        mad = statistics.median(abs(t - med) for t in self._times) or 1e-9
        is_slow = seconds > med + self.threshold * mad * 1.4826
        if is_slow:
            self.flagged.append((step, seconds, med))
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        return is_slow

    def should_checkpoint_now(self) -> bool:
        return self._slow_streak >= self.degrade_patience

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0
