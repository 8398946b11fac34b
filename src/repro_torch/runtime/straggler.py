"""Straggler detection via a per-step wall-time EMA and heartbeats, the
port of the reference's ``repro.runtime.straggler``.

A step whose time exceeds ``threshold x`` the EMA (after ``warmup_steps``)
is flagged and handed to ``on_straggler`` (the trainer checkpoints at
once); the EMA adapts with the clamped sample, so one straggler does not
poison the baseline.  Pure bookkeeping: no device is involved.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ema: float
    ratio: float


class StragglerDetector:
    def __init__(self, *, threshold: float = 2.0, ema_alpha: float = 0.1,
                 warmup_steps: int = 5,
                 heartbeat_timeout: float = 600.0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.warmup = warmup_steps
        self.heartbeat_timeout = heartbeat_timeout
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.n = 0
        self.events: list[StragglerEvent] = []
        self._last_beat = time.monotonic()

    def record(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        """Feed one step's wall time; returns an event if it straggled."""
        self._last_beat = time.monotonic()
        self.n += 1
        if self.ema is None:
            self.ema = step_time
            return None
        ev = None
        if self.n > self.warmup and step_time > self.threshold * self.ema:
            ev = StragglerEvent(step, step_time, self.ema,
                                step_time / self.ema)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        # slow-adapt the EMA with the *clamped* sample so one straggler
        # doesn't poison the baseline
        sample = min(step_time, (self.threshold if ev else 1.0) * self.ema)
        self.ema = (1 - self.alpha) * self.ema + self.alpha * sample
        return ev

    def heartbeat_stale(self) -> bool:
        return time.monotonic() - self._last_beat > self.heartbeat_timeout


__all__ = ["StragglerEvent", "StragglerDetector"]
