"""Fault tolerance: step watchdog (straggler detection), preemption
handling, and a restarting run-loop — a copy of
``repro/runtime/fault.py`` (pure Python).

In synchronous SPMD, a straggling host shows up as an inflated wall-clock
step; the watchdog keeps a robust running estimate (median + MAD) and flags
outlier steps.  Policy hooks: ``on_straggler`` triggers checkpoint-now, so a
subsequent hard failure loses zero healthy work; repeated straggling is the
signal the elastic path (the reference's checkpoint/reshard.py)
keys off.

``run_with_restarts`` is the crash loop of the fault-injection tests:
any exception (or simulated preemption) restarts the step function from
the latest checkpoint, up to ``max_restarts``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


class SimulatedPreemption(RuntimeError):
    """Raised by tests / chaos hooks to emulate a node loss."""


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 3.0          # x median
    warmup_steps: int = 5
    window: int = 50

    def __post_init__(self):
        self._times: List[float] = []
        self.straggler_steps: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        hist = self._times[-self.window:]
        self._times.append(seconds)
        if len(hist) < self.warmup_steps:
            return False
        med = sorted(hist)[len(hist) // 2]
        if seconds > self.threshold * max(med, 1e-9):
            self.straggler_steps.append(step)
            return True
        return False

    @property
    def median(self) -> Optional[float]:
        if not self._times:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed_steps: int
    straggler_steps: List[int]


def run_with_restarts(
    make_state: Callable[[], tuple],
    step_fn: Callable,
    save_fn: Callable,
    restore_fn: Callable,
    total_steps: int,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    watchdog: Optional[StepWatchdog] = None,
    on_straggler: Optional[Callable] = None,
) -> RestartReport:
    """Generic fault-tolerant loop.

    make_state() -> (step, state); step_fn(step, state) -> state;
    save_fn(step, state); restore_fn() -> Optional[(step, state)].
    """
    wd = watchdog or StepWatchdog()
    restarts = 0
    while True:
        restored = restore_fn()
        step, state = restored if restored is not None else make_state()
        try:
            while step < total_steps:
                t0 = time.monotonic()
                state = step_fn(step, state)
                dt = time.monotonic() - t0
                if wd.observe(step, dt):
                    if on_straggler is not None:
                        on_straggler(step, state)
                    else:
                        save_fn(step + 1, state)
                step += 1
                if step % checkpoint_every == 0:
                    save_fn(step, state)
            save_fn(step, state)
            return RestartReport(restarts=restarts, completed_steps=step,
                                 straggler_steps=wd.straggler_steps)
        except SimulatedPreemption:
            restarts += 1
            if restarts > max_restarts:
                raise
