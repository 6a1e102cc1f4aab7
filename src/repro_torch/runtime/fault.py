"""Fault tolerance: the retry policy of the serving dispatcher
(``Backoff``), and the trainer's step watchdog (straggler detection),
bounded step retries and a test fault injector (the reference's
``runtime/fault.py``)."""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepWatchdog:
    """EMA step-timer; flags steps slower than `threshold` × EMA."""

    threshold: float = 3.0
    decay: float = 0.9
    warmup: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _ema: float = 0.0
    _n: int = 0
    straggler_steps: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged."""
        self._n += 1
        if self._n <= self.warmup:
            self._ema = dt if self._ema == 0 else (
                self.decay * self._ema + (1 - self.decay) * dt
            )
            return False
        flagged = dt > self.threshold * self._ema
        if flagged:
            self.straggler_steps.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, self._ema)
        else:  # don't poison the EMA with outliers
            self._ema = self.decay * self._ema + (1 - self.decay) * dt
        return flagged

    def time_step(self, step: int):
        return _Timer(self, step)


class _Timer:
    def __init__(self, wd: StepWatchdog, step: int):
        self.wd, self.step = wd, step

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.wd.observe(self.step, time.monotonic() - self.t0)
        return False




class Backoff:
    """Jittered exponential backoff with a hard retry-time budget.

    ``next_delay()`` returns the next sleep (seconds): exponential from
    ``base_s`` up to ``cap_s``, multiplied by a uniform jitter in
    ``[1 - jitter, 1]`` so synchronized retriers de-correlate.  Once the
    cumulative delay would exceed ``budget_s`` it raises
    ``RuntimeError`` — a retry loop with a budget can stall, never hang.
    ``reset()`` after a success.
    """

    def __init__(self, base_s: float = 0.01, cap_s: float = 1.0,
                 budget_s: float = 30.0, jitter: float = 0.5,
                 seed: Optional[int] = None):
        self.base_s = base_s
        self.cap_s = cap_s
        self.budget_s = budget_s
        self.jitter = jitter
        self._seed = seed
        self._rng = random.Random(seed)
        self._attempt = 0
        self._spent = 0.0

    def next_delay(self) -> float:
        raw = min(self.cap_s, self.base_s * (2.0 ** self._attempt))
        delay = raw * (1.0 - self.jitter * self._rng.random())
        if self._spent + delay > self.budget_s:
            raise RuntimeError(
                f"retry budget exhausted after {self._attempt} attempts "
                f"({self._spent:.2f}s of {self.budget_s:.2f}s)")
        self._attempt += 1
        self._spent += delay
        return delay

    def reset(self) -> None:
        self._attempt = 0
        self._spent = 0.0

    def clone(self) -> "Backoff":
        """A fresh backoff with the same settings (one per retry loop)."""
        return Backoff(self.base_s, self.cap_s, self.budget_s, self.jitter, self._seed)


def run_with_retries(step_fn, state, batch, *, retries: int = 2,
                     on_failure: Optional[Callable[[int, Exception], None]] = None):
    """Execute one training step with bounded retries; repeated failure
    raises the last error.  Only a step that leaves its state as it was
    when it fails may be run again: the port's trainer retries its
    gradient stage and not its in-place update (``launch/train.py``)."""
    last = None
    for attempt in range(retries + 1):
        try:
            return step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 — deliberate boundary
            last = e
            if on_failure:
                on_failure(attempt, e)
    raise last


class FaultInjector:
    """Test utility: raises on selected steps (once each)."""

    def __init__(self, fail_steps):
        self.fail_steps = set(fail_steps)
        self.failed = set()

    def maybe_fail(self, step: int):
        if step in self.fail_steps and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected fault at step {step}")
