"""Retry policy shared by the serving dispatcher."""
from __future__ import annotations

import random
from typing import Optional


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
