"""Wall-clock timer (reference: src/base/timer.h:29-66)."""

from __future__ import annotations

import time


class Timer:
    """Wall-clock stopwatch; `elapsed()` in seconds since construction/reset."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __enter__(self) -> "Timer":
        self.reset()
        return self

    def __exit__(self, *exc) -> None:
        pass
