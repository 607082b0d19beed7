"""The simulator's clock seam: the one module of the simulator that reads
the wall clock.

A copy of the JAX package's ``sim/clock.py``, held equal to it by
``tests/test_torch_copies.py``.  Everything else takes a clock object and
calls ``now()`` / ``sleep()`` on it: :class:`SimClock` is virtual time whose
sleeps are free, :class:`WallClock` paces for real.  :func:`wall_now`,
:func:`perf_ms` and :func:`wait_for` serve the few places that must touch
the wall clock: report freshness stamps, timings, and bounded waits on
real reader threads.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

#: The fixed virtual epoch every SimClock starts from — an arbitrary but
#: stable instant, so two runs of the same seed see identical timestamps.
SIM_EPOCH = 1_700_000_000.0


class SimClock:
    """Deterministic virtual clock: ``sleep`` advances time instantly.

    Thread-safe — fixture handlers pace from server threads while the
    scenario driver reads ``now()`` — and it records every sleep request
    (``sleeps``) so a test can assert a fault script *asked* to stall
    without anybody actually stalling.
    """

    def __init__(self, start: float = SIM_EPOCH):
        self._now = float(start)
        self._lock = threading.Lock()
        self.sleeps: List[float] = []

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._now += seconds
            self.sleeps.append(seconds)

    def advance(self, seconds: float) -> None:
        """Move virtual time forward without recording a sleep (the round
        boundary tick the scenario driver applies between rounds)."""
        with self._lock:
            self._now += max(0.0, float(seconds))


class WallClock:
    """The real-time clock with *interruptible* sleeps.

    ``interrupt`` (a ``threading.Event``) lets a fixture server shut down
    promptly mid-pace — the shape ``WatchScript.pace`` always had, now
    shared by every fault script instead of a bare ``time.sleep`` each.
    """

    def __init__(self, interrupt: Optional[threading.Event] = None):
        self._interrupt = interrupt

    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        if self._interrupt is not None:
            self._interrupt.wait(seconds)
        else:
            time.sleep(seconds)


def wall_now() -> float:
    """Real ``time.time()`` — for artifacts that outside code grades
    against the real clock (probe-report ``written_at`` freshness)."""
    return time.time()


def perf_ms() -> float:
    """Real monotonic milliseconds — bench timings only, never report
    content (wall durations are noise; the report must stay seed-pure)."""
    return time.perf_counter() * 1000.0


def wait_for(predicate: Callable[[], bool], timeout: float = 5.0,
             interval: float = 0.01, what: str = "condition") -> None:
    """Bounded real-time poll for a REAL resource (a watch reader thread
    draining frames off a live socket).  The *outcome* a scenario grades
    stays deterministic; only the arrival latency is physical."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"simulator timed out waiting for {what}")
