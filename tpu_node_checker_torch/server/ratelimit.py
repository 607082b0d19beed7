"""Token-bucket rate limiting for the fleet API's write path
(``--write-rps``).

A copy of the JAX package's ``server/ratelimit.py``, held equal to it by
``tests/test_torch_copies.py``.  Sustained ``rate`` tokens a second with a
burst of the same size (at least 1); a refusal answers 429 with a
``Retry-After`` the client's retry ladder honors.  The clock is a
constructor seam, so tests drive the refill without sleeping.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional


class TokenBucket:
    """Classic token bucket: ``burst`` capacity, ``rate`` tokens/second.

    Thread-safe — request handler threads race on it by design.  ``rate``
    must be positive (a zero-rate bucket could never answer a honest
    ``Retry-After``; disable limiting by not constructing one).
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 monotonic: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError("token bucket rate must be positive")
        self.rate = float(rate)
        # Default burst: the per-second rate itself, floored at 1 so a
        # sub-1 rps bucket still admits single requests.
        self.burst = float(burst) if burst is not None else max(1.0, self.rate)
        self._monotonic = monotonic
        self._tokens = self.burst
        self._last = monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, tokens: float = 1.0) -> float:
        """Take ``tokens`` if available → ``0.0``; else seconds until they
        would be (the ``Retry-After`` floor).  Refusal accounting lives
        with the caller (``ServerStats.rate_limited`` feeds the metric) —
        one source of truth, not two counters."""
        with self._lock:
            now = self._monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= tokens:
                self._tokens -= tokens
                return 0.0
            return (tokens - self._tokens) / self.rate


def retry_after_header(wait_s: float) -> str:
    """Seconds-to-wait → the ``Retry-After`` delta-seconds header value.

    Ceiled to a whole second (the RFC form is an integer) and floored at 1
    so a caller honoring the header always waits long enough to find a
    token — the round-trip contract ``utils/retry.parse_retry_after``
    tests pin.
    """
    return str(max(1, math.ceil(wait_s)))
