"""Graded retry and backoff for the Kubernetes API path.

A copy of the JAX package's ``utils/retry.py``, held equal to it by
``tests/test_torch_copies.py``:

* GET/LIST retries freely within the budget; a PATCH only when the
  transport tags the failure ``request_never_sent``;
* full-jitter exponential backoff, with a ``Retry-After`` (delta-seconds
  or HTTP-date) as the floor of the next delay, and a ``Retry-After`` the
  budget cannot honour ends the sequence;
* per-call attempt caps plus one :class:`RetryBudget` of wall-clock
  seconds shared by every call of a round (``--retry-budget``), charged
  with the sleeps and the failed attempts; an exhausted budget surfaces the
  original error, so a failed LIST still exits 1.

Every clock is a seam (``sleep``/``monotonic``/``uniform``/``now`` on the
policy, and the module's ``_sleep``/``_monotonic``/``_wall_now``), so tests
run on a fake clock.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

# Test seams: resolved at CALL time (not bound at import), so monkeypatching
# these module globals redirects every policy that wasn't constructed with
# explicit injections — including the one the checker builds per round.
_sleep = time.sleep
_monotonic = time.monotonic
_wall_now = time.time

# HTTP statuses worth one more try on an idempotent request: throttling and
# the transient 5xx family a busy GKE apiserver / its LB actually emits.
# 410 is deliberately absent (the paginated LIST's expired-snapshot restart
# owns it) and 4xx config errors (401/403/404) are never retried.
RETRIABLE_STATUS = frozenset({429, 500, 502, 503, 504})

DEFAULT_MAX_ATTEMPTS = 4  # 1 original + up to 3 retries per call
DEFAULT_BASE_DELAY_S = 0.1
DEFAULT_MAX_DELAY_S = 2.0  # cap on any single backoff sleep
DEFAULT_BUDGET_S = 15.0  # shared per-run wall-clock retry allowance


def status_retry_reason(status_code) -> Optional[str]:
    """Map an HTTP status to its retry-reason label, or None (not retriable)."""
    if status_code == 429:
        return "http_429"
    if status_code in RETRIABLE_STATUS:
        return f"http_{status_code}"
    return None


def classify_retriable(exc: BaseException) -> Optional[str]:
    """Transient-error classifier: reason label when ``exc`` is worth a
    retry on an idempotent request, else None.

    Retriable: connect refused, connection reset/aborted/broken-pipe (and
    their http.client faces — a peer slamming the socket mid-exchange reads
    as ``BadStatusLine``/``RemoteDisconnected`` or a truncated body as
    ``IncompleteRead``), socket timeouts, and responses carrying a 429/5xx
    status (read from ``status_code`` on the exception or its ``response``,
    covering both ClusterAPIError and a drop-in requests.HTTPError).

    NOT retriable: everything else — TLS/cert failures, auth rejections,
    malformed JSON (a proxy serving HTML with a 200 is a config problem, not
    a blip), and any unknown exception.  Misclassifying a persistent error
    as transient would just burn the budget hiding it.
    """
    import http.client

    status = getattr(exc, "status_code", None)
    if status is None:
        status = getattr(getattr(exc, "response", None), "status_code", None)
    if status is not None:
        return status_retry_reason(status)
    if isinstance(exc, ConnectionRefusedError):
        return "connect_refused"
    if isinstance(
        exc, (ConnectionResetError, ConnectionAbortedError, BrokenPipeError)
    ):
        return "connection_reset"
    if isinstance(exc, (http.client.BadStatusLine, http.client.IncompleteRead)):
        # Peer closed between/mid response: same fault class as a reset.
        return "connection_reset"
    if isinstance(exc, TimeoutError):  # socket.timeout is this in 3.10+
        return "timeout"
    return None


def parse_retry_after(value, now: Optional[float] = None) -> Optional[float]:
    """Parse an HTTP ``Retry-After`` header: delta-seconds or HTTP-date.

    Returns non-negative seconds to wait, or None when absent/unparseable
    (an unparseable header degrades to plain backoff — never a crash on a
    server's malformed hint).  ``now`` injects the wall clock for the
    HTTP-date form (epoch seconds; defaults to the module seam).
    """
    if value is None:
        return None
    value = str(value).strip()
    if not value:
        return None
    try:
        return max(0.0, float(int(value)))  # delta-seconds (RFC: an integer)
    except ValueError:
        pass
    from email.utils import parsedate_to_datetime

    try:
        when = parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    if when.tzinfo is None:
        import datetime

        when = when.replace(tzinfo=datetime.timezone.utc)
    current = _wall_now() if now is None else now
    return max(0.0, when.timestamp() - current)


class RetryBudget:
    """Shared wall-clock allowance for retry overhead across ONE check round.

    Charged with both backoff sleeps (via :meth:`grant`, which clips the
    requested delay to what remains) and the elapsed cost of failed
    re-attempts (via :meth:`charge`), so "retry overhead" is true wall-clock
    added versus a no-retry run — a server that times out every attempt
    exhausts the budget by attempt cost alone.  Thread-safe: the bounded
    fan-out's workers all draw from the same budget, so N concurrently
    retrying workers cannot multiply the round's worst case by N.
    """

    def __init__(self, seconds: float):
        self.total = max(0.0, float(seconds))
        self._spent = 0.0
        self._lock = threading.Lock()

    @property
    def spent(self) -> float:
        with self._lock:
            return self._spent

    @property
    def remaining(self) -> float:
        with self._lock:
            return max(0.0, self.total - self._spent)

    @property
    def exhausted(self) -> bool:
        return self.remaining <= 0.0

    def charge(self, seconds: float) -> None:
        """Spend ``seconds`` unconditionally (failed re-attempt wall-clock)."""
        if seconds > 0:
            with self._lock:
                self._spent += seconds

    def grant(self, want: float) -> float:
        """Reserve up to ``want`` seconds of delay; returns what was granted
        (0 when the budget is exhausted — the caller must then stop
        retrying, not sleep-and-hope)."""
        want = max(0.0, want)
        with self._lock:
            remaining = self.total - self._spent
            if remaining <= 0.0:
                return 0.0
            granted = min(want, remaining)
            self._spent += granted
            return granted


class RetryPolicy:
    """Decision logic for one run's retries: attempt caps, full-jitter
    backoff, Retry-After floors, and the shared budget.

    Stateless across calls (per-call attempt counts live with the caller);
    the only shared mutable state is the :class:`RetryBudget`.  All time
    sources are injectable for deterministic tests.
    """

    def __init__(
        self,
        budget: Optional[RetryBudget] = None,
        max_attempts: int = DEFAULT_MAX_ATTEMPTS,
        base_delay_s: float = DEFAULT_BASE_DELAY_S,
        max_delay_s: float = DEFAULT_MAX_DELAY_S,
        sleep: Optional[Callable[[float], None]] = None,
        monotonic: Optional[Callable[[], float]] = None,
        uniform: Optional[Callable[[float, float], float]] = None,
        now: Optional[Callable[[], float]] = None,
    ):
        self.budget = budget if budget is not None else RetryBudget(DEFAULT_BUDGET_S)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self._sleep = sleep
        self._monotonic = monotonic
        self._uniform = uniform or random.uniform
        self._now = now

    # Clock surface the transport uses, so injected fakes govern both the
    # policy's own math and the caller's attempt-cost measurement.
    def monotonic(self) -> float:
        return (self._monotonic or _monotonic)()

    def now(self) -> float:
        return (self._now or _wall_now)()

    def wait(self, seconds: float) -> None:
        if seconds > 0:
            (self._sleep or _sleep)(seconds)

    def plan_retry(
        self, attempt: int, reason: str, retry_after: Optional[float] = None
    ) -> Optional[float]:
        """May failure number ``attempt`` (0-based) be retried?

        Returns the backoff delay to sleep before the next attempt (already
        reserved against the budget), or None — attempt cap reached, budget
        exhausted, or a ``Retry-After`` the remaining budget cannot honor.
        """
        if attempt + 1 >= self.max_attempts:
            return None
        if self.budget.exhausted:
            return None
        # Full jitter: uniform over (0, base·2^attempt], capped.  The floor
        # from Retry-After is applied AFTER jitter — the server's number is
        # a minimum, not a suggestion to randomize below.
        ceiling = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        want = self._uniform(0.0, ceiling)
        if retry_after is not None:
            want = max(want, retry_after)
        granted = self.budget.grant(want)
        if retry_after is not None and granted < retry_after:
            # Cannot honor the server's directive within budget: retrying
            # early would just re-trip the throttle — fail now, honestly.
            return None
        if want > 0 and granted <= 0:
            return None
        return granted
