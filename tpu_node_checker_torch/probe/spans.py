"""Spans and counters of one probe round, over :class:`~tpu_node_checker_torch.obs.trace.Tracer`.

The probe path's seam onto the port's tracer, port-only and torch-free (the
probe child imports it before ``import torch``):

* :class:`Round`: one round's ``Tracer``, its counters, and the pair of
  clocks (``unix_ns``, ``monotonic_ns``) read together;
  :func:`active` makes a round the current one, :func:`current` reads it;
* :func:`span` (``with span("probe.hbm_bandwidth_probe"): ...``): a span of
  the current round, a null context when there is none; while a
  ``torch.profiler`` records in this process it also opens
  ``record_function("tnc:<name>")``, so the span lands in the device trace
  on the trace's own clock; :func:`within`, a span of a given round from
  another thread (autograd's backward); :func:`count` adds to a counter;
* :func:`summary`: span name -> ``[count, total_ms, max_ms]``, what the
  report carries under ``spans`` (so a long soak stays a few lines);
* the parent's side: the child's settings (:func:`child_env`), the three
  spans the two processes time together on the shared monotonic clock
  (:meth:`Round.adopt_child`), the report's block (:meth:`Round.report_block`)
  and the ``--trace`` document (:meth:`Round.chrome_trace`).

``time.perf_counter`` and ``time.monotonic_ns`` read the same clock on
Linux (``CLOCK_MONOTONIC``), which the parent and the child share; a
``torch.profiler`` trace's time is Unix ns, ``ts`` x 1000 +
``baseTimeNanoseconds``, so a span's Unix time is its monotonic time less
``clock.monotonic_ns`` plus ``clock.unix_ns``.
"""

from __future__ import annotations

import contextvars
import sys
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from tpu_node_checker_torch.obs.trace import Tracer

# The parent's settings for the probe child: the round's trace id, and
# whether to send every span (for a --trace document), not the summary alone.
TRACE_ID_ENV = "TNC_TRACE_ID"
TRACE_EVENTS_ENV = "TNC_TRACE_EVENTS"
# Counters every probe child reports, 0 where its level never runs the work.
CHILD_COUNTERS = ("graph_captures", "graph_pool_reuses", "graph_replays", "kernels_built",
                  "kernels_cached", "soak_rounds")
# The caching allocator's counts, differenced from the first probe to the report.
ALLOCATOR_COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
                      "num_sync_all_streams")

_current: contextvars.ContextVar = contextvars.ContextVar("tnc_probe_round", default=None)


class Round:
    """One probe round's tracer and counters.

    ``origin_ns`` is the tracer's zero on the monotonic clock; ``clock`` is
    the pair read together at the round's start (the child passes the pair
    it read at its first statement).
    """

    def __init__(self, trace_id: Optional[str] = None, clock: Optional[dict] = None,
                 events: bool = False):
        # Read just before the tracer's own zero: a span placed by it is
        # never later than it ran.
        self.origin_ns = time.monotonic_ns()
        self.tracer = Tracer(trace_id=trace_id, mode="probe")
        self.clock = clock or {"unix_ns": time.time_ns(), "monotonic_ns": self.origin_ns}
        self.events = events
        self.counters: Dict[str, int] = {}
        self.child_clock: Optional[dict] = None

    def place(self, name: str, start_ns: int, end_ns: int) -> None:
        """A span timed on the monotonic clock across the two processes,
        placed where it happened, one level below the round."""
        self.tracer.spans.append((name, (start_ns - self.origin_ns) / 1e6,
                                  max(0, end_ns - start_ns) / 1e6, 1, 1, None))

    def span_events(self) -> List[dict]:
        """Every span as a Chrome-trace event, ``ts`` in microseconds from
        ``clock["monotonic_ns"]``."""
        shift_us = (self.origin_ns - self.clock["monotonic_ns"]) / 1e3
        return [{"name": name, "ph": "X", "pid": 1, "tid": tid,
                 "ts": round(start_ms * 1e3 + shift_us, 1), "dur": round(dur_ms * 1e3, 1),
                 "args": {"depth": depth}}
                for name, start_ms, dur_ms, depth, tid, _ in self.tracer.spans]

    # -- the probe child -----------------------------------------------------

    def child_block(self) -> dict:
        """The child's ``spans`` block, its own ``probe.child`` (first
        statement to now, as the report is serialised) included."""
        child_ms = (time.monotonic_ns() - self.clock["monotonic_ns"]) / 1e6
        ms = summary(self.tracer.spans)
        ms["probe.child"] = [1, round(child_ms, 3), round(child_ms, 3)]
        block = {"trace_id": self.tracer.trace_id, "clock": self.clock, "ms": ms,
                 "counters": dict(self.counters)}
        if self.events:
            block["events"] = self.span_events()
        return block

    # -- the parent ----------------------------------------------------------

    def adopt_child(self, block, spawn_ns: int, reaped_ns: int) -> None:
        """Place ``probe.spawn`` (the parent's spawn to the child's first
        statement), ``probe.child`` (first statement to the report) and
        ``probe.child_exit`` (the report to the child reaped: serialising
        and printing it, exit handlers, the CUDA context's teardown, the
        pipe), and stitch the child's span list, if it sent one, into this
        trace on the shared clock."""
        if not isinstance(block, dict) or not isinstance(block.get("clock"), dict):
            return
        self.child_clock = block["clock"]
        first_ns = int(self.child_clock["monotonic_ns"])
        child = (block.get("ms") or {}).get("probe.child")
        self.place("probe.spawn", spawn_ns, first_ns)
        if child:
            done_ns = first_ns + int(child[1] * 1e6)
            self.place("probe.child", first_ns, done_ns)
            self.place("probe.child_exit", done_ns, reaped_ns)
        events = block.pop("events", None)
        if events:
            shift_us = (first_ns - self.origin_ns) / 1e3
            self.tracer.attach_subtrace(
                "probe child", [{**e, "ts": round(e["ts"] + shift_us, 1)} for e in events],
                trace_id=block.get("trace_id"))

    def report_block(self, block=None) -> dict:
        """The report's ``spans``: the child's block (or an empty one where
        the child sent none) with this process's closed spans merged into
        ``ms``."""
        if not isinstance(block, dict):
            block = {"trace_id": self.tracer.trace_id, "clock": self.clock, "ms": {},
                     "counters": {}}
        block.setdefault("ms", {}).update(summary(self.tracer.spans))
        return block

    def chrome_trace(self) -> dict:
        """The round's ``--trace`` document: the tracer's, with the pair of
        clocks of ``ts`` 0 (and the child's, where it ran) in ``otherData``."""
        doc = self.tracer.chrome_trace()
        doc["otherData"]["clock"] = self.clock
        if self.child_clock is not None:
            doc["otherData"]["child_clock"] = self.child_clock
        return doc


def current() -> Optional[Round]:
    return _current.get()


@contextmanager
def active(round_: Round) -> Iterator[Round]:
    """``round_`` is the current round inside the block."""
    token = _current.set(round_)
    try:
        yield round_
    finally:
        _current.reset(token)


def child_round(clock: dict, environ) -> Round:
    """The probe child's round for its whole life: the parent's trace id,
    the pair of clocks of its first statement, its counters at 0."""
    round_ = Round(trace_id=environ.get(TRACE_ID_ENV) or None, clock=clock,
                   events=environ.get(TRACE_EVENTS_ENV) == "1")
    round_.counters.update(dict.fromkeys(CHILD_COUNTERS, 0))
    _current.set(round_)
    return round_


def child_env(round_: Optional[Round]) -> Dict[str, str]:
    """The settings the probe child of ``round_`` reads (none without one)."""
    if round_ is None:
        return {}
    env = {TRACE_ID_ENV: round_.tracer.trace_id}
    if round_.events:
        env[TRACE_EVENTS_ENV] = "1"
    return env


class _Bridged:
    """A tracer span that also opens ``record_function("tnc:<name>")``
    while a ``torch.profiler`` records in this process."""

    __slots__ = ("_span", "_name", "_range")

    def __init__(self, span, name: str):
        self._span, self._name, self._range = span, name, None

    def __enter__(self):
        self._span.__enter__()
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(f"tnc:{self._name}")
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self._span.__exit__(*exc)
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL = _Null()


def span(name: str):
    """``with span(name):`` a span of the current round; nothing without one."""
    round_ = _current.get()
    if round_ is None:
        return NULL
    return _Bridged(round_.tracer.span(name), name)


@contextmanager
def within(round_: Optional[Round], name: Optional[str] = None) -> Iterator[None]:
    """Inside ``round_``, made the current one, and its span ``name`` where
    one is given; nothing without a round.  For work that autograd runs on
    its own thread, where no round is current: the forward pass keeps
    :func:`current` for its backward to pass here."""
    if round_ is None:
        yield
        return
    with active(round_):
        if name is None:
            yield
        else:
            with span(name):
                yield


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current round's counter ``name``."""
    round_ = _current.get()
    if round_ is not None:
        round_.counters[name] = round_.counters.get(name, 0) + n


def summary(spans) -> Dict[str, list]:
    """Span name -> ``[count, total_ms, max_ms]`` over a tracer's spans."""
    out: Dict[str, list] = {}
    for name, _start, dur_ms, *_ in spans:
        row = out.get(name)
        if row is None:
            out[name] = [1, dur_ms, dur_ms]
        else:
            row[0] += 1
            row[1] += dur_ms
            row[2] = max(row[2], dur_ms)
    return {k: [c, round(t, 3), round(m, 3)] for k, (c, t, m) in out.items()}


def allocator_counts(device) -> Optional[Dict[str, int]]:
    """The caching allocator's :data:`ALLOCATOR_COUNTERS` on a card (a
    read on the host; None off the card)."""
    torch = sys.modules.get("torch")
    if torch is None or getattr(device, "type", None) != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {k: int(stats[k]) for k in ALLOCATOR_COUNTERS if k in stats}


def count_allocator(before: Optional[Dict[str, int]], device) -> None:
    """Count what the allocator did since ``before`` (:func:`allocator_counts`)."""
    after = allocator_counts(device) if before is not None else None
    for k, v in (after or {}).items():
        if k in before:
            count(k, v - before[k])
