"""Hierarchical round tracing: nested spans, trace ids, a debug ring.

A copy of the JAX package's ``obs/trace.py``.  :class:`Tracer` records a
round's spans, which may nest (``span()`` inside ``span()``) and carry
``args``, from any thread; every tracer mints a process-unique
``trace_id`` that rides the round's payload, its Slack message and every
event-log line, the join key between an alert and the timeline of the
round that fired it.  ``phase(name)`` is a span at the caller's depth,
``record_timed_span`` backfills a span timed elsewhere (a probe child's
link legs), ``set_error`` labels a failed round, ``attach_subtrace``
stitches another tier's trace in as its own track, and ``chrome_trace()``
is the ``--trace FILE`` document.  :class:`TraceRing` keeps the last N
finished traces for readers on other threads, without locks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from itertools import count as _count
from typing import Dict, List, Optional, Tuple

# Trace ids are process-prefixed counters, not urandom-per-round: minting
# one costs a next() on the hot tick path, and uniqueness across processes
# comes from the 4-byte random prefix.
_PROC_PREFIX = os.urandom(4).hex()
_NEXT_TRACE = _count(1)


def new_trace_id() -> str:
    return f"{_PROC_PREFIX}{next(_NEXT_TRACE):08x}"


class _Span:
    """One open span: a context manager recording on exit.

    ``end()`` closes a manually started span (``start_span``) — but prefer
    ``with``: TNC017 flags bare ``start_span`` calls for a reason.
    """

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth", "_done")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._depth = 0
        self._done = False

    def __enter__(self) -> "_Span":
        tls = self._tracer._tls
        self._depth = getattr(tls, "depth", 0)
        tls.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if not self._done:
            self._done = True
            self._tracer._record(self, time.perf_counter())
        return False

    def end(self) -> None:
        self.__exit__(None, None, None)


class Tracer:
    """Collects one round's spans; cheap enough to always be on.

    Backwards-compatible with the original ``PhaseTimer`` surface:
    ``phase(name)`` / ``phases`` / ``total_ms()`` / ``as_dict()`` /
    ``chrome_trace()`` all behave as before — ``phase`` is simply a span
    at whatever nesting depth the caller is at.
    """

    def __init__(self, trace_id: Optional[str] = None,
                 round_seq: Optional[int] = None, mode: str = "round",
                 process_name: str = "tpu-node-checker"):
        self.trace_id = trace_id or new_trace_id()
        self.round_seq = round_seq
        self.mode = mode
        self.process_name = process_name
        self.ts = round(time.time(), 3)
        self.phases: Dict[str, float] = {}
        # (name, start_ms, dur_ms, depth, tid, args) in completion order.
        self.spans: List[Tuple] = []
        self.error: Optional[str] = None
        self._start = time.perf_counter()
        self._total_ms: Optional[float] = None
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}
        # [(label, trace_id, events)] — stitched sub-traces (the federation
        # aggregator attaches each upstream cluster's round trace here, so
        # one Chrome-trace document spans both tiers).
        self._subtraces: List[Tuple[str, Optional[str], list]] = []

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("merge"): ...`` — the one way spans close."""
        return _Span(self, name, args or None)

    def start_span(self, name: str, **args) -> _Span:
        """A span the caller must ``end()`` — escape hatch only; TNC017
        flags any call site that is not a ``with`` context expression."""
        span = _Span(self, name, args or None)
        span.__enter__()
        return span

    def phase(self, name: str) -> _Span:
        """PhaseTimer-compatible alias of :meth:`span`."""
        return _Span(self, name, None)

    def record_timed_span(self, name: str, dur_ms: float, **args) -> None:
        """Backfill a span whose duration was measured ELSEWHERE (the mesh
        probe child times each ICI link leg in-process and ships the
        numbers home in its report — re-timing them here would measure
        nothing).  The span lands at the tracer's current elapsed offset,
        back-dated by its duration, one nesting level below top.  It is
        deliberately NOT folded into :attr:`phases`: phase names feed the
        per-phase histogram and the payload ``timings`` block, and
        per-link names there would be unbounded-cardinality."""
        now_ms = (time.perf_counter() - self._start) * 1e3
        start_ms = max(0.0, now_ms - float(dur_ms))
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[ident] = tid
            self.spans.append(
                (name, start_ms, float(dur_ms), 1, tid, args or None)
            )

    def _record(self, span: _Span, t1: float) -> None:
        tls = self._tls
        tls.depth = max(0, getattr(tls, "depth", 1) - 1)
        start_ms = (span._t0 - self._start) * 1e3
        dur_ms = (t1 - span._t0) * 1e3
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[ident] = tid
            self.phases[span.name] = self.phases.get(span.name, 0.0) + dur_ms
            self.spans.append(
                (span.name, start_ms, dur_ms, span._depth, tid, span.args)
            )

    def set_error(self, message: str) -> None:
        """A failed round still completes its trace — labeled."""
        self.error = message

    def attach_subtrace(self, label: str, events: list,
                        trace_id: Optional[str] = None) -> None:
        """Stitch another tier's already-built Chrome-trace events into
        this trace as their own process track (the aggregator attaches
        each upstream cluster's round here).  Events are attached by
        reference and re-based onto a fresh ``pid`` at render time."""
        with self._lock:
            self._subtraces.append((label, trace_id, events))

    def finish(self) -> float:
        """Freeze and return the total; spans recorded after this still
        append but the round's total no longer moves (the ring's readers
        see a fixed doc)."""
        if self._total_ms is None:
            self._total_ms = (time.perf_counter() - self._start) * 1e3
        return self._total_ms

    # -- reading -------------------------------------------------------------

    def total_ms(self) -> float:
        if self._total_ms is not None:
            return self._total_ms
        return (time.perf_counter() - self._start) * 1e3

    def as_dict(self) -> Dict[str, float]:
        out = {k: round(v, 2) for k, v in self.phases.items()}
        out["total"] = round(self.total_ms(), 2)
        return out

    def summary(self) -> dict:
        """The ``/api/v1/debug/rounds`` list entry."""
        out = {
            "trace_id": self.trace_id,
            "round_seq": self.round_seq,
            "mode": self.mode,
            "ts": self.ts,
            "total_ms": round(self.total_ms(), 3),
            "spans": len(self.spans),
        }
        if self._subtraces:
            out["subtraces"] = [
                {"label": label, "trace_id": tid}
                for label, tid, _ in self._subtraces
            ]
        if self.error:
            out["error"] = self.error
        return out

    def chrome_trace(self) -> dict:
        """Trace-event-format document: one complete ``X`` event per span
        (depth/thread placement lets Perfetto nest them), metadata events
        carrying the trace identity, and one ``pid`` per stitched
        sub-trace."""
        events: List[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": 1, "tid": 1,
                "args": {"name": self.process_name},
            },
            {
                "name": "trace_id", "ph": "M", "pid": 1, "tid": 1,
                "args": {"trace_id": self.trace_id,
                         "round_seq": self.round_seq, "mode": self.mode},
            },
        ]
        for name, start_ms, dur_ms, depth, tid, args in self.spans:
            event = {
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": round(start_ms * 1e3, 1),  # microseconds
                "dur": round(dur_ms * 1e3, 1),
            }
            span_args = dict(args) if args else {}
            span_args["depth"] = depth
            event["args"] = span_args
            events.append(event)
        events.append(
            {
                "name": "total", "ph": "X", "pid": 1, "tid": 1,
                "ts": 0.0, "dur": round(self.total_ms() * 1e3, 1),
            }
        )
        for i, (label, sub_id, sub_events) in enumerate(self._subtraces):
            pid = 2 + i
            events.append(
                {"name": "process_name", "ph": "M", "pid": pid, "tid": 1,
                 "args": {"name": label}}
            )
            if sub_id:
                events.append(
                    {"name": "trace_id", "ph": "M", "pid": pid, "tid": 1,
                     "args": {"trace_id": sub_id}}
                )
            for sub in sub_events:
                if isinstance(sub, dict):
                    if sub.get("ph") == "M" and sub.get("name") in (
                        "process_name", "trace_id"
                    ):
                        # The sub-trace's own metadata would override the
                        # cluster:<name> track label we just emitted.
                        continue
                    rebased = dict(sub)
                    rebased["pid"] = pid
                    events.append(rebased)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "round_seq": self.round_seq,
                "mode": self.mode,
                "ts": self.ts,
            },
        }
        if self.error:
            doc["otherData"]["error"] = self.error
        return doc

    def chrome_trace_bytes(self) -> bytes:
        return (
            json.dumps(self.chrome_trace(), ensure_ascii=False) + "\n"
        ).encode("utf-8")


class TraceRing:
    """The last N completed round traces, queryable without locks.

    One writer (the round driver) assigns slots; readers (debug-endpoint
    request threads) scan a bounded window.  A reader racing the writer
    can only ever see a COMPLETE tracer reference — either the old slot
    occupant or the new one — because slot assignment is a single store
    (atomic under the GIL) and tracers are finished before they are
    pushed.
    """

    def __init__(self, size: int = 32):
        self.size = max(1, int(size))
        self._slots: List[Optional[Tracer]] = [None] * self.size
        self._n = 0

    def push(self, tracer: Tracer) -> None:
        self._slots[self._n % self.size] = tracer
        self._n += 1

    def entries(self) -> List[Tracer]:
        """Newest-first window of completed traces."""
        n = self._n
        out: List[Tracer] = []
        for i in range(1, min(n, self.size) + 1):
            entry = self._slots[(n - i) % self.size]
            if entry is not None:
                out.append(entry)
        return out

    def find(self, trace_id: str) -> Optional[Tracer]:
        for entry in self.entries():
            if entry.trace_id == trace_id:
                return entry
        return None
