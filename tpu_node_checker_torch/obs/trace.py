"""Round tracing: nested spans and a trace id per round.

The part of the JAX package's ``obs/trace.py`` that the one-shot round
uses: :class:`Tracer` with ``phase()``, ``record_timed_span()``,
``as_dict()``, ``trace_id`` and ``chrome_trace()`` (``--trace FILE``).
Argument-carrying spans, the debug ring, sub-trace stitching and the error
label serve the watch loop and the federation tier, which the port does
not have yet.

Every tracer mints a process-unique ``trace_id`` that rides the round's
payload and its Slack message: the join key between an alert and the
timeline of the round that fired it.
"""

from __future__ import annotations

import os
import threading
import time
from itertools import count as _count
from typing import Dict, List, Optional, Tuple

# Trace ids are process-prefixed counters: uniqueness across processes
# comes from the 4-byte random prefix.
_PROC_PREFIX = os.urandom(4).hex()
_NEXT_TRACE = _count(1)


def new_trace_id() -> str:
    return f"{_PROC_PREFIX}{next(_NEXT_TRACE):08x}"


class _Span:
    """One open span: a context manager recording on exit."""

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


class Tracer:
    """Collects one round's spans; ``phase(name)`` is a span at whatever
    nesting depth the caller is at."""

    # A one-shot round: no round sequence, the JAX tracer's default mode and
    # process track name, so both packages' trace files read alike.
    round_seq = None
    mode = "round"
    process_name = "tpu-node-checker"

    def __init__(self):
        self.trace_id = new_trace_id()
        self.ts = round(time.time(), 3)
        self.phases: Dict[str, float] = {}
        # (name, start_ms, dur_ms, depth, tid, args) in completion order.
        self.spans: List[Tuple] = []
        self._start = time.perf_counter()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}

    def phase(self, name: str) -> _Span:
        """``with tracer.phase("probe"): ...``: one span of the round."""
        return _Span(self, name, None)

    def record_timed_span(self, name: str, dur_ms: float, **args) -> None:
        """Backfill a span whose duration was measured elsewhere (the mesh
        probe child times each link leg and ships the p50 home).  It lands
        at the tracer's current offset, back-dated by its duration, one
        level below top, and is not folded into :attr:`phases`: per-link
        names there would be unbounded."""
        now_ms = (time.perf_counter() - self._start) * 1e3
        start_ms = max(0.0, now_ms - float(dur_ms))
        with self._lock:
            tid = self._tid()
            self.spans.append((name, start_ms, float(dur_ms), 1, tid, args or None))

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
        return tid

    def _record(self, span: _Span, t1: float) -> None:
        tls = self._tls
        tls.depth = max(0, getattr(tls, "depth", 1) - 1)
        start_ms = (span._t0 - self._start) * 1e3
        dur_ms = (t1 - span._t0) * 1e3
        with self._lock:
            tid = self._tid()
            self.phases[span.name] = self.phases.get(span.name, 0.0) + dur_ms
            self.spans.append((span.name, start_ms, dur_ms, span._depth, tid, span.args))

    def total_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1e3

    def as_dict(self) -> Dict[str, float]:
        out = {k: round(v, 2) for k, v in self.phases.items()}
        out["total"] = round(self.total_ms(), 2)
        return out

    def chrome_trace(self) -> dict:
        """Trace-event-format document: one complete ``X`` event per span
        and metadata events carrying the trace identity, as the JAX
        tracer writes it (Perfetto, ``chrome://tracing``)."""
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 1,
             "args": {"name": self.process_name}},
            {"name": "trace_id", "ph": "M", "pid": 1, "tid": 1,
             "args": {"trace_id": self.trace_id, "round_seq": self.round_seq,
                      "mode": self.mode}},
        ]
        for name, start_ms, dur_ms, depth, tid, args in self.spans:
            span_args = dict(args) if args else {}
            span_args["depth"] = depth
            events.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": round(start_ms * 1e3, 1),  # microseconds
                "dur": round(dur_ms * 1e3, 1),
                "args": span_args,
            })
        events.append({"name": "total", "ph": "X", "pid": 1, "tid": 1,
                       "ts": 0.0, "dur": round(self.total_ms() * 1e3, 1)})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id, "round_seq": self.round_seq,
                          "mode": self.mode, "ts": self.ts},
        }
