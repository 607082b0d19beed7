"""Native Prometheus histograms: lock-free record, merge-at-scrape.

A copy of the JAX package's ``obs/hist.py``.  A :class:`HistogramFamily`
records one sample as a ``bisect`` over fixed buckets and a list-index
increment on a recorder owned by the recording thread (registration, once
per thread and label, is the only locked step), and merges the recorders
at scrape time into cumulative ``_bucket``/``_sum``/``_count`` lines, the
shape ``histogram_quantile()`` reads.  Every family name carries its unit
(``_ms``, or ``_us``) and every family declares its buckets.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

# The latency ladder the project's assertions live on: sub-ms resolution
# where the serve p99 budget sits (<5 ms), round-trip resolution where the
# steady-round budget sits (<10 ms), and a tail out to 5 s for cold paths
# (cold 5k-node LIST ≈ 350 ms, federation seed ≈ 330 ms).  +Inf is
# implicit.
DEFAULT_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

# Microsecond ladder for the mesh link sweep: a healthy ICI hop sits in
# the tens-to-hundreds of µs, a SLOW grade lands just past its budget
# (``max(BUDGET_FLOOR_US, SLOW_FACTOR × baseline)``), and the 1 s tail
# catches a leg rescued from a hang by the hop deadline.  +Inf implicit.
MESH_LINK_BUCKETS_US = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    10000.0, 50000.0, 250000.0, 1000000.0,
)


def _fmt(value: float) -> str:
    """Bucket bound → label text (``0.1``, ``5``, ``1000``): trailing-zero
    free so identical bounds always render identical ``le`` values."""
    text = f"{value:g}"
    return text


class Histogram:
    """One single-writer recorder: a counts array plus a running sum.

    ``counts[i]`` holds observations in ``(buckets[i-1], buckets[i]]``;
    the final slot is the +Inf overflow.  Mutated by exactly one thread
    (the registering thread), read by any — element loads are atomic under
    the GIL, so a concurrent scrape sees monitoring-grade skew at worst.
    """

    __slots__ = ("buckets", "counts", "total")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0

    def record(self, value_ms: float) -> None:
        # bisect_left keeps the boundary Prometheus-shaped: a value equal
        # to a bound belongs to THAT bucket (le is ≤, not <).
        self.counts[bisect_left(self.buckets, value_ms)] += 1
        self.total += value_ms

    @property
    def count(self) -> int:
        return sum(self.counts)


class _Lease:
    """One thread's recorder set for one family, returned to the family's
    free-list when the thread dies (CPython drops thread-local values at
    thread exit, running this finalizer on the dying thread — off the
    serve read path, so its brief lock round is fine)."""

    __slots__ = ("_family", "by_label")

    def __init__(self, family: "HistogramFamily"):
        self._family = family
        self.by_label: Dict[str, Histogram] = {}

    def __del__(self):
        try:
            if self.by_label:
                self._family._release(self.by_label)
        except Exception:  # tnc: allow-broad-except(interpreter teardown: the family (or threading itself) may already be torn down when the last lease dies — a finalizer must never raise)
            pass


class HistogramFamily:
    """One metric family (optionally labeled), merged across per-thread
    recorders at scrape time.

    ``label`` names the label key (``phase``, ``route``, ``cluster``) — or
    a TUPLE of keys (``("slice", "axis")``) for a multi-label family, in
    which case every ``label_value`` passed to :meth:`record` must be a
    same-length tuple of values.  ``None`` makes the family label-free.
    Buckets are declared per family — TNC017 rejects an instantiation
    that omits them.
    """

    def __init__(self, name: str, help_text: str,
                 buckets: Tuple[float, ...],
                 label: Optional[object] = None):
        self.name = name
        self.help_text = help_text
        self.buckets = tuple(buckets)
        self.label = label
        self._register_lock = threading.Lock()
        # [(label_value, Histogram)] — append-only; scrapes iterate a
        # snapshot slice, never mutate.
        self._recorders: List[Tuple[str, Histogram]] = []
        # label_value -> recorders whose leasing thread has DIED, available
        # for re-lease.  Both major recording surfaces run on short-lived
        # threads (thread-per-connection handlers, per-round federation
        # fetchers); without reuse every dead thread would leak its
        # recorder into _recorders forever and the scrape-time merge would
        # grow without bound.  Counts are cumulative, so handing a dead
        # thread's recorder to a new thread never loses a sample.
        self._free: Dict[str, List[Histogram]] = {}
        self._tls = threading.local()

    # -- the hot path (TNC011-scanned: no locks, no I/O) ----------------------

    def record(self, value_ms: float, label_value: str = "") -> None:
        lease = getattr(self._tls, "lease", None)
        if lease is None:
            lease = self._tls.lease = _Lease(self)
        recorder = lease.by_label.get(label_value)
        if recorder is None:
            recorder = lease.by_label[label_value] = self._lease(label_value)
        recorder.record(value_ms)

    # -- registration (cold: once per thread per label value) -----------------

    def _lease(self, label_value: str) -> Histogram:
        """A recorder for THIS thread: a dead thread's returned recorder
        when one is free (its counts carry over — they are cumulative),
        else a fresh registration.  Live recorder count is bounded by peak
        thread concurrency, not by thread churn."""
        with self._register_lock:
            free = self._free.get(label_value)
            if free:
                return free.pop()
            recorder = Histogram(self.buckets)
            self._recorders.append((label_value, recorder))
        return recorder

    def _release(self, by_label: Dict[str, Histogram]) -> None:
        """Thread death (the lease's finalizer): recorders return to the
        free-list for the next thread.  They stay in _recorders — their
        accumulated counts must keep scraping."""
        with self._register_lock:
            for label_value, recorder in by_label.items():
                self._free.setdefault(label_value, []).append(recorder)

    def recorder(self, label_value: str = "") -> Histogram:
        """A dedicated recorder for single-writer callers that want to skip
        even the thread-local lookup (the round loop's pattern); never
        auto-released — the caller owns it for the process lifetime."""
        return self._lease(label_value)

    # -- the scrape path (TNC011-scanned: merge without locks) ----------------

    @property
    def count(self) -> int:
        return sum(rec.count for _, rec in list(self._recorders))

    def merged(self) -> Dict[str, Tuple[List[int], float, int]]:
        """``label_value -> (bucket counts, sum, count)`` summed across
        every thread's recorder.  Reads a snapshot slice of the recorder
        list; element-wise sums may lag in-flight records by one — skew,
        never tearing."""
        out: Dict[str, Tuple[List[int], float, int]] = {}
        for label_value, rec in list(self._recorders):
            counts = list(rec.counts)
            total = rec.total
            have = out.get(label_value)
            if have is None:
                out[label_value] = (counts, total, sum(counts))
            else:
                merged_counts = [a + b for a, b in zip(have[0], counts)]
                out[label_value] = (
                    merged_counts, have[1] + total, sum(merged_counts)
                )
        return out

    def prometheus_lines(self, merged=None) -> List[str]:
        """Text-exposition render: cumulative ``_bucket`` lines (``le``
        labels, ``+Inf`` included), ``_sum`` and ``_count`` — the shape
        ``histogram_quantile()`` consumes.  ``merged`` (a precomputed
        :meth:`merged` result) lets a caller rendering a derived view in
        the same scrape reuse ONE merge pass, so the two can never
        disagree."""
        from tpu_node_checker_torch.metrics import _line

        if merged is None:
            merged = self.merged()
        lines = [
            f"# HELP {self.name} {self.help_text}",
            f"# TYPE {self.name} histogram",
        ]
        for label_value, (counts, total, count) in sorted(merged.items()):
            if not self.label:
                base = {}
            elif isinstance(self.label, tuple):
                base = dict(zip(self.label, label_value))
            else:
                base = {self.label: label_value}
            cumulative = 0
            for bound, n in zip(self.buckets, counts):
                cumulative += n
                lines.append(
                    _line(self.name + "_bucket", float(cumulative),
                          {**base, "le": _fmt(bound)})
                )
            lines.append(
                _line(self.name + "_bucket", float(count),
                      {**base, "le": "+Inf"})
            )
            lines.append(
                _line(self.name + "_sum", round(total, 3), base or None)
            )
            lines.append(
                _line(self.name + "_count", float(count), base or None)
            )
        return lines
