"""Observability of the watch loop: round traces, histograms, event log.

A copy of the JAX package's ``obs/__init__.py``.  :class:`Observability`
bundles one process's :class:`~tpu_node_checker_torch.obs.trace.TraceRing`
of finished round traces, its
:class:`~tpu_node_checker_torch.obs.events.EventLog` (``--event-log``) and
the histogram families it owns:

* ``tpu_node_checker_round_phase_duration_ms{phase}``: each round phase's
  cost (``phase="total"`` is the whole round);
* ``tpu_node_checker_federation_fetch_duration_ms{cluster}``: the
  federation tier's fetches (``--federate``);
* ``tpu_node_checker_mesh_link_duration_us{slice,axis}``: each link leg's
  p50 from the mesh probe level, in microseconds.

``prometheus_lines()`` renders every family holding samples; the watch
loop's ``--metrics-port`` scrape appends them to each round's body.
"""

from __future__ import annotations

import os
from typing import List, Optional

from tpu_node_checker_torch.obs.events import EventLog
from tpu_node_checker_torch.obs.hist import (
    DEFAULT_LATENCY_BUCKETS_MS,
    MESH_LINK_BUCKETS_US,
    HistogramFamily,
)
from tpu_node_checker_torch.obs.trace import Tracer, TraceRing

# Completed round traces kept queryable; a debugging session needs the last
# few minutes of rounds, not an archive (the --trace file is the archive).
DEFAULT_RING_SIZE = 32


class Observability:
    """One process's observability state: trace ring, histograms, events.

    Created once per mode entry (``--watch``, ``--federate``, standalone
    ``--serve``) and threaded to the round driver and the serving layer —
    never a module global, so tests and embedded uses get isolated state.
    """

    def __init__(
        self,
        cluster: Optional[str] = None,
        event_log: Optional[str] = None,
        ring_size: int = DEFAULT_RING_SIZE,
    ):
        self.cluster = cluster
        self.ring = TraceRing(ring_size)
        self.events = EventLog(event_log, cluster=cluster)
        self.round_phases = HistogramFamily(
            "tpu_node_checker_round_phase_duration_ms",
            "Round phase cost distribution (phase='total' = the whole "
            "round) — histogram_quantile-able tail latency per phase.",
            DEFAULT_LATENCY_BUCKETS_MS,
            label="phase",
        )
        self.federation_fetch = HistogramFamily(
            "tpu_node_checker_federation_fetch_duration_ms",
            "Per-cluster upstream fleet-API fetch cost in the federation "
            "aggregator (304 rounds included — they are the steady state).",
            DEFAULT_LATENCY_BUCKETS_MS,
            label="cluster",
        )
        self.mesh_links = HistogramFamily(
            "tpu_node_checker_mesh_link_duration_us",
            "Per-link ICI sweep p50 from the mesh probe level, in "
            "MICROSECONDS (the one _us family) — one sample per link per "
            "round, labeled by slice domain and mesh axis.",
            MESH_LINK_BUCKETS_US,
            label=("slice", "axis"),
        )
        self._families = [
            self.round_phases, self.federation_fetch, self.mesh_links
        ]
        # phase name -> dedicated Histogram recorder.  complete() runs on
        # the ONE round-driver thread, so it can skip record()'s
        # thread-local hop entirely — the steady watch round is ~15µs all
        # in, and the BENCH_r09 gate caps the whole tracing tax at 15%.
        self._phase_recorders: dict = {}

    @classmethod
    def from_args(cls, args) -> "Observability":
        """The CLI seam.  The cluster stamp follows the metrics-label
        policy: only EXPLICIT identity (``--cluster-name`` / env) rides on
        event lines — an inferred hostname would churn per pod restart."""
        cluster = (
            getattr(args, "cluster_name", None)
            or os.environ.get("TNC_CLUSTER_NAME")
            or None
        )
        return cls(
            cluster=cluster, event_log=getattr(args, "event_log", None)
        )

    def tracer(self, round_seq: Optional[int] = None,
               mode: str = "round") -> Tracer:
        return Tracer(round_seq=round_seq, mode=mode)

    def complete(self, tracer: Tracer) -> Tracer:
        """Finish one round's trace: freeze the clock, feed every phase
        total (plus the round total) into the phase histogram, and push
        the trace into the debug ring.  Called from the round driver's
        thread — readers of the ring only ever see finished traces."""
        total_ms = tracer.finish()
        recorders = self._phase_recorders
        for name, ms in tracer.phases.items():
            recorder = recorders.get(name)
            if recorder is None:
                recorder = recorders[name] = self.round_phases.recorder(name)
            recorder.record(ms)
        recorder = recorders.get("total")
        if recorder is None:
            recorder = recorders["total"] = self.round_phases.recorder("total")
        recorder.record(total_ms)
        self.ring.push(tracer)
        return tracer

    def record_mesh_links(self, samples) -> None:
        """Feed one round's mesh link sweep into the per-link histogram.
        ``samples`` is an iterable of ``(slice_domain, axis, p50_us)``
        triples (the checker derives them from each node's
        ``collective_legs_ok.links`` block).  Runs on the round-driver
        thread; record()'s thread-local hop makes that cheap, and label
        cardinality is bounded by slices × mesh axes, not by hop."""
        for slice_domain, axis, p50_us in samples:
            self.mesh_links.record(
                float(p50_us), (str(slice_domain), str(axis))
            )

    def prometheus_lines(self) -> List[str]:
        """Scrape-time render of every family with data.  Merging reads
        the recorder lists without locks (TNC011: this runs on the serve
        read path)."""
        lines: List[str] = []
        for family in self._families:
            if family.count:
                lines.extend(family.prometheus_lines())
        return lines


__all__ = [
    "DEFAULT_LATENCY_BUCKETS_MS",
    "DEFAULT_RING_SIZE",
    "MESH_LINK_BUCKETS_US",
    "EventLog",
    "HistogramFamily",
    "Observability",
    "TraceRing",
    "Tracer",
]
