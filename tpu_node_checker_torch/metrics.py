"""Prometheus-format metrics: the ``--metrics-port`` scrape of both loops.

A copy of the JAX package's ``metrics.py``.  :func:`render_metrics` turns a
round's :class:`~tpu_node_checker_torch.checker.CheckResult` into the text
exposition format (version 0.0.4).  Family names, label sets, HELP and TYPE
text are the JAX package's byte for byte (the TPU words in the HELP text
included): the PrometheusRule and the dashboards read them, and tests hold
the two scrapes equal.  What renders depends on the payload: the fleet round
of the aggregator's ``--watch`` loop renders the fleet families; with
``--probe``, or in an emitter round (payload ``{"local_probe": report}``),
the probe families of its report; every round the exit code, duration and
timestamp, and in the ``--watch`` loop the breaker's.  The fleet API server
appends its own request families to ``/metrics`` under ``--serve``, and
:class:`MetricsServer` serves the latest body on a thread of its own, with
the round's phase histograms (``obs``) appended.

Exported metric families:

* ``tpu_node_checker_nodes{state="total|ready"}`` — accelerator node counts;
* ``tpu_node_checker_chips{state="total|ready"}`` — device counts;
* ``tpu_node_checker_slice_complete{nodepool,topology}`` — per-slice 0/1;
* ``tpu_node_checker_slice_ready_chips{nodepool,topology}`` / ``..._expected_chips``;
* ``tpu_node_checker_exit_code`` — the would-be CLI exit code (0/2/3);
* ``tpu_node_checker_check_duration_ms`` — end-to-end phase total;
* ``tpu_node_checker_last_run_timestamp_seconds`` — staleness detector;
* ``tpu_node_checker_probe_*`` — when ``--probe`` ran: pass/fail by level and
  numeric chip telemetry (device count, MXU TFLOP/s, HBM/DMA GB/s, collective
  bus and per-link ICI bandwidth, workload step time);
* ``tpu_node_checker_probe_perf_floor_ok{generation}`` /
  ``..._probe_perf_floor_ratio{metric}`` — floor grading of measured perf
  vs the device kind's published peak (a ratio trending down is thermal
  degradation in progress);
* ``tpu_node_checker_probe_fault_domain_ok{axis}`` — multislice hybrid-mesh
  verdicts (axis ``dcn`` = the slice boundary) and
  ``..._probe_dcn_busbw_gbps`` — cross-slice bandwidth;
* ``tpu_node_checker_probe_reports_skipped{reason}`` — refused report files
  (stale / future_skew / unreadable / schema);
* ``tpu_node_checker_probe_hosts{state="reported|ok|failed|missing|floor_failed"}`` — the
  ``--probe-results`` fleet roll-up, plus
  ``tpu_node_checker_probe_host_unhealthy{host,state}`` naming each sick host;
* ``tpu_node_checker_multislice_{complete,ready_chips,slices}{group}`` — the
  DCN-joined multislice roll-up, when grouping labels are present;
* ``tpu_node_checker_{cordoned,uncordoned}_nodes`` and
  ``tpu_node_checker_cordon_skipped_over_cap`` — the quarantine lifecycle
  (nonzero skipped-over-cap means humans must look NOW);
* ``tpu_node_checker_kind_mismatch_nodes`` — nodes whose probed TPU
  generation contradicts their GKE accelerator label;
* ``tpu_node_checker_node_notready{reason}`` — NotReady node counts keyed by
  the kubelet Ready-condition reason (KubeletNotReady vs NetworkUnavailable
  vs NodeStatusUnknown route to different responders);
* ``tpu_node_checker_slice_expected_chips{nodepool,topology}`` — the per-slice
  denominator ``slice_ready_chips`` is graded against;
* ``tpu_node_checker_planned_disruption_nodes`` — sick nodes attributed to a
  planned GKE disruption (maintenance/upgrade), split out of availability;
* ``tpu_node_checker_node_state{state}`` /
  ``tpu_node_checker_node_flaps_total`` — hysteresis FSM occupancy (all five
  states always emitted) and the monotonic flap counter, under ``--history``;
* ``tpu_node_checker_round_degraded`` — 1 when the round completed but a
  non-fatal phase (events/cordon/uncordon) degraded;
* ``tpu_node_checker_api_{connections_opened,requests,requests_reused}_total``
  and ``tpu_node_checker_api_retries_total{reason}`` — k8s API transport
  lifecycle: sockets dialed, requests sent, keep-alive reuse, retry ladder;
* ``tpu_node_checker_api_list_truncated_total{resource}`` — paginated LIST
  walks whose page budget ran out with the continue token still set (the
  listing's tail was silently absent before this counter existed);
* ``tpu_node_checker_watch_breaker_open`` /
  ``tpu_node_checker_watch_breaker_consecutive_failures`` — watch-mode
  circuit-breaker state ("the monitor itself is degraded" is alertable
  separately from "the fleet is degraded");
* ``tpu_node_checker_watch_stream_events_total{type}`` /
  ``tpu_node_checker_watch_relists_total{reason}`` /
  ``tpu_node_checker_watch_stream_age_seconds`` — watch-stream mode
  (``--watch-stream``): events folded into the node cache by type, full
  LISTs by cause (seed / 410 gone / stream loss — steady state adds none),
  and seconds since the stream last showed life;
* ``tpu_node_checker_api_server_workers`` — accept loops serving the
  fleet API (``--serve-workers`` SO_REUSEPORT pool size; 1 = single
  listener, including the no-SO_REUSEPORT fallback);
* ``tpu_node_checker_api_server_rate_limited_total`` — authenticated
  write requests refused 429 by the ``--write-rps`` token bucket;
* ``tpu_node_checker_api_server_swr_stale_served_total`` — ``/api/v1/trend``
  responses served stale while a background rebuild ran
  (stale-while-revalidate hits; a climbing rate with no matching rebuilds
  means the trend log is churning faster than it can be summarized);
* ``tpu_node_checker_cluster_info{cluster,source}`` — the resolved cluster
  identity this checker stamps into every payload/snapshot
  (``--cluster-name`` → ``$TNC_CLUSTER_NAME`` → kube context → hostname);
  explicitly configured names (flag/env) additionally label every round
  family above with ``cluster=...``;
* ``tpu_node_checker_federation_clusters{state}`` /
  ``tpu_node_checker_federation_cluster_up{cluster}`` /
  ``tpu_node_checker_federation_staleness_rounds{cluster}`` — the
  ``--federate`` aggregator's view of its cluster set: counts by fetch
  state (configured/with_data/fresh/degraded), per-cluster up gauges, and
  rounds since each cluster was last fetched successfully;
* ``tpu_node_checker_federation_fetch_total{cluster,result}`` — upstream
  fleet-API fetches (fresh = 200, not_modified = 304, error): a healthy
  steady state is almost all 304s;
* ``tpu_node_checker_federation_nodes{state}`` — total/ready nodes in the
  merged global view (stale shards' last-known numbers included);
* ``tpu_node_checker_federation_round_duration_ms`` /
  ``tpu_node_checker_federation_workers`` — fetch+merge round wall-clock
  and the consistent-hash fetcher pool size;
* ``tpu_node_checker_round_phase_duration_ms{phase}`` — NATIVE histogram
  (``_bucket``/``_sum``/``_count``) of per-phase round cost;
  ``phase="total"`` is the whole round, so
  ``histogram_quantile(0.99, ...)`` is the production-side counterpart of
  the bench's steady-round assertions;
* ``tpu_node_checker_federation_fetch_duration_ms{cluster}`` — histogram
  of per-cluster upstream fetch cost in the ``--federate`` aggregator;
* ``tpu_node_checker_federation_feed_frames_total{cluster,kind}`` —
  watch-feed frames applied per upstream in ``--federate-feed`` mode, by
  kind (``delta`` / ``heartbeat`` / ``resync``): a healthy steady state
  is deltas and heartbeats with resyncs flat at their seed value;
* ``tpu_node_checker_federation_feed_resyncs_total{cluster,reason}`` —
  full-state resync frames by cause (``requested`` = cold start,
  ``stale-cursor`` = the upstream's ring evicted our cursor — a climbing
  rate means the consumer cannot keep up with upstream churn);
* ``tpu_node_checker_federation_feed_lag_seconds{cluster}`` — seconds
  since each stream last applied a frame (the feed-side counterpart of
  ``watch_stream_age_seconds``: lag past a few long-poll windows means
  the stream is wedged and the engine is riding last-known state);
* ``tpu_node_checker_api_server_request_duration_ms{route}`` — histogram
  of routed-path fleet-API request latency (replaces the
  ``tpu_node_checker_api_server_request_latency_ms`` pseudo-summary,
  which remains one release as a deprecated alias derived from the merged
  histogram);
* ``tpu_node_checker_remediation_denied_total{reason}`` — actuations the
  budget engine refused, by reason (``cordon-max``, ``slice-floor``,
  ``disruption-budget``, ``pdb``, ``lease-denied``,
  ``lease-unreachable``; ``none`` = zero denials so far) — the
  no-silent-caps counter: a refused cordon/drain is audit-visible, never
  a silent skip;
* ``tpu_node_checker_remediation_actions_total{action}`` — actuations
  APPLIED through the budget engine (cordon / drain / uncordon /
  clear-annotation / repair; dry runs excluded);
* ``tpu_node_checker_remediation_domains{state}`` — failure domains in
  the budget engine's round view (``total``, and ``at_floor`` = domains
  with no actuation headroom left above their healthy-chip floor);
* ``tpu_node_checker_remediation_budget_remaining`` — actuation permits
  left in the ``--disruption-budget`` window/round;
* ``tpu_node_checker_remediation_repairs_total{result}`` — repair hooks
  by outcome (``fired`` / ``succeeded`` / ``failed``), and
  ``tpu_node_checker_remediation_repair_age_seconds`` — age of the
  OLDEST repair still without a terminal state (the stuck-repair alert's
  input; 0 when none are in flight);
* ``tpu_node_checker_analytics_predictions_total`` — changepoint
  detections (CUSUM flap episodes, ``--analytics``): each one promoted a
  still-HEALTHY flapper to SUSPECT before the FSM saw a hard failure;
* ``tpu_node_checker_analytics_suspects`` — nodes currently inside an
  active changepoint episode (the standing prediction set);
* ``tpu_node_checker_analytics_buckets{res}`` — closed roll-up buckets
  retained in the analytics segment store, by resolution (60/900/21600 s);
* ``tpu_node_checker_analytics_rollup_lines_total`` /
  ``tpu_node_checker_analytics_compactions_total`` — segment-store write
  telemetry: lines appended through the ``append_bucket`` gate, and
  atomic tmp+rename shard compactions;
* ``tpu_node_checker_analytics_sketch_samples_total{metric}`` — duration
  samples folded into the mergeable percentile sketches, by stream
  (``mttr_s`` / ``repair_age_s`` / ``round_ms`` / ``link_us``);
* ``tpu_node_checker_analytics_global_clusters`` /
  ``tpu_node_checker_analytics_global_slo{metric,q}`` /
  ``tpu_node_checker_analytics_global_merge_ms`` — the ``--federate``
  aggregator's global analytics view (rendered by its own scrape body,
  not this module): clusters contributing sketch blocks, fleet-wide SLO
  percentiles from merged sketches, and the last sketch-merge cost;
* ``tpu_node_checker_federation_lease_total{result}`` /
  ``tpu_node_checker_federation_fleet_budget_remaining`` — the
  ``--federate`` aggregator's disruption-lease traffic (granted permits
  vs denied requests) and the fleet budget's remaining permits;
* ``tpu_node_checker_mesh_link_duration_us{slice,axis}`` — NATIVE
  histogram of per-link ICI sweep p50 from ``--probe-level mesh``, in
  MICROSECONDS (the tree's one ``_us`` family — link legs are two orders
  of magnitude under the millisecond ladder), one sample per distinct
  link per round, labeled by slice budget-domain and mesh axis: the
  scrape-side view of a link drifting toward its SLOW budget.

This docstring is the package's metric index: tnc-lint's
``drift-readme-metrics`` rule (TNC202) fails CI when a family is emitted
below but listed neither here nor in the README — keep it current.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional, Tuple

from tpu_node_checker_torch.checker import CheckResult  # noqa: F401 (the result rendered)
from tpu_node_checker_torch.server.router import RoutedHandler, Router, negotiate
from tpu_node_checker_torch.server.snapshot import Entity

# Prometheus text exposition format, version 0.0.4 — the scrape content type.
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _line(name: str, value: float, labels: Optional[dict] = None) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


def _breaker_lines(breaker: dict, cluster: Optional[str] = None) -> List[str]:
    """The watch-breaker gauge families — ONE definition, shared by the
    normal render and mark_error's no-result-yet branch (a pod that comes
    up against a dead API server is exactly when these matter).

    ``cluster`` rides along so an explicitly configured ``--cluster-name``
    labels these families like every other round family (the breaker is
    exactly the series a multi-cluster dashboard aggregates ``by
    (cluster)``); mark_error's no-result-yet branch has no resolved
    identity yet and renders bare until the first completed round."""
    labels = {"cluster": cluster} if cluster else None
    return [
        "# HELP tpu_node_checker_watch_breaker_open 1 while the watch-mode "
        "circuit breaker is open (consecutive failed check rounds; interval "
        "widened, alerts collapsed).",
        "# TYPE tpu_node_checker_watch_breaker_open gauge",
        _line(
            "tpu_node_checker_watch_breaker_open",
            1.0 if breaker.get("open") else 0.0,
            labels,
        ),
        "# HELP tpu_node_checker_watch_breaker_consecutive_failures "
        "Consecutive failed watch rounds (resets to 0 on success).",
        "# TYPE tpu_node_checker_watch_breaker_consecutive_failures gauge",
        _line(
            "tpu_node_checker_watch_breaker_consecutive_failures",
            float(breaker.get("consecutive_failures", 0)),
            labels,
        ),
    ]


def render_metrics(
    result,
    exit_code_override: Optional[int] = None,
    breaker: Optional[dict] = None,
) -> str:
    """CheckResult → Prometheus text exposition (version 0.0.4).

    ``breaker`` (watch mode only) is the WatchBreaker state dict — rendered
    as its own gauges so "the monitor itself is degraded" is alertable
    separately from "the fleet is degraded"."""
    lines: List[str] = []

    payload = result.payload
    # Cluster identity (--cluster-name satellite of the federation tier):
    # an EXPLICITLY configured name (flag/env) labels every round family —
    # the multi-cluster Prometheus setup's aggregation key.  Inferred
    # defaults (kube context, hostname) stamp the payload but never the
    # labels: a pod hostname churns per restart, and each churn would mint
    # a whole new series set.  The info family below carries the resolved
    # identity either way.
    cluster = payload.get("cluster")
    cluster_label = (
        cluster if payload.get("cluster_source") in ("flag", "env") else None
    )

    def family(name: str, mtype: str, help_text: str, samples: List[Tuple[dict, float]]):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if cluster_label is not None:
                labels = {**(labels or {}), "cluster": cluster_label}
            lines.append(_line(name, value, labels or None))

    if cluster:
        family(
            "tpu_node_checker_cluster_info",
            "gauge",
            "The resolved cluster identity this checker stamps into every "
            "payload/snapshot (source: flag | env | context | hostname).",
            [({"cluster": cluster,
               "source": str(payload.get("cluster_source") or "")}, 1.0)],
        )
    # Fleet families render only for aggregator payloads: an emitter-mode
    # scrape (probe-only payload, no LIST ran) must not advertise
    # nodes{state="total"} 0 — "zero nodes" and "this process never counted
    # nodes" are different facts.
    if "total_nodes" in payload:
        family(
            "tpu_node_checker_nodes",
            "gauge",
            "Accelerator node counts by state.",
            [({"state": "total"}, payload.get("total_nodes", 0)),
             ({"state": "ready"}, payload.get("ready_nodes", 0))],
        )
        family(
            "tpu_node_checker_chips",
            "gauge",
            "Accelerator device counts by state.",
            [({"state": "total"}, payload.get("total_chips", 0)),
             ({"state": "ready"}, payload.get("ready_chips", 0))],
        )
        notready: dict = {}
        for n in payload.get("nodes", []):
            if not n.get("ready"):
                reason = (n.get("not_ready") or {}).get("reason") or "unknown"
                notready[reason] = notready.get(reason, 0) + 1
        family(
            "tpu_node_checker_node_notready",
            "gauge",
            "NotReady nodes by kubelet Ready-condition reason ('unknown' when "
            "the API gave none).",
            [({"reason": r}, float(c)) for r, c in sorted(notready.items())],
        )
        # "slice" is the unique series key: several single-host slices can
        # share one nodepool, and duplicate label sets would invalidate the
        # whole scrape.
        slice_labels = lambda s: {  # noqa: E731
            "slice": s.get("id") or "",
            "nodepool": s.get("nodepool") or "",
            "topology": s.get("topology") or "",
        }
        slices = payload.get("slices", [])
        family(
            "tpu_node_checker_slice_complete",
            "gauge",
            "1 when every host the slice topology implies is effectively Ready.",
            [(slice_labels(s), 1.0 if s.get("complete") else 0.0) for s in slices],
        )
        family(
            "tpu_node_checker_slice_ready_chips",
            "gauge",
            "Effectively-Ready chips per slice.",
            [(slice_labels(s), s.get("ready_chips", 0)) for s in slices],
        )
        family(
            "tpu_node_checker_slice_expected_chips",
            "gauge",
            "Chips the slice topology label promises.",
            [(slice_labels(s), s.get("expected_chips") or 0) for s in slices],
        )
    multislices = payload.get("multislices") or []
    if multislices:
        ms_labels = lambda m: {"group": m.get("group") or ""}  # noqa: E731
        family(
            "tpu_node_checker_multislice_complete",
            "gauge",
            "1 when every member slice of the DCN-joined group is complete.",
            [(ms_labels(m), 1.0 if m.get("complete") else 0.0) for m in multislices],
        )
        family(
            "tpu_node_checker_multislice_ready_chips",
            "gauge",
            "Effectively-Ready chips across the multislice group.",
            [(ms_labels(m), m.get("ready_chips", 0)) for m in multislices],
        )
        family(
            "tpu_node_checker_multislice_slices",
            "gauge",
            "Member slices present in the cluster for the group.",
            [(ms_labels(m), m.get("num_slices", 0)) for m in multislices],
        )
    cordon = payload.get("cordon")
    if cordon is not None:
        family(
            "tpu_node_checker_cordoned_nodes",
            "gauge",
            "Nodes cordoned by --cordon-failed this round (dry-run rounds "
            "report what would have been cordoned).",
            [({}, len(cordon.get("cordoned", [])))],
        )
        family(
            "tpu_node_checker_cordon_skipped_over_cap",
            "gauge",
            "Probe-failed candidates left alone by the --cordon-max budget — "
            "nonzero means humans must look NOW.",
            [({}, len(cordon.get("skipped_over_cap", [])))],
        )
    uncordon = payload.get("uncordon")
    if uncordon is not None:
        family(
            "tpu_node_checker_uncordoned_nodes",
            "gauge",
            "Quarantines lifted by --uncordon-recovered this round.",
            [({}, len(uncordon.get("uncordoned", [])))],
        )
    probe = payload.get("local_probe")
    if probe:
        family(
            "tpu_node_checker_probe_ok",
            "gauge",
            "1 when the local chip probe passed at its level.",
            [({"level": probe.get("level", "")}, 1.0 if probe.get("ok") else 0.0)],
        )
        telemetry = [
            # (payload key, metric suffix, help)
            ("device_count", "probe_devices", "Chips the probe enumerated."),
            ("matmul_tflops", "probe_matmul_tflops", "MXU burn throughput."),
            ("int8_tops", "probe_int8_tops", "Int8 MXU matmul throughput."),
            ("hbm_gbps", "probe_hbm_gbps", "HBM streaming bandwidth sample."),
            ("dma_gbps", "probe_dma_gbps", "DMA-engine stream bandwidth."),
            ("collective_busbw_gbps", "probe_collective_busbw_gbps",
             "Ring all-reduce bus bandwidth lower bound."),
            ("dcn_busbw_gbps", "probe_dcn_busbw_gbps",
             "Cross-slice (DCN) psum bus bandwidth lower bound."),
            ("dispatch_overhead_ms", "probe_dispatch_overhead_ms",
             "Per-dispatch round-trip overhead (gates floor grading)."),
            ("ring_link_gbps", "probe_ring_link_gbps",
             "Per-hop ICI link bandwidth from the ppermute ring walk."),
            ("workload_step_ms", "probe_workload_step_ms",
             "Sharded train-step time at the workload level."),
        ]
        for key, suffix, help_text in telemetry:
            value = probe.get(key)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                family(f"tpu_node_checker_{suffix}", "gauge", help_text, [({}, value)])
        # Fabric-fault trending: boolean fabric verdicts as 0/1 gauges, the
        # per-torus-axis localization map, and named bad ICI links — so a
        # flapping link or a recurring sick axis shows up as a time series,
        # not only in one round's JSON.
        for key, suffix, help_text in (
            ("collective_ok", "probe_collective_ok",
             "1 when flat psum/all_gather/reduce-scatter verified."),
            ("ring_ok", "probe_ring_ok",
             "1 when the ppermute ring walk returned every payload."),
        ):
            value = probe.get(key)
            if isinstance(value, bool):
                family(f"tpu_node_checker_{suffix}", "gauge", help_text,
                       [({}, 1.0 if value else 0.0)])
        cap = probe.get("hbm_capacity")
        if isinstance(cap, dict) and "min_gb" in cap:
            family(
                "tpu_node_checker_probe_hbm_capacity_ok",
                "gauge",
                "1 when every device exposes ~nominal HBM for its generation "
                "(a low bytes_limit is a dead memory channel).",
                [({"generation": str(cap.get("generation") or "")},
                  1.0 if cap.get("ok") else 0.0)],
            )
            family(
                "tpu_node_checker_probe_hbm_min_gb",
                "gauge",
                "Smallest per-device HBM bytes_limit observed, in decimal GB.",
                [({}, cap["min_gb"])],
            )
        floor = probe.get("perf_floor")
        if isinstance(floor, dict) and isinstance(floor.get("ratios"), dict):
            # Floor grading (probe/floors.py): the measured/peak ratio per
            # metric is the trend line that catches gradual thermal
            # degradation before it crosses the floor.
            family(
                "tpu_node_checker_probe_perf_floor_ok",
                "gauge",
                "1 when every measured perf figure cleared its device-kind "
                "floor (--perf-floor fraction of published peak).",
                [(
                    {"generation": str(floor.get("generation") or "")},
                    1.0 if floor.get("ok") else 0.0,
                )],
            )
            family(
                "tpu_node_checker_probe_perf_floor_ratio",
                "gauge",
                "Measured / published-peak ratio per perf metric.",
                [({"metric": m}, r) for m, r in sorted(floor["ratios"].items())
                 if isinstance(r, (int, float))],
            )
        axis_ok = probe.get("ici_axis_ok")
        if isinstance(axis_ok, dict) and axis_ok:
            family(
                "tpu_node_checker_probe_ici_axis_ok",
                "gauge",
                "Per-ICI-torus-dimension psum verdict (0 names the sick axis).",
                [({"axis": a}, 1.0 if ok else 0.0) for a, ok in sorted(axis_ok.items())],
            )
        axis_bw = probe.get("ici_axis_busbw_gbps") or probe.get(
            "fault_domain_busbw_gbps"
        )
        if isinstance(axis_bw, dict):
            samples = [
                ({"axis": a}, v)
                for a, v in sorted(axis_bw.items())
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            ]
            if samples:
                # A torus dimension (or the DCN boundary) can be correct but
                # SLOW; per-axis bandwidth trends catch the degradation the
                # exact compare cannot see.
                family(
                    "tpu_node_checker_probe_axis_busbw_gbps",
                    "gauge",
                    "psum bus bandwidth per mesh axis (ICI torus dimensions; "
                    "'dcn' = the multislice boundary).",
                    samples,
                )
        domains = probe.get("fault_domain_ok")
        if isinstance(domains, dict) and domains:
            # Multislice hybrid-mesh verdicts: axis "dcn" is the slice
            # boundary, t* the intra-slice ICI torus — a 0 attributes the
            # fault to its domain (different cables, different repair).
            family(
                "tpu_node_checker_probe_fault_domain_ok",
                "gauge",
                "Per-fault-domain psum verdict over the hybrid DCN x ICI "
                "mesh (axis 'dcn' = the slice boundary; 0 names the sick "
                "domain).",
                [({"axis": a}, 1.0 if ok else 0.0) for a, ok in sorted(domains.items())],
            )
        bad_links = probe.get("ring_bad_links")
        if isinstance(bad_links, list):
            family(
                "tpu_node_checker_probe_ring_bad_links",
                "gauge",
                "ICI links the single-hop diagnostic named as corrupting.",
                [({}, len(bad_links))],
            )
            if bad_links:
                family(
                    "tpu_node_checker_probe_ring_bad_link",
                    "gauge",
                    "1 per named bad ICI link (receiver-side hop i->i+1).",
                    [({"link": str(l)}, 1.0) for l in bad_links],
                )
    planned: dict = {}
    for n in payload.get("nodes", []):
        p = n.get("planned")
        if isinstance(p, dict):
            for reason in p.get("disruptions") or []:
                planned[reason] = planned.get(reason, 0) + 1
    if planned:
        # Planned-disruption context: lets alert rules separate "maintenance
        # drain in progress" from "hardware down" without JSON parsing.
        family(
            "tpu_node_checker_planned_disruption_nodes",
            "gauge",
            "Nodes carrying a planned-disruption taint, by reason "
            "(autoscaler scale-down / GKE impending termination).",
            [({"reason": r}, c) for r, c in sorted(planned.items())],
        )
    mismatched = sum(
        1
        for n in payload.get("nodes", [])
        if isinstance(n.get("probe"), dict) and n["probe"].get("kind_mismatch")
    )
    if mismatched:
        # Label-vs-enumerated-generation contradictions (informational in the
        # check itself) become a trendable series so a mislabeled pool is
        # alertable without JSON parsing.  No series when clean; a count
        # only — the node names live in the JSON payload.
        family(
            "tpu_node_checker_kind_mismatch_nodes",
            "gauge",
            "Nodes whose probed TPU generation contradicts their GKE "
            "accelerator label (mislabeled pool / wrong image).",
            [({}, mismatched)],
        )
    summary = payload.get("probe_summary")
    if summary is not None:
        # Fleet chip-health roll-up under the DaemonSet pattern
        # (--probe-results): the aggregator Deployment alerts on "N hosts
        # probe-failed" straight off the scrape, no JSON-log parsing.
        family(
            "tpu_node_checker_probe_hosts",
            "gauge",
            "Hosts by data-plane probe state across the fleet "
            "(--probe-results roll-up).",
            [
                ({"state": "reported"}, summary.get("hosts_reported", 0)),
                ({"state": "ok"}, summary.get("hosts_ok", 0)),
                ({"state": "failed"}, len(summary.get("hosts_failed", []))),
                ({"state": "missing"}, len(summary.get("hosts_missing", []))),
                # Subset of "failed" whose probe flunked the perf floor —
                # throttled, not dead.  Always emitted (0 included) so the
                # family's states stay consistent and recovery reads as a
                # return to zero, not a vanished series.
                ({"state": "floor_failed"},
                 len(summary.get("hosts_floor_failed", []))),
            ],
        )
        skipped = summary.get("reports_skipped")
        if skipped:
            # Refused reports by reason — a rising "future_skew" or "stale"
            # series means emitters (or their clocks) are sick even though
            # the aggregator keeps running.
            family(
                "tpu_node_checker_probe_reports_skipped",
                "gauge",
                "Probe report files refused this round, by reason "
                "(stale, future_skew = clock skew, unreadable, schema).",
                [({"reason": r}, n) for r, n in sorted(skipped.items())],
            )
        unhealthy = [("failed", h) for h in summary.get("hosts_failed", [])] + [
            ("missing", h) for h in summary.get("hosts_missing", [])
        ]
        if unhealthy:
            # Info-style series naming the sick hosts; healthy hosts emit no
            # series, so cardinality tracks the (alertable) problem count,
            # not fleet size.  Capped all the same: a fleet-wide emitter
            # outage (every host missing) must not mint one series per node —
            # the aggregate family above carries the full counts, and the cap
            # is surfaced as its own series rather than silently truncating
            # (same policy as the Slack list caps).
            cap = 100
            family(
                "tpu_node_checker_probe_host_unhealthy",
                "gauge",
                "1 per host whose chip probe failed or that never reported "
                f"(first {cap}; see ..._probe_hosts for full counts).",
                [({"host": h, "state": state}, 1.0) for state, h in unhealthy[:cap]],
            )
            if len(unhealthy) > cap:
                family(
                    "tpu_node_checker_probe_host_unhealthy_omitted",
                    "gauge",
                    "Unhealthy hosts beyond the per-host series cap.",
                    [({}, len(unhealthy) - cap)],
                )
    remediation = payload.get("remediation")
    if remediation is not None:
        # The budget engine's round view (--slice-floor-pct /
        # --disruption-budget / legacy --cordon-max denials): refusals are
        # the alertable signal — a rising denied rate during a storm is
        # the budget protecting capacity, and exactly when humans must
        # look.
        denied = remediation.get("denied_total") or {}
        family(
            "tpu_node_checker_remediation_denied_total",
            "counter",
            "Actuations the disruption-budget engine refused, by reason "
            "(cordon-max, slice-floor, disruption-budget, pdb, "
            "lease-denied, lease-unreachable; 'none' = no denials yet).",
            [({"reason": r}, float(n)) for r, n in sorted(denied.items())]
            or [({"reason": "none"}, 0.0)],
        )
        actions = remediation.get("actions_total") or {}
        family(
            "tpu_node_checker_remediation_actions_total",
            "counter",
            "Actuations applied through the budget engine, by action "
            "(cordon/drain/uncordon/clear-annotation/repair; dry runs "
            "excluded; 'none' = no actuations yet).",
            [({"action": a}, float(n)) for a, n in sorted(actions.items())]
            or [({"action": "none"}, 0.0)],
        )
        domains = remediation.get("domains") or {}
        family(
            "tpu_node_checker_remediation_domains",
            "gauge",
            "Failure domains (slices) in the budget engine's view: total, "
            "and at_floor = no actuation headroom left above the "
            "healthy-chip floor.",
            [({"state": "total"}, float(domains.get("total", 0))),
             ({"state": "at_floor"}, float(domains.get("at_floor", 0)))],
        )
        budget = remediation.get("budget")
        if isinstance(budget, dict):
            family(
                "tpu_node_checker_remediation_budget_remaining",
                "gauge",
                "Actuation permits left in the --disruption-budget "
                "window/round.",
                [({}, float(budget.get("remaining", 0)))],
            )
        repairs = remediation.get("repairs")
        if isinstance(repairs, dict):
            family(
                "tpu_node_checker_remediation_repairs_total",
                "counter",
                "Repair hooks by outcome (fired = started, succeeded = "
                "node re-earned HEALTHY, failed = the hook itself "
                "errored).",
                [({"result": "fired"}, float(repairs.get("fired_total", 0))),
                 ({"result": "succeeded"},
                  float(repairs.get("succeeded_total", 0))),
                 ({"result": "failed"},
                  float(repairs.get("failed_total", 0)))],
            )
            family(
                "tpu_node_checker_remediation_repair_age_seconds",
                "gauge",
                "Age of the oldest repair with no terminal state (0 = "
                "none in flight) — the stuck-repair alert's input.",
                [({}, float(repairs.get("oldest_age_s", 0.0)))],
            )
    history = payload.get("history")
    if history is not None:
        # Hysteresis roll-up (--history): EVERY state always emits (0
        # included) so a node leaving CHRONIC reads as a return to zero,
        # not a vanished series — same policy as probe_hosts.
        from tpu_node_checker_torch.history.fsm import STATES

        states = history.get("states") or {}
        family(
            "tpu_node_checker_node_state",
            "gauge",
            "Accelerator nodes by hysteresis state (HEALTHY/SUSPECT/FAILED/"
            "RECOVERING/CHRONIC; CHRONIC = flap detector tripped, held "
            "cordoned).",
            [({"state": s}, float(states.get(s, 0))) for s in STATES],
        )
        family(
            "tpu_node_checker_node_flaps_total",
            "counter",
            "Lifetime verdict flips summed across the fleet's history "
            "store — a rising rate is quarantine churn in progress even "
            "while every round's aggregate grade stays green.",
            [({}, float(history.get("flaps_total", 0)))],
        )
    analytics = payload.get("analytics")
    if analytics is not None:
        # Fleet analytics tier (--analytics): prediction and roll-up
        # telemetry.  Gauges cover the standing state; counters are
        # lifetime (the store/detector persist across watch rounds).
        family(
            "tpu_node_checker_analytics_predictions_total",
            "counter",
            "Changepoint detections (CUSUM flap episodes opened) — each "
            "one promoted a still-HEALTHY flapper to SUSPECT ahead of "
            "the FSM's own evidence.",
            [({}, float(analytics.get("predictions_total", 0)))],
        )
        family(
            "tpu_node_checker_analytics_suspects",
            "gauge",
            "Nodes currently inside an active changepoint episode (the "
            "standing prediction set the remediation budget view "
            "surfaces).",
            [({}, float(len(analytics.get("suspects") or ())))],
        )
        family(
            "tpu_node_checker_analytics_buckets",
            "gauge",
            "Closed roll-up buckets retained in the segment store, by "
            "resolution (seconds).",
            [({"res": res}, float(n))
             for res, n in sorted((analytics.get("buckets") or {}).items())],
        )
        family(
            "tpu_node_checker_analytics_rollup_lines_total",
            "counter",
            "Roll-up lines appended to segment files through the "
            "append_bucket gate (lifetime).",
            [({}, float(analytics.get("rollup_lines_total", 0)))],
        )
        family(
            "tpu_node_checker_analytics_compactions_total",
            "counter",
            "Atomic segment-file compactions (tmp+rename rewrites of a "
            "shard's live bucket set).",
            [({}, float(analytics.get("compactions_total", 0)))],
        )
        sketch_samples = analytics.get("sketch_samples")
        if sketch_samples:
            family(
                "tpu_node_checker_analytics_sketch_samples_total",
                "counter",
                "Duration samples folded into mergeable percentile "
                "sketches, by metric stream (mttr_s / repair_age_s / "
                "round_ms / link_us) — the raw material of the federated "
                "SLO percentiles.",
                [({"metric": metric}, float(n))
                 for metric, n in sorted(sketch_samples.items())],
            )
    transport = payload.get("api_transport")
    if transport:
        # Keep-alive pool telemetry (session-lifetime counters): opened
        # flat + reused climbing = the pooled transport amortizing its
        # handshakes across watch rounds; opened tracking requests_sent
        # means the server is dropping keep-alive and every round pays
        # TCP+TLS again.
        family(
            "tpu_node_checker_api_connections_opened_total",
            "counter",
            "TCP(+TLS) connections the checker's API session has dialed "
            "(lifetime of the pooled session).",
            [({}, transport.get("connections_opened", 0))],
        )
        family(
            "tpu_node_checker_api_requests_total",
            "counter",
            "Kubernetes API requests sent over the pooled session.",
            [({}, transport.get("requests_sent", 0))],
        )
        family(
            "tpu_node_checker_api_requests_reused_total",
            "counter",
            "API requests served over an already-open keep-alive "
            "connection (no handshake paid).",
            [({}, transport.get("requests_reused", 0))],
        )
        truncated = transport.get("list_truncated")
        if truncated:
            # No-silent-caps: a LIST walk that exhausted its page budget
            # with the continue token still set lost its tail — per
            # resource, so an events-triage shortfall and a node-LIST
            # abort alert differently.  Absent entirely on healthy
            # sessions (the payload omits the key at zero).
            family(
                "tpu_node_checker_api_list_truncated_total",
                "counter",
                "Paginated LIST walks that exhausted their page budget "
                "with the continue token still set (the tail of the "
                "listing was not fetched), by resource.",
                [({"resource": r}, n) for r, n in sorted(truncated.items())],
            )
        if "retries" in transport:
            # Graded-retry telemetry (utils/retry.py): a climbing series
            # means the API path is absorbing transient faults — the
            # monitor staying green while this rises is the retry layer
            # doing its job; the reason label says which fault class.
            by_reason = transport.get("retries_by_reason") or {}
            samples = [({"reason": r}, n) for r, n in sorted(by_reason.items())]
            if not samples:
                samples = [({"reason": "none"}, 0)]
            family(
                "tpu_node_checker_api_retries_total",
                "counter",
                "Transparent API request retries by transient-fault reason "
                "(connect_refused, connection_reset, timeout, http_429, "
                "http_5xx; 'none' = zero retries so far).",
                samples,
            )
    ws = payload.get("watch_stream")
    if ws is not None:
        # Watch-stream mode (--watch-stream): event-driven round telemetry.
        # events climbing while relists stay flat is the stream doing its
        # job; relists climbing with it means the stream keeps dying and
        # every "incremental" round is secretly a full LIST again.
        events = ws.get("events_total") or {}
        family(
            "tpu_node_checker_watch_stream_events_total",
            "counter",
            "Watch-stream events consumed since process start, by type "
            "(ADDED/MODIFIED/DELETED/BOOKMARK/ERROR; 'none' = no events "
            "yet).",
            [({"type": t}, float(n)) for t, n in sorted(events.items())]
            or [({"type": "none"}, 0.0)],
        )
        relists = ws.get("relists_total") or {}
        family(
            "tpu_node_checker_watch_relists_total",
            "counter",
            "Full node LISTs performed, by reason (seed = startup, gone = "
            "410 resourceVersion expiry, stream_end / stream_error = the "
            "watch connection died) — steady state adds none.",
            [({"reason": r}, float(n)) for r, n in sorted(relists.items())]
            or [({"reason": "none"}, 0.0)],
        )
        family(
            "tpu_node_checker_watch_stream_age_seconds",
            "gauge",
            "Seconds since the stream last showed life (an event, a "
            "bookmark, or a (re)connect) — the staleness detector for the "
            "event-driven cache.",
            [({}, float(ws.get("stream_age_seconds", 0.0)))],
        )
    if "total_nodes" in payload:
        # Partial degradation: 1 when a NON-essential phase (events fetch,
        # cordon/uncordon sweep) lost data this round.  The grade gauges
        # stay truthful; this one says the triage detail around them is
        # incomplete.
        family(
            "tpu_node_checker_round_degraded",
            "gauge",
            "1 when a non-essential phase (events, cordon/uncordon) failed "
            "transiently this round — verdict stands, triage is partial.",
            [({}, 1.0 if payload.get("degraded") else 0.0)],
        )
    if breaker is not None:
        lines.extend(_breaker_lines(breaker, cluster_label))
    family(
        "tpu_node_checker_exit_code",
        "gauge",
        "Exit code the equivalent one-shot run would return "
        "(0 ok, 1 monitor error, 2 none, 3 degraded).",
        [({}, result.exit_code if exit_code_override is None else exit_code_override)],
    )
    # Aggregator rounds report phase-timer totals; emitter rounds report the
    # probe's own elapsed time — never a constant 0.0 that would graph
    # emitters as instant.
    if "timings_ms" in payload:
        duration = payload.get("timings_ms", {}).get("total", 0.0)
    else:
        duration = (probe or {}).get("elapsed_ms", 0.0)
    family(
        "tpu_node_checker_check_duration_ms",
        "gauge",
        "End-to-end duration of the last check (probe time in emitter mode).",
        [({}, duration)],
    )
    family(
        "tpu_node_checker_last_run_timestamp_seconds",
        "gauge",
        "Unix time of the last completed check (staleness detector).",
        [({}, time.time())],
    )
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Background /metrics endpoint fed by ``update(result)``.

    Routed through the shared :class:`~tpu_node_checker_torch.server.router.Router`
    (the same one the ``--serve`` fleet API speaks), so the scrape surface
    gets the full HTTP contract for free: unknown paths 404, ``HEAD``
    answers the GET's headers with no body, and the body — static between
    rounds by construction — carries a strong ETag and a gzip variant, so a
    scraper sending ``If-None-Match`` pays 304-sized responses for every
    round it has already seen.
    """

    def __init__(self, port: int, host: str = "0.0.0.0", obs=None):
        self._body = b"# tpu-node-checker: no check completed yet\n"
        self._entity = Entity(self._body, METRICS_CONTENT_TYPE)
        self._lock = threading.Lock()
        # Observability layer (obs.Observability): its histogram families
        # (round phases) are appended to every per-round body rebuild.
        self._obs = obs

        router = Router()
        router.add("GET", "/metrics", self._get_metrics)
        # "/" has served the metrics body since the first MetricsServer;
        # keep the alias — ad-hoc curl probes depend on it.
        router.add("GET", "/", self._get_metrics)

        class Handler(RoutedHandler):
            pass

        Handler.router = router
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tnc-metrics-server",
            daemon=True,
        )
        self._thread.start()

    def _get_metrics(self, req):
        with self._lock:
            entity = self._entity
        return negotiate(entity, req.headers)

    def _set_body(self, body: bytes) -> None:
        # One pre-serialized entity per round: gzip + ETag computed at
        # update time, every scrape is a lookup (same contract as the
        # fleet API's snapshots).
        with self._lock:
            self._body = body
            self._entity = Entity(body, METRICS_CONTENT_TYPE)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def set_breaker(self, state: Optional[dict]) -> None:
        """Record the watch breaker's state for subsequent renders (watch
        mode calls this every round, before update()/mark_error())."""
        self._breaker = state

    def update(self, result) -> None:
        text = render_metrics(result, breaker=getattr(self, "_breaker", None))
        if self._obs is not None:
            lines = self._obs.prometheus_lines()
            if lines:
                text += "\n".join(lines) + "\n"
        self._set_body(text.encode())
        self._last_result = result

    def mark_error(self, exit_code: int = 1) -> None:
        """A check round failed: surface it on the scrape.

        Node/chip gauges keep their last-known values (the cluster state is
        UNKNOWN, not zero) but ``exit_code`` flips so alerts on it fire, and
        ``last_run_timestamp_seconds`` deliberately goes stale.
        """
        breaker = getattr(self, "_breaker", None)
        last = getattr(self, "_last_result", None)
        if last is None:
            head = (
                "# HELP tpu_node_checker_exit_code Exit code (1 = monitor error).\n"
                "# TYPE tpu_node_checker_exit_code gauge\n"
                f"tpu_node_checker_exit_code {exit_code}\n"
            )
            if breaker is not None:
                head += "\n".join(_breaker_lines(breaker)) + "\n"
            body = head.encode()
        else:
            # Re-render WITHOUT refreshing the timestamp: drop that family's
            # sample line so its staleness mirrors reality.
            text = render_metrics(last, exit_code_override=exit_code, breaker=breaker)
            body = "\n".join(
                line
                for line in text.splitlines()
                # Both sample shapes: bare and cluster-labeled.
                if not line.startswith(
                    ("tpu_node_checker_last_run_timestamp_seconds ",
                     "tpu_node_checker_last_run_timestamp_seconds{")
                )
            ).encode() + b"\n"
        self._set_body(body)

    def close(self) -> None:
        self._server.shutdown()
