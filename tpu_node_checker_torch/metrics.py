"""The emitter's Prometheus scrape: ``--metrics-port`` on the ``--watch`` loop.

A copy of the part of the JAX package's ``metrics.py`` that an emitter pod
serves.  Each round's payload is ``{"local_probe": report}``, which renders:

* ``tpu_node_checker_probe_ok{level}`` and the probe's numeric telemetry
  (``tpu_node_checker_probe_{devices,matmul_tflops,int8_tops,hbm_gbps,
  dma_gbps,collective_busbw_gbps,dcn_busbw_gbps,dispatch_overhead_ms,
  ring_link_gbps,workload_step_ms}``);
* the fabric verdicts ``tpu_node_checker_probe_{collective_ok,ring_ok}``,
  ``..._probe_ici_axis_ok{axis}``, ``..._probe_axis_busbw_gbps{axis}``,
  ``..._probe_fault_domain_ok{axis}``, ``..._probe_ring_bad_links`` and
  ``..._probe_ring_bad_link{link}``;
* ``tpu_node_checker_probe_hbm_capacity_ok{generation}``,
  ``..._probe_hbm_min_gb``, ``..._probe_perf_floor_ok{generation}`` and
  ``..._probe_perf_floor_ratio{metric}``;
* ``tpu_node_checker_exit_code``, ``tpu_node_checker_check_duration_ms``
  (the probe's ``elapsed_ms``) and
  ``tpu_node_checker_last_run_timestamp_seconds``.

Family names, label sets, HELP and TYPE text are the JAX package's byte for
byte (the TPU words in the HELP text included): the PrometheusRule and the
dashboards read them, and a test holds the two scrapes equal.  An emitter
lists no nodes, so no fleet family renders here.
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional, Tuple

from tpu_node_checker_torch.checker import CheckResult
from tpu_node_checker_torch.server.router import Entity, RoutedHandler, Router, negotiate

# Prometheus text exposition format, version 0.0.4: the scrape content type.
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _line(name: str, value: float, labels: Optional[dict] = None) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


def _numeric(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def render_metrics(result: CheckResult, exit_code_override: Optional[int] = None) -> str:
    """CheckResult → Prometheus text exposition (version 0.0.4)."""
    lines: List[str] = []

    def family(name: str, mtype: str, help_text: str, samples: List[Tuple[dict, float]]):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(_line(name, value, labels or None))

    probe = result.payload.get("local_probe")
    if probe:
        family(
            "tpu_node_checker_probe_ok",
            "gauge",
            "1 when the local chip probe passed at its level.",
            [({"level": probe.get("level", "")}, 1.0 if probe.get("ok") else 0.0)],
        )
        telemetry = [
            # (report key, metric suffix, help)
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
            if _numeric(value):
                family(f"tpu_node_checker_{suffix}", "gauge", help_text, [({}, value)])
        # Boolean fabric verdicts as 0/1 gauges, so a flapping link shows up
        # as a time series.
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
            # The measured/expected ratio per metric is the trend line that
            # catches gradual degradation before it crosses the floor.
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
        axis_bw = probe.get("ici_axis_busbw_gbps") or probe.get("fault_domain_busbw_gbps")
        if isinstance(axis_bw, dict):
            samples = [({"axis": a}, v) for a, v in sorted(axis_bw.items()) if _numeric(v)]
            if samples:
                # An axis can be correct but slow; its bandwidth trend shows it.
                family(
                    "tpu_node_checker_probe_axis_busbw_gbps",
                    "gauge",
                    "psum bus bandwidth per mesh axis (ICI torus dimensions; "
                    "'dcn' = the multislice boundary).",
                    samples,
                )
        domains = probe.get("fault_domain_ok")
        if isinstance(domains, dict) and domains:
            # Axis "dcn" is the slice boundary, t* the torus axes: a 0 names
            # the sick domain.
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
                    [({"link": str(link)}, 1.0) for link in bad_links],
                )
    family(
        "tpu_node_checker_exit_code",
        "gauge",
        "Exit code the equivalent one-shot run would return "
        "(0 ok, 1 monitor error, 2 none, 3 degraded).",
        [({}, result.exit_code if exit_code_override is None else exit_code_override)],
    )
    # An emitter round reports the probe's own elapsed time.
    family(
        "tpu_node_checker_check_duration_ms",
        "gauge",
        "End-to-end duration of the last check (probe time in emitter mode).",
        [({}, (probe or {}).get("elapsed_ms", 0.0))],
    )
    family(
        "tpu_node_checker_last_run_timestamp_seconds",
        "gauge",
        "Unix time of the last completed check (staleness detector).",
        [({}, time.time())],
    )
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Background ``/metrics`` endpoint (and ``/``, its alias) fed by
    :meth:`update`, on a thread of its own from construction to
    :meth:`close`.

    Each round's body is serialized once, with its ETag and gzip variant,
    so a scrape is a lookup, and a scraper sending ``If-None-Match`` gets a
    304 for a round it has already seen.
    """

    def __init__(self, port: int, host: str = "0.0.0.0"):
        self._entity = Entity(b"# tpu-node-checker: no check completed yet\n",
                              METRICS_CONTENT_TYPE)
        self._lock = threading.Lock()
        self._last_result: Optional[CheckResult] = None

        router = Router()
        router.add("GET", "/metrics", self._get_metrics)
        router.add("GET", "/", self._get_metrics)

        class Handler(RoutedHandler):
            pass

        Handler.router = router
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tnc-metrics-server", daemon=True,
        )
        self._thread.start()

    def _get_metrics(self, req):
        with self._lock:
            entity = self._entity
        return negotiate(entity, req.headers)

    def _set_body(self, body: bytes) -> None:
        with self._lock:
            self._entity = Entity(body, METRICS_CONTENT_TYPE)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def update(self, result: CheckResult) -> None:
        self._set_body(render_metrics(result).encode())
        self._last_result = result

    def mark_error(self, exit_code: int = 1) -> None:
        """A round failed: ``exit_code`` flips so alerts on it fire, the
        probe gauges keep their last-known values, and
        ``last_run_timestamp_seconds`` is left out so it goes stale."""
        last = self._last_result
        if last is None:
            body = (
                "# HELP tpu_node_checker_exit_code Exit code (1 = monitor error).\n"
                "# TYPE tpu_node_checker_exit_code gauge\n"
                f"tpu_node_checker_exit_code {exit_code}\n"
            ).encode()
        else:
            text = render_metrics(last, exit_code_override=exit_code)
            body = "\n".join(
                line for line in text.splitlines()
                if not line.startswith("tpu_node_checker_last_run_timestamp_seconds ")
            ).encode() + b"\n"
        self._set_body(body)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()
