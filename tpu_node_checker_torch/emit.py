"""The node-side emitter: ``--emit-probe`` once or on a cadence, and
``--report-fresh``.

The report is the probe child's, plus the envelope the fleet checker grades
it by: ``schema`` (the contract's major version) and ``written_at`` (its
staleness anchor), as the JAX package's emitter writes it.  The JAX fleet
checker reads such files through ``--probe-results DIR``; that is the only
way the two packages meet.

A DaemonSet pod runs :func:`emit_probe_loop` (``--watch``), which rewrites the
report every interval, appends one ``--trend``-shaped line per round to
``--log-jsonl`` and serves the round's gauges on ``--metrics-port``; its
livenessProbe runs :func:`report_fresh`.  With ``--history`` each round
also feeds the host's own hysteresis machine, whose state rides in the
round's line.  These are copies of the JAX checker's emitter
(``checker.py`` ``_emit_probe_once``, ``_emitter_round_entry``,
``emit_probe``, ``_emitter_history_round``, ``emit_probe_loop``,
``report_fresh`` and the loop's signal and wait seams).
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from typing import Optional, Tuple

from tpu_node_checker_torch.checker import (  # noqa: F401 — re-exported API
    CLOCK_SKEW_ALLOWANCE_S,
    EXIT_ERROR,
    EXIT_NONE_READY,
    EXIT_OK,
    REPORT_SCHEMA_VERSION,
    CheckResult,
)
from tpu_node_checker_torch.checker import _append_jsonl as append_jsonl
from tpu_node_checker_torch.checker import _write_trace_file
from tpu_node_checker_torch.metrics import MetricsServer
from tpu_node_checker_torch.probe import spans
from tpu_node_checker_torch.probe.liveness import run_local_probe
from tpu_node_checker_torch.probe.schema import strict_mode, validate_report

EXIT_SIGTERM = 128 + 15


def emit_probe_once(
    target: str,
    level: str = "enumerate",
    timeout_s: Optional[float] = None,
    device: str = "cuda:0",
    topology: Optional[str] = None,
    soak_s: float = 0.0,
    perf_floor: Optional[float] = None,
    distributed: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    dist_init_timeout_s: Optional[float] = None,
    trace_file: Optional[str] = None,
    workload_model: Optional[str] = None,
) -> Tuple[int, dict]:
    """One probe and one atomic report write (``-`` writes to stdout).

    Returns ``(exit_code, report)``: 0 when the host is healthy, 3 otherwise.
    A report that violates the declared schema warns on stderr, or raises
    under ``TNC_SCHEMA_STRICT``.  The rendezvous arguments of a distributed
    probe, and ``workload_model`` (the model the workload level trains),
    pass through to :func:`run_local_probe`.

    The round is one trace (:mod:`tpu_node_checker_torch.probe.spans`),
    which the probe child joins: the report's ``spans`` carries its
    ``trace_id``, the child's pair of clocks, each span's count, total and
    longest milliseconds (every span closed before the write: not
    ``emit.write`` and ``emit.round``) and the counters.  ``trace_file``
    (``--trace``) gets the round's Chrome trace, the child's spans on their
    own track, written atomically after the round.
    """
    round_ = spans.Round(events=trace_file is not None)
    try:
        with spans.active(round_), spans.span("emit.round"):
            probed = run_local_probe(
                level=level, timeout_s=timeout_s, device=device,
                topology=topology, soak_s=soak_s, perf_floor=perf_floor,
                distributed=distributed, coordinator=coordinator,
                num_processes=num_processes, process_id=process_id,
                dist_init_timeout_s=dist_init_timeout_s, workload_model=workload_model,
            )
            with spans.span("emit.schema"):
                doc = probed.to_dict()
                doc["schema"] = REPORT_SCHEMA_VERSION
                doc["written_at"] = time.time()
                violations = validate_report(doc)
                if violations:
                    msg = "probe report violates its declared schema: " + "; ".join(
                        violations[:5])
                    if strict_mode():
                        raise ValueError(msg)
                    print(f"WARNING: {msg}", file=sys.stderr)
            doc["spans"] = round_.report_block(doc.get("spans"))
            with spans.span("emit.write"):
                payload = json.dumps(doc, ensure_ascii=False, indent=2)
                if target == "-":
                    print(payload, flush=True)
                else:
                    tmp = f"{target}.tmp"
                    with open(tmp, "w") as f:
                        f.write(payload + "\n")
                    os.replace(tmp, target)
                    print(f"Probe report written to {target} (ok={probed.ok}).",
                          file=sys.stderr, flush=True)
    finally:
        if trace_file:
            _write_trace_file(trace_file, round_)
    return (EXIT_OK if probed.ok else EXIT_NONE_READY), doc


def emitter_round_entry(rc: int, doc: dict) -> dict:
    """One ``--trend``-compatible log line for an emission round."""
    entry = {
        "ts": round(time.time(), 3),
        "exit_code": rc,
        "probe_ok": bool(doc.get("ok")),
        "probe_level": doc.get("level"),
        "duration_ms": doc.get("elapsed_ms"),
    }
    if rc != EXIT_OK:
        entry["causes"] = [
            f"probe-failed: {doc.get('hostname') or 'local'}"
            + (f" ({doc.get('error')})" if doc.get("error") else "")
        ]
    return entry


def emit_probe(target: str, log_jsonl: Optional[str] = None,
               history: Optional[dict] = None, **probe) -> int:
    """``--emit-probe FILE`` once: one probe, one report, and with
    ``log_jsonl`` one round line, which carries the round's ``--history``
    state when ``history`` (``checker._build_history``) is given.  Returns 0 when the host is healthy, else 3.
    """
    rc, doc = emit_probe_once(target, **probe)
    entry = emitter_round_entry(rc, doc)
    _emitter_history_round(history, doc, entry)
    if log_jsonl:
        append_jsonl(log_jsonl, entry)
    return rc


def _emitter_history_round(history, doc: dict, entry: dict) -> None:
    """Emitter-mode ``--history``: the single-host hysteresis machine.

    The pod tracks its OWN cards' history, keyed by the report's hostname
    (the key the aggregator would use), so a flapping card reads CHRONIC
    at the host edge, and the verdict rides in the ``--log-jsonl`` line.
    """
    if history is None:
        return
    fsm, store = history["fsm"], history["store"]
    fsm.transitions.clear()  # per-emission log; nothing consumes older rounds
    node = doc.get("hostname") or "local"
    ok = bool(doc.get("ok"))
    fsm.observe(node, ok)
    h = fsm.health(node)
    store.record(
        {
            "node": node,
            "ts": round(time.time(), 3),
            "ok": ok,
            "causes": [] if ok else ["probe-failed"],
            "state": h.state,
            "streak": h.streak,
            "flaps": h.flaps,
            "flaps_total": h.flaps_total,
        }
    )
    store.flush()
    entry["state"] = h.state
    if h.flaps:
        entry["flaps"] = h.flaps


def emit_probe_loop(target: str, interval: float, log_jsonl: Optional[str] = None,
                    metrics_port: Optional[int] = None, history: Optional[dict] = None,
                    **probe) -> int:
    """``--emit-probe FILE --watch SECONDS``: the DaemonSet emitter loop.

    Rewrites the report every ``interval`` seconds, measured from the start
    of a round (a round longer than the interval starts the next one at
    once), and appends each round to ``log_jsonl``.  With ``metrics_port``
    (0 for an ephemeral port) it serves the emitter's own probe gauges
    (:mod:`tpu_node_checker_torch.metrics`), started before the first round
    and updated after each.  Each round spawns a fresh probe child.  One bad
    round (a shared-volume blip, a probe crash) is logged as an
    ``EXIT_ERROR`` round, flips the scrape's exit code, and the loop goes
    on: a crash-looping pod would let the report go stale.  With
    ``history`` (``--history``), one tracker for the loop's lifetime
    observes every round, and its state rides in the round's line.  Runs
    until SIGTERM, which stops the loop after the current emission and
    returns 143.  ``probe`` is passed to :func:`emit_probe_once`.
    """
    server = None
    if metrics_port is not None:
        server = MetricsServer(metrics_port)
        # Flushed: a pod's log, or a script waiting for the port, must see
        # it before the first round ends.
        print(f"Serving emitter metrics on port {server.port} (/metrics).",
              file=sys.stderr, flush=True)
    stop = threading.Event()
    prev_handler = _install_stop_signal(stop)
    try:
        return _emit_probe_rounds(target, interval, log_jsonl, server, history, probe,
                                  stop)
    finally:
        _restore_stop_signal(prev_handler)
        if server is not None:
            server.close()


def _emit_probe_rounds(target, interval, log_jsonl, server, history, probe,
                       stop) -> int:
    while True:
        round_start = time.monotonic()
        try:
            rc, doc = emit_probe_once(target, **probe)
        except Exception as exc:  # tnc: allow-broad-except(emitter must survive a round)
            print(f"Probe emission failed: {exc}", file=sys.stderr)
            entry = {"ts": round(time.time(), 3), "exit_code": EXIT_ERROR, "error": str(exc)}
            if server is not None:
                server.mark_error()
        else:
            entry = emitter_round_entry(rc, doc)
            _emitter_history_round(history, doc, entry)
            if server is not None:
                server.update(CheckResult(exit_code=rc, payload={"local_probe": doc}))
        if log_jsonl:
            append_jsonl(log_jsonl, entry)
        # Fixed cadence: the probe's time comes out of the interval, so the
        # report's age keeps the margin the aggregator's max-age assumes.
        if _wait_for_next_round(stop, max(0.0, interval - (time.monotonic() - round_start))):
            print(
                "SIGTERM: emitter loop stopped cleanly (last report and "
                "round log flushed).",
                file=sys.stderr,
            )
            return EXIT_SIGTERM


def _install_stop_signal(stop: threading.Event) -> object:
    """SIGTERM sets ``stop``, so the loop exits at its next wait instead of
    dying mid-round with the round unlogged.  Returns the previous handler,
    or None where no handler can be installed (off the main thread)."""
    import signal

    def _handler(signum, frame):
        stop.set()

    try:
        return signal.signal(signal.SIGTERM, _handler)
    except (AttributeError, ValueError, OSError):
        return None


def _restore_stop_signal(prev) -> None:
    if prev is None:
        return
    import signal

    try:
        signal.signal(signal.SIGTERM, prev)
    except (AttributeError, ValueError, OSError):
        pass


def _wait_for_next_round(stop: threading.Event, seconds: float) -> bool:
    """The inter-round wait: True when shutdown was asked for (at once,
    mid-wait).  The seam the loop tests drive the loop through."""
    return stop.wait(max(0.0, seconds))


def report_fresh(path: str, max_age: float) -> int:
    """``--report-fresh FILE``: the emitter's liveness verdict on its own
    report.  0 when its ``written_at`` is younger than ``max_age`` and not
    dated more than :data:`CLOCK_SKEW_ALLOWANCE_S` ahead; 1 when it is
    stale, future-dated, unreadable, not a JSON object, or its ``written_at``
    is missing or not a finite number."""
    try:
        with open(path) as f:
            # AttributeError: valid JSON whose root is not an object.
            written_at = float(json.load(f).get("written_at"))
        if not math.isfinite(written_at):
            # NaN passes both comparisons below; it must fail.
            raise ValueError(f"non-finite written_at {written_at!r}")
    except (OSError, json.JSONDecodeError, TypeError, ValueError, AttributeError) as exc:
        print(f"probe report {path} unreadable: {exc}", file=sys.stderr)
        return 1
    age = time.time() - written_at
    if age < -CLOCK_SKEW_ALLOWANCE_S:
        print(
            f"probe report {path} future-dated: written {-age:.0f}s ahead of "
            f"this host's clock (skew beyond {CLOCK_SKEW_ALLOWANCE_S:.0f}s)",
            file=sys.stderr,
        )
        return 1
    if age > max_age:
        print(f"probe report {path} stale: age {age:.0f}s > {max_age:.0f}s", file=sys.stderr)
        return 1
    print(f"probe report {path} fresh (age {age:.0f}s).", file=sys.stderr)
    return 0
