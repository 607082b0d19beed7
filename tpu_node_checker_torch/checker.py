"""The fleet round: list → detect → probe → history → grade → notify →
print → exit code, once or in the aggregator's ``--watch`` loop.

A copy of the JAX package's ``checker.py`` round and polling loop, with
their names and order:

* Slack delivery happens **before** any stdout output, and ``--json``
  suppresses the Slack console lines;
* exit codes: 0 = at least one effectively Ready accelerator node, 2 = no
  accelerator nodes, 3 = accelerator nodes exist but none effectively
  Ready, or ``--strict-slices`` / ``--expected-chips`` failed; 1 is the
  CLI's catch-all;
* a Slack failure is never fatal.

The nodes come from the live LIST (``cluster.KubeClient`` through the
kubeconfig, ``$KUBECONFIG``, ``~/.kube/config`` or the in-cluster service
account, paged and projected, ``--label-selector`` on the server, retried
within ``--retry-budget``) or from a ``--nodes-json`` file.  ``--node-events``
attaches the recent Events of sick nodes (a live cluster only; a failed
fetch marks the round ``degraded``, never exit 1).  ``--probe`` runs the
port's own probe (:func:`_run_probe`) on this host's card;
``--probe-results`` grades the reports of the fleet's emitters.

:func:`watch` repeats the round every ``--watch`` seconds at a fixed
cadence until SIGTERM (exit 143 after the round in flight), alerts on a
change of the exit code or the sick-node set under ``--slack-on-change``,
serves ``--metrics-port``, writes ``--event-log``, and opens a circuit
breaker (:class:`WatchBreaker`) over consecutive failed rounds.
With ``--cordon-failed``, ``--uncordon-recovered``, ``--cordon-degraded``,
``--drain-failed`` and the repair hooks the round quarantines condemned
nodes through the budget engine (:mod:`~tpu_node_checker_torch.remediation`):
uncordon first, then cordon, under ``--cordon-max``, the slice floor, the
disruption budget and the fleet lease, each decision one audit event.
:func:`trend_summary` and :func:`trend_nodes` are the post-incident readers
of the ``--log-jsonl`` trend log and the ``--history`` store.

``--analytics DIR`` folds each round's verdicts into the roll-up store
(:mod:`~tpu_node_checker_torch.analytics`) and runs the changepoint
detectors, whose standing predictions the budget engine sees.  ``--serve``
publishes each round of :func:`watch` to the fleet state API
(:mod:`~tpu_node_checker_torch.server`), whose cordon/uncordon writes go
through :func:`_make_serve_control`; without ``--watch``, :func:`serve_store`
serves a store another process records.  With ``--watch-stream`` each round
of :func:`watch` is a tick of :class:`~tpu_node_checker_torch.watchstream.StreamRoundEngine`
over a node cache that a Kubernetes watch keeps current.
"""

from __future__ import annotations

import fnmatch
import json
import math
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_node_checker_torch import notify, report
from tpu_node_checker_torch.detect import (
    HARD_PLANNED_DISRUPTIONS,
    NodeInfo,
    SliceInfo,
    format_why_not_ready,
    group_multislices,
    group_slices,
    select_accelerator_nodes,
)

# Generation detection is shared with probe.floors so label cross-checks and
# floor grading cannot drift.  A label/kind mismatch is a warning, never a
# failure grade.
from tpu_node_checker_torch.generations import (
    LABEL_GENERATION as _LABEL_GENERATION,
    generations_of as _generations_of,
)
from tpu_node_checker_torch.resources import ResourceRegistry, default_registry
from tpu_node_checker_torch.utils.timing import PhaseTimer

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_NO_ACCEL_NODES = 2
EXIT_NONE_READY = 3

# How far in the FUTURE a probe report's written_at may sit before it is
# rejected as clock skew: 60 s tolerates a mis-stepped host without letting
# a future-dated report defeat --probe-results-max-age.
CLOCK_SKEW_ALLOWANCE_S = 60.0

# Major version of the emitter → aggregator report contract.  The
# aggregator refuses reports whose major it does not speak (reports with no
# schema are accepted: the pre-versioning emitters).
REPORT_SCHEMA_VERSION = 1


@dataclass
class CheckResult:
    exit_code: int
    accel: List[NodeInfo] = field(default_factory=list)
    ready: List[NodeInfo] = field(default_factory=list)  # effective (probe-adjusted)
    slices: List[SliceInfo] = field(default_factory=list)
    multislices: List = field(default_factory=list)
    payload: dict = field(default_factory=dict)
    local_probe: Optional[dict] = None
    # --analytics: the SLO/offenders/flaps query documents this round
    # computed from roll-ups (served by FleetStateServer.publish_analytics;
    # never part of the payload — they are a serving surface).
    analytics_docs: Optional[dict] = None


def _registry_from_args(args) -> ResourceRegistry:
    reg = default_registry()
    extra = getattr(args, "resource_key", None) or []
    if extra:
        reg = reg.with_extra_keys(extra)
    return reg


# Keep-alive client cache: one KubeClient (one pooled transport) per set of
# resolved connection credentials.  Keyed by the RESOLVED config, not the
# flag: config resolution runs every round, so a rotated token or an
# exec-plugin refresh lands on a new key and a fresh client.
_CLIENT_CACHE: dict = {}
_CLIENT_CACHE_MAX = 8  # tests spin many fixture servers; evict, don't grow

# The live client this round's API traffic rode: the source of the
# payload's api_transport telemetry.
_ROUND_CLIENT: dict = {"client": None}

# This round's retry policy (a fresh shared wall-clock budget per round),
# installed on whichever client the round resolves, cached ones included.
_ROUND_POLICY: dict = {"policy": None}


def _build_retry_policy(args):
    """``--retry-budget`` → a per-round RetryPolicy (None disables retries).

    The budget is SHARED by every API call in the round (the LIST and the
    events fan-out's workers), so the round's worst-case added latency is
    bounded by one number.
    """
    from tpu_node_checker_torch.utils.retry import (
        DEFAULT_BUDGET_S,
        RetryBudget,
        RetryPolicy,
    )

    budget_s = getattr(args, "retry_budget", None)
    if budget_s is None:
        budget_s = DEFAULT_BUDGET_S
    if budget_s <= 0:
        return None  # 0 = retries off: the pre-retry transport, exactly
    return RetryPolicy(budget=RetryBudget(budget_s))


def _client_key(cfg) -> tuple:
    return (
        cfg.server,
        cfg.token,
        cfg.basic_auth,
        cfg.client_cert,
        cfg.ca_file,
        cfg.insecure_skip_tls_verify,
    )


def _cached_client(cfg):
    from tpu_node_checker_torch.cluster import KubeClient

    key = _client_key(cfg)
    client = _CLIENT_CACHE.get(key)
    if client is None:
        while len(_CLIENT_CACHE) >= _CLIENT_CACHE_MAX:
            # Evict the least recently USED (hits below move their entry to
            # the end).
            _CLIENT_CACHE.pop(next(iter(_CLIENT_CACHE))).close()
        client = KubeClient(cfg)
    else:
        del _CLIENT_CACHE[key]  # re-insert: move-to-end = mark recently used
    _CLIENT_CACHE[key] = client
    # Fresh budget every round, cached client or not.
    client.set_retry_policy(_ROUND_POLICY["policy"])
    _ROUND_CLIENT["client"] = client
    return client


def reset_client_cache() -> None:
    """Drop (and close) every cached client, so the next round redials
    instead of trusting a pool whose sockets (or credentials) may be dead."""
    while _CLIENT_CACHE:
        _, client = _CLIENT_CACHE.popitem()
        client.close()


def _api_concurrency(args) -> int:
    """``--api-concurrency``: bound on concurrent API calls in the per-node
    fan-out (the events fetches).  1 = serial."""
    from tpu_node_checker_torch.utils.fanout import DEFAULT_API_CONCURRENCY

    value = getattr(args, "api_concurrency", None)
    return max(1, int(value)) if value is not None else DEFAULT_API_CONCURRENCY


def _fetch_nodes(args, timer: PhaseTimer):
    """Node source: the ``--nodes-json`` file, or one live LIST.

    Returns ``(nodes, client)``; ``client`` is ``None`` offline.  A live
    LIST rides the relist fast path (``list_nodes_projected``): ``nodes``
    is then a :class:`~tpu_node_checker_torch.fastpath.ProjectedFleet`.
    """
    nodes_json = getattr(args, "nodes_json", None)
    if nodes_json:
        with timer.phase("list"):
            with open(nodes_json) as f:
                doc = json.load(f)
            # "items": null happens in Go-serialized NodeLists; treat as empty.
            return ((doc.get("items") or []) if isinstance(doc, dict) else doc), None
    from tpu_node_checker_torch.cluster import resolve_cluster_config

    with timer.phase("config"):
        cfg = resolve_cluster_config(
            getattr(args, "kubeconfig", None), getattr(args, "context", None)
        )
    with timer.phase("list"):
        client = _cached_client(cfg)
        return client.list_nodes_projected(
            label_selector=getattr(args, "label_selector", None)
        ), client


def _run_probe(
    args, accel: List[NodeInfo], result: CheckResult, slices: Sequence[SliceInfo] = ()
) -> None:
    """Attach the local card probe to the matching node (or the payload).

    The probe speaks for the host it runs on (``NODE_NAME`` downward-API env
    or the kernel hostname); its verdict adjusts that host's effective
    readiness only.  When the probed host isn't in the node list, the
    result is surfaced as ``local_probe`` but flips no node state.  The
    probe runs on ``--device`` (``cuda:0`` unless the caller asks for
    ``cpu``): a host with no card, or fewer than its node's allocatable
    count, fails it.
    """
    from tpu_node_checker_torch.probe.liveness import run_local_probe

    # Resolve the local node first so the probe can enforce the allocatable
    # device count itself (run_local_probe's expected_devices check).
    hostname = os.environ.get("NODE_NAME") or os.uname().nodename
    local = next((n for n in accel if n.name == hostname), None)
    distributed = getattr(args, "probe_distributed", False)
    expected = local.accelerators if local else None
    if distributed and local is not None:
        # Global enumeration: the expectation is the whole slice's chip count.
        for s in slices:
            if any(h.name == local.name for h in s.hosts):
                expected = s.expected_chips or s.chips
                break
    probed = run_local_probe(
        level=getattr(args, "probe_level", "enumerate"),
        timeout_s=getattr(args, "probe_timeout", None),  # None → per-level budget
        expected_devices=expected,
        device=getattr(args, "device", "cuda:0"),
        distributed=distributed,
        # An explicit --probe-topology always wins; otherwise, with global
        # (distributed) enumeration the mesh spans the slice, so the node's
        # topology label describes the probed fabric.
        topology=getattr(args, "probe_topology", None)
        or (local.tpu_topology if local and distributed else None),
        soak_s=getattr(args, "probe_soak", 0.0) or 0.0,
        coordinator=getattr(args, "probe_coordinator", None),
        num_processes=getattr(args, "probe_num_processes", None),
        process_id=getattr(args, "probe_process_id", None),
        dist_init_timeout_s=getattr(args, "probe_rendezvous_timeout", None),
        perf_floor=getattr(args, "perf_floor", None),
        # Port-only: named, it joins the call; unnamed, the call is the JAX checker's.
        **({"workload_model": args.probe_workload_model}
           if getattr(args, "probe_workload_model", None) else {}),
    )
    if local is not None:
        local.probe = probed.to_dict()
        _flag_kind_mismatch(local)
        # Same dict on both surfaces: the label/kind annotation must show in
        # payload["local_probe"] too, not only on the node entry.
        result.local_probe = local.probe
    else:
        result.local_probe = probed.to_dict()


def _flag_kind_mismatch(node: NodeInfo) -> None:
    """Cross-check control plane vs data plane: the node LABEL promises one
    TPU generation, the probe ENUMERATED another.  Flags only when the
    enumerated kind clearly names a different known generation.
    Informational (``kind_mismatch`` on the probe dict + a stderr note)."""
    probe = node.probe or {}
    kinds = probe.get("device_kinds") or []
    expected = _LABEL_GENERATION.get(node.tpu_accelerator or "")
    if not expected or not kinds:
        return
    seen: set = set()
    for k in kinds:
        seen |= _generations_of(k)
    if not seen or expected in seen:
        return
    probe["kind_mismatch"] = {
        "label": node.tpu_accelerator,
        "expected_generation": expected,
        "enumerated": list(kinds),
        "enumerated_generations": sorted(seen),
    }
    print(
        f"⚠️ {node.name}: label {node.tpu_accelerator!r} promises a "
        f"{expected} device but the probe enumerated {kinds} — mislabeled "
        "pool or wrong image?",
        file=sys.stderr,
    )


def _attach_probe_results(args, accel: List[NodeInfo]) -> dict:
    """Attach per-host probe reports from ``--probe-results DIR``.

    Each emitter pod writes ``DIR/$NODE_NAME.json``; every node gains its
    host's data-plane verdict.  A report must never improve a node's grade
    wrongly:

    * an unparseable report, or one with a non-numeric ``written_at``, is
      skipped with a note;
    * one older than ``--probe-results-max-age`` (by ``written_at``, else
      the file's mtime) is skipped, and so is one dated more than
      ``CLOCK_SKEW_ALLOWANCE_S`` in the future;
    * one of another schema major, or violating the schema, is skipped;
    * a node already carrying an in-process verdict (``--probe``) is never
      overwritten by a file.

    Returns skip counts by reason (``unreadable``/``schema``/``stale``/
    ``future_skew``).
    """
    import glob

    skipped = {"unreadable": 0, "schema": 0, "stale": 0, "future_skew": 0}
    directory = getattr(args, "probe_results", None)
    if not directory:
        return skipped
    from tpu_node_checker_torch.probe.schema import validate_report as _validate_report
    max_age = getattr(args, "probe_results_max_age", None) or 900.0
    now = time.time()
    by_name = {n.name: n for n in accel}
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        try:
            with open(path) as f:
                data = json.load(f)
            # ValueError/TypeError: a foreign emitter's written_at (e.g. an
            # ISO-8601 string) must skip THIS report, not sink the round.
            written_at = float(data.get("written_at") or os.stat(path).st_mtime)
            if not math.isfinite(written_at):
                # NaN compares False against both bounds below.
                raise ValueError(f"non-finite written_at {written_at!r}")
        except (OSError, json.JSONDecodeError, TypeError, ValueError) as exc:
            print(f"Skipping unreadable probe report {path}: {exc}", file=sys.stderr)
            skipped["unreadable"] += 1
            continue
        schema = data.get("schema")
        if schema is not None and schema != REPORT_SCHEMA_VERSION:
            print(
                f"Skipping probe report {path}: schema {schema!r} != "
                f"{REPORT_SCHEMA_VERSION} (emitter/aggregator version skew?)",
                file=sys.stderr,
            )
            skipped["schema"] += 1
            continue
        age = now - written_at
        if age < -CLOCK_SKEW_ALLOWANCE_S:
            print(
                f"Skipping future-dated probe report {path} (written "
                f"{-age:.0f}s ahead of this host's clock; skew beyond "
                f"{CLOCK_SKEW_ALLOWANCE_S:.0f}s — emitter clock broken?)",
                file=sys.stderr,
            )
            skipped["future_skew"] += 1
            continue
        if age > max_age:
            print(
                f"Skipping stale probe report {path} (age {age:.0f}s > {max_age:.0f}s)",
                file=sys.stderr,
            )
            skipped["stale"] += 1
            continue
        violations = _validate_report(data)
        if violations:
            # Checked after the freshness gates so a stale report still
            # counts as stale.
            print(
                f"Skipping probe report {path}: schema violation — "
                + "; ".join(violations[:5]),
                file=sys.stderr,
            )
            skipped["schema"] += 1
            continue
        hostname = data.get("hostname") or os.path.splitext(os.path.basename(path))[0]
        node = by_name.get(hostname)
        if node is not None and node.probe is None:
            node.probe = data
            _flag_kind_mismatch(node)
    if getattr(args, "probe_results_required", False):
        # Coverage enforcement: every TPU node must carry a FRESH report (the
        # JAX package's rule, kept as it is: a GPU node without one is not
        # graded missing).
        for node in accel:
            if node.is_tpu and node.probe is None:
                node.probe = {
                    "ok": False,
                    "level": "missing",
                    "hostname": node.name,
                    "error": f"no fresh probe report in {directory}",
                }
    return skipped


# --node-events fetch bounds: one bounded paged walk per sick node (see
# cluster.KubeClient), at most _EVENTS_NODE_CAP nodes, fanned out over at
# most --api-concurrency connections.  Past the cap the fetches stop,
# visibly: a fleet-wide outage must not turn the checker into an event
# storm against an already degraded control plane.
_EVENTS_NODE_CAP = 8
_EVENTS_PER_NODE = 3


def _summarize_events(raw: Sequence) -> list:
    """Raw Event objects → compact triage entries, Warnings first, newest
    first, messages whitespace-collapsed and capped."""
    evs = []
    for e in raw:
        if not isinstance(e, dict):
            continue
        last = (
            e.get("lastTimestamp")
            or e.get("eventTime")
            or (e.get("series") or {}).get("lastObservedTime")
            or e.get("firstTimestamp")
            or ""
        )
        evs.append(
            {
                "type": e.get("type"),
                "reason": e.get("reason"),
                "message": " ".join(str(e.get("message") or "").split())[:200],
                "count": e.get("count"),
                "last_seen": last if isinstance(last, str) else "",
            }
        )
    # Warnings outrank Normals; within a class, newest first (RFC-3339
    # strings sort chronologically).
    evs.sort(
        key=lambda v: (v.get("type") == "Warning", v.get("last_seen") or ""),
        reverse=True,
    )
    return evs[:_EVENTS_PER_NODE]


def _attach_node_events(
    args, accel: List[NodeInfo], client
) -> Tuple[List[str], List[str]]:
    """``--node-events``: recent k8s Events for SICK nodes.

    Fetched only for nodes that are not effectively ready, capped at
    ``_EVENTS_NODE_CAP`` (unplanned faults first), fanned out over
    ``--api-concurrency`` workers, and never fatal to the round.

    Returns ``(failure_notes, truncated_names)``, both empty when every
    fetch landed whole: a failed fetch marks the round ``degraded`` instead
    of sinking it to exit 1, and a walk that ran out of pages with its
    continue token still set is named in the degradation detail.
    """
    errors: List[str] = []
    truncated: List[str] = []
    sick = [n for n in accel if not n.effectively_ready]
    if not sick:
        return errors, truncated
    # Unplanned faults outrank maintenance drains for the fetch budget
    # (the stable sort keeps cluster order within each class).
    sick.sort(key=lambda n: n.sickness_planned)
    try:
        client = _resolve_client(args, client)
    except Exception as exc:  # tnc: allow-broad-except(triage extra, never fatal)
        print(f"Cannot fetch node events: {exc}", file=sys.stderr)
        errors.append(f"no cluster client: {exc}")
        return errors, truncated
    from tpu_node_checker_torch.utils.fanout import bounded_map

    paged_fetch = getattr(client, "list_node_events_paged", None)

    # tnc: allow-exception-escape(bounded_map CAPTURES a worker's exception as its (False, exc) outcome — every raise becomes a per-node stderr note and errors entry below, never a silent death)
    def _fetch(n):
        # Drop-in clients without the truncation-aware walk still attach
        # events; they just cannot report a capped walk.
        if paged_fetch is not None:
            return paged_fetch(n.name)
        return client.list_node_events(n.name), False

    targets = sick[:_EVENTS_NODE_CAP]
    outcomes = bounded_map(_fetch, targets, _api_concurrency(args))
    # Input-ordered results: attachment and stderr notes stay deterministic
    # no matter which worker finished first.
    for n, (ok, value) in zip(targets, outcomes):
        if ok:
            items, was_truncated = value
            n.events = _summarize_events(items)
            if was_truncated:
                truncated.append(n.name)
        else:
            print(f"Cannot fetch events for {n.name}: {value}", file=sys.stderr)
            errors.append(f"{n.name}: {value}")
    omitted = len(sick) - _EVENTS_NODE_CAP
    if omitted > 0:
        print(
            f"--node-events: {omitted} more sick node(s) beyond the "
            f"{_EVENTS_NODE_CAP}-node fetch cap",
            file=sys.stderr,
        )
    return errors, truncated


def _resolve_client(args, client):
    """Reuse the LIST call's client; otherwise resolve one on demand
    (through the same keep-alive cache)."""
    if client is not None:
        return client
    from tpu_node_checker_torch.cluster import resolve_cluster_config

    return _cached_client(
        resolve_cluster_config(
            getattr(args, "kubeconfig", None), getattr(args, "context", None)
        )
    )


# Live history tracker, cached across rounds within one process: the FSM
# must keep advancing in memory even when the store file cannot be written,
# and a big fleet must not re-parse the store every round.  Keyed by every
# knob that shapes the machine, so a changed flag rebuilds.
_HISTORY_CACHE: dict = {"key": None, "tracker": None}


def _build_history(args):
    """``--history FILE`` → ``{"store", "fsm"}`` (None when the flag is off).

    Opens the per-node health store and seeds one hysteresis machine per
    recorded node, so state survives process restarts.  Shared by the
    one-shot round and the emitter.  Within one process the tracker is
    cached: later rounds reuse the in-memory machine (with a fresh
    per-round transition log) instead of reseeding from disk.
    """
    path = getattr(args, "history", None)
    if not path:
        return None
    from tpu_node_checker_torch.history import HealthFSM, HistoryStore
    from tpu_node_checker_torch.history.fsm import (
        DEFAULT_CORDON_AFTER,
        DEFAULT_FLAP_THRESHOLD,
        DEFAULT_FLAP_WINDOW,
        DEFAULT_UNCORDON_AFTER,
    )
    from tpu_node_checker_torch.history.store import DEFAULT_MAX_ROUNDS

    key = (
        os.path.abspath(path),
        getattr(args, "history_max_rounds", None) or DEFAULT_MAX_ROUNDS,
        getattr(args, "cordon_after", None) or DEFAULT_CORDON_AFTER,
        getattr(args, "uncordon_after", None) or DEFAULT_UNCORDON_AFTER,
        getattr(args, "flap_threshold", None) or DEFAULT_FLAP_THRESHOLD,
        getattr(args, "flap_window", None) or DEFAULT_FLAP_WINDOW,
    )
    if _HISTORY_CACHE["key"] == key:
        tracker = _HISTORY_CACHE["tracker"]
        tracker["fsm"].transitions.clear()  # the log is per-round
        return tracker
    store = HistoryStore(key[0], key[1])
    fsm = HealthFSM(
        cordon_after=key[2],
        uncordon_after=key[3],
        flap_threshold=key[4],
        flap_window=key[5],
    )
    for node, entries in store.load().items():
        fsm.seed(node, entries)
    tracker = {"store": store, "fsm": fsm}
    _HISTORY_CACHE["key"], _HISTORY_CACHE["tracker"] = key, tracker
    return tracker


# Analytics bundle (segment store + changepoint detectors), cached across
# rounds like the history tracker: the roll-up store's open buckets and the
# CUSUM scores are cross-round state, which a per-round rebuild would lose.
_ANALYTICS_CACHE: dict = {"key": None, "bundle": None}

# Remediation bundle (budget engine + lease client + repair tracker),
# cached across rounds like the history tracker: the sliding-window
# actuation ledger, the lifetime denied/action counters and the last-leased
# fleet allowance must survive from round to round.  Keyed by every budget
# knob and the round's data sources, so two embedded runs never share a
# ledger.
_REMEDIATION_CACHE: dict = {"key": None, "bundle": None}


def _remediation_enabled(args) -> bool:
    """True when any of the NEW remediation flags is present — the switch
    between legacy --cordon-max-only budgeting and the full engine
    (slice floors, disruption budgets, leases).  The regression pin rides
    on this: all-False means payload/metrics stay byte-identical."""
    return bool(
        getattr(args, "slice_floor_pct", None) is not None
        or getattr(args, "disruption_budget", None)
        or getattr(args, "drain_failed", False)
        or getattr(args, "cordon_degraded", False)
        or getattr(args, "repair_cmd", None)
        or getattr(args, "repair_webhook", None)
        or getattr(args, "disruption_lease", None)
    )


def _round_events(args, events):
    """The round's audit EventLog: the watch loop hands down the shared
    Observability log (so ``--event-log`` captures remediation lines);
    one-shot runs mint a stderr-only one with the same cluster-stamp
    policy (explicit identity only)."""
    if events is not None:
        return events
    from tpu_node_checker_torch.obs.events import EventLog

    cluster = (
        getattr(args, "cluster_name", None)
        or os.environ.get("TNC_CLUSTER_NAME")
        or None
    )
    return EventLog(cluster=cluster)


def _build_remediation(args, history, events=None) -> dict:
    """Flags → ``{"engine", "tracker", "events"}`` (cached across rounds).

    Always built when ANY actuator flag is on: in legacy mode (no new
    remediation flags) the engine enforces exactly the old --cordon-max
    semantics, with its denials made visible (audit event + counter)
    instead of silently skipped.
    """
    from tpu_node_checker_torch.remediation import (
        BudgetEngine,
        parse_disruption_budget,
    )
    from tpu_node_checker_torch.remediation.repair import RepairTracker

    events = _round_events(args, events)
    budget_raw = getattr(args, "disruption_budget", None)
    lease_url = getattr(args, "disruption_lease", None)
    repair_on = bool(
        getattr(args, "repair_cmd", None)
        or getattr(args, "repair_webhook", None)
    )
    key = (
        getattr(args, "slice_floor_pct", None),
        budget_raw,
        lease_url,
        getattr(args, "cordon_max", 1),
        bool(getattr(args, "drain_failed", False)),
        bool(getattr(args, "cordon_degraded", False)),
        repair_on,
        os.path.abspath(args.history) if getattr(args, "history", None) else None,
        getattr(args, "nodes_json", None),
        getattr(args, "probe_results", None),
        getattr(args, "kubeconfig", None),
    )
    if _REMEDIATION_CACHE["key"] == key:
        bundle = _REMEDIATION_CACHE["bundle"]
        bundle["events"] = bundle["engine"].events = events
        return bundle
    budget = window = None
    if budget_raw:
        budget, window = parse_disruption_budget(budget_raw)
    lease = None
    if lease_url:
        from tpu_node_checker_torch.remediation.lease import LeaseClient

        name, _source = resolve_cluster_name(args)
        lease = LeaseClient(lease_url, cluster=name)
    engine = BudgetEngine(
        slice_floor_pct=getattr(args, "slice_floor_pct", None),
        budget=budget,
        window_s=window,
        cordon_max=getattr(args, "cordon_max", 1) or 1,
        lease=lease,
        events=events,
        enabled=_remediation_enabled(args),
    )
    tracker = (
        RepairTracker(history["store"] if history is not None else None)
        if repair_on
        else None
    )
    bundle = {"engine": engine, "tracker": tracker, "events": events}
    _REMEDIATION_CACHE["key"], _REMEDIATION_CACHE["bundle"] = key, bundle
    return bundle


def _build_analytics(args):
    """``--analytics DIR`` → ``{"store", "detector"}`` (None when off).

    The segment store loads its shard files once per process and then
    rides in memory; the detector's CUSUM scores persist across rounds
    (an episode spans rounds by definition).  Keyed by the directory so
    two embedded runs (tests) never share buckets.
    """
    path = getattr(args, "analytics", None)
    if not path:
        return None
    from tpu_node_checker_torch.analytics import (
        CusumFlapDetector,
        LinkDriftDetector,
        SegmentStore,
    )

    key = os.path.abspath(path)
    if _ANALYTICS_CACHE["key"] == key:
        return _ANALYTICS_CACHE["bundle"]
    store = SegmentStore(key)
    store.load()
    bundle = {
        "store": store,
        "detector": CusumFlapDetector(),
        # The mesh link doctor's timing channel: CUSUM over per-link
        # p50/budget headroom, keyed by slice-qualified link names.
        "link_detector": LinkDriftDetector(),
    }
    _ANALYTICS_CACHE["key"], _ANALYTICS_CACHE["bundle"] = key, bundle
    return bundle


def _node_group_labels(args, n: NodeInfo, cluster: Optional[str]) -> dict:
    """The (cluster, slice, topology) labels one node's roll-up buckets
    carry — slice named exactly like the remediation budget's failure
    domains (one definition, so analytics groupings and budget domains
    can never disagree)."""
    from tpu_node_checker_torch.detect import slice_group_key
    from tpu_node_checker_torch.remediation.budget import _domain_name

    key = slice_group_key(n)
    return {
        "cluster": cluster,
        "slice": _domain_name(key) if key is not None else None,
        "topology": n.tpu_topology,
    }

def _node_round_causes(n: NodeInfo) -> List[str]:
    """Compact cause tokens for one node's round, recorded in the history
    store."""
    causes: List[str] = []
    if not n.ready:
        causes.append("not-ready")
    elif not n.schedulable:
        causes.append("no-allocatable")
    if n.probe is not None and not n.probe.get("ok"):
        causes.append(
            "no-probe-report" if n.probe.get("level") == "missing" else "probe-failed"
        )
    elif n.probe is not None and n.probe.get("mesh_degraded"):
        # Chips passed but the mesh link sweep graded a link SLOW: degraded,
        # not failed.
        causes.append("degraded-link")
    return causes


def _fold_round_samples(analytics, accel: List[NodeInfo], timer) -> None:
    """Fold this round's duration samples into the reserved ``_fleet``
    roll-up stream: round wall-clock (ms) and the deduplicated per-link
    sweep medians (µs).  One ``observe_samples`` call — the sketches land
    in whatever 1m/15m/6h buckets are open right now and persist through
    the same TNC021-gated append path as verdict counters."""
    import time as _time

    from tpu_node_checker_torch.analytics.segments import FLEET_STREAM

    samples: Dict[str, List[float]] = {}
    round_ms = timer.total_ms()
    if round_ms > 0:
        samples["round_ms"] = [round_ms]
    link_us = [p50 for _domain, _axis, p50 in _mesh_link_samples(accel)]
    if link_us:
        samples["link_us"] = link_us
    if samples:
        analytics["store"].observe_samples(
            FLEET_STREAM, round(_time.time(), 3), samples
        )


def _observe_link_drift(analytics, accel: List[NodeInfo], fsm, args=None,
                        events=None, trace_id=None,
                        round_seq: int = 0) -> List[dict]:
    """The per-link timing channel (``--analytics`` + mesh probes): feed
    every probed link's p50/budget sample through the
    :class:`~tpu_node_checker_torch.analytics.changepoint.LinkDriftDetector`.

    A firing is an early warning that a link is trending toward its SLOW
    budget: every node of the link's slice is promoted HEALTHY → SUSPECT
    through :meth:`HealthFSM.promote_suspect` — the same zeroed-streak
    pin as the flip channel, so link drift can never accelerate a cordon.
    Returns the round's link prediction records (shape ``{"link",
    "score", "nodes", "promoted"}`` — keyed by link, not node, so readers
    can tell the two channels apart in the shared predictions list).
    """
    detector = analytics.get("link_detector")
    if detector is None:
        return []
    members: Dict[str, List[str]] = {}
    for n in accel:
        domain = _node_link_domain(n)
        members.setdefault(domain or n.name, []).append(n.name)
    from tpu_node_checker_torch.meshprobe import qualify_link

    predictions: List[dict] = []
    live: set = set()
    for n in accel:
        links = _node_mesh_links(n)
        if not links:
            continue
        domain = _node_link_domain(n)
        group = members[domain or n.name]
        for link in sorted(links):
            entry = links[link]
            if not isinstance(entry, dict):
                continue
            name = qualify_link(domain, link)
            live.add(name)
            fired = detector.observe(
                name,
                float(entry.get("p50_us") or 0.0),
                float(entry.get("budget_us") or 0.0),
                round_seq,
            )
            if not fired:
                continue
            promoted = sorted(
                m for m in group
                if fsm is not None and fsm.promote_suspect(m) is not None
            )
            prediction = {
                "link": name,
                "score": round(detector.score(name), 3),
                "nodes": sorted(group),
                "promoted": promoted,
            }
            predictions.append(prediction)
            if events is not None:
                events.emit(
                    "analytics-link-drift",
                    trace_id=trace_id,
                    link=name,
                    score=prediction["score"],
                    promoted=promoted,
                )
    # Same fleet-tracking policy as the flip channel's prune, but over
    # THIS round's probed link set (a drained slice's links must not
    # stand as suspects forever).
    detector.prune(live)
    return predictions

def _update_history(history: dict, accel: List[NodeInfo], analytics=None,
                    args=None, events=None, trace_id=None,
                    round_seq: int = 0, steady=None) -> List[dict]:
    """Feed this round's verdicts through the FSM and queue store lines.

    With an ``analytics`` bundle (``--analytics``), every boolean verdict
    is ALSO folded into the segment store's roll-up buckets and the CUSUM
    flap detector — a detection on a still-HEALTHY node promotes it to
    SUSPECT through :meth:`HealthFSM.promote_suspect` (the prediction
    seam) BEFORE the store line and payload are stamped, so the persisted
    round and the served state agree.  Returns the round's prediction
    records (empty without analytics).

    ``steady`` carries the watch-stream tick path's UNCHANGED nodes:
    their current verdicts fold into analytics (roll-up buckets keep
    counting, CUSUM scores keep draining) but they neither re-observe the
    FSM nor append history lines — the stream mode's evidence discipline
    (DESIGN.md §12: the FSM sees changed nodes only) is untouched, while
    a steady fleet still produces roll-ups instead of none at all.  A
    steady node the FSM has never observed folds nothing (analytics must
    not mint state from a node whose first real round hasn't landed).

    Verdict rules:

    * a node's round is good iff it is *effectively* ready (kubelet Ready,
      schedulable, chips alive when probed) — the same readiness the exit
      code consumes;
    * a node WE quarantined with no probe evidence this round observes
      ``None``: state holds — absence must neither heal (an evidence-free
      "good" round counting toward ``--uncordon-after``) nor sicken;
    * likewise a kubelet-healthy node whose only badness is a MISSING
      probe report (``--probe-results-required`` synthesizes
      ``level="missing"``) observes ``None`` — a wedged emitter rollout
      must not bank rounds toward ``--cordon-after``, or K-1 rounds of
      absence plus one real failure would defeat the debounce;
    * a quarantined-by-us node that is no longer cordoned was uncordoned
      out-of-band (`kubectl uncordon` leaves our annotation behind): the
      FSM resets it to RECOVERING, never straight to HEALTHY — the
      stale-annotation sweep and the machine must agree that an override
      is a decision, not evidence.
    """
    import time as _time

    from tpu_node_checker_torch.history.fsm import DEGRADED

    fsm, store = history["fsm"], history["store"]
    now = round(_time.time(), 3)
    predictions: List[dict] = []
    cluster = None
    if analytics is not None and args is not None:
        name, source = resolve_cluster_name(args)
        # Same policy as the metrics label: only an EXPLICIT identity
        # groups analytics — inferred hostnames would mint per-restart
        # groups.
        cluster = name if source in ("flag", "env") else None
    rounds = [(n, False) for n in accel]
    if steady:
        rounds.extend((n, True) for n in steady)
    for n, is_steady in rounds:
        verdict: Optional[bool] = n.effectively_ready
        if n.quarantined_by_us and n.probe is None:
            verdict = None
        elif (
            not verdict
            and n.ready
            and n.schedulable
            and n.probe is not None
            and n.probe.get("level") == "missing"
        ):
            # Bad SOLELY because no report arrived: no evidence either way.
            verdict = None
        if (
            verdict is True
            and n.probe is not None
            and n.probe.get("mesh_degraded")
        ):
            # Chips passed but the mesh link sweep graded an ICI link
            # SLOW: the DEGRADED evidence class — affirmative evidence
            # that holds state (no banking toward --cordon-after, no
            # SUSPECT-streak reset, no flap-window entry; see
            # HealthFSM.observe).  The store records "ok": "degraded"
            # verbatim; the tail-seed's flap replay skips it like any
            # non-bool verdict.
            verdict = DEGRADED
        out_of_band = n.quarantined_by_us and not n.cordoned
        if is_steady and n.name not in fsm.nodes:
            continue
        if verdict is None and n.name not in fsm.nodes and not out_of_band:
            # No evidence about a node this machine has NEVER observed:
            # record nothing and attach nothing.  Minting (and persisting)
            # a default-HEALTHY machine here would seed uncordon-eligible
            # state from pure absence — a restart would then trust it.
            continue
        if not is_steady:
            fsm.observe(
                n.name,
                verdict,
                uncordoned_out_of_band=out_of_band,
            )
        if analytics is not None and isinstance(verdict, bool):
            detector, seg_store = analytics["detector"], analytics["store"]
            flipped = detector.flip(n.name, verdict)
            if detector.observe(n.name, flipped, round_seq):
                promoted = fsm.promote_suspect(n.name)
                prediction = {
                    "node": n.name,
                    "score": round(detector.score(n.name), 3),
                    "promoted": promoted is not None,
                }
                predictions.append(prediction)
                if events is not None:
                    events.emit(
                        "analytics-prediction",
                        trace_id=trace_id,
                        **prediction,
                    )
            # AFTER any promotion: the bucket's dwell and the store line
            # below must both carry the state this round ends in.
            seg_store.observe(
                n.name, now, verdict, fsm.health(n.name).state, flipped,
                group=_node_group_labels(args, n, cluster),
            )
        h = fsm.health(n.name)
        n.health = {"state": h.state, "streak": h.streak, "flaps": h.flaps}
        if is_steady:
            # Unchanged node: analytics folded above; no history line —
            # the store records evidence, and nothing changed.
            continue
        store.record(
            {
                "node": n.name,
                "ts": now,
                "ok": verdict,
                "causes": _node_round_causes(n),
                "state": h.state,
                "streak": h.streak,
                "flaps": h.flaps,
                "flaps_total": h.flaps_total,
            }
        )
    if analytics is not None:
        # The per-link timing channel AFTER every node's verdict landed:
        # a link-drift promotion belongs to the NEXT round's store lines
        # (this round's were stamped with the pre-promotion state above —
        # same before/after seam as any other prediction vs evidence).
        link_predictions = _observe_link_drift(
            analytics, accel, fsm, args=args, events=events,
            trace_id=trace_id, round_seq=round_seq,
        )
        predictions.extend(link_predictions)
        # Re-stamp the payload health of any node a link firing just
        # promoted, so payload["nodes"] and the history state gauges
        # agree within the round (the store line keeps the
        # pre-promotion state: prediction is not evidence).
        promoted_now = {
            m for p in link_predictions for m in p.get("promoted", ())
        }
        for n in accel:
            if n.name in promoted_now:
                h = fsm.health(n.name)
                n.health = {
                    "state": h.state, "streak": h.streak, "flaps": h.flaps,
                }
        # A departed node's episode could never close on its own (no
        # more observes drain its score): the standing prediction set
        # tracks THIS round's fleet, like the FSM state gauges.  The
        # store's lifetime aggregates deliberately keep departed nodes
        # (the flaps_total-counter policy) until retention ages them out.
        # On the tick path "this round's fleet" is changed ∪ steady.
        fleet_names = {n.name for n in accel}
        if steady:
            fleet_names.update(n.name for n in steady)
        analytics["detector"].prune(fleet_names)
        # Close+append buckets whose window passed; compaction rides the
        # same call when a shard outgrew its live set.
        analytics["store"].flush(now)
    return predictions


def _history_payload(history: dict, accel: List[NodeInfo]) -> dict:
    """The payload's ``history`` block.

    State gauges cover this round's fleet only; ``flaps_total`` is a
    counter and sums over every node the store remembers.
    """
    from tpu_node_checker_torch.history.fsm import CHRONIC, STATES

    fsm = history["fsm"]
    states = {s: 0 for s in STATES}
    chronic = []
    for n in accel:
        # .get, never .health(): the roll-up must not MINT a machine for a
        # node the FSM has never observed.
        h = fsm.nodes.get(n.name)
        if h is None:
            continue
        states[h.state] += 1
        if h.state == CHRONIC:
            chronic.append(n.name)
    flaps_total = sum(h.flaps_total for h in fsm.nodes.values())
    return {
        "states": states,
        "chronic": sorted(chronic),
        "flaps_total": flaps_total,
        "transitions": list(fsm.transitions),
        "thresholds": {
            "cordon_after": fsm.cordon_after,
            "uncordon_after": fsm.uncordon_after,
            "flap_threshold": fsm.flap_threshold,
            "flap_window": fsm.flap_window,
        },
    }


def _uncordon_recovered_nodes(args, accel: List[NodeInfo], client=None,
                              fsm=None, engine=None, events=None,
                              trace_id=None) -> dict:
    """``--uncordon-recovered``: lift OUR quarantines once chips pass again.

    The closing half of the quarantine lifecycle.  A node qualifies only
    when ALL of: it is cordoned, the cordon carries this tool's annotation
    (``QUARANTINE_ANNOTATION`` — a human's cordon is never touched), the
    kubelet reports Ready, and a *fresh passing* probe verdict vouches for
    the chips.  No budget: uncordoning restores capacity and each lift is
    individually evidence-backed.  Shares ``--cordon-dry-run``.

    With ``--history`` the hysteresis machine is consulted ON TOP of the
    evidence rules: the lift additionally needs the node to have re-earned
    HEALTHY (``--uncordon-after`` consecutive good rounds), and a CHRONIC
    flapper never qualifies — its passing round is the setup for its next
    failure, the exact churn the FSM exists to stop.
    """
    candidates = [
        n
        for n in accel
        if n.cordoned
        and n.quarantined_by_us
        and n.ready
        and n.probe is not None
        and n.probe.get("ok")
        and (fsm is None or fsm.uncordon_eligible(n.name))
    ]
    # Annotation hygiene: an annotated-but-SCHEDULABLE node means someone
    # lifted our quarantine out-of-band (`kubectl uncordon` only flips
    # spec.unschedulable).  Strip the stale annotation now, or a later
    # *human* cordon on the node would read as ours and be auto-lifted.
    stale = [n for n in accel if n.quarantined_by_us and not n.cordoned]
    report_entry: dict = {
        "dry_run": bool(getattr(args, "cordon_dry_run", False)),
        "uncordoned": [],
        "failed": [],
        "stale_annotations_cleared": [],
    }
    if not candidates and not stale:
        return report_entry
    if report_entry["dry_run"]:
        report_entry["uncordoned"] = sorted(n.name for n in candidates)
        report_entry["stale_annotations_cleared"] = sorted(n.name for n in stale)
        for n in candidates:
            # Preview post-action state throughout the run: the cordon
            # budget math (and payload nodes) must match what a real run
            # would do after this lift.
            n.cordoned = False
            n.quarantined_by_us = False
            print(
                f"[dry-run] would uncordon {n.name} (probe recovered)", file=sys.stderr
            )
        for n in stale:
            n.quarantined_by_us = False
            print(
                f"[dry-run] would clear stale quarantine annotation on {n.name}",
                file=sys.stderr,
            )
        return report_entry
    try:
        client = _resolve_client(args, client)
    except Exception as exc:  # tnc: allow-broad-except(best-effort, like cordoning)
        report_entry["failed"] = [
            {"node": n.name, "error": f"no cluster client: {exc}"} for n in candidates
        ]
        print(f"--uncordon-recovered: cannot reach cluster: {exc}", file=sys.stderr)
        return report_entry
    from tpu_node_checker_torch.remediation import actuate
    from tpu_node_checker_torch.utils.fanout import bounded_map

    engine = _ensure_engine(args, accel, engine, trace_id)
    workers = _api_concurrency(args)
    # Uncordons restore capacity: the budget engine always grants them,
    # but routing the PATCH through the actuate module keeps the audit
    # trail (and the TNC019 call-site invariant) uniform.
    decisions = {
        n.name: engine.decide("uncordon", n) for n in candidates
    }
    # Bounded parallel PATCHes (one pooled connection per worker); outcomes
    # come back in candidate order, so report lists and stderr notes stay
    # deterministic.  A dead-socket PATCH is NEVER transparently retried by
    # the transport (it may have applied) — it lands here as a failure note.
    for n, (ok, err) in zip(
        candidates,
        bounded_map(
            lambda n: actuate.uncordon(
                client, decisions[n.name], events=events, trace_id=trace_id
            ),
            candidates,
            workers,
        ),
    ):
        if not ok:
            report_entry["failed"].append({"node": n.name, "error": str(err)})
            print(f"Uncordon of {n.name} failed: {err}", file=sys.stderr)
        else:
            n.cordoned = False
            n.quarantined_by_us = False
            engine.commit(decisions[n.name])
            report_entry["uncordoned"].append(n.name)
            print(f"Uncordoned {n.name} (chip probe recovered).", file=sys.stderr)
    stale_decisions = {
        n.name: engine.decide("clear-annotation", n) for n in stale
    }
    for n, (ok, err) in zip(
        stale,
        bounded_map(
            lambda n: actuate.clear_annotation(
                client, stale_decisions[n.name], events=events,
                trace_id=trace_id,
            ),
            stale,
            workers,
        ),
    ):
        if not ok:
            report_entry["failed"].append({"node": n.name, "error": str(err)})
            print(
                f"Clearing stale annotation on {n.name} failed: {err}", file=sys.stderr
            )
        else:
            n.quarantined_by_us = False
            engine.commit(stale_decisions[n.name])
            report_entry["stale_annotations_cleared"].append(n.name)
            print(
                f"Cleared stale quarantine annotation on {n.name} "
                "(uncordoned out-of-band).",
                file=sys.stderr,
            )
    return report_entry


def _ensure_engine(args, accel, engine, trace_id=None):
    """Sweeps invoked directly (tests, embedders) without a round-owned
    engine still get the legacy --cordon-max gate — never a crash, never
    an ungated actuation."""
    if engine is not None:
        return engine
    from tpu_node_checker_torch.remediation import BudgetEngine

    engine = BudgetEngine(
        cordon_max=getattr(args, "cordon_max", 1) or 1, enabled=False
    )
    engine.begin_round(accel, trace_id=trace_id)
    return engine


def _failed_candidates(accel: List[NodeInfo], fsm=None) -> List[NodeInfo]:
    """The evidence rules for the cordon AND drain sweeps — one definition,
    so the two actuators can never disagree about who is condemnable:
    kubelet-Ready, schedulable, not already cordoned, carrying a REAL
    failed probe report this round (``level="missing"`` is absence, not
    evidence), FSM-gated (FAILED/CHRONIC) under ``--history``."""
    if fsm is None:
        return [
            n
            for n in accel
            if n.ready
            and n.schedulable  # dead-plugin nodes must not consume the budget
            and not n.cordoned
            and n.probe is not None
            and not n.probe.get("ok")
            and n.probe.get("level") != "missing"  # absent report ≠ dead chips
        ]
    return [
        n
        for n in accel
        if n.ready
        and n.schedulable
        and not n.cordoned
        and n.probe is not None
        and n.probe.get("level") != "missing"
        and fsm.cordon_eligible(n.name)
    ]


def _drain_failed_nodes(args, accel: List[NodeInfo], client=None, fsm=None,
                        engine=None, events=None, trace_id=None) -> dict:
    """``--drain-failed``: evict-then-cordon the condemned nodes.

    Same candidates as the cordon sweep (one evidence definition), same
    budget gate, but the actuation is the civilized sequence: Eviction-API
    POSTs (PDBs get their vote — a refusal is a budget denial with
    ``reason="pdb"``, never an error), then the cordon PATCH.  Dry-run is
    the DEFAULT (``--no-drain-dry-run`` opts into real evictions); dry
    runs still LIST the node's pods so the report shows the real blast
    radius (pod list + summed termination grace).
    """
    from tpu_node_checker_torch.remediation.drain import drain_nodes

    engine = _ensure_engine(args, accel, engine, trace_id)
    candidates = _failed_candidates(accel, fsm)
    dry_run = bool(getattr(args, "drain_dry_run", True))
    if not candidates:
        return {"dry_run": dry_run, "drained": [], "failed": [],
                "pods_evicted": 0, "grace_seconds_total": 0}
    try:
        client = _resolve_client(args, client)
    except Exception as exc:  # tnc: allow-broad-except(drain is best-effort, like cordoning)
        print(f"--drain-failed: cannot reach cluster: {exc}", file=sys.stderr)
        return {
            "dry_run": dry_run,
            "drained": [],
            "failed": [
                {"node": n.name, "error": f"no cluster client: {exc}"}
                for n in candidates
            ],
            "pods_evicted": 0,
            "grace_seconds_total": 0,
        }
    return drain_nodes(args, candidates, client, engine, events=events,
                       trace_id=trace_id)


def _cordon_failed_nodes(args, accel: List[NodeInfo], client=None, fsm=None,
                         engine=None, events=None, trace_id=None) -> dict:
    """``--cordon-failed``: mark probe-failed nodes unschedulable.

    Auto-quarantine for the one failure mode only this tool can see — a
    kubelet-Ready node whose *chips* are dead (probe verdict) — so the
    scheduler stops placing TPU jobs on it while a human investigates.
    Safety rails:

    * only kubelet-Ready, not-already-cordoned nodes with an explicit failed
      probe verdict qualify (NotReady nodes are already the control plane's
      problem; dead-device-plugin nodes are already unschedulable for
      device-requesting pods; an absent report is not evidence);
    * ``--cordon-max`` is a **budget on total cordoned state**, not a
      per-run rate: nodes already cordoned (by this tool or anyone) count
      against it, so a persistent fleet-wide regression under ``--watch``
      converges at N cordoned nodes instead of draining one more node per
      round until the pool is gone;
    * ``--cordon-dry-run`` reports the decisions without patching;
    * a PATCH failure is reported, never fatal — the check's own verdict
      stands regardless.

    Returns the report dict for the payload.  ``client`` reuses the LIST
    call's :class:`~tpu_node_checker_torch.cluster.KubeClient`; offline runs
    (``--nodes-json``) resolve one on demand.

    With ``--history`` the raw this-round verdict is replaced by the
    hysteresis machine: a node qualifies only once it has been bad for
    ``--cordon-after`` consecutive rounds (FAILED) or tripped the flap
    detector (CHRONIC) — one bad probe is a data point, not a diagnosis.
    The evidence rule survives the swap: a PATCH still requires a real
    probe report this round (``level="missing"`` is absence, not evidence).
    """
    engine = _ensure_engine(args, accel, engine, trace_id)
    candidates = _failed_candidates(accel, fsm)
    cap = getattr(args, "cordon_max", 1)
    already = sum(1 for n in accel if n.cordoned)
    dry_run = bool(getattr(args, "cordon_dry_run", False))
    # The budget engine has the only veto left: the Nth grant that would
    # exceed --cordon-max (the legacy alias), take a slice below its
    # floor, or exhaust the disruption budget/lease is refused — recorded
    # as an audit event and a denied_total sample, never a silent skip.
    to_cordon, decisions, capped = [], {}, []
    for n in candidates:
        decision = engine.decide("cordon", n, dry_run=dry_run)
        if decision.allowed:
            to_cordon.append(n)
            decisions[n.name] = decision
        elif decision.reason == "cordon-max":
            capped.append(n)
        # Other refusals (slice-floor / disruption-budget / lease) live in
        # the engine's denial list, surfaced via payload["remediation"].
    report_entry: dict = {
        "dry_run": dry_run,
        "cordoned": [],
        "failed": [],
        "already_cordoned": already,
        "skipped_over_cap": sorted(n.name for n in capped),
    }
    if capped:
        print(
            f"--cordon-failed: {len(capped)} candidate(s) beyond the "
            f"--cordon-max={cap} budget ({already} already cordoned) left "
            f"alone: {', '.join(report_entry['skipped_over_cap'])}",
            file=sys.stderr,
        )
    if not to_cordon:
        return report_entry
    if dry_run:
        report_entry["cordoned"] = sorted(n.name for n in to_cordon)
        for n in to_cordon:
            print(f"[dry-run] would cordon {n.name} (chip probe failed)", file=sys.stderr)
            if events is not None:
                events.emit(
                    "remediation-cordon",
                    trace_id=trace_id,
                    node=n.name,
                    domain=decisions[n.name].domain,
                    dry_run=True,
                )
        return report_entry
    try:
        client = _resolve_client(args, client)
    except Exception as exc:  # tnc: allow-broad-except(quarantine is best-effort)
        report_entry["failed"] = [
            {"node": n.name, "error": f"no cluster client: {exc}"} for n in to_cordon
        ]
        print(f"--cordon-failed: cannot reach cluster: {exc}", file=sys.stderr)
        return report_entry
    from tpu_node_checker_torch.remediation import actuate
    from tpu_node_checker_torch.utils.fanout import bounded_map

    # Bounded parallel PATCHes, results consumed in candidate order (see
    # _uncordon_recovered_nodes for the ordering/retry rationale).
    for n, (ok, err) in zip(
        to_cordon,
        bounded_map(
            lambda n: actuate.cordon(
                client, decisions[n.name], events=events, trace_id=trace_id
            ),
            to_cordon,
            _api_concurrency(args),
        ),
    ):
        if not ok:
            report_entry["failed"].append({"node": n.name, "error": str(err)})
            print(f"Cordon of {n.name} failed: {err}", file=sys.stderr)
        else:
            n.cordoned = True
            engine.commit(decisions[n.name])
            report_entry["cordoned"].append(n.name)
            print(f"Cordoned {n.name} (chip probe failed).", file=sys.stderr)
    return report_entry


def _degraded_candidates(accel: List[NodeInfo]) -> List[NodeInfo]:
    """The evidence rule for the ``--cordon-degraded`` sweep: kubelet-Ready,
    schedulable, not already cordoned, carrying a PASSING probe report
    this round whose mesh link sweep graded an ICI link SLOW.  Disjoint
    from :func:`_failed_candidates` by construction (a failed report is
    never ``ok``), so the two sweeps can never fight over one node."""
    return [
        n
        for n in accel
        if n.ready
        and n.schedulable
        and not n.cordoned
        and n.probe is not None
        and n.probe.get("ok")
        and n.probe.get("mesh_degraded")
    ]


def _cordon_degraded_nodes(args, accel: List[NodeInfo], client=None,
                           engine=None, events=None, trace_id=None) -> dict:
    """``--cordon-degraded``: quarantine the nodes of a slice whose ICI
    link the mesh sweep graded SLOW.

    The chips PASS — this is a capacity-quality call, not a failure
    verdict, which is why it is its own opt-in flag and its own payload
    block: a DEGRADED round never feeds the FSM's condemnation ladder
    (see :meth:`HealthFSM.observe`), so without this flag a slow link
    changes no actuation at all.  Every PATCH rides the budget engine's
    :meth:`decide` (TNC019) under the same rails as the failed sweep —
    ``--cordon-max`` total-state budget, slice floors, disruption
    budget/lease — so draining a sick-link slice can never take a slice
    below its floor or blow the round's disruption budget.  Dry-run
    follows ``--cordon-dry-run``; a PATCH failure is a report note,
    never fatal.
    """
    engine = _ensure_engine(args, accel, engine, trace_id)
    candidates = _degraded_candidates(accel)
    dry_run = bool(getattr(args, "cordon_dry_run", False))
    to_cordon, decisions, capped = [], {}, []
    for n in candidates:
        decision = engine.decide("cordon", n, dry_run=dry_run)
        if decision.allowed:
            to_cordon.append(n)
            decisions[n.name] = decision
        elif decision.reason == "cordon-max":
            capped.append(n)
    report_entry: dict = {
        "dry_run": dry_run,
        "cordoned": [],
        "failed": [],
        "links": sorted(
            {
                link
                for n in candidates
                for link in (_degraded_link_evidence([n]) or {}).get(n.name, ())
            }
        ),
        "skipped_over_cap": sorted(n.name for n in capped),
    }
    if capped:
        print(
            f"--cordon-degraded: {len(capped)} candidate(s) beyond the "
            f"--cordon-max budget left alone: "
            f"{', '.join(report_entry['skipped_over_cap'])}",
            file=sys.stderr,
        )
    if not to_cordon:
        return report_entry
    if dry_run:
        report_entry["cordoned"] = sorted(n.name for n in to_cordon)
        for n in to_cordon:
            print(
                f"[dry-run] would cordon {n.name} (degraded ICI link)",
                file=sys.stderr,
            )
            if events is not None:
                events.emit(
                    "remediation-cordon",
                    trace_id=trace_id,
                    node=n.name,
                    domain=decisions[n.name].domain,
                    degraded=True,
                    dry_run=True,
                )
        return report_entry
    try:
        client = _resolve_client(args, client)
    except Exception as exc:  # tnc: allow-broad-except(quarantine is best-effort)
        report_entry["failed"] = [
            {"node": n.name, "error": f"no cluster client: {exc}"}
            for n in to_cordon
        ]
        print(f"--cordon-degraded: cannot reach cluster: {exc}", file=sys.stderr)
        return report_entry
    from tpu_node_checker_torch.remediation import actuate
    from tpu_node_checker_torch.utils.fanout import bounded_map

    for n, (ok, err) in zip(
        to_cordon,
        bounded_map(
            lambda n: actuate.cordon(
                client, decisions[n.name], events=events, trace_id=trace_id
            ),
            to_cordon,
            _api_concurrency(args),
        ),
    ):
        if not ok:
            report_entry["failed"].append({"node": n.name, "error": str(err)})
            print(f"Cordon of {n.name} failed: {err}", file=sys.stderr)
        else:
            n.cordoned = True
            engine.commit(decisions[n.name])
            report_entry["cordoned"].append(n.name)
            print(f"Cordoned {n.name} (degraded ICI link).", file=sys.stderr)
    return report_entry


def resolve_cluster_name(args, client=None):
    """This checker's cluster identity → ``(name, source)``.

    Precedence: ``--cluster-name`` flag → ``$TNC_CLUSTER_NAME`` → the
    kubeconfig context the round resolved through → the hostname.
    """
    flag = getattr(args, "cluster_name", None)
    if flag:
        return flag, "flag"
    env = os.environ.get("TNC_CLUSTER_NAME")
    if env:
        return env, "env"
    context = getattr(getattr(client, "config", None), "context_name", None)
    if context:
        return context, "context"
    import socket

    return socket.gethostname(), "hostname"


def stamp_cluster_identity(payload: dict, args, client=None) -> None:
    """Stamp the resolved cluster identity into one round payload."""
    name, source = resolve_cluster_name(args, client)
    payload["cluster"] = name
    payload["cluster_source"] = source


def grade_fleet(args, accel, effective_ready, slices):
    """The exit-code ladder plus the ``--expected-chips`` capacity math.

    Returns ``(exit_code, expected_key, expected_n, have_chips)``.
    """
    expectation = getattr(args, "expected_chips", None)
    expected_key, expected_n, have_chips = None, None, None
    if expectation is not None:
        expected_key, expected_n = expectation
        if expected_key is None:
            have_chips = sum(n.accelerators for n in effective_ready)
        else:
            have_chips = sum(
                v
                for n in effective_ready
                for k, v in n.breakdown.items()
                if fnmatch.fnmatchcase(k, expected_key)
            )
    if not accel:
        code = EXIT_NO_ACCEL_NODES
    elif not effective_ready:
        code = EXIT_NONE_READY
    elif getattr(args, "strict_slices", False) and any(not s.complete for s in slices):
        code = EXIT_NONE_READY
    elif expected_n is not None and have_chips < expected_n:
        # Cluster-level capacity assertion: some nodes may be Ready, but the
        # fleet is short of the chips the caller requires.
        code = EXIT_NONE_READY
    else:
        code = EXIT_OK
    return code, expected_key, expected_n, have_chips


def stamp_expected_chips(payload: dict, expected_key, expected_n, have_chips) -> None:
    """The payload's ``expected_chips*`` keys."""
    if expected_n is None:
        return
    payload["expected_chips"] = expected_n
    if expected_key is not None:
        payload["expected_chips_key"] = expected_key
    payload["expected_chips_have"] = have_chips
    payload["expected_chips_met"] = have_chips >= expected_n


def _emit_link_spans(timer, probe: Optional[dict]) -> None:
    """One named span per link leg of the local mesh sweep, backfilled into
    the round trace from the p50 the probe child measured."""
    record = getattr(timer, "record_timed_span", None)
    if record is None or not probe:
        return
    links = (probe.get("collective_legs_ok") or {}).get("links")
    if not isinstance(links, dict):
        return
    for link in sorted(links):
        entry = links[link]
        if not isinstance(entry, dict) or entry.get("p50_us") is None:
            continue
        record(
            f"mesh-link:{link}", float(entry["p50_us"]) / 1e3,
            verdict=entry.get("verdict"), budget_us=entry.get("budget_us"),
        )


def _node_link_domain(n: NodeInfo) -> Optional[str]:
    """The budget-domain name a node's links are qualified under (the
    remediation engine's ``_domain_name`` over ``slice_group_key``), or
    ``None`` for a node outside any slice grouping."""
    from tpu_node_checker_torch.detect import slice_group_key
    from tpu_node_checker_torch.remediation.budget import _domain_name

    key = slice_group_key(n)
    return _domain_name(key) if key is not None else None


def _node_mesh_links(n: NodeInfo) -> dict:
    """One node's per-link timing matrix (``collective_legs_ok.links``)
    from its probe report, or ``{}``."""
    links = ((n.probe or {}).get("collective_legs_ok") or {}).get("links")
    return links if isinstance(links, dict) else {}



def _degraded_link_evidence(accel: List[NodeInfo]) -> Optional[dict]:
    """This round's DEGRADED-link evidence for the budget engine:
    ``{node: [slice-qualified SLOW link names]}``, or ``None`` when no
    probed node reported a slow ICI link — the byte-identical-payload pin
    rides on the None (``begin_round`` then attaches no block)."""
    from tpu_node_checker_torch.meshprobe import qualify_link

    out: dict = {}
    for n in accel:
        slow = (n.probe or {}).get("mesh_slow_links")
        if not slow:
            continue
        domain = _node_link_domain(n)
        out[n.name] = sorted(qualify_link(domain, link) for link in slow)
    return out or None


def _mesh_link_samples(accel: List[NodeInfo]) -> List[tuple]:
    """This round's mesh histogram feed: ``(slice_domain, axis, p50_us)``
    per link, deduplicated by (domain, link): every host of a slice reports
    the same sweep."""
    samples: List[tuple] = []
    seen: set = set()
    for n in accel:
        links = _node_mesh_links(n)
        if not links:
            continue
        domain = _node_link_domain(n) or "-"
        for link in sorted(links):
            entry = links[link]
            if not isinstance(entry, dict) or entry.get("p50_us") is None:
                continue
            key = (domain, link)
            if key in seen:
                continue
            seen.add(key)
            samples.append((domain, link.split("/")[0], float(entry["p50_us"])))
    return samples


def run_check(args, nodes: Optional[List[dict]] = None,
              tracer=None, events=None) -> CheckResult:
    """Everything of the round except printing and Slack I/O, so tests can
    drive it directly; the payload carries the round's ``trace_id``.

    ``tracer`` (the watch loop) is the round's :class:`~tpu_node_checker_torch.
    obs.trace.Tracer`: the round's phases become its spans, and the loop
    writes it to ``--trace`` after the round.  Without one a fresh tracer is
    minted (the one-shot round).  ``nodes`` replaces the node list's fetch.
    ``events`` is the loop's event log, which the remediation audit lines
    ride; without one a stderr-only log is minted when an actuator runs.
    """
    timer = tracer if tracer is not None else PhaseTimer()
    kube_client = None
    _ROUND_CLIENT["client"] = None  # telemetry tracks THIS round's traffic
    _ROUND_POLICY["policy"] = _build_retry_policy(args)
    # Per-phase failure notes of the non-essential phases (events, cordon,
    # uncordon, drain, repair): they mark the round degraded instead of
    # sinking it.  A failed node LIST still raises out of here (exit 1).
    degradation: dict = {}
    if nodes is None:
        nodes, kube_client = _fetch_nodes(args, timer)
    result = CheckResult(exit_code=EXIT_OK)
    with timer.phase("detect"):
        from tpu_node_checker_torch import fastpath

        entries = None
        if isinstance(nodes, fastpath.ProjectedFleet):
            if fastpath.reuse_allowed(args):
                # Content-addressed reuse: an unchanged grading digest
                # reuses the node's NodeInfo and its payload entry.
                accel, ready, entries, _changed = nodes.reuse.select(
                    nodes, _registry_from_args(args)
                )
            else:
                # A per-round attachment source (probe/events/history/
                # cordon) mutates NodeInfo per round: extract fresh.
                accel, ready = select_accelerator_nodes(
                    nodes.docs(), _registry_from_args(args)
                )
        else:
            accel, ready = select_accelerator_nodes(nodes, _registry_from_args(args))
        slices = group_slices(accel)
    result.accel, result.slices = accel, slices

    if getattr(args, "probe", False):
        with timer.phase("probe"):
            _run_probe(args, accel, result, slices)
        _emit_link_spans(timer, result.local_probe)
    reports_skipped = _attach_probe_results(args, accel)

    if getattr(args, "node_events", False):
        with timer.phase("events"):
            event_errors, events_truncated = _attach_node_events(
                args, accel, kube_client
            )
        if event_errors:
            degradation["events"] = event_errors[:_EVENTS_NODE_CAP]
        if events_truncated:
            # A capped events walk must never read as a complete one.
            degradation["events_truncated"] = events_truncated[:_EVENTS_NODE_CAP]

    # Per-node health history + hysteresis (--history): verdicts feed the
    # FSM after every probe surface attached.  None when the flag is off,
    # and then the payload does not change by a byte.
    history = _build_history(args)
    analytics = _build_analytics(args) if history is not None else None
    predictions: List[dict] = []
    if history is not None:
        with timer.phase("history"):
            predictions = _update_history(
                history, accel, analytics=analytics, args=args,
                events=_round_events(args, events) if analytics else None,
                trace_id=timer.trace_id,
                round_seq=getattr(timer, "round_seq", 0) or 0,
            )

    # Effective readiness: kubelet Ready minus unschedulable/probe-failed hosts.
    effective_ready = [n for n in ready if n.effectively_ready]
    result.ready = effective_ready

    result.exit_code, expected_key, expected_n, have_chips = grade_fleet(
        args, accel, effective_ready, slices
    )

    cordon_report = uncordon_report = None
    drain_report = repair_report = None
    remediation = None
    degraded_report = None
    actuation = (
        getattr(args, "cordon_failed", False)
        or getattr(args, "cordon_degraded", False)
        or getattr(args, "uncordon_recovered", False)
        or getattr(args, "drain_failed", False)
        or getattr(args, "repair_cmd", None)
        or getattr(args, "repair_webhook", None)
    )
    if actuation:
        # Before render, so payload["nodes"] reflects post-cordon state.
        # Every actuator below rides the budget engine's decision function:
        # the evidence rules pick candidates, budgets have the only
        # remaining veto, and each decision is one audit event joinable to
        # this round's trace.
        remediation = _build_remediation(args, history, events)
        engine, audit = remediation["engine"], remediation["events"]
        engine.begin_round(
            accel, trace_id=timer.trace_id,
            # The analytics tier's standing prediction set (--analytics):
            # a predicted flapper is refused disruptive actions.
            predictions=set(analytics["detector"].active) if analytics else None,
            # This round's DEGRADED-link evidence (node → slice-qualified
            # SLOW links), which the --cordon-degraded sweep consumes.
            degraded=_degraded_link_evidence(accel),
        )
        fsm = history["fsm"] if history is not None else None
        with timer.phase("cordon"):
            if getattr(args, "uncordon_recovered", False):
                # Uncordon first: a recovered node leaving quarantine frees
                # --cordon-max budget for this round's new failures.
                uncordon_report = _uncordon_recovered_nodes(
                    args, accel, client=kube_client, fsm=fsm, engine=engine,
                    events=audit, trace_id=timer.trace_id,
                )
            if getattr(args, "cordon_failed", False):
                cordon_report = _cordon_failed_nodes(
                    args, accel, client=kube_client, fsm=fsm, engine=engine,
                    events=audit, trace_id=timer.trace_id,
                )
            if getattr(args, "cordon_degraded", False):
                # After the failed sweep: dead chips outrank a slow link
                # for whatever --cordon-max budget remains.
                degraded_report = _cordon_degraded_nodes(
                    args, accel, client=kube_client, engine=engine,
                    events=audit, trace_id=timer.trace_id,
                )
        if getattr(args, "drain_failed", False):
            with timer.phase("drain"):
                drain_report = _drain_failed_nodes(
                    args, accel, client=kube_client, fsm=fsm, engine=engine,
                    events=audit, trace_id=timer.trace_id,
                )
        if getattr(args, "repair_cmd", None) or getattr(
            args, "repair_webhook", None
        ):
            from tpu_node_checker_torch.remediation.repair import run_repairs

            with timer.phase("repair"):
                repair_report = run_repairs(
                    args, accel, engine, remediation["tracker"], fsm=fsm,
                    events=audit, trace_id=timer.trace_id,
                )
    if history is not None:
        # Flush after remediation: the persisted round carries the
        # out-of-band RECOVERING resets the sweep acted on, and the repair
        # sweep's own state lines.
        history["store"].flush()

    with timer.phase("render"):
        payload = report.build_json_payload(
            accel, effective_ready, slices, timings_ms=None, entries=entries
        )
        multislices = group_multislices(
            slices, getattr(args, "multislice_label", None) or ()
        )
        if multislices:
            payload["multislices"] = [m.to_dict() for m in multislices]
            result.multislices = multislices
        if result.local_probe is not None:
            payload["local_probe"] = result.local_probe
        if getattr(args, "probe_results", None):
            # Fleet roll-up of per-host verdicts, only under --probe-results
            # (a single-host --probe run must not produce a fleet-looking
            # "hosts_failed: []").  Emitted even when no report was usable.
            # Synthesized level="missing" entries are hosts that did NOT
            # report, counted separately.
            probed = [
                n
                for n in accel
                if n.probe is not None and n.probe.get("level") != "missing"
            ]
            payload["probe_summary"] = {
                "hosts_reported": len(probed),
                "hosts_ok": sum(1 for n in probed if n.probe.get("ok")),
                "hosts_failed": sorted(
                    n.name for n in probed if not n.probe.get("ok")
                ),
                "hosts_missing": sorted(
                    n.name
                    for n in accel
                    if n.probe is not None and n.probe.get("level") == "missing"
                ),
            }
            floor_failed = sorted(
                n.name
                for n in probed
                if not n.probe.get("ok")  # subset-of-hosts_failed invariant
                and isinstance(n.probe.get("perf_floor"), dict)
                and n.probe["perf_floor"].get("ok") is False
            )
            if floor_failed:
                # "Dead" and "slow" are different repairs.
                payload["probe_summary"]["hosts_floor_failed"] = floor_failed
            if any(reports_skipped.values()):
                # Reports present but refused: a sick emitter population is
                # its own incident, distinct from hosts that never wrote.
                payload["probe_summary"]["reports_skipped"] = {
                    k: v for k, v in reports_skipped.items() if v
                }
        stamp_expected_chips(payload, expected_key, expected_n, have_chips)
        if cordon_report is not None:
            payload["cordon"] = cordon_report
        if degraded_report is not None:
            payload["cordon_degraded"] = degraded_report
        if uncordon_report is not None:
            payload["uncordon"] = uncordon_report
        if drain_report is not None:
            payload["drain"] = drain_report
        if repair_report is not None:
            payload["repair"] = repair_report
        if remediation is not None:
            engine = remediation["engine"]
            if engine.enabled or engine.ever_denied:
                # The budget view: domains, floors, denials, counters, what
                # the remediation_* metric families serve.  Legacy runs (no
                # new flags) attach it only once a denial has occurred.
                payload["remediation"] = engine.payload_block()
        if history is not None:
            # Per-node state/streak/flaps ride on each node entry; this is
            # the fleet roll-up plus the round's transition log.
            payload["history"] = _history_payload(history, accel)
        if analytics is not None:
            # The analytics roll-up block (--analytics): this round's
            # predictions plus store telemetry, what the
            # tpu_node_checker_analytics_* families render.  The full SLO
            # documents ride result.analytics_docs (below): they are a
            # serving surface, not round state.
            detector, seg_store = analytics["detector"], analytics["store"]
            payload["analytics"] = {
                "predictions": predictions,
                "predictions_total": detector.detections_total,
                "suspects": sorted(detector.active),
                "buckets": seg_store.bucket_counts(),
                "rollup_lines_total": seg_store.rollup_lines_total,
                "compactions_total": seg_store.compactions_total,
                "sketch_samples": dict(
                    sorted(seg_store.sketch_samples_total.items())
                ),
            }
        for phase_name, rep in (("cordon", cordon_report),
                                ("cordon_degraded", degraded_report),
                                ("uncordon", uncordon_report),
                                ("drain", drain_report),
                                ("repair", repair_report)):
            failed = (rep or {}).get("failed")
            if failed:
                degradation[phase_name] = [
                    f"{f.get('node')}: {f.get('error')}" for f in failed[:_CAUSES_CAP]
                ]
        if degradation:
            # Partial degradation: the round's verdict stands, and the
            # payload says which non-essential phase lost data and why.
            payload["degraded"] = True
            payload["degradation"] = degradation
        # Keep-alive pool telemetry (session-lifetime counters) of the live
        # client this round rode.
        live_client = kube_client or _ROUND_CLIENT["client"]
        if live_client is not None:
            stats = getattr(live_client, "transport_stats", lambda: {})()
            if stats:
                payload["api_transport"] = stats
        stamp_cluster_identity(payload, args, live_client)
        payload["trace_id"] = timer.trace_id
        payload["exit_code"] = result.exit_code
    if analytics is not None:
        # The round's wall time and the deduplicated per-link sweep medians
        # fold into the reserved "_fleet" stream's buckets, before the
        # query phase, so this round's documents include this round.
        _fold_round_samples(analytics, accel, timer)
        # The documents of GET /api/v1/analytics/*, computed from roll-ups
        # and serialized once by the server's publish_analytics.
        from tpu_node_checker_torch.analytics import build_analytics_docs

        with timer.phase("analytics-query"):
            result.analytics_docs = build_analytics_docs(
                analytics["store"], detector=analytics["detector"],
                predictions=predictions,
            )
    payload["timings_ms"] = timer.as_dict()
    result.payload = payload
    if tracer is None and getattr(args, "trace", None):
        # One-shot (caller-owned tracers are written by the round loop,
        # AFTER the publish span lands on the same trace).
        _write_trace_file(
            args.trace, timer, announce=getattr(args, "watch", None) is None
        )
    return result


def _write_trace_file(trace_path: str, timer, announce: bool = False) -> None:
    """``--trace FILE``: one Chrome-trace document per round, written
    atomically (tmp + rename), so a reader never sees torn JSON; the watch
    loop rewrites it every round."""
    try:
        tmp = f"{trace_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(timer.chrome_trace(), f)
        os.replace(tmp, trace_path)
        if announce:
            print(f"Trace written to {trace_path}.", file=sys.stderr)
    except OSError as exc:
        print(f"Cannot write trace {trace_path}: {exc}", file=sys.stderr)


def _append_jsonl(path: str, entry: dict) -> None:
    """Append one JSONL line, never raising: a full disk must not kill a
    monitoring round (the round's and the emitter's logs both)."""
    try:
        with open(path, "a") as f:
            f.write(json.dumps(entry, ensure_ascii=False) + "\n")
    except OSError as exc:
        print(f"Cannot append state log {path}: {exc}", file=sys.stderr)


_CAUSES_CAP = 6


def _round_causes(payload: dict) -> List[str]:
    """Compact, capped "what was wrong" summary for one degraded round,
    ordered by actionability: capacity, incomplete slices, probe-failed /
    unreported hosts, chronic flappers, then sick individual nodes."""
    causes: List[str] = []
    if not payload.get("nodes"):
        causes.append("no accelerator nodes")
    if payload.get("expected_chips") is not None and not payload.get(
        "expected_chips_met"
    ):
        key = payload.get("expected_chips_key")
        what = f"{key} chips" if key else "chips"
        causes.append(
            f"expected ≥{payload['expected_chips']} {what}, "
            f"have {payload.get('expected_chips_have')}"
        )
    for s in payload.get("slices", []):
        if not s.get("complete"):
            expected = s.get("expected_hosts") or s.get("hosts")
            note = f" ({s['planned_context']})" if s.get("planned_context") else ""
            causes.append(
                f"slice {s.get('id')}: {s.get('ready_hosts')}/{expected} "
                f"hosts ready{note}"
            )
    summary = payload.get("probe_summary") or {}
    for h in summary.get("hosts_failed", []):
        causes.append(f"probe-failed: {h}")
    for h in summary.get("hosts_missing", []):
        causes.append(f"no probe report: {h}")
    for h in (payload.get("history") or {}).get("chronic", []):
        causes.append(f"chronic-flapper: {h}")
    for n in payload.get("nodes", []):
        if not n.get("ready"):
            nr = n.get("not_ready") or {}
            why = format_why_not_ready(
                nr.get("reason"), nr.get("message"),
                n.get("adverse_conditions") or (),
            )
            causes.append(
                f"not-ready: {n.get('name')}" + (f" ({why})" if why else "")
            )
        elif not n.get("schedulable", True):
            causes.append(f"no allocatable devices: {n.get('name')}")
        elif not summary and isinstance(n.get("probe"), dict) and not n["probe"].get("ok"):
            # Single-host --probe runs have no fleet summary; name the host
            # here instead.
            causes.append(f"probe-failed: {n.get('name')}")
    if len(causes) > _CAUSES_CAP:
        omitted = len(causes) - (_CAUSES_CAP - 1)
        causes = causes[: _CAUSES_CAP - 1] + [f"+{omitted} more"]
    return causes


def _round_is_planned(payload: dict, exit_code: int) -> bool:
    """True when a degraded round is FULLY explained by planned disruption:
    every unusable node carries a hard planned signal and no failed probe,
    and every incomplete slice the matching context."""
    if exit_code == EXIT_OK or not payload.get("nodes"):
        return False

    def _excused(n: dict) -> bool:
        dis = set((n.get("planned") or {}).get("disruptions") or ())
        if not dis & HARD_PLANNED_DISRUPTIONS:
            return False
        return not (
            isinstance(n.get("probe"), dict) and not n["probe"].get("ok")
        )

    sick = [
        n
        for n in payload["nodes"]
        if not n.get("ready")
        or not n.get("schedulable", True)
        or (isinstance(n.get("probe"), dict) and not n["probe"].get("ok"))
    ]
    if not sick:
        return False
    if any(not _excused(n) for n in sick):
        return False
    return all(
        s.get("complete") or s.get("planned_context")
        for s in payload.get("slices", [])
    )


def _append_state_log(args, result: Optional[CheckResult], error: Optional[str] = None) -> None:
    """``--log-jsonl FILE``: append one line per check round, the trend
    record ``--trend`` reads; degraded rounds also record capped
    ``causes``."""
    path = getattr(args, "log_jsonl", None)
    if not path:
        return
    entry: dict = {"ts": round(time.time(), 3)}
    if result is not None:
        p = result.payload
        entry.update(
            exit_code=result.exit_code,
            total_nodes=p.get("total_nodes"),
            ready_nodes=p.get("ready_nodes"),
            total_chips=p.get("total_chips"),
            ready_chips=p.get("ready_chips"),
            slices_complete=sum(1 for s in p.get("slices", []) if s.get("complete")),
            slices=len(p.get("slices", [])),
            duration_ms=p.get("timings_ms", {}).get("total"),
        )
        if p.get("degraded"):
            entry["degraded"] = True
        chronic = (p.get("history") or {}).get("chronic")
        if chronic:
            entry["chronic"] = list(chronic)
        if result.exit_code != EXIT_OK:
            causes = _round_causes(p)
            if causes:
                entry["causes"] = causes
            if _round_is_planned(p, result.exit_code):
                entry["planned"] = True
    else:
        entry.update(exit_code=EXIT_ERROR, error=error)
    _append_jsonl(path, entry)


def one_shot(args) -> int:
    """Full run with side effects; returns the process exit code."""
    result = run_check(args)
    _append_state_log(args, result)
    return render_and_notify(args, result)


def render_and_notify(args, result: CheckResult, notify_enabled: bool = True) -> int:
    """Deliver Slack (policy-gated; the watch loop's ``--slack-on-change``
    turns it off for an unchanged round) then print.  Returns the exit
    code."""
    accel, ready, slices = result.accel, result.ready, result.slices

    healthy = result.exit_code == EXIT_OK
    history = result.payload.get("history")
    # An actionable hysteresis transition (→FAILED, →CHRONIC, a re-earned
    # HEALTHY) pages even under --slack-only-on-error on an exit-0 round.
    transitions = bool(
        history
        and any(t.get("actionable") for t in history.get("transitions", []))
    )
    webhook = notify.get_slack_webhook_url(getattr(args, "slack_webhook", None))
    if notify_enabled and notify.should_send_slack_message(
        webhook,
        getattr(args, "slack_only_on_error", False),
        healthy,
        transitions=transitions,
    ):
        message = report.format_slack_message(
            accel,
            ready,
            slices,
            healthy=healthy,
            multislices=result.multislices,
            cordon=result.payload.get("cordon"),
            uncordon=result.payload.get("uncordon"),
            history=history,
            drain=result.payload.get("drain"),
            remediation=result.payload.get("remediation"),
        )
        sent = notify.send_slack_message(
            webhook,
            message,
            username=getattr(args, "slack_username", notify.DEFAULT_USERNAME),
            max_retries=getattr(args, "slack_retry_count", notify.DEFAULT_MAX_RETRIES),
            retry_delay=getattr(args, "slack_retry_delay", notify.DEFAULT_RETRY_DELAY_S),
            trace_id=result.payload.get("trace_id"),
        )
        if not getattr(args, "json", False):
            # Console confirmation suppressed in JSON mode.
            if sent:
                print("Slack notification sent.")
            else:
                print("Slack notification failed (check stderr).", file=sys.stderr)

    if getattr(args, "json", False):
        print(report.dumps(result.payload))
    else:
        print(report.summary_line(accel, ready))
        if result.payload.get("expected_chips") is not None and not result.payload.get(
            "expected_chips_met"
        ):
            key = result.payload.get("expected_chips_key")
            what = f"{key} chips" if key else "Ready chips"
            print(
                f"⚠️ Expected ≥{result.payload['expected_chips']} {what}, "
                f"have {result.payload.get('expected_chips_have')}."
            )
        print()
        print(report.format_node_table(accel))
        slice_table = report.format_slice_table(slices)
        if slice_table:
            print()
            print(slice_table)
        ms_table = report.format_multislice_table(result.multislices)
        if ms_table:
            print()
            print(ms_table)
        if result.local_probe is not None:
            status = "ok" if result.local_probe.get("ok") else "FAILED"
            print()
            print(
                f"Local chip probe [{result.local_probe.get('level')}] {status}: "
                f"{result.local_probe.get('device_count')} device(s), "
                f"platform={result.local_probe.get('platform')}"
            )
            floor = result.local_probe.get("perf_floor")
            if isinstance(floor, dict):
                if floor.get("skipped"):
                    print(f"Perf floors: skipped — {floor['skipped']}")
                elif floor.get("ok"):
                    worst = min(floor.get("ratios", {}).values(), default=None)
                    note = f" (worst ratio {worst}× of peak)" if worst is not None else ""
                    print(f"Perf floors: cleared at {floor.get('fraction')}× "
                          f"{floor.get('generation')} peak{note}")
                else:
                    from tpu_node_checker_torch.probe.floors import floor_failure_message
                    print(f"Perf floors: FAILED — {floor_failure_message(floor)}")
        if getattr(args, "debug", False):
            print()
            print("Timings (ms): " + json.dumps(result.payload.get("timings_ms", {})))
    return result.exit_code


# Circuit-breaker tuning for the watch loop: the breaker OPENS after this
# many CONSECUTIVE failed rounds (run_check raised: "the monitor is down",
# not a degraded fleet verdict), and while open the inter-round interval
# widens by doubling, capped at this multiple of the configured interval.
BREAKER_THRESHOLD = 3
BREAKER_MAX_SCALE = 8


class WatchBreaker:
    """Watch-mode circuit breaker over consecutive failed rounds.

    State machine::

        CLOSED --(threshold consecutive failures)--> OPEN   ["opened"]
        OPEN   --(any successful round)-----------> CLOSED  ["closed"]

    While OPEN: the effective interval widens (``interval_scale``), and the
    per-round "monitor failed" alerts are suppressed — ONE "monitor
    degraded" alert fired at the open transition covers them, and the close
    transition alerts recovery.  A breaker round is never written as fleet
    state: the trend log keeps recording exit-1 rounds as before.
    """

    def __init__(self, threshold: int = BREAKER_THRESHOLD, max_scale: int = BREAKER_MAX_SCALE):
        self.threshold = max(1, threshold)
        self.max_scale = max(1, max_scale)
        self.consecutive_failures = 0
        self.open = False

    def record_failure(self) -> Optional[str]:
        """Returns "opened" when this failure trips the breaker."""
        self.consecutive_failures += 1
        if not self.open and self.consecutive_failures >= self.threshold:
            self.open = True
            return "opened"
        return None

    def record_success(self) -> Optional[str]:
        """Returns "closed" when this success recovers an open breaker."""
        self.consecutive_failures = 0
        if self.open:
            self.open = False
            return "closed"
        return None

    def interval_scale(self) -> int:
        """Multiplier on the configured interval: 1 while closed; doubling
        from 2 per further failed round while open, capped."""
        if not self.open:
            return 1
        return min(self.max_scale, 2 ** (self.consecutive_failures - self.threshold + 1))

    def as_dict(self) -> dict:
        return {
            "open": self.open,
            "consecutive_failures": self.consecutive_failures,
        }


def _install_stop_signal(stop) -> object:
    """SIGTERM → set ``stop`` so the loop exits at the next wait instead of
    dying mid-round with the round's state unlogged (a Deployment rollout
    sends SIGTERM, waits terminationGracePeriodSeconds, then KILLs).
    Returns the previous handler for restoration, or None where signals
    aren't installable (non-POSIX, non-main thread — tests)."""
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


def _wait_for_next_round(stop, seconds: float) -> bool:
    """Event-based inter-round wait: returns True when shutdown was
    requested (promptly — mid-wait, not after sleeping the interval out).
    The seam the loop tests fake their clock through."""
    return stop.wait(max(0.0, seconds))


def _api_write_decision(node: dict, action: str) -> tuple:
    """Evidence rules for one fleet-API write → ``(eligible, reason)``.

    Evaluated over the last round's IMMUTABLE snapshot entry — the write
    path must not race (or lock against) a round in flight.  The rules are
    the same ones the ``--cordon-failed`` / ``--uncordon-recovered`` sweeps
    apply: FSM-gated when the round carried hysteresis state, probe-evidence
    gated otherwise — an authenticated caller can ask, only evidence can
    approve.  A refusal is a 409, distinct from auth (401/403).
    """
    health = node.get("health") if isinstance(node.get("health"), dict) else None
    state = (health or {}).get("state")
    probe = node.get("probe") if isinstance(node.get("probe"), dict) else None
    if action == "cordon":
        if node.get("cordoned"):
            return False, "already cordoned"
        if not node.get("ready"):
            return False, (
                "node is NotReady — already the control plane's problem; "
                "cordon is for kubelet-Ready nodes with dead chips"
            )
        if not node.get("schedulable", True):
            return False, (
                "no allocatable devices — already unschedulable for "
                "device-requesting pods"
            )
        if probe is None or probe.get("level") == "missing":
            # Same rule as the sweep: a PATCH needs a REAL probe report
            # from the last round; absence is not evidence.
            return False, "no probe evidence in the last round"
        if health is not None:
            from tpu_node_checker_torch.history.fsm import CHRONIC, FAILED

            if state not in (FAILED, CHRONIC):
                return False, (
                    f"hysteresis state {state} is not cordon-eligible "
                    "(needs FAILED or CHRONIC)"
                )
            return True, f"hysteresis state {state} with probe evidence"
        if probe.get("ok"):
            return False, "probe passed in the last round — nothing to quarantine"
        return True, "probe failed in the last round"
    # uncordon
    if not node.get("cordoned"):
        return False, "not cordoned"
    if not node.get("quarantined_by_us"):
        return False, (
            "cordon is not ours (no quarantine annotation) — human cordons "
            "are never touched; use kubectl uncordon"
        )
    if not node.get("ready"):
        return False, "kubelet does not report Ready"
    if probe is None or not probe.get("ok"):
        return False, "no fresh passing probe verdict vouches for the chips"
    if health is not None:
        from tpu_node_checker_torch.history.fsm import CHRONIC, HEALTHY

        if state == CHRONIC:
            return False, (
                "CHRONIC flapper: held cordoned — a passing round is the "
                "setup for its next failure (uncordon out-of-band to override)"
            )
        if state != HEALTHY:
            return False, (
                f"hysteresis state {state} is not uncordon-eligible "
                "(needs re-earned HEALTHY)"
            )
        return True, "re-earned HEALTHY with passing probe"
    return True, "Ready with passing probe"


def _make_serve_control(args, events=None):
    """The fleet API's write-path seam: decide over the snapshot, PATCH on
    a PRIVATE client.

    The round's pooled session stays untouched — a write resolves (and
    closes) its own client, so a control-plane PATCH can never race the
    check loop's keep-alive pool or ride a round's retry budget.  Writes
    are rare; one handshake each is the cost of isolation.

    The ``--cordon-max`` budget applies here exactly as in the sweep —
    total cordoned state, counting the snapshot's already-cordoned nodes
    PLUS cordons this control path applied since that snapshot (the
    snapshot is immutable, so an applied PATCH is invisible to it until
    the next round publishes) — a token holder must not be able to drain
    the pool one authenticated request at a time.
    """
    # Cordons applied via the API since the snapshot they were decided on.
    round_state = {"seq": None, "applied": 0}

    def control(name: str, action: str, dry_run: bool, node: dict, snap) -> tuple:
        eligible, reason = _api_write_decision(node, action)
        if eligible and action == "cordon":
            if round_state["seq"] != snap.seq:
                round_state["seq"], round_state["applied"] = snap.seq, 0
            cap = getattr(args, "cordon_max", 1) or 1
            already = sum(
                1 for d in snap.node_docs.values() if d.get("cordoned")
            ) + round_state["applied"]
            if already >= cap:
                eligible = False
                reason = (
                    f"--cordon-max budget exhausted ({already} nodes already "
                    f"cordoned, cap {cap}) — raise --cordon-max deliberately "
                    "for mass-repair workflows"
                )
        body = {"applied": False, "eligible": eligible, "reason": reason,
                "dry_run": dry_run}
        if not eligible:
            return 409, body
        if dry_run:
            return 200, {**body, "would_apply": True}
        from tpu_node_checker_torch.cluster import KubeClient, resolve_cluster_config
        from tpu_node_checker_torch.remediation import actuate
        from tpu_node_checker_torch.remediation.budget import Decision

        client = KubeClient(
            resolve_cluster_config(
                getattr(args, "kubeconfig", None), getattr(args, "context", None)
            )
        )
        # The API write path decided eligibility (evidence rules) and the
        # --cordon-max budget above; the actuation itself still rides the
        # actuate module with an explicit granted Decision, so the TNC019
        # call-site invariant — and the per-actuation audit event — hold
        # on every path that touches a node.
        decision = Decision(True, action, name, None, reason)
        try:
            if action == "cordon":
                actuate.cordon(client, decision, events=events,
                               trace_id=snap.trace_id)
            else:
                actuate.uncordon(client, decision, events=events,
                                 trace_id=snap.trace_id)
        finally:
            client.close()
        if action == "cordon":
            round_state["applied"] += 1
        return 200, {**body, "applied": True}

    return control


def _serve_pool_kwargs(args) -> dict:
    """The serving-scale knobs both --serve modes share: worker count and
    the write-path token bucket (``None`` write_rps = unlimited)."""
    kwargs = {"workers": getattr(args, "serve_workers", None) or 1}
    write_rps = getattr(args, "write_rps", None)
    if write_rps:
        from tpu_node_checker_torch.server.ratelimit import TokenBucket

        kwargs["write_limiter"] = TokenBucket(write_rps)
    return kwargs


def serve_store(args) -> int:
    """``--serve PORT`` without ``--watch``: serve a RECORDED store.

    The standalone half of the fleet API: no check rounds run in this
    process.  ``/api/v1/nodes*`` and ``/api/v1/summary`` serve the
    ``--history`` store (each node's latest FSM line + fleet roll-up),
    ``/api/v1/trend`` the ``--log-jsonl`` trend log — both owned by
    ANOTHER process (the aggregator Deployment, a cron one-shot) and
    re-read only when their mtime/size signature moves, never per request.
    With only ``--log-jsonl``, the summary degrades to the log's last
    round.  Control-plane writes answer 503: with no live round there is
    no evidence to gate a PATCH on.  Runs until SIGTERM (exit 143).
    """
    import threading

    from tpu_node_checker_torch.server.app import FleetStateServer
    from tpu_node_checker_torch.server.auth import resolve_serve_token
    from tpu_node_checker_torch.server.snapshot import (
        build_store_snapshot,
        build_trendlog_snapshot,
    )

    history_path = getattr(args, "history", None)
    trend_path = getattr(args, "log_jsonl", None)
    source = history_path or trend_path
    state = {"sig": object(), "seq": 0}  # sentinel: first stat always differs
    refresh_lock = threading.Lock()
    holder: dict = {}

    def refresh() -> None:
        """Request-time seam: stat the store, rebuild the snapshot only on
        change.  A stat per request is the whole steady-state cost; the
        lock serializes concurrent pollers racing one store change, so a
        rewrite rebuilds (and bumps the served round) exactly once."""
        from tpu_node_checker_torch.history.store import file_signature

        sig = file_signature(source)
        if sig == state["sig"]:
            return
        with refresh_lock:
            if sig == state["sig"]:
                return  # another request rebuilt while we waited
            if sig is None:
                state["sig"] = None  # vanished store: keep the last snapshot
                return
            # seq commits only AFTER a successful build: a stat-able but
            # unreadable store (perms flipped mid-incident) must not bump
            # the served round per poll — that would churn the trend
            # cache's (seq, signature) key into a re-parse per request.
            now = round(time.time(), 3)
            snap = (
                build_store_snapshot(history_path, state["seq"] + 1, now)
                if history_path
                else build_trendlog_snapshot(trend_path, state["seq"] + 1, now)
            )
            state["seq"] += 1
            if snap.node_docs or snap.exit_code is not None:
                # An empty store is "no completed round yet": /readyz must
                # stay 503 until a real round has been recorded.
                holder["server"].publish_snapshot(snap)
            state["sig"] = sig

    from tpu_node_checker_torch.obs import Observability

    # Standalone serving runs no rounds (the debug ring stays empty) but
    # the event log still carries the write-path audit lines.
    obs = Observability.from_args(args)
    server = FleetStateServer(
        args.serve,
        token=resolve_serve_token(getattr(args, "serve_token", None)),
        control=None,  # no live round → no evidence → writes answer 503
        trend_path=trend_path,
        refresh=refresh,
        obs=obs,
        **_serve_pool_kwargs(args),
    )
    holder["server"] = server
    try:
        refresh()
    except OSError as exc:
        print(f"Cannot read store {source}: {exc} (serving not-ready)", file=sys.stderr)
    requested_workers = getattr(args, "serve_workers", None) or 1
    if server.workers_active != requested_workers:
        print(
            f"--serve-workers {requested_workers}: SO_REUSEPORT unavailable "
            f"on this platform — serving with {server.workers_active} "
            "listener.",
            file=sys.stderr,
        )
    print(
        f"Serving fleet state API on port {server.port} "
        f"({server.workers_active} worker"
        f"{'s' if server.workers_active != 1 else ''}) over "
        f"{'history store ' + history_path if history_path else 'trend log ' + trend_path}"
        " (standalone: no check rounds run here; writes disabled).",
        file=sys.stderr,
    )
    stop = threading.Event()
    prev_handler = _install_stop_signal(stop)
    try:
        # Short wait slices, not one long one: Event.wait's underlying lock
        # acquire is NOT interruptible by signals in CPython, so a single
        # 3600 s wait would delay the SIGTERM handler — and the clean exit —
        # by up to an hour.  An idle wakeup per second costs one timed
        # acquire; the watch loop never hits this because its waits are
        # bounded by the (short) check interval.
        while not _wait_for_next_round(stop, 1.0):
            pass
        print("SIGTERM: fleet state API stopped cleanly.", file=sys.stderr)
        return 128 + 15
    finally:
        _restore_stop_signal(prev_handler)
        server.close()

def watch(args) -> int:
    """``--watch SECONDS``: run the round repeatedly (the aggregator
    Deployment's daemon mode).

    With ``--slack-on-change`` notifications fire only when the round's
    fingerprint (exit code, sick-node set, an actionable hysteresis
    transition) changes instead of every round.  Errors in a round are
    reported and the loop continues; consecutive failures trip a circuit
    breaker (:class:`WatchBreaker`) that widens the interval and collapses
    per-round failure alerts into one degraded/recovered pair.  Runs until
    interrupted — SIGTERM stops the loop cleanly after the current round
    (state log flushed) and returns 143.
    """
    import threading

    from tpu_node_checker_torch.obs import Observability

    interval = args.watch
    on_change = getattr(args, "slack_on_change", False)
    webhook = notify.get_slack_webhook_url(getattr(args, "slack_webhook", None))
    # The observability layer: per-round traces (debug ring + --trace),
    # round-phase histograms on every scrape surface, and the unified
    # event log (--event-log) breaker/FSM/audit lines ride through.
    obs = Observability.from_args(args)
    metrics_server = None
    if getattr(args, "metrics_port", None) is not None:
        from tpu_node_checker_torch.metrics import MetricsServer

        metrics_server = MetricsServer(args.metrics_port, obs=obs)
        print(f"Serving /metrics on port {metrics_server.port}", file=sys.stderr)
    last_code: Optional[int] = None
    # The previous round's sick-node set (None = unknown: first round,
    # resumed from a log that records only the code, or an error round).
    # Part of the change fingerprint so a same-code node swap still alerts.
    last_sick: Optional[tuple] = None
    # The previous round's budget/lease denial fingerprint — one Slack
    # alert per (domain, reason) per window, not one per refused node
    # per round (same dedup clock the sick-set half rides).
    last_denials: Optional[tuple] = None
    if on_change:
        # Resume across restarts: recover the last recorded outcome from the
        # trend log so a pod restart doesn't re-alert on an unchanged state.
        last_code = _recover_last_code(args)
        if last_code is not None:
            print(
                f"Resuming state-transition alerting from exit {last_code} "
                f"(recovered from {args.log_jsonl})",
                file=sys.stderr,
            )
    breaker = WatchBreaker()
    stop = threading.Event()
    prev_handler = _install_stop_signal(stop)
    username = getattr(args, "slack_username", notify.DEFAULT_USERNAME)
    engine = None
    if getattr(args, "watch_stream", False):
        # Watch-stream mode (--watch-stream): the round becomes a tick over
        # an event-fed node cache — one LIST seeds it, a watch stream keeps
        # it current, and only changed nodes are re-graded/re-encoded.  A
        # tick raises exactly like run_check when the stream is down and
        # the relist fails, so the breaker/backoff path below is shared.
        from tpu_node_checker_torch.watchstream import StreamRoundEngine

        engine = StreamRoundEngine(args)
        print(
            "Watch-stream mode: LIST once, then incremental rounds over "
            "the node watch (full relist only on stream loss/410).",
            file=sys.stderr,
        )
    fleet_server = None
    if getattr(args, "serve", None) is not None:
        # The fleet state API rides the watch loop: each completed round
        # publishes one immutable pre-serialized snapshot, so every poller
        # GET is a dict lookup + ETag/gzip negotiation — never a re-encode,
        # never a torn read mid-round (server/snapshot.py).
        from tpu_node_checker_torch.server.app import FleetStateServer
        from tpu_node_checker_torch.server.auth import resolve_serve_token

        fleet_server = FleetStateServer(
            args.serve,
            token=resolve_serve_token(getattr(args, "serve_token", None)),
            control=_make_serve_control(args, obs.events),
            trend_path=getattr(args, "log_jsonl", None),
            obs=obs,
            **_serve_pool_kwargs(args),
        )
        requested_workers = getattr(args, "serve_workers", None) or 1
        if fleet_server.workers_active != requested_workers:
            print(
                f"--serve-workers {requested_workers}: SO_REUSEPORT "
                "unavailable on this platform — serving with "
                f"{fleet_server.workers_active} listener.",
                file=sys.stderr,
            )
        print(
            f"Serving fleet state API on port {fleet_server.port} "
            f"({fleet_server.workers_active} worker"
            f"{'s' if fleet_server.workers_active != 1 else ''}: "
            "/api/v1/{summary,nodes,slices,trend}, /healthz, /readyz, "
            "/metrics).",
            file=sys.stderr,
        )
        if webhook:
            fleet_server.on_event = lambda kind, detail: notify.server_event(
                webhook, kind, detail, username=username
            )
            notify.server_event(
                webhook,
                "server-start",
                f"fleet state API listening on port {fleet_server.port}"
                + (
                    " (write endpoints token-gated)"
                    if resolve_serve_token(getattr(args, "serve_token", None))
                    else " (write endpoints disabled: no token)"
                ),
                username=username,
            )
    round_seq = 0
    try:
        while True:
            round_start = time.monotonic()
            round_seq += 1
            # One trace per round: the check's phases, the publish, and the
            # round's events all share its trace_id; completed traces land
            # in the debug ring (/api/v1/debug/rounds) and, under --trace,
            # in the Chrome-trace file.
            tracer = obs.tracer(round_seq)
            # The try covers ONLY the check itself: a failure here means "the
            # monitor is down" — a state of its own (EXIT_ERROR) so that
            # recovery also registers as a transition.  Render/notify problems
            # afterwards are reported but do not reclassify a successful round.
            try:
                if engine is not None:
                    result, delta = engine.tick(tracer=tracer)
                else:
                    result, delta = run_check(
                        args, tracer=tracer, events=obs.events
                    ), None
            except KeyboardInterrupt:
                raise
            except Exception as exc:  # tnc: allow-broad-except(a bad round must not kill the daemon)
                code = EXIT_ERROR
                tracer.set_error(str(exc))
                print(f"Check round failed: {exc}", file=sys.stderr)
                # The cached keep-alive client just failed a round: drop it so
                # the next round redials (and re-resolves credentials) instead
                # of re-trusting a pool that may hold only dead sockets.
                reset_client_cache()
                if engine is not None:
                    # The stream rode that client (or died with it): tear it
                    # down so the next tick reconnects from a clean dial.
                    engine.abort_stream()
                transition = breaker.record_failure()
                if metrics_server is not None:
                    metrics_server.set_breaker(breaker.as_dict())
                    metrics_server.mark_error(EXIT_ERROR)
                if fleet_server is not None:
                    # The last snapshot keeps serving (fleet state is
                    # UNKNOWN, not gone); an OPEN breaker flips /readyz.
                    fleet_server.mark_error(breaker.as_dict())
                _append_state_log(args, None, error=str(exc))
                if transition == "opened":
                    obs.events.emit(
                        "breaker-opened",
                        trace_id=tracer.trace_id,
                        consecutive_failures=breaker.consecutive_failures,
                        error=str(exc),
                    )
                sick = denials = None  # an error round observed no nodes
                changed = last_code is None or code != last_code
                if webhook:
                    if transition == "opened":
                        # ONE degraded alert covers the whole open stretch —
                        # not one page per failed round.
                        notify.send_slack_message(
                            webhook,
                            f"🚨 *Accelerator node monitor DEGRADED*: "
                            f"{breaker.consecutive_failures} consecutive check "
                            f"rounds failed (last: {exc}). Widening the check "
                            "interval; further failure alerts suppressed "
                            "until recovery.",
                            username=username,
                            max_retries=0,  # don't stall the watch loop
                        )
                    elif breaker.open:
                        pass  # suppressed: the degraded alert covers it
                    elif (not on_change) or changed:
                        notify.send_slack_message(
                            webhook,
                            f"❌ *Accelerator node check FAILED to run*: {exc}",
                            username=username,
                            max_retries=0,  # don't stall the watch loop on retries
                        )
            else:
                code = result.exit_code
                transition = breaker.record_success()
                if transition == "closed":
                    obs.events.emit(
                        "breaker-closed", trace_id=tracer.trace_id
                    )
                for t in (result.payload.get("history") or {}).get(
                    "transitions", []
                ):
                    if t.get("actionable"):
                        # The quarantine lifecycle, joinable to its round:
                        # →FAILED / →CHRONIC / a re-earned HEALTHY.
                        obs.events.emit(
                            "fsm-transition",
                            trace_id=tracer.trace_id,
                            node=t.get("node"),
                            transition=t,
                        )
                # BEFORE the scrape surface refreshes: update(result)
                # renders obs.prometheus_lines(), and this round's link
                # samples must already be in the family it renders.
                obs.record_mesh_links(_mesh_link_samples(result.accel or []))
                if metrics_server is not None:
                    metrics_server.set_breaker(breaker.as_dict())
                    metrics_server.update(result)
                _append_state_log(args, result)
                if fleet_server is not None:
                    # AFTER the state log append: /api/v1/trend's cache key
                    # includes the publication seq, so the new round's line
                    # must already be on disk when the seq moves.  A
                    # watch-stream tick with an EMPTY delta publishes
                    # nothing: served content would be byte-identical, and
                    # skipping the swap keeps every poller's cached ETag a
                    # 304 hit — the served round advances when the fleet
                    # changes, while the scrape surface (timestamp and
                    # stream-age gauges) keeps moving every tick.
                    with tracer.span("publish"):
                        if delta is None or delta:
                            fleet_server.publish(
                                result, breaker=breaker.as_dict(),
                                changed=delta, tracer=tracer,
                            )
                        else:
                            fleet_server.refresh_metrics(
                                result, breaker=breaker.as_dict()
                            )
                    # The budget view (GET /api/v1/remediation): swapped
                    # per round like every other entity; absent payload
                    # block clears it back to 404.
                    fleet_server.publish_remediation(
                        result.payload.get("remediation")
                    )
                    # The analytics view (GET /api/v1/analytics/*): same
                    # swap discipline; absent docs clear it back to 404.
                    fleet_server.publish_analytics(result.analytics_docs)
                sick = _round_sick_set(result)
                denials = _round_denials_fp(result)
                # Change fingerprint = exit code + sick-node set: a node
                # swap inside an unchanged code is still a transition.  The
                # set half compares only when both sides are known — after
                # a restart the log yields the code alone, and an unchanged
                # code must not re-alert just because the set is unknown.
                # An actionable hysteresis transition is a change by itself:
                # a RECOVERING node re-earning HEALTHY left the sick set
                # rounds ago, so neither half above moves when its
                # quarantine finally lifts — yet that lift must page.
                hist = result.payload.get("history")
                actionable = bool(
                    hist
                    and any(
                        t.get("actionable") for t in hist.get("transitions", [])
                    )
                )
                changed = (
                    last_code is None
                    or code != last_code
                    or actionable
                    or (last_sick is not None and sick != last_sick)
                    # A NEW (domain, reason) refusal — or one clearing —
                    # is a transition; the same refusal repeating every
                    # round of a standing storm is not.
                    or (last_denials is None and bool(denials))
                    or (last_denials is not None and denials is not None
                        and denials != last_denials)
                )
                if transition == "closed":
                    print(
                        "Monitor recovered: check rounds succeeding again; "
                        "interval restored.",
                        file=sys.stderr,
                    )
                    if webhook:
                        notify.send_slack_message(
                            webhook,
                            "✅ *Accelerator node monitor RECOVERED*: check "
                            "rounds are succeeding again (interval restored).",
                            username=username,
                            max_retries=0,
                        )
                try:
                    render_and_notify(args, result, notify_enabled=(not on_change) or changed)
                except Exception as exc:  # tnc: allow-broad-except(e.g. stdout pipe gone)
                    print(f"Render/notify failed (check itself OK): {exc}", file=sys.stderr)
            # The round's trace is done (publish span included): freeze it,
            # feed the phase histograms, make it queryable in the debug
            # ring — failed rounds too, labeled with their error.
            obs.complete(tracer)
            if getattr(args, "trace", None):
                _write_trace_file(args.trace, tracer)
            if last_code is not None and code != last_code:
                print(f"State change: exit {last_code} → {code}", file=sys.stderr)
            elif last_sick is not None and sick is not None and sick != last_sick:
                print(
                    f"State change: sick-node set {list(last_sick)} → "
                    f"{list(sick)} (exit {code} unchanged)",
                    file=sys.stderr,
                )
            last_code = code
            last_sick = sick
            last_denials = denials
            effective_interval = interval * breaker.interval_scale()
            if breaker.open:
                print(
                    f"Watch breaker OPEN ({breaker.consecutive_failures} "
                    f"consecutive failed rounds): next round in "
                    f"{effective_interval:g}s.",
                    file=sys.stderr,
                )
            # Fixed cadence, not fixed gap: the round's own cost (a
            # workload-level probe can take minutes) comes out of the
            # interval, so round N starts ~N*interval after the first and
            # --probe-results-max-age freshness math stays honest.  A round
            # slower than the interval runs back to back rather than
            # drifting further.  The wait is EVENT-based: SIGTERM wakes it
            # immediately instead of serving out the sleep.
            if _wait_for_next_round(
                stop, max(0.0, effective_interval - (time.monotonic() - round_start))
            ):
                print(
                    "SIGTERM: watch loop stopped cleanly (last round's state "
                    "log flushed).",
                    file=sys.stderr,
                )
                return 128 + 15  # conventional SIGTERM exit
    finally:
        _restore_stop_signal(prev_handler)
        if engine is not None:
            engine.close()
        if fleet_server is not None:
            fleet_server.close()


def _round_denials_fp(result: CheckResult) -> tuple:
    """Budget/lease denial fingerprint for ``--slack-on-change`` dedup —
    one definition (remediation.budget.denial_fingerprint): a 30-node
    storm inside one slice is ONE standing refusal, not 30 alerts, and
    not a fresh alert per round while it persists."""
    from tpu_node_checker_torch.remediation.budget import denial_fingerprint

    return denial_fingerprint(
        (result.payload.get("remediation") or {}).get("denials") or []
    )


def _round_sick_set(result: CheckResult) -> tuple:
    """The round's sick-node fingerprint for ``--slack-on-change``.

    The exit code alone under-fingerprints: a same-round node swap (A
    recovers, B fails) keeps the aggregate code and would stay silent, yet
    both events are pages.  Without history, the set is the raw
    not-effectively-ready nodes; with ``--history`` it is the DEBOUNCED
    (name, state) pairs in FAILED/CHRONIC — sub-threshold SUSPECT/
    RECOVERING wobble must not re-create the per-round alert churn the
    hysteresis exists to absorb (and FAILED→CHRONIC, same sick set, still
    alerts because the state rides in the pair).
    """
    if result.payload.get("history") is not None:
        from tpu_node_checker_torch.history.fsm import CHRONIC, FAILED

        return tuple(
            sorted(
                (n.name, (n.health or {}).get("state") or "")
                for n in result.accel
                if (n.health or {}).get("state") in (FAILED, CHRONIC)
            )
        )
    # The same effectively_ready the exit code consumed — NOT a payload
    # re-derivation that could drift from it.
    return tuple(sorted(n.name for n in result.accel if not n.effectively_ready))


def _recover_last_code(args) -> Optional[int]:
    """Last recorded ``exit_code`` from the ``--log-jsonl`` trend log, if any.

    The checkpoint/resume surface of watch mode: the trend log doubles as the
    durable state record, so ``--slack-on-change`` survives pod restarts
    without duplicate alerts.  Corrupt/missing logs degrade to ``None``
    (first round then alerts, the safe direction).
    """
    path = getattr(args, "log_jsonl", None)
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            # Tail read: the log grows unboundedly; only the end matters.
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 8192))
            lines = f.read().decode("utf-8", errors="replace").strip().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        try:
            code = json.loads(line).get("exit_code")
        except (json.JSONDecodeError, AttributeError):
            continue
        if isinstance(code, int):
            return code
    return None


def _cause_class(cause: str) -> str:
    """Fold one logged cause line into its failure CLASS for the --trend
    roll-up: per-host and per-slice names drop (a 64-host outage is one
    cause, not 64), the NotReady kubelet reason survives (different reasons
    route to different responders), and the "+N more" cap lines vanish."""
    cause = cause.strip()
    if not cause or re.fullmatch(r"\+\d+ more", cause):
        return ""
    head, sep, rest = cause.partition(":")
    head = head.strip()
    if head.startswith("slice "):
        return "slice incomplete"
    if head == "not-ready":
        # Only a reason-SHAPED token counts: a CamelCase condition name
        # (KubeletNotReady, NodeStatusUnknown), possibly a '+'-joined
        # adverse list (DiskPressure+PIDPressure), ending the paren group
        # or followed by ':'/','.  A message-only condition renders as
        # "(container runtime is down)" and its first word must not
        # masquerade as a kubelet reason class.
        m = re.search(r"\(([A-Z]\w*(?:\+[A-Z]\w*)*)\s*[:,)]", rest)
        return f"not-ready ({m.group(1)})" if m else "not-ready"
    if head.startswith("expected ≥"):
        return "capacity shortfall"
    # "probe-failed", "no probe report", "no allocatable devices",
    # "monitor error", "no accelerator nodes", ...
    return head if sep else cause[:40]


def compute_trend_summary(path: str, max_lines: Optional[int] = None):
    """The ``--trend`` analysis as data: ``(summary, reason, rounds, skipped)``.

    ``summary`` is the machine-readable object ``--trend --json`` prints
    (``None`` when the log is unreadable or holds no usable rounds, with
    ``reason`` saying why); ``rounds`` is the sorted ``(ts, code, entry)``
    list the human renderer formats timestamps from.  Shared by the CLI
    wrapper (:func:`trend_summary`) and the fleet API's ``/api/v1/trend``
    snapshot cache, so both surfaces compute one set of numbers.

    Both callers pass ``max_lines`` (default
    ``store.DEFAULT_TREND_TAIL_LINES``): the log is read through the
    bounded TAIL loader, so a multi-GB runaway log costs O(bound) memory
    per query instead of O(file) — and any log inside the bound (every
    realistic one) summarizes byte-identically to the unbounded read.
    """
    from tpu_node_checker_torch.history.store import (
        DEFAULT_TREND_TAIL_LINES,
        read_jsonl_tail,
    )

    if max_lines is None:
        max_lines = DEFAULT_TREND_TAIL_LINES
    skipped = 0
    try:
        entries, skipped, _offset = read_jsonl_tail(path, max_lines=max_lines)
    except OSError as exc:
        return None, f"unreadable: {exc}", [], skipped
    rounds = []
    for e in entries:
        try:
            ts = float(e["ts"])
            if not math.isfinite(ts):
                # NaN/inf ts would poison interval math and crash the UTC
                # formatter downstream.
                raise ValueError(f"non-finite ts {ts!r}")
            rounds.append((ts, int(e["exit_code"]), e))
        except (KeyError, TypeError, ValueError, OverflowError):
            # OverflowError: json round-trips Infinity, and int(inf) raises
            # it — a malformed line must be SKIPPED, never sink the analysis.
            skipped += 1
    if not rounds:
        return None, "has no usable rounds", [], skipped
    rounds.sort(key=lambda r: r[0])
    ok_rounds = sum(1 for _, code, _ in rounds if code == EXIT_OK)
    transitions = []
    last_code = None
    for ts, code, e in rounds:
        if last_code is not None and code != last_code:
            t = {"ts": round(ts, 3), "from": last_code, "to": code}
            # The entering round's recorded causes (or monitor error) ride
            # along, so a transition line names the slice/host that caused
            # it — the question a post-incident --trend exists to answer.
            causes = e.get("causes")
            if isinstance(causes, list) and causes:
                t["causes"] = [str(c) for c in causes[:_CAUSES_CAP]]
            elif code == EXIT_ERROR and e.get("error"):
                t["causes"] = [f"monitor error: {e['error']}"]
            transitions.append(t)
        last_code = code
    # Longest stretch of consecutive non-0 rounds, measured wall-clock from
    # the first bad round to the next good one (or the last entry).
    longest_outage_s = 0.0
    outage_start = None
    for ts, code, _ in rounds:
        if code != EXIT_OK and outage_start is None:
            outage_start = ts
        elif code == EXIT_OK and outage_start is not None:
            longest_outage_s = max(longest_outage_s, ts - outage_start)
            outage_start = None
    if outage_start is not None:
        longest_outage_s = max(longest_outage_s, rounds[-1][0] - outage_start)
    chip_ratios = [
        e["ready_chips"] / e["total_chips"]
        for _, _, e in rounds
        if isinstance(e.get("total_chips"), (int, float)) and e["total_chips"]
        and isinstance(e.get("ready_chips"), (int, float))
    ]
    slice_ratios = [
        e["slices_complete"] / e["slices"]
        for _, _, e in rounds
        if isinstance(e.get("slices"), (int, float)) and e["slices"]
        and isinstance(e.get("slices_complete"), (int, float))
    ]
    # Wall-time in each exit state: each interval between rounds is charged
    # to the EARLIER round's state.  Round-count availability misleads when
    # intervals vary (a slow workload-probe round should weigh its full
    # duration).  The FINAL round has no successor, but charging it zero
    # would hide exactly the outage that matters most — one still in
    # progress at the end of the log — so it is charged one median interval.
    import statistics

    state_seconds: dict = {}
    planned_outage_s = 0.0
    intervals = [b[0] - a[0] for a, b in zip(rounds, rounds[1:])]
    for (_, code, e), dt in zip(rounds, intervals):
        state_seconds[code] = state_seconds.get(code, 0.0) + dt
        if code != EXIT_OK and e.get("planned"):
            planned_outage_s += dt
    if intervals:
        _, final_code, final_e = rounds[-1]
        dt = statistics.median(intervals)
        state_seconds[final_code] = state_seconds.get(final_code, 0.0) + dt
        if final_code != EXIT_OK and final_e.get("planned"):
            planned_outage_s += dt
    occupancy_total = sum(state_seconds.values())
    # Dominant failure classes across ALL degraded rounds (not only
    # transitions): "what mostly took us down" is the first post-incident
    # question after "when".  Host/slice names are folded into classes so a
    # 64-host outage reads as one cause, and the NotReady kubelet reason is
    # kept — KubeletNotReady and NodeStatusUnknown are different incidents.
    cause_counts: dict = {}
    for _, code, e in rounds:
        if code == EXIT_OK:
            continue
        causes = e.get("causes") if isinstance(e.get("causes"), list) else []
        if code == EXIT_ERROR and not causes and e.get("error"):
            causes = ["monitor error"]
        for cls in {cls for c in causes if (cls := _cause_class(str(c)))}:
            cause_counts[cls] = cause_counts.get(cls, 0) + 1
    top_causes = [
        {"cause": cls, "rounds": n}
        for cls, n in sorted(cause_counts.items(), key=lambda kv: (-kv[1], kv[0]))[:5]
    ]
    cause_classes_total = len(cause_counts)
    summary = {
        "rounds": len(rounds),
        "skipped_lines": skipped,
        "window_s": round(rounds[-1][0] - rounds[0][0], 1),
        "availability_pct": round(100.0 * ok_rounds / len(rounds), 2),
        "time_weighted_availability_pct": (
            round(100.0 * state_seconds.get(EXIT_OK, 0.0) / occupancy_total, 2)
            if occupancy_total > 0
            else None
        ),
        "state_seconds": {str(k): round(v, 1) for k, v in sorted(state_seconds.items())},
        # Downtime fully explained by maintenance drains / scale-downs
        # (rounds logged planned=true), and availability with that time
        # excused — the SLO most fleets actually report against.
        "planned_outage_s": round(planned_outage_s, 1),
        "unplanned_availability_pct": (
            round(
                100.0
                * state_seconds.get(EXIT_OK, 0.0)
                / (occupancy_total - planned_outage_s),
                2,
            )
            if occupancy_total - planned_outage_s > 0
            else None
        ),
        "chip_availability_pct": (
            round(100.0 * sum(chip_ratios) / len(chip_ratios), 2)
            if chip_ratios
            else None
        ),
        "slice_availability_pct": (
            round(100.0 * sum(slice_ratios) / len(slice_ratios), 2)
            if slice_ratios
            else None
        ),
        "top_causes": top_causes,
        # Same no-silent-truncation rule as transitions_total: a capped
        # list must say what it dropped.
        "cause_classes_total": cause_classes_total,
        "transitions": transitions[-20:],
        "transitions_total": len(transitions),
        "longest_outage_s": round(longest_outage_s, 1),
        "last_exit_code": rounds[-1][1],
        "last_ts": round(rounds[-1][0], 3),
    }
    last_chronic = rounds[-1][2].get("chronic")
    if isinstance(last_chronic, list) and last_chronic:
        # --history rounds record standing chronic flappers even at exit 0;
        # the current set belongs in the post-incident picture (per-node
        # depth lives in --trend-nodes against the history store).
        summary["chronic_nodes"] = [str(n) for n in last_chronic]
    return summary, None, rounds, skipped


def trend_summary(path: str, json_mode: bool = False) -> int:
    """``--trend FILE``: summarize a ``--log-jsonl`` trend log.

    The post-incident questions the log exists to answer — when did the
    fleet degrade, for how long, how available was it — computed from the
    per-round entries: availability (fraction of rounds at exit 0), every
    state TRANSITION with its timestamp, the longest non-0 stretch, and
    chip-level availability (mean ready/total chips).  Malformed lines are
    skipped with a count via the same torn-line-tolerant loader the history
    store uses (a crash mid-append must not sink the analysis); an
    unreadable or empty log exits 1 — with a machine-readable summary on
    stdout in ``--json`` mode, never a traceback.
    """
    summary, reason, rounds, skipped = compute_trend_summary(path)
    if summary is None:
        print(f"trend log {path} {reason}", file=sys.stderr)
        if json_mode:
            # Automation reads stdout: an empty / whitespace-only /
            # unreadable log must still parse (rounds=0 plus the reason),
            # with exit 1 as the signal — not a bare stderr note.
            print(
                json.dumps(
                    {"rounds": 0, "skipped_lines": skipped, "error": reason},
                    ensure_ascii=False,
                )
            )
        return 1
    if json_mode:
        print(json.dumps(summary, ensure_ascii=False, indent=2))
        return 0
    import datetime

    def _fmt(ts: float) -> str:
        # UTC, explicitly marked: an incident timeline must read identically
        # from a pod and from an operator laptop in any timezone (ops
        # convention; the bench's provenance stamps already use gmtime).
        return datetime.datetime.fromtimestamp(
            ts, datetime.timezone.utc
        ).strftime("%Y-%m-%d %H:%M:%SZ")

    print(
        f"{len(rounds)} rounds over {summary['window_s']}s "
        f"({_fmt(rounds[0][0])} → {_fmt(rounds[-1][0])})"
        + (f", {skipped} malformed lines skipped" if skipped else "")
    )
    print(
        f"availability: {summary['availability_pct']}% of rounds at exit 0"
        + (
            f" ({summary['time_weighted_availability_pct']}% time-weighted)"
            if summary["time_weighted_availability_pct"] is not None
            else ""
        )
        + (
            f"; {summary['unplanned_availability_pct']}% excluding "
            f"{summary['planned_outage_s']}s planned maintenance"
            if summary["planned_outage_s"]
            and summary["unplanned_availability_pct"] is not None
            else ""
        )
        + (
            f"; chip availability {summary['chip_availability_pct']}%"
            if summary["chip_availability_pct"] is not None
            else ""
        )
        + (
            f"; slice availability {summary['slice_availability_pct']}%"
            if summary["slice_availability_pct"] is not None
            else ""
        )
    )
    transitions_total = summary["transitions_total"]
    top_causes = summary["top_causes"]
    print(
        f"state transitions: {transitions_total}; "
        f"longest outage {summary['longest_outage_s']}s; "
        f"current state: exit {summary['last_exit_code']}"
    )
    if summary.get("chronic_nodes"):
        print(
            "chronic flappers held in quarantine: "
            + ", ".join(summary["chronic_nodes"])
        )
    if top_causes:
        omitted = summary["cause_classes_total"] - len(top_causes)
        print(
            "top causes: "
            + "; ".join(f"{c['cause']} ×{c['rounds']}" for c in top_causes)
            + (f"; +{omitted} more classes" if omitted else "")
        )
    shown = summary["transitions"]  # one truncation rule for both surfaces
    if transitions_total > len(shown):
        print(f"  … {transitions_total - len(shown)} earlier transitions omitted")
    for t in shown:
        suffix = ""
        if t.get("causes"):
            suffix = "  (" + "; ".join(t["causes"]) + ")"
        print(f"  {_fmt(t['ts'])}  exit {t['from']} → {t['to']}{suffix}")
    return 0


def trend_nodes(path: str, json_mode: bool = False) -> int:
    """``--trend-nodes FILE``: per-node analysis of a ``--history`` store.

    The fleet questions the per-round trend log cannot answer — WHICH nodes
    are the problem: per-node availability (fraction of evidence rounds
    good), MTBF (mean seconds between failure onsets), MTTR (mean seconds
    from a failure onset to the next good round), flap counts, and current
    hysteresis state — with the worst offenders ranked first.  Chronic
    offenders with 95% availability are exactly the hardware MTBF/MTTR
    surfaces and a snapshot checker cannot.

    Same degradation contract as ``--trend``: torn/malformed lines are
    skipped with a count, an unreadable or empty store exits 1 (with a
    machine-readable object on stdout in ``--json`` mode).
    """
    from tpu_node_checker_torch.history.fsm import CHRONIC
    from tpu_node_checker_torch.history.store import (
        HISTORY_SCHEMA_VERSION,
        read_jsonl_tolerant,
    )

    def _empty(reason: str) -> int:
        print(f"history store {path} {reason}", file=sys.stderr)
        if json_mode:
            print(
                json.dumps(
                    {"nodes": {}, "skipped_lines": skipped, "error": reason},
                    ensure_ascii=False,
                )
            )
        return 1

    skipped = 0
    try:
        entries, skipped = read_jsonl_tolerant(path)
    except OSError as exc:
        return _empty(f"unreadable: {exc}")
    by_node: dict = {}
    for e in entries:
        schema = e.get("schema")
        node = e.get("node")
        if (schema is not None and schema != HISTORY_SCHEMA_VERSION) or not isinstance(
            node, str
        ) or not node:
            skipped += 1
            continue
        by_node.setdefault(node, []).append(e)
    if not by_node:
        return _empty("has no usable rounds")

    def _num(v):
        return v if isinstance(v, (int, float)) and not isinstance(v, bool) and math.isfinite(v) else None

    def _int(v):
        return v if isinstance(v, int) and not isinstance(v, bool) else None

    nodes: dict = {}
    for node, seq in sorted(by_node.items()):
        # Malformed-but-dict lines (a hand-edited "ts": "oops") must degrade
        # like torn lines, never crash the analysis: every read is coerced.
        seq.sort(key=lambda e: _num(e.get("ts")) or 0.0)
        evidence = [e for e in seq if isinstance(e.get("ok"), bool)]
        ok_rounds = sum(1 for e in evidence if e["ok"])
        # Failure onsets (good→bad edges, or a bad first round) and the
        # matching repairs (the next good round) — the MTBF/MTTR inputs.
        onsets: List[float] = []
        repairs: List[float] = []  # seconds from onset to recovery
        failing_since: Optional[float] = None
        for e in evidence:
            ts = _num(e.get("ts"))
            if ts is None:
                continue
            if not e["ok"] and failing_since is None:
                failing_since = ts
                onsets.append(ts)
            elif e["ok"] and failing_since is not None:
                repairs.append(ts - failing_since)
                failing_since = None
        last = seq[-1]
        cause_counts: dict = {}
        for e in evidence:
            for c in e.get("causes") or []:
                cause_counts[str(c)] = cause_counts.get(str(c), 0) + 1
        nodes[node] = {
            "rounds": len(evidence),
            "ok_rounds": ok_rounds,
            "availability_pct": (
                round(100.0 * ok_rounds / len(evidence), 2) if evidence else None
            ),
            "failures": len(onsets),
            "mtbf_s": (
                round(
                    (onsets[-1] - onsets[0]) / (len(onsets) - 1), 1
                )
                if len(onsets) >= 2
                else None
            ),
            "mttr_s": (
                round(sum(repairs) / len(repairs), 1) if repairs else None
            ),
            "state": last.get("state") if isinstance(last.get("state"), str) else None,
            "flaps": _int(last.get("flaps")),
            "flaps_total": _int(last.get("flaps_total")),
            "top_causes": [
                c
                for c, _ in sorted(
                    cause_counts.items(), key=lambda kv: (-kv[1], kv[0])
                )[:3]
            ],
        }
    # Worst first: lowest availability, then most flaps — the repair queue.
    worst = sorted(
        nodes,
        key=lambda n: (
            nodes[n]["availability_pct"]
            if nodes[n]["availability_pct"] is not None
            else 100.0,
            -(nodes[n]["flaps_total"] or 0),
            n,
        ),
    )
    summary = {
        "nodes": nodes,
        "worst_offenders": worst[:10],
        "chronic": sorted(n for n in nodes if nodes[n]["state"] == CHRONIC),
        "rounds_total": sum(v["rounds"] for v in nodes.values()),
        "skipped_lines": skipped,
    }
    if json_mode:
        print(json.dumps(summary, ensure_ascii=False, indent=2))
        return 0
    print(
        f"{len(nodes)} node(s), {summary['rounds_total']} evidence rounds"
        + (f", {skipped} malformed/foreign lines skipped" if skipped else "")
    )
    if summary["chronic"]:
        print("chronic flappers: " + ", ".join(summary["chronic"]))
    print()
    rows = []
    for n in worst:
        v = nodes[n]
        rows.append(
            [
                n,
                v["state"] or "?",
                f"{v['availability_pct']}%" if v["availability_pct"] is not None else "-",
                str(v["failures"]),
                f"{v['mtbf_s']}s" if v["mtbf_s"] is not None else "-",
                f"{v['mttr_s']}s" if v["mttr_s"] is not None else "-",
                str(v["flaps_total"] if v["flaps_total"] is not None else "-"),
                ", ".join(v["top_causes"]) or "-",
            ]
        )
    print(
        report.render_columns(
            ["NODE", "STATE", "AVAIL", "FAILS", "MTBF", "MTTR", "FLAPS", "TOP CAUSES"],
            rows,
        )
    )
    return 0
