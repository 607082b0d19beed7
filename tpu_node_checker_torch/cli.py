"""Command line of the PyTorch/CUDA checker: the fleet round over the live
node LIST or a NodeList file, once or in the aggregator's ``--watch`` loop,
and the node side (the emitter and its pod's modes).

::

    python -m tpu_node_checker_torch [--kubeconfig FILE] [--context NAME]
        [--label-selector SEL] [--retry-budget S] [--api-concurrency N]
        [--node-events] | --nodes-json FILE
        [--json] [--debug]
        [--trace FILE] [--strict-slices] [--resource-key KEY]...
        [--multislice-label KEY]... [--expected-chips [KEY=]N]
        [--cluster-name NAME] [--log-jsonl FILE]
        [--probe [--probe-level L] [--probe-timeout S] [--device cpu]
         [--probe-soak S] [--probe-topology DIMS] [--perf-floor F]
         [--probe-workload-model M] [--probe-distributed ...]]
        [--probe-results DIR [--probe-results-required]
         [--probe-results-max-age S]]
        [--history FILE [--history-max-rounds N] [--cordon-after K]
         [--uncordon-after M] [--flap-threshold F] [--flap-window W]
         [--analytics DIR]]
        [--slack-webhook URL] [--slack-username NAME] [--slack-only-on-error]
        [--slack-retry-count N] [--slack-retry-delay S]
        [--watch S [--watch-stream] [--slack-on-change] [--metrics-port PORT]
         [--event-log FILE]
         [--serve PORT [--serve-token TOKEN] [--serve-workers N] [--write-rps R]]]
        [--cordon-failed | --drain-failed [--no-drain-dry-run]] [--cordon-max N]
        [--cordon-degraded] [--uncordon-recovered] [--cordon-dry-run]
        [--disruption-budget N[/WINDOW]] [--slice-floor-pct PCT]
        [--disruption-lease URL] [--repair-cmd CMD | --repair-webhook URL
         [--no-repair-dry-run]]
    python -m tpu_node_checker_torch --serve PORT (--history FILE | --log-jsonl FILE)
        [--serve-token TOKEN] [--serve-workers N] [--write-rps R] [--event-log FILE]
    python -m tpu_node_checker_torch --federate ENDPOINTS_JSON --serve PORT
        [--federate-interval S] [--federate-workers N] [--federate-feed]
        [--fleet-disruption-budget N[/WINDOW]] [--serve-workers N]
        [--retry-budget S] [--event-log FILE] [--trace FILE]
    python -m tpu_node_checker_torch --trend FILE [--json]
    python -m tpu_node_checker_torch --trend-nodes FILE [--json]
    python -m tpu_node_checker_torch --emit-probe FILE|- \\
        [--probe-level {enumerate,compute,collective,mesh,workload}]
        [--probe-timeout S] [--device cpu] [--probe-soak S]
        [--probe-topology DIMS] [--perf-floor F] [--probe-workload-model M]
        [--watch S [--metrics-port PORT]] [--log-jsonl FILE] [--history FILE ...]
        [--probe-distributed --probe-coordinator HOST:PORT
         --probe-num-processes N --probe-process-id I
         [--probe-rendezvous-timeout S]]
    python -m tpu_node_checker_torch --selftest [--json] [--probe-timeout S] [--device cpu]
    python -m tpu_node_checker_torch --calibrate REPS [--probe-level L]
        [--calibrate-margin F] [--calibrate-out FILE] [--probe-timeout S]
        [--probe-soak S] [--probe-topology DIMS] [--device cpu]
    python -m tpu_node_checker_torch --report-fresh FILE [--probe-results-max-age S]
    python -m tpu_node_checker_torch --probe-report-schema
    python -m tpu_node_checker_torch --version
    python -m tpu_node_checker_torch simulate (--scenario NAME [--seed N]
        [--clusters K] [--nodes-per-cluster M] [--rounds R] | --list-scenarios
        | --fuzz [--seed N] [--seeds N] | --replay FILE) [--report {human,json}]

With no mode flag the one-shot round runs: it lists the cluster's nodes
(``--kubeconfig``, else ``$KUBECONFIG``, ``~/.kube/config`` or the pod's
service account), or reads them from ``--nodes-json``, and grades them;
with ``--node-events`` it attaches the recent Events of sick nodes, with
``--probe`` probes this host's card and attaches the verdict to its node
(``NODE_NAME``, else the hostname), with ``--probe-results`` attaches the
fleet's emitter reports, with ``--history`` debounces each node's verdict
through the hysteresis machine, and posts to Slack before it prints.
With ``--watch`` the round repeats every S seconds until SIGTERM (exit 143):
``--slack-on-change`` posts only when the outcome changes, a circuit breaker
widens the interval over consecutive failed rounds, ``--metrics-port``
serves the round's gauges and ``--event-log`` records the loop's events.
``--cordon-failed`` (or ``--drain-failed``, evict-then-cordon) quarantines
nodes whose probe failed, ``--uncordon-recovered`` lifts our quarantines
once they pass again, and the budget engine refuses what would pass
``--cordon-max``, ``--slice-floor-pct``, ``--disruption-budget`` or the
fleet lease (``--disruption-lease``); ``--repair-cmd`` or
``--repair-webhook`` fires once per condemned node.  ``--analytics`` keeps
roll-ups of the history stream and predicts flappers; ``--serve`` publishes
each round of the loop to the fleet state API (reads open, writes
``--serve-token``-gated and ``--write-rps``-limited, ``--serve-workers``
accept loops), or without ``--watch`` serves a store another process
records.  ``--watch-stream`` turns each round of the loop into a tick over a
node cache that one LIST seeds and a Kubernetes watch keeps current, so only
changed nodes are graded again.  ``--federate`` runs the aggregator over
many clusters' fleet state APIs (polled with conditional GETs, or with
``--federate-feed`` through their watch feeds), serves the merged
``/api/v1/global/*`` view, and with ``--fleet-disruption-budget`` grants the
fleet-wide disruption lease.  ``--trend`` summarizes
a ``--log-jsonl`` trend log and ``--trend-nodes`` a ``--history`` store.
``--emit-probe`` writes one report, or with ``--watch`` one every S seconds
until SIGTERM (exit 143), serving the round's gauges on ``--metrics-port``;
with ``--probe-distributed`` one emitter per host joins one rendezvous and
probes every host's cards as one rank group.  ``--selftest`` rehearses
every detector on this host (the emitter pod's initContainer), and
``--calibrate`` prints this host's healthy figures as ``TNC_PERF_EXPECT``
JSON, which ``--perf-floor`` grades against.  ``--report-fresh`` is the
emitter pod's liveness verdict on its report.  ``--probe-report-schema``
prints the report's JSON Schema.  ``simulate`` runs the seeded chaos
simulator (``sim/``) over these same fleet modules, with its own flags and
exit codes.  The flags keep the JAX checker's names,
defaults, meanings and usage errors, and every flag of the JAX checker is
accepted here; ``--device``, ``--probe-workload-model`` and the port's stricter
mode rules are its own.

Exit codes of the round: 0 when at least one accelerator node is
effectively Ready, 2 when there is none, 3 when none is Ready (or the
probe, ``--strict-slices`` or ``--expected-chips`` failed), 1 on an error
(``{"error": ...}`` on stdout under ``--json``).  Of the node side: 0 when
the report is healthy (or fresh, or the drill behaved, or the calibration
ran), 3 when it is not, 1 on an error.  2 is a usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import List, Optional

from tpu_node_checker_torch import __version__
from tpu_node_checker_torch.probe.floors import DEFAULT_CALIBRATION_MARGIN
from tpu_node_checker_torch.probe.levels import LEVELS, WORKLOAD_MODELS

EXIT_OK = 0
EXIT_ERROR = 1


def _expected_chips(raw: str):
    """``N`` or ``KEY=N`` → (key_or_None, n) for the capacity assertion."""
    key, sep, count = raw.rpartition("=")
    if sep and (not key or "=" in key or key != key.strip()):
        # '=8' / '==8' is a typo (or an empty $KEY interpolation), not the
        # unkeyed form.
        raise argparse.ArgumentTypeError(f"malformed resource key in {raw!r}")
    try:
        n = int(count)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer chip count, got {count!r}"
        )
    if n <= 0:
        raise argparse.ArgumentTypeError("chip count must be positive")
    return (key or None, n)


def build_parser() -> argparse.ArgumentParser:
    # No abbreviations: a flag is spelled whole, so a port-only flag
    # (--device) never makes a JAX spelling ambiguous.
    p = argparse.ArgumentParser(
        prog="python -m tpu_node_checker_torch",
        description="Check a Kubernetes NodeList for Ready accelerator nodes, probe "
        "this host's NVIDIA card(s), and write probe reports for the fleet "
        "checker's --probe-results. Exit codes of the round: 0 = at least one "
        "Ready accelerator node; 2 = no accelerator nodes; 3 = accelerator nodes "
        "exist but none Ready (or the probe / strict slice check failed); 1 = error.",
        allow_abbrev=False,
    )
    # The JAX checker's words: its prog is the console script's name.
    p.add_argument("--version", action="version", version=f"tpu-node-checker {__version__}")
    p.add_argument("--kubeconfig", help="path to kubeconfig (default: $KUBECONFIG, then ~/.kube/config, then in-cluster)")
    p.add_argument("--context", help="kubeconfig context to use (default: current-context)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON output (the round's payload, or "
                   "--selftest's document)")
    p.add_argument("--cluster-name", metavar="NAME",
                   help="this checker's cluster identity (or $TNC_CLUSTER_NAME; "
                   "default: the kubeconfig context, else the hostname), stamped "
                   "into every payload as the 'cluster' key")
    p.add_argument("--label-selector",
                   help="server-side node label selector for the LIST call "
                   "(e.g. 'cloud.google.com/gke-tpu-accelerator')")
    p.add_argument("--resource-key", action="append", metavar="KEY",
                   help="additional accelerator resource key or glob to detect (repeatable)")
    p.add_argument("--nodes-json", metavar="FILE",
                   help="read nodes from a JSON NodeList file instead of a live cluster "
                   "(offline mode for CI fixtures and demos)")
    p.add_argument("--strict-slices", action="store_true",
                   help="exit 3 if any multi-host TPU slice is incomplete")
    p.add_argument("--api-concurrency", type=int, default=None, metavar="N",
                   help="max concurrent Kubernetes API calls in the per-node "
                   "fan-out (--node-events fetches); each worker keeps its own "
                   "pooled keep-alive connection (default 4; 1 = serial)")
    p.add_argument("--retry-budget", type=float, default=None, metavar="SECONDS",
                   help="shared wall-clock budget for transparent API retries "
                   "per check round (default 15; 0 disables): transient "
                   "faults — connect refused/reset, socket timeout, HTTP "
                   "429/500/502/503/504 — retry with full-jitter exponential "
                   "backoff (Retry-After honored) until the budget or the "
                   "per-call attempt cap runs out; GETs retry freely, a "
                   "PATCH only when the request provably never left the "
                   "socket")
    p.add_argument("--node-events", action="store_true",
                   help="fetch recent k8s Events for sick nodes (the kubectl-"
                   "describe triage block: OOM kills, evictions, plugin crash "
                   "loops) into the JSON payload and Slack bullets; capped "
                   "fetches, needs 'events: list' RBAC, live cluster only")
    p.add_argument("--multislice-label", action="append", metavar="KEY",
                   help="node label key that groups slices into a DCN-joined "
                   "multislice (repeatable; checked before the built-in "
                   "cloud.google.com/gke-multislice-group convention)")
    p.add_argument("--expected-chips", type=_expected_chips, metavar="[KEY=]N",
                   help="exit 3 unless at least N chips are on Ready nodes "
                   "(cluster-level capacity assertion); KEY restricts the count to "
                   "one resource key or glob, e.g. 'nvidia.com/gpu=8' — without it "
                   "every accelerator family counts")
    p.add_argument("--debug", action="store_true", help="print phase timings")
    p.add_argument("--trace", metavar="FILE",
                   help="write a Chrome-trace-format timeline of the check's "
                   "phases to FILE (open in Perfetto / chrome://tracing); "
                   "with --watch or --federate the file is atomically "
                   "rewritten every round with that round's trace — the "
                   "same documents GET /api/v1/debug/rounds serves; with "
                   "--emit-probe, the probe round's trace, the probe "
                   "child's spans on a track of their own (rewritten "
                   "every round under --watch)")
    p.add_argument("--event-log", metavar="FILE",
                   help="append the unified structured event stream (fleet-"
                   "API write audits, shard degraded/recovered, breaker "
                   "open/close, FSM actionable transitions — one JSON line "
                   "each, stamped with trace_id and cluster) to FILE; events "
                   "always also go to stderr (requires --watch, --serve or "
                   "--federate: one-shot runs emit no events)")
    p.add_argument("--watch", type=float, metavar="SECONDS",
                   help="daemon mode: repeat the check every SECONDS, measured "
                   "from the start of a round, until SIGTERM (exit 143); with "
                   "--emit-probe, rewrite the report every SECONDS")
    p.add_argument("--watch-stream", dest="watch_stream", action="store_true",
                   default=False,
                   help="with --watch: replace per-round LISTs with a "
                   "Kubernetes watch stream — one LIST seeds a node cache, "
                   "ADDED/MODIFIED/DELETED events keep it current, each "
                   "round re-grades only changed nodes and delta-patches "
                   "the --serve snapshot; a 410/stream loss triggers one "
                   "clean relist through the normal retry ladder")
    p.add_argument("--no-watch-stream", dest="watch_stream", action="store_false",
                   help="force classic poll-and-relist rounds (the default; "
                   "overrides an earlier --watch-stream on the command line)")
    p.add_argument("--slack-on-change", action="store_true",
                   help="with --watch: notify only when the check outcome changes")
    p.add_argument("--metrics-port", type=int, metavar="PORT",
                   help="with --watch: serve Prometheus metrics on this port (0 = ephemeral)")
    p.add_argument("--log-jsonl", metavar="FILE",
                   help="append one JSON line per check round (or emitter round) to "
                   "FILE (trend log; the fleet checker's --trend reads it)")
    p.add_argument("--trend", metavar="FILE",
                   help="summarize a --log-jsonl trend log (availability — "
                   "time-weighted and excluding planned maintenance — state "
                   "transitions with their causes, longest outage) and exit "
                   "— post-incident analysis; runs alone")

    serve = p.add_argument_group("Fleet state API (queryable health over HTTP)")
    serve.add_argument("--serve", type=int, metavar="PORT",
                       help="serve the fleet state HTTP API on PORT (0 = "
                       "ephemeral): GET /api/v1/summary, /api/v1/nodes[/NAME], "
                       "/api/v1/slices, /api/v1/trend, plus /healthz, /readyz "
                       "and /metrics — every round publishes one immutable "
                       "pre-serialized snapshot (strong ETag + gzip), so "
                       "polls never re-encode JSON or race the check loop; "
                       "with --watch serves live rounds, standalone (with "
                       "--history and/or --log-jsonl) serves a store another "
                       "process writes")
    serve.add_argument("--serve-token", metavar="TOKEN",
                       help="bearer token (or $TNC_SERVE_TOKEN) gating the "
                       "API's write endpoints — POST /api/v1/nodes/NAME/"
                       "cordon|uncordon, evidence/FSM-gated with ?dry_run=1 "
                       "support, audit-logged; with no token configured every "
                       "write answers 403 (reads stay open)")
    serve.add_argument("--serve-workers", type=int, default=None, metavar="N",
                       help="with --serve: accept-loop workers sharing the "
                       "port via SO_REUSEPORT (default 1; falls back to a "
                       "single listener where the option is unavailable) — "
                       "hot read endpoints are answered from wire responses "
                       "prebuilt once per round, so read throughput scales "
                       "to tens of thousands of polls per second")
    serve.add_argument("--write-rps", type=float, default=None, metavar="RATE",
                       help="with --serve: token-bucket rate limit on the "
                       "authenticated cordon/uncordon write path — sustained "
                       "RATE requests/second (burst of the same size, "
                       "minimum 1); refusals answer 429 with a Retry-After "
                       "the caller's retry ladder can honor (default: "
                       "unlimited)")

    federate = p.add_argument_group(
        "Multi-cluster federation (a stateless aggregator over N checkers)"
    )
    federate.add_argument("--federate", metavar="ENDPOINTS_JSON",
                          help="aggregator mode (requires --serve): poll the "
                          "per-cluster fleet state APIs registered in "
                          "ENDPOINTS_JSON with conditional GETs (an "
                          "unchanged cluster costs one 304 per endpoint), "
                          "merge them into a global view keyed "
                          "cluster/node, and serve /api/v1/global/"
                          "{summary,clusters,clusters/NAME,nodes} — an "
                          "unreachable or stale cluster degrades only its "
                          "shard (staleness-labeled), never the fleet; the "
                          "file is re-read between rounds, so a ConfigMap "
                          "rollout adds/removes clusters live; runs no "
                          "check rounds of its own")
    federate.add_argument("--federate-interval", type=float, default=None,
                          metavar="SECONDS",
                          help="with --federate: seconds between fetch+merge "
                          "rounds (default 10)")
    federate.add_argument("--federate-workers", type=int, default=None,
                          metavar="N",
                          help="with --federate: fetcher threads the cluster "
                          "set is consistent-hash sharded across (default "
                          "4); assignments are stable under cluster churn, "
                          "so each worker's keep-alive connections stay "
                          "warm")
    federate.add_argument("--federate-feed", action="store_true",
                          help="with --federate: stream mode — consume each "
                          "upstream's GET /api/v1/watch push-delta feed "
                          "instead of re-polling unchanged state (a steady "
                          "round costs zero upstream requests, churn costs "
                          "one delta frame of only the changed entries); an "
                          "upstream without the feed (older build) silently "
                          "degrades to conditional-GET polling, and a dead "
                          "stream degrades only its shard")

    probe = p.add_argument_group("Card probe (data-plane liveness)")
    probe.add_argument("--probe", action="store_true",
                       help="probe this host's card(s) in a child process and "
                       "attach the verdict to this host's node (NODE_NAME, else the "
                       "hostname), expecting its allocatable device count")
    probe.add_argument("--probe-level", choices=LEVELS, default="enumerate",
                       help="enumerate, compute, collective, mesh or workload (each "
                       "includes the previous); collective and up run one rank per card")
    probe.add_argument("--probe-timeout", type=float, default=None, metavar="S",
                       help="kill the probe child after S seconds (default: the level's "
                       "budget, plus --probe-soak)")
    probe.add_argument("--device", default="cuda:0",  # tnc: allow-drift-readme-flags(port-only flag; the README table lists the JAX CLI's)
                       help="device to probe: cuda:0 (default) or cpu")
    # No default in the namespace: without the flag the parsed arguments,
    # and the probe's call, are the JAX checker's.
    probe.add_argument("--probe-workload-model", choices=WORKLOAD_MODELS,  # tnc: allow-drift-readme-flags(port-only flag; the README table lists the JAX CLI's)
                       default=argparse.SUPPRESS,
                       help="the model the workload level trains: burnin (default), or "
                       "deepseek-v2-lite, DeepSeek-V2-Lite's training step at one card's "
                       "share of an 8-way expert-parallel layout, on card 0 alone however "
                       "many cards the host has")
    probe.add_argument("--emit-probe", metavar="FILE",
                       help="write the probe report to FILE atomically ('-' for stdout)")
    probe.add_argument("--probe-results", metavar="DIR",
                       help="attach per-host probe reports (written by --emit-probe on "
                       "each host) from DIR to the matching nodes")
    probe.add_argument("--report-fresh", metavar="FILE",
                       help="exit 0 iff FILE is a readable probe report whose "
                       "written_at is younger than --probe-results-max-age, else 1 "
                       "(the emitter pod's livenessProbe); runs alone")
    probe.add_argument("--probe-report-schema", action="store_true",
                       help="print the probe report's JSON Schema (draft 2020-12) "
                       "and exit; runs alone")
    probe.add_argument("--selftest", action="store_true",
                       help="rehearse the fault-detection pipeline on this host: a clean "
                       "baseline probe, then one injected fault per detector class (perf "
                       "throttle, collective leg, link, slice boundary), each verified to "
                       "be caught AND correctly named; exit 0 = drill passed, 3 = a "
                       "detector missed — runs alone")
    probe.add_argument("--calibrate", type=int, default=None, metavar="REPS",
                       help="measure this host's healthy perf expectations: run the probe "
                       "REPS times at --probe-level (compute or higher), print the "
                       "margin-adjusted per-metric medians as TNC_PERF_EXPECT JSON on "
                       "stdout, which --perf-floor grades against on cards the built-in "
                       "table lacks (the H100); any failed rep aborts (never calibrate a "
                       "sick host) — runs alone")
    probe.add_argument("--calibrate-margin", type=float, default=None, metavar="FRACTION",
                       help="with --calibrate: expectation = FRACTION x median, keeping "
                       "headroom under the healthy median so run-to-run jitter never "
                       "sits above 'expected' (default 0.9)")
    probe.add_argument("--calibrate-out", metavar="FILE",
                       help="with --calibrate: write the JSON to FILE (atomic) instead "
                       "of stdout")
    probe.add_argument("--probe-results-max-age", type=float, default=900.0,
                       metavar="SECONDS",
                       help="ignore probe reports older than this (default 900s) so a "
                       "wedged emitter can't keep vouching for dead cards; with "
                       "--report-fresh, the report's greatest age")
    probe.add_argument("--probe-results-required", action="store_true",
                       help="with --probe-results: grade any TPU node WITHOUT a fresh "
                       "report as probe-failed (full DaemonSet coverage expected)")
    probe.add_argument("--probe-soak", type=float, default=0.0, metavar="SECONDS",
                       help="node-acceptance soak: at compute level and above, loop the "
                       "matmul burn under sustained load for this long; fails on "
                       "numerics errors or throughput collapse (probe timeout extends "
                       "to fit)")
    probe.add_argument("--probe-topology", metavar="DIMS",
                       help="torus label of the host's cards (e.g. 2x2); at collective "
                       "level and above, one all_reduce per axis so a fault names its "
                       "axis")
    probe.add_argument("--probe-distributed", action="store_true",
                       help="join the rendezvous of one probe process per host before "
                       "enumerating, so the probe sees every host's cards, verifies a "
                       "cross-process psum, and its collectives cross hosts")
    probe.add_argument("--probe-coordinator", metavar="HOST:PORT",
                       help="with --probe-distributed: the rendezvous coordinator, where "
                       "process 0 hosts the store")
    probe.add_argument("--probe-num-processes", type=int, metavar="N",
                       help="with --probe-distributed: total process count in the "
                       "rendezvous")
    probe.add_argument("--probe-process-id", type=int, metavar="I",
                       help="with --probe-distributed: this process's rank")
    probe.add_argument("--probe-rendezvous-timeout", type=float, default=None,
                       metavar="SECONDS",
                       help="with --probe-distributed: bound the rendezvous itself so "
                       "an unreachable coordinator or a missing peer reports a "
                       "structured error (default 60s)")
    probe.add_argument("--perf-floor", type=float, default=None, metavar="FRACTION",
                       help="at compute level and above, grade the measured figures "
                       "against this fraction of the device kind's expected figures "
                       "(default 0.4; 0 disables); $TNC_PERF_EXPECT (JSON {metric: "
                       "expected}) gives the expectations where the built-in table "
                       "has none, as for the H100")

    history = p.add_argument_group("Health history & hysteresis (flap-proof quarantine)")
    history.add_argument("--history", metavar="FILE",
                         help="persist per-node health history to FILE "
                         "(schema-versioned append-only JSONL, bounded, compacted in "
                         "place) and grade each node through a hysteresis state "
                         "machine (HEALTHY→SUSPECT→FAILED→RECOVERING, plus a CHRONIC "
                         "flap trap) instead of one round's snapshot; works in the "
                         "one-shot round and in --emit-probe mode")
    history.add_argument("--history-max-rounds", type=int, default=None, metavar="N",
                         help="with --history: per-node rounds kept in the store "
                         "(default 64); older lines are dropped at the next atomic "
                         "compaction")
    history.add_argument("--cordon-after", type=int, default=None, metavar="K",
                         help="with --history: consecutive bad rounds before a node is "
                         "FAILED (default 1 = the per-round behavior)")
    history.add_argument("--uncordon-after", type=int, default=None, metavar="M",
                         help="with --history: consecutive good rounds before a "
                         "RECOVERING node re-earns HEALTHY (default 1)")
    history.add_argument("--flap-threshold", type=int, default=None, metavar="F",
                         help="with --history: verdict flips inside the flap window "
                         "that mark a node CHRONIC — its own Slack line and trend "
                         "cause (default 4)")
    history.add_argument("--flap-window", type=int, default=None, metavar="W",
                         help="with --history: sliding window (rounds) the flap "
                         "detector counts flips over (default 10)")
    history.add_argument("--analytics", metavar="DIR",
                         help="with --history: maintain the fleet "
                         "analytics tier in DIR — the per-node verdict "
                         "stream is downsampled into 1m/15m/6h roll-up "
                         "buckets sharded across per-shard segment files "
                         "(append-only, atomically compacted; the raw "
                         "history JSONL stays authoritative), SLO/"
                         "offender/flap-rate queries are served from "
                         "GET /api/v1/analytics/{slo,offenders,flaps} "
                         "under --serve, and an online CUSUM changepoint "
                         "detector promotes flappers to SUSPECT before "
                         "the FSM sees a hard failure (predictions feed "
                         "the remediation budget view)")
    history.add_argument("--trend-nodes", metavar="FILE",
                         help="summarize a --history store per node: "
                         "availability, MTBF/MTTR, flap counts, current "
                         "hysteresis state, worst offenders first — and exit "
                         "(post-incident analysis; runs alone)")

    cordon = p.add_argument_group("Auto-quarantine (data-plane failures)")
    cordon.add_argument("--cordon-failed", action="store_true",
                        help="mark kubelet-Ready nodes whose chip probe FAILED as "
                        "unschedulable (kubectl-cordon PATCH; needs the 'patch' "
                        "verb on nodes — see deploy/rbac.yaml)")
    cordon.add_argument("--cordon-max", type=int, default=None, metavar="N",
                        help="budget on TOTAL cordoned accelerator nodes (default "
                        "1): nodes already cordoned — by this tool or anyone — "
                        "count against it, so a fleet-wide regression under "
                        "--watch converges at N instead of draining the pool; "
                        "raise deliberately for mass-repair workflows")
    cordon.add_argument("--cordon-degraded", action="store_true",
                        help="also quarantine nodes whose chips PASS but whose "
                        "mesh link sweep (--probe-level mesh) graded an ICI "
                        "link SLOW this round — a capacity-quality drain, "
                        "never fed through the FSM condemnation ladder; "
                        "rides the same budget rails (--cordon-max, slice "
                        "floors, disruption budget/lease) as --cordon-failed")
    cordon.add_argument("--cordon-dry-run", action="store_true",
                        help="report cordon/uncordon decisions without patching anything")
    cordon.add_argument("--uncordon-recovered", action="store_true",
                        help="lift THIS TOOL'S quarantines (cordons carrying the "
                        "tpu-node-checker.io/quarantined annotation) once the node "
                        "is Ready with a fresh passing chip probe; human cordons "
                        "are never touched")

    remediation = p.add_argument_group(
        "Remediation & disruption budgets (slice-aware actuation limits)"
    )
    remediation.add_argument("--slice-floor-pct", type=float, default=None,
                             metavar="PCT",
                             help="refuse any cordon/drain that would take a "
                             "failure domain (a multi-host TPU slice, keyed "
                             "like the grading's slice grouping) below PCT%% "
                             "of its expected healthy chips — even when each "
                             "node individually looks expendable (default 90 "
                             "once any remediation flag engages the budget "
                             "engine; single-host domains are exempt); "
                             "requires --cordon-failed or --drain-failed")
    remediation.add_argument("--disruption-budget", metavar="N[/WINDOW]",
                             help="cap disruptive actuations (cordon, drain, "
                             "repair) at N per round, or N per sliding "
                             "WINDOW (30s/10m/1h/1d) across rounds; refused "
                             "actuations surface as audit events, "
                             "remediation_denied_total samples and deduped "
                             "Slack lines — a mass-failure storm degrades "
                             "into bounded actuation plus visible refusals, "
                             "never a self-inflicted capacity drain; "
                             "requires --cordon-failed or --drain-failed")
    remediation.add_argument("--drain-failed", action="store_true",
                             help="drain (evict-then-cordon) condemned nodes "
                             "instead of bare-cordoning them: pods are "
                             "evicted through the Eviction API so "
                             "PodDisruptionBudgets get their vote (a PDB "
                             "refusal is a budget denial, reason=pdb, never "
                             "an error), then the node is cordoned; same "
                             "evidence rules as --cordon-failed (which it "
                             "replaces — the two are mutually exclusive); "
                             "DRY-RUN BY DEFAULT")
    remediation.add_argument("--drain-dry-run", dest="drain_dry_run",
                             action="store_true", default=True,
                             help="with --drain-failed: report the eviction "
                             "list and grace accounting without evicting "
                             "anything (THE DEFAULT — --no-drain-dry-run "
                             "opts into real evictions)")
    remediation.add_argument("--no-drain-dry-run", dest="drain_dry_run",
                             action="store_false",
                             help="with --drain-failed: actually evict and "
                             "cordon (overrides the default dry-run)")
    remediation.add_argument("--repair-cmd", metavar="CMD",
                             help="fire CMD (through the shell; TNC_NODE/"
                             "TNC_DOMAIN/TNC_REASON/TNC_TRACE_ID in the "
                             "environment) once per node the FSM condemns "
                             "(FAILED/CHRONIC) while it sits in our "
                             "quarantine; per-node repair state rides the "
                             "--history store so a restart never "
                             "double-fires; each firing charges the "
                             "disruption budget; DRY-RUN BY DEFAULT; "
                             "requires --history and an actuator flag")
    remediation.add_argument("--repair-webhook", metavar="URL",
                             help="like --repair-cmd but POST the repair "
                             "facts ({node, domain, reason, trace_id}) as "
                             "JSON to URL (mutually exclusive with "
                             "--repair-cmd)")
    remediation.add_argument("--repair-dry-run", dest="repair_dry_run",
                             action="store_true", default=True,
                             help="with --repair-cmd/--repair-webhook: log "
                             "which repairs would fire without firing them "
                             "(THE DEFAULT — --no-repair-dry-run opts in)")
    remediation.add_argument("--no-repair-dry-run", dest="repair_dry_run",
                             action="store_false",
                             help="with --repair-cmd/--repair-webhook: "
                             "actually fire the hooks")
    remediation.add_argument("--disruption-lease", metavar="URL",
                             help="borrow each actuation from the federation "
                             "aggregator's fleet disruption budget first "
                             "(POST URL/api/v1/global/disruption-lease): a "
                             "lease denial is a local refusal; an "
                             "unreachable aggregator falls back to the "
                             "LOCAL budget, additionally bounded by the "
                             "fleet allowance last leased — degrading "
                             "toward less actuation, never more; requires "
                             "--cordon-failed or --drain-failed")
    remediation.add_argument("--fleet-disruption-budget", metavar="N[/WINDOW]",
                             help="with --federate: the fleet-wide actuation "
                             "budget the aggregator grants disruption "
                             "leases against (N per merge round, or N per "
                             "sliding WINDOW); without it the lease "
                             "endpoint answers 404 and checkers fall back "
                             "to their local budgets")

    slack = p.add_argument_group("Slack")
    slack.add_argument("--slack-webhook", help="Slack incoming-webhook URL (or $SLACK_WEBHOOK_URL)")
    slack.add_argument("--slack-username", default="tpu-node-checker")
    slack.add_argument("--slack-only-on-error", action="store_true",
                       help="notify only when the check outcome is non-zero: no "
                       "accelerator nodes, none effectively Ready, a failed probe, "
                       "an incomplete slice under --strict-slices, or an "
                       "--expected-chips shortfall")
    slack.add_argument("--slack-retry-count", type=int, default=3,
                       help="delivery retries on connection-reset errors (default 3)")
    slack.add_argument("--slack-retry-delay", type=float, default=30.0,
                       help="seconds between Slack delivery retries (default 30)")
    return p


# Flags that mean something only in the one-shot round: beside another mode
# they would silently do nothing.
_ROUND_FLAGS = (
    ("--kubeconfig", "kubeconfig"), ("--context", "context"),
    ("--label-selector", "label_selector"), ("--api-concurrency", "api_concurrency"),
    ("--retry-budget", "retry_budget"), ("--node-events", "node_events"),
    ("--nodes-json", "nodes_json"), ("--probe", "probe"),
    ("--probe-results", "probe_results"), ("--strict-slices", "strict_slices"),
    ("--resource-key", "resource_key"), ("--multislice-label", "multislice_label"),
    ("--expected-chips", "expected_chips"), ("--cluster-name", "cluster_name"),
    ("--debug", "debug"), ("--trace", "trace"), ("--slack-username", "slack_username"),
    ("--slack-retry-count", "slack_retry_count"),
    ("--slack-retry-delay", "slack_retry_delay"),
)
# Flags of the probe: in the one-shot round they need --probe.
_PROBE_FLAGS = (
    ("--probe-level", "probe_level"), ("--probe-timeout", "probe_timeout"),
    ("--device", "device"), ("--probe-topology", "probe_topology"),
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)

    def given(dest: str) -> bool:
        return getattr(args, dest) != p.get_default(dest)

    if args.probe_report_schema and any(
        v != p.get_default(k) for k, v in vars(args).items() if k != "probe_report_schema"
    ):
        # Pure-output mode: anything riding along would silently not run.
        p.error("--probe-report-schema runs alone")
    if args.watch is not None and args.watch <= 0:
        p.error("--watch interval must be a positive number of seconds")
    if args.api_concurrency is not None and args.api_concurrency < 1:
        p.error("--api-concurrency must be at least 1 (1 = serial)")
    if args.retry_budget is not None and args.retry_budget < 0:
        p.error("--retry-budget must be >= 0 (0 disables retries)")
    if args.metrics_port is not None and args.watch is None:
        p.error("--metrics-port requires --watch (one-shot runs serve no scrapes)")
    if args.watch_stream:
        if args.watch is None:
            p.error("--watch-stream requires --watch (one-shot runs have no "
                    "stream to hold open)")
        if args.nodes_json:
            p.error("--watch-stream requires a live API server "
                    "(--nodes-json is an offline node source)")
        if args.emit_probe:
            # The emitter's loop re-probes this host on a cadence: there is
            # no node LIST to stream.
            p.error("--watch-stream cannot be combined with --emit-probe "
                    "(the emitter loop watches a chip, not the node list)")
        for flag, val in (
            ("--probe", args.probe),
            ("--probe-results", args.probe_results),
            ("--node-events", args.node_events),
        ):
            if val:
                # These gather evidence outside the node-object stream,
                # which the incremental tick does not re-poll: accepting
                # them would grade on stale probe or event data.
                p.error(f"{flag} is not supported with --watch-stream yet "
                        "(use poll-mode --watch)")
    if args.serve_token and args.serve is None:
        p.error("--serve-token requires --serve")
    if args.serve_workers is not None:
        if args.serve is None:
            p.error("--serve-workers requires --serve")
        if args.serve_workers < 1:
            p.error("--serve-workers must be at least 1")
    if args.write_rps is not None:
        if args.serve is None:
            p.error("--write-rps requires --serve")
        if args.write_rps <= 0:
            p.error("--write-rps must be positive (omit the flag for "
                    "unlimited writes)")
    if args.federate:
        if args.serve is None:
            p.error("--federate requires --serve PORT (serving the merged "
                    "global view is the aggregator's whole job)")
        if args.federate_interval is not None and args.federate_interval <= 0:
            p.error("--federate-interval must be a positive number of seconds")
        if args.federate_workers is not None and args.federate_workers < 1:
            p.error("--federate-workers must be at least 1")
        for flag, on in (
            # The aggregator runs no check rounds and talks to no
            # apiserver, and its write path is off: each of these would
            # silently do nothing.
            ("--watch", args.watch is not None),
            ("--kubeconfig", args.kubeconfig),
            ("--context", args.context),
            ("--cluster-name", args.cluster_name),
            ("--nodes-json", args.nodes_json),
            ("--label-selector", args.label_selector),
            ("--resource-key", args.resource_key),
            ("--multislice-label", args.multislice_label),
            ("--strict-slices", args.strict_slices),
            ("--expected-chips", args.expected_chips),
            ("--node-events", args.node_events),
            ("--api-concurrency", args.api_concurrency is not None),
            ("--probe", args.probe),
            ("--emit-probe", args.emit_probe),
            ("--probe-results", args.probe_results),
            ("--report-fresh", args.report_fresh),
            ("--selftest", args.selftest),
            ("--calibrate", args.calibrate is not None),
            ("--history", args.history),
            ("--analytics", args.analytics),
            ("--trend", args.trend),
            ("--trend-nodes", args.trend_nodes),
            ("--log-jsonl", args.log_jsonl),
            ("--metrics-port", args.metrics_port is not None),
            ("--slack-webhook", args.slack_webhook),
            ("--slack-only-on-error", args.slack_only_on_error),
            ("--slack-on-change", args.slack_on_change),
            ("--cordon-failed", args.cordon_failed),
            ("--cordon-degraded", args.cordon_degraded),
            ("--uncordon-recovered", args.uncordon_recovered),
            ("--cordon-max", args.cordon_max is not None),
            ("--cordon-dry-run", args.cordon_dry_run),
            ("--drain-failed", args.drain_failed),
            ("--repair-cmd", args.repair_cmd),
            ("--repair-webhook", args.repair_webhook),
            ("--disruption-budget", args.disruption_budget),
            ("--disruption-lease", args.disruption_lease),
            ("--slice-floor-pct", args.slice_floor_pct is not None),
            ("--serve-token", args.serve_token),
            ("--write-rps", args.write_rps is not None),
            ("--json", args.json),
            ("--debug", args.debug),
        ):
            if on:
                p.error(
                    f"--federate runs no check rounds (and serves no write "
                    f"path): {flag} would silently do nothing"
                )
    else:
        for flag, val in (
            ("--federate-interval", args.federate_interval),
            ("--federate-workers", args.federate_workers),
            ("--federate-feed", args.federate_feed or None),
        ):
            if val is not None:
                p.error(f"{flag} requires --federate")
    if args.slack_on_change and args.watch is None:
        p.error("--slack-on-change requires --watch")
    if args.event_log and (
        args.watch is None and args.serve is None and args.federate is None
    ):
        # One-shot runs emit no events (breaker/FSM/audit lines are
        # daemon-mode surfaces).
        p.error(
            "--event-log records daemon-mode events: it requires --watch, "
            "--serve or --federate"
        )
    if args.probe_results_required and not args.probe_results:
        p.error("--probe-results-required requires --probe-results DIR")
    if args.trend and (
        args.emit_probe
        or args.node_events
        or args.probe
        or args.watch is not None
        or args.probe_results
        or args.cordon_failed
        or args.cordon_degraded
        or args.uncordon_recovered
        or args.report_fresh
        or args.log_jsonl
        or args.slack_webhook
        or args.slack_only_on_error
        or args.strict_slices
        or args.expected_chips
        or args.history
        or args.trend_nodes
        or args.serve is not None
    ):
        # A summary-only mode must not absorb check/emit/notify/quarantine
        # flags the operator thinks ran.
        p.error("--trend runs alone (only --json may accompany it)")
    if args.trend_nodes and (
        args.emit_probe
        or args.node_events
        or args.probe
        or args.watch is not None
        or args.probe_results
        or args.cordon_failed
        or args.cordon_degraded
        or args.uncordon_recovered
        or args.report_fresh
        or args.log_jsonl
        or args.slack_webhook
        or args.slack_only_on_error
        or args.strict_slices
        or args.expected_chips
        or args.history
        or args.serve is not None
    ):
        p.error("--trend-nodes runs alone (only --json may accompany it)")
    for flag, val in (
        ("--analytics", args.analytics),
        ("--history-max-rounds", args.history_max_rounds),
        ("--cordon-after", args.cordon_after),
        ("--uncordon-after", args.uncordon_after),
        ("--flap-threshold", args.flap_threshold),
        ("--flap-window", args.flap_window),
    ):
        if val is not None and not args.history:
            # Hysteresis knobs without the store would silently grade
            # per-round: the operator thinks debouncing is on.
            p.error(f"{flag} requires --history FILE")
    if args.history_max_rounds is not None and args.history_max_rounds < 1:
        p.error("--history-max-rounds must be at least 1")
    for flag, val in (
        ("--cordon-after", args.cordon_after),
        ("--uncordon-after", args.uncordon_after),
    ):
        if val is not None and val < 1:
            p.error(f"{flag} must be at least 1")
    for flag, val in (
        ("--flap-threshold", args.flap_threshold),
        ("--flap-window", args.flap_window),
    ):
        if val is not None and val < 2:
            # One flip is any single failure; a window of one can hold no
            # flip at all: both would disable the detector silently.
            p.error(f"{flag} must be at least 2")
    if args.history:
        # A store bound smaller than the flap window could never hold
        # enough verdicts to trip the detector after a restart.
        from tpu_node_checker_torch.history.fsm import DEFAULT_FLAP_WINDOW
        from tpu_node_checker_torch.history.store import DEFAULT_MAX_ROUNDS

        window = args.flap_window or DEFAULT_FLAP_WINDOW
        if window > (args.history_max_rounds or DEFAULT_MAX_ROUNDS):
            p.error(
                "--flap-window cannot exceed --history-max-rounds (a "
                "restarted checker reseeds from the store, which could "
                "never hold enough rounds to trip the detector)"
            )
    if args.selftest and (
        args.emit_probe
        or args.node_events
        or args.probe
        or args.watch is not None
        or args.probe_results
        or args.cordon_failed
        or args.cordon_degraded
        or args.uncordon_recovered
        or args.report_fresh
        or args.trend
        or args.trend_nodes
        or args.history
        or args.calibrate is not None
        or args.slack_webhook
        or args.log_jsonl
        or args.nodes_json
        or args.label_selector
        or args.resource_key
        or args.strict_slices
        or args.expected_chips
        or args.multislice_label
        or args.probe_topology
        or args.probe_level != "enumerate"
        or args.trace
        or args.serve is not None
    ):
        # A drill-only mode must not absorb flags the operator thinks ran.
        p.error("--selftest runs alone (only --json and --probe-timeout "
                "may accompany it)")
    if args.calibrate is not None:
        if (
            args.emit_probe
            or args.node_events
            or args.probe
            or args.watch is not None
            or args.probe_results
            or args.cordon_failed
            or args.cordon_degraded
            or args.uncordon_recovered
            or args.report_fresh
            or args.trend
            or args.trend_nodes
            or args.history
            or args.slack_webhook
            or args.slack_only_on_error
            or args.log_jsonl
            or args.nodes_json
            or args.label_selector
            or args.resource_key
            or args.strict_slices
            or args.expected_chips
            or args.multislice_label
            or args.json
            or args.trace
            or args.perf_floor is not None
            or args.serve is not None
        ):
            # Calibration's stdout is the TNC_PERF_EXPECT JSON (command
            # substitution is its consumer); anything else riding along would
            # pollute it or silently not run.
            p.error("--calibrate runs alone (only --probe-level/"
                    "--probe-timeout/--probe-soak/--probe-topology and "
                    "--calibrate-margin/--calibrate-out may accompany it)")
        if args.calibrate < 1:
            p.error("--calibrate needs at least 1 rep")
        if args.probe_level == "enumerate":
            p.error("--calibrate requires --probe-level compute (or higher)")
        if args.calibrate_margin is None:
            args.calibrate_margin = DEFAULT_CALIBRATION_MARGIN
        if not 0 < args.calibrate_margin <= 1:
            p.error("--calibrate-margin must be in (0, 1]")
    else:
        if args.calibrate_out:
            p.error("--calibrate-out requires --calibrate")
        if args.calibrate_margin is not None:
            p.error("--calibrate-margin requires --calibrate")
    if args.report_fresh and (
        args.emit_probe
        or args.node_events
        or args.probe
        or args.watch is not None
        or args.probe_results
        or args.cordon_failed
        or args.cordon_degraded
        or args.uncordon_recovered
        or args.history
        or args.trend_nodes
        or args.serve is not None
    ):
        # JAX's rule and words first; the port's wider rule below.
        p.error(
            "--report-fresh runs alone (no --emit-probe/--probe/--watch/"
            "--probe-results/--cordon-failed/--uncordon-recovered)"
        )
    if args.report_fresh and any(
        v != p.get_default(k) for k, v in vars(args).items()
        if k not in ("report_fresh", "probe_results_max_age")
    ):
        # A liveness verdict stays a liveness verdict: an emission, round or
        # probe flag beside it would silently do nothing.
        p.error(
            "--report-fresh runs alone (no --emit-probe/--watch/--log-jsonl/"
            "--probe-level/--probe-timeout/--probe-soak/--probe-topology/"
            "--perf-floor/--device)"
        )
    # Remediation and disruption budgets: every budget knob needs an
    # actuator it can gate, every hook needs the state that stops it firing
    # twice.
    if args.cordon_failed and args.drain_failed:
        p.error("--drain-failed replaces --cordon-failed (evict-then-cordon "
                "instead of a bare PATCH) — pass one, not both")
    from tpu_node_checker_torch.remediation.budget import parse_disruption_budget

    for flag, raw in (
        ("--disruption-budget", args.disruption_budget),
        ("--fleet-disruption-budget", args.fleet_disruption_budget),
    ):
        if raw is not None:
            try:
                parse_disruption_budget(raw)
            except ValueError as exc:
                p.error(f"{flag}: {exc}")
    if args.slice_floor_pct is not None and not (
        0 < args.slice_floor_pct <= 100
    ):
        p.error("--slice-floor-pct must be in (0, 100]")
    actuator = args.cordon_failed or args.drain_failed or args.cordon_degraded
    for flag, on in (
        ("--slice-floor-pct", args.slice_floor_pct is not None),
        ("--disruption-budget", args.disruption_budget),
        ("--disruption-lease", args.disruption_lease),
    ):
        if on and not actuator:
            p.error(f"{flag} requires --cordon-failed or --drain-failed "
                    "(a budget with no actuator gates nothing)")
    if args.repair_cmd and args.repair_webhook:
        p.error("--repair-cmd and --repair-webhook are mutually exclusive "
                "(one repair channel per checker)")
    if args.repair_cmd or args.repair_webhook:
        if not args.history:
            p.error("--repair-cmd/--repair-webhook require --history FILE "
                    "(repair state rides the store so a restart never "
                    "double-fires)")
        if not actuator:
            p.error("--repair-cmd/--repair-webhook require --cordon-failed "
                    "or --drain-failed (repairs fire on quarantined nodes)")
    if not args.drain_dry_run and not args.drain_failed:
        # Arming real evictions with no drain sweep would let an operator
        # believe draining is live.
        p.error("--no-drain-dry-run requires --drain-failed")
    if not args.repair_dry_run and not (args.repair_cmd or args.repair_webhook):
        p.error("--no-repair-dry-run requires --repair-cmd or "
                "--repair-webhook")
    if args.fleet_disruption_budget and not args.federate:
        p.error("--fleet-disruption-budget requires --federate (the fleet "
                "budget lives on the aggregator tier)")
    if args.cordon_degraded and args.probe and args.probe_level not in (
        "mesh", "workload"
    ):
        # The degraded sweep's only evidence is the mesh link sweep's
        # verdict; below the mesh level the sweep could never fire.
        p.error("--cordon-degraded with --probe requires --probe-level "
                "mesh (or workload): lower levels never run the mesh "
                "link sweep")
    for flag, on in (
        ("--cordon-failed", args.cordon_failed),
        ("--cordon-degraded", args.cordon_degraded),
        ("--drain-failed", args.drain_failed),
        ("--uncordon-recovered", args.uncordon_recovered),
    ):
        if on and not (args.probe or args.probe_results):
            # Each keys off a data-plane verdict; without a probe source
            # the flag could never act.
            p.error(f"{flag} requires --probe or --probe-results DIR")
        if on and args.emit_probe:
            p.error(f"{flag} cannot be combined with --emit-probe")
    if args.emit_probe:
        for flag, on in (
            # The emitter loop runs no fleet rounds: nothing to repair,
            # budget, roll up or predict over.
            ("--analytics", args.analytics),
            ("--repair-cmd", args.repair_cmd),
            ("--repair-webhook", args.repair_webhook),
            ("--disruption-budget", args.disruption_budget),
            ("--disruption-lease", args.disruption_lease),
            ("--slice-floor-pct", args.slice_floor_pct is not None),
            ("--fleet-disruption-budget", args.fleet_disruption_budget),
        ):
            if on:
                p.error(f"{flag} cannot be combined with --emit-probe")
    if args.emit_probe:
        for flag, on in (
            ("--slack-webhook", args.slack_webhook),
            ("--slack-only-on-error", args.slack_only_on_error),
            ("--slack-on-change", args.slack_on_change),
            # The emitter loop runs no round engine: no breaker/FSM events
            # exist to log.
            ("--event-log", args.event_log),
        ):
            if on:
                # Emitters never notify: Slack is the aggregator's job.
                p.error(f"{flag} cannot be combined with --emit-probe")
    if args.node_events:
        if args.nodes_json:
            # Offline fixtures have no event stream; silently fetching
            # nothing would let an operator believe triage ran.
            p.error("--node-events requires a live cluster (not --nodes-json)")
        if args.emit_probe:
            p.error("--node-events cannot be combined with --emit-probe")
    if args.cordon_max is not None and args.cordon_max < 1:
        p.error("--cordon-max must be at least 1")
    if args.cordon_max is not None and not (
        args.cordon_failed or args.cordon_degraded or args.drain_failed
        or args.serve is not None
    ):
        # --serve counts too: the fleet API's cordon endpoint shares the
        # same total-cordoned-state budget as the sweep.
        p.error("--cordon-max requires --cordon-failed, --drain-failed "
                "or --serve")
    if args.cordon_dry_run and not (
        args.cordon_failed or args.cordon_degraded or args.uncordon_recovered
    ):
        p.error("--cordon-dry-run requires --cordon-failed or --uncordon-recovered")
    if args.cordon_max is None:
        args.cordon_max = 1
    if args.probe_distributed and not (args.probe or args.emit_probe):
        # A probe modifier that silently does nothing would let an operator
        # believe a distributed probe ran.
        p.error("--probe-distributed requires --probe or --emit-probe")
    if not args.probe_distributed:
        for flag, val in (
            ("--probe-coordinator", args.probe_coordinator),
            ("--probe-num-processes", args.probe_num_processes),
            ("--probe-process-id", args.probe_process_id),
            ("--probe-rendezvous-timeout", args.probe_rendezvous_timeout),
        ):
            if val is not None:
                p.error(f"{flag} requires --probe-distributed")
    if args.probe_soak:
        # Silently not soaking would grade a node healthy without ever
        # applying the sustained load the flag exists to apply.
        if not (args.probe or args.emit_probe or args.calibrate is not None):
            p.error("--probe-soak requires --probe, --emit-probe or --calibrate")
        if args.probe_soak < 0:
            p.error("--probe-soak must be >= 0 (0 disables)")
        if args.probe_level == "enumerate":
            p.error("--probe-soak requires --probe-level compute (or higher)")
    if args.perf_floor is not None:
        # Floors only grade figures a compute-level probe produces.
        if args.perf_floor < 0:
            p.error("--perf-floor must be >= 0 (0 disables)")
        if not (args.probe or args.emit_probe):
            p.error("--perf-floor requires --probe or --emit-probe")
        if args.probe_level == "enumerate":
            p.error("--perf-floor requires --probe-level compute (or higher)")
    if args.probe_topology and args.probe_level in ("enumerate", "compute"):
        # The per-axis block runs at the collective level and above only.
        p.error("--probe-topology requires --probe-level collective (or higher)")
    if args.serve is not None:
        if not 0 <= args.serve <= 65535:
            p.error("--serve PORT must be in 0-65535 (0 = ephemeral)")
        if args.emit_probe:
            # The fleet API is the aggregator's surface (fleet snapshots,
            # cordon control); an emitter pod exposes --metrics-port only.
            p.error("--serve cannot be combined with --emit-probe")
        if args.watch is None and args.federate is None and not (
            args.history or args.log_jsonl
        ):
            # Standalone mode serves a recorded store; without one the
            # server could never answer anything but 503.  Checked last so
            # the runs-alone modes above report their own errors.
            p.error(
                "--serve without --watch serves a recorded store: add "
                "--history FILE and/or --log-jsonl FILE (or run with --watch)"
            )
        if args.watch is None and args.federate is None:
            # Standalone serving runs no check rounds: a flag that only
            # means something during a round would silently do nothing
            # (--federate passed its own stricter list above, and --trace
            # is meaningful there: the merge round's two-tier trace).
            for flag, on in (
                ("--probe", args.probe),
                ("--probe-results", args.probe_results),
                ("--node-events", args.node_events),
                ("--analytics", args.analytics),
                ("--cordon-failed", args.cordon_failed),
                ("--cordon-degraded", args.cordon_degraded),
                ("--uncordon-recovered", args.uncordon_recovered),
                ("--drain-failed", args.drain_failed),
                ("--repair-cmd", args.repair_cmd),
                ("--repair-webhook", args.repair_webhook),
                ("--disruption-budget", args.disruption_budget),
                ("--disruption-lease", args.disruption_lease),
                ("--slice-floor-pct", args.slice_floor_pct is not None),
                ("--strict-slices", args.strict_slices),
                ("--expected-chips", args.expected_chips),
                ("--nodes-json", args.nodes_json),
                ("--label-selector", args.label_selector),
                ("--resource-key", args.resource_key),
                ("--multislice-label", args.multislice_label),
                ("--slack-webhook", args.slack_webhook),
                ("--slack-only-on-error", args.slack_only_on_error),
                ("--trace", args.trace),
            ):
                if on:
                    p.error(
                        f"--serve without --watch runs no check rounds: "
                        f"{flag} would silently do nothing (add --watch to "
                        "run rounds alongside the API)"
                    )

    # The port's own rules, after JAX's: a flag beside a mode that never
    # reads it must not be accepted and silently skipped.
    mode = next((m for m, on in (
        ("--emit-probe", args.emit_probe), ("--selftest", args.selftest),
        ("--calibrate", args.calibrate is not None), ("--report-fresh", args.report_fresh),
        ("--probe-report-schema", args.probe_report_schema)) if on), None)
    if "probe_workload_model" in vars(args):
        if mode not in (None, "--emit-probe") or not (mode or args.probe):
            p.error("--probe-workload-model requires --probe or --emit-probe")
        if args.probe_level != "workload":
            p.error("--probe-workload-model requires --probe-level workload")
    if args.json and mode not in (None, "--selftest"):
        p.error(f"--json requires --selftest or a one-shot round (not {mode})")
    if args.probe_results_max_age != p.get_default("probe_results_max_age") and not (
            args.probe_results or args.report_fresh):
        p.error("--probe-results-max-age requires --probe-results or --report-fresh")
    if mode is not None:
        for flag, dest in _ROUND_FLAGS:
            # The emitter writes its round's trace (emit.py).
            if given(dest) and not (flag == "--trace" and mode == "--emit-probe"):
                p.error(f"{flag} belongs to the one-shot round: it cannot be "
                        f"combined with {mode}")
    elif not args.probe:
        for flag, dest in _PROBE_FLAGS:
            if given(dest):
                p.error(f"{flag} requires --probe or --emit-probe")
    return args


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "simulate":
        # The chaos simulator, as in the JAX CLI: its flags are its own
        # (sim/cli.py), and --device does not apply to it.
        from tpu_node_checker_torch.sim.cli import main as simulate_main

        return simulate_main(argv[1:])
    args = parse_args(argv)
    try:
        return _dispatch(args)
    except KeyboardInterrupt:
        return 130
    except Exception as exc:  # tnc: allow-broad-except(the CLI's catch-all, as JAX's main)
        if args.json:
            from tpu_node_checker_torch.report import error_payload

            print(error_payload(str(exc)))
        else:
            print(f"Error: {exc}", file=sys.stderr)
            traceback.print_exc()
        return EXIT_ERROR


def _dispatch(args) -> int:
    if args.trend:
        from tpu_node_checker_torch import checker

        return checker.trend_summary(args.trend, json_mode=args.json)
    if args.trend_nodes:
        from tpu_node_checker_torch import checker

        return checker.trend_nodes(args.trend_nodes, json_mode=args.json)
    if args.selftest:
        from tpu_node_checker_torch.selftest import selftest

        return selftest(timeout_s=args.probe_timeout, device=args.device, json_mode=args.json)
    if args.calibrate is not None:
        from tpu_node_checker_torch.calibrate import calibrate

        return calibrate(
            args.calibrate, margin=args.calibrate_margin, out=args.calibrate_out,
            level=args.probe_level, timeout_s=args.probe_timeout,
            topology=args.probe_topology, soak_s=args.probe_soak, device=args.device,
        )
    if args.probe_report_schema:
        from tpu_node_checker_torch.probe.schema import as_json_schema

        print(json.dumps(as_json_schema(), indent=2))
        return EXIT_OK
    from tpu_node_checker_torch import checker

    if not args.emit_probe and not args.report_fresh:
        if args.federate:
            # The federation aggregator: merges N per-cluster fleet APIs
            # into /api/v1/global/*; returns only on SIGTERM (143).
            from tpu_node_checker_torch.federation.aggregator import federate

            return federate(args)
        if args.watch is not None:
            # The aggregator's loop: returns only on SIGTERM (143).
            return checker.watch(args)
        if args.serve is not None:
            # The standalone fleet API over a store another process
            # records: returns only on SIGTERM (143).
            return checker.serve_store(args)
        return checker.one_shot(args)
    from tpu_node_checker_torch import emit

    if args.report_fresh:
        return emit.report_fresh(args.report_fresh, args.probe_results_max_age)
    probe = dict(
        level=args.probe_level, timeout_s=args.probe_timeout, device=args.device,
        topology=args.probe_topology, soak_s=args.probe_soak, perf_floor=args.perf_floor,
        distributed=args.probe_distributed, coordinator=args.probe_coordinator,
        num_processes=args.probe_num_processes, process_id=args.probe_process_id,
        dist_init_timeout_s=args.probe_rendezvous_timeout, trace_file=args.trace,
        workload_model=getattr(args, "probe_workload_model", None),
    )
    # One history tracker for the emitter's lifetime (None without --history).
    history = checker._build_history(args)
    if args.watch is not None:
        # Returns only on SIGTERM (143).
        return emit.emit_probe_loop(args.emit_probe, args.watch, log_jsonl=args.log_jsonl,
                                    metrics_port=args.metrics_port, history=history,
                                    **probe)
    return emit.emit_probe(args.emit_probe, log_jsonl=args.log_jsonl, history=history,
                           **probe)


def entrypoint() -> None:
    """Console entry: load ``.env`` (so ``SLACK_WEBHOOK_URL`` may come from
    it), then exit with the run's code."""
    import signal

    try:
        # Die quietly when stdout is a closed pipe (`... | head`).
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # non-POSIX or non-main thread
        pass
    from tpu_node_checker_torch.utils.env import load_dotenv

    load_dotenv()
    sys.exit(main())
