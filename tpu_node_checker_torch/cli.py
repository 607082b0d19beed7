"""Command line of the PyTorch/CUDA probe: the node side of the checker.

::

    python -m tpu_node_checker_torch --emit-probe FILE|- \
        [--probe-level {enumerate,compute,collective,mesh,workload}]
        [--probe-timeout S] [--device cpu] [--probe-soak S]
        [--probe-topology DIMS] [--perf-floor F]
        [--watch S [--metrics-port PORT]] [--log-jsonl FILE]
        [--probe-distributed --probe-coordinator HOST:PORT
         --probe-num-processes N --probe-process-id I
         [--probe-rendezvous-timeout S]]
    python -m tpu_node_checker_torch --selftest [--json] [--probe-timeout S] [--device cpu]
    python -m tpu_node_checker_torch --calibrate REPS [--probe-level L]
        [--calibrate-margin F] [--calibrate-out FILE] [--probe-timeout S]
        [--probe-soak S] [--probe-topology DIMS] [--device cpu]
    python -m tpu_node_checker_torch --report-fresh FILE [--probe-results-max-age S]
    python -m tpu_node_checker_torch --probe-report-schema

Exactly one mode runs.  ``--emit-probe`` writes one report, or with
``--watch`` one every S seconds until SIGTERM (exit 143), serving the
round's gauges on ``--metrics-port``; with ``--probe-distributed`` one
emitter per host joins one rendezvous and probes every host's cards as one
rank group.  ``--selftest`` rehearses every
detector on this host (the emitter pod's initContainer), and
``--calibrate`` prints this host's healthy figures as ``TNC_PERF_EXPECT``
JSON, which ``--perf-floor`` grades against.  ``--report-fresh`` is the
emitter pod's liveness verdict on its report.  ``--probe-report-schema``
prints the report's JSON Schema.  The flags keep the JAX checker's names,
defaults, meanings and usage errors; a flag of the JAX checker that is not
ported is an unknown argument here.

Exit codes: 0 when the report is healthy (or fresh, or the drill behaved,
or the calibration ran), 3 when it is not, 1 on an error that left no
report (or a report that is not fresh), 2 on a usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tpu_node_checker_torch.probe.floors import DEFAULT_CALIBRATION_MARGIN
from tpu_node_checker_torch.probe.levels import LEVELS

EXIT_OK = 0
EXIT_ERROR = 1
MODES = ("--emit-probe", "--selftest", "--calibrate", "--report-fresh",
         "--probe-report-schema")


def build_parser() -> argparse.ArgumentParser:
    # No abbreviations: a JAX checker flag the port lacks (--probe-results)
    # must not parse as a prefix of one it has (--probe-results-max-age).
    p = argparse.ArgumentParser(
        prog="python -m tpu_node_checker_torch",
        description="Probe this host's NVIDIA card(s) and write probe reports "
        "for the fleet checker's --probe-results.",
        allow_abbrev=False,
    )
    p.add_argument("--emit-probe", metavar="FILE",
                   help="write the probe report to FILE atomically ('-' for stdout)")
    p.add_argument("--report-fresh", metavar="FILE",
                   help="exit 0 iff FILE is a readable probe report whose "
                   "written_at is younger than --probe-results-max-age, else 1 "
                   "(the emitter pod's livenessProbe); runs alone")
    p.add_argument("--probe-report-schema", action="store_true",
                   help="print the probe report's JSON Schema (draft 2020-12) "
                   "and exit; runs alone")
    p.add_argument("--probe-level", choices=LEVELS, default="enumerate",
                   help="enumerate, compute, collective, mesh or workload (each "
                   "includes the previous); collective and up run one rank per card")
    p.add_argument("--probe-timeout", type=float, default=None, metavar="S",
                   help="kill the probe child after S seconds (default: the level's "
                   "budget, plus --probe-soak)")
    p.add_argument("--device", default="cuda:0",
                   help="device to probe: cuda:0 (default) or cpu")
    p.add_argument("--watch", type=float, metavar="SECONDS",
                   help="with --emit-probe: rewrite the report every SECONDS, "
                   "measured from the start of a round, until SIGTERM (exit 143)")
    p.add_argument("--log-jsonl", metavar="FILE",
                   help="with --emit-probe: append one JSON line per round to FILE "
                   "(the fleet checker's --trend reads it)")
    p.add_argument("--metrics-port", type=int, metavar="PORT",
                   help="with --watch: serve Prometheus metrics on this port (0 = ephemeral)")
    p.add_argument("--selftest", action="store_true",
                   help="rehearse the fault-detection pipeline on this host: a clean "
                   "baseline probe, then one injected fault per detector class (perf "
                   "throttle, collective leg, link, slice boundary), each verified to be "
                   "caught AND correctly named; exit 0 = drill passed, 3 = a detector "
                   "missed — runs alone")
    p.add_argument("--json", action="store_true",
                   help="with --selftest: machine-readable JSON output")
    p.add_argument("--calibrate", type=int, default=None, metavar="REPS",
                   help="measure this host's healthy perf expectations: run the probe "
                   "REPS times at --probe-level (compute or higher), print the "
                   "margin-adjusted per-metric medians as TNC_PERF_EXPECT JSON on "
                   "stdout, which --perf-floor grades against on cards the built-in "
                   "table lacks (the H100); any failed rep aborts (never calibrate a "
                   "sick host) — runs alone")
    p.add_argument("--calibrate-margin", type=float, default=None, metavar="FRACTION",
                   help="with --calibrate: expectation = FRACTION x median, keeping "
                   "headroom under the healthy median so run-to-run jitter never sits "
                   "above 'expected' (default 0.9)")
    p.add_argument("--calibrate-out", metavar="FILE",
                   help="with --calibrate: write the JSON to FILE (atomic) instead of stdout")
    p.add_argument("--probe-results-max-age", type=float, default=900.0, metavar="SECONDS",
                   help="with --report-fresh: the report's greatest age (default 900s)")
    p.add_argument("--probe-soak", type=float, default=0.0, metavar="SECONDS",
                   help="node-acceptance soak: at compute level and above, loop the "
                   "matmul burn under sustained load for this long; fails on numerics "
                   "errors or throughput collapse (probe timeout extends to fit)")
    p.add_argument("--probe-topology", metavar="DIMS",
                   help="torus label of the host's cards (e.g. 2x2); at collective "
                   "level and above, one all_reduce per axis so a fault names its axis")
    p.add_argument("--probe-distributed", action="store_true",
                   help="with --emit-probe: join the rendezvous of one probe process per "
                   "host before enumerating, so the probe sees every host's cards, "
                   "verifies a cross-process psum, and its collectives cross hosts")
    p.add_argument("--probe-coordinator", metavar="HOST:PORT",
                   help="with --probe-distributed: the rendezvous coordinator, where "
                   "process 0 hosts the store")
    p.add_argument("--probe-num-processes", type=int, metavar="N",
                   help="with --probe-distributed: total process count in the rendezvous")
    p.add_argument("--probe-process-id", type=int, metavar="I",
                   help="with --probe-distributed: this process's rank")
    p.add_argument("--probe-rendezvous-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="with --probe-distributed: bound the rendezvous itself so an "
                   "unreachable coordinator or a missing peer reports a structured "
                   "error (default 60s)")
    p.add_argument("--perf-floor", type=float, default=None, metavar="FRACTION",
                   help="at compute level and above, grade the measured figures against "
                   "this fraction of the device kind's expected figures (default 0.4; "
                   "0 disables); $TNC_PERF_EXPECT (JSON {metric: expected}) gives the "
                   "expectations where the built-in table has none, as for the H100")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.probe_report_schema and any(
        v != p.get_default(k) for k, v in vars(args).items() if k != "probe_report_schema"
    ):
        # Pure-output mode: anything riding along would silently not run.
        p.error("--probe-report-schema runs alone")
    if args.watch is not None and args.watch <= 0:
        p.error("--watch interval must be a positive number of seconds")
    if args.metrics_port is not None and args.watch is None:
        p.error("--metrics-port requires --watch (one-shot runs serve no scrapes)")
    if args.selftest and (
        args.emit_probe
        or args.watch is not None
        or args.report_fresh
        or args.calibrate is not None
        or args.log_jsonl
        or args.probe_topology
        or args.probe_level != "enumerate"
    ):
        # A drill-only mode must not absorb emit flags the operator thinks ran.
        p.error("--selftest runs alone (only --json and --probe-timeout "
                "may accompany it)")
    if args.calibrate is not None:
        if (
            args.emit_probe
            or args.watch is not None
            or args.report_fresh
            or args.log_jsonl
            or args.json
            or args.perf_floor is not None
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
    if args.json and not args.selftest:
        # The drill's document is the port's only JSON output mode.
        p.error("--json requires --selftest")
    if args.report_fresh and any(
        v != p.get_default(k) for k, v in vars(args).items()
        if k not in ("report_fresh", "probe_results_max_age")
    ):
        # A liveness verdict stays a liveness verdict: an emission or probe
        # flag beside it would silently do nothing.
        p.error(
            "--report-fresh runs alone (no --emit-probe/--watch/--log-jsonl/"
            "--probe-level/--probe-timeout/--probe-soak/--probe-topology/"
            "--perf-floor/--device)"
        )
    if args.probe_distributed and not args.emit_probe:
        # A probe modifier that silently does nothing would let an operator
        # believe a distributed probe ran.  JAX's words: the port has no
        # --probe, so only --emit-probe satisfies the rule.
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
    if not (args.emit_probe or args.report_fresh or args.probe_report_schema
            or args.selftest or args.calibrate is not None):
        p.error(f"one of {', '.join(MODES)} is required")
    if (not args.report_fresh
            and args.probe_results_max_age != p.get_default("probe_results_max_age")):
        p.error("--probe-results-max-age requires --report-fresh")
    if args.probe_soak:
        # Silently not soaking would grade a node healthy without ever
        # applying the sustained load the flag exists to apply.
        if not (args.emit_probe or args.calibrate is not None):
            p.error("--probe-soak requires --emit-probe or --calibrate")
        if args.probe_soak < 0:
            p.error("--probe-soak must be >= 0 (0 disables)")
        if args.probe_level == "enumerate":
            p.error("--probe-soak requires --probe-level compute (or higher)")
    if args.perf_floor is not None:
        # Floors only grade figures a compute-level probe produces.
        if args.perf_floor < 0:
            p.error("--perf-floor must be >= 0 (0 disables)")
        if not args.emit_probe:
            p.error("--perf-floor requires --emit-probe")
        if args.probe_level == "enumerate":
            p.error("--perf-floor requires --probe-level compute (or higher)")
    if args.probe_topology and args.probe_level in ("enumerate", "compute"):
        # The per-axis block runs at the collective level and above only.
        p.error("--probe-topology requires --probe-level collective (or higher)")
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
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
    from tpu_node_checker_torch import emit

    if args.probe_report_schema:
        from tpu_node_checker_torch.probe.schema import as_json_schema

        print(json.dumps(as_json_schema(), indent=2))
        return EXIT_OK
    if args.report_fresh:
        return emit.report_fresh(args.report_fresh, args.probe_results_max_age)
    probe = dict(
        level=args.probe_level, timeout_s=args.probe_timeout, device=args.device,
        topology=args.probe_topology, soak_s=args.probe_soak, perf_floor=args.perf_floor,
        distributed=args.probe_distributed, coordinator=args.probe_coordinator,
        num_processes=args.probe_num_processes, process_id=args.probe_process_id,
        dist_init_timeout_s=args.probe_rendezvous_timeout,
    )
    if args.watch is not None:
        # Returns only on SIGTERM (143).
        return emit.emit_probe_loop(args.emit_probe, args.watch, log_jsonl=args.log_jsonl,
                                    metrics_port=args.metrics_port, **probe)
    try:
        rc, doc = emit.emit_probe_once(args.emit_probe, **probe)
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return EXIT_ERROR
    if args.log_jsonl:
        emit.append_jsonl(args.log_jsonl, emit.emitter_round_entry(rc, doc))
    return rc


def entrypoint() -> None:
    sys.exit(main())
