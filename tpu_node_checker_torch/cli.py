"""Command line of the PyTorch/CUDA probe: the node side of the checker.

::

    python -m tpu_node_checker_torch --emit-probe FILE|- \
        [--probe-level {enumerate,compute,collective,mesh,workload}]
        [--probe-timeout S] [--device cpu] [--probe-soak S]
        [--probe-topology DIMS] [--perf-floor F]
        [--watch S] [--log-jsonl FILE]
    python -m tpu_node_checker_torch --report-fresh FILE [--probe-results-max-age S]
    python -m tpu_node_checker_torch --probe-report-schema

Exactly one mode runs.  ``--emit-probe`` writes one report, or with
``--watch`` one every S seconds until SIGTERM (exit 143).  ``--report-fresh``
is the emitter pod's liveness verdict on its report.
``--probe-report-schema`` prints the report's JSON Schema.  The flags keep
the JAX checker's names, defaults, meanings and usage errors; a flag of the
JAX checker that is not ported is an unknown argument here.

Exit codes: 0 when the report is healthy (or fresh), 3 when it is not, 1 on
an error that left no report (or a report that is not fresh), 2 on a usage
error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tpu_node_checker_torch.probe.levels import LEVELS

EXIT_OK = 0
EXIT_ERROR = 1
MODES = ("--emit-probe", "--report-fresh", "--probe-report-schema")


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
    p.add_argument("--probe-results-max-age", type=float, default=900.0, metavar="SECONDS",
                   help="with --report-fresh: the report's greatest age (default 900s)")
    p.add_argument("--probe-soak", type=float, default=0.0, metavar="SECONDS",
                   help="node-acceptance soak: at compute level and above, loop the "
                   "matmul burn under sustained load for this long; fails on numerics "
                   "errors or throughput collapse (probe timeout extends to fit)")
    p.add_argument("--probe-topology", metavar="DIMS",
                   help="torus label of the host's cards (e.g. 2x2); at collective "
                   "level and above, one all_reduce per axis so a fault names its axis")
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
    if not (args.emit_probe or args.report_fresh or args.probe_report_schema):
        p.error(f"one of {', '.join(MODES)} is required")
    if args.emit_probe and args.probe_results_max_age != p.get_default("probe_results_max_age"):
        p.error("--probe-results-max-age requires --report-fresh")
    if args.probe_soak:
        # Silently not soaking would grade a node healthy without ever
        # applying the sustained load the flag exists to apply.
        if args.probe_soak < 0:
            p.error("--probe-soak must be >= 0 (0 disables)")
        if args.probe_level == "enumerate":
            p.error("--probe-soak requires --probe-level compute (or higher)")
    if args.perf_floor is not None:
        # Floors only grade figures a compute-level probe produces.
        if args.perf_floor < 0:
            p.error("--perf-floor must be >= 0 (0 disables)")
        if args.probe_level == "enumerate":
            p.error("--perf-floor requires --probe-level compute (or higher)")
    if args.probe_topology and args.probe_level in ("enumerate", "compute"):
        # The per-axis block runs at the collective level and above only.
        p.error("--probe-topology requires --probe-level collective (or higher)")
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
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
    )
    if args.watch is not None:
        # Returns only on SIGTERM (143).
        return emit.emit_probe_loop(args.emit_probe, args.watch, log_jsonl=args.log_jsonl,
                                    **probe)
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
