"""The ``simulate`` subcommand's command surface.

A copy of the JAX package's ``sim/cli.py``, held equal to it by
``tests/test_torch_copies.py``; the port's ``cli.main`` hands it every argv
that starts with ``simulate``.  Its flags are its own, not the round's.

Exit codes: **0** every invariant green, **3** at least one invariant
violated, **1** internal error, **2** usage error (argparse).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from tpu_node_checker_torch import checker


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-node-checker simulate",
        description=(
            "Deterministic chaos simulator: run a seeded fleet scenario "
            "against real checker/aggregator machinery and grade it with "
            "the invariant acceptance matrix.  Same --seed, same scenario "
            "parameters: byte-identical report and event log.  Exit codes: "
            "0 = all invariants green; 3 = an invariant was violated; "
            "1 = error."
        ),
    )
    p.add_argument("--scenario", metavar="NAME",
                   help="scenario to run (see --list-scenarios)")
    p.add_argument("--seed", type=int, default=0, metavar="N",
                   help="RNG seed — the replay handle (default 0)")
    p.add_argument("--clusters", type=int, default=None, metavar="K",
                   help="clusters to synthesize (scenarios that honor it; "
                   "see --list-scenarios)")
    p.add_argument("--nodes-per-cluster", type=int, default=None,
                   metavar="M",
                   help="nodes per cluster, rounded up to whole slices")
    p.add_argument("--rounds", type=int, default=None, metavar="R",
                   help="check rounds to drive")
    p.add_argument("--report", choices=("human", "json"), default="human",
                   help="report format on stdout (json is the "
                   "byte-replayable CI artifact)")
    p.add_argument("--list-scenarios", action="store_true",
                   help="list the scenario grid and exit")
    p.add_argument("--fuzz", action="store_true",
                   help="fuzz mode: sample --seeds failure programs from "
                   "the chaos grammar (--seed is the base seed), grade "
                   "each against the invariant matrix, and shrink the "
                   "first violation to a minimal reproducer")
    p.add_argument("--seeds", type=int, default=10, metavar="N",
                   help="fuzz campaign size; run i samples from seed "
                   "--seed + i (default 10)")
    p.add_argument("--replay", metavar="FILE",
                   help="replay a JSON reproducer (emitted by --fuzz, "
                   "checked into tests/sim_reproducers/) and re-grade it")
    return p


def _list_scenarios() -> str:
    from tpu_node_checker_torch.sim.scenarios import SCENARIOS

    lines = []
    for name in sorted(SCENARIOS):
        s = SCENARIOS[name]
        d = s.defaults
        lines.append(f"{name:20s} {s.title}")
        lines.append(
            f"{'':20s} defaults: clusters={d['clusters']} "
            f"nodes-per-cluster={d['nodes_per_cluster']} "
            f"rounds={d['rounds']}; tunable: "
            f"{', '.join(t.replace('_', '-') for t in s.tunable) or 'none'}"
        )
        lines.append(f"{'':20s} invariants: {', '.join(s.invariants)}")
    return "\n".join(lines)


def _render_human(result) -> str:
    lines = [
        f"scenario {result.name!r} seed={result.seed} "
        + " ".join(f"{k.replace('_', '-')}={v}"
                   for k, v in sorted(result.params.items())),
    ]
    for v in result.report["invariants"]:
        mark = "PASS" if v["ok"] else "FAIL"
        lines.append(f"  [{mark}] {v['name']}: {v['detail']}")
    lines.append(
        f"{'OK' if result.ok else 'VIOLATED'} — "
        f"{sum(1 for v in result.report['invariants'] if v['ok'])}"
        f"/{len(result.report['invariants'])} invariants green; "
        f"events={result.report['event_count']} "
        f"digest={result.report['events_digest']}"
    )
    return "\n".join(lines)


def _render_fuzz(report: dict) -> str:
    lines = [f"fuzz base-seed={report['base_seed']} seeds={report['seeds']}"]
    for r in report["runs"]:
        mark = "ok " if r["ok"] else "RED"
        line = (f"  [{mark}] seed={r['seed']} slices={r['slices']} "
                f"rounds={r['rounds']} programs={r['programs']} "
                f"api-faults={r['api_faults']} watch-loss={r['watch_loss']}")
        if not r["ok"]:
            line += f" violated={','.join(r['violated'])}"
        lines.append(line)
    if report["reproducer"]:
        rep = report["reproducer"]
        prog = rep["program"]
        lines.append(
            f"shrunk reproducer: invariant={rep['invariant']} "
            f"seed={rep['seed']} slices={prog['slices']} "
            f"rounds={prog['rounds']} programs={len(prog['programs'])}"
        )
        for step in report["shrink_steps"] or []:
            lines.append(f"  shrink: {step}")
    green = sum(1 for r in report["runs"] if r["ok"])
    lines.append(f"{'OK' if report['ok'] else 'VIOLATED'} — "
                 f"{green}/{len(report['runs'])} seeds green")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.list_scenarios:
        if args.scenario:
            p.error("--list-scenarios runs alone")
        print(_list_scenarios())
        return checker.EXIT_OK
    from tpu_node_checker_torch.sim.engine import ScenarioError, run_scenario

    if args.replay:
        if args.scenario or args.fuzz:
            p.error("--replay runs alone (no --scenario, no --fuzz)")
        import json

        from tpu_node_checker_torch.sim import fuzz as fuzz_mod

        try:
            with open(args.replay, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            program = doc.get("program", doc) if isinstance(doc, dict) else doc
            result = fuzz_mod.run_program(
                program,
                seed=int(doc.get("seed", 0)) if isinstance(doc, dict) else 0,
            )
        except ScenarioError as exc:
            p.error(str(exc))
        except Exception as exc:  # tnc: allow-broad-except(the CLI's documented exit-1 contract: a bad reproducer file reports its error instead of a traceback impersonating a verdict)
            print(f"Error: {exc}", file=sys.stderr)
            return checker.EXIT_ERROR
        if args.report == "json":
            sys.stdout.write(result.report_json)
        else:
            print(_render_human(result))
        return checker.EXIT_OK if result.ok else checker.EXIT_NONE_READY
    if args.fuzz:
        if args.scenario:
            p.error("--fuzz and --scenario are mutually exclusive")
        if args.seeds < 1:
            p.error("--seeds must be >= 1")
        from tpu_node_checker_torch.sim import fuzz as fuzz_mod

        try:
            report = fuzz_mod.run_fuzz(args.seed, args.seeds)
        except ScenarioError as exc:
            p.error(str(exc))
        except Exception as exc:  # tnc: allow-broad-except(same exit-1 contract as scenario runs)
            print(f"Error: {exc}", file=sys.stderr)
            return checker.EXIT_ERROR
        if args.report == "json":
            sys.stdout.write(fuzz_mod.fuzz_report_json(report))
        else:
            print(_render_fuzz(report))
        return checker.EXIT_OK if report["ok"] else checker.EXIT_NONE_READY
    if not args.scenario:
        p.error("--scenario NAME is required (see --list-scenarios)")

    try:
        result = run_scenario(
            args.scenario, args.seed,
            clusters=args.clusters,
            nodes_per_cluster=args.nodes_per_cluster,
            rounds=args.rounds,
        )
    except ScenarioError as exc:
        p.error(str(exc))
    except Exception as exc:  # tnc: allow-broad-except(the CLI's documented exit-1 contract: any crashed scenario reports its error instead of a traceback impersonating a verdict)
        print(f"Error: {exc}", file=sys.stderr)
        return checker.EXIT_ERROR
    if args.report == "json":
        sys.stdout.write(result.report_json)
    else:
        print(_render_human(result))
    return checker.EXIT_OK if result.ok else checker.EXIT_NONE_READY


def entrypoint(argv: Optional[List[str]] = None) -> None:
    sys.exit(main(argv))
