"""``python -m tpu_node_checker_torch.analysis`` — the tnc-lint CLI.

Exit codes: 0 clean (suppressed findings don't count), 1 unsuppressed
findings, 2 usage error (bad flag, root is not a checkout), 3 internal
error (a rule crashed — traceback on stderr).  The codes are symbolic
below for the same reason the checker's are: CI and scripts branch on
them; in particular the CI corpus gate requires *exactly* 1, so a rule
crashing mid-walk can never impersonate "findings present".
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import List, Optional

from tpu_node_checker_torch.analysis.engine import (
    NotAProjectRoot,
    render_human,
    render_json,
    run_project,
)

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2
EXIT_INTERNAL = 3


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_node_checker_torch.analysis",
        description="Project-native static analysis: invariant lints, a "
        "lock-discipline race checker, and contract-drift detection.",
    )
    parser.add_argument(
        "--root", default=".",
        help="repository checkout to analyze (default: current directory)",
    )
    parser.add_argument(
        "--format", choices=("human", "json", "sarif"), default="human",
        help="output format (json: stable schema for CI artifacts; "
        "sarif: SARIF 2.1.0 for forge annotation upload)",
    )
    parser.add_argument(
        "--rule", action="append", metavar="SLUG",
        help="run only this rule (repeatable; default: all; bypasses the "
        "incremental cache — a filtered run is not the repo verdict)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table (code, slug, invariant) and exit 0",
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help="incremental mode: replay per-file findings cached by "
        "content sha256, re-run graph rules only when a file in their "
        "reachability slice changed (same report as a full run)",
    )
    parser.add_argument(
        "--cache", metavar="FILE", default=None,
        help="cache file for --changed-only "
        "(default: <root>/.tnc-lint-cache.json)",
    )
    parser.add_argument(
        "--graph", choices=("json",), default=None,
        help="dump the whole-program call graph (symbols, edges, "
        "thread entries, domains, unresolved bucket) and exit 0",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        # argparse exits 2 on usage errors and 0 on --help: preserve both,
        # but through OUR symbolic contract.
        return EXIT_USAGE if exc.code else EXIT_CLEAN

    if args.list_rules:
        from tpu_node_checker_torch.analysis.rules import ALL_RULES

        for rule in ALL_RULES:
            print(f"{rule.code}  {rule.slug:24s} {rule.doc}")
        return EXIT_CLEAN

    if args.rule:
        from tpu_node_checker_torch.analysis.rules import RULE_SLUGS

        unknown = sorted(set(args.rule) - RULE_SLUGS)
        if unknown:
            print(
                f"unknown rule(s): {', '.join(unknown)} "
                f"(see --list-rules)", file=sys.stderr,
            )
            return EXIT_USAGE
        if args.changed_only:
            print("tnc-lint: --rule bypasses the incremental cache; drop "
                  "--changed-only for filtered runs", file=sys.stderr)
            return EXIT_USAGE

    if args.graph is not None:
        try:
            return _dump_graph(os.path.abspath(args.root))
        except NotAProjectRoot as exc:
            print(f"tnc-lint: {exc}", file=sys.stderr)
            return EXIT_USAGE

    try:
        if args.changed_only:
            from tpu_node_checker_torch.analysis.cache import run_incremental

            report = run_incremental(os.path.abspath(args.root),
                                     cache_path=args.cache)
        else:
            report = run_project(os.path.abspath(args.root),
                                 only_rules=args.rule)
    except NotAProjectRoot as exc:
        print(f"tnc-lint: {exc}", file=sys.stderr)
        return EXIT_USAGE
    except Exception:  # tnc: allow-broad-except(a crashed rule must exit 3, distinct from exit 1, or CI's corpus gate would read the traceback's exit as findings-present)
        traceback.print_exc()
        print("tnc-lint: internal error — a rule crashed; this is a linter "
              "bug, not a finding", file=sys.stderr)
        return EXIT_INTERNAL
    if args.format == "json":
        print(render_json(report))
    elif args.format == "sarif":
        from tpu_node_checker_torch.analysis.sarif import render_sarif

        print(render_sarif(report))
    else:
        print(render_human(report))
    return EXIT_FINDINGS if report.findings else EXIT_CLEAN


def _dump_graph(root: str) -> int:
    """``--graph json``: the whole-program view as one stable document."""
    import json
    import time

    from tpu_node_checker_torch.analysis.engine import load_project
    from tpu_node_checker_torch.analysis.flow import build_graph, infer_entries
    from tpu_node_checker_torch.analysis.flow.entries import compute_domains

    t0 = time.perf_counter()
    project = load_project(root)
    graph = build_graph(project)
    entries = infer_entries(graph)
    domains = compute_domains(graph, entries)
    doc = graph.to_dict()
    doc["thread_entries"] = [
        {"domain": e.domain, "function": e.fid, "kind": e.kind,
         "site": f"{e.path}:{e.lineno}"}
        for e in entries
    ]
    doc["multi_domain_functions"] = {
        fid: sorted(doms) for fid, doms in sorted(domains.items())
        if len(doms) > 1
    }
    doc["build_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    print(json.dumps(doc, indent=2, sort_keys=True))
    return EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
