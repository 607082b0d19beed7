"""tnc-lint: project-native static analysis.

A 14k-line threaded checker accumulates invariants that exist only as prose
("the snapshot read path takes no locks and does no I/O", "PATCH retries only
on connect-phase failures", "no real sleeps in tests") — until a refactor
silently regresses one.  This package turns those invariants into machine
checks: a stdlib-``ast``/``tokenize`` lint engine plus three rule families,

* **invariant lints** — broad ``except`` without re-raise, blocking calls on
  the snapshot read path or inside registered signal handlers, mutable
  default arguments, metric-name contract (``tpu_node_checker_`` prefix,
  counters end ``_total``), the CLI exit-code contract, and real sleeps in
  tests;
* a heuristic **lock-discipline race checker** — attributes guarded by a
  ``with self._lock`` anywhere in a class must be guarded everywhere, no
  mutation of a published snapshot after the atomic swap, and every spawned
  thread carries ``name=`` and ``daemon=``;
* **contract-drift detectors** — metric names in ``deploy/prometheusrule.yaml``
  and the README must be names the package can actually emit, and the README
  flag table must match ``cli.py`` exactly, in both directions.

Run it as ``python -m tpu_node_checker_torch.analysis`` from a checkout (exit 0
clean / 1 findings / 2 usage error / 3 internal error).  Suppressions are explicit and
accountable: ``# tnc: allow-<rule>(reason)`` on the offending line or alone
on the line above — the reason is mandatory, and an empty or unknown
suppression is itself a finding.  See ``docs/DESIGN.md`` §11 for the rule
table and the policy for adding rules.

No dependencies beyond the standard library, consistent with the project's
pinned-constraints policy: the linter must run anywhere the code does.
"""

from tpu_node_checker_torch.analysis.engine import Finding, Report, run_project
import tpu_node_checker_torch.analysis.rules  # noqa: F401 — loads flow.rules whole, whichever module is imported first

__all__ = ["Finding", "Report", "run_project"]
