"""Remediation: slice-aware disruption budgets over the round's evidence
rules.

A copy of the JAX package's ``remediation/__init__.py``, held equal to it
by ``tests/test_torch_copies.py``.  The pieces:

* :mod:`~tpu_node_checker_torch.remediation.budget`: the budget engine,
  which treats every multi-host slice as one failure domain and refuses,
  most specific first, a cordon past ``--cordon-max``, one that would take
  a slice below ``--slice-floor-pct``, one past ``--disruption-budget
  N[/WINDOW]``, or one the fleet lease refused;
* :mod:`~tpu_node_checker_torch.remediation.actuate`: the one module that
  calls the cluster's actuators, each call on a granted decision with one
  audit line;
* :mod:`~tpu_node_checker_torch.remediation.drain`: evict-then-cordon
  (a PodDisruptionBudget's refusal is a denial; dry run by default);
* :mod:`~tpu_node_checker_torch.remediation.repair`: ``--repair-cmd`` and
  ``--repair-webhook``, fired once per condemned node, the state kept in
  the history store;
* :mod:`~tpu_node_checker_torch.remediation.lease`: the client of the
  aggregator's fleet budget (``--disruption-lease``); an unreachable
  aggregator falls back to the allowance last leased.
"""

from tpu_node_checker_torch.remediation.budget import (
    DEFAULT_SLICE_FLOOR_PCT,
    BudgetEngine,
    Decision,
    FleetLeaseBudget,
    parse_disruption_budget,
)

__all__ = [
    "DEFAULT_SLICE_FLOOR_PCT",
    "BudgetEngine",
    "Decision",
    "FleetLeaseBudget",
    "parse_disruption_budget",
]
