"""The rule registry: three families, stable slugs and codes.

Adding a rule (the DESIGN §11 procedure): implement it in the right family
module, append it to that module's ``RULES``, seed a true-positive AND a
near-miss true-negative in ``tests/analysis_fixtures/``, add the table row
in DESIGN.md §11 — then run the engine over the repo and fix or
reason-annotate every site the new rule surfaces before merging.
"""

from __future__ import annotations

from typing import List

from tpu_node_checker_torch.analysis.rules.base import Rule
from tpu_node_checker_torch.analysis.rules import contracts, invariants, locks
from tpu_node_checker_torch.analysis.flow import rules as flow

FILE_RULES: List[Rule] = list(invariants.RULES) + list(locks.RULES)
PROJECT_RULES: List[Rule] = list(contracts.RULES) + list(flow.RULES)
ALL_RULES: List[Rule] = FILE_RULES + PROJECT_RULES

RULE_SLUGS = frozenset(rule.slug for rule in ALL_RULES)

__all__ = ["ALL_RULES", "FILE_RULES", "PROJECT_RULES", "RULE_SLUGS", "Rule"]
