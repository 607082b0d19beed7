"""The program's own spans and counters of a round, as the readers see them.

Every report of the port carries ``spans`` (``tpu_node_checker_torch/probe/
spans.py``): ``ms``, each span's ``[count, total_ms, max_ms]`` over the round,
and ``counters``.  A program without them (the parent commit of the change
that added them) gives every reader here None, never an error.
"""

from __future__ import annotations

from typing import Callable, Optional


def block(r: dict) -> dict:
    """The round's ``spans`` block, or {}."""
    found = (r.get("report") or {}).get("spans")
    return found if isinstance(found, dict) else {}


def row(r: dict, name: str) -> Optional[list]:
    """``[count, total_ms, max_ms]`` of span ``name`` in round ``r``, or None."""
    found = (block(r).get("ms") or {}).get(name)
    return found if isinstance(found, list) and len(found) == 3 else None


def counter(r: dict, name: str) -> Optional[float]:
    found = (block(r).get("counters") or {}).get(name)
    return found if isinstance(found, (int, float)) else None


def mean_round_s(run, name: str, less: Callable[[dict], float] = lambda r: 0.0) -> Optional[float]:
    """Span ``name``'s seconds a window round (its total in each round,
    less ``less(r)``, the benchmark hook's own seconds inside it), the mean
    over the window's rounds; None where a round lacks the span."""
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    values = []
    for r in run.rounds:
        found = row(r, name)
        if found is None:
            return None
        values.append(found[1] / 1e3 - less(r))
    return sum(values) / len(values)
