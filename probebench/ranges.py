"""The card time launched inside the program's own ranges, as a share of a step's.

The program opens ``record_function("tnc:<span>")`` around each span while
a profiler records (``tpu_node_checker_torch/probe/spans.py``), on whichever
thread runs it: autograd's backward thread included.  A device operation
belongs to a range when the call that launched it (matched by correlation
id) lies inside it, as ``trace.launched_within`` matches the steps; here
the intervals are merged and searched by bisection, for the thousands of
ranges a step of a deep model opens.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

from probebench import trace as tr

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def ranges(events: List[dict], name: str) -> List[tuple]:
    """The union of the host intervals of every ``name`` range, on any thread."""
    return tr.union((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") == name)


def launched_in(events: List[dict], within: List[tuple]) -> List[dict]:
    """The device events of every launch made in one of the disjoint,
    sorted intervals ``within``."""
    starts = [s for s, _ in within]
    ids = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= within[i][1]:
            ids.add((e.get("args") or {}).get("correlation"))
    ids.discard(None)
    return [e for e in tr.device_events(events)
            if (e.get("args") or {}).get("correlation") in ids]


def step_share(run, names) -> Optional[float]:
    """The card time launched inside the ``tnc:<name>`` ranges (any of
    ``names``) within the training steps, over the steps' own card time
    (NCCL's left out), in %: the busiest card's, the mean over the window's
    rounds.  None where a round traced no step or none of the ranges."""
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    values = []
    for r in run.rounds:
        found = []
        for p in run.processes(r):
            events = run.events(p) or []
            steps = tr.union(tr.annotations(events, "workload_step"))
            inner = tr.union(iv for name in names for iv in ranges(events, f"tnc:{name}"))
            if not steps or not inner:
                continue
            step = [e for e in launched_in(events, steps) if not tr.is_nccl(e)]
            part = launched_in(events, inner)
            ids = {id(e) for e in step}
            part = [e for e in part if id(e) in ids]
            if step:
                found.append((tr.busy_of(step), tr.busy_of(part)))
        if not found:
            return None
        whole, part = max(found)
        values.append(100.0 * part / whole)
    return sum(values) / len(values)
