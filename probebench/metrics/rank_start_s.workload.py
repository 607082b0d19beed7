"""rank_start_s.workload: seconds from the rank group's start to every rank's first command.

Timed by the benchmark's tap on ``parallel/mesh.py``: from the start of
``RankGroup.start`` in the probe child (spawning the ranks, each one's
``import torch`` and its join of the NCCL process group) to the latest
first command of any process of the group, each spawned rank's less its
profiler's start (the hook's, before the rank joins); the mean over the
window's rounds.
"""


def read(run):
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    values = []
    for r in run.rounds:
        starts = (r["capture"] or {}).get("group_starts")
        if not starts or not r.get("ranks"):
            return None
        late = []
        for p in run.processes(r):
            cap = p["capture"] or {}
            if cap.get("first_command_wall") is None:
                return None
            cost = (cap.get("trace_start_cost_s") or 0.0) if p is not r else 0.0
            late.append(cap["first_command_wall"] - cost)
        values.append(max(late) - starts[0][0])
    return sum(values) / len(values)
