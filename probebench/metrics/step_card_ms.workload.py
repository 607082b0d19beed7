"""step_card_ms.workload: device milliseconds of one training step, on the busiest card.

In each process of a window round, the device work launched inside the
training step's calls (the tap's ``probebench:workload_step`` ranges:
forward, backward, the Adam update, the copies; matched to each launch by
correlation id) but NCCL's kernels, as ``workload_card_ms`` counts it, its
union over the steps' count; the busiest card of the round, the mean over
the window's rounds.  Nothing where a round's trace holds no step.
"""

from probebench import trace as tr


def read(run):
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    values = []
    for r in run.rounds:
        cards = []
        for p in run.processes(r):
            events = run.events(p)
            steps = tr.annotations(events or [], "workload_step")
            if not steps:
                continue
            launched = [e for e in tr.launched_within(events, steps) if not tr.is_nccl(e)]
            if launched:
                cards.append(tr.busy_of(launched) / 1000.0 / len(steps))
        if not cards:
            return None
        values.append(max(cards))
    return sum(values) / len(values)
