"""expert_imbalance.dsv2: the busiest held expert's tokens over the held experts' mean, per layer-step.

From the program's counters of each window round: ``moe_max_expert_tokens``
(the busiest held expert's assignments, summed over the MoE layers' forward
passes) over ``moe_assignments_held`` divided by the configuration's
``held_experts``; the mean over the window's rounds.  1 is an even load;
the step waits on the busiest expert.  Nothing where a round has no such
counters.
"""

from probebench import spans
from probebench.core import HERE, load_json


def read(run):
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    held = load_json(HERE / "configs" / f"{run.cell['config']}.json").get("held_experts")
    values = []
    for r in run.rounds:
        busiest = spans.counter(r, "moe_max_expert_tokens")
        assigned = spans.counter(r, "moe_assignments_held")
        if not held or not busiest or not assigned:
            return None
        values.append(busiest / (assigned / held))
    return sum(values) / len(values)
