"""workload_card_ms: card milliseconds a workload round's cross-card work takes, busiest spawned rank, less NCCL.

The probe child, on card 0, spawns one rank on each other card; a rank
runs only the workload level's commands (the collectives, the link sweep,
the sharded training step, ring attention, pipeline hops, the expert
all_to_all), as the child does beside its compute probes, which
``probe_card_ms`` judges in ``emitter-compute``.  A rank's card time is the
union of every kernel, copy and fill in its process's device trace, from
its start to its exit, but NCCL's kernels; the round reads its busiest
rank, and the metric is the mean over the window's rounds.  Nothing
unless every round traced one process a card.

NCCL's kernels are left out because one runs from its launch until every
peer has joined: a rank that is late on its host holds the others' cards,
and across runs that spread their card time by 23-50 % (``nccl_card_ms.
workload`` reports it).
"""

from probebench import trace as tr


def read(run):
    if run.traffic["window"] != "rounds" or not run.rounds:
        return None
    values = []
    for r in run.rounds:
        ranks = r.get("ranks") or []
        if not ranks or len(ranks) + 1 != run.cell.get("chips", 1):
            return None
        cards = []
        for p in ranks:
            events = run.events(p)
            if events is None:
                return None
            cards.append(tr.busy_of(e for e in tr.device_events(events) if not tr.is_nccl(e)))
        if not max(cards):
            return None
        values.append(max(cards) / 1000.0)
    return sum(values) / len(values)
