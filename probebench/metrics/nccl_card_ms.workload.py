"""nccl_card_ms.workload: milliseconds NCCL's kernels hold a card a workload round.

Each card's union of the NCCL kernels (``nccl`` in the kernel's name: the
collectives, send and receive) in its process's device trace, the busiest
card's in each round, the mean over the window's rounds.  An NCCL kernel
runs from its launch until every peer has joined, so a peer that is late
on its host shows here as card time, and a shorter, better aligned round
as less: it moves the round, and so ``setup_s``, which holds one.
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
            if events is None:
                return None
            cards.append(tr.busy_of(e for e in tr.device_events(events) if tr.is_nccl(e)) / 1000.0)
        if len(cards) != run.cell.get("chips", 1) or not max(cards):
            return None
        values.append(max(cards))
    return sum(values) / len(values)
