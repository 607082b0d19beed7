"""probe_card_ms: milliseconds of work one emitter round puts on the card.

The union of every kernel, copy and fill in each window round's device
trace (taken in the probe child from its first probe to its exit), the
mean over the window's rounds: the card time each round takes from the
node's own jobs.  Nothing when a round's trace holds no device work.
"""


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    values = [run.busy_s(r) for r in run.rounds]
    if not values or any(not v for v in values):
        return None
    return 1000.0 * sum(values) / len(values)
