"""kernel_ms.emitter: milliseconds a round's kernels run on the card.

Each kernel's device time in a window round's trace, summed kernel by
kernel (copies and fills left out), the mean over the window's rounds.
Nothing when a round's trace holds no kernel.
"""

from probebench import trace as tr


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    values = []
    for r in run.rounds:
        events = run.events(r)
        if events is None:
            return None
        values.append(sum(e["dur"] for e in tr.device_events(events) if e.get("cat") == "kernel"))
    if not values or not all(values):
        return None
    return sum(values) / len(values) / 1000.0
