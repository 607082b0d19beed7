"""burn_chain_roofline: the burn chain's least time over its device time, in %.

The chain is every kernel that the chain's CUDA graph launches in the traced
soak rounds (its products, rescales, casts and its checksum), matched to
the graph launch by correlation id.  Its least time is the products'
(``iters`` a launch), each the larger of 2 n^3 operations over the bf16 peak
and its bytes over the memory bandwidth (``probebench/roofline.py``).
"""

from probebench import roofline
from probebench import trace as tr


def read(run):
    soak = run.soak
    peak = roofline.peaks(run.device_kind)
    events = run.events(run.rounds[0]) if soak is not None else None
    if events is None or peak is None:
        return None
    launches, kernels = tr.launched_by_graphs(events, tr.annotations(events, "soak_burn_round"))
    device_s = sum(e["dur"] for e in kernels) / 1e6
    if not launches or device_s <= 0:
        return None
    flops, bytes_moved = roofline.chain_product_work(soak["n"])
    least_s = launches * soak["iters"] * roofline.least_seconds(flops, bytes_moved, peak)
    return 100.0 * least_s / device_s
