"""device_allocs.soak: the caching allocator's device allocations a soak round.

The program's ``num_device_alloc`` counter (the allocator's ``cudaMalloc``
calls from the first probe to the report, ``torch.cuda.memory_stats``) over
its ``soak_rounds``; the compute stage's few allocations count in too.
"""

from probebench import spans


def read(run):
    if run.traffic["window"] != "soak" or not run.rounds:
        return None
    r = run.rounds[0]
    allocs, rounds = spans.counter(r, "num_device_alloc"), spans.counter(r, "soak_rounds")
    if allocs is None or not rounds:
        return None
    return allocs / rounds
