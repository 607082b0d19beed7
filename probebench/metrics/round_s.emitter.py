"""round_s.emitter: seconds per emitter round, the window's rounds back to back.

The host clock from the window's start to the end of its last round, less
the benchmark hook's own seconds in those rounds (starting the profiler,
sampling outputs, writing its capture at the child's exit), over the number
of rounds; a round that starts inside the window counts in full.
"""


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    hook = sum(run.overhead_s(r) for r in run.rounds)
    return (run.window_s - hook) / len(run.rounds)
