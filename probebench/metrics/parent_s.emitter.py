"""parent_s.emitter: the emitter and probe parent's seconds a round.

Each window round's wall less the child's run from its process start to
its exit handlers (the benchmark hook's clock) and the hook's own work
there: spawning the child, its interpreter's teardown, the pipe, the parse,
the schema check and the atomic write; the mean over the window's rounds.
"""


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    values = [run.parent_s(r) for r in run.rounds]
    return None if None in values else sum(values) / len(values)
