"""child_import_s.emitter: the probe child's start-up seconds a round.

From the child's process start (``/proc``) to its first probe, timed by the
benchmark's hook in the child: the interpreter, ``import torch``, the
port's imports, the CUDA context and loading the built kernels; the mean
over the window's rounds.
"""


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    values = [run.child_startup_s(r) for r in run.rounds]
    return None if None in values else sum(values) / len(values)
