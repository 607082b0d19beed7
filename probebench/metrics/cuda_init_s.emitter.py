"""cuda_init_s.emitter: seconds of CUDA's start in the probe child a round.

The program's ``child.cuda_init`` spans, summed in each round: the driver's
start (``resolve_device``) and each card's context, created at its first
memory query; the mean over the window's rounds.
"""

from probebench import spans


def read(run):
    return spans.mean_round_s(run, "child.cuda_init")
