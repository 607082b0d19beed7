"""torch_import_s.emitter: seconds of the probe child's ``import torch`` a round.

The program's ``child.import_torch`` span, the mean over the window's rounds.
"""

from probebench import spans


def read(run):
    return spans.mean_round_s(run, "child.import_torch")
