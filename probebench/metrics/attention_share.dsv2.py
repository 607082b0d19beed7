"""attention_share.dsv2: MLA attention's share of a DeepSeek-V2-Lite step's card time, in %.

The card time of the kernels, copies and fills launched inside the
program's ``tnc:mla.attention`` ranges (the scores, mask, softmax and P·V
of each sequence, in the forward pass, its recomputation and the backward)
within the training steps, over the steps' card time (``ranges.py``); the
mean over the window's rounds.  Nothing where the program opens no such
range (a program without the model, or a step of another model).
"""

from probebench.ranges import step_share


def read(run):
    return step_share(run, ("mla.attention",))
