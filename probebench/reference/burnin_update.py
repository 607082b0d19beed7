"""burnin_update: the burn-in steps' change of each parameter, by leaf norm.

``got``: the norm of each leaf's change over the rank's steps (its block of
each parameter), as the hook read it after the last step.  The number is
the worst leaf, as ``burnin_grad``'s, over the leaves whose reference
gradient is at least a thousandth of the median leaf's (``burnin.
STILL_LEAF``): a leaf below it moves under Adam by round-off alone.
"""

import numpy as np

from probebench.reference import burnin

CHECK = "workload_update_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    done = burnin.trained(args, idx, args["steps"], device)
    grads = burnin.leaf_norms(done["grads"], args)
    keep = grads >= burnin.STILL_LEAF * np.median(grads)
    return CHECK, burnin.worst_leaf_gap(got, burnin.leaf_norms(done["change"], args), keep)


def control(args, idx, got, device):
    low = burnin.trained(args, idx, args["steps"], device, "fp8")["change"]
    return burnin.leaf_norms(low, args)
