"""burnin_grad: the burn-in step's first gradient, as the optimizer got it, by leaf norm.

``got``: the norm of each leaf of the rank's first gradient (its block of
each parameter, the data-parallel mean taken), worked out by the hook from
the optimizer's first moment after one step.  The number is the worst leaf:
|norm - reference's| over the reference's norm of that leaf or of the
median leaf, whichever is larger.
"""

from probebench.reference import burnin

CHECK = "workload_grad_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = burnin.leaf_norms(burnin.trained(args, idx, args["steps"], device)["grads"], args)
    return CHECK, burnin.worst_leaf_gap(got, want)


def control(args, idx, got, device):
    low = burnin.trained(args, idx, args["steps"], device, "fp8")["grads"]
    return burnin.leaf_norms(low, args)
