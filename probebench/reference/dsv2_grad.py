"""dsv2_grad: DeepSeek-V2-Lite's first gradient, as the optimizer got it, by leaf norm.

``got``: the norm of each parameter's first gradient (the optimizer's first
moment after one step, over 1 - b1), in the recipe's order.  The number is
the worst leaf: |norm - reference's| over the reference's norm of that leaf
or of the median leaf, whichever is larger.  A token whose top-k choice
sits at a near tie can fall to another expert under rounding: that moves
the held experts' leaves by about one token's share of an expert's
gradient, which the limit allows.
"""

from probebench.reference import dsv2_lite

CHECK = "dsv2_grad_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = dsv2_lite.trained(args, idx, args["steps"], device)["grads"]
    return CHECK, dsv2_lite.worst_leaf_gap(got, want)


def control(args, idx, got, device):
    return dsv2_lite.trained(args, idx, args["steps"], device, "fp8")["grads"]
