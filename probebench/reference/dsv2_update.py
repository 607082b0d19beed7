"""dsv2_update: DeepSeek-V2-Lite's change of each parameter over the steps, by leaf norm.

``got``: the norm of each parameter's change over the steps, read after
the last against its initial value drawn again by the recipe.  The number
is the worst leaf, as ``dsv2_grad``'s.
"""

from probebench.reference import dsv2_lite

CHECK = "dsv2_update_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = dsv2_lite.trained(args, idx, args["steps"], device)["change"]
    return CHECK, dsv2_lite.worst_leaf_gap(got, want)


def control(args, idx, got, device):
    return dsv2_lite.trained(args, idx, args["steps"], device, "fp8")["change"]
