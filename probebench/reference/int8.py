"""int8: the int8 chain's int32 sums, sampled words unequal to the exact answer.

Exact: the inputs in [-8, 8) are what int4 holds too, so the answer is its
own control.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "int8_mismatches"
REDUCE = "sum"


def compare(args, idx, got, device):
    want = ref.int8_entries(args["m"], args["k"], args["n"], args["iters"], idx)
    return CHECK, int(np.count_nonzero(got.astype(np.int64) != want))
