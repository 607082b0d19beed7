"""memtest: the pattern memtest's words, sampled, unequal to the pattern.

Exact: bit patterns, their own control.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "memtest_mismatches"
REDUCE = "sum"


def compare(args, idx, got, device):
    want = ref.memtest_expected(args["pattern"], idx)
    return CHECK, int(np.count_nonzero(got.astype(np.int32) != want))
