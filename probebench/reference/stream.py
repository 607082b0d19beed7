"""stream: the HBM stream's elements, sampled, unequal to the pass count.

Exact: small integers, their own control.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "stream_mismatches"
REDUCE = "sum"


def compare(args, idx, got, device):
    return CHECK, int(np.count_nonzero(got != ref.stream_expected(args["iters"])))
