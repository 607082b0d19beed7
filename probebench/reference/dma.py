"""dma: the bulk-copy stream's ``2x + 1``, sampled words unequal to float32's.

The control takes ``x`` rounded to bf16, the step below float32.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "dma_mismatches"
REDUCE = "sum"


def compare(args, idx, got, device):
    want = ref.dma_expected(args["rows"], args["cols"], idx, device)
    return CHECK, int(np.count_nonzero(got != want))


def control(args, idx, got, device):
    return ref.dma_expected(args["rows"], args["cols"], idx, device, "bf16")
