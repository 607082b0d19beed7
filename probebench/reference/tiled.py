"""tiled: the tiled wgmma matmul probe, compared at its sampled entries.

``max |out - ref| / max(|ref|, 1)`` over the sampled entries of
``0.5 * a @ b``; the control takes fp8 operands.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "tiled_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = ref.tiled_entries(args["m"], args["k"], args["n"], idx, device)
    gap = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1.0)
    return CHECK, ref.worst(gap)


def control(args, idx, got, device):
    return ref.tiled_entries(args["m"], args["k"], args["n"], idx, device, "fp8")
