"""flash: the flash-attention probe, compared over its whole output.

``max |out - ref|`` against the causal softmax in float64; the control
passes q, k, v and the probabilities through fp8.
"""

import numpy as np

from probebench.reference import probes as ref

CHECK = "flash_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    want = ref.causal_attention(args["batch"], args["heads"], args["seq"],
                                args["head_dim"], device)[idx]
    return CHECK, ref.worst(np.abs(got.astype(np.float64) - want))


def control(args, idx, got, device):
    return ref.causal_attention(args["batch"], args["heads"], args["seq"], args["head_dim"],
                                device, "fp8")[idx]
