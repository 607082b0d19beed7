"""dsv2_step: DeepSeek-V2-Lite's step losses, each against the float32 reference.

The largest |loss - reference| / |reference| over the steps the program
returned (``got``), the reference trained from the recorded seed and
tokens (``idx``); the model, its steps and the control are ``dsv2_lite.py``'s.
"""

import numpy as np

from probebench.reference import dsv2_lite
from probebench.reference import probes as ref

CHECK = "dsv2_loss_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    got = np.asarray(got, dtype=np.float64)
    want = dsv2_lite.trained(args, idx, len(got), device)["losses"]
    return CHECK, ref.worst(np.abs(got - want) / np.abs(want))


def control(args, idx, got, device):
    return dsv2_lite.trained(args, idx, len(got), device, "fp8")["losses"]
