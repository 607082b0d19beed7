"""burnin_step: the burn-in training step's losses, each against float64.

The largest |loss - reference| / |reference| over the steps a rank
returned (``got``), from the inputs the hook recorded (``idx``); the model,
its steps and the control are ``burnin.py``'s.
"""

import numpy as np

from probebench.reference import burnin
from probebench.reference import probes as ref

CHECK = "workload_loss_gap"
REDUCE = "max"


def compare(args, idx, got, device):
    got = np.asarray(got, dtype=np.float64)
    want = burnin.trained(args, idx, len(got), device)["losses"]
    return CHECK, ref.worst(np.abs(got - want) / np.abs(want))


def control(args, idx, got, device):
    return burnin.trained(args, idx, len(got), device, "fp8")["losses"]
