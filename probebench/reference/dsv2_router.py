"""dsv2_router: DeepSeek-V2-Lite's router logits, against float64.

``idx``: the hidden states of the sampled tokens at the first MoE layer of
the first step (``rows`` x ``hidden``), then the router's weight
(``hidden`` x ``experts``), as the program held them; ``got``: the
program's logits for those tokens.  The number is the largest |logit -
reference| over the largest |reference logit|.  The configuration states
the router in f32 (as ``modeling_deepseek.py`` computes it); the control
takes its product from bf16 operands with a bf16 result, one precision
below, as a router run in the activations' dtype would.
"""

import numpy as np
import torch

from probebench.reference import probes as ref

CHECK = "dsv2_router_gap"
REDUCE = "max"


def _operands(args, idx):
    n, d = args["rows"] * args["hidden"], args["hidden"] * args["experts"]
    flat = np.asarray(idx, dtype=np.float64)
    if flat.size != n + d:
        raise ValueError(f"dsv2_router: {flat.size} recorded values, the layout needs {n + d}")
    x = flat[:n].reshape(args["rows"], args["hidden"])
    return x, flat[n:].reshape(args["hidden"], args["experts"])


def compare(args, idx, got, device):
    x, w = _operands(args, idx)
    want = x @ w
    gap = np.abs(np.asarray(got, dtype=np.float64) - want) / np.abs(want).max()
    return CHECK, ref.worst(gap.reshape(-1))


def control(args, idx, got, device):
    x, w = _operands(args, idx)
    low = torch.from_numpy(x).to(device, torch.bfloat16) @ torch.from_numpy(w).to(
        device, torch.bfloat16)
    return low.float().cpu().numpy()
