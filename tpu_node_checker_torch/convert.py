"""Carry the JAX package's probe inputs across to this package's tensors.

The state that crosses between the two packages is probe inputs and
outputs, and the burn-in model's parameters, as numpy arrays (``np.asarray``
of a JAX array).  Two numpy dtypes need care:

* bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  refuses: its bits are viewed as uint16, then int16, then reinterpreted as
  ``torch.bfloat16``;
* uint32 (the memtest words) is kept as int32 holding the same bits, since
  unsigned 32-bit arithmetic is sparse in torch.

Arrays from JAX are read-only, so every conversion copies before
``torch.from_numpy``.

:func:`burnin_shard` cuts a one-card burn-in state dict into one rank's
shard of the data × model sharded step.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_node_checker_torch.models.burnin import BurninConfig, shard_state
from tpu_node_checker_torch.ops._harness import DeviceLike
from tpu_node_checker_torch.parallel.mesh import MeshSpec


def to_torch(array, device: DeviceLike = "cpu") -> torch.Tensor:
    """A tensor on ``device`` with the values (or, for bf16/uint32, the bits)
    of ``array``."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32).copy())
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def burnin_state(params: dict) -> dict:
    """The burn-in model's state dict, on the CPU, from the JAX package's
    parameter pytree (``models.burnin.init_params``: nested dicts of arrays,
    the layers stacked on a leading axis), keys joined with ``.``."""
    state = {}
    for key, value in params.items():
        if isinstance(value, dict):
            state.update({f"{key}.{k}": v for k, v in burnin_state(value).items()})
        else:
            state[key] = to_torch(value)
    return state


def burnin_shard(state: dict, cfg: BurninConfig, mesh: MeshSpec, coords) -> dict:
    """The shard of a one-card burn-in state dict (:func:`burnin_state`)
    that the rank at ``coords`` of a ``("data", "model")`` mesh holds, by
    ``models.burnin.param_specs``: its block of every sharded parameter
    (the same on every ``data`` coordinate), the replicated ones whole."""
    model = mesh.axis_names.index("model")
    return shard_state(state, cfg, coords[model], mesh.shape[model])
