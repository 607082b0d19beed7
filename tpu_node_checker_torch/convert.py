"""Carry the JAX package's probe inputs across to this package's tensors.

The system has no weights: the state that crosses between the two packages
is probe inputs and outputs, as numpy arrays (``np.asarray`` of a JAX array).
Two numpy dtypes need care:

* bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  refuses: its bits are viewed as uint16, then int16, then reinterpreted as
  ``torch.bfloat16``;
* uint32 (the memtest words) is kept as int32 holding the same bits, since
  unsigned 32-bit arithmetic is sparse in torch.

Arrays from JAX are read-only, so every conversion copies before
``torch.from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_node_checker_torch.ops._harness import DeviceLike


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

