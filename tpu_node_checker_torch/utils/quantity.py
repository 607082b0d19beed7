"""Kubernetes resource-quantity parsing.

The reference converts capacity values with a bare ``int(str(val))`` and
silently drops anything that fails (check-gpu-node.py:191-195).  Accelerator
counts are in practice plain integers, but kubelet is allowed to serialize any
quantity with binary (Ki/Mi/...) or decimal (k/M/.../m) suffixes, so this
parser understands the full quantity grammar and rounds to whole devices.
Unparseable values still degrade to ``None`` (dropped by the caller) to keep
the reference's defensive behavior.

A copy of the JAX package's ``utils/quantity.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import Optional

_BINARY_SUFFIXES = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL_SUFFIXES = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}


def parse_quantity(raw: object) -> Optional[int]:
    """Parse a k8s quantity into a device count (int), or None if unparseable.

    Fractional results (e.g. the milli-suffix ``"500m"``) floor to whole
    devices; a quantity below one device parses to 0 and is treated as absent
    by callers, matching the truthiness gate at check-gpu-node.py:190.
    """
    if raw is None:
        return None
    if isinstance(raw, bool):  # bool is an int subclass; reject explicitly
        return None
    if isinstance(raw, int):
        return raw
    if isinstance(raw, float):
        try:
            return int(raw)
        except (OverflowError, ValueError):  # inf/nan (json.load accepts them)
            return None
    s = str(raw).strip()
    if not s:
        return None
    for suffix, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suffix):
            return _scaled(s[: -len(suffix)], mult)
    if s.endswith("m"):  # milli — must check before decimal "M"
        return _scaled(s[:-1], 1e-3)
    for suffix, mult in _DECIMAL_SUFFIXES.items():
        if s.endswith(suffix):
            return _scaled(s[: -len(suffix)], mult)
    return _scaled(s, 1)


def _scaled(num: str, mult: float) -> Optional[int]:
    try:
        return int(float(num) * mult)
    except (ValueError, OverflowError):
        return None
