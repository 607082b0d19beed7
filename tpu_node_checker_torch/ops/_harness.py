"""Shared scaffold for the kernel cross-check probes.

Every probe follows one shape: resolve the target device, then warm up once
(the first launch also builds the kernel), then time a second run with a
synchronise plus a scalar fetch as the completion barrier.  Kept here so the
probes cannot drift apart on the device or timing rules.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The probe device: ``cuda:0`` unless the caller names another.

    ``cpu`` runs only when asked for.  A CUDA device that is asked for (or
    defaulted to) and absent raises: a probe must never grade a host healthy
    on the CPU because its card is gone.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA device {dev} requested but torch.cuda.is_available() is "
                "False (no NVIDIA card visible to this process)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported probe device {dev}: expected cuda or cpu")
    return dev


def is_cpu(device: DeviceLike) -> bool:
    """Whether the caller asked for the CPU (the plain versions run there)."""
    return device is not None and str(device).split(":")[0] == "cpu"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(fn, *args) -> Tuple[torch.Tensor, float, float]:
    """(output, checksum, steady-state ms) for ``fn(*args)``.

    The first call warms up (and builds the kernel); the timed second call
    ends in ``torch.cuda.synchronize()`` plus a scalar ``.item()``, so the
    clock stops only when the work is done.
    """
    out = fn(*args)
    sync(out.device)
    checksum = float(out.float().sum().item())
    t0 = time.perf_counter()
    out = fn(*args)
    sync(out.device)
    checksum = float(out.float().sum().item())
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    return out, checksum, elapsed_ms
