"""Probe-level names and budgets — a leaf module with no heavy imports.

This package's copy of the JAX package's module of the same name: the port
imports nothing of the JAX package, so it keeps its own.  Keep the two in
step; tests/test_torch_probe.py holds them equal.

The CLI needs :data:`LEVELS` for its ``--probe-level`` choices at argparse
time; importing :mod:`.liveness` for that would pull ``subprocess`` /
``dataclasses`` / ``inspect`` (~8 ms) onto every cold start, probe or not.
Single source of truth: :mod:`.liveness` imports from here.
"""

from __future__ import annotations

LEVELS = ("enumerate", "compute", "collective", "mesh", "workload")
# Per-level wall-clock budgets: each level compiles and runs strictly more
# programs (first jit compile on TPU alone is ~20-40 s).  "mesh" adds one
# jitted single-pair ppermute per ICI link leg on top of "collective".
LEVEL_TIMEOUTS_S = {
    "enumerate": 30.0,
    "compute": 180.0,
    "collective": 300.0,
    "mesh": 450.0,
    "workload": 600.0,
}
DEFAULT_TIMEOUT_S = LEVEL_TIMEOUTS_S["enumerate"]
