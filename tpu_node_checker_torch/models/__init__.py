"""Workload-level health probe: a real training step as the final grade.

A small but structurally realistic transformer
(:mod:`tpu_node_checker_torch.models.burnin`) trains for a few steps on one
card, with the hand-written flash-attention kernel in its forward pass;
healthy means a finite, strictly decreasing loss.  The sharded (data ×
tensor parallel) step of the JAX package is not ported yet.
"""

from tpu_node_checker_torch.models.burnin import (
    Burnin,
    BurninConfig,
    WorkloadResult,
    make_train_step,
    workload_probe,
)

__all__ = [
    "Burnin",
    "BurninConfig",
    "WorkloadResult",
    "make_train_step",
    "workload_probe",
]
