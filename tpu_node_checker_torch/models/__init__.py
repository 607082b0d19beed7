"""Workload-level health probe: a real training step as the final grade.

A small but structurally realistic transformer
(:mod:`tpu_node_checker_torch.models.burnin`) trains for a few steps,
sharded data × tensor parallel over the cards of a rank group
(:func:`workload_mesh` picks the layout), or on one card with the
hand-written flash-attention kernel in its forward pass; healthy means a
finite, strictly decreasing loss.
"""

from tpu_node_checker_torch.models.burnin import (
    Burnin,
    BurninConfig,
    WorkloadResult,
    make_train_step,
    param_specs,
    shard_state,
    train_steps,
    workload_mesh,
    workload_probe,
)

__all__ = [
    "Burnin",
    "BurninConfig",
    "WorkloadResult",
    "make_train_step",
    "param_specs",
    "shard_state",
    "train_steps",
    "workload_mesh",
    "workload_probe",
]
