"""Rank groups, rank meshes and the fabric probes over ``torch.distributed``.

The port of the JAX package's data plane for one host: one rank per local
card (:mod:`.mesh`, whose :class:`RankMesh` lays named axes over the ranks,
each with the process groups of its lines), and the probes that push
collectives and point-to-point traffic across the links between the cards:
psum, all_gather and reduce-scatter, a ring walk, and one all_reduce per
mesh axis with its bus bandwidth (:mod:`.collectives`), ring attention with
the sequence split over the ranks (:mod:`.ring_attention`), a GPipe
pipeline over neighbour hops (:mod:`.pipeline`) and an expert-parallel MoE
layer over all_to_all (:mod:`.moe`).
"""

from tpu_node_checker_torch.parallel.mesh import (
    MeshSpec,
    RankFailure,
    RankGroup,
    RankMesh,
    build_mesh,
    flat_mesh,
    fold,
    hybrid_mesh,
    hybrid_spec,
    local_device,
    mesh_from_topology,
    topology_spec,
)
from tpu_node_checker_torch.parallel.collectives import (
    CollectiveResult,
    axis_bandwidth_probe,
    collective_probe,
    per_axis_probe,
    ring_probe,
)
from tpu_node_checker_torch.parallel.ring_attention import (
    RingAttentionResult,
    reference_causal_attention,
    ring_attention,
    ring_attention_probe,
    ring_attention_sharded,
)
from tpu_node_checker_torch.parallel.pipeline import (
    PipelineResult,
    pipeline_forward,
    pipeline_probe,
    pipeline_sharded,
    reference_pipeline,
)
from tpu_node_checker_torch.parallel.moe import (
    MoEResult,
    moe_forward,
    moe_probe,
    moe_sharded,
    reference_moe,
)

__all__ = [
    "MeshSpec",
    "RankFailure",
    "RankGroup",
    "RankMesh",
    "build_mesh",
    "flat_mesh",
    "fold",
    "hybrid_mesh",
    "hybrid_spec",
    "local_device",
    "mesh_from_topology",
    "topology_spec",
    "CollectiveResult",
    "axis_bandwidth_probe",
    "collective_probe",
    "per_axis_probe",
    "ring_probe",
    "RingAttentionResult",
    "reference_causal_attention",
    "ring_attention",
    "ring_attention_probe",
    "ring_attention_sharded",
    "PipelineResult",
    "pipeline_forward",
    "pipeline_probe",
    "pipeline_sharded",
    "reference_pipeline",
    "MoEResult",
    "moe_forward",
    "moe_probe",
    "moe_sharded",
    "reference_moe",
]
