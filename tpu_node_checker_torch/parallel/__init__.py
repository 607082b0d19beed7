"""Rank groups and the fabric probes over ``torch.distributed``.

The port of the JAX package's data plane for one host: one rank per local
card on a flat axis (:mod:`.mesh`), and the probes that push collectives
and point-to-point traffic across the links between the cards: psum,
all_gather and reduce-scatter plus a ring walk (:mod:`.collectives`), and
ring attention, the sequence split over the ranks (:mod:`.ring_attention`).
The per-axis probes, pipeline and expert parallelism are not ported yet.
"""

from tpu_node_checker_torch.parallel.mesh import (
    MeshSpec,
    RankFailure,
    RankGroup,
    fold,
    local_device,
)
from tpu_node_checker_torch.parallel.collectives import (
    CollectiveResult,
    collective_probe,
    ring_probe,
)
from tpu_node_checker_torch.parallel.ring_attention import (
    RingAttentionResult,
    reference_causal_attention,
    ring_attention,
    ring_attention_probe,
    ring_attention_sharded,
)

__all__ = [
    "MeshSpec",
    "RankFailure",
    "RankGroup",
    "fold",
    "local_device",
    "CollectiveResult",
    "collective_probe",
    "ring_probe",
    "RingAttentionResult",
    "reference_causal_attention",
    "ring_attention",
    "ring_attention_probe",
    "ring_attention_sharded",
]
