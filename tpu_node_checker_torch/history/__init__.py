"""Per-node health history: durable store + hysteresis state machine.

The layer between probing and remediation (DESIGN.md §9).  Everything in
this package is reached only through ``--history FILE`` (or the fleet
API's standalone ``--serve`` mode, which reads a store another process
writes); without those flags the checker's per-round behavior is
untouched.

A copy of the JAX package's ``history/__init__.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from tpu_node_checker_torch.history.fsm import (  # noqa: F401
    CHRONIC,
    DEGRADED,
    DEFAULT_CORDON_AFTER,
    DEFAULT_FLAP_THRESHOLD,
    DEFAULT_FLAP_WINDOW,
    DEFAULT_UNCORDON_AFTER,
    FAILED,
    HEALTHY,
    HealthFSM,
    RECOVERING,
    SUSPECT,
)
from tpu_node_checker_torch.history.store import (  # noqa: F401
    DEFAULT_MAX_ROUNDS,
    HISTORY_SCHEMA_VERSION,
    HistoryStore,
    file_signature,
    read_jsonl_tolerant,
)
