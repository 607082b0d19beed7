"""The grading view of a node object, shared by the relist fast path.

The JAX package's ``watchstream.py`` holds the ``--watch-stream`` engine
(``NodeCache``, ``StreamRoundEngine``), which the port does not have yet.
Of it the port keeps :func:`grading_view`, the content address's preimage
that ``fastpath.grading_digest`` hashes, held equal to the original
function by function by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations


def grading_view(node: dict) -> tuple:
    """The grading-relevant projection of one raw node object.

    Everything ``detect.extract_node_info`` reads — name, labels,
    annotations, ``spec.unschedulable``/``spec.taints`` (NOT the rest of
    spec: podCIDR/providerID churn is invisible to grading), allocatable/
    capacity, and conditions MINUS their heartbeat timestamps.  Two nodes
    with equal views grade identically, so a MODIFIED event whose view is
    unchanged (a kubelet status heartbeat, a lease bump serialized onto
    the object) updates the cache without dirtying the node — the
    property that keeps steady-state ticks at O(changes) on a chatty API
    server.  This is also the preimage of the relist fast path's content
    address (``fastpath.grading_digest``), so a raw watch-event object and
    its projection-pruned twin hash identically by construction.
    """
    meta = node.get("metadata") if isinstance(node.get("metadata"), dict) else {}
    status = node.get("status") if isinstance(node.get("status"), dict) else {}
    spec = node.get("spec") if isinstance(node.get("spec"), dict) else {}
    conditions = status.get("conditions")
    cond_sig: tuple = ()
    if isinstance(conditions, list):
        cond_sig = tuple(
            (
                c.get("type"),
                c.get("status"),
                c.get("reason"),
                c.get("message"),
            )
            for c in conditions
            if isinstance(c, dict)
        )
    return (
        meta.get("name"),
        meta.get("labels"),
        meta.get("annotations"),
        spec.get("unschedulable"),
        spec.get("taints"),
        status.get("allocatable"),
        status.get("capacity"),
        cond_sig,
    )
