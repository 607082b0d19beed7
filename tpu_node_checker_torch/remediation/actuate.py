"""The one module that calls the cluster's actuators.

A copy of the JAX package's ``remediation/actuate.py``, held equal to it by
``tests/test_torch_copies.py``.  Every function takes a granted
:class:`~tpu_node_checker_torch.remediation.budget.Decision`, refuses to
run without one, and emits one audit event per actuation.  Exceptions
propagate: the sweeps turn a failed PATCH into a per-node note.
"""

from __future__ import annotations

from typing import Optional

from tpu_node_checker_torch.remediation.budget import Decision


def _require(decision: Decision, action: str) -> None:
    if not isinstance(decision, Decision) or not decision.allowed:
        raise ValueError(
            f"{action} without a granted budget decision — every actuator "
            "call rides BudgetEngine.decide() (TNC019)"
        )


def _audit(events, kind: str, decision: Decision,
           trace_id: Optional[str], **fields) -> None:
    if events is None:
        return
    events.emit(
        kind,
        trace_id=trace_id,
        node=decision.node,
        domain=decision.domain,
        reason=decision.reason,
        dry_run=decision.dry_run or None,
        **fields,
    )


def cordon(client, decision: Decision, events=None,
           trace_id: Optional[str] = None) -> None:
    """``spec.unschedulable=true`` + the quarantine annotation."""
    _require(decision, "cordon")
    client.cordon_node(decision.node)
    _audit(events, "remediation-cordon", decision, trace_id)


def uncordon(client, decision: Decision, events=None,
             trace_id: Optional[str] = None) -> None:
    """Lift one of OUR quarantines (capacity-restoring: always granted)."""
    _require(decision, "uncordon")
    client.uncordon_node(decision.node)
    _audit(events, "remediation-uncordon", decision, trace_id)


def clear_annotation(client, decision: Decision, events=None,
                     trace_id: Optional[str] = None) -> None:
    """Drop a stale quarantine annotation (out-of-band uncordon hygiene)."""
    _require(decision, "clear-annotation")
    client.clear_quarantine_annotation(decision.node)
    _audit(events, "remediation-clear-annotation", decision, trace_id)


def evict(client, decision: Decision, namespace: str, pod: str,
          grace_seconds: Optional[int] = None, events=None,
          trace_id: Optional[str] = None) -> None:
    """One Eviction-API POST for one pod of a draining node.

    The audit line is per POD — a drain's blast radius is its pod list,
    and "which workload did the drain displace" must be answerable from
    the event log alone.
    """
    _require(decision, "evict")
    client.evict_pod(namespace, pod, grace_seconds=grace_seconds)
    _audit(events, "remediation-evict", decision, trace_id,
           namespace=namespace, pod=pod, grace_seconds=grace_seconds)
