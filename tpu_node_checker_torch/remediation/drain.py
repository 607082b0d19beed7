"""The drain actuator: evict-then-cordon, budget-gated, dry run first.

A copy of the JAX package's ``remediation/drain.py``, held equal to it by
``tests/test_torch_copies.py``.  ``--drain-failed`` evicts the node's pods
through the Eviction API, then cordons it.  Dry run is the default
(``--no-drain-dry-run`` evicts); a PodDisruptionBudget's refusal (409/429)
is a budget denial (``reason="pdb"``) and the node stays schedulable;
DaemonSet and mirror pods are skipped; each report carries the pod list and
the summed termination grace.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from tpu_node_checker_torch.remediation import actuate
from tpu_node_checker_torch.remediation.budget import BudgetEngine, Decision

_MIRROR_ANNOTATION = "kubernetes.io/config.mirror"
DEFAULT_GRACE_S = 30


def _evictable_pods(pods: List[dict]) -> List[dict]:
    out = []
    for pod in pods:
        if not isinstance(pod, dict):
            continue
        meta = pod.get("metadata") or {}
        if _MIRROR_ANNOTATION in (meta.get("annotations") or {}):
            continue
        owners = meta.get("ownerReferences") or []
        if any(o.get("kind") == "DaemonSet" for o in owners):
            continue
        phase = (pod.get("status") or {}).get("phase")
        if phase in ("Succeeded", "Failed"):
            continue  # already terminal: nothing to displace
        out.append(pod)
    return out


def _pod_grace(pod: dict) -> int:
    grace = (pod.get("spec") or {}).get("terminationGracePeriodSeconds")
    if isinstance(grace, int) and not isinstance(grace, bool) and grace >= 0:
        return grace
    return DEFAULT_GRACE_S


def _is_pdb_refusal(exc: Exception) -> bool:
    return getattr(exc, "status_code", None) in (409, 429)


def drain_node(
    client,
    node,
    decision: Decision,
    engine: BudgetEngine,
    events=None,
    trace_id: Optional[str] = None,
    api_concurrency: int = 1,
) -> Tuple[bool, dict]:
    """Drain ONE granted node → ``(drained, detail)``.

    ``detail`` always carries ``pods``/``grace_seconds_total``; on a PDB
    refusal ``drained`` is False and the refusal has already been recorded
    as a budget denial.  Any other eviction failure raises — the caller's
    per-node failure-note contract applies.
    """
    pods = _evictable_pods(client.list_node_pods(node.name))
    names = [
        f"{(p.get('metadata') or {}).get('namespace') or 'default'}/"
        f"{(p.get('metadata') or {}).get('name') or '?'}"
        for p in pods
    ]
    grace_total = sum(_pod_grace(p) for p in pods)
    detail = {"pods": names, "grace_seconds_total": grace_total}
    if decision.dry_run:
        return True, detail
    from tpu_node_checker_torch.utils.fanout import bounded_map

    # tnc: allow-exception-escape(bounded_map CAPTURES a worker's exception as its (False, exc) outcome — a refused eviction becomes the per-pod PDB/budget accounting below, never a silent death)
    def _evict_one(pod):
        meta = pod.get("metadata") or {}
        actuate.evict(
            client, decision,
            meta.get("namespace") or "default", meta.get("name") or "",
            grace_seconds=_pod_grace(pod), events=events, trace_id=trace_id,
        )

    evicted = 0
    for pod, (ok, err) in zip(
        pods, bounded_map(_evict_one, pods, api_concurrency)
    ):
        if ok:
            evicted += 1
            continue
        meta = pod.get("metadata") or {}
        pod_id = f"{meta.get('namespace') or 'default'}/{meta.get('name')}"
        if _is_pdb_refusal(err):
            # The cluster's PodDisruptionBudget refused: OUR budget denial
            # too.  Evictions already applied stay applied (they were
            # individually legal); the node is NOT cordoned — a partially
            # drained, still-schedulable node beats a cordoned node whose
            # remaining pods k8s refused to displace.
            engine.deny(
                "drain", node.name, decision.domain, "pdb",
                detail=f"eviction of {pod_id} refused by a "
                       f"PodDisruptionBudget ({evicted}/{len(pods)} pods "
                       "evicted before the refusal)",
            )
            detail["pods_evicted"] = evicted
            return False, detail
        raise err if isinstance(err, Exception) else RuntimeError(str(err))
    detail["pods_evicted"] = evicted
    actuate.cordon(client, decision, events=events, trace_id=trace_id)
    return True, detail


def drain_nodes(
    args,
    candidates: List,
    client,
    engine: BudgetEngine,
    events=None,
    trace_id: Optional[str] = None,
) -> dict:
    """The ``--drain-failed`` sweep over this round's eligible nodes.

    Candidates arrive pre-filtered by the SAME evidence rules the cordon
    sweep applies (real probe report, FSM-gated under ``--history``) —
    the budget engine then has the only remaining veto.  Returns the
    payload's ``drain`` report.
    """
    dry_run = bool(getattr(args, "drain_dry_run", True))
    report: dict = {
        "dry_run": dry_run,
        "drained": [],
        "failed": [],
        "pods_evicted": 0,
        "grace_seconds_total": 0,
    }
    if not candidates:
        return report
    concurrency = getattr(args, "api_concurrency", None) or 1
    for n in candidates:
        decision = engine.decide("drain", n, dry_run=dry_run)
        if not decision.allowed:
            continue  # recorded by the engine (denial list + event + counter)
        try:
            drained, detail = drain_node(
                client, n, decision, engine, events=events,
                trace_id=trace_id, api_concurrency=concurrency,
            )
        except Exception as exc:  # tnc: allow-broad-except(a failed eviction/PATCH is a per-node failure note, never fatal to the round — the cordon sweep's exact contract)
            report["failed"].append({"node": n.name, "error": str(exc)})
            print(f"Drain of {n.name} failed: {exc}", file=sys.stderr)
            continue
        report["pods_evicted"] += detail.get("pods_evicted", 0)
        report["grace_seconds_total"] += detail.get("grace_seconds_total", 0)
        if not drained:
            continue  # PDB refusal: recorded as a budget denial above
        if not dry_run:
            # Flag first, commit second: the engine's live budget math
            # reads node.cordoned, the preview counters cover dry runs.
            n.cordoned = True
        engine.commit(decision, node=n)
        if dry_run:
            report["drained"].append(n.name)
            print(
                f"[dry-run] would drain {n.name}: evict "
                f"{len(detail['pods'])} pod(s) "
                f"(grace {detail['grace_seconds_total']}s), then cordon",
                file=sys.stderr,
            )
        else:
            report["drained"].append(n.name)
            print(
                f"Drained {n.name}: {detail.get('pods_evicted', 0)} pod(s) "
                f"evicted (grace {detail['grace_seconds_total']}s), node "
                "cordoned.",
                file=sys.stderr,
            )
    report["drained"].sort()
    return report
