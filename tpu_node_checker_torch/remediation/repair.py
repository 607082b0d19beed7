"""Repair hooks: ``--repair-cmd`` / ``--repair-webhook``.

A copy of the JAX package's ``remediation/repair.py``, held equal to it by
``tests/test_torch_copies.py``.  Once the hysteresis machine condemns a
node (FAILED or CHRONIC) and it sits in our quarantine, the hook fires
once: the command through the shell with ``TNC_NODE``, ``TNC_DOMAIN``,
``TNC_REASON`` and ``TNC_TRACE_ID`` set, or a JSON POST of the same facts.
Dry run is the default.  Each firing charges the disruption budget.  The
repair's state rides the history store as ``{"repair": {...}}`` lines, so
a restarted checker never fires twice; a started repair succeeds when the
node re-earns HEALTHY.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

from tpu_node_checker_torch.remediation.budget import BudgetEngine

REPAIR_CMD_TIMEOUT_S = 300.0
REPAIR_WEBHOOK_TIMEOUT_S = 10.0

STARTED = "started"
SUCCEEDED = "succeeded"
FAILED = "failed"


class RepairTracker:
    """Per-node repair state, persisted as history-store lines.

    Repair lines carry the node's current FSM snapshot alongside the
    ``repair`` object, so the FSM's tail-seeding (which trusts the LAST
    line's ``state``/``streak``) stays correct whichever line lands last.
    """

    def __init__(self, store=None):
        self.store = store
        self.state: Dict[str, dict] = {}
        # Lifetime counters for the metrics families.
        self.fired_total = 0
        self.succeeded_total = 0
        self.failed_total = 0
        if store is not None:
            for node, entries in store.by_node.items():
                for entry in entries:
                    rep = entry.get("repair")
                    if isinstance(rep, dict) and rep.get("state"):
                        self.state[node] = dict(rep)

    def in_flight(self, node: str) -> bool:
        return self.state.get(node, {}).get("state") == STARTED

    def _record(self, node: str, rep: dict, fsm=None) -> None:
        self.state[node] = rep
        if self.store is None:
            return
        entry = {"node": node, "ts": rep.get("ts"), "repair": rep}
        if fsm is not None and node in fsm.nodes:
            h = fsm.nodes[node]
            entry.update(state=h.state, streak=h.streak,
                         flaps_total=h.flaps_total)
        self.store.record(entry)

    def mark_started(self, node: str, via: str, fsm=None) -> None:
        self.fired_total += 1
        self._record(
            node, {"state": STARTED, "via": via, "ts": round(time.time(), 3)},
            fsm,
        )

    def mark_succeeded(self, node: str, fsm=None) -> None:
        self.succeeded_total += 1
        self._record(
            node, {"state": SUCCEEDED, "ts": round(time.time(), 3)}, fsm
        )

    def mark_failed(self, node: str, error: str, fsm=None) -> None:
        self.failed_total += 1
        self._record(
            node,
            {"state": FAILED, "ts": round(time.time(), 3),
             "error": error[:200]},
            fsm,
        )

    def roll_up(self) -> dict:
        """The payload block: in-flight repairs (with ages) + counters."""
        now = time.time()
        in_flight = sorted(
            n for n, rep in self.state.items() if rep.get("state") == STARTED
        )
        oldest_age = 0.0
        for n in in_flight:
            ts = self.state[n].get("ts")
            if isinstance(ts, (int, float)) and now >= ts:
                oldest_age = max(oldest_age, now - ts)
        return {
            "in_flight": in_flight,
            "oldest_age_s": round(oldest_age, 1),
            "fired_total": self.fired_total,
            "succeeded_total": self.succeeded_total,
            "failed_total": self.failed_total,
        }


def _fire_cmd(cmd: str, env_extra: Dict[str, str]) -> None:
    import os

    env = dict(os.environ)
    env.update(env_extra)
    result = subprocess.run(
        cmd, shell=True, env=env, capture_output=True, text=True,
        timeout=REPAIR_CMD_TIMEOUT_S,
    )
    if result.returncode != 0:
        raise RuntimeError(
            f"repair command exited {result.returncode}: "
            f"{(result.stderr or result.stdout or '').strip()[:200]}"
        )


def _fire_webhook(url: str, body: dict, session=None) -> None:
    if session is not None:  # caller-owned: its lifetime is the caller's
        _post_webhook(session, url, body)
        return
    from tpu_node_checker_torch.cluster import _StdlibSession

    session = _StdlibSession()
    try:
        _post_webhook(session, url, body)
    finally:
        session.close()


def _post_webhook(session, url: str, body: dict) -> None:
    resp = session.post(
        url, data=json.dumps(body),
        headers={"Content-Type": "application/json"},
        timeout=REPAIR_WEBHOOK_TIMEOUT_S,
    )
    resp.raise_for_status()


def run_repairs(
    args,
    accel: List,
    engine: BudgetEngine,
    tracker: RepairTracker,
    fsm=None,
    events=None,
    trace_id: Optional[str] = None,
    webhook_session=None,
) -> dict:
    """The per-round repair sweep → the payload's ``repair`` report.

    Two passes: (1) close the loop on earlier repairs — a started repair
    whose node re-earned HEALTHY is recorded ``succeeded``; (2) fire new
    repairs for condemned, quarantined-by-us nodes that have none in
    flight, budget-gated per firing.
    """
    from tpu_node_checker_torch.history.fsm import CHRONIC
    from tpu_node_checker_torch.history.fsm import FAILED as FSM_FAILED

    dry_run = bool(getattr(args, "repair_dry_run", True))
    cmd = getattr(args, "repair_cmd", None)
    webhook = getattr(args, "repair_webhook", None)
    report: dict = {"dry_run": dry_run, "started": [], "completed": [],
                    "failed": []}
    by_name = {n.name: n for n in accel}
    for name in sorted(tracker.state):
        if not tracker.in_flight(name):
            continue
        node = by_name.get(name)
        healthy = (
            node is not None
            and not node.cordoned
            and node.effectively_ready
        ) or (
            fsm is not None and fsm.uncordon_eligible(name)
        )
        if healthy:
            tracker.mark_succeeded(name, fsm)
            report["completed"].append(name)
            if events is not None:
                events.emit("remediation-repair-succeeded",
                            trace_id=trace_id, node=name)
    condemned = [
        n for n in accel
        if n.quarantined_by_us
        and fsm is not None
        and fsm.health(n.name).state in (FSM_FAILED, CHRONIC)
        and not tracker.in_flight(n.name)
    ]
    via = "cmd" if cmd else "webhook"
    to_fire = []
    for n in condemned:
        decision = engine.decide("repair", n, dry_run=dry_run)
        if not decision.allowed:
            continue  # engine recorded the denial
        reason = fsm.health(n.name).state if fsm is not None else "failed"
        if dry_run:
            engine.commit(decision, node=n)
            report["started"].append(n.name)
            print(
                f"[dry-run] would fire {via} repair for {n.name} "
                f"(state {reason})",
                file=sys.stderr,
            )
            if events is not None:
                events.emit("remediation-repair", trace_id=trace_id,
                            node=n.name, via=via, dry_run=True)
            continue
        to_fire.append((n, decision, reason))
    if to_fire:
        from tpu_node_checker_torch.utils.fanout import bounded_map

        # tnc: allow-exception-escape(bounded_map CAPTURES a worker's exception as its (False, exc) outcome — a failed hook becomes tracker.mark_failed + a report entry below, never a silent death)
        def _fire(item):
            n, decision, reason = item
            if cmd:
                _fire_cmd(cmd, {
                    "TNC_NODE": n.name,
                    "TNC_DOMAIN": decision.domain or "",
                    "TNC_REASON": reason,
                    "TNC_TRACE_ID": trace_id or "",
                })
            else:
                _fire_webhook(webhook, {
                    "node": n.name,
                    "domain": decision.domain,
                    "reason": reason,
                    "trace_id": trace_id,
                }, session=webhook_session)

        # Hooks fan out over the bounded pool (--api-concurrency), so a
        # storm's worth of wedged ticketing backends costs the round
        # ~max(one hook timeout), never the sum — the same wall-clock
        # discipline as the PATCH/events fan-outs.  Outcomes come back in
        # input order: tracker lines and stderr notes stay deterministic.
        workers = getattr(args, "api_concurrency", None) or 4
        outcomes = bounded_map(_fire, to_fire, workers)
        for (n, decision, reason), (ok, err) in zip(to_fire, outcomes):
            if not ok:
                tracker.mark_failed(n.name, str(err), fsm)
                report["failed"].append({"node": n.name, "error": str(err)})
                print(f"Repair hook for {n.name} failed: {err}",
                      file=sys.stderr)
                if events is not None:
                    events.emit("remediation-repair-failed",
                                trace_id=trace_id, node=n.name, via=via,
                                error=str(err)[:200])
                continue
            engine.commit(decision, node=n)
            tracker.mark_started(n.name, via, fsm)
            report["started"].append(n.name)
            print(f"Repair {via} fired for {n.name} (state {reason}).",
                  file=sys.stderr)
            if events is not None:
                events.emit("remediation-repair", trace_id=trace_id,
                            node=n.name, via=via)
    engine.repairs = tracker.roll_up()
    return report
