"""The invariant acceptance matrix: every cross-tier contract the chaos
scenarios grade, as pure functions over a completed run's ground truth.

A copy of the JAX package's ``sim/invariants.py``, held equal to it by
``tests/test_torch_copies.py``.  Each check returns a :class:`Verdict`
``(name, ok, detail)`` whose detail is deterministic (node names, counts,
round indices).  Actuation invariants read what the simulated API server
received, never the checker's own account; grading invariants read the
payloads the checker produced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from tpu_node_checker_torch.history.fsm import (
    CHRONIC,
    FAILED,
    HEALTHY,
    RECOVERING,
    STATES,
    SUSPECT,
)

# Every edge HealthFSM.observe can legally take (DESIGN.md §9).  A
# transition outside this map means the hysteresis machine was corrupted —
# e.g. CHRONIC healing without the out-of-band human override, or SUSPECT
# jumping straight to RECOVERING without ever being condemned.
LEGAL_FSM_TRANSITIONS: Dict[str, set] = {
    HEALTHY: {SUSPECT, FAILED, CHRONIC},
    SUSPECT: {HEALTHY, FAILED, CHRONIC},
    FAILED: {RECOVERING, HEALTHY, CHRONIC},
    RECOVERING: {HEALTHY, SUSPECT, FAILED, CHRONIC},
    CHRONIC: {RECOVERING},
}


@dataclass(frozen=True)
class Verdict:
    """One invariant's outcome over one scenario run."""

    name: str
    ok: bool
    detail: str

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "detail": self.detail}


def _fail(name: str, detail: str) -> Verdict:
    return Verdict(name, False, detail)


def _ok(name: str, detail: str) -> Verdict:
    return Verdict(name, True, detail)


def check_exit_codes(records: Sequence[dict],
                     expected: Optional[Sequence[int]] = None,
                     allowed: Iterable[int] = (0, 1, 2, 3)) -> Verdict:
    """The exit-code contract: every round's code sits inside the
    documented 0/1/2/3 ladder (and the scenario's ``allowed`` subset), the
    JSON payload's ``exit_code`` agrees with the process verdict, and —
    when the scenario can compute one — the per-round ``expected``
    sequence matches exactly."""
    name = "exit-code-contract"
    allowed = set(allowed)
    for r in records:
        if r["exit_code"] not in (0, 1, 2, 3):
            return _fail(name, f"round {r['round']} cluster {r['cluster']}: "
                               f"exit {r['exit_code']} outside the contract")
        if r["exit_code"] not in allowed:
            return _fail(name, f"round {r['round']} cluster {r['cluster']}: "
                               f"exit {r['exit_code']} not in allowed "
                               f"{sorted(allowed)}")
        payload_code = r.get("payload_exit_code")
        if payload_code is not None and payload_code != r["exit_code"]:
            return _fail(name, f"round {r['round']}: payload exit_code "
                               f"{payload_code} != verdict {r['exit_code']}")
    if expected is not None:
        got = [r["exit_code"] for r in records]
        if list(expected) != got:
            return _fail(name, f"expected per-round codes {list(expected)}, "
                               f"got {got}")
    return _ok(name, f"{len(records)} rounds within the contract"
                     + ("" if expected is None else ", matching the oracle"))


def check_disruption_budget(patches_per_round: Sequence[int],
                            budget: int) -> Verdict:
    """Never past budget: per-round actuations counted SERVER-SIDE."""
    name = "disruption-budget"
    over = [(i, n) for i, n in enumerate(patches_per_round) if n > budget]
    if over:
        return _fail(name, f"rounds over the {budget}/round budget "
                           f"(round, patches): {over}")
    return _ok(name, f"max {max(patches_per_round, default=0)} actuations "
                     f"per round within budget {budget}")


def check_slice_floor(floor_timeline: Sequence[Dict[str, int]],
                      floor_chips: int) -> Verdict:
    """Never below floor: per-slice AVAILABLE chips from the apiserver's
    live node state after every round."""
    name = "slice-floor"
    breaches = [
        (i, pool, chips)
        for i, by_slice in enumerate(floor_timeline)
        for pool, chips in sorted(by_slice.items())
        if chips < floor_chips
    ]
    if breaches:
        return _fail(name, f"slices below the {floor_chips}-chip floor "
                           f"(round, slice, chips): {breaches}")
    worst = min(
        (chips for by_slice in floor_timeline for chips in by_slice.values()),
        default=floor_chips,
    )
    return _ok(name, f"no slice below {floor_chips} chips "
                     f"(observed floor {worst})")


def check_fsm_legality(records: Sequence[dict]) -> Verdict:
    """Every hysteresis transition the rounds recorded is a legal edge of
    the HEALTHY→SUSPECT→FAILED→RECOVERING machine (CHRONIC only exits via
    the out-of-band override)."""
    name = "fsm-legality"
    seen = 0
    for r in records:
        for t in r.get("transitions") or []:
            node, _, edge = t.partition(":")
            src, _, dst = edge.partition(">")
            seen += 1
            if src not in STATES or dst not in STATES:
                return _fail(name, f"round {r['round']}: unknown state in "
                                   f"transition {t!r}")
            if src == dst:
                return _fail(name, f"round {r['round']}: self-transition "
                                   f"{t!r} recorded (observe only logs "
                                   "changes)")
            if dst not in LEGAL_FSM_TRANSITIONS[src]:
                return _fail(name, f"round {r['round']}: illegal edge "
                                   f"{src}->{dst} on {node}")
    return _ok(name, f"{seen} transitions, all legal edges")


def check_breaker_legality(timeline: Sequence[dict], threshold: int,
                           max_scale: int) -> Verdict:
    """The watch breaker's state machine stayed legal over the scripted
    outage: open iff the failure streak reached the threshold, the
    interval ladder doubles from 2 and caps, events fire exactly on
    transitions."""
    name = "breaker-legality"
    for i, s in enumerate(timeline):
        cf, is_open, scale, event = (s["consecutive_failures"], s["open"],
                                     s["interval_scale"], s["event"])
        should_open = cf >= threshold
        if is_open != should_open:
            return _fail(name, f"step {i}: open={is_open} with "
                               f"{cf} consecutive failures "
                               f"(threshold {threshold})")
        want_scale = (min(max_scale, 2 ** (cf - threshold + 1))
                      if is_open else 1)
        if scale != want_scale:
            return _fail(name, f"step {i}: interval scale {scale} != "
                               f"ladder value {want_scale}")
        prev_open = timeline[i - 1]["open"] if i else False
        want_event = ("opened" if is_open and not prev_open
                      else "closed" if prev_open and not is_open else None)
        if event != want_event:
            return _fail(name, f"step {i}: event {event!r} != "
                               f"expected {want_event!r}")
    opened = sum(1 for s in timeline if s["event"] == "opened")
    return _ok(name, f"{len(timeline)} steps legal; opened {opened}x")


def check_slack_dedup(records: Sequence[dict], max_alerts: int) -> Verdict:
    """The --slack-on-change fingerprint (exit code, debounced sick set,
    denial pair-set) fires only on CHANGES: a standing storm is one alert,
    not one per round."""
    name = "slack-dedup"
    alerts = 0
    prev = None
    for r in records:
        fp = (r["exit_code"], tuple(r.get("sick") or ()),
              tuple(r.get("denials") or ()))
        if fp != prev:
            alerts += 1
        prev = fp
    if alerts > max_alerts:
        return _fail(name, f"{alerts} fingerprint changes over "
                           f"{len(records)} rounds exceeds the scenario's "
                           f"{max_alerts}-alert bound — standing conditions "
                           "are re-alerting")
    return _ok(name, f"{alerts} alert-worthy changes over "
                     f"{len(records)} rounds (bound {max_alerts})")


def check_denials_visible(records: Sequence[dict],
                          from_round: int) -> Verdict:
    """Refusals are visible: every round from the storm's onset records at
    least one budget denial pair — bounded actuation must never read as
    'nothing to do'."""
    name = "denials-visible"
    silent = [r["round"] for r in records
              if r["round"] >= from_round and not r.get("denials")]
    if silent:
        return _fail(name, f"rounds {silent} actuated under pressure with "
                           "no recorded denial")
    pairs = sorted({d for r in records for d in (r.get("denials") or ())})
    return _ok(name, f"denial pairs recorded from round {from_round}: "
                     f"{pairs}")


def check_staleness_labels(timeline: Sequence[dict], dead_cluster: str,
                           death_round: int) -> Verdict:
    """Shard-degraded-never-fleet: after the partition, the dead cluster is
    labeled stale with monotonically growing staleness, its last-known
    nodes stay counted, and the global view keeps serving healthy."""
    name = "staleness-labels"
    for s in timeline:
        r = s["round"]
        if r < death_round:
            if s["degraded_clusters"]:
                return _fail(name, f"round {r}: degraded clusters "
                                   f"{s['degraded_clusters']} before the "
                                   "partition")
            continue
        if s["degraded_clusters"] != [dead_cluster]:
            return _fail(name, f"round {r}: degraded clusters "
                               f"{s['degraded_clusters']} != "
                               f"[{dead_cluster!r}]")
        want_stale = r - death_round + 1
        if s["staleness_rounds"] != want_stale:
            return _fail(name, f"round {r}: staleness {s['staleness_rounds']}"
                               f" rounds != {want_stale} (must grow per "
                               "round)")
        if not s["healthy"]:
            return _fail(name, f"round {r}: global healthy flipped false — "
                               "a dead shard degraded the fleet")
        if s["total_nodes"] != timeline[0]["total_nodes"]:
            return _fail(name, f"round {r}: total_nodes "
                               f"{s['total_nodes']} dropped the dead "
                               "shard's last-known nodes")
    return _ok(name, f"{dead_cluster!r} stale from round {death_round}, "
                     "staleness monotone, fleet healthy throughout")


def check_prediction_precedes_failure(records: Sequence[dict],
                                      flappers: Sequence[str]) -> Verdict:
    """Prediction beats the FSM: every ground-truth flapper is flagged by
    the changepoint detector, and the flagging round strictly precedes
    the node's first FSM FAILED **and** first CHRONIC (when either
    happens at all) — SUSPECT-by-prediction must land ≥1 round before any
    condemnation the hysteresis machine reaches on its own evidence."""
    name = "prediction-precedes-failure"
    detected: Dict[str, int] = {}
    condemned: Dict[str, Dict[str, int]] = {}
    for r in records:
        for node in r.get("predictions") or ():
            detected.setdefault(node, r["round"])
        for t in r.get("transitions") or ():
            node, _, edge = t.partition(":")
            _src, _, dst = edge.partition(">")
            if dst in (FAILED, CHRONIC):
                condemned.setdefault(node, {}).setdefault(dst, r["round"])
    timeline = {}
    for node in flappers:
        d = detected.get(node)
        if d is None:
            return _fail(name, f"flapper {node} was never flagged by the "
                               "changepoint detector")
        for dst, c in sorted(condemned.get(node, {}).items()):
            if d >= c:
                return _fail(name, f"flapper {node} flagged round {d}, "
                                   f"but first {dst} was round {c} — "
                                   "prediction must lead by ≥1 round")
        timeline[node] = (d, condemned.get(node, {}))
    lead = [
        min(c for c in cond.values()) - d
        for d, cond in timeline.values() if cond
    ]
    if not lead:
        return _fail(name, "no flapper was ever condemned (FAILED or "
                           "CHRONIC): the scenario graded nothing")
    return _ok(name, f"{len(flappers)} flappers flagged ahead of "
                     f"condemnation (lead rounds: min {min(lead)}, "
                     f"max {max(lead)})")


def check_degraded_link_named(timeline: Sequence[dict], host: str,
                              link: str, onset: int) -> Verdict:
    """The mesh link doctor's first promise: a DEGRADED verdict always
    NAMES the slow link.  From the onset round on, the remediation budget
    view's degraded block must carry exactly the torn host and a
    slice-qualified name ending in the ground-truth link; before onset it
    must be empty — phantom evidence would be its own bug."""
    name = "degraded-link-named"
    named = None
    for s in timeline:
        r = s["round"]
        if r < onset:
            if s["nodes"] or s["links"]:
                return _fail(name, f"round {r}: degraded evidence "
                                   f"(nodes={s['nodes']} links={s['links']})"
                                   " before the link tore")
            continue
        if s["nodes"] != [host]:
            return _fail(name, f"round {r}: degraded nodes {s['nodes']} != "
                               f"[{host!r}]")
        if len(s["links"]) != 1 or not s["links"][0].endswith("/" + link):
            return _fail(name, f"round {r}: degraded links {s['links']} do "
                               f"not name the torn link {link!r}")
        named = s["links"][0]
    if named is None:
        return _fail(name, f"no round at or past onset {onset}: the "
                           "scenario graded nothing")
    return _ok(name, f"{named!r} named on {host} every round from {onset}")


def check_degraded_not_condemned(records: Sequence[dict],
                                 hosts: Sequence[str]) -> Verdict:
    """DEGRADED is capacity-quality evidence, never condemnation: a host
    whose only fault is a slow ICI link must never transition to FAILED
    or CHRONIC — the FSM holds state on degraded rounds (link drift may
    promote to SUSPECT, nothing more)."""
    name = "degraded-not-condemned"
    torn = set(hosts)
    held = 0
    for r in records:
        for t in r.get("transitions") or ():
            node, _, edge = t.partition(":")
            _src, _, dst = edge.partition(">")
            if node in torn and dst in (FAILED, CHRONIC):
                return _fail(name, f"round {r['round']}: degraded host "
                                   f"{node} condemned {dst} — a slow link "
                                   "fed the condemnation ladder")
            if node in torn:
                held += 1
    return _ok(name, f"{len(torn)} degraded host(s) never reached "
                     f"FAILED/CHRONIC ({held} sub-condemnation "
                     "transitions)")


def check_degraded_drain(patch_timeline: Sequence[Sequence[str]],
                         hosts: Sequence[str], records: Sequence[dict],
                         strict: bool = False) -> Verdict:
    """Remediation acts on DEGRADED evidence: every torn host is drained
    (cordoned, counted SERVER-SIDE) or visibly budget-denied by the final
    round — silently ignoring a sick link is the failure mode.  An
    out-of-band uncordon (the resurrect sabotage) un-drains the host and
    must turn this red.  ``strict`` additionally forbids actuation on any
    OTHER host (the dedicated scenario, where the torn host is the only
    sick one; the fuzzer mixes failure programs and skips it)."""
    name = "degraded-drain"
    torn = set(hosts)
    cordoned: set = set()
    for i, patches in enumerate(patch_timeline):
        for p in patches:
            node, _, action = p.rpartition(":")
            if action == "cordon":
                if strict and node not in torn:
                    return _fail(name, f"round {i}: cordoned {node} outside "
                                       "the degraded set")
                if node in torn:
                    cordoned.add(node)
            elif action == "uncordon":
                cordoned.discard(node)
    missing = sorted(torn - cordoned)
    if not missing:
        return _ok(name, f"all {len(torn)} degraded host(s) drained within "
                         "the budget rails")
    # Denial pairs are (domain, reason) — node names fold away in the
    # fingerprint — so a standing recorded refusal is the escape hatch:
    # bounded actuation, but never silent.
    denied = sorted({d for r in records for d in (r.get("denials") or ())})
    if denied:
        return _ok(name, f"{len(cordoned & torn)} drained, {len(missing)} "
                         f"left under a visible refusal: {denied}")
    return _fail(name, f"degraded host(s) {missing} neither drained nor "
                       "visibly denied by the final round — the evidence "
                       "was silently ignored")


def check_trace_completeness(records: Sequence[dict]) -> Verdict:
    """Every completed round ran under a tracer: the payload carries the
    round's trace_id and the trace recorded the detect phase (exit-1
    rounds have no payload and are exempt)."""
    name = "trace-completeness"
    bad = [r["round"] for r in records
           if r["exit_code"] != 1 and not r.get("trace_ok")]
    if bad:
        return _fail(name, f"rounds {bad} missing trace_id or the detect "
                           "span")
    graded = sum(1 for r in records if r["exit_code"] != 1)
    return _ok(name, f"{graded} completed rounds fully traced")


def check_relist_economy(lists: int, expected: int) -> Verdict:
    """Relist exactly once per stream loss: the fixture-side LIST count is
    seed + one per injected loss — a thundering relist (N reconnect
    attempts re-LISTing N times) is the regression this pins."""
    name = "relist-economy"
    if lists != expected:
        return _fail(name, f"{lists} LIST walks != expected {expected} "
                           "(seed + one per injected loss)")
    return _ok(name, f"{lists} LIST walks == seed + losses")


def check_lease_bound(total_patches: int, fleet_budget: int) -> Verdict:
    """Federated budget: across the whole storm — aggregator death
    included — server-side actuations never exceed the fleet allowance
    last leased."""
    name = "lease-bound"
    if total_patches > fleet_budget:
        return _fail(name, f"{total_patches} actuations exceed the fleet "
                           f"budget {fleet_budget}")
    return _ok(name, f"{total_patches} total actuations within the fleet "
                     f"budget {fleet_budget}")


def check_feed_parity(timeline: Sequence[dict]) -> Verdict:
    """Stream ≡ poll, graded per round: a federated view folded from
    push-delta frames must be byte-identical to one rebuilt by conditional
    GETs — same per-cluster entry bytes, same upstream validators, same
    staleness labels.  The scenario synchronizes the feed cursor before
    comparing, so a mismatch is a wire/fold defect, not a race."""
    name = "feed-parity"
    for s in timeline:
        diverged = sorted(c for c, ok in s["clusters"].items() if not ok)
        if diverged:
            return _fail(name, f"round {s['round']}: stream view diverged "
                               f"from poll view for {diverged}")
    cluster_rounds = sum(len(s["clusters"]) for s in timeline)
    return _ok(name, f"{cluster_rounds} cluster-rounds byte-identical "
                     "between the stream and poll federations")


def check_retry_absorption(records: Sequence[dict], round_i: int,
                           min_retries: int) -> Verdict:
    """A brownout burst is absorbed invisibly: the faulted round still
    exits 0 and the transport telemetry shows the retries that paid for
    it."""
    name = "retry-absorption"
    rec = next((r for r in records if r["round"] == round_i), None)
    if rec is None:
        return _fail(name, f"no record for brownout round {round_i}")
    if rec["exit_code"] != 0:
        return _fail(name, f"brownout round {round_i} exited "
                           f"{rec['exit_code']} — the retry ladder did not "
                           "absorb the burst")
    retries = rec.get("retries") or 0
    if retries < min_retries:
        return _fail(name, f"brownout round {round_i} recorded {retries} "
                           f"retries < {min_retries} — recovery happened "
                           "but not through the ladder under test")
    return _ok(name, f"round {round_i} exited 0 with {retries} retries")
