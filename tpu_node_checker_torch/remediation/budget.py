"""The disruption-budget engine: slice-aware refusal before any actuation.

A copy of the JAX package's ``remediation/budget.py``, held equal to it by
``tests/test_torch_copies.py``.

A multi-host slice is one failure domain, keyed by
:func:`~tpu_node_checker_torch.detect.slice_group_key` (the grading's own
grouping).  Single-host domains (every GPU node) are exempt from the
floor.  Refusals, most specific first: ``cordon-max`` (total cordoned
state, nodes cordoned by anyone count), ``slice-floor``,
``disruption-budget`` (``N`` a round or ``N/WINDOW`` sliding), then
``lease-denied`` / ``lease-unreachable``.  Every denial is recorded, counted
in ``denied_total`` and emitted as one ``remediation-denied`` event line.
:class:`FleetLeaseBudget` is the aggregator's side of the lease.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from tpu_node_checker_torch.detect import slice_group_key, topology_chip_count

DEFAULT_SLICE_FLOOR_PCT = 90.0

# Actions that remove (or may remove) capacity and therefore charge
# budgets.  Uncordon/annotation hygiene RESTORE capacity: always granted,
# still audited at the actuation site.
DISRUPTIVE_ACTIONS = ("cordon", "drain", "repair")

_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_BUDGET_RE = re.compile(r"^(\d+)(?:/(\d+(?:\.\d+)?)([smhd]?))?$")


def parse_disruption_budget(raw: str) -> Tuple[int, Optional[float]]:
    """``"N"`` or ``"N/WINDOW"`` → ``(count, window_seconds_or_None)``.

    ``WINDOW`` accepts ``30s`` / ``10m`` / ``1h`` / ``1d`` (bare numbers
    are seconds).  No window means *per round*.  Raises ``ValueError`` on
    anything else — a mis-typed budget must fail loudly at parse time,
    never silently grant unlimited actuation.
    """
    m = _BUDGET_RE.match(raw.strip())
    if not m:
        raise ValueError(
            f"malformed disruption budget {raw!r} (want N or N/WINDOW, "
            "e.g. 4 or 4/10m)"
        )
    count = int(m.group(1))
    if count < 1:
        raise ValueError("disruption budget must allow at least 1 actuation")
    if m.group(2) is None:
        return count, None
    window = float(m.group(2)) * _WINDOW_UNITS[m.group(3) or "s"]
    if window <= 0:
        raise ValueError("disruption budget window must be positive")
    return count, window


@dataclass
class Decision:
    """One budget verdict for one (action, node) pair.

    The actuate module refuses to run without a granted Decision — the
    type IS the proof that the budget engine was consulted (tnc-lint
    TNC019 pins the call sites).
    """

    allowed: bool
    action: str
    node: str
    domain: Optional[str] = None
    reason: str = ""
    dry_run: bool = False


@dataclass
class _Domain:
    """One failure domain's capacity picture for the current round."""

    name: str
    nodes: List = field(default_factory=list)
    expected_chips: int = 0

    def available_chips(self, granted: set) -> int:
        """Chips still in the schedulable pool: cordoned nodes and nodes
        already granted a cordon/drain THIS round (the flag lands only
        when the PATCH does) both count as gone."""
        return sum(
            n.accelerators
            for n in self.nodes
            if not n.cordoned and n.name not in granted
        )


class ActuationLedger:
    """Sliding-window record of applied disruptive actuations.

    Survives across watch rounds (the engine is cached like the history
    tracker), so ``--disruption-budget 4/1h`` means four actuations per
    hour of process lifetime, not four per round.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._events: Deque[Tuple[float, int]] = deque()

    def charge(self, n: int = 1) -> None:
        self._events.append((self._clock(), n))

    def in_window(self, window_s: Optional[float]) -> int:
        if window_s is None:
            return 0
        cutoff = self._clock() - window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()
        return sum(n for _, n in self._events)


def denial_fingerprint(denials: List[dict]) -> Tuple:
    """Refusal identity for Slack dedup: the set of (domain, reason)
    pairs, node names folding away (the domain is the failure unit) — one
    alert per standing condition, not one per refused node per round.
    The ONE definition: the watch loop's change fingerprint and the
    engine's round records both ride it."""
    return tuple(sorted({
        (d.get("domain") or d.get("node") or "", d.get("reason") or "")
        for d in denials
    }))


def _domain_name(key: Tuple) -> str:
    if key[0] == "__single__":
        return f"single/{key[1]}"
    return "/".join(str(part or "-") for part in key)


class BudgetEngine:
    """Per-process budget state + per-round domain maps; see module doc.

    ``enabled=False`` (no new remediation flag given) degrades to exactly
    the legacy ``--cordon-max`` behavior — same grants, same order — with
    the denials made visible.  The regression pin: a run with no
    remediation flags and no cap denials produces a payload byte-identical
    to the pre-engine checker.

    Budget accounting happens at GRANT time, not actuation time: the
    sweeps decide a whole candidate list before PATCHing any of it, and a
    grant whose PATCH later fails still consumed budget for the round —
    the conservative direction, and exactly what the pre-engine slice
    ``candidates[:budget]`` did.  :meth:`commit` records only the durable
    side (window ledger, lifetime action counters) for APPLIED actuations.
    """

    def __init__(
        self,
        *,
        slice_floor_pct: Optional[float] = None,
        budget: Optional[int] = None,
        window_s: Optional[float] = None,
        cordon_max: int = 1,
        lease=None,
        events=None,
        enabled: Optional[bool] = None,
        clock=time.monotonic,
    ):
        self.enabled = (
            enabled
            if enabled is not None
            else (slice_floor_pct is not None or budget is not None
                  or lease is not None)
        )
        self.slice_floor_pct = (
            slice_floor_pct
            if slice_floor_pct is not None
            else (DEFAULT_SLICE_FLOOR_PCT if self.enabled else None)
        )
        self.budget = budget
        self.window_s = window_s
        self.cordon_max = max(1, int(cordon_max))
        self.lease = lease
        self.events = events
        self.ledger = ActuationLedger(clock)
        # Lifetime counters (the Prometheus families are counters; the
        # engine outlives rounds via checker's remediation cache).
        self.denied_total: Dict[str, int] = {}
        self.actions_total: Dict[str, int] = {}
        self._accel: List = []
        self._domains: Dict[Tuple, _Domain] = {}
        self._trace_id: Optional[str] = None
        self._round_denials: List[dict] = []
        self._round_budget_used = 0  # disruptive grants this round
        self._round_granted: set = set()  # node names granted cordon/drain
        self._predictions: set = set()  # analytics changepoint suspects
        self._degraded: Dict[str, list] = {}  # node -> slow ICI links
        self.repairs: Optional[dict] = None  # repair.py stamps its roll-up

    # -- round lifecycle -----------------------------------------------------

    def begin_round(self, accel: List, trace_id: Optional[str] = None,
                    predictions: Optional[set] = None,
                    degraded: Optional[Dict[str, list]] = None) -> None:
        """``predictions`` (the analytics tier's standing changepoint
        set, ``--analytics``) is the budget view's early-warning input:
        surfaced per domain in :meth:`payload_block` so the repair
        scheduler sees which domains are PREDICTED to degrade before the
        FSM condemns a single node in them.  It never relaxes a refusal
        and never grants anything — prediction informs, evidence gates.

        ``degraded`` (node → its slice-qualified SLOW ICI links, the mesh
        link doctor's standing DEGRADED evidence) is the second informing
        input: surfaced per domain the same way, and consumed by the
        ``--cordon-degraded`` drain path — whose every PATCH still rides
        :meth:`decide`, so a sick-link drain obeys the same floor/budget/
        lease ladder as any failure-driven cordon."""
        self._accel = list(accel)
        self._trace_id = trace_id
        self._predictions = set(predictions or ())
        self._degraded = dict(degraded or {})
        self._round_denials = []
        self._round_budget_used = 0
        self._round_granted = set()
        self.repairs = None
        domains: Dict[Tuple, _Domain] = {}
        for n in accel:
            key = slice_group_key(n)
            if key is None:
                continue
            d = domains.get(key)
            if d is None:
                d = domains[key] = _Domain(name=_domain_name(key))
            d.nodes.append(n)
        for key, d in domains.items():
            expected = (
                topology_chip_count(key[2]) if key[0] != "__single__" else None
            )
            d.expected_chips = expected or sum(
                n.accelerators for n in d.nodes
            )
        self._domains = domains

    def domain_of(self, node) -> Optional[str]:
        key = slice_group_key(node)
        d = self._domains.get(key) if key is not None else None
        return d.name if d is not None else None

    # -- the decision function ----------------------------------------------

    def decide(self, action: str, node, dry_run: bool = False) -> Decision:
        """The ONE gate every actuator call rides (TNC019).

        Non-disruptive actions (uncordon, clear-annotation) are always
        granted — they restore capacity — but routing them through here
        keeps the audit trail uniform.  A disruptive grant immediately
        charges the round's budgets (see the class docstring); the caller
        then :meth:`commit`-s applied actuations so the durable ledger and
        lifetime counters record what really happened.
        """
        key = slice_group_key(node)
        domain = self._domains.get(key) if key is not None else None
        domain_name = domain.name if domain is not None else None
        if action not in DISRUPTIVE_ACTIONS:
            return Decision(True, action, node.name, domain_name,
                            "capacity-restoring", dry_run)
        if action in ("cordon", "drain"):
            denial = self._check_cordon_max(action, node, domain_name, dry_run)
            if denial is None and self.slice_floor_pct is not None:
                denial = self._check_slice_floor(
                    action, node, domain, domain_name, dry_run
                )
        else:  # repair: node is already quarantined — no capacity change
            denial = None
        if denial is None and self.budget is not None:
            denial = self._check_disruption_budget(
                action, node.name, domain_name, dry_run
            )
        if denial is None and self.lease is not None and not dry_run:
            granted, reason = self.lease.acquire(
                1, action=action, node=node.name, trace_id=self._trace_id
            )
            if not granted:
                denial = self.deny(action, node.name, domain_name, reason,
                                   dry_run)
        if denial is not None:
            return denial
        # Grant: charge the round's budgets NOW — the next candidate must
        # see this one gone whether or not its PATCH has landed yet.
        self._round_budget_used += 1
        if action in ("cordon", "drain"):
            self._round_granted.add(node.name)
        return Decision(True, action, node.name, domain_name, "granted",
                        dry_run)

    def _check_cordon_max(self, action, node, domain_name, dry_run):
        # Total-cordoned-state budget: nodes cordoned by anyone, plus the
        # grants already issued this round (their PATCH may not have
        # landed; dry-run grants never flip the flag at all).  Uncordons
        # earlier in the round flipped node.cordoned and freed budget.
        already = sum(
            1 for n in self._accel
            if n.cordoned or n.name in self._round_granted
        )
        if already >= self.cordon_max:
            return self.deny(
                action, node.name, domain_name, "cordon-max", dry_run,
                detail=f"{already} nodes already cordoned, cap "
                       f"{self.cordon_max}",
            )
        return None

    def _check_slice_floor(self, action, node, domain, domain_name, dry_run):
        if domain is None or len(domain.nodes) < 2:
            # Single-host domains: the floor is meaningless (see module
            # doc); cordon-max and the disruption budget still apply.
            return None
        floor_chips = math.ceil(
            domain.expected_chips * self.slice_floor_pct / 100.0
        )
        after = (
            domain.available_chips(self._round_granted) - node.accelerators
        )
        if after < floor_chips:
            return self.deny(
                action, node.name, domain_name, "slice-floor", dry_run,
                detail=f"would leave {after}/{domain.expected_chips} chips, "
                       f"floor {self.slice_floor_pct:g}% = {floor_chips}",
            )
        return None

    def _check_disruption_budget(self, action, node_name, domain_name,
                                 dry_run):
        used = self._round_budget_used + self.ledger.in_window(self.window_s)
        if used >= self.budget:
            window = (
                f"per {self.window_s:g}s window"
                if self.window_s is not None
                else "per round"
            )
            return self.deny(
                action, node_name, domain_name, "disruption-budget", dry_run,
                detail=f"{used} actuations against a budget of "
                       f"{self.budget} {window}",
            )
        return None

    def deny(self, action: str, node: str, domain: Optional[str],
             reason: str, dry_run: bool = False,
             detail: Optional[str] = None) -> Decision:
        """Record one refusal: denial list, lifetime counter, audit event.

        Public because the drain actuator reports PDB refusals through it
        (``reason="pdb"``): an eviction the cluster's own disruption
        budget blocked is OUR budget denial too, not an error.
        """
        self.denied_total[reason] = self.denied_total.get(reason, 0) + 1
        record = {"action": action, "node": node, "reason": reason}
        if domain:
            record["domain"] = domain
        if detail:
            record["detail"] = detail
        self._round_denials.append(record)
        if self.events is not None:
            self.events.emit(
                "remediation-denied",
                trace_id=self._trace_id,
                dry_run=dry_run or None,
                **record,
            )
        return Decision(False, action, node, domain, reason, dry_run)

    def commit(self, decision: Decision, node=None) -> None:
        """One granted decision was APPLIED: record the durable side.

        Round budgets were charged at grant time; this adds the sliding-
        window ledger entry and the lifetime action counter.  Dry-run
        decisions are never committed — previews must not age into a
        window budget the next real round then finds exhausted.
        """
        if not decision.allowed:
            raise ValueError("cannot commit a denied decision")
        if decision.dry_run:
            return
        if decision.action in DISRUPTIVE_ACTIONS:
            self.ledger.charge(1)
        self.actions_total[decision.action] = (
            self.actions_total.get(decision.action, 0) + 1
        )

    # -- round results -------------------------------------------------------

    def denials(self) -> List[dict]:
        return list(self._round_denials)

    @property
    def ever_denied(self) -> bool:
        return bool(self.denied_total)

    def payload_block(self) -> dict:
        """The payload's ``remediation`` block (what metrics.py renders)."""
        at_floor = 0
        if self.slice_floor_pct is not None:
            for d in self._domains.values():
                if len(d.nodes) < 2:
                    continue
                floor_chips = math.ceil(
                    d.expected_chips * self.slice_floor_pct / 100.0
                )
                if d.available_chips(self._round_granted) <= floor_chips:
                    at_floor += 1
        block: dict = {
            "enabled": self.enabled,
            "denied_total": dict(sorted(self.denied_total.items())),
            "actions_total": dict(sorted(self.actions_total.items())),
            "denials": self.denials(),
            "domains": {"total": len(self._domains), "at_floor": at_floor},
        }
        if self._predictions:
            # The prediction input (--analytics): standing changepoint
            # suspects, plus the domains they would degrade — what a
            # slice-aware repair scheduler reads to stage work BEFORE the
            # FSM condemns anything.
            predicted_domains = sorted({
                d for n in self._accel
                if n.name in self._predictions
                and (d := self.domain_of(n)) is not None
            })
            block["prediction"] = {
                "suspects": sorted(self._predictions),
                "domains": predicted_domains,
            }
        if self._degraded:
            # The DEGRADED-link input (--probe-level mesh): nodes whose
            # chips pass but whose slice carries a SLOW ICI link, with the
            # offending links by name — what --cordon-degraded acts on and
            # what a repair scheduler reads to drain a slice BEFORE its
            # chips die.
            block["degraded"] = {
                "nodes": sorted(self._degraded),
                "links": sorted({
                    link for links in self._degraded.values() for link in links
                }),
                "domains": sorted({
                    d for n in self._accel
                    if n.name in self._degraded
                    and (d := self.domain_of(n)) is not None
                }),
            }
        if self.slice_floor_pct is not None:
            block["slice_floor_pct"] = self.slice_floor_pct
        if self.budget is not None:
            used = self._round_budget_used + self.ledger.in_window(self.window_s)
            block["budget"] = {
                "limit": self.budget,
                "window_s": self.window_s,
                "remaining": max(0, self.budget - used),
            }
        if self.lease is not None:
            block["lease"] = self.lease.as_dict()
        if self.repairs is not None:
            block["repairs"] = self.repairs
        return block


class FleetLeaseBudget:
    """The aggregator side of federated budgets: one fleet-wide window.

    Serves ``POST /api/v1/global/disruption-lease`` (wired through
    :class:`~tpu_node_checker_torch.server.app.FleetStateServer`): per-cluster
    checkers borrow actuation permits against the fleet budget before
    acting.  Thread-safe — lease requests arrive on serving threads, and
    the write path may lock (TNC011 covers read handlers only).
    """

    def __init__(self, budget: int, window_s: Optional[float] = None,
                 clock=time.monotonic, events=None):
        self.budget = max(1, int(budget))
        self.window_s = window_s
        self._ledger = ActuationLedger(clock)
        self._round_used = 0  # used when window_s is None: reset_round()
        self._lock = threading.Lock()
        self.events = events
        self.granted_total = 0
        self.denied_total = 0

    def reset_round(self) -> None:
        """Window-less budgets are per federation round: the mode loop
        calls this each merge round."""
        with self._lock:
            if self.window_s is None:
                self._round_used = 0

    def remaining(self) -> int:
        with self._lock:
            return self._remaining_locked()

    def _remaining_locked(self) -> int:
        used = (
            self._ledger.in_window(self.window_s)
            if self.window_s is not None
            else self._round_used
        )
        return max(0, self.budget - used)

    def grant(self, body: dict) -> Tuple[int, dict]:
        """One lease request → ``(http_status, response_body)``."""
        count = body.get("count")
        if not isinstance(count, int) or isinstance(count, bool) or count < 1:
            return 400, {"granted": False,
                         "reason": "count must be a positive integer"}
        cluster = body.get("cluster") if isinstance(body.get("cluster"), str) else None
        with self._lock:
            remaining = self._remaining_locked()
            granted = count <= remaining
            if granted:
                if self.window_s is not None:
                    self._ledger.charge(count)
                else:
                    self._round_used += count
                self.granted_total += count
                remaining -= count
            else:
                self.denied_total += 1
        if self.events is not None:
            self.events.emit(
                "disruption-lease",
                cluster_requesting=cluster,
                count=count,
                granted=granted,
                remaining=remaining,
                action=body.get("action"),
                node=body.get("node"),
            )
        resp = {
            "granted": granted,
            "remaining": remaining,
            "budget": self.budget,
            "window_s": self.window_s,
        }
        if not granted:
            resp["reason"] = (
                f"fleet disruption budget exhausted ({self.budget} "
                + (f"per {self.window_s:g}s window" if self.window_s is not None
                   else "per round")
                + f", {remaining} remaining)"
            )
            return 409, resp
        return 200, resp
