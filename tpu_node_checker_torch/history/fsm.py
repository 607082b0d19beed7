"""Per-node hysteresis state machine over health-history verdicts.

States and transitions (DESIGN.md §9)::

              bad                      bad × K              good
    HEALTHY ───────► SUSPECT ────────────────────► FAILED ───────► RECOVERING
       ▲               │ good                         ▲               │
       │               ▼                              │ bad           │ good × M
       └─────────── HEALTHY                           └───────────────┤
                                                                      ▼
                 ≥ F verdict flips in the last W rounds            HEALTHY
    (any state) ─────────────────────────────────────► CHRONIC
    CHRONIC ── uncordoned out-of-band (human override) ──► RECOVERING

* ``FAILED`` is the cordon-eligible state: only after ``--cordon-after K``
  *consecutive* bad rounds may ``--cordon-failed`` PATCH — one bad probe is
  a data point, not a diagnosis.
* ``RECOVERING`` holds a quarantined node until ``--uncordon-after M``
  consecutive good rounds prove the repair; only then does the node reach
  ``HEALTHY``, the uncordon-eligible state.
* ``CHRONIC`` is the flap trap: a node whose verdict flipped at least
  ``--flap-threshold`` times within the last ``--flap-window`` rounds is a
  chronic offender — it stays cordoned, ``--uncordon-recovered`` never
  lifts it, and only a human uncordoning it out-of-band (detected by the
  stale-annotation sweep) releases it, into ``RECOVERING`` — never straight
  to ``HEALTHY``: an override is a decision, not evidence.

With the default ``K = M = 1`` the machine collapses to the pre-history
per-round behavior (one bad round → FAILED, one good round → HEALTHY), so
``--history`` alone changes durability and flap detection, not policy.

The machine is deliberately pure: verdicts in, states and transitions out.
Persistence (seeding from the store's tail, recording each observation)
belongs to the caller.

A copy of the JAX package's ``history/fsm.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
FAILED = "FAILED"
RECOVERING = "RECOVERING"
CHRONIC = "CHRONIC"

STATES = (HEALTHY, SUSPECT, FAILED, RECOVERING, CHRONIC)

# The DEGRADED evidence VERDICT (not a state): the mesh link doctor found
# the chips healthy but an ICI link SLOW.  It grades between a good and a
# bad round — affirmative evidence the node exists and computes, but
# neither heals (no banking toward ``--uncordon-after``) nor sickens (no
# banking toward ``--cordon-after``, no SUSPECT-streak reset, no flap-
# window entry).  Recorded verbatim in the history store (``"ok":
# "degraded"``) and skipped by the tail-seed's flap replay exactly like
# any non-bool verdict.
DEGRADED = "degraded"

# K = M = 1 keeps the one-shot contract: the first --history run behaves
# exactly like the snapshot grading it replaces, plus memory.
DEFAULT_CORDON_AFTER = 1
DEFAULT_UNCORDON_AFTER = 1
# Four verdict flips inside ten rounds is a chip that cannot hold a state
# for three rounds running — past any plausible transient.
DEFAULT_FLAP_THRESHOLD = 4
DEFAULT_FLAP_WINDOW = 10

# The transitions worth a Slack line / a page.  Sub-threshold wobble
# (HEALTHY↔SUSPECT, FAILED→RECOVERING) is the noise hysteresis exists to
# absorb — alerting on it would re-create the per-round churn.
_ACTIONABLE_TO = {FAILED, CHRONIC}


@dataclass
class NodeHealth:
    """One node's hysteresis state between rounds."""

    state: str = HEALTHY
    # Consecutive rounds sharing the current verdict direction (bad rounds
    # in SUSPECT/FAILED, good rounds in RECOVERING/HEALTHY).
    streak: int = 0
    # Verdict window for flap detection (True = good round).
    verdicts: Deque[bool] = field(default_factory=deque)
    # Lifetime verdict flips (monotonic — the Prometheus counter).
    flaps_total: int = 0

    @property
    def flaps(self) -> int:
        """Verdict flips inside the current window."""
        return sum(
            1 for a, b in zip(self.verdicts, list(self.verdicts)[1:]) if a != b
        )


class HealthFSM:
    """The fleet's per-node machines plus this round's transition log."""

    def __init__(
        self,
        cordon_after: int = DEFAULT_CORDON_AFTER,
        uncordon_after: int = DEFAULT_UNCORDON_AFTER,
        flap_threshold: int = DEFAULT_FLAP_THRESHOLD,
        flap_window: int = DEFAULT_FLAP_WINDOW,
    ):
        self.cordon_after = max(1, int(cordon_after))
        self.uncordon_after = max(1, int(uncordon_after))
        self.flap_threshold = max(2, int(flap_threshold))
        self.flap_window = max(2, int(flap_window))
        self.nodes: Dict[str, NodeHealth] = {}
        # [{"node", "from", "to", "actionable"}] for the round so far.
        self.transitions: List[dict] = []

    # -- persistence seam ---------------------------------------------------

    def seed(self, node: str, entries: List[dict]) -> None:
        """Rebuild a node's machine from its store tail.

        Trusts the recorded final ``state``/``streak``/``flaps_total`` (the
        FSM that wrote them saw evidence this process never did) and
        replays only the verdict window for flap math.  An unknown recorded
        state degrades to HEALTHY-with-no-streak — the conservative seed:
        every state-gated action then needs fresh consecutive evidence.
        """
        h = NodeHealth()
        if entries:
            last = entries[-1]
            state = last.get("state")
            if state in STATES:
                h.state = state
                streak = last.get("streak")
                h.streak = int(streak) if isinstance(streak, int) else 0
            total = last.get("flaps_total")
            if isinstance(total, int) and total >= 0:
                h.flaps_total = total
            for e in entries[-self.flap_window:]:
                ok = e.get("ok")
                if isinstance(ok, bool):
                    h.verdicts.append(ok)
            while len(h.verdicts) > self.flap_window:
                h.verdicts.popleft()
        self.nodes[node] = h

    # -- the machine --------------------------------------------------------

    def observe(
        self, node: str, ok, uncordoned_out_of_band: bool = False
    ) -> Optional[Tuple[str, str]]:
        """Feed one round's verdict; returns ``(from, to)`` on a transition.

        ``ok=None`` means *no evidence this round* (a quarantined node whose
        probe report never arrived, or — under ``--watch-stream`` — a node
        the event stream stayed silent about): state, streaks and the flap
        window all hold — absence must neither heal nor sicken, exactly the
        rule the cordon path applies to ``level="missing"`` reports.  A
        silent stream therefore never banks healthy rounds toward
        ``--uncordon-after`` nor bad rounds toward ``--cordon-after``; only
        an observed verdict advances a streak.  For a node this machine has
        never seen, no-evidence observes NOTHING: absence must not mint a
        HEALTHY machine either.

        ``ok=DEGRADED`` grades BETWEEN the booleans: the chips passed but
        an ICI link is SLOW.  State, streaks and the flap window hold like
        no-evidence — a degraded round must not bank toward
        ``--cordon-after`` as if FAILED, must not reset a SUSPECT streak
        as if healthy, and must not enter the flap window (SLOW↔OK link
        weather is not a verdict flip).  Unlike ``None`` it IS affirmative
        evidence, so it mints a machine for a never-seen node — the
        degraded-drain path needs the node known to the fleet's state.
        """
        if ok is None and node not in self.nodes and not uncordoned_out_of_band:
            return None
        h = self.nodes.setdefault(node, NodeHealth())
        before = h.state
        if uncordoned_out_of_band and h.state in (FAILED, CHRONIC):
            # A human lifted our quarantine: respect the override, but the
            # node re-earns HEALTHY through M good rounds like any repair.
            # The flap window clears too — the override wiped the slate, and
            # stale flips would otherwise re-trap the node CHRONIC on its
            # very next verdict, overriding the human right back.
            h.state = RECOVERING
            h.streak = 0
            h.verdicts.clear()
        if ok is None or ok == DEGRADED:
            return self._transitioned(node, before, h.state)
        # Flap window first: a flip is a flip whatever the state outcome.
        if h.verdicts and h.verdicts[-1] != ok:
            h.flaps_total += 1
        h.verdicts.append(ok)
        while len(h.verdicts) > self.flap_window:
            h.verdicts.popleft()
        if h.state != CHRONIC:
            if ok:
                self._observe_good(h)
            else:
                self._observe_bad(h)
            if h.flaps >= self.flap_threshold:
                h.state = CHRONIC
                h.streak = 0  # CHRONIC streak counts consecutive good rounds
        else:
            # CHRONIC is sticky: verdicts keep being recorded (the window
            # is the evidence a human reads — streak counts consecutive
            # good rounds) but never change the state.
            h.streak = h.streak + 1 if ok else 0
        return self._transitioned(node, before, h.state)

    def _observe_good(self, h: NodeHealth) -> None:
        if h.state in (HEALTHY, RECOVERING):
            h.streak += 1
            if h.state == RECOVERING and h.streak >= self.uncordon_after:
                h.state = HEALTHY
        elif h.state == SUSPECT:
            h.state = HEALTHY
            h.streak = 1
        else:  # FAILED
            h.state = RECOVERING
            h.streak = 1
            if h.streak >= self.uncordon_after:
                h.state = HEALTHY
        self._clamp(h)

    def _observe_bad(self, h: NodeHealth) -> None:
        if h.state in (SUSPECT, FAILED):
            h.streak += 1
            if h.state == SUSPECT and h.streak >= self.cordon_after:
                h.state = FAILED
        else:  # HEALTHY or RECOVERING: the bad streak restarts at 1
            h.state = SUSPECT
            h.streak = 1
            if h.streak >= self.cordon_after:
                h.state = FAILED
        self._clamp(h)

    def promote_suspect(self, node: str) -> Optional[Tuple[str, str]]:
        """Prediction seam: the analytics changepoint detector flags a
        flapper *before* the machine condemns it.

        Only a HEALTHY node moves (→ SUSPECT, a legal observe edge,
        recorded in the same per-round transition log) and its streak is
        ZEROED: a promoted node still needs the full ``--cordon-after``
        consecutive bad rounds before any cordon is eligible — prediction
        is early warning, never an accelerant.  Any other state returns
        ``None``: the machine already knows at least this much.
        """
        h = self.nodes.get(node)
        if h is None or h.state != HEALTHY:
            return None
        h.state = SUSPECT
        h.streak = 0
        return self._transitioned(node, HEALTHY, SUSPECT)

    @staticmethod
    def _clamp(h: NodeHealth) -> None:
        # Streaks only need to clear thresholds; unbounded growth would
        # overflow nothing but helps nobody and bloats the store lines.
        h.streak = min(h.streak, 1_000_000)

    def _transitioned(
        self, node: str, before: str, after: str
    ) -> Optional[Tuple[str, str]]:
        if before == after:
            return None
        self.transitions.append(
            {
                "node": node,
                "from": before,
                "to": after,
                "actionable": after in _ACTIONABLE_TO
                or (before in (FAILED, RECOVERING) and after == HEALTHY)
                or (before == CHRONIC and after == RECOVERING),
            }
        )
        return (before, after)

    # -- gates the remediation path consults --------------------------------

    def health(self, node: str) -> NodeHealth:
        return self.nodes.setdefault(node, NodeHealth())

    def cordon_eligible(self, node: str) -> bool:
        """Only FAILED (K consecutive bad rounds) and CHRONIC earn a cordon
        PATCH — SUSPECT is the debounce this subsystem exists to add."""
        return self.health(node).state in (FAILED, CHRONIC)

    def uncordon_eligible(self, node: str) -> bool:
        """Only HEALTHY (M consecutive good rounds out of RECOVERING) earns
        a lift; CHRONIC never qualifies — a flapper's passing round is the
        setup for its next failure."""
        return self.health(node).state == HEALTHY

    def actionable_transitions(self) -> List[dict]:
        return [t for t in self.transitions if t.get("actionable")]

    def state_counts(self) -> Dict[str, int]:
        counts = {s: 0 for s in STATES}
        for h in self.nodes.values():
            counts[h.state] += 1
        return counts
