"""Online changepoint detection: CUSUM over per-node verdict flips and
over per-link timing headroom.

A copy of the JAX package's ``analytics/changepoint.py``, held equal to it
by ``tests/test_torch_copies.py``.  Each evidence round adds one flip sample
``x`` in {0, 1}; ``S <- max(0, S + x - DRIFT)`` fires at ``S >= THRESHOLD``
(0.5 and 1.5: three net flips above drift).  :class:`LinkDriftDetector`
runs the same statistic over a link's p50 against its SLOW budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Allowed flip drift per round and the episode threshold; see module doc.
CUSUM_DRIFT = 0.5
CUSUM_THRESHOLD = 1.5


class CusumFlapDetector:
    """Per-node one-sided CUSUM over verdict flips; see the module doc."""

    def __init__(self, drift: float = CUSUM_DRIFT,
                 threshold: float = CUSUM_THRESHOLD):
        self.drift = float(drift)
        self.threshold = float(threshold)
        self._score: Dict[str, float] = {}
        self._last_ok: Dict[str, bool] = {}
        self._armed: Dict[str, bool] = {}  # False while an episode stands
        self.detections_total = 0
        # node -> round_seq of the episode's first firing (current episode
        # only; cleared when the score decays and the episode closes).
        self.active: Dict[str, int] = {}

    def flip(self, node: str, ok: bool) -> bool:
        """Record one verdict; True when it flipped vs the previous one."""
        prev = self._last_ok.get(node)
        self._last_ok[node] = ok
        return prev is not None and prev != ok

    def observe(self, node: str, flipped: bool,
                round_seq: int = 0) -> bool:
        """Advance the node's CUSUM by one round's flip sample.

        Returns True exactly once per episode — on the round the score
        first crosses the threshold.
        """
        score = max(
            0.0,
            self._score.get(node, 0.0)
            + (1.0 if flipped else 0.0)
            - self.drift,
        )
        self._score[node] = score
        if score <= 0.0 and not self._armed.get(node, True):
            # Episode over: the flapping stopped long enough for the
            # score to drain — re-arm for the next one.
            self._armed[node] = True
            self.active.pop(node, None)
        if score >= self.threshold and self._armed.get(node, True):
            self._armed[node] = False
            self.active[node] = round_seq
            self.detections_total += 1
            return True
        return False

    def score(self, node: str) -> float:
        return self._score.get(node, 0.0)

    def active_count(self) -> int:
        return len(self.active)

    def forget(self, node: str) -> None:
        """Drop a departed node's state so the dicts track the fleet."""
        for d in (self._score, self._last_ok, self._armed, self.active):
            d.pop(node, None)

    def prune(self, fleet: set) -> None:
        """Forget every node outside ``fleet`` — called once per round so
        a deleted/renamed node cannot sit in the standing suspect set
        forever (its score could never drain: observe() only runs for
        nodes the round saw).  Same policy as the FSM state gauges: the
        standing sets cover THIS round's fleet."""
        for node in set(self._last_ok) - fleet:
            self.forget(node)

    def snapshot(self) -> List[dict]:
        """Deterministic per-node view for the flaps query doc."""
        return [
            {
                "node": node,
                "score": round(self._score.get(node, 0.0), 3),
                "active": node in self.active,
            }
            for node in sorted(self._score)
            if self._score.get(node, 0.0) > 0.0 or node in self.active
        ]


# Per-link timing channel: the fraction of a link's timing budget its p50
# may consume before the round counts as drifting.  One SLOW verdict is a
# fact; a link that *trends toward* its budget round after round is a
# prediction — the same early-warning-never-accelerant contract as the
# flip channel above.
LINK_HEADROOM = 0.5


class LinkDriftDetector:
    """Per-ICI-link one-sided CUSUM over timing-budget headroom.

    The sample: each probed round, a link contributes ``x ∈ {0, 1}`` — did
    its p50 consume at least :data:`LINK_HEADROOM` of its per-link budget
    (the mesh link doctor's SLOW ladder).  Scores follow the exact flip-
    channel mechanics (``S ← max(0, S + x − DRIFT)``, one firing per
    episode, re-arm on drain), so a detection needs three net drifting
    rounds: a healthy link far under budget contributes nothing, one noisy
    sweep peaks at 0.5, and a link sliding toward SLOW fires typically
    before the sweep ever grades it SLOW.  Keys are slice-qualified link
    names (``slice/axis/hop`` — the budget-domain namespace), so a firing
    names the slice whose nodes the caller promotes to SUSPECT, through
    the same :meth:`HealthFSM.promote_suspect` pin as the flip channel —
    never accelerating condemnation.  Pure arithmetic: no clock, no RNG
    (the TNC020 replay contract holds by construction).
    """

    def __init__(self, drift: float = CUSUM_DRIFT,
                 threshold: float = CUSUM_THRESHOLD,
                 headroom: float = LINK_HEADROOM):
        self.drift = float(drift)
        self.threshold = float(threshold)
        self.headroom = float(headroom)
        self._score: Dict[str, float] = {}
        self._armed: Dict[str, bool] = {}
        self.detections_total = 0
        # link -> round_seq of the current episode's first firing.
        self.active: Dict[str, int] = {}

    def observe(self, link: str, p50_us: float, budget_us: float,
                round_seq: int = 0) -> bool:
        """Advance one link's CUSUM by one probed round's timing sample.

        Returns True exactly once per episode — on the round the score
        first crosses the threshold.
        """
        drifting = budget_us > 0 and p50_us >= self.headroom * budget_us
        score = max(
            0.0,
            self._score.get(link, 0.0)
            + (1.0 if drifting else 0.0)
            - self.drift,
        )
        self._score[link] = score
        if score <= 0.0 and not self._armed.get(link, True):
            self._armed[link] = True
            self.active.pop(link, None)
        if score >= self.threshold and self._armed.get(link, True):
            self._armed[link] = False
            self.active[link] = round_seq
            self.detections_total += 1
            return True
        return False

    def score(self, link: str) -> float:
        return self._score.get(link, 0.0)

    def active_count(self) -> int:
        return len(self.active)

    def prune(self, live: set) -> None:
        """Forget every link outside ``live`` (this round's probed link
        set) — a drained slice's links must not sit in the standing
        prediction set forever, same policy as the flip channel's fleet
        prune.  The cost is deliberate: a link that skips a round restarts
        its episode, which only *delays* a detection — the conservative
        direction for an early-warning channel."""
        for link in set(self._score) - live:
            for d in (self._score, self._armed, self.active):
                d.pop(link, None)

    def snapshot(self) -> List[dict]:
        """Deterministic per-link view for the flaps query doc."""
        return [
            {
                "link": link,
                "score": round(self._score.get(link, 0.0), 3),
                "active": link in self.active,
            }
            for link in sorted(self._score)
            if self._score.get(link, 0.0) > 0.0 or link in self.active
        ]
