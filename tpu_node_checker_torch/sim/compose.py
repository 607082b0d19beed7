"""Scenario composition: a transport-fault scenario stacked on a
failure-program scenario, graded on the union of both invariant sets.

A copy of the JAX package's ``sim/compose.py``, held equal to it by
``tests/test_torch_copies.py``.  A program layer (``PROGRAM_LAYERS``) shapes
the fleet's failure programs, flags, exit oracle and program-side
invariants; a fault layer (``FAULT_LAYERS``) owns the simulated API server's
fault front and the transport-side invariants.  ``compose(a, b)`` takes one
of each, in either order, and registers ``"<program>+<fault>"`` in
``SCENARIOS``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from tpu_node_checker_torch import checker
from tpu_node_checker_torch.sim import fixtures as fx
from tpu_node_checker_torch.sim import invariants as inv
from tpu_node_checker_torch.sim.engine import Scenario, ScenarioError, SimWorld
from tpu_node_checker_torch.sim.fleet import SimCluster, synth_cluster


@dataclass(frozen=True)
class ProgramLayer:
    """One composable WHO-fails axis (see module docstring)."""

    name: str
    setup: Callable[[SimWorld, SimCluster], dict]
    flags: Callable[[SimWorld], List[str]]
    oracle: Callable[[SimCluster, int], int]
    grade: Callable[[SimWorld, dict, dict], None]
    invariants: Tuple[str, ...]
    observed_rounds: int  # completed rounds the program's script needs
    slack_bound: int      # standalone alert-fingerprint bound (rule 6)
    floor_pct: int = 50   # must match the --slice-floor-pct the flags set


@dataclass(frozen=True)
class FaultLayer:
    """One composable HOW-the-transport-fails axis."""

    name: str
    mode: Callable[[int], str]  # round -> "ok" | "burst" | "blackout"
    schedule: Callable[[SimWorld, str], object]
    grade: Callable[[SimWorld, dict], None]
    invariants: Tuple[str, ...]
    hidden_rounds: int     # error rounds the history tier never sees
    alert_allowance: int   # extra fingerprint moves it may cause (rule 6)


# ---------------------------------------------------------------------------
# program layer: flap-storm
# ---------------------------------------------------------------------------


def _flap_storm_setup(world: SimWorld, cluster: SimCluster) -> dict:
    flappers = cluster.assign(world.rng, lambda i: ("flap", 1, 2),
                              per_slice=1)
    # die_at 6 lands just past the fault layer's blackout window, so the
    # decay is OBSERVED: flap prodrome before, hard failure after.
    decayers = cluster.assign(world.rng,
                              lambda i: ("flap-until", 2, 3, 6),
                              per_slice=1)
    world.event(f"fleet slices={len(cluster.by_slice)} "
                f"flappers={','.join(sorted(flappers))} "
                f"decayers={','.join(sorted(decayers))}")
    return {"flappers": flappers, "decayers": decayers}


def _flap_storm_flags(world: SimWorld) -> List[str]:
    # The standalone flap-storm grading stack; see _run_flap_storm for the
    # threshold rationale (CHRONIC from flips, FAILED from consecutives).
    return [
        "--history", world.history_path("c0"),
        "--analytics", world.analytics_dir("c0"),
        "--cordon-after", "3", "--flap-threshold", "6",
        "--cordon-failed", "--cordon-max", "8",
        "--slice-floor-pct", "50", "--disruption-budget", "2",
    ]


def _flap_storm_oracle(cluster: SimCluster, round_i: int) -> int:
    down = cluster.down(round_i)
    return (checker.EXIT_NONE_READY
            if len(down) == len(cluster.node_names())
            else checker.EXIT_OK)


def _flap_storm_grade(world: SimWorld, ctx: dict, ledger: dict) -> None:
    world.grade(inv.check_disruption_budget(ledger["patches_per_round"], 2))
    world.grade(inv.check_slice_floor(ledger["floor_timeline"],
                                      ledger["floor_chips"]))
    world.grade(inv.check_fsm_legality(world.records))
    world.grade(inv.check_slack_dedup(world.records,
                                      max_alerts=ledger["max_alerts"]))
    world.grade(inv.check_prediction_precedes_failure(
        world.records, sorted(ctx["flappers"]) + sorted(ctx["decayers"])
    ))


# ---------------------------------------------------------------------------
# fault layer: api-brownout
# ---------------------------------------------------------------------------

_BROWNOUT_BURST_ROUND = 1
_BROWNOUT_BLACKOUT = range(2, 5)


def _brownout_mode(round_i: int) -> str:
    if round_i == _BROWNOUT_BURST_ROUND:
        return "burst"
    if round_i in _BROWNOUT_BLACKOUT:
        return "blackout"
    return "ok"


def _brownout_schedule(world: SimWorld, mode: str):
    if mode == "burst":
        # A finite fault burst the default retry budget must absorb.
        return fx.FaultSchedule(["429:0", "500"], clock=world.clock)
    if mode == "blackout":
        # Every request RSTs; with retries off the round is exit 1.
        return fx.FaultSchedule([], then="reset", clock=world.clock)
    return None


def _brownout_grade(world: SimWorld, ledger: dict) -> None:
    world.grade(inv.check_retry_absorption(
        world.records, _BROWNOUT_BURST_ROUND, min_retries=2
    ))
    world.grade(inv.check_breaker_legality(
        ledger["breaker_timeline"], ledger["breaker_threshold"],
        ledger["breaker_max_scale"],
    ))


PROGRAM_LAYERS: Dict[str, ProgramLayer] = {
    "flap-storm": ProgramLayer(
        name="flap-storm",
        setup=_flap_storm_setup,
        flags=_flap_storm_flags,
        oracle=_flap_storm_oracle,
        grade=_flap_storm_grade,
        invariants=("exit-code-contract", "disruption-budget",
                    "slice-floor", "fsm-legality", "slack-dedup",
                    "prediction-precedes-failure", "trace-completeness"),
        observed_rounds=9,
        slack_bound=3,
    ),
}

FAULT_LAYERS: Dict[str, FaultLayer] = {
    "api-brownout": FaultLayer(
        name="api-brownout",
        mode=_brownout_mode,
        schedule=_brownout_schedule,
        grade=_brownout_grade,
        invariants=("exit-code-contract", "retry-absorption",
                    "breaker-legality", "trace-completeness"),
        hidden_rounds=len(_BROWNOUT_BLACKOUT),
        alert_allowance=3,
    ),
}


def _composed_runner(prog: ProgramLayer,
                     fault: FaultLayer) -> Callable[[SimWorld], None]:
    def runner(world: SimWorld) -> None:
        # Lazy import: scenarios.py registers the composed entries at the
        # end of its own module body, so this closure only runs after both
        # modules are fully loaded.
        from tpu_node_checker_torch.sim.scenarios import (
            _available_by_slice,
            _base_argv,
            _patch_names,
        )

        p = world.params
        cluster = synth_cluster("sim-c0", p["nodes_per_cluster"],
                                min_slices=2)
        ctx = prog.setup(world, cluster)
        server, state = fx.storm_apiserver(cluster.nodes())
        world.on_cleanup(server.shutdown)
        kc = world.kubeconfig(server.server_address[1], "c0")
        breaker = checker.WatchBreaker()
        ledger = {
            "patches_per_round": [],
            "floor_timeline": [],
            "breaker_timeline": [],
            "breaker_threshold": breaker.threshold,
            "breaker_max_scale": breaker.max_scale,
            "floor_chips": cluster.chips_per_slice() * prog.floor_pct // 100,
            "max_alerts": prog.slack_bound + fault.alert_allowance,
        }
        expected: List[int] = []
        for r in range(p["rounds"]):
            mode = fault.mode(r)
            # Rule 1: the fault layer owns the handler front.
            state["schedule"] = fault.schedule(world, mode)
            reports = world.write_reports("c0", cluster.verdicts(r))
            flags = prog.flags(world)
            if mode == "burst":
                # Rule 3: the fault layer's transport posture wins on its
                # scripted rounds — default retry budget absorbs the burst.
                argv = ["--kubeconfig", kc, "--probe-results", reports,
                        "--json", "--api-concurrency", "1", *flags]
            else:
                argv = _base_argv(kc, reports, *flags)
            # Rule 4: fault-layer error rounds dominate the exit oracle.
            expected.append(checker.EXIT_ERROR if mode == "blackout"
                            else prog.oracle(cluster, r))
            before = len(state["patches"])
            _result, rec = world.checker_round(argv, r, "sim-c0")
            rec["patches"] = _patch_names(state, before)
            ledger["patches_per_round"].append(len(rec["patches"]))
            ledger["floor_timeline"].append(_available_by_slice(
                cluster.by_slice, cluster.chips_per_host, state["nodes"]
            ))
            event = (breaker.record_failure() if rec["exit_code"] == 1
                     else breaker.record_success())
            step = {
                "consecutive_failures": breaker.consecutive_failures,
                "open": breaker.open,
                "interval_scale": breaker.interval_scale(),
                "event": event,
            }
            ledger["breaker_timeline"].append(step)
            world.commit(rec)
            world.event(
                f"composed round={r} mode={mode} "
                f"cf={step['consecutive_failures']} open={step['open']} "
                f"event={step['event']}"
            )
        # Rule 5: shared invariants graded once over the merged run, then
        # each layer's own.
        world.grade(inv.check_exit_codes(world.records, expected=expected,
                                         allowed={0, 1, 3}))
        prog.grade(world, ctx, ledger)
        fault.grade(world, ledger)
        world.grade(inv.check_trace_completeness(world.records))

    return runner


def _union_invariants(a: Tuple[str, ...],
                      b: Tuple[str, ...]) -> Tuple[str, ...]:
    seen: List[str] = []
    for name in (*a, *b):
        if name not in seen:
            seen.append(name)
    return tuple(seen)


def compose(name_a: str, name_b: str) -> Scenario:
    """Build the composed scenario ``<program>+<fault>`` from two parent
    names, in either order.  Raises :class:`ScenarioError` unless exactly
    one parent is a registered program layer and the other a fault layer
    (the layering rules above have nothing to say about two same-axis
    parents — they would fight over the fleet's programs or the handler
    front, so the combinator refuses them loudly)."""
    layers = {}
    declared: Dict[str, Tuple[str, ...]] = {}
    for n in (name_a, name_b):
        if n in PROGRAM_LAYERS:
            kind, layer = "program", PROGRAM_LAYERS[n]
        elif n in FAULT_LAYERS:
            kind, layer = "fault", FAULT_LAYERS[n]
        else:
            composable = sorted(set(PROGRAM_LAYERS) | set(FAULT_LAYERS))
            raise ScenarioError(
                f"scenario {n!r} has no composition layer (composable: "
                f"{', '.join(composable)})"
            )
        if kind in layers:
            raise ScenarioError(
                f"cannot compose {name_a!r}+{name_b!r}: composition stacks "
                "exactly one fault layer on one program layer (two "
                f"{kind} layers would fight over the same seam)"
            )
        layers[kind] = layer
        declared[n] = layer.invariants
    prog, fault = layers["program"], layers["fault"]
    rounds = prog.observed_rounds + fault.hidden_rounds
    return Scenario(
        name=f"{prog.name}+{fault.name}",
        title=f"Composed: {fault.name} stacked on {prog.name} — the union "
              "of both invariant sets over one run",
        runner=_composed_runner(prog, fault),
        defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": rounds,
                  "min_rounds": rounds},
        # Rule 5: declared union in PARENT order (name_a's first).
        invariants=_union_invariants(declared[name_a], declared[name_b]),
        # Rule 2: the round count is part of the layering contract (the
        # fault window positions are script-fixed), so only fleet size
        # scales.
        tunable=("nodes_per_cluster",),
    )


#: The composed entries scenarios.py registers as first-class grid members.
COMPOSED: Tuple[Scenario, ...] = (
    compose("flap-storm", "api-brownout"),
)
