"""Seeded chaos fuzzer: sampled failure programs, graded, then shrunk.

A copy of the JAX package's ``sim/fuzz.py``, held equal to it by
``tests/test_torch_copies.py``.  :func:`sample_program` draws a whole-fleet
failure assignment, API fault rounds and watch losses from one seeded
``random.Random``; :func:`run_program` drives it through
:func:`engine.run_world` and grades the invariant matrix; :func:`shrink`
reduces a red program to a minimal reproducer (delete-one, halve-fleet,
shorten-rounds, to a fixpoint).  A program's ``"sabotage"`` entry injects
the over-budget cordon or the out-of-band uncordon that the matrix must
catch.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Tuple

from tpu_node_checker_torch import checker
from tpu_node_checker_torch.sim import fixtures as fx
from tpu_node_checker_torch.sim import invariants as inv
from tpu_node_checker_torch.sim.clock import wait_for
from tpu_node_checker_torch.sim.engine import ScenarioError, ScenarioResult, run_world
from tpu_node_checker_torch.sim.fleet import SimCluster
from tpu_node_checker_torch.sim.scenarios import (
    _base_argv,
    _cordoned,
    _patch_names,
    _sabotage_patch,
    _tick_round,
)

REPRODUCER_KIND = "tnc-sim-reproducer"
REPRODUCER_SCHEMA = 1

# Invariants every fuzzed program is graded against (relist-economy joins
# when the program injects watch losses; degraded-not-condemned and
# degraded-drain join when it draws a torn-link program).
FUZZ_INVARIANTS = ("exit-code-contract", "disruption-budget", "slice-floor",
                   "fsm-legality", "trace-completeness")

_PROGRAM_ARITY = {"steady": 1, "flap": 3, "flap-until": 4, "fail-at": 2,
                  "kubelet-down-at": 2, "torn-link": 2}


# ---------------------------------------------------------------------------
# sampling: one seeded draw over the failure-program grammar
# ---------------------------------------------------------------------------


def sample_program(seed: int) -> dict:
    """Draw one whole-fleet failure program from the chaos grammar.

    Everything — fleet shape, which hosts fail, how, and which rounds the
    transport misbehaves — comes from ONE ``random.Random(seed)``, in a
    fixed draw order, so the program is the seed's pure function."""
    rng = random.Random(seed)
    slices = rng.randint(2, 3)
    rounds = rng.randint(6, 8)
    hosts_per_slice = 4
    programs: Dict[str, List] = {}
    for s in range(slices):
        for h in range(hosts_per_slice):
            node = f"sim-c0-s{s}-h{h}"
            # ~25% of hosts get a failure program; the draw happens for
            # EVERY host so the stream stays aligned across candidates.
            if rng.random() >= 0.25:
                continue
            kind = rng.choice(("flap", "flap-until", "fail-at",
                               "kubelet-down-at", "torn-link"))
            if kind == "flap":
                period = rng.choice((2, 3))
                programs[node] = ["flap", rng.randrange(period), period]
            elif kind == "flap-until":
                period = rng.choice((2, 3))
                programs[node] = ["flap-until", rng.randrange(period), period,
                                  rng.randint(2, rounds - 2)]
            elif kind == "fail-at":
                programs[node] = ["fail-at", rng.randint(1, rounds - 1)]
            elif kind == "torn-link":
                programs[node] = ["torn-link", rng.randint(1, rounds - 1)]
            else:
                programs[node] = ["kubelet-down-at", rng.randint(1, rounds - 1)]
    api_faults: Dict[str, object] = {}
    if rng.random() < 0.5:
        # A burst round: a small absorbable fault list the default retry
        # budget must soak without changing the verdict.
        api_faults[str(rng.randint(1, rounds - 1))] = list(
            rng.choice((("429:0",), ("500",), ("429:0", "500")))
        )
    if rng.random() < 0.35:
        # A blackout round: connection resets all round — the checker must
        # exit 1 (error), never a fabricated verdict.
        r = rng.randint(1, rounds - 1)
        if str(r) not in api_faults:
            api_faults[str(r)] = "blackout"
    watch_loss: List[int] = []
    if rng.random() < 0.4:
        watch_loss = sorted(rng.sample(range(1, rounds),
                                       rng.randint(1, min(2, rounds - 1))))
    return {
        "slices": slices,
        "hosts_per_slice": hosts_per_slice,
        "rounds": rounds,
        "programs": programs,
        "api_faults": api_faults,
        "watch_loss": watch_loss,
        "sabotage": None,
    }


# ---------------------------------------------------------------------------
# execution: drive a program through the real checker and grade it
# ---------------------------------------------------------------------------


def _validate_program(program: dict) -> None:
    if not isinstance(program, dict):
        raise ScenarioError("reproducer program must be a JSON object")
    for key in ("slices", "rounds"):
        if not isinstance(program.get(key), int) or program[key] < 1:
            raise ScenarioError(f"program {key!r} must be a positive integer")
    for node, prog in (program.get("programs") or {}).items():
        if not prog or prog[0] not in _PROGRAM_ARITY:
            raise ScenarioError(
                f"unknown failure program {prog!r} on {node!r} "
                f"(grammar: {', '.join(sorted(_PROGRAM_ARITY))})"
            )
        if len(prog) != _PROGRAM_ARITY[prog[0]]:
            raise ScenarioError(
                f"failure program {prog!r} on {node!r}: expected "
                f"{_PROGRAM_ARITY[prog[0]]} elements"
            )
    for key, fault in (program.get("api_faults") or {}).items():
        if fault != "blackout" and not isinstance(fault, list):
            raise ScenarioError(
                f"api_faults[{key!r}] must be \"blackout\" or a fault list"
            )


def _stream_leg(world, rounds: int, losses: List[int],
                expected: List[int]) -> int:
    """The watch-loss injection leg: a REAL ``StreamRoundEngine`` against
    a static healthy slice, losing its stream on the drawn rounds.  Grades
    the relist economy — exactly one LIST per loss, plus the bootstrap."""
    from tpu_node_checker_torch import cli as round_cli
    from tpu_node_checker_torch.watchstream import StreamRoundEngine

    cluster = SimCluster("sim-stream", slices=1, hosts_per_slice=4)
    script = fx.WatchScript([], clock=world.clock)
    list_requests: List[int] = []
    server = fx.serve_http(fx.watch_nodelist_handler(
        cluster.nodes(0), script, resource_version="100",
        list_requests=list_requests,
    ))
    world.on_cleanup(server.shutdown)
    world.on_cleanup(script.close)
    kc = world.kubeconfig(server.server_address[1], "stream")
    args = round_cli.parse_args([
        "--kubeconfig", kc, "--watch", "5", "--watch-stream",
        "--strict-slices", "--json", "--retry-budget", "0",
    ])
    engine = StreamRoundEngine(args)
    world.on_cleanup(engine.close)
    loss_rounds = set(losses)
    for r in range(rounds):
        if r in loss_rounds:
            script.push(None)  # server ends the stream cleanly
            wait_for(lambda: not engine.stream_alive(),
                     what="stream worker exit")
        rec = _tick_round(world, engine, r, cluster="sim-stream")
        world.commit(rec)
        expected.append(checker.EXIT_OK)
        world.event(f"stream round={r} lists={len(list_requests)} "
                    f"connections={script.connections}")
    return len(list_requests)


def _program_runner(world, program: dict) -> None:
    _validate_program(program)
    slices = program["slices"]
    hosts_per_slice = program.get("hosts_per_slice", 4)
    rounds = program["rounds"]
    cluster = SimCluster("sim-c0", slices=slices,
                         hosts_per_slice=hosts_per_slice)
    for node, prog in sorted((program.get("programs") or {}).items()):
        if node not in cluster.programs:
            raise ScenarioError(
                f"program names unknown node {node!r} (fleet is "
                f"{slices} slice(s) x {hosts_per_slice} hosts)"
            )
        cluster.programs[node] = tuple(prog)
    api_faults = {int(k): v
                  for k, v in (program.get("api_faults") or {}).items()}
    # Losses outside [1, rounds) have no stream to kill: round 0 IS the
    # bootstrap LIST.  Filtering (not failing) keeps shrink candidates
    # that trimmed rounds valid.
    watch_loss = sorted(x for x in (program.get("watch_loss") or [])
                        if 1 <= int(x) < rounds)
    sabotage = program.get("sabotage") or None
    world.event(
        f"fuzz fleet slices={slices} hosts-per-slice={hosts_per_slice} "
        f"rounds={rounds} programs={len(program.get('programs') or {})} "
        f"api-faults={len(api_faults)} watch-loss={len(watch_loss)} "
        f"sabotage={'round-' + str(sabotage['round']) if sabotage else 'none'}"
    )
    server, state = fx.storm_apiserver(cluster.nodes(0))
    world.on_cleanup(server.shutdown)
    port = server.server_address[1]
    kc = world.kubeconfig(port, "c0")
    floor_chips = cluster.chips_per_slice() // 2  # --slice-floor-pct 50
    expected: List[int] = []
    patches_per_round: List[int] = []
    floor_timeline: List[Dict[str, int]] = []
    flags = [
        "--strict-slices",
        "--history", world.history_path("c0"),
        "--cordon-after", "2", "--cordon-failed", "--cordon-degraded",
        "--cordon-max", "8",
        "--slice-floor-pct", "50", "--disruption-budget", "2",
    ]
    # torn-link ground truth: hosts whose link tears inside the run —
    # they keep passing verdicts (never in down()), so the exit-code
    # oracle ignores them; the degraded invariants below do not.
    torn = sorted(n for n, prog in cluster.programs.items()
                  if prog[0] == "torn-link" and prog[1] < rounds)
    patch_timeline: List[List[str]] = []
    for r in range(rounds):
        fault = api_faults.get(r)
        blackout = fault == "blackout"
        if fault is None:
            state["schedule"] = None
        elif blackout:
            state["schedule"] = fx.FaultSchedule([], then="reset",
                                                 clock=world.clock)
        else:
            state["schedule"] = fx.FaultSchedule(list(fault),
                                                 clock=world.clock)
        # kubelet-down programs flip readiness IN PLACE: replacing the
        # node dicts would silently wipe the checker's own cordons.
        for nd in state["nodes"]:
            nm = nd["metadata"]["name"]
            nd["status"]["conditions"] = fx.make_node(
                nm, ready=not cluster._kubelet_down(nm, r)
            )["status"]["conditions"]
        reports = world.write_reports("c0", cluster.verdicts(r),
                                      degraded=cluster.degraded(r))
        if blackout:
            expected.append(checker.EXIT_ERROR)
        else:
            # --strict-slices: ANY program-down host tears its slice; our
            # own cordons deliberately do not change grading.
            expected.append(checker.EXIT_NONE_READY if cluster.down(r)
                            else checker.EXIT_OK)
        before = len(state["patches"])
        if fault is not None and not blackout:
            # Burst rounds run with the DEFAULT retry budget: the oracle
            # says the verdict must not notice the faults.
            argv = ["--kubeconfig", kc, "--probe-results", reports,
                    "--json", "--api-concurrency", "1", *flags]
        else:
            argv = _base_argv(kc, reports, *flags)
        _result, rec = world.checker_round(argv, r, "sim-c0")
        if sabotage and r == int(sabotage["round"]):
            if sabotage.get("kind") == "uncordon-degraded":
                # Deliberate violation (tests only): resurrect every
                # drained torn-link host behind the budget engine's back
                # — the degraded-drain invariant must notice the slice
                # is no longer drained.
                for host in sorted(cluster.degraded(r)):
                    if host in _cordoned(state):
                        _sabotage_patch(port, host, unschedulable=False)
                world.event(f"sabotage round={r} uncordon-degraded")
            else:
                # Deliberate violation (tests only): cordon every
                # remaining host behind the budget engine's back.
                for host in sorted(cluster.node_names()):
                    if host not in _cordoned(state):
                        _sabotage_patch(port, host)
                world.event(f"sabotage round={r} over-budget fleet-wide")
        rec["patches"] = _patch_names(state, before)
        patch_timeline.append(rec["patches"])
        patches_per_round.append(len(rec["patches"]))
        floor_timeline.append(fx.available_by_slice(
            cluster.by_slice, cluster.chips_per_host, state["nodes"]
        ))
        world.commit(rec)
    lists = _stream_leg(world, rounds, watch_loss, expected) \
        if watch_loss else None
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 1, 3}))
    world.grade(inv.check_disruption_budget(patches_per_round, 2))
    world.grade(inv.check_slice_floor(floor_timeline, floor_chips))
    world.grade(inv.check_fsm_legality(world.records))
    if torn:
        # The degraded invariants join only when the grammar drew a
        # torn-link program — same pattern as relist-economy below.
        world.grade(inv.check_degraded_not_condemned(world.records, torn))
        world.grade(inv.check_degraded_drain(patch_timeline, torn,
                                             world.records))
    if lists is not None:
        world.grade(inv.check_relist_economy(
            lists, expected=1 + len(watch_loss)
        ))
    world.grade(inv.check_trace_completeness(world.records))


def run_program(program: dict, seed: int = 0) -> ScenarioResult:
    """Run one failure program (sampled or replayed) through the full
    world machinery and grade it.  ``seed`` is provenance for the report;
    the program itself is pure data and fully determines the run."""
    params = {
        "clusters": 1,
        "nodes_per_cluster":
            program.get("slices", 1) * program.get("hosts_per_slice", 4)
            if isinstance(program, dict) else 0,
        "rounds": program.get("rounds", 0) if isinstance(program, dict) else 0,
    }
    return run_world("fuzz", seed, params,
                     lambda world: _program_runner(world, program))


def violated(result: ScenarioResult) -> List[str]:
    """Names of the invariants a run violated, sorted."""
    return sorted(v["name"] for v in result.report["invariants"]
                  if not v["ok"])


# ---------------------------------------------------------------------------
# shrinking: delete-one / halve-fleet / shorten-rounds, each re-verified
# ---------------------------------------------------------------------------


def _copy(program: dict) -> dict:
    return json.loads(json.dumps(program))


def _halved(program: dict) -> Optional[dict]:
    new_slices = program["slices"] // 2
    if new_slices < 1:
        return None
    cand = _copy(program)
    cand["slices"] = new_slices
    keep = {f"sim-c0-s{s}-h{h}"
            for s in range(new_slices)
            for h in range(cand.get("hosts_per_slice", 4))}
    cand["programs"] = {n: p for n, p in (cand.get("programs") or {}).items()
                        if n in keep}
    return cand


def _shortened(program: dict) -> Optional[dict]:
    floor = 1
    sabotage = program.get("sabotage") or None
    if sabotage:
        # The sabotage round must still exist, or the candidate no longer
        # contains the violation it is supposed to pin.
        floor = int(sabotage["round"]) + 1
    if program["rounds"] - 1 < floor:
        return None
    cand = _copy(program)
    cand["rounds"] -= 1
    return cand


def shrink(program: dict, invariant: str) -> Tuple[dict, List[str]]:
    """Reduce ``program`` to a minimal program still violating
    ``invariant``.  Every candidate is re-run and kept only if the SAME
    invariant stays red; passes loop to a fixpoint.  Pure function of its
    inputs — no rng, no wall clock — so shrinking replays exactly."""

    def is_red(cand: dict) -> bool:
        return invariant in violated(run_program(cand))

    current = _copy(program)
    steps: List[str] = []
    changed = True
    while changed:
        changed = False
        for node in sorted(current.get("programs") or {}):
            if node not in current["programs"]:
                continue
            cand = _copy(current)
            del cand["programs"][node]
            if is_red(cand):
                current = cand
                steps.append(f"delete-program {node}")
                changed = True
        for key in sorted(current.get("api_faults") or {}):
            if key not in current["api_faults"]:
                continue
            cand = _copy(current)
            del cand["api_faults"][key]
            if is_red(cand):
                current = cand
                steps.append(f"drop-fault round {key}")
                changed = True
        for loss in list(current.get("watch_loss") or []):
            cand = _copy(current)
            cand["watch_loss"] = [x for x in cand["watch_loss"] if x != loss]
            if is_red(cand):
                current = cand
                steps.append(f"drop-watch-loss round {loss}")
                changed = True
        while True:
            cand = _halved(current)
            if cand is None or not is_red(cand):
                break
            current = cand
            steps.append(f"halve-fleet to {cand['slices']} slice(s)")
            changed = True
        while True:
            cand = _shortened(current)
            if cand is None or not is_red(cand):
                break
            current = cand
            steps.append(f"shorten-rounds to {cand['rounds']}")
            changed = True
    return current, steps


# ---------------------------------------------------------------------------
# the fuzz campaign and its replayable artifacts
# ---------------------------------------------------------------------------


def make_reproducer(program: dict, seed: int, invariant: Optional[str],
                    expect: str = "red", ref: Optional[str] = None) -> dict:
    """The checked-in regression artifact: pure data, replayable byte for
    byte by ``tnc simulate --replay`` and the ``tests/sim_reproducers/``
    harness."""
    return {
        "schema": REPRODUCER_SCHEMA,
        "kind": REPRODUCER_KIND,
        "seed": seed,
        "expect": expect,
        "invariant": invariant,
        "ref": ref,
        "program": program,
    }


def run_fuzz(base_seed: int, seeds: int) -> dict:
    """One fuzz campaign: ``seeds`` sampled programs from consecutive
    seeds, each graded; the FIRST violation is shrunk to a minimal
    reproducer.  The report is a pure function of (base_seed, seeds)."""
    runs: List[dict] = []
    reproducer: Optional[dict] = None
    shrink_steps: Optional[List[str]] = None
    for i in range(seeds):
        seed = base_seed + i
        program = sample_program(seed)
        result = run_program(program, seed=seed)
        bad = violated(result)
        runs.append({
            "seed": seed,
            "ok": not bad,
            "violated": bad,
            "slices": program["slices"],
            "rounds": program["rounds"],
            "programs": len(program["programs"]),
            "api_faults": len(program["api_faults"]),
            "watch_loss": len(program["watch_loss"]),
        })
        if bad and reproducer is None:
            name = bad[0]
            shrunk, shrink_steps = shrink(program, name)
            reproducer = make_reproducer(
                shrunk, seed=seed, invariant=name,
                ref=f"fuzz base_seed={base_seed} seed={seed}",
            )
    return {
        "schema": 1,
        "mode": "fuzz",
        "base_seed": base_seed,
        "seeds": seeds,
        "ok": all(r["ok"] for r in runs),
        "runs": runs,
        "reproducer": reproducer,
        "shrink_steps": shrink_steps,
    }


def fuzz_report_json(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True) + "\n"
