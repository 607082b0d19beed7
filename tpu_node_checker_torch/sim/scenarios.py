"""The scenario grid: named, seed-replayable chaos scripts over the port's
checker and aggregator machinery.

A copy of the JAX package's ``sim/scenarios.py``, held equal to it by
``tests/test_torch_copies.py``.  Every scenario drives ``checker.run_check``
rounds, the ``StreamRoundEngine`` watch tick or the ``FederationEngine``
merge against the simulated API servers of
:mod:`tpu_node_checker_torch.sim.fixtures`, then grades the run with
:mod:`tpu_node_checker_torch.sim.invariants`.  Expected exit codes come from
the scenario's own ground truth.  The composed scenarios
(:mod:`tpu_node_checker_torch.sim.compose`) join ``SCENARIOS`` at the
bottom of this module.
"""

from __future__ import annotations

import http.client
import json
from typing import Dict, List

from tpu_node_checker_torch import checker
from tpu_node_checker_torch.obs.trace import Tracer
from tpu_node_checker_torch.sim import fixtures as fx
from tpu_node_checker_torch.sim import invariants as inv
from tpu_node_checker_torch.sim.clock import wait_for
from tpu_node_checker_torch.sim.engine import Scenario, SimWorld
from tpu_node_checker_torch.sim.fleet import SimCluster, synth_cluster


_available_by_slice = fx.available_by_slice


def _cordoned(state: dict) -> set:
    return {
        n["metadata"]["name"]
        for n in state["nodes"]
        if n["spec"].get("unschedulable")
    }


def _patch_names(state: dict, start: int) -> List[str]:
    """Canonical ``node:action`` strings for this round's server-side
    PATCH log delta."""
    out = []
    for patch in state["patches"][start:]:
        spec = patch["body"].get("spec") or {}
        if spec.get("unschedulable") is True:
            action = "cordon"
        elif "unschedulable" in spec:
            action = "uncordon"
        else:
            action = "annotate"
        out.append(f"{patch['node']}:{action}")
    return out


def _base_argv(kubeconfig: str, reports: str, *extra: str) -> List[str]:
    # --api-concurrency 1: the actuation fan-out normally PATCHes in
    # parallel, which makes the server-side ARRIVAL order racy — and the
    # request log is digested into the byte-replayable report.
    return ["--kubeconfig", kubeconfig, "--probe-results", reports,
            "--json", "--retry-budget", "0", "--api-concurrency", "1",
            *extra]


def _sabotage_patch(port: int, node: str,
                    unschedulable: bool = True) -> None:
    """An UNBUDGETED cordon (or, with ``unschedulable=False``, uncordon)
    PATCH straight at the simulated apiserver — the deliberate contract
    violation the tests inject to prove the matrix catches breakage
    instead of rubber-stamping green."""
    body = json.dumps({"spec": {"unschedulable": unschedulable}}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("PATCH", f"/api/v1/nodes/{node}", body=body,
                     headers={"Content-Type": "application/json"})
        conn.getresponse().read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# flap-storm: chronic flappers, debounce, CHRONIC quarantine
# ---------------------------------------------------------------------------


def _run_flap_storm(world: SimWorld) -> None:
    p = world.params
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"], min_slices=2)
    flappers = cluster.assign(world.rng, lambda i: ("flap", 1, 2),
                              per_slice=1)
    # Decayers: flapping as the PRODROME of a hard failure — period-3
    # flaps until round 6, then failed forever.  The changepoint detector
    # must fire on the flapping (round 5, a GOOD round, so the promotion
    # seam moves HEALTHY→SUSPECT) before --cordon-after 3 consecutive bad
    # rounds condemn the node FAILED at round 8 — the
    # prediction-precedes-failure invariant.
    decayers = cluster.assign(world.rng,
                              lambda i: ("flap-until", 2, 3, 6),
                              per_slice=1)
    world.event(f"fleet slices={len(cluster.by_slice)} "
                f"flappers={','.join(sorted(flappers))} "
                f"decayers={','.join(sorted(decayers))}")
    server, state = fx.storm_apiserver(cluster.nodes())
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    floor_chips = cluster.chips_per_slice() // 2  # --slice-floor-pct 50
    expected: List[int] = []
    patches_per_round: List[int] = []
    floor_timeline: List[Dict[str, int]] = []
    for r in range(p["rounds"]):
        # Flappers are a minority: the fleet keeps at least one effective
        # node every round, so the aggregate verdict must stay 0 — the
        # churn lands in the FSM/sick-set layers, not the exit code.
        down = cluster.down(r)
        expected.append(checker.EXIT_NONE_READY
                        if len(down) == len(cluster.node_names())
                        else checker.EXIT_OK)
        reports = world.write_reports("c0", cluster.verdicts(r))
        before = len(state["patches"])
        _result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--history", world.history_path("c0"),
            "--analytics", world.analytics_dir("c0"),
            # --cordon-after 3: a period-2 flapper can never string 3 bad
            # rounds together, so quarantine comes from the CHRONIC flap
            # trap — the layer this scenario exists to exercise.
            "--cordon-after", "3",
            # --flap-threshold 6: the period-2 flappers still trip CHRONIC
            # (6 flips by round 6) while the decayers' 5 in-window flips
            # stay below it — their condemnation must come from FAILED,
            # the edge the prediction invariant measures against.
            "--flap-threshold", "6",
            "--cordon-failed", "--cordon-max", "8",
            "--slice-floor-pct", "50", "--disruption-budget", "2",
        ), r, "sim-c0")
        rec["patches"] = _patch_names(state, before)
        patches_per_round.append(len(rec["patches"]))
        floor_timeline.append(_available_by_slice(
            cluster.by_slice, cluster.chips_per_host, state["nodes"]
        ))
        world.commit(rec)
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 3}))
    world.grade(inv.check_disruption_budget(patches_per_round, 2))
    world.grade(inv.check_slice_floor(floor_timeline, floor_chips))
    world.grade(inv.check_fsm_legality(world.records))
    # The flap-proof-quarantine payoff: the debounced fingerprint moves
    # TWICE (the CHRONIC promotion, then the decayers' FAILED), never
    # once per flap.
    world.grade(inv.check_slack_dedup(world.records, max_alerts=3))
    world.grade(inv.check_prediction_precedes_failure(
        world.records, sorted(flappers) + sorted(decayers)
    ))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# mass-cordon-storm: the quarantine acceptance storm as a named scenario
# ---------------------------------------------------------------------------


def _run_mass_cordon_storm(world: SimWorld) -> None:
    p = world.params
    slices = max(2, p["nodes_per_cluster"] // 4)
    storm = fx.StormSchedule(seed=world.seed, slices=slices,
                             hosts_per_slice=4, chips_per_host=4,
                             fail_round=1, fail_fraction=0.75,
                             flappers_per_slice=1, name_prefix="sim-c0")
    world.event(f"fleet slices={slices} "
                f"failed={','.join(sorted(storm.failed))} "
                f"flappers={','.join(sorted(storm.flappers))}")
    server, state = fx.storm_apiserver(storm.nodes())
    world.on_cleanup(server.shutdown)
    port = server.server_address[1]
    kc = world.kubeconfig(port, "c0")
    floor_chips = (storm.chips_per_host * 4) // 2  # --slice-floor-pct 50
    expected: List[int] = []
    patches_per_round: List[int] = []
    floor_timeline: List[Dict[str, int]] = []
    sabotage_round = p["rounds"] // 2
    for r in range(p["rounds"]):
        verd = storm.verdicts(r)
        # Under --strict-slices any program-down host tears its slice;
        # our own cordons deliberately do NOT change grading (quarantine
        # rides above it), so the oracle ignores them.
        down = {n for n, ok in verd.items() if not ok}
        expected.append(checker.EXIT_NONE_READY if down else checker.EXIT_OK)
        reports = world.write_reports("c0", verd)
        before = len(state["patches"])
        _result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--strict-slices",
            "--cordon-failed", "--cordon-max", "8",
            "--slice-floor-pct", "50", "--disruption-budget", "2",
        ), r, "sim-c0")
        if world.sabotage == "over-budget" and r == sabotage_round:
            # Deliberate violation (tests only): cordon every remaining
            # host behind the budget engine's back — past budget AND
            # below floor in one stroke.
            for host in sorted(storm.node_names()):
                if host not in _cordoned(state):
                    _sabotage_patch(port, host)
            world.event(f"sabotage round={r} over-budget fleet-wide")
        rec["patches"] = _patch_names(state, before)
        patches_per_round.append(len(rec["patches"]))
        floor_timeline.append(_available_by_slice(
            storm.by_slice, storm.chips_per_host, state["nodes"]
        ))
        world.commit(rec)
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 3}))
    world.grade(inv.check_disruption_budget(patches_per_round, 2))
    world.grade(inv.check_slice_floor(floor_timeline, floor_chips))
    world.grade(inv.check_denials_visible(world.records, from_round=1))
    world.grade(inv.check_slack_dedup(world.records,
                                      max_alerts=4 + slices))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# api-brownout: 429/5xx bursts absorbed, a black-hole trips the breaker
# ---------------------------------------------------------------------------


def _run_api_brownout(world: SimWorld) -> None:
    p = world.params
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"])
    server, state = fx.storm_apiserver(cluster.nodes())
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    breaker = checker.WatchBreaker()
    breaker_timeline: List[dict] = []
    expected: List[int] = []
    # Round script: healthy → absorbed burst → 3-round black-hole (trips
    # the breaker) → recovery (the else branch, closes it).
    burst_round, blackout = 1, range(2, 5)
    for r in range(p["rounds"]):
        reports = world.write_reports("c0", cluster.verdicts(r))
        if r == burst_round:
            # Finite fault burst with a GENEROUS retry budget: the ladder
            # must absorb exactly these faults and exit 0.
            state["schedule"] = fx.FaultSchedule(["429:0", "500"],
                                                 clock=world.clock)
            argv = ["--kubeconfig", kc, "--probe-results", reports, "--json"]
            expected.append(checker.EXIT_OK)
        elif r in blackout:
            # Every request RSTs and retries are off: the documented
            # exit-1 round, charged to the breaker like the watch loop
            # does.
            state["schedule"] = fx.FaultSchedule([], then="reset",
                                                 clock=world.clock)
            argv = _base_argv(kc, reports)
            expected.append(checker.EXIT_ERROR)
        else:
            state["schedule"] = None
            argv = _base_argv(kc, reports)
            expected.append(checker.EXIT_OK)
        _result, rec = world.checker_round(argv, r, "sim-c0")
        event = (breaker.record_failure() if rec["exit_code"] == 1
                 else breaker.record_success())
        step = {
            "consecutive_failures": breaker.consecutive_failures,
            "open": breaker.open,
            "interval_scale": breaker.interval_scale(),
            "event": event,
        }
        breaker_timeline.append(step)
        world.commit(rec)
        world.event(
            f"breaker round={r} cf={step['consecutive_failures']} "
            f"open={step['open']} scale={step['interval_scale']} "
            f"event={step['event']}"
        )
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 1}))
    world.grade(inv.check_retry_absorption(world.records, burst_round,
                                           min_retries=2))
    world.grade(inv.check_breaker_legality(
        breaker_timeline, breaker.threshold, breaker.max_scale
    ))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# slow-drain: staggered permanent failures trickle through the budget
# ---------------------------------------------------------------------------


def _run_slow_drain(world: SimWorld) -> None:
    p = world.params
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"], min_slices=2)
    drainers = cluster.assign(
        world.rng, lambda i: ("fail-at", 2 + 2 * i), per_slice=1
    )
    world.event(f"fleet slices={len(cluster.by_slice)} "
                f"drainers={','.join(sorted(drainers))}")
    server, state = fx.storm_apiserver(cluster.nodes())
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    floor_chips = cluster.chips_per_slice() // 2
    expected: List[int] = []
    patches_per_round: List[int] = []
    floor_timeline: List[Dict[str, int]] = []
    for r in range(p["rounds"]):
        down = cluster.down(r)
        expected.append(checker.EXIT_NONE_READY if down else checker.EXIT_OK)
        reports = world.write_reports("c0", cluster.verdicts(r))
        before = len(state["patches"])
        _result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--strict-slices",
            "--history", world.history_path("c0"),
            "--cordon-failed", "--cordon-max", "8",
            "--slice-floor-pct", "50", "--disruption-budget", "1",
        ), r, "sim-c0")
        rec["patches"] = _patch_names(state, before)
        patches_per_round.append(len(rec["patches"]))
        floor_timeline.append(_available_by_slice(
            cluster.by_slice, cluster.chips_per_host, state["nodes"]
        ))
        world.commit(rec)
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 3}))
    world.grade(inv.check_disruption_budget(patches_per_round, 1))
    world.grade(inv.check_slice_floor(floor_timeline, floor_chips))
    world.grade(inv.check_fsm_legality(world.records))
    # One alert per drain onset plus the healthy baseline.
    fails_seen = sum(
        1 for d in drainers
        if cluster.programs[d][1] < p["rounds"]
    )
    world.grade(inv.check_slack_dedup(world.records,
                                      max_alerts=1 + fails_seen))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# torn-slice: the kubelet tears a slice — no chip fault anywhere
# ---------------------------------------------------------------------------


def _run_torn_slice(world: SimWorld) -> None:
    p = world.params
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"], min_slices=2)
    first_pool = sorted(cluster.by_slice)[0]
    torn = cluster.assign(
        world.rng, lambda i: ("kubelet-down-at", 1), per_slice=2,
        eligible=set(cluster.by_slice[first_pool]),
    )
    world.event(f"fleet slices={len(cluster.by_slice)} "
                f"torn={','.join(sorted(torn))}")
    server, state = fx.storm_apiserver(cluster.nodes(0))
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    expected: List[int] = []
    for r in range(p["rounds"]):
        state["nodes"] = cluster.nodes(r)  # the kubelet state moves
        down = cluster.down(r)
        expected.append(checker.EXIT_NONE_READY if down else checker.EXIT_OK)
        reports = world.write_reports("c0", cluster.verdicts(r))
        _result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--strict-slices",
            "--history", world.history_path("c0"),
        ), r, "sim-c0")
        world.commit(rec)
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 3}))
    world.grade(inv.check_fsm_legality(world.records))
    world.grade(inv.check_slack_dedup(world.records, max_alerts=2))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# degraded-link: one slow ICI hop — named, DEGRADED not FAILED, drained
# ---------------------------------------------------------------------------


def _run_degraded_link(world: SimWorld) -> None:
    """The mesh link doctor end to end, at sim speed: one host's ICI link
    tears at round 1 (a ``torn-link`` program replaying the report shape
    the probe child's ``TNC_CHAOS_SLOW_LINK`` hook produces — the jax
    sweep itself is pinned by the slow test_probe chaos tests).  The
    matrix asserts the link is NAMED in the budget view, the host grades
    DEGRADED and is never condemned FAILED/CHRONIC, the exit code never
    notices (the chips pass), and ``--cordon-degraded`` drains the sick
    host through the budget engine's rails."""
    p = world.params
    onset = 1
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"], min_slices=2)
    first_pool = sorted(cluster.by_slice)[0]
    torn = cluster.assign(
        world.rng, lambda i: ("torn-link", onset), per_slice=1,
        eligible=set(cluster.by_slice[first_pool]),
    )
    host = torn[0]
    link = cluster.degraded(onset)[host]
    world.event(f"fleet slices={len(cluster.by_slice)} torn={host} "
                f"link={link} onset={onset}")
    server, state = fx.storm_apiserver(cluster.nodes())
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    expected: List[int] = []
    patch_timeline: List[List[str]] = []
    degraded_timeline: List[dict] = []
    for r in range(p["rounds"]):
        # The exit-code contract is untouched by link weather: every
        # chip passes every round, so the oracle is a flat 0 — DEGRADED
        # rides the evidence layers, never the verdict.
        expected.append(checker.EXIT_OK)
        reports = world.write_reports("c0", cluster.verdicts(r),
                                      degraded=cluster.degraded(r))
        before = len(state["patches"])
        result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--history", world.history_path("c0"),
            "--cordon-degraded", "--cordon-max", "8",
            "--slice-floor-pct", "50", "--disruption-budget", "2",
        ), r, "sim-c0")
        rec["patches"] = _patch_names(state, before)
        patch_timeline.append(rec["patches"])
        block = {}
        if result is not None:
            block = ((result.payload.get("remediation") or {})
                     .get("degraded") or {})
        step = {
            "round": r,
            "nodes": list(block.get("nodes") or []),
            "links": list(block.get("links") or []),
        }
        degraded_timeline.append(step)
        world.commit(rec)
        world.event(
            f"degraded round={r} nodes={','.join(step['nodes']) or '-'} "
            f"links={','.join(step['links']) or '-'}"
        )
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0}))
    world.grade(inv.check_degraded_link_named(degraded_timeline, host,
                                              link, onset))
    world.grade(inv.check_degraded_not_condemned(world.records, [host]))
    world.grade(inv.check_degraded_drain(patch_timeline, [host],
                                         world.records, strict=True))
    world.grade(inv.check_disruption_budget(
        [len(x) for x in patch_timeline], 2
    ))
    world.grade(inv.check_fsm_legality(world.records))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# watch-loss-relist: stream losses and the one-relist-per-loss economy
# ---------------------------------------------------------------------------


def _tick_round(world: SimWorld, engine, round_i: int,
                cluster: str = "sim-c0") -> dict:
    """One REAL watch-stream tick, recorded like a poll round."""
    tracer = Tracer()
    result, _delta = engine.tick(tracer=tracer)
    world.clock.advance(30.0)
    phases = tracer.as_dict()
    record = {
        "round": round_i,
        "cluster": cluster,
        "exit_code": result.exit_code,
        "error": None,
        "payload_exit_code": result.payload.get("exit_code"),
        "sick": sorted(
            n["name"] for n in result.payload.get("nodes") or []
            if not (n.get("ready") and n.get("schedulable", True))
        ),
        "trace_ok": bool(
            result.payload.get("trace_id") == tracer.trace_id
            and any(k in phases for k in ("fold", "grade", "detect"))
        ),
        "relists": dict(
            (result.payload.get("watch_stream") or {}).get("relists_total")
            or {}
        ),
    }
    return record


def _run_watch_loss_relist(world: SimWorld) -> None:
    from tpu_node_checker_torch import cli
    from tpu_node_checker_torch.watchstream import StreamRoundEngine

    p = world.params
    cluster = synth_cluster("sim-c0", p["nodes_per_cluster"], min_slices=1)
    nodes = cluster.nodes(0)
    sick_name = sorted(cluster.node_names())[1]
    script = fx.WatchScript([], clock=world.clock)
    list_requests: List[int] = []
    server = fx.serve_http(fx.watch_nodelist_handler(
        nodes, script, resource_version="100", list_requests=list_requests
    ))
    world.on_cleanup(server.shutdown)
    world.on_cleanup(script.close)
    kc = world.kubeconfig(server.server_address[1], "c0")
    args = cli.parse_args([
        "--kubeconfig", kc, "--watch", "5", "--watch-stream",
        "--strict-slices", "--json", "--retry-budget", "0",
    ])
    engine = StreamRoundEngine(args)
    world.on_cleanup(engine.close)

    def lists() -> int:
        # Each relist is one paged LIST walk; small fleets are one page.
        return len(list_requests)

    rv = 200
    losses = 0
    expected: List[int] = []
    for r in range(p["rounds"]):
        if r == 1:
            # One host goes NotReady via a stream event.
            sick_node = fx.make_node(
                sick_name, ready=False,
                allocatable={"google.com/tpu": str(cluster.chips_per_host)},
                labels=next(
                    n["metadata"]["labels"] for n in nodes
                    if n["metadata"]["name"] == sick_name
                ),
                taints=[fx.TPU_TAINT],
            )
            script.push(fx.watch_event("MODIFIED", sick_node,
                                       resource_version=str(rv)))
            rv += 1
            wait_for(lambda: engine.cache.pending() >= 1,
                     what="stream event delivery")
            expected.append(checker.EXIT_NONE_READY)
        elif r == 2:
            # Server ends the stream cleanly; the node recovered while the
            # stream was down — only the relist can see it.
            for n in nodes:
                if n["metadata"]["name"] == sick_name:
                    n["status"]["conditions"] = fx.make_node(
                        sick_name
                    )["status"]["conditions"]
            script.push(None)
            losses += 1
            wait_for(lambda: not engine.stream_alive(), what="worker exit")
            expected.append(checker.EXIT_OK)
        elif r == 4:
            # A second clean loss, nothing changed server-side.
            script.push(None)
            losses += 1
            wait_for(lambda: not engine.stream_alive(), what="worker exit")
            expected.append(checker.EXIT_OK)
        elif r == 5:
            # The in-band 410 replay: the stream itself says Gone.
            script.push(fx.watch_error_gone())
            losses += 1
            wait_for(lambda: not engine.stream_alive(),
                     what="worker exit on 410 replay")
            expected.append(checker.EXIT_OK)
        else:
            expected.append(checker.EXIT_OK)
        rec = _tick_round(world, engine, r)
        world.commit(rec)
        world.event(f"watch round={r} lists={lists()} "
                    f"connections={script.connections}")
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 3}))
    world.grade(inv.check_relist_economy(lists(), expected=1 + losses))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# partitioned-region: one cluster vanishes; the federation labels, never
# drops
# ---------------------------------------------------------------------------


def _run_partitioned_region(world: SimWorld) -> None:
    from tpu_node_checker_torch import cli
    from tpu_node_checker_torch.federation.aggregator import FederationEngine
    from tpu_node_checker_torch.server.app import FleetStateServer

    p = world.params
    death_round = 2
    names = [f"sim-c{i}" for i in range(p["clusters"])]
    dead = names[-1]
    worlds = {}
    for name in names:
        cluster = synth_cluster(name, p["nodes_per_cluster"])
        api, state = fx.storm_apiserver(cluster.nodes())
        world.on_cleanup(api.shutdown)
        fleet = FleetStateServer(0, host="127.0.0.1")
        world.on_cleanup(fleet.close)
        worlds[name] = {
            "cluster": cluster, "api": api, "state": state, "fleet": fleet,
            "kc": world.kubeconfig(api.server_address[1], name),
        }
    world.event(f"fleet clusters={','.join(names)} dead={dead} "
                f"death_round={death_round}")
    endpoints = f"{world.tmpdir}/endpoints.json"
    with open(endpoints, "w", encoding="utf-8") as fh:
        json.dump({"clusters": [
            {"name": n, "url": f"http://127.0.0.1:{worlds[n]['fleet'].port}"}
            for n in names
        ]}, fh)
    fed = FederationEngine(cli.parse_args([
        "--federate", endpoints, "--serve", "0", "--retry-budget", "0",
    ]))
    world.on_cleanup(fed.close)
    expected: List[int] = []
    staleness_timeline: List[dict] = []
    for r in range(p["rounds"]):
        if r == death_round:
            worlds[dead]["fleet"].close()
            worlds[dead]["api"].shutdown()
            # Close the listen socket too: the partitioned checker must see
            # a refused dial, not a half-open server's kernel backlog.
            worlds[dead]["api"].server_close()
            # A real partition severs ESTABLISHED flows as well; the
            # fixture server's per-connection threads would keep serving
            # the checker's pooled keep-alive socket forever.  Dropping the
            # pool forces the redial the partition would have killed.
            checker.reset_client_cache()
            world.event(f"partition round={r} cluster={dead}")
        for name in names:
            w = worlds[name]
            partitioned = name == dead and r >= death_round
            reports = world.write_reports(
                name, w["cluster"].verdicts(r)
            )
            result, rec = world.checker_round(_base_argv(
                w["kc"], reports, "--strict-slices", "--cluster-name", name,
            ), r, name)
            expected.append(checker.EXIT_ERROR if partitioned
                            else checker.EXIT_OK)
            if result is not None and not partitioned:
                w["fleet"].publish(result)
            world.commit(rec)
        snap = fed.round()
        summary = json.loads(snap.entity("global/summary").raw)
        clusters_doc = json.loads(snap.entity("global/clusters").raw)
        stale_rounds = 0
        for c in clusters_doc.get("clusters", []):
            if c.get("name") == dead or c.get("cluster") == dead:
                stale_rounds = ((c.get("staleness") or {}).get("rounds")
                                or 0)
        step = {
            "round": r,
            "healthy": bool(summary.get("healthy")),
            "degraded_clusters": sorted(summary.get("degraded_clusters")
                                        or []),
            "staleness_rounds": stale_rounds,
            "total_nodes": summary.get("total_nodes"),
        }
        staleness_timeline.append(step)
        world.event(
            f"federation round={r} healthy={step['healthy']} "
            f"degraded={','.join(step['degraded_clusters']) or '-'} "
            f"stale_rounds={step['staleness_rounds']} "
            f"total_nodes={step['total_nodes']}"
        )
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 1}))
    world.grade(inv.check_staleness_labels(
        staleness_timeline, dead, death_round
    ))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# aggregator-death: the lease aggregator dies mid-storm; fallback must
# degrade toward LESS actuation, never more
# ---------------------------------------------------------------------------


def _run_aggregator_death(world: SimWorld) -> None:
    from tpu_node_checker_torch.remediation.budget import FleetLeaseBudget
    from tpu_node_checker_torch.server.app import FleetStateServer

    p = world.params
    fleet_budget = 3
    death_round = 2
    slices = max(2, p["nodes_per_cluster"] // 4)
    storm = fx.StormSchedule(seed=world.seed, slices=slices,
                             hosts_per_slice=4, chips_per_host=4,
                             fail_round=0, fail_fraction=1.0,
                             flappers_per_slice=0, name_prefix="sim-c0")
    world.event(f"fleet slices={slices} fleet_budget={fleet_budget} "
                f"death_round={death_round}")
    server, state = fx.storm_apiserver(storm.nodes())
    world.on_cleanup(server.shutdown)
    kc = world.kubeconfig(server.server_address[1], "c0")
    fleet = FleetLeaseBudget(fleet_budget, 3600.0)
    aggregator = FleetStateServer(0, host="127.0.0.1", lease=fleet.grant)
    world.on_cleanup(aggregator.close)
    agg_url = f"http://127.0.0.1:{aggregator.port}"
    floor_chips = storm.chips_per_host * 4 // 4  # --slice-floor-pct 25
    patches_per_round: List[int] = []
    floor_timeline: List[Dict[str, int]] = []
    expected: List[int] = []
    for r in range(p["rounds"]):
        if r == death_round:
            aggregator.close()
            world.event(f"aggregator-killed round={r}")
        verd = storm.verdicts(r)
        reports = world.write_reports("c0", verd)
        before = len(state["patches"])
        _result, rec = world.checker_round(_base_argv(
            kc, reports,
            "--cordon-failed", "--cordon-max", "8",
            "--slice-floor-pct", "25", "--disruption-lease", agg_url,
        ), r, "sim-c0")
        # Every host failed from round 0: never any effective readiness.
        expected.append(checker.EXIT_NONE_READY)
        rec["patches"] = _patch_names(state, before)
        patches_per_round.append(len(rec["patches"]))
        floor_timeline.append(_available_by_slice(
            storm.by_slice, storm.chips_per_host, state["nodes"]
        ))
        world.commit(rec)
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={3}))
    world.grade(inv.check_lease_bound(sum(patches_per_round), fleet_budget))
    world.grade(inv.check_slice_floor(floor_timeline, floor_chips))
    world.grade(inv.check_denials_visible(world.records, from_round=0))
    world.grade(inv.check_slack_dedup(world.records, max_alerts=4))
    world.grade(inv.check_trace_completeness(world.records))


# ---------------------------------------------------------------------------
# federated-world: K clusters × M nodes through the REAL federation —
# poll and feed engines in lockstep, the lease path, analytics folding
# ---------------------------------------------------------------------------


def _run_federated_world(world: SimWorld) -> None:
    from tpu_node_checker_torch import cli
    from tpu_node_checker_torch.federation.aggregator import FederationEngine
    from tpu_node_checker_torch.remediation.budget import FleetLeaseBudget
    from tpu_node_checker_torch.server.app import FleetStateServer

    p = world.params
    rounds = p["rounds"]
    death_round = rounds - 2
    fleet_budget = 2
    names = [f"sim-c{i}" for i in range(p["clusters"])]
    analytics_cluster, lease_cluster, dead = names[0], names[1], names[-1]
    worlds: Dict[str, dict] = {}
    decayers: List[str] = []
    failers: List[str] = []
    for name in names:
        cluster = synth_cluster(name, p["nodes_per_cluster"])
        if name == analytics_cluster:
            # Decay prodrome: flap until round 3, then failed forever —
            # the CUSUM detector must flag the flapping (round 3) before
            # --cordon-after 2 condemns FAILED (round 4).
            decayers = cluster.assign(
                world.rng, lambda i: ("flap-until", 2, 3, 3), per_slice=1
            )
        elif name == lease_cluster:
            # Hard failures from round 1 drive cordon requests through
            # the aggregator-owned disruption lease.
            failers = cluster.assign(
                world.rng, lambda i: ("fail-at", 1), per_slice=1
            )
        api, state = fx.storm_apiserver(cluster.nodes())
        world.on_cleanup(api.shutdown)
        fleet = FleetStateServer(0, host="127.0.0.1")
        world.on_cleanup(fleet.close)
        worlds[name] = {
            "cluster": cluster, "api": api, "state": state, "fleet": fleet,
            "kc": world.kubeconfig(api.server_address[1], name),
        }
    world.event(
        f"fleet clusters={','.join(names)} dead={dead} "
        f"death_round={death_round} fleet_budget={fleet_budget} "
        f"decayers={','.join(sorted(decayers))} "
        f"failers={','.join(sorted(failers))}"
    )
    lease = FleetLeaseBudget(fleet_budget, 3600.0)
    agg = FleetStateServer(0, host="127.0.0.1", lease=lease.grant)
    world.on_cleanup(agg.close)
    agg_url = f"http://127.0.0.1:{agg.port}"
    endpoints = f"{world.tmpdir}/endpoints.json"
    with open(endpoints, "w", encoding="utf-8") as fh:
        json.dump({"clusters": [
            {"name": n, "url": f"http://127.0.0.1:{worlds[n]['fleet'].port}"}
            for n in names
        ]}, fh)
    fed_poll = FederationEngine(cli.parse_args([
        "--federate", endpoints, "--serve", "0", "--retry-budget", "0",
    ]))
    world.on_cleanup(fed_poll.close)
    fed_feed = FederationEngine(cli.parse_args([
        "--federate", endpoints, "--serve", "0", "--retry-budget", "0",
        "--federate-feed",
    ]))
    world.on_cleanup(fed_feed.close)

    def _cluster_argv(name: str, reports: str) -> List[str]:
        w = worlds[name]
        argv = _base_argv(w["kc"], reports, "--cluster-name", name)
        if name == analytics_cluster:
            argv += ["--history", world.history_path(name),
                     "--analytics", world.analytics_dir(name),
                     "--cordon-after", "2"]
        elif name == lease_cluster:
            # No --strict-slices: a minority of hard failures must not
            # drain this cluster's aggregate verdict — the global summary
            # stays healthy-by-verdict, so the staleness invariant grades
            # the PARTITION, not ordinary sickness.  The cordon path (and
            # the fleet lease funding it) fires on the failed probes
            # regardless of the exit code.
            argv += ["--cordon-failed", "--cordon-max", "8",
                     "--slice-floor-pct", "50",
                     "--disruption-lease", agg_url]
        else:
            argv += ["--strict-slices"]
        return argv

    def _oracle(name: str, r: int) -> int:
        if name == dead and r >= death_round:
            return checker.EXIT_ERROR
        cluster = worlds[name]["cluster"]
        down = cluster.down(r)
        if name in (analytics_cluster, lease_cluster):
            # No --strict-slices on these: a minority of sick hosts never
            # drains the aggregate verdict.
            return (checker.EXIT_NONE_READY
                    if len(down) == len(cluster.node_names())
                    else checker.EXIT_OK)
        return checker.EXIT_NONE_READY if down else checker.EXIT_OK

    def _feeds_verified() -> bool:
        live = {n for n in names if n != dead}
        clients = dict(fed_feed._feeds)
        return live <= set(clients) and all(
            clients[n]._state is not None for n in live
        )

    def _frame_applied(name: str) -> bool:
        client = fed_feed._feeds.get(name)
        if client is None:
            return False
        with client._lock:
            state = client._state
        etag = worlds[name]["fleet"]._snap.entities["nodes"].etag
        return state is not None and state[0] == etag

    expected: List[int] = []
    lease_patches = 0
    staleness_timeline: List[dict] = []
    parity_timeline: List[dict] = []
    for r in range(rounds):
        if r == death_round:
            dead_client = fed_feed._feeds.get(dead)
            worlds[dead]["fleet"].close()
            worlds[dead]["api"].shutdown()
            worlds[dead]["api"].server_close()
            checker.reset_client_cache()
            if dead_client is not None:
                # Consume the stream death deterministically: the next
                # feed round must already know, not race the reader.
                dead_client.thread.join(timeout=10)
            world.event(f"partition round={r} cluster={dead}")
        for name in names:
            w = worlds[name]
            partitioned = name == dead and r >= death_round
            reports = world.write_reports(name, w["cluster"].verdicts(r))
            before = len(w["state"]["patches"])
            result, rec = world.checker_round(
                _cluster_argv(name, reports), r, name
            )
            rec["patches"] = _patch_names(w["state"], before)
            if name == lease_cluster:
                lease_patches += len(rec["patches"])
            expected.append(_oracle(name, r))
            if result is not None and not partitioned:
                w["fleet"].publish(result)
            world.commit(rec)
        poll_snap = fed_poll.round()
        if r == 0:
            fed_feed.round()  # the relist round: polls, then opens streams
            wait_for(_feeds_verified, timeout=10.0,
                     what="federation streams verified")
        else:
            for name in names:
                if name == dead and r >= death_round:
                    continue
                if name in fed_feed._feeds:
                    wait_for(lambda n=name: _frame_applied(n), timeout=10.0,
                             what=f"feed frame applied for {name}")
            fed_feed.round()
        summary = json.loads(poll_snap.entity("global/summary").raw)
        clusters_doc = json.loads(poll_snap.entity("global/clusters").raw)
        stale_rounds = 0
        for c in clusters_doc.get("clusters", []):
            if c.get("name") == dead or c.get("cluster") == dead:
                stale_rounds = ((c.get("staleness") or {}).get("rounds")
                                or 0)
        staleness_timeline.append({
            "round": r,
            "healthy": bool(summary.get("healthy")),
            "degraded_clusters": sorted(summary.get("degraded_clusters")
                                        or []),
            "staleness_rounds": stale_rounds,
            "total_nodes": summary.get("total_nodes"),
        })
        parity = {
            name: (fed_feed.views[name].nodes_entries
                   == fed_poll.views[name].nodes_entries
                   and fed_feed.views[name].nodes_etag
                   == fed_poll.views[name].nodes_etag)
            for name in names
        }
        stale_parity = {
            name: bool(fed_feed.views[name].stale)
            == bool(fed_poll.views[name].stale)
            for name in names
        }
        parity_timeline.append({
            "round": r,
            "clusters": {n: parity[n] and stale_parity[n] for n in names},
        })
        world.event(
            f"federation round={r} "
            f"healthy={staleness_timeline[-1]['healthy']} "
            f"degraded={','.join(staleness_timeline[-1]['degraded_clusters']) or '-'} "
            f"stale_rounds={stale_rounds} "
            f"total_nodes={staleness_timeline[-1]['total_nodes']} "
            f"parity={'ok' if all(parity_timeline[-1]['clusters'].values()) else 'DIVERGED'}"
        )
    world.grade(inv.check_exit_codes(world.records, expected=expected,
                                     allowed={0, 1, 3}))
    world.grade(inv.check_staleness_labels(
        staleness_timeline, dead, death_round
    ))
    world.grade(inv.check_lease_bound(lease_patches, fleet_budget))
    world.grade(inv.check_prediction_precedes_failure(
        world.records, sorted(decayers)
    ))
    world.grade(inv.check_feed_parity(parity_timeline))
    world.grade(inv.check_trace_completeness(world.records))


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="flap-storm",
            title="Chronic flappers debounced into CHRONIC quarantine; "
                  "decaying flappers predicted before FAILED",
            runner=_run_flap_storm,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 10,
                      "min_rounds": 10},
            invariants=("exit-code-contract", "disruption-budget",
                        "slice-floor", "fsm-legality", "slack-dedup",
                        "prediction-precedes-failure",
                        "trace-completeness"),
        ),
        Scenario(
            name="mass-cordon-storm",
            title="Simultaneous mass failure vs budgets and slice floors",
            runner=_run_mass_cordon_storm,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 6,
                      "min_rounds": 4},
            invariants=("exit-code-contract", "disruption-budget",
                        "slice-floor", "denials-visible", "slack-dedup",
                        "trace-completeness"),
        ),
        Scenario(
            name="api-brownout",
            title="429/5xx bursts absorbed; a black-hole trips the breaker",
            runner=_run_api_brownout,
            defaults={"clusters": 1, "nodes_per_cluster": 4, "rounds": 6,
                      "min_rounds": 6},
            invariants=("exit-code-contract", "retry-absorption",
                        "breaker-legality", "trace-completeness"),
            tunable=("nodes_per_cluster",),
        ),
        Scenario(
            name="slow-drain",
            title="Staggered permanent failures trickling through budgets",
            runner=_run_slow_drain,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 8,
                      "min_rounds": 6},
            invariants=("exit-code-contract", "disruption-budget",
                        "slice-floor", "fsm-legality", "slack-dedup",
                        "trace-completeness"),
        ),
        Scenario(
            name="torn-slice",
            title="Kubelet NotReady tears a slice without any chip fault",
            runner=_run_torn_slice,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 5,
                      "min_rounds": 3},
            invariants=("exit-code-contract", "fsm-legality", "slack-dedup",
                        "trace-completeness"),
        ),
        Scenario(
            name="degraded-link",
            title="One slow ICI hop: the link named, the host DEGRADED "
                  "not FAILED, drained within budget",
            runner=_run_degraded_link,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 5,
                      "min_rounds": 3},
            invariants=("exit-code-contract", "degraded-link-named",
                        "degraded-not-condemned", "degraded-drain",
                        "disruption-budget", "fsm-legality",
                        "trace-completeness"),
        ),
        Scenario(
            name="watch-loss-relist",
            title="Stream losses and the one-relist-per-loss economy",
            runner=_run_watch_loss_relist,
            defaults={"clusters": 1, "nodes_per_cluster": 4, "rounds": 6,
                      "min_rounds": 6},
            invariants=("exit-code-contract", "relist-economy",
                        "trace-completeness"),
            tunable=("nodes_per_cluster",),
        ),
        Scenario(
            name="partitioned-region",
            title="A region vanishes; federation labels staleness, never "
                  "drops the shard",
            runner=_run_partitioned_region,
            defaults={"clusters": 3, "nodes_per_cluster": 4, "rounds": 5,
                      "min_clusters": 2, "min_rounds": 4},
            invariants=("exit-code-contract", "staleness-labels",
                        "trace-completeness"),
            tunable=("clusters", "nodes_per_cluster", "rounds"),
        ),
        Scenario(
            name="aggregator-death",
            title="Lease aggregator killed mid-storm; fallback bounded by "
                  "the last lease",
            runner=_run_aggregator_death,
            defaults={"clusters": 1, "nodes_per_cluster": 8, "rounds": 4,
                      "min_rounds": 4},
            invariants=("exit-code-contract", "lease-bound", "slice-floor",
                        "denials-visible", "slack-dedup",
                        "trace-completeness"),
        ),
        Scenario(
            name="federated-world",
            title="K clusters × M nodes through the REAL federation: poll "
                  "and feed engines in lockstep, disruption lease, "
                  "analytics prediction, one shard partitioned",
            runner=_run_federated_world,
            defaults={"clusters": 3, "nodes_per_cluster": 8, "rounds": 6,
                      "min_clusters": 3, "min_rounds": 5},
            invariants=("exit-code-contract", "staleness-labels",
                        "lease-bound", "prediction-precedes-failure",
                        "feed-parity", "trace-completeness"),
            tunable=("clusters", "nodes_per_cluster", "rounds"),
        ),
    )
}

# Composed scenarios are first-class grid members: same registry, same
# --list-scenarios row, same byte-identical replay contract.  compose()
# enforces the layering rules (sim/compose.py).
from tpu_node_checker_torch.sim.compose import COMPOSED  # noqa: E402  (the combinator needs Scenario/engine loaded first)

for _composed in COMPOSED:
    SCENARIOS[_composed.name] = _composed
