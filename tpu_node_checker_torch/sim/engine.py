"""The scenario driver: seeded world, real checker rounds, canonical event
log, deterministic report.

A copy of the JAX package's ``sim/engine.py``, held equal to it by
``tests/test_torch_copies.py``.  :func:`run_scenario` builds a
:class:`SimWorld` (seeded RNG, virtual clock, scratch directory, simulated
API servers), hands it to the named scenario's runner
(:mod:`tpu_node_checker_torch.sim.scenarios`) and folds the round records
and invariant verdicts into a report that is byte-identical for the same
``(scenario, seed, params)``: no wall time, port or message text enters it.
The port's checker state (client pool, history, remediation and analytics
caches) is reset at the start and end of every run.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tpu_node_checker_torch import checker, cli
from tpu_node_checker_torch.obs.trace import Tracer
from tpu_node_checker_torch.sim.clock import SimClock, perf_ms, wall_now

REPORT_SCHEMA = 1

#: Virtual seconds between rounds — the cadence a ``--watch`` interval
#: would impose, applied to the SimClock so scenario timestamps advance
#: deterministically.
ROUND_INTERVAL_S = 30.0


class ScenarioError(Exception):
    """A scenario could not run (unknown name, bad parameters)."""


@dataclass
class ScenarioResult:
    """Everything one scenario run produced."""

    name: str
    seed: int
    params: Dict[str, int]
    ok: bool
    report: dict
    report_json: str
    events: List[str]
    round_ms: List[float]  # wall timings for bench — NOT in the report


class SimWorld:
    """Per-run context handed to a scenario's runner."""

    def __init__(self, name: str, seed: int, params: Dict[str, int],
                 tmpdir: str):
        self.name = name
        self.seed = seed
        self.params = params
        self.tmpdir = tmpdir
        self.rng = random.Random(seed)
        self.clock = SimClock()
        self.records: List[dict] = []
        self.events: List[str] = []
        self.verdicts: List = []
        self.round_ms: List[float] = []
        self._cleanups: List[Callable[[], None]] = []
        self._retries_seen: Dict[str, int] = {}
        self.sabotage: Optional[str] = None

    # -- infrastructure ------------------------------------------------------

    def on_cleanup(self, fn: Callable[[], None]) -> None:
        self._cleanups.append(fn)

    def cleanup(self) -> None:
        for fn in reversed(self._cleanups):
            try:
                fn()
            except Exception:  # tnc: allow-broad-except(best-effort teardown of fixture servers — a dead socket must not mask the scenario verdict)
                pass
        self._cleanups.clear()

    def kubeconfig(self, port: int, name: str = "sim") -> str:
        path = os.path.join(self.tmpdir, f"kubeconfig-{name}")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(
                "apiVersion: v1\n"
                "kind: Config\n"
                "current-context: sim\n"
                "contexts: [{name: sim, context: {cluster: sim, user: sim}}]\n"
                f"clusters: [{{name: sim, cluster: "
                f"{{server: \"http://127.0.0.1:{port}\"}}}}]\n"
                "users: [{name: sim, user: {token: sim-token}}]\n"
            )
        return path

    def reports_dir(self, cluster: str) -> str:
        path = os.path.join(self.tmpdir, f"probes-{cluster}")
        os.makedirs(path, exist_ok=True)
        return path

    def write_reports(self, cluster: str, verdicts: Dict[str, bool],
                      degraded: Optional[Dict[str, str]] = None) -> str:
        """Per-host probe reports for one round.  ``written_at`` is REAL
        wall time (via the clock seam) because the checker grades report
        freshness against the real clock; it never enters the report.

        ``degraded`` (``host -> slow link name``, from
        :meth:`~tpu_node_checker_torch.sim.fleet.SimCluster.degraded`) upgrades
        those hosts' reports to mesh level: a PASSING report whose link
        matrix grades exactly that link SLOW — the same shape the real
        probe child emits under its ``TNC_CHAOS_SLOW_LINK`` chaos hook
        (pinned by the test_probe chaos tests), replayed here without the
        jax process so the scenario stays deterministic and fast."""
        path = self.reports_dir(cluster)
        for host, ok in verdicts.items():
            slow = (degraded or {}).get(host)
            if ok and slow is not None:
                links = {
                    leg: {"verdict": "OK", "p50_us": 50.0, "p99_us": 60.0,
                          "budget_us": 400.0}
                    for leg in ("t0/0", "t0/1", "t1/0", "t1/1")
                }
                links[slow] = {"verdict": "SLOW", "p50_us": 900.0,
                               "p99_us": 950.0, "budget_us": 400.0}
                doc = {
                    "ok": True,
                    "level": "mesh",
                    "hostname": host,
                    "written_at": wall_now(),
                    "error": None,
                    "mesh_ok": True,
                    "mesh_degraded": True,
                    "mesh_n_links": len(links),
                    "mesh_latency_us": 900.0,
                    "mesh_slow_links": [slow],
                    "collective_legs_ok": {
                        "psum_ok": True,
                        "all_gather_ok": True,
                        "reduce_scatter_ok": True,
                        "psum_latency_us": 11.0,
                        "all_gather_latency_us": 12.0,
                        "reduce_scatter_latency_us": 13.0,
                        "links": links,
                    },
                }
            else:
                doc = {
                    "ok": ok,
                    "level": "compute",
                    "hostname": host,
                    "written_at": wall_now(),
                    "error": None if ok else "simulated chip fault",
                }
            with open(os.path.join(path, f"{host}.json"), "w",
                      encoding="utf-8") as fh:
                json.dump(doc, fh)
        return path

    def history_path(self, cluster: str) -> str:
        return os.path.join(self.tmpdir, f"history-{cluster}.jsonl")

    def analytics_dir(self, cluster: str) -> str:
        path = os.path.join(self.tmpdir, f"analytics-{cluster}")
        os.makedirs(path, exist_ok=True)
        return path

    # -- driving the real checker --------------------------------------------

    def checker_round(self, argv: List[str], round_i: int,
                      cluster: str) -> Tuple[Optional[object], dict]:
        """One REAL check round: parse the argv like the CLI would, run
        ``checker.run_check`` under a fresh tracer, and fold the outcome
        into a deterministic round record.

        A raised round (unreachable apiserver, exhausted retry budget) is
        the documented exit-1 contract, recorded with the exception CLASS
        only — messages carry ports and would break replay identity.
        """
        args = cli.parse_args(argv)
        tracer = Tracer()
        t0 = perf_ms()
        try:
            result = checker.run_check(args, tracer=tracer)
            exit_code, error = result.exit_code, None
        except Exception as exc:  # tnc: allow-broad-except(the watch loop's failed-round contract: any raised round is exit 1, breaker-charged, pool reset — the scenario grades the failure instead of dying on it)
            checker.reset_client_cache()
            # The pool reset also zeroed the transport's cumulative retry
            # counter: drop our high-water mark with it, or every retry
            # after an error round is silently under-reported.
            self._retries_seen[cluster] = 0
            result, exit_code, error = None, checker.EXIT_ERROR, type(exc).__name__
        self.round_ms.append(perf_ms() - t0)
        self.clock.advance(ROUND_INTERVAL_S)
        record = {
            "round": round_i,
            "cluster": cluster,
            "exit_code": exit_code,
            "error": error,
        }
        if result is not None:
            record["payload_exit_code"] = result.payload.get("exit_code")
            record["sick"] = [
                f"{name}:{state}" if state else name
                for name, state in _normalize_sick(
                    checker._round_sick_set(result)
                )
            ]
            record["denials"] = [
                ":".join(str(p) for p in pair)
                for pair in checker._round_denials_fp(result)
            ]
            record["transitions"] = [
                f"{t['node']}:{t['from']}>{t['to']}"
                for t in ((result.payload.get("history") or {})
                          .get("transitions") or [])
            ]
            preds = (result.payload.get("analytics") or {}).get(
                "predictions"
            ) or []
            # The shared predictions list carries two channels: flip
            # detections keyed by "node", link-drift firings keyed by
            # "link" — record each under its own key.
            predictions = sorted(p["node"] for p in preds if "node" in p)
            link_predictions = sorted(p["link"] for p in preds
                                      if "link" in p)
            if predictions:
                # Node names only: scores are deterministic too, but the
                # record keeps the minimal ground truth the invariant
                # reads (bucket/timestamp fields must never leak in).
                record["predictions"] = predictions
            if link_predictions:
                record["link_predictions"] = link_predictions
            record["trace_ok"] = bool(
                result.payload.get("trace_id") == tracer.trace_id
                and "detect" in tracer.as_dict()
            )
            retries_total = (result.payload.get("api_transport") or {}).get(
                "retries", 0
            )
            prev = self._retries_seen.get(cluster, 0)
            record["retries"] = max(0, retries_total - prev)
            self._retries_seen[cluster] = max(prev, retries_total)
        return result, record

    def commit(self, record: dict) -> None:
        """Record one round and append its canonical event line."""
        self.records.append(record)
        parts = [
            f"round={record['round']}",
            f"cluster={record['cluster']}",
            f"exit={record['exit_code']}",
        ]
        if record.get("error"):
            parts.append(f"error={record['error']}")
        for key in ("sick", "denials", "transitions", "predictions",
                    "link_predictions", "patches"):
            values = record.get(key)
            if values:
                parts.append(f"{key}={','.join(values)}")
        if record.get("retries"):
            parts.append(f"retries={record['retries']}")
        self.events.append(" ".join(parts))

    def event(self, line: str) -> None:
        """A scenario-specific canonical event (breaker transition,
        staleness observation, injected chaos)."""
        self.events.append(line)

    def grade(self, verdict) -> None:
        self.verdicts.append(verdict)

    # -- report ---------------------------------------------------------------

    def result(self) -> ScenarioResult:
        ok = all(v.ok for v in self.verdicts)
        digest = hashlib.sha256(
            "\n".join(self.events).encode("utf-8")
        ).hexdigest()
        report = {
            "schema": REPORT_SCHEMA,
            "scenario": self.name,
            "seed": self.seed,
            "params": dict(self.params),
            "ok": ok,
            "invariants": [v.to_dict() for v in self.verdicts],
            "rounds": [
                {k: rec[k] for k in sorted(rec) if k != "trace_ok"}
                for rec in self.records
            ],
            "events_digest": f"sha256:{digest}",
            "event_count": len(self.events),
        }
        return ScenarioResult(
            name=self.name,
            seed=self.seed,
            params=dict(self.params),
            ok=ok,
            report=report,
            report_json=json.dumps(report, indent=2, sort_keys=True) + "\n",
            events=list(self.events),
            round_ms=list(self.round_ms),
        )


def _normalize_sick(fp) -> List[Tuple[str, str]]:
    """``_round_sick_set`` yields plain names (no history) or (name, state)
    pairs (debounced) — normalize both to (name, state-or-empty)."""
    out = []
    for item in fp:
        if isinstance(item, tuple):
            out.append((item[0], item[1]))
        else:
            out.append((item, ""))
    return out


def _reset_checker_state() -> None:
    """Same-seed replays need identical checker process state: drop the
    pooled clients and the cross-round history/remediation caches the
    watch loop deliberately persists."""
    checker.reset_client_cache()
    checker._HISTORY_CACHE["key"] = None
    checker._HISTORY_CACHE["tracker"] = None
    checker._REMEDIATION_CACHE["key"] = None
    checker._REMEDIATION_CACHE["bundle"] = None
    checker._ANALYTICS_CACHE["key"] = None
    checker._ANALYTICS_CACHE["bundle"] = None


def run_world(name: str, seed: int, params: Dict[str, int],
              runner: Callable[["SimWorld"], None],
              sabotage: Optional[str] = None) -> ScenarioResult:
    """Run ANY runner through the full world machinery: scratch dir,
    seeded world, checker-state isolation, cleanup, deterministic report.
    :func:`run_scenario` is the named-registry wrapper; the fuzzer drives
    sampled failure programs through this directly."""
    with tempfile.TemporaryDirectory(prefix="tnc-sim-") as tmpdir:
        world = SimWorld(name, seed, params, tmpdir)
        world.sabotage = sabotage
        _reset_checker_state()
        try:
            runner(world)
        finally:
            world.cleanup()
            _reset_checker_state()
        return world.result()


def run_scenario(name: str, seed: int, clusters: Optional[int] = None,
                 nodes_per_cluster: Optional[int] = None,
                 rounds: Optional[int] = None,
                 sabotage: Optional[str] = None) -> ScenarioResult:
    """Run one named scenario to completion and grade its invariant matrix.

    ``sabotage`` (tests only) injects a deliberate contract violation —
    ``"over-budget"`` performs an extra unbudgeted cordon PATCH straight
    against the simulated apiserver mid-storm — to prove the matrix
    actually catches and names breakage instead of rubber-stamping green.
    """
    from tpu_node_checker_torch.sim.scenarios import SCENARIOS

    scenario = SCENARIOS.get(name)
    if scenario is None:
        raise ScenarioError(
            f"unknown scenario {name!r} (known: "
            f"{', '.join(sorted(SCENARIOS))})"
        )
    params = scenario.resolve(clusters, nodes_per_cluster, rounds)
    return run_world(name, seed, params, scenario.runner, sabotage=sabotage)


@dataclass(frozen=True)
class Scenario:
    """One named scenario: defaults, docs, and its runner."""

    name: str
    title: str
    runner: Callable[[SimWorld], None]
    defaults: Dict[str, int]
    invariants: Tuple[str, ...]
    # Parameters the scenario actually honors; others are clamped to the
    # default so an override cannot silently break the script's shape.
    tunable: Tuple[str, ...] = ("nodes_per_cluster", "rounds")

    def resolve(self, clusters: Optional[int],
                nodes_per_cluster: Optional[int],
                rounds: Optional[int]) -> Dict[str, int]:
        params = dict(self.defaults)
        overrides = {
            "clusters": clusters,
            "nodes_per_cluster": nodes_per_cluster,
            "rounds": rounds,
        }
        for key, value in overrides.items():
            if value is None:
                continue
            if key not in self.tunable:
                raise ScenarioError(
                    f"scenario {self.name!r} does not honor --{key.replace('_', '-')} "
                    f"(fixed at {params[key]})"
                )
            if value < self.defaults.get(f"min_{key}", 1):
                raise ScenarioError(
                    f"--{key.replace('_', '-')} must be at least "
                    f"{self.defaults.get(f'min_{key}', 1)} for "
                    f"{self.name!r}"
                )
            params[key] = value
        return {k: v for k, v in params.items() if not k.startswith("min_")}
