"""Federated-analytics smoke: merged sketches against a raw-replay oracle.

A copy of the JAX package's ``sim/analytics_smoke.py``, held equal to it by
``tests/test_torch_copies.py``.  A seeded 3-cluster world of per-node
health histories is folded into ``SegmentStore`` roll-ups, exported as
per-cluster slo docs and merged by ``build_global_analytics``; every global
p50/p90/p99 of availability, MTBF and MTTR must land within the sketches'
relative error bound (``DEFAULT_ALPHA``) of the exact order statistics over
the raw history.  The report is sorted-key JSON, byte-identical per seed.

Run: ``python -m tpu_node_checker_torch.sim.analytics_smoke [--seed N]``
Exit codes: 0 = every quantile within bound, 3 = bound violated.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

from tpu_node_checker_torch.analytics.queries import (
    build_analytics_docs,
    replay_raw,
)
from tpu_node_checker_torch.analytics.segments import RESOLUTIONS, SegmentStore
from tpu_node_checker_torch.analytics.sketch import DEFAULT_ALPHA
from tpu_node_checker_torch.federation.merge import (
    ClusterView,
    build_global_analytics,
)

# Fixed epoch: the world starts here for every seed (wall-clock never read).
T0 = 1_700_000_000.0
ROUND_S = 30.0
CLUSTERS = ("us-a", "eu-b", "ap-c")
NODES_PER_CLUSTER = 12
ROUNDS = 200
METRICS = ("availability_pct", "mtbf_s", "mttr_s")
QS = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))


def _world_rows(rng, cluster):
    """One cluster's seeded (node, ts, ok) history: per-node failure
    rates drawn once, then per-round Bernoulli readiness — the same
    shape the chaos fuzzer's programs produce, without the apiserver."""
    rates = {
        f"{cluster}-n{i:02d}": rng.uniform(0.02, 0.4)
        for i in range(NODES_PER_CLUSTER)
    }
    rows = []
    for r in range(ROUNDS):
        ts = T0 + ROUND_S * r
        for node, rate in sorted(rates.items()):
            rows.append((node, ts, rng.random() > rate))
    return rows


def _ingest(store, rows, cluster):
    """The production fold: observe every verdict with the same flip
    computation ``checker._update_history`` feeds the store."""
    last_ok = {}
    last_ts = T0
    for node, ts, ok in rows:
        flipped = node in last_ok and last_ok[node] != ok
        last_ok[node] = ok
        last_ts = max(last_ts, ts)
        store.observe(node, ts, ok, "HEALTHY" if ok else "SUSPECT",
                      flipped, group={"cluster": cluster})
    store.flush(last_ts + RESOLUTIONS[-1] + 1)


def _write_history(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for node, ts, ok in rows:
            f.write(json.dumps({
                "schema": 1, "node": node, "ts": ts, "ok": ok,
                "causes": [], "state": "HEALTHY" if ok else "SUSPECT",
                "streak": 1, "flaps": 0, "flaps_total": 0,
            }) + "\n")


def _oracle_values(history_path):
    """Raw-replay side: per-node scalars from the history JSONL, using
    the same formulas (and rounding) ``queries.node_stats_view`` derives
    from the store's running aggregates — sketches nowhere in sight."""
    out = {m: [] for m in METRICS}
    for _node, s in sorted(replay_raw(history_path).items()):
        n = s["n"]
        if n:
            out["availability_pct"].append(round(100.0 * s["ok"] / n, 2))
        span = (
            (s["last_ts"] - s["first_ts"])
            if s["first_ts"] is not None and s["last_ts"] is not None
            else 0.0
        )
        if s["onsets"] >= 2 and span > 0:
            out["mtbf_s"].append(round(span / s["onsets"], 1))
        if s["repairs"]:
            out["mttr_s"].append(round(s["repair_s"] / s["repairs"], 1))
    return out


def _exact_quantile(values, q):
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[rank - 1]


def run_smoke(seed: int) -> dict:
    import random

    rng = random.Random(seed)
    views = []
    union = {m: [] for m in METRICS}
    with tempfile.TemporaryDirectory(prefix="tnc-analytics-smoke-") as tmp:
        for cluster in CLUSTERS:
            rows = _world_rows(rng, cluster)
            history = os.path.join(tmp, f"{cluster}.jsonl")
            _write_history(history, rows)
            for metric, vals in _oracle_values(history).items():
                union[metric].extend(vals)
            store = SegmentStore(os.path.join(tmp, cluster))
            store.load()
            _ingest(store, rows, cluster)
            view = ClusterView(cluster, f"http://{cluster}:8080")
            view.set_analytics(build_analytics_docs(store)["slo"])
            views.append(view)
        global_doc = build_global_analytics(views)

    report = {
        "seed": seed,
        "clusters": len(CLUSTERS),
        "nodes": len(CLUSTERS) * NODES_PER_CLUSTER,
        "rounds": ROUNDS,
        "sketch_alpha": DEFAULT_ALPHA,
        "ok": True,
        "metrics": {},
    }
    assert global_doc["fleet"]["nodes"] == report["nodes"], global_doc
    for metric in METRICS:
        values = union[metric]
        merged = global_doc["fleet"][metric]
        entry = {"oracle_n": len(values), "quantiles": {}}
        for q, key in QS:
            exact = _exact_quantile(values, q)
            est = merged[key]
            within = abs(est - exact) <= DEFAULT_ALPHA * exact + 1e-9
            entry["quantiles"][key] = {
                "sketch": est,
                "oracle": round(exact, 3),
                "within_bound": within,
            }
            if not within:
                report["ok"] = False
        report["metrics"][metric] = entry
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="federated analytics smoke: merged-sketch quantiles "
                    "vs the raw-replay oracle over a seeded 3-cluster world"
    )
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args(argv)
    report = run_smoke(args.seed)
    print(json.dumps(report, sort_keys=True))
    return 0 if report["ok"] else 3


if __name__ == "__main__":
    sys.exit(main())
