"""The SLO query engine: availability, MTBF and MTTR percentiles, offender
rankings and flap views, computed from roll-ups.

A copy of the JAX package's ``analytics/queries.py``, held equal to it by
``tests/test_torch_copies.py``.  :func:`build_analytics_docs` returns the
``slo``, ``offenders`` and ``flaps`` documents that the fleet API serves
under ``/api/v1/analytics/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from tpu_node_checker_torch.analytics.segments import (
    FLEET_STREAM,
    RESERVED_STREAM_PREFIX,
    RESOLUTIONS,
    SegmentStore,
)
from tpu_node_checker_torch.analytics.sketch import (
    DEFAULT_ALPHA,
    merge_docs,
    sketch_of,
)

# Worst-offender list depth (the --trend-nodes convention).
OFFENDERS_CAP = 10

# Closed 1m buckets per node in the flaps view: ~half an hour of rate.
FLAP_VIEW_BUCKETS = 30

_PCTLS = (50, 90, 99)


def _pctl(sorted_values: List[float], pct: int) -> Optional[float]:
    if not sorted_values:
        return None
    idx = max(0, min(len(sorted_values) - 1,
                     int(len(sorted_values) * pct / 100.0 + 0.5) - 1))
    return sorted_values[idx]


def _percentiles(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    values = sorted(values)
    return {f"p{p}": round(_pctl(values, p), 2) for p in _PCTLS}


def node_stats_view(store: SegmentStore) -> Dict[str, dict]:
    """Per-node SLO numbers from the store's running aggregates."""
    out: Dict[str, dict] = {}
    for node, s in sorted(store.node_stats.items()):
        if node.startswith(RESERVED_STREAM_PREFIX):
            # Reserved duration streams (``_fleet``) ride the bucket
            # machinery but are not nodes — they surface through the slo
            # doc's "streams" block, never through node views.
            continue
        n = s["n"]
        span = (
            (s["last_ts"] - s["first_ts"])
            if s["first_ts"] is not None and s["last_ts"] is not None
            else 0.0
        )
        out[node] = {
            "rounds": n,
            "availability_pct": (
                round(100.0 * s["ok"] / n, 2) if n else None
            ),
            "failures": s["onsets"],
            "flips": s["flips"],
            # Mean seconds between failure onsets over the observed span.
            "mtbf_s": (
                round(span / s["onsets"], 1) if s["onsets"] >= 2 and span > 0
                else None
            ),
            "mttr_s": (
                round(s["repair_s"] / s["repairs"], 1)
                if s["repairs"] else None
            ),
            "last_ok": s["last_ok"],
        }
    return out


def _group_keys(store: SegmentStore, node: str) -> List[Tuple[str, str]]:
    group = store.node_groups.get(node) or {}
    keys = []
    for kind in ("cluster", "slice", "topology"):
        value = group.get(kind)
        if value:
            keys.append((kind, value))
    return keys


def build_analytics_docs(store: SegmentStore, detector=None,
                         predictions: Optional[List[dict]] = None) -> dict:
    """→ ``{"slo": …, "offenders": …, "flaps": …}`` (plain data; the
    server serializes each into one snapshot entity)."""
    nodes = node_stats_view(store)

    # -- slo: percentiles per (kind, group) ---------------------------------
    grouped: Dict[Tuple[str, str], dict] = {}
    fleet = {"availability": [], "mtbf": [], "mttr": [], "nodes": 0}
    for node, v in nodes.items():
        targets = [fleet]
        for key in _group_keys(store, node):
            g = grouped.get(key)
            if g is None:
                g = grouped[key] = {
                    "availability": [], "mtbf": [], "mttr": [], "nodes": 0,
                }
            targets.append(g)
        for g in targets:
            g["nodes"] += 1
            if v["availability_pct"] is not None:
                g["availability"].append(v["availability_pct"])
            if v["mtbf_s"] is not None:
                g["mtbf"].append(v["mtbf_s"])
            if v["mttr_s"] is not None:
                g["mttr"].append(v["mttr_s"])

    def _slo_entry(g: dict) -> dict:
        return {
            "nodes": g["nodes"],
            "availability_pct": _percentiles(g["availability"]),
            "mtbf_s": _percentiles(g["mtbf"]),
            "mttr_s": _percentiles(g["mttr"]),
            # Mergeable mirror of the percentile triplet: one sample per
            # node, so an aggregator merging two clusters' sketches gets
            # the distribution over the UNION of their nodes — the thing
            # the percentile dicts above cannot give without raw stats.
            "sketches": {
                metric: (sketch_of(g[src]).to_doc() if g[src] else None)
                for metric, src in (
                    ("availability_pct", "availability"),
                    ("mtbf_s", "mtbf"),
                    ("mttr_s", "mttr"),
                )
            },
        }

    # -- offenders: worst-first repair queue --------------------------------
    ranked = sorted(
        nodes,
        key=lambda n: (
            nodes[n]["availability_pct"]
            if nodes[n]["availability_pct"] is not None
            else 100.0,
            -nodes[n]["flips"],
            n,
        ),
    )

    # Fleet-wide duration streams: the per-sample sketches the store
    # persists in bucket records.  round/link durations live under the
    # reserved ``_fleet`` stream; repair age and per-event repair times
    # merge across every real node (merge_docs skips missing sketches).
    fleet_sketches = (
        store.node_stats.get(FLEET_STREAM, {}).get("sketches") or {}
    )
    streams: Dict[str, dict] = {}
    for metric in ("round_ms", "link_us"):
        sk = fleet_sketches.get(metric)
        if sk is not None and sk.total:
            streams[metric] = sk.to_doc()
    for metric, out_name in (("repair_age_s", "repair_age_s"),
                             ("mttr_s", "mttr_event_s")):
        merged = merge_docs(
            (s.get("sketches") or {}).get(metric)
            for node, s in store.node_stats.items()
            if not node.startswith(RESERVED_STREAM_PREFIX)
        )
        if merged is not None and merged.total:
            streams[out_name] = merged.to_doc()

    slo = {
        "fleet": _slo_entry(fleet),
        "groups": [
            {"kind": kind, "group": name, **_slo_entry(g)}
            for (kind, name), g in sorted(grouped.items())
        ],
        "streams": streams,
        # A compact worst-first brief so the aggregator can re-rank
        # offenders FLEET-WIDE from slo blocks alone (the full offenders
        # doc stays poll-only; the feed carries just the slo block).
        "offenders": [
            {
                "node": n,
                "availability_pct": nodes[n]["availability_pct"],
                "flips": nodes[n]["flips"],
                "mttr_s": nodes[n]["mttr_s"],
                "last_ok": nodes[n]["last_ok"],
            }
            for n in ranked[:OFFENDERS_CAP]
        ],
        "sketch_alpha": DEFAULT_ALPHA,
        "source": "rollups",
    }
    offenders = {
        "offenders": [
            {"node": n, **nodes[n], "group": store.node_groups.get(n) or {}}
            for n in ranked[:OFFENDERS_CAP]
        ],
        "nodes_total": len(nodes),
    }

    # -- flaps: rates + changepoint state -----------------------------------
    finest = RESOLUTIONS[0]
    # Filter to the finest resolution BEFORE sorting: at fleet scale the
    # bucket dict is dominated by the coarser resolutions this view never
    # reads, and sorting the whole dict per round would be O(B log B) of
    # wasted work on the round path.
    recent: Dict[str, List[dict]] = {}
    for (node, res, bucket), e in sorted(
        item for item in store.buckets.items() if item[0][1] == finest
    ):
        recent.setdefault(node, []).append(
            {"bucket": bucket, "n": e.get("n") or 0,
             "flips": e.get("flips") or 0}
        )
    flap_nodes = []
    for node in sorted(nodes):
        buckets = recent.get(node, [])[-FLAP_VIEW_BUCKETS:]
        flap_nodes.append({
            "node": node,
            "flips_total": nodes[node]["flips"],
            "recent_buckets": buckets,
            "cusum": (
                round(detector.score(node), 3) if detector is not None
                else None
            ),
            "predicted": (
                node in detector.active if detector is not None else False
            ),
        })
    flaps = {
        "nodes": flap_nodes,
        "predictions": list(predictions or []),
        "predictions_total": (
            detector.detections_total if detector is not None else 0
        ),
        "bucket_resolution_s": finest,
    }
    return {"slo": slo, "offenders": offenders, "flaps": flaps}


def replay_raw(path: str) -> Dict[str, dict]:
    """The raw-replay oracle: per-node stats straight from the history
    JSONL — O(every round ever written).

    This is the cost model the roll-up path replaces; it stays as (a) the
    property test's equivalence ground truth and (b) the bench's raw leg.
    Uses the same torn-line-tolerant loader as every JSONL surface.
    """
    from tpu_node_checker_torch.history.store import (
        HISTORY_SCHEMA_VERSION,
        read_jsonl_tolerant,
    )

    entries, _skipped = read_jsonl_tolerant(path)
    out: Dict[str, dict] = {}
    failing: Dict[str, float] = {}
    last_ok: Dict[str, bool] = {}
    for e in entries:
        schema = e.get("schema")
        node = e.get("node")
        ok = e.get("ok")
        ts = e.get("ts")
        if (
            (schema is not None and schema != HISTORY_SCHEMA_VERSION)
            or not isinstance(node, str) or not node
            or not isinstance(ok, bool)
            or not isinstance(ts, (int, float))
        ):
            continue
        s = out.setdefault(node, {
            "n": 0, "ok": 0, "flips": 0, "onsets": 0, "repairs": 0,
            "repair_s": 0.0, "first_ts": None, "last_ts": None,
            "last_ok": None,
        })
        s["n"] += 1
        s["ok"] += 1 if ok else 0
        prev = last_ok.get(node)
        if prev is not None and prev != ok:
            s["flips"] += 1
        last_ok[node] = ok
        if not ok and node not in failing:
            failing[node] = float(ts)
            s["onsets"] += 1
        elif ok and node in failing:
            s["repairs"] += 1
            s["repair_s"] += max(0.0, float(ts) - failing.pop(node))
        if s["first_ts"] is None:
            s["first_ts"] = float(ts)
        s["last_ts"] = float(ts)
        s["last_ok"] = ok
    for s in out.values():
        s["repair_s"] = round(s["repair_s"], 3)
    return out
