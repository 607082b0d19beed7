"""The federation merge tier: N per-cluster snapshots into one global view.

A copy of the JAX package's ``federation/merge.py``, held equal to it by
``tests/test_torch_copies.py``.  Each cluster's ``/api/v1/nodes`` body is
split once into its head and its entries bytes (:func:`extract_entries`),
kept per cluster in a :class:`ClusterView`, and byte-joined into the
``/api/v1/global/nodes`` body; :func:`build_global_snapshot` also builds the
global summary, the cluster list, one entity per cluster and the merged
analytics document, reusing an unchanged cluster's block and gzip members by
reference.  A cluster whose fetch failed keeps its last-known data, marked
stale, and the global ``healthy`` verdict is judged over fresh clusters only.
"""

from __future__ import annotations

import gzip
import json
import time
from typing import Dict, List, Optional, Tuple

from tpu_node_checker_torch.analytics.sketch import (
    DEFAULT_ALPHA,
    Sketch,
    merge_docs,
)
from tpu_node_checker_torch.server.snapshot import (
    _GZIP_LEVEL,
    _GZIP_MIN_BYTES,
    Entity,
    joined_prefix,
    json_entity,
)

_NODES_MARKER = b'"nodes": ['
_CLUSTERS_MARKER = b'"clusters": ['


def extract_entries(body: bytes) -> Tuple[bytes, dict, str]:
    """One upstream collection body → ``(entries bytes, head dict, key)``.

    The head (round/ts/count/cluster) is parsed from the bytes BEFORE the
    marker — never the entries themselves, so a 5k-node body costs a find
    and a tiny ``json.loads``, not a 5k-entry parse.  The EARLIEST of the
    two collection markers decides the key: a checker's body opens
    ``"nodes": [``, an aggregator's ``/api/v1/global/nodes`` body opens
    ``"clusters": [`` (any nested ``"nodes": [`` lives inside the entries
    and comes later) — which is what lets an aggregator consume another
    aggregator the same way it consumes a checker.  Raises ``ValueError``
    when the body carries neither joined-collection shape.
    """
    candidates = [
        (i, marker, key)
        for i, marker, key in (
            (body.find(_NODES_MARKER), _NODES_MARKER, "nodes"),
            (body.find(_CLUSTERS_MARKER), _CLUSTERS_MARKER, "clusters"),
        )
        if i != -1
    ]
    if not candidates:
        raise ValueError("no \"nodes\" array in body")
    i, marker, key = min(candidates)
    head = json.loads(body[:i] + marker + b"]}")
    # The parse above closes the collection as an empty array; drop it so
    # the head is exactly the dict ``joined_prefix(head, key)`` re-splices
    # the body from (the byte-exact reconstruction contract).
    head.pop(key, None)
    tail = body.rstrip()
    if not tail.endswith(b"]}"):
        raise ValueError("body does not close a joined collection")
    entries = tail[i + len(marker):-2]
    return entries, head, key


def extract_node_entries(body: bytes) -> Tuple[bytes, dict]:
    """Checker-tier shape of :func:`extract_entries` (the original API:
    callers that only ever see ``"nodes": [`` bodies keep their contract,
    error message included)."""
    entries, head, key = extract_entries(body)
    if key != "nodes":
        raise ValueError("no \"nodes\" array in body")
    return entries, head


class ClusterView:
    """One cluster's last-known state in the global view.

    Written by exactly one fetcher worker per round (the consistent-hash
    shard owner); read by the merge on the round thread AFTER the workers
    joined — no lock needed.  Holds the byte caches the merge reuses:
    ``block()`` (this cluster's run inside the global nodes body) and its
    gzip members, keyed on the nodes content identity (``nodes_fp`` — the
    upstream ETag, or a content hash for ETag-less upstreams) + the stale
    flag.
    """

    __slots__ = (
        "name", "url",
        "summary_doc", "summary_etag",
        "nodes_entries", "nodes_etag", "nodes_fp", "nodes_count",
        "nodes_round", "nodes_head", "entries_key", "tier", "feed_blocks",
        "analytics_doc", "analytics_fp", "analytics_rev",
        "analytics_unsupported", "analytics_sketches",
        "reported_cluster",
        "upstream_trace", "upstream_trace_events",
        "consecutive_failures", "rounds_behind", "last_success_wall",
        "last_error", "backoff_skip",
        "fetch_fresh", "fetch_not_modified", "fetch_errors",
        "_block_key", "_block", "_gz_lead", "_gz_mid",
    )

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url
        self.summary_doc: Optional[dict] = None
        self.summary_etag: Optional[str] = None
        self.nodes_entries: Optional[bytes] = None
        self.nodes_etag: Optional[str] = None
        # The upstream collection head these entries were spliced out of —
        # what a restarted feed client needs to reconstruct the exact body
        # (and so resume its stream AT the cached cursor).
        self.nodes_head: Optional[dict] = None
        # What the entries ARE: "nodes" (a checker upstream) or "clusters"
        # (an aggregator upstream — tier stacking).  Pinned by the first
        # successful fetch; the block head splices the same key back in.
        self.entries_key = "nodes"
        # None until discovered; "aggregator" routes fetches to the
        # /api/v1/global/* surface one tier down.
        self.tier: Optional[str] = None
        # Named side-channel blocks the watch feed delivered with this
        # cluster's state (summary / remediation budget / analytics SLO) —
        # surfaced through /api/v1/global/clusters detail, never spliced
        # into the merged nodes body (poll and feed bytes must agree).
        self.feed_blocks: Optional[dict] = None
        # This cluster's last-known analytics SLO doc (the ``analytics_slo``
        # feed block, or the polled /api/v1/analytics/slo body) — the raw
        # material of the global analytics merge.  ``analytics_rev`` bumps
        # only when the doc CHANGES, so the merge's reuse signature can
        # tell a quiet cluster from a moved one without comparing docs.
        self.analytics_doc: Optional[dict] = None
        self.analytics_fp: Optional[str] = None
        self.analytics_rev = 0
        # Lazy per-doc parse memo (sub-doc id → Sketch), reset whenever
        # the doc changes: a quiet shard's sketches deserialize ONCE, not
        # once per global merge — the federation's bytes-not-objects
        # reuse discipline applied to the analytics tier.
        self.analytics_sketches: dict = {}
        # Negative cache for the optional analytics leg: a 404 means the
        # upstream runs without --analytics, and a steady round must not
        # keep re-asking — the fetch tier re-probes only when a mandatory
        # surface served fresh content (the upstream observably changed).
        self.analytics_unsupported = False
        # Cache identity of nodes_entries: the upstream ETag, or a content
        # hash when the upstream sends none (a validator-stripping proxy
        # must not freeze the merged bytes at their first-fetched content).
        self.nodes_fp: Optional[str] = None
        self.nodes_count = 0
        self.nodes_round = None
        self.reported_cluster: Optional[str] = None
        # Two-tier trace stitching: the upstream round's trace_id (from the
        # X-TNC-Trace response header) and that trace's Chrome-trace events
        # (fetched from the upstream's debug endpoint once per NEW upstream
        # round — 304 rounds re-attach the cached events by reference).
        self.upstream_trace: Optional[str] = None
        self.upstream_trace_events: Optional[list] = None
        self.consecutive_failures = 0
        self.rounds_behind = 0
        self.last_success_wall: Optional[float] = None
        self.last_error: Optional[str] = None
        # Rounds the fetch tier will SKIP before re-dialing this cluster
        # (its per-cluster breaker: set after repeated failures so a
        # black-holed upstream can't stall its shard-mates every round).
        # Skipped rounds still advance rounds_behind — staleness labels
        # keep telling the truth while the breaker waits.
        self.backoff_skip = 0
        self.fetch_fresh = 0
        self.fetch_not_modified = 0
        self.fetch_errors = 0
        self._block_key = None
        self._block: Optional[bytes] = None
        self._gz_lead: Optional[bytes] = None
        self._gz_mid: Optional[bytes] = None

    # -- fetch bookkeeping (the owning worker's side) -------------------------

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.rounds_behind = 0
        self.backoff_skip = 0
        self.last_success_wall = time.time()
        self.last_error = None

    def record_failure(self, error: str) -> None:
        self.consecutive_failures += 1
        self.rounds_behind += 1
        self.last_error = error

    def set_analytics(self, doc: Optional[dict],
                      fp: Optional[str] = None) -> None:
        """Install this cluster's analytics SLO doc (None clears it — an
        upstream that stopped serving analytics must 404 out of the
        global view, not freeze in it).  ``fp`` is the upstream's ETag
        when the poll path has one; the feed path passes None and the doc
        is compared directly (feed blocks only arrive when changed, so
        the comparison is rarely reached and never hot)."""
        if doc is None:
            if self.analytics_doc is not None:
                self.analytics_doc = None
                self.analytics_fp = None
                self.analytics_sketches = {}
                self.analytics_rev += 1
            return
        if self.analytics_doc is not None:
            if fp is not None and fp == self.analytics_fp:
                return
            if fp is None and doc == self.analytics_doc:
                return
        self.analytics_doc = doc
        self.analytics_fp = fp
        self.analytics_sketches = {}
        self.analytics_rev += 1

    # -- derived state ---------------------------------------------------------

    @property
    def has_data(self) -> bool:
        return self.summary_doc is not None

    @property
    def stale(self) -> bool:
        """This shard is degraded: the last fetch round did not succeed
        (or none ever has).  Marks ONLY this cluster's entries — the
        fleet view keeps serving around it."""
        return self.rounds_behind > 0 or not self.has_data

    def staleness(self, now_wall: Optional[float] = None) -> dict:
        seconds = None
        if self.last_success_wall is not None:
            seconds = round((now_wall or time.time()) - self.last_success_wall, 1)
        return {"rounds": self.rounds_behind, "seconds": seconds}

    # -- merge-side byte caches ------------------------------------------------

    def block(self) -> bytes:
        """This cluster's run inside the global nodes body — rebuilt only
        when the nodes content identity (upstream ETag, or the fetch
        tier's content hash for ETag-less upstreams), the upstream round,
        or the stale flag moved.  The round rides the key because the
        content hash covers only the entries bytes — an ETag-less
        upstream whose round advances over identical entries must not
        serve a frozen ``"round"`` in its block head."""
        key = (self.nodes_fp or self.nodes_etag, self.nodes_round,
               self.stale, self.entries_key)
        if self._block_key != key or self._block is None:
            head = {
                "cluster": self.name,
                "round": self.nodes_round,
                "count": self.nodes_count,
            }
            if self.stale:
                head["stale"] = True
            self._block = (
                joined_prefix(head, self.entries_key)
                + (self.nodes_entries or b"") + b"]}"
            )
            self._gz_lead = None
            self._gz_mid = None
            self._block_key = key
        return self._block

    def gz_member(self, lead: bool) -> bytes:
        """The block as a standalone gzip member (``lead`` = first block in
        the joined array, no ``", "`` separator folded in) — deflated once
        per block change, reused by reference every round after."""
        block = self.block()
        if lead:
            if self._gz_lead is None:
                self._gz_lead = gzip.compress(block, _GZIP_LEVEL, mtime=0)
            return self._gz_lead
        if self._gz_mid is None:
            self._gz_mid = gzip.compress(b", " + block, _GZIP_LEVEL, mtime=0)
        return self._gz_mid


class GlobalSnapshot:
    """One merge round's immutable, pre-serialized global view.

    Same discipline as :class:`~tpu_node_checker_torch.server.snapshot.FleetSnapshot`:
    built once per round, swapped into the server with a single attribute
    assignment, never mutated after — so the read accessors below are a
    dict lookup, no locks (TNC011's scan set for this module).
    """

    __slots__ = ("seq", "ts", "trace_id", "entities", "cluster_entities",
                 "nodes_sig", "analytics_sig", "analytics_doc",
                 "analytics_merge_ms", "cluster_blocks", "nodes_head",
                 "block_gz", "summary_doc")

    def __init__(self, seq: int, ts: float):
        self.seq = seq
        self.ts = ts
        # The merge round's trace (X-TNC-Trace on every global read; the
        # /api/v1/debug/rounds join key).
        self.trace_id: Optional[str] = None
        self.entities: Dict[str, Entity] = {}
        self.cluster_entities: Dict[str, Entity] = {}
        self.nodes_sig: tuple = ()
        # Reuse signature + parsed doc of the global analytics entity:
        # (cluster, analytics_rev) pairs — unchanged revs mean the merged
        # sketches cannot have moved, so bytes, gzip and ETag serve on.
        # The parsed doc stays on the snapshot for the metrics renderer
        # (re-parsing our own entity bytes every scrape would be silly).
        self.analytics_sig: tuple = ()
        self.analytics_doc: Optional[dict] = None
        self.analytics_merge_ms = 0.0
        # The watch feed's raw material (this aggregator SERVES the same
        # feed it consumes): per-cluster block bytes in body order, the
        # head the body's prefix was spliced from, and the cached mid-run
        # gzip members — all references into the views' byte caches.
        self.cluster_blocks: Dict[str, bytes] = {}
        self.nodes_head: Optional[dict] = None
        self.block_gz: Dict[str, bytes] = {}
        self.summary_doc: Optional[dict] = None

    # -- the read path (lock-free by construction) ----------------------------

    def entity(self, key: str) -> Entity:
        return self.entities[key]

    def cluster_entity(self, name: str) -> Optional[Entity]:
        return self.cluster_entities.get(name)


def build_cluster_entry(view: ClusterView, now_wall: float) -> dict:
    """One cluster's row in ``/api/v1/global/clusters`` — identity, fetch
    health, staleness labels, and the last-known roll-up numbers."""
    entry = {
        "cluster": view.name,
        "url": view.url,
        "reachable": view.consecutive_failures == 0,
        "degraded": view.stale,
        "staleness": view.staleness(now_wall),
    }
    if view.has_data:
        doc = view.summary_doc
        entry["round"] = doc.get("round")
        entry["healthy"] = bool(doc.get("healthy"))
        for key in ("total_nodes", "ready_nodes", "total_chips", "ready_chips"):
            if doc.get(key) is not None:
                entry[key] = doc[key]
    if view.nodes_entries is not None:
        entry["nodes"] = view.nodes_count
    if view.stale and view.last_error:
        entry["error"] = view.last_error
    if view.reported_cluster and view.reported_cluster != view.name:
        # The upstream stamps its own --cluster-name; a mismatch with the
        # endpoints file is a misconfiguration worth surfacing, not hiding.
        entry["reported_cluster"] = view.reported_cluster
    return entry


def build_global_summary(views: List[ClusterView], seq: int, ts: float,
                         trace_id: Optional[str] = None) -> dict:
    """The global roll-up.  ``healthy`` is judged over FRESH clusters only;
    a degraded shard is LISTED (``degraded`` / ``degraded_clusters``) but
    can never sink the fleet verdict — the invariant federation inherits
    from the round's partial-degradation rule."""
    with_data = [v for v in views if v.has_data]
    fresh = [v for v in with_data if not v.stale]
    degraded = sorted(v.name for v in views if v.stale)
    unhealthy = sorted(
        v.name for v in fresh if not v.summary_doc.get("healthy")
    )

    def total(key: str) -> int:
        return sum(v.summary_doc.get(key) or 0 for v in with_data)

    return {
        "round": seq,
        "ts": ts,
        "source": "federation",
        **({"trace_id": trace_id} if trace_id else {}),
        "clusters": {
            "total": len(views),
            "with_data": len(with_data),
            "fresh": len(fresh),
            "degraded": len(degraded),
        },
        # Healthy needs at least one FRESH cluster agreeing; no fresh data
        # at all is not healthy — but it is also not a fleet-wide failure:
        # the last-known numbers below keep serving, labeled.
        "healthy": bool(fresh) and not unhealthy,
        "degraded": bool(degraded),
        "degraded_clusters": degraded,
        "unhealthy_clusters": unhealthy,
        "total_nodes": total("total_nodes"),
        "ready_nodes": total("ready_nodes"),
        "total_chips": total("total_chips"),
        "ready_chips": total("ready_chips"),
        "slices": {
            "total": sum(
                (v.summary_doc.get("slices") or {}).get("total") or 0
                for v in with_data
            ),
            "complete": sum(
                (v.summary_doc.get("slices") or {}).get("complete") or 0
                for v in with_data
            ),
        },
    }


def _cached_sketch(view: ClusterView, doc) -> Optional[Sketch]:
    """Deserialize a sketch doc through the view's parse memo.  Sub-docs
    are identity-stable for as long as ``analytics_doc`` is installed
    (``set_analytics`` swaps doc and memo together), so a quiet shard's
    sketches parse once per delta, not once per global merge.  The cached
    Sketch is never mutated: ``merge_docs`` copies caller-owned objects
    before folding into them."""
    if not isinstance(doc, dict):
        return None
    memo = view.analytics_sketches
    key = id(doc)
    sk = memo.get(key)
    if sk is None and key not in memo:
        sk = memo[key] = Sketch.from_doc(doc)
    return sk


def _merged_slo_entry(entries: List[Tuple[ClusterView, dict]]) -> dict:
    """Merge slo entries (fleet blocks or same-key group rows) into one:
    node counts add, per-metric sketches merge bucket-wise, and the
    percentile triplets are re-derived from the MERGED sketch — never
    averaged from the inputs' percentiles (averaging percentiles is the
    classic federation lie; merging sketches is the whole point).

    Single-contributor entries — most groups in a wide merge, since a
    slice lives in exactly one cluster — memoize their WHOLE result
    beside the view's sketch memo: the derived percentiles cannot change
    while the installed doc doesn't, so a quiet shard's groups cost a
    dict lookup per round.  Callers splat the result into fresh dicts,
    so the cached object is never mutated."""
    if len(entries) == 1:
        view, entry = entries[0]
        memo = view.analytics_sketches
        key = ("entry", id(entry))
        cached = memo.get(key)
        if cached is None:
            cached = memo[key] = _compute_slo_entry(entries)
        return cached
    return _compute_slo_entry(entries)


def _compute_slo_entry(entries: List[Tuple[ClusterView, dict]]) -> dict:
    out: dict = {"nodes": sum(e.get("nodes") or 0 for _, e in entries)}
    sketches: Dict[str, Optional[dict]] = {}
    for metric in ("availability_pct", "mtbf_s", "mttr_s"):
        docs = [(e.get("sketches") or {}).get(metric) for _, e in entries]
        merged = merge_docs(
            _cached_sketch(v, doc)
            for (v, _), doc in zip(entries, docs)
        )
        if merged is not None and merged.total:
            out[metric] = merged.percentiles()
            # Single-contributor groups (most of a 100-cluster merge:
            # every per-slice group appears in exactly one cluster's doc)
            # re-export the upstream's own doc — a re-serialization would
            # say the same bytes slower.
            if len(docs) == 1 and isinstance(docs[0], dict):
                sketches[metric] = docs[0]
            else:
                sketches[metric] = merged.to_doc()
        else:
            out[metric] = None
            sketches[metric] = None
    # Re-exported so the tier above can merge again: the global doc's
    # entries keep the exact shape of a checker's slo entries.
    out["sketches"] = sketches
    return out


def build_global_analytics(views: List[ClusterView]) -> Optional[dict]:
    """N per-cluster SLO docs → one global analytics doc, sketch-merge
    only (never raw replay, never re-fetching node bodies).

    The output deliberately mirrors the per-cluster slo doc's shape —
    ``fleet`` / ``groups`` / ``streams`` / ``offenders`` / ``sketch_alpha``
    — so an aggregator-of-aggregators consumes a lower aggregator's
    ``/api/v1/global/analytics`` body with this very function (the same
    tier-stacking trick ``extract_entries`` plays for node bodies).

    A checker-tier doc (``source: "rollups"``) that carries no explicit
    cluster group (no ``--cluster-name``) gets one synthesized from its
    fleet sketches under the endpoints-file name, so "grouped by cluster"
    holds fleet-wide without forcing every upstream to restate identity.
    Stale shards contribute their LAST-KNOWN sketches, labeled in
    ``clusters`` — the shard-degraded-never-fleet rule, analytics flavor.
    """
    from tpu_node_checker_torch.analytics.queries import OFFENDERS_CAP

    docs = [
        (v, v.analytics_doc)
        for v in sorted(views, key=lambda v: v.name)
        if v.analytics_doc is not None
    ]
    if not docs:
        return None
    alpha = next(
        (
            d.get("sketch_alpha") for _, d in docs
            if isinstance(d.get("sketch_alpha"), (int, float))
        ),
        DEFAULT_ALPHA,
    )
    clusters: Dict[str, dict] = {}
    fleet_entries: List[Tuple[ClusterView, dict]] = []
    grouped: Dict[Tuple[str, str], List[Tuple[ClusterView, dict]]] = {}
    offenders: List[dict] = []
    stream_docs: Dict[str, List[Tuple[ClusterView, dict]]] = {}
    for v, doc in docs:
        fleet = doc.get("fleet") or {}
        fleet_entries.append((v, fleet))
        clusters[v.name] = {
            "nodes": fleet.get("nodes") or 0,
            "stale": v.stale,
        }
        contributes_cluster_group = False
        for g in doc.get("groups") or ():
            kind, group = g.get("kind"), g.get("group")
            if not kind or not group:
                continue
            grouped.setdefault((kind, group), []).append((v, g))
            if kind == "cluster" and group == v.name:
                contributes_cluster_group = True
        if doc.get("source") == "rollups" and not contributes_cluster_group:
            grouped.setdefault(("cluster", v.name), []).append((v, fleet))
        for o in doc.get("offenders") or ():
            if isinstance(o, dict) and o.get("node"):
                offenders.append({**o, "cluster": o.get("cluster") or v.name})
        streams = doc.get("streams")
        if isinstance(streams, dict):
            for name, sdoc in streams.items():
                stream_docs.setdefault(name, []).append((v, sdoc))
    # Fleet-wide re-rank over the UNION of every cluster's worst: same
    # sort key as the per-cluster offenders doc, cluster stamped so the
    # repair queue reads "which machine, where".
    offenders.sort(key=lambda o: (
        o["availability_pct"] if o.get("availability_pct") is not None
        else 100.0,
        -(o.get("flips") or 0),
        o.get("cluster") or "",
        o["node"],
    ))
    merged_streams: Dict[str, dict] = {}
    for name, pairs in sorted(stream_docs.items()):
        merged = merge_docs(_cached_sketch(v, sdoc) for v, sdoc in pairs)
        if merged is not None and merged.total:
            # Same single-contributor reuse as the slo entries.
            if len(pairs) == 1 and isinstance(pairs[0][1], dict):
                merged_streams[name] = pairs[0][1]
            else:
                merged_streams[name] = merged.to_doc()
    return {
        "clusters": clusters,
        "fleet": _merged_slo_entry(fleet_entries),
        "groups": [
            {"kind": kind, "group": group, **_merged_slo_entry(entries)}
            for (kind, group), entries in sorted(grouped.items())
        ],
        "offenders": offenders[:OFFENDERS_CAP],
        "streams": merged_streams,
        "sketch_alpha": alpha,
        "source": "sketches",
    }


def build_global_snapshot(
    views: List[ClusterView],
    seq: int,
    ts: float,
    prev: Optional[GlobalSnapshot] = None,
    trace_id: Optional[str] = None,
) -> GlobalSnapshot:
    """One merge round → the immutable global snapshot.

    The summary and clusters entities are small and rebuilt every round
    (staleness seconds move); the NODES entity — the 100k-node body — is
    reused WHOLE (bytes, gzip and ETag, so pollers keep 304-ing) when no
    cluster's nodes content or freshness changed, and otherwise re-joined
    from per-cluster blocks of which only the changed ones are re-encoded
    or re-deflated.
    """
    views = sorted(views, key=lambda v: v.name)
    snap = GlobalSnapshot(seq, ts)
    snap.trace_id = trace_id
    summary = build_global_summary(views, seq, ts, trace_id=trace_id)
    snap.summary_doc = summary
    snap.entities["global/summary"] = json_entity(summary)

    now_wall = time.time()
    entries = [build_cluster_entry(v, now_wall) for v in views]
    snap.entities["global/clusters"] = json_entity(
        {"round": seq, "ts": ts, "count": len(views), "clusters": entries}
    )
    for view, entry in zip(views, entries):
        snap.cluster_entities[view.name] = json_entity(
            {"round": seq, "ts": ts, "cluster": entry,
             "summary": view.summary_doc}
        )

    with_analytics = [v for v in views if v.analytics_doc is not None]
    snap.analytics_sig = tuple(
        (v.name, v.analytics_rev) for v in with_analytics
    )
    if with_analytics:
        if (
            prev is not None
            and snap.analytics_sig == prev.analytics_sig
            and "global/analytics" in prev.entities
        ):
            # No cluster's analytics rev moved: the merged doc cannot
            # differ — bytes, gzip and ETag serve on (pollers keep
            # 304-ing), and the metrics renderer keeps the parsed doc.
            snap.entities["global/analytics"] = prev.entities["global/analytics"]
            snap.analytics_doc = prev.analytics_doc
            snap.analytics_merge_ms = prev.analytics_merge_ms
        else:
            merge_t0 = time.perf_counter()
            analytics = build_global_analytics(views)
            if analytics is not None:
                snap.analytics_doc = analytics
                snap.analytics_merge_ms = round(
                    (time.perf_counter() - merge_t0) * 1000.0, 3
                )
                snap.entities["global/analytics"] = json_entity(
                    {"round": seq, "ts": ts, **analytics}
                )

    with_nodes = [v for v in views if v.nodes_entries is not None]
    snap.nodes_sig = tuple(
        (v.name, v.nodes_fp or v.nodes_etag, v.nodes_round, v.stale)
        for v in with_nodes
    )
    if prev is not None and snap.nodes_sig == prev.nodes_sig:
        # Nothing observable moved: the previous entity (bytes, gz AND
        # ETag) serves on — every poller's cached ETag keeps 304-ing.
        # The feed carriers come along unchanged too: the head must keep
        # describing the bytes the reused ETag names, and the block
        # references are the views' caches (identical by the sig).
        snap.entities["global/nodes"] = prev.entities["global/nodes"]
        snap.cluster_blocks = prev.cluster_blocks
        snap.nodes_head = prev.nodes_head
        snap.block_gz = prev.block_gz
        return snap

    head = {
        "round": seq,
        "ts": ts,
        "cluster_count": len(with_nodes),
        "count": sum(v.nodes_count for v in with_nodes),
    }
    prefix = joined_prefix(head, "clusters")
    tail = b"]}\n"
    body = prefix + b", ".join(v.block() for v in with_nodes) + tail
    gz = None
    if with_nodes and len(body) >= _GZIP_MIN_BYTES:
        # Member-concatenated gzip (RFC 1952): tiny fresh members for the
        # prefix/tail, each cluster's CACHED member in between — only
        # changed clusters were re-deflated above.
        joined = bytearray(gzip.compress(prefix, _GZIP_LEVEL, mtime=0))
        for i, v in enumerate(with_nodes):
            joined += v.gz_member(lead=(i == 0))
        joined += gzip.compress(tail, _GZIP_LEVEL, mtime=0)
        gz = bytes(joined)
    snap.entities["global/nodes"] = Entity(body, gz=gz)
    snap.nodes_head = head
    snap.cluster_blocks = {v.name: v.block() for v in with_nodes}
    # Watch-feed gzip reuse: the MID-run member (", " + block) is what a
    # delta frame can splice by reference; views that only ever deflated
    # as the lead member simply fall back at frame-build time.
    snap.block_gz = {
        v.name: v._gz_mid for v in with_nodes if v._gz_mid is not None
    }
    return snap
