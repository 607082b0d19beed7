"""Immutable, pre-serialized fleet snapshots: the serving side's heart.

A copy of the JAX package's ``server/snapshot.py``, held equal to it by
``tests/test_torch_copies.py``.  Each round builds one :class:`FleetSnapshot`
with every endpoint body JSON-encoded once, its gzip variant and strong ETag
computed once, and the server swaps it in with one attribute assignment, so
a GET never re-encodes or races the round.  :class:`TrendCache` recomputes
``/api/v1/trend`` only when a round lands or the log file changes.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import threading
from typing import Dict, Optional

JSON_CONTENT_TYPE = "application/json; charset=utf-8"

# Level 6 is zlib's sweet spot; below this size the gzip header overhead
# beats the savings and the raw bytes are served instead.
_GZIP_LEVEL = 6
_GZIP_MIN_BYTES = 256


def entity_tag(raw: bytes) -> str:
    """The strong ETag for a body: quoted truncated sha256.  ONE
    definition shared by :class:`Entity` and the feed consumers that
    digest-verify fragment-joined bodies against a frame's ``to``
    cursor — the watch feed's cursor IS this tag, so the formula must
    not drift per copy."""
    return '"' + hashlib.sha256(raw).hexdigest()[:32] + '"'


class Entity:
    """One immutable HTTP representation: raw bytes + gzip variant + ETag.

    ``gz`` may be supplied precomputed — the delta builder hands in a
    multi-member gzip stream concatenated from per-node cached members
    (RFC 1952 members decompress back to exactly ``raw``), so a delta
    publish compresses only the CHANGED bytes.  Either way the variant is
    served only when it actually saved bytes.
    """

    __slots__ = ("raw", "gz", "etag", "content_type")

    def __init__(self, raw: bytes, content_type: str = JSON_CONTENT_TYPE,
                 gz: Optional[bytes] = None):
        self.raw = raw
        self.content_type = content_type
        if gz is None:
            # mtime=0 pins the gzip header, so identical bodies compress to
            # identical bytes — representation equality mirrors ETag equality.
            gz = (
                gzip.compress(raw, _GZIP_LEVEL, mtime=0)
                if len(raw) >= _GZIP_MIN_BYTES
                else None
            )
        self.gz = gz if gz is not None and len(gz) < len(raw) else None
        self.etag = entity_tag(raw)


def json_entity(obj) -> Entity:
    return Entity((json.dumps(obj, ensure_ascii=False) + "\n").encode("utf-8"))


class FleetSnapshot:
    """One round's queryable state, fully serialized at build time.

    ``entities`` holds the collection endpoints (summary / nodes / slices),
    ``node_entities`` one pre-encoded body per node, and ``node_docs`` the
    raw per-node dicts the control plane's evidence rules read — all
    build-once, mutate-never.  ``node_fragments`` keeps each node entry's
    exact bytes inside the ``nodes`` collection body, so a delta build
    (:func:`build_snapshot_delta`) re-encodes only the changed entries and
    byte-joins the rest.
    """

    __slots__ = ("seq", "ts", "exit_code", "source", "trace_id", "entities",
                 "node_entities", "node_docs", "docs", "node_fragments",
                 "node_gz_fragments")

    def __init__(self, seq: int, ts: float, exit_code: Optional[int], source: str):
        self.seq = seq
        self.ts = ts
        self.exit_code = exit_code
        self.source = source
        # The round trace that built this snapshot (payload-stamped): rides
        # every read response as X-TNC-Trace, the join key the federation
        # tier stitches global traces with.  None for store snapshots.
        self.trace_id: Optional[str] = None
        self.entities: Dict[str, Entity] = {}
        self.node_entities: Dict[str, Entity] = {}
        self.node_docs: Dict[str, dict] = {}
        self.node_fragments: Dict[str, bytes] = {}
        # Per-node gzip MEMBERS (", " separator folded in) of the entries
        # inside the nodes collection body — populated by delta builds so
        # the next delta re-compresses only changed entries (full builds
        # leave it empty; the first delta migrates in one O(n) pass).
        self.node_gz_fragments: Dict[str, bytes] = {}
        # The un-serialized collection docs (references, not copies): what
        # the bench's cold-encode cost model re-encodes per request.
        self.docs: Dict[str, dict] = {}


def build_fragment(obj) -> bytes:
    """One node entry's exact bytes inside the ``nodes`` collection body —
    encoded with the same options ``json_entity`` uses, so fragment-joined
    bodies are byte-identical to whole-document encodes."""
    return json.dumps(obj, ensure_ascii=False).encode("utf-8")


def gzip_fragment(frag: bytes) -> bytes:
    """One node entry (+ its ``", "`` separator) as a standalone gzip
    member — the unit the member-joined collection gz is concatenated
    from, cacheable per node across delta publishes."""
    return gzip.compress(b", " + frag, _GZIP_LEVEL, mtime=0)


def joined_prefix(head: dict, key: str) -> bytes:
    """The byte prefix ``{<head fields>, "<key>": [`` every joined
    collection opens with — ONE definition of the head-splice framing
    (``json.dumps`` default separators, closing brace replaced by the
    array) shared by this module and the federation merge tier, so the
    wire format the marker parsers depend on cannot drift per copy."""
    return (
        json.dumps(head, ensure_ascii=False)[:-1] + f', "{key}": ['
    ).encode("utf-8")


def build_joined_entity(head: dict, key: str, fragments,
                        gz_fragments=None) -> Entity:
    """``{**head, key: [...]}`` as an Entity, the list byte-joined from
    pre-encoded fragments instead of re-encoding every element.

    The byte-identity contract with ``json_entity(dict(head, key=list))``
    is pinned by tests: ``json.dumps`` default separators are ``", "`` /
    ``": "``, so the head's closing brace is replaced by the joined array.

    ``gz_fragments`` (delta builds) is one gzip member per fragment AFTER
    the first (each covering ``", " + fragment``); the gzip variant is then
    the member concatenation ``gz(prefix + frag0) + members + gz(tail)`` —
    a multi-member stream whose decompression is byte-identical to the
    plain body, built without re-deflating any unchanged node.
    """
    prefix = joined_prefix(head, key)
    tail = b"]}\n"
    body = prefix + b", ".join(fragments) + tail
    gz = None
    if gz_fragments is not None and fragments and len(body) >= _GZIP_MIN_BYTES:
        joined = bytearray(
            gzip.compress(prefix + fragments[0], _GZIP_LEVEL, mtime=0)
        )
        for member in gz_fragments[1:]:
            joined += member
        joined += gzip.compress(tail, _GZIP_LEVEL, mtime=0)
        gz = bytes(joined)
    return Entity(body, gz=gz)


def build_summary_doc(payload: dict, exit_code: int, seq: int, ts: float) -> dict:
    """The fleet roll-up doc (what a dashboard tile or CI gate polls) —
    ONE definition shared by the full and delta snapshot builders."""
    slices = payload.get("slices") or []
    summary = {
        "round": seq,
        "ts": ts,
        "exit_code": exit_code,
        "healthy": exit_code == 0,
        "total_nodes": payload.get("total_nodes"),
        "ready_nodes": payload.get("ready_nodes"),
        "total_chips": payload.get("total_chips"),
        "ready_chips": payload.get("ready_chips"),
        "slices": {
            "total": len(slices),
            "complete": sum(1 for s in slices if s.get("complete")),
        },
        "degraded": bool(payload.get("degraded")),
    }
    for key in ("cluster", "trace_id", "probe_summary", "history",
                "expected_chips", "expected_chips_met", "api_transport",
                "watch_stream"):
        if payload.get(key) is not None:
            summary[key] = payload[key]
    return summary


def collection_head(payload: dict, seq: int, ts: float, count: int) -> dict:
    """The nodes collection's head keys — ONE definition for the full and
    delta builders, so the byte-joined body and a whole-document encode can
    never disagree on what precedes the entries.  Carries the round's
    cluster identity when the payload is stamped (``--cluster-name``): the
    field a federation aggregator cross-checks against its endpoints
    file."""
    head = {"round": seq, "ts": ts, "count": count}
    if payload.get("cluster") is not None:
        head["cluster"] = payload["cluster"]
    return head


def build_slices_entity(payload: dict, seq: int, ts: float):
    slices_doc = {"round": seq, "ts": ts}
    if payload.get("cluster") is not None:
        slices_doc["cluster"] = payload["cluster"]
    slices_doc["slices"] = payload.get("slices") or []
    if payload.get("multislices") is not None:
        slices_doc["multislices"] = payload["multislices"]
    return slices_doc, json_entity(slices_doc)


def build_snapshot(
    payload: dict, exit_code: int, seq: int, ts: float
) -> FleetSnapshot:
    """A check round's payload → the round's immutable snapshot.

    The summary is a roll-up (what a dashboard tile or CI gate polls); the
    nodes/slices endpoints carry the payload's own entries verbatim — the
    API must never re-derive (and drift from) what the round computed.
    """
    snap = FleetSnapshot(seq, ts, exit_code, "round")
    snap.trace_id = payload.get("trace_id")
    nodes = payload.get("nodes") or []
    summary = build_summary_doc(payload, exit_code, seq, ts)
    head = collection_head(payload, seq, ts, len(nodes))
    nodes_doc = {**head, "nodes": nodes}
    slices_doc, slices_entity = build_slices_entity(payload, seq, ts)
    snap.docs = {"summary": summary, "nodes": nodes_doc, "slices": slices_doc}
    snap.entities["summary"] = json_entity(summary)
    snap.entities["slices"] = slices_entity
    fragments = []
    for n in nodes:
        frag = build_fragment(n)
        fragments.append(frag)
        name = n.get("name")
        if not isinstance(name, str) or not name:
            continue
        snap.node_docs[name] = n
        snap.node_fragments[name] = frag
        snap.node_entities[name] = json_entity(
            {"round": seq, "ts": ts, "node": n}
        )
    snap.entities["nodes"] = build_joined_entity(head, "nodes", fragments)
    return snap


def build_snapshot_delta(
    prev: FleetSnapshot,
    payload: dict,
    exit_code: int,
    seq: int,
    ts: float,
    changed,
) -> FleetSnapshot:
    """A round's payload → a snapshot that REUSES the previous round's
    per-node work for every node outside ``changed``.

    The steady-state cost model of the watch-stream tentpole: the summary
    and slices docs (small) are re-encoded every publish, but per-node
    entities, evidence docs, collection-body fragments AND their gzip
    members are carried over by reference for unchanged nodes — so a
    5k-node fleet with 50 changed nodes pays 50 entry encodes (and 50
    deflates) plus one byte-join, not 5 000.
    Unchanged per-node entities keep the round/ts of the round that last
    touched them (their bytes — and therefore ETags — are unchanged by
    construction: a poller's cached 304 stays valid until the node itself
    moves).

    ``changed`` is the set of node names whose payload entries differ from
    the previous round; callers own its correctness.  Nodes absent from
    ``prev`` are encoded fresh regardless, so an over-small ``prev`` (or a
    node that flickered out and back) degrades to full-encode, never to a
    stale entry.
    """
    snap = FleetSnapshot(seq, ts, exit_code, "round")
    snap.trace_id = payload.get("trace_id")
    nodes = payload.get("nodes") or []
    summary = build_summary_doc(payload, exit_code, seq, ts)
    head = collection_head(payload, seq, ts, len(nodes))
    nodes_doc = {**head, "nodes": nodes}
    slices_doc, slices_entity = build_slices_entity(payload, seq, ts)
    snap.docs = {"summary": summary, "nodes": nodes_doc, "slices": slices_doc}
    snap.entities["summary"] = json_entity(summary)
    snap.entities["slices"] = slices_entity
    fragments = []
    gz_fragments = []
    for n in nodes:
        name = n.get("name")
        named = isinstance(name, str) and bool(name)
        if named and name not in changed and name in prev.node_fragments:
            frag = prev.node_fragments[name]
            # Compressed-fragment reuse BY REFERENCE: the member was
            # deflated the round this node last changed (or in the one-off
            # migration pass after a full build, which stores no members).
            gz_frag = prev.node_gz_fragments.get(name) or gzip_fragment(frag)
            fragments.append(frag)
            gz_fragments.append(gz_frag)
            snap.node_docs[name] = prev.node_docs[name]
            snap.node_fragments[name] = frag
            snap.node_gz_fragments[name] = gz_frag
            snap.node_entities[name] = prev.node_entities[name]
            continue
        frag = build_fragment(n)
        gz_frag = gzip_fragment(frag)
        fragments.append(frag)
        gz_fragments.append(gz_frag)
        if named:
            snap.node_docs[name] = n
            snap.node_fragments[name] = frag
            snap.node_gz_fragments[name] = gz_frag
            snap.node_entities[name] = json_entity(
                {"round": seq, "ts": ts, "node": n}
            )
    snap.entities["nodes"] = build_joined_entity(
        head, "nodes", fragments, gz_fragments,
    )
    return snap


def build_store_snapshot(path: str, seq: int, ts: float) -> FleetSnapshot:
    """A ``--history`` store file → a snapshot (standalone serving mode).

    The store is the durable twin of the live round: one line per node per
    round, each carrying the FSM verdict.  The snapshot serves each node's
    LATEST line (state/streak/flaps + causes) and a fleet roll-up; slices
    are not recorded in the store, so ``/api/v1/slices`` answers an empty
    list with the source named rather than pretending to know.

    Raises ``OSError`` when the file is unreadable; torn/foreign lines are
    skipped by the shared tolerant loader, exactly like ``--trend-nodes``.
    """
    from tpu_node_checker_torch.history.store import (
        HISTORY_SCHEMA_VERSION,
        read_jsonl_tolerant,
    )

    entries, skipped = read_jsonl_tolerant(path)
    by_node: Dict[str, list] = {}
    for e in entries:
        schema = e.get("schema")
        node = e.get("node")
        if (schema is not None and schema != HISTORY_SCHEMA_VERSION) or not isinstance(
            node, str
        ) or not node:
            skipped += 1
            continue
        by_node.setdefault(node, []).append(e)

    snap = FleetSnapshot(seq, ts, None, "history-store")
    node_docs = []
    states: Dict[str, int] = {}
    last_ts = None
    for name in sorted(by_node):
        seq_entries = sorted(
            by_node[name],
            key=lambda e: e.get("ts") if isinstance(e.get("ts"), (int, float)) else 0.0,
        )
        last = seq_entries[-1]
        state = last.get("state") if isinstance(last.get("state"), str) else None
        doc = {
            "name": name,
            "ok": last.get("ok") if isinstance(last.get("ok"), bool) else None,
            "causes": [str(c) for c in (last.get("causes") or [])],
            "rounds": len(seq_entries),
            "last_ts": last.get("ts"),
            "health": {
                "state": state,
                "streak": last.get("streak"),
                "flaps": last.get("flaps"),
                "flaps_total": last.get("flaps_total"),
            },
        }
        node_docs.append(doc)
        if state:
            states[state] = states.get(state, 0) + 1
        if isinstance(last.get("ts"), (int, float)):
            last_ts = max(last_ts or 0.0, last["ts"])
    summary = {
        "round": seq,
        "ts": ts,
        "source": "history-store",
        "total_nodes": len(node_docs),
        "states": states,
        "chronic": [
            d["name"] for d in node_docs if d["health"]["state"] == "CHRONIC"
        ],
        "last_round_ts": last_ts,
        "skipped_lines": skipped,
    }
    snap.entities["summary"] = json_entity(summary)
    snap.entities["nodes"] = json_entity(
        {"round": seq, "ts": ts, "count": len(node_docs), "nodes": node_docs,
         "source": "history-store"}
    )
    snap.entities["slices"] = json_entity(
        {"round": seq, "ts": ts, "slices": [], "source": "history-store",
         "note": "slice grouping is not recorded in the history store; "
                 "run the server alongside --watch for live slices"}
    )
    for doc in node_docs:
        snap.node_docs[doc["name"]] = doc
        snap.node_entities[doc["name"]] = json_entity(
            {"round": seq, "ts": ts, "node": doc, "source": "history-store"}
        )
    return snap


def build_trendlog_snapshot(path: str, seq: int, ts: float) -> FleetSnapshot:
    """A ``--log-jsonl`` trend log → a summary-only snapshot.

    The degraded standalone mode (no ``--history`` store): per-node state
    was never recorded, so ``/api/v1/nodes`` answers an empty list with the
    source named, and the summary carries the log's LAST usable round —
    enough for a CI gate polling ``healthy`` or a dashboard tile, honest
    about what it cannot know.  Raises ``OSError`` when unreadable.
    """
    from tpu_node_checker_torch.history.store import read_jsonl_tolerant

    entries, skipped = read_jsonl_tolerant(path)
    usable = [
        e
        for e in entries
        if isinstance(e.get("ts"), (int, float))
        and isinstance(e.get("exit_code"), int)
        and not isinstance(e.get("exit_code"), bool)
    ]
    usable.sort(key=lambda e: e["ts"])
    snap = FleetSnapshot(
        seq, ts, usable[-1]["exit_code"] if usable else None, "trend-log"
    )
    summary = {
        "round": seq,
        "ts": ts,
        "source": "trend-log",
        "rounds_recorded": len(usable),
        "skipped_lines": skipped,
    }
    if usable:
        last = usable[-1]
        summary["exit_code"] = last["exit_code"]
        summary["healthy"] = last["exit_code"] == 0
        summary["last_round_ts"] = last["ts"]
        for key in ("total_nodes", "ready_nodes", "total_chips", "ready_chips",
                    "slices", "slices_complete", "degraded", "causes", "chronic"):
            if last.get(key) is not None:
                summary[key] = last[key]
    snap.entities["summary"] = json_entity(summary)
    note = (
        "per-node entries are not recorded in the trend log; serve a "
        "--history store (or run alongside --watch) for node detail"
    )
    snap.entities["nodes"] = json_entity(
        {"round": seq, "ts": ts, "count": 0, "nodes": [],
         "source": "trend-log", "note": note}
    )
    snap.entities["slices"] = json_entity(
        {"round": seq, "ts": ts, "slices": [], "source": "trend-log",
         "note": note}
    )
    return snap


class TrendCache:
    """``/api/v1/trend`` cache over a ``--log-jsonl`` trend log —
    **stale-while-revalidate**, keyed by the TREND-RELEVANT content
    digest.

    Steady state is a stat per request.  When the file's mtime/size
    signature moves, only the APPENDED bytes are parsed (byte-offset
    resume through the history store's tail loader; a shrink or rewrite —
    compaction — re-reads from scratch) and each new entry's projection
    onto the fields the trend math actually consumes is folded into a
    running digest.  Only a digest MOVE triggers a rebuild: a publication
    seq advancing over an unchanged log (the steady watch round), a
    touched-but-identical file, or appended lines carrying no
    trend-relevant fields all cost zero rebuilds — the regression this
    class used to have (one full JSONL re-read + summary per ``(seq,
    signature)`` move, trend-relevant or not) is pinned away by
    ``tests/test_server.py::TestTrendCache``.

    On a digest move the reader is served the PREVIOUS entity immediately
    and ONE rebuild runs on a background thread (SWR); only the very
    first build (nothing stale to serve yet) blocks the requester.
    """

    # The fields compute_trend_summary reads: lines differing only in
    # OTHER fields must not move the digest.
    _TREND_FIELDS = (
        "ts", "exit_code", "causes", "error", "planned", "ready_chips",
        "total_chips", "slices", "slices_complete", "chronic",
    )

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._key = None  # the digest hex the served entity was built from
        self._pending = None  # key a background rebuild is running for
        self._entity: Optional[Entity] = None
        self._sig = None  # (mtime_ns, size) of the last scanned file state
        self._offset = 0  # resume point for the incremental scan
        self._suffix = b""  # last bytes before _offset: rewrite detector
        self._hasher = hashlib.sha256()
        self.rebuilds = 0  # observability + test seam
        self.stale_served = 0  # → ..._swr_stale_served_total

    # tnc: allow-transitive-blocking(the digest scan reads only the bytes APPENDED since the last request — it runs solely when the file signature already moved, replacing the full JSONL re-read + summary rebuild the old (seq,signature) key paid on every publish; the steady path above it is one stat)
    def _advance_digest(self) -> Optional[str]:
        """Fold bytes appended since the last scan into the running
        digest (full re-read after a shrink/rewrite); returns the digest
        hex — the cache key — or ``None`` on a TRANSIENT read failure (an
        external rotation racing the stat): the caller must then NOT
        commit the new signature, so the missed bytes are re-scanned on
        the next request instead of being skipped forever.  A missing
        file is not transient — it digests as empty, matching the
        summary's machine-readable empty-log answer."""
        from tpu_node_checker_torch.history.store import read_jsonl_tail

        try:
            size = os.stat(self.path).st_size
        except OSError:
            size = 0
        if size < self._offset or not self._check_suffix():
            # Shrunk, or the bytes before our resume point changed (an
            # in-place rewrite that GREW the file — mtime/size alone
            # cannot tell it from an append): the running digest no
            # longer describes the file — start over.
            self._offset = 0
            self._suffix = b""
            self._hasher = hashlib.sha256()
        try:
            # max_lines applies only to from-scratch scans (offset 0 —
            # first request, or a shrink/rewrite): the digest guard must
            # never cost more than the rebuild it guards, and the rebuild
            # itself reads at most DEFAULT_TREND_TAIL_LINES.  Resumed
            # scans parse only the appended bytes regardless.
            from tpu_node_checker_torch.history.store import (
                DEFAULT_TREND_TAIL_LINES,
            )

            entries, skipped, self._offset = read_jsonl_tail(
                self.path, max_lines=DEFAULT_TREND_TAIL_LINES,
                start_offset=self._offset,
                consume_partial_tail=False,
            )
        except FileNotFoundError:
            return self._hasher.hexdigest()
        except OSError:
            return None
        for e in entries:
            projection = {
                k: e[k] for k in self._TREND_FIELDS if k in e
            }
            if projection:
                self._hasher.update(
                    json.dumps(projection, sort_keys=True,
                               ensure_ascii=False).encode("utf-8")
                )
            else:
                # A valid line with no trend field still moves the
                # summary's skipped_lines count (the trend math cannot
                # read it), so it is trend-relevant after all — the true
                # digest-holds case is a REWRITE that only changed
                # non-trend FIELDS of existing lines.
                skipped += 1
        if skipped:
            # Malformed lines surface in the summary's skipped count, so
            # they are trend-relevant too.
            self._hasher.update(b"skip:%d" % skipped)
        self._suffix = self._read_suffix()
        return self._hasher.hexdigest()

    _SUFFIX_LEN = 64

    def _check_suffix(self) -> bool:
        """True when the bytes immediately before the resume offset still
        match what the last scan saw — the append-vs-rewrite test."""
        if self._offset == 0:
            return True
        return self._read_suffix() == self._suffix

    def _read_suffix(self) -> bytes:
        start = max(0, self._offset - self._SUFFIX_LEN)
        try:
            with open(self.path, "rb") as f:  # tnc: allow-blocking-read-path(one ≤64-byte pread under _advance_digest's sanctioned signature-moved scan; the steady read path never reaches it)
                f.seek(start)
                return f.read(self._offset - start)
        except OSError:
            return b""

    # tnc: allow-transitive-blocking(the SWR first build is the one sanctioned synchronous store read — once per process, before any stale entity exists to serve; every later rebuild runs on the tnc-trend-swr thread, per the TNC011 exception annotated on the lock below)
    def entity(self) -> Entity:
        from tpu_node_checker_torch.history.store import file_signature

        # tnc: allow-blocking-read-path(the sanctioned exception — DESIGN §10/§13: one stat per request (plus a parse of only the APPENDED bytes when the signature moved); the lock guards flag flips and the FIRST build only, every later rebuild runs on a tnc-trend-swr thread while readers get the stale entity)
        with self._lock:
            sig = file_signature(self.path)
            if sig == self._sig and self._entity is not None:
                # The file did not move: whatever seq did, the summary
                # cannot have changed (the no-op-publish fast path).  A
                # rebuild still in flight means the served entity is
                # stale — the SWR counter must say so.
                if self._pending is not None:
                    self.stale_served += 1
                return self._entity
            key = self._advance_digest()
            if key is None:
                # Transient read failure: keep the old signature so the
                # next request retries the scan; serve what we have.
                if self._entity is not None:
                    return self._entity
                key = self._hasher.hexdigest()
            else:
                # Commit the signature only AFTER the scan succeeded — a
                # failed read must not let sig==self._sig fast-path past
                # the bytes it never digested.
                self._sig = sig
            if key == self._key and self._entity is not None:
                return self._entity  # touched, or non-trend bytes only
            if self._entity is not None:
                # Stale-while-revalidate: serve what we have NOW; exactly
                # one rebuild per digest change runs off-thread.
                if self._pending != key:
                    self._pending = key
                    threading.Thread(
                        target=self._rebuild, args=(key,),
                        name="tnc-trend-swr", daemon=True,
                    ).start()
                self.stale_served += 1
                return self._entity
            # First build: nothing stale to serve, so the requester pays
            # for it (the pre-SWR behavior, once per process).
            entity = self._build_entity()
            self._entity = entity
            self._key = key
            self.rebuilds += 1
            return entity

    def _rebuild(self, key) -> None:
        entity = self._build_entity()
        # Runs on the tnc-trend-swr thread, never a request thread (it is
        # a builder in TNC011's enumeration); the lock guards commit flags.
        with self._lock:
            # Last writer wins: commit unconditionally (the build read the
            # file as it is NOW), clear pending only if no newer key change
            # superseded this rebuild mid-flight.
            self._entity = entity
            self._key = key
            if self._pending == key:
                self._pending = None
            self.rebuilds += 1

    def _build_entity(self) -> Entity:
        # Lazy import: checker imports the server package, so the reverse
        # edge must resolve at call time, not import time.
        from tpu_node_checker_torch.checker import compute_trend_summary

        summary, reason, _rounds, skipped = compute_trend_summary(self.path)
        if summary is None:
            body = {"rounds": 0, "skipped_lines": skipped, "error": reason}
        else:
            body = summary
        return json_entity(body)
