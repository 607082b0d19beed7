"""Watch-stream incremental rounds (``--watch-stream``): O(changes) ticks.

A copy of the JAX package's ``watchstream.py``, held equal to it by
``tests/test_torch_copies.py``.  One LIST seeds a :class:`NodeCache` and
gives the resourceVersion a Kubernetes node watch resumes from; a reader
thread (:class:`_StreamWorker`) folds ADDED, MODIFIED and DELETED events
into the cache, dirtying a node only when its :func:`grading_view`
changed; each round of the ``--watch`` loop calls
:meth:`StreamRoundEngine.tick`, which returns the cached round when nothing
changed and otherwise re-grades only the changed nodes.  A 410 or a lost
stream costs exactly one relist, and a relist that fails raises like a
failed poll round.  A silent stream is no new evidence: the hysteresis
machine observes only the nodes that changed.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

# Watch event types per the Kubernetes API (meta/v1 WatchEvent).
EVENT_TYPES = ("ADDED", "MODIFIED", "DELETED", "BOOKMARK", "ERROR")


def _private_timer():
    """A tick driven without the watch loop's tracer (tests, bench) still
    times itself — same Tracer, just not on anyone's debug ring."""
    from tpu_node_checker_torch.obs.trace import Tracer

    return Tracer()


def grading_view(node: dict) -> tuple:
    """The grading-relevant projection of one raw node object.

    Everything ``detect.extract_node_info`` reads — name, labels,
    annotations, ``spec.unschedulable``/``spec.taints`` (NOT the rest of
    spec: podCIDR/providerID churn is invisible to grading), allocatable/
    capacity, and conditions MINUS their heartbeat timestamps.  Two nodes
    with equal views grade identically, so a MODIFIED event whose view is
    unchanged (a kubelet status heartbeat, a lease bump serialized onto
    the object) updates the cache without dirtying the node — the
    property that keeps steady-state ticks at O(changes) on a chatty API
    server.  This is also the preimage of the relist fast path's content
    address (``fastpath.grading_digest``), so a raw watch-event object and
    its projection-pruned twin hash identically by construction.
    """
    meta = node.get("metadata") if isinstance(node.get("metadata"), dict) else {}
    status = node.get("status") if isinstance(node.get("status"), dict) else {}
    spec = node.get("spec") if isinstance(node.get("spec"), dict) else {}
    conditions = status.get("conditions")
    cond_sig: tuple = ()
    if isinstance(conditions, list):
        cond_sig = tuple(
            (
                c.get("type"),
                c.get("status"),
                c.get("reason"),
                c.get("message"),
            )
            for c in conditions
            if isinstance(c, dict)
        )
    return (
        meta.get("name"),
        meta.get("labels"),
        meta.get("annotations"),
        spec.get("unschedulable"),
        spec.get("taints"),
        status.get("allocatable"),
        status.get("capacity"),
        cond_sig,
    )


class WatchStats:
    """Thread-shared stream telemetry → ``tpu_node_checker_watch_*``.

    Written by the reader thread (per event) and the engine (per relist /
    reconnect), read by the tick when it builds the payload's
    ``watch_stream`` block — every access under the one lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[str, int] = {}
        self._relists: Dict[str, int] = {}
        self._last_activity = time.monotonic()
        self._connected = False

    def count_event(self, etype: str) -> None:
        with self._lock:
            self._events[etype] = self._events.get(etype, 0) + 1
            self._last_activity = time.monotonic()

    def count_relist(self, reason: str) -> None:
        with self._lock:
            self._relists[reason] = self._relists.get(reason, 0) + 1
            self._last_activity = time.monotonic()

    def set_connected(self, connected: bool) -> None:
        with self._lock:
            self._connected = connected
            if connected:
                self._last_activity = time.monotonic()

    def as_dict(self) -> dict:
        """The payload's ``watch_stream`` block (a fresh snapshot dict —
        published payloads are immutable, so counters are copied out)."""
        with self._lock:
            return {
                "events_total": dict(self._events),
                "relists_total": dict(self._relists),
                "stream_age_seconds": round(
                    time.monotonic() - self._last_activity, 3
                ),
                "connected": self._connected,
            }


class NodeCache:
    """The fleet's raw node objects, folded from LIST + watch events.

    One writer thread (the stream reader) applies events; the tick drains
    the changed-name set.  Raw node dicts are REPLACED whole on every
    apply, never mutated in place, so references handed out by
    :meth:`drain` stay safe to read without the lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[str, dict] = {}
        # name → 16-byte grading digest (fastpath.grading_digest): the one
        # content address both a projected relist and a raw watch event
        # produce, so seed-vs-apply comparisons never cross types.
        self._views: Dict[str, bytes] = {}
        self._changed: Set[str] = set()
        self._removed: Set[str] = set()
        self.resource_version: Optional[str] = None

    def seed(self, items, resource_version: Optional[str]) -> None:
        """Replace the cache with a fresh LIST, diffing against what was
        already held: only nodes that appeared, vanished, or changed their
        grading view land in the changed/removed sets — a relist after a
        brief stream hiccup dirties (and later re-encodes) almost nothing.

        ``items`` is a :class:`~tpu_node_checker_torch.fastpath.ProjectedFleet`
        on the fast path (digests ride along — unchanged byte-runs carried
        their digest by reference, so this loop hashes nothing), or a raw
        node list (offline fixtures, drop-in clients), which is digested
        here through the same one definition.
        """
        from tpu_node_checker_torch.fastpath import ProjectedFleet, grading_digest

        if isinstance(items, ProjectedFleet):
            fresh, fresh_views = items.seed_maps()
        else:
            fresh = {}
            fresh_views = {}
            for node in items:
                meta = node.get("metadata") if isinstance(node.get("metadata"), dict) else {}
                name = meta.get("name")
                if not isinstance(name, str) or not name:
                    continue
                fresh[name] = node
                fresh_views[name] = grading_digest(node)
        with self._lock:
            # C-speed diffing (the relist hot path): names whose
            # (name, digest) pair is new or different, and names that
            # vanished — both as dict-view set operations, no Python loop
            # over 5k unchanged nodes.
            dirty = {name for name, _ in fresh_views.items() - self._views.items()}
            gone = self._views.keys() - fresh_views.keys()
            self._changed |= dirty
            self._changed -= gone
            self._removed -= fresh_views.keys()
            self._removed |= gone
            self._nodes = fresh
            self._views = fresh_views
            self.resource_version = resource_version

    def apply(self, etype: str, obj: dict) -> None:
        """Fold one ADDED/MODIFIED/DELETED event into the cache."""
        from tpu_node_checker_torch.fastpath import grading_digest

        if not isinstance(obj, dict):
            return
        meta = obj.get("metadata") if isinstance(obj.get("metadata"), dict) else {}
        name = meta.get("name")
        if not isinstance(name, str) or not name:
            return
        rv = meta.get("resourceVersion")
        view = grading_digest(obj) if etype != "DELETED" else None
        with self._lock:
            if rv:
                self.resource_version = str(rv)
            if etype == "DELETED":
                self._nodes.pop(name, None)
                self._views.pop(name, None)
                self._changed.discard(name)
                self._removed.add(name)
                return
            changed = self._views.get(name) != view
            self._nodes[name] = obj
            self._views[name] = view
            self._removed.discard(name)
            if changed:
                self._changed.add(name)

    def note_bookmark(self, obj: dict) -> None:
        """BOOKMARK events carry only a resourceVersion: advance the
        resumption point, touch nothing else."""
        meta = (obj or {}).get("metadata") if isinstance(obj, dict) else None
        rv = (meta or {}).get("resourceVersion")
        if rv:
            with self._lock:
                self.resource_version = str(rv)

    def pending(self) -> int:
        """Changed + removed names not yet drained (test/bench seam)."""
        with self._lock:
            return len(self._changed) + len(self._removed)

    def drain(self) -> Tuple[Dict[str, dict], FrozenSet[str]]:
        """Take this tick's deltas: ``(changed name → raw node, removed)``.

        Clears both sets; the returned raw dicts are the cache's current
        objects (safe: applies replace, never mutate)."""
        with self._lock:
            changed = {
                name: self._nodes[name]
                for name in self._changed
                if name in self._nodes
            }
            removed = frozenset(self._removed)
            self._changed = set()
            self._removed = set()
            return changed, removed


class _StreamWorker(threading.Thread):
    """Reader thread for ONE established watch stream.

    Deliberately dumb: it decodes frames and folds them into the cache
    until the stream ends — by clean EOF, 410 replayed as an ERROR event,
    a decode error, or a socket error/timeout — then records why and
    exits.  It makes NO API calls: reconnecting and relisting happen in
    the tick, synchronously, where a failure rides the existing
    round-failure path (and its breaker) instead of dying unseen in a
    background thread.
    """

    def __init__(self, stream, cache: NodeCache, stats: WatchStats):
        super().__init__(name="tnc-watch-stream", daemon=True)
        self._stream = stream
        self._cache = cache
        self._stats = stats
        self.exit_reason = "stream_end"

    def run(self) -> None:
        try:
            for line in self._stream.iter_lines():
                try:
                    event = json.loads(line)
                except ValueError:
                    # A frame that is not JSON means the decode framing is
                    # lost — resynchronizing mid-stream is guesswork, and a
                    # relist re-establishes truth cheaply.
                    self.exit_reason = "stream_error"
                    return
                etype = event.get("type")
                obj = event.get("object")
                self._stats.count_event(
                    etype if etype in EVENT_TYPES else "ERROR"
                )
                if etype == "BOOKMARK":
                    self._cache.note_bookmark(obj)
                elif etype == "ERROR":
                    # The in-band 410 replay: a Status object on the stream
                    # when the resourceVersion expired under us.
                    code = obj.get("code") if isinstance(obj, dict) else None
                    self.exit_reason = "gone" if code == 410 else "stream_error"
                    return
                elif etype in ("ADDED", "MODIFIED", "DELETED"):
                    self._cache.apply(etype, obj)
                # Unknown types are counted (as ERROR) and skipped: a new
                # event kind must not kill the stream.
            self.exit_reason = "stream_end"
        except Exception:  # tnc: allow-broad-except(any read failure — timeout, reset, TLS teardown — is the one 'stream lost' outcome; the tick relists)
            self.exit_reason = "stream_error"
        finally:
            self._stats.set_connected(False)
            self._stream.close()


class StreamRoundEngine:
    """The watch loop's round engine under ``--watch-stream``.

    Owns the node cache, the stream worker, and the per-node grading
    caches (NodeInfo + serialized payload entry per node).  ``tick()`` is
    the whole round: ensure the stream lives (relisting through the retry
    ladder when it does not), drain the cache's deltas, re-grade only the
    changed nodes, and return a fresh ``CheckResult`` plus the changed
    name set the snapshot delta-patcher consumes.

    Single-threaded by contract: ticks run on the watch loop's thread; the
    only concurrent writer is the stream worker, and the cache/stats locks
    are the only shared state between them.
    """

    def __init__(self, args):
        from tpu_node_checker_torch import checker

        self.args = args
        self.cache = NodeCache()
        self.stats = WatchStats()
        self._registry = checker._registry_from_args(args)
        self._worker: Optional[_StreamWorker] = None
        self._stream = None
        self._client = None
        self._seeded = False
        # Per-node grading caches, keyed by node name: the NodeInfo and its
        # payload entry are rebuilt only when the node's grading view
        # changed — everything else is reused by reference.
        self._infos: Dict[str, object] = {}
        self._entries: Dict[str, dict] = {}
        self._accel_names: List[str] = []
        self._entries_list: List[dict] = []
        self._last_result = None
        self._last_history_rollup: Optional[dict] = None
        # This tick's analytics predictions (--analytics on the stream):
        # steady ticks fold evidence but cannot flip, so the list empties
        # on any tick without fresh detections — same semantics as the
        # transition log.
        self._last_predictions: List[dict] = []
        # Incremental slice cache (the relist fast path, one level up):
        # group membership, SliceInfo objects and their payload dicts are
        # rebuilt ONLY for groups touching a changed node — every other
        # slice (and its serialized payload entry) is reused by reference,
        # exactly like per-node entries.  None until the first full build.
        self._slice_infos: Optional[Dict[tuple, object]] = None
        self._slice_members: Dict[tuple, set] = {}
        self._node_slice_key: Dict[str, tuple] = {}
        self._slice_dicts: Dict[tuple, dict] = {}

    # -- stream lifecycle ----------------------------------------------------

    def _connect(self, timer) -> None:
        """(Re)establish LIST + WATCH.  Every path that needs a fresh LIST
        funnels through here, so "full relist only on stream loss" is a
        structural property, not a convention.

        The dead worker's exit reason is consumed exactly once: if the
        relist below succeeds but the watch connect then fails (the tick
        raises into the breaker path), the NEXT tick sees no pending
        reason and retries only the connect — one stream loss is one
        relist, never one per failed reconnect attempt.
        """
        from tpu_node_checker_torch import checker
        from tpu_node_checker_torch.cluster import WatchGone, resolve_cluster_config

        reason = None
        if not self._seeded:
            reason = "seed"
        elif self._worker is not None:
            reason = self._worker.exit_reason
        self._worker = None
        with timer.phase("config"):
            cfg = resolve_cluster_config(
                getattr(self.args, "kubeconfig", None),
                getattr(self.args, "context", None),
            )
            # Fresh shared retry budget per (re)connect, exactly like a
            # poll-mode round: the relist rides the same graded ladder.
            checker._ROUND_POLICY["policy"] = checker._build_retry_policy(self.args)
            client = checker._cached_client(cfg)
            self._client = client
        label_selector = getattr(self.args, "label_selector", None)
        if reason is not None:
            with timer.phase("list"):
                # The relist fast path: projection decode + page/byte-run
                # reuse on the client's ListProjector, digests riding into
                # the seed — a post-loss relist re-extracts O(changes).
                fleet = client.list_nodes_projected(label_selector=label_selector)
            self.cache.seed(fleet, fleet.resource_version)
            self.stats.count_relist(reason)
            self._seeded = True
        with timer.phase("watch_connect"):
            try:
                stream = client.watch_nodes(
                    self.cache.resource_version, label_selector=label_selector
                )
            except WatchGone:
                # The LIST's resourceVersion already expired (aggressive
                # compaction): one more relist, then the connect must stick.
                fleet = client.list_nodes_projected(label_selector=label_selector)
                self.cache.seed(fleet, fleet.resource_version)
                self.stats.count_relist("gone")
                stream = client.watch_nodes(
                    self.cache.resource_version, label_selector=label_selector
                )
        self._stream = stream
        self.stats.set_connected(True)
        worker = _StreamWorker(stream, self.cache, self.stats)
        self._worker = worker
        worker.start()

    def stream_alive(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def abort_stream(self) -> None:
        """Tear the stream down (failed tick / shutdown): the next tick
        reconnects from scratch.  Closing the socket is also what unblocks
        a reader parked in ``readline``."""
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        self.stats.set_connected(False)

    def close(self) -> None:
        self.abort_stream()

    # -- the round -----------------------------------------------------------

    def tick(self, tracer=None):
        """One watch-stream round → ``(CheckResult, changed_names)``.

        ``changed_names`` is the frozenset the snapshot delta-patcher
        keys on: empty means nothing observable moved and the caller can
        skip publishing entirely.  Raises (exactly like ``run_check``)
        when the stream is down and the relist fails — the watch loop's
        breaker/backoff path handles it.

        ``tracer`` (the watch loop's per-round trace) turns the tick's
        phases into spans on the round trace — ``fold`` (drain the event
        cache), ``grade`` (re-extract changed nodes, with ``detect`` /
        ``fsm`` / ``render`` children) — alongside the caller's
        ``publish`` / ``delta-build`` spans; without one a private tracer
        keeps ``timings_ms`` working identically.
        """
        timer = tracer if tracer is not None else _private_timer()
        if not self.stream_alive():
            self._connect(timer)
        with timer.span("fold"):
            changed_raw, removed = self.cache.drain()
        if not changed_raw and not removed and self._last_result is not None:
            result = self._steady_result(timer)
            # --analytics on a steady tick: the fleet's CURRENT verdicts
            # still fold into the roll-up buckets (a healthy hour is
            # availability evidence, not the absence of evidence) — this
            # is what makes a steady --watch-stream fleet produce
            # roll-ups at all.  Without the flag this is one falsy
            # getattr: the zero-cost steady path stays zero-cost.
            if getattr(self.args, "analytics", None):
                self._fold_steady_analytics(timer, result)
            return result, frozenset()
        changed = self._grade(changed_raw, removed, timer)
        result = self._build_result(timer, changed)
        self._last_result = result
        return result, changed

    def _grade(self, changed_raw, removed, timer) -> FrozenSet[str]:
        """Re-extract ONLY the changed nodes; returns the set of payload
        node names whose entries must be re-encoded downstream.  The whole
        pass is one ``grade`` span with ``detect``/``fsm``/``render``
        children — the hierarchy a slow churn round is debugged by."""
        from tpu_node_checker_torch import checker
        from tpu_node_checker_torch.detect import extract_node_info
        from tpu_node_checker_torch.report import _node_entry

        with timer.span("grade", changed=len(changed_raw), removed=len(removed)):
            return self._grade_inner(
                changed_raw, removed, timer, extract_node_info, _node_entry,
                checker,
            )

    def _grade_inner(self, changed_raw, removed, timer, extract_node_info,
                     _node_entry, checker) -> FrozenSet[str]:
        changed_names: Set[str] = set()
        with timer.phase("detect"):
            for name in removed:
                self._infos.pop(name, None)
                self._entries.pop(name, None)
                changed_names.add(name)
            for name, raw in changed_raw.items():
                info = extract_node_info(raw, self._registry)
                if info.accelerators > 0 or info.families:
                    self._infos[name] = info
                    changed_names.add(name)
                else:
                    # A CPU node: invisible to the payload.  If it USED to
                    # be an accelerator node (label stripped), drop it.
                    if self._infos.pop(name, None) is not None:
                        changed_names.add(name)
                    self._entries.pop(name, None)
            self._accel_names = sorted(self._infos)
        history = checker._build_history(self.args)
        analytics = (
            checker._build_analytics(self.args) if history is not None
            else None
        )
        if history is not None:
            with timer.span("fsm"):
                evidence = [
                    self._infos[n]
                    for n in self._accel_names
                    if n in changed_names
                ]
                # Only nodes with fresh events observe a verdict: a silent
                # stream is no new evidence (DESIGN §12) — state, streaks
                # and flap windows hold for everyone else.  With
                # --analytics the unchanged rest of the fleet rides along
                # as ``steady``: their verdicts fold into roll-up buckets
                # (and drain CUSUM scores) without touching FSM state or
                # appending history lines.
                steady = (
                    [
                        self._infos[n]
                        for n in self._accel_names
                        if n not in changed_names
                    ]
                    if analytics is not None else None
                )
                self._last_predictions = checker._update_history(
                    history, evidence, analytics=analytics, args=self.args,
                    trace_id=timer.trace_id,
                    round_seq=getattr(timer, "round_seq", 0) or 0,
                    steady=steady,
                )
                history["store"].flush()
            self._last_history_rollup = checker._history_payload(
                history, [self._infos[n] for n in self._accel_names]
            )
        # NOTE: no remediation sweep here — --cordon-failed/--uncordon-
        # recovered require a probe source (cli.py), and every probe source
        # is rejected with --watch-stream, so the flags cannot reach this
        # engine.  When stream mode grows probe-report change detection,
        # the sweep belongs after the history phase, with any PATCHed node
        # fed back into changed_names.
        with timer.phase("render"):
            for name in changed_names:
                info = self._infos.get(name)
                if info is None:
                    self._entries.pop(name, None)
                else:
                    self._entries[name] = _node_entry(info)
            self._entries_list = [self._entries[n] for n in self._accel_names]
        return frozenset(changed_names)

    def _slices_incremental(self, changed: FrozenSet[str]):
        """The round's slices, rebuilding only groups a changed node
        touches (old group, new group, or both on a label move); every
        other SliceInfo — and its cached payload dict — carries over by
        reference.  Key/grouping/order semantics are detect.py's own
        (``slice_group_key``/``build_slice``/``sort_slices``), so this can
        never drift from a from-scratch ``group_slices``."""
        from tpu_node_checker_torch.detect import (
            build_slice,
            group_slices,
            slice_group_key,
            sort_slices,
        )

        if self._slice_infos is None:
            # First (seed) build: one full pass, membership derived from it.
            accel = [self._infos[n] for n in self._accel_names]
            slices = group_slices(accel)
            self._slice_infos = {}
            self._slice_members = {}
            self._node_slice_key = {}
            self._slice_dicts = {}
            for s in slices:
                key = slice_group_key(s.hosts[0])
                self._slice_infos[key] = s
                self._slice_members[key] = {h.name for h in s.hosts}
                for h in s.hosts:
                    self._node_slice_key[h.name] = key
            return slices
        affected = set()
        for name in changed:
            old_key = self._node_slice_key.pop(name, None)
            if old_key is not None:
                affected.add(old_key)
                members = self._slice_members.get(old_key)
                if members is not None:
                    members.discard(name)
            info = self._infos.get(name)
            key = slice_group_key(info) if info is not None else None
            if key is not None:
                self._node_slice_key[name] = key
                self._slice_members.setdefault(key, set()).add(name)
                affected.add(key)
        for key in affected:
            members = self._slice_members.get(key)
            if not members:
                self._slice_members.pop(key, None)
                self._slice_infos.pop(key, None)
                self._slice_dicts.pop(key, None)
                continue
            # Hosts in name order == the full build's accel order (the
            # engine's accel list is name-sorted): byte-identical payloads.
            hosts = [self._infos[n] for n in sorted(members)]
            self._slice_infos[key] = build_slice(key, hosts)
            self._slice_dicts.pop(key, None)  # re-rendered at payload time
        return sort_slices(self._slice_infos.values())

    def _slice_payload(self, slices) -> List[dict]:
        """Payload dicts for ``slices`` — cached per group, re-rendered
        only when the group was rebuilt (its cache entry was evicted)."""
        from tpu_node_checker_torch.detect import slice_group_key

        out = []
        for s in slices:
            key = slice_group_key(s.hosts[0])
            d = self._slice_dicts.get(key)
            if d is None:
                d = s.to_dict()
                self._slice_dicts[key] = d
            out.append(d)
        return out

    def _build_result(self, timer, changed: FrozenSet[str]):
        """Assemble a fresh CheckResult over the cached fleet — the
        grading itself is ``checker.grade_fleet``, the SAME ladder
        ``run_check`` applies, so the two modes cannot drift; only the
        per-node work is amortized into the caches."""
        from tpu_node_checker_torch import checker
        from tpu_node_checker_torch.detect import group_multislices

        accel = [self._infos[n] for n in self._accel_names]
        ready = [n for n in accel if n.ready and n.schedulable]
        effective_ready = [n for n in ready if n.effectively_ready]
        with timer.phase("slices"):
            slices = self._slices_incremental(changed)
            multislices = group_multislices(
                slices, getattr(self.args, "multislice_label", None) or ()
            )
        exit_code, expected_key, expected_n, have_chips = checker.grade_fleet(
            self.args, accel, effective_ready, slices
        )
        with timer.phase("payload"):
            payload = {
                "total_nodes": len(accel),
                "ready_nodes": len(effective_ready),
                "total_chips": sum(n.accelerators for n in accel),
                "ready_chips": sum(n.accelerators for n in effective_ready),
                "nodes": self._entries_list,
                "slices": self._slice_payload(slices),
            }
            if multislices:
                payload["multislices"] = [m.to_dict() for m in multislices]
            checker.stamp_expected_chips(
                payload, expected_key, expected_n, have_chips
            )
            if self._last_history_rollup is not None:
                payload["history"] = self._last_history_rollup
            if self._client is not None:
                stats = getattr(self._client, "transport_stats", lambda: {})()
                if stats:
                    payload["api_transport"] = stats
            checker.stamp_cluster_identity(payload, self.args, self._client)
            payload["watch_stream"] = self.stats.as_dict()
            payload["trace_id"] = timer.trace_id
            payload["exit_code"] = exit_code
        analytics = (
            checker._build_analytics(self.args)
            if checker._build_history(self.args) is not None else None
        )
        docs = None
        if analytics is not None:
            # Same round tail as run_check: fold this round's duration
            # samples into the "_fleet" stream, stamp the payload's
            # analytics telemetry block, then rebuild the query docs from
            # roll-ups — stream and poll rounds serve identical surfaces.
            checker._fold_round_samples(analytics, accel, timer)
            detector, seg_store = analytics["detector"], analytics["store"]
            payload["analytics"] = {
                "predictions": self._last_predictions,
                "predictions_total": detector.detections_total,
                "suspects": sorted(detector.active),
                "buckets": seg_store.bucket_counts(),
                "rollup_lines_total": seg_store.rollup_lines_total,
                "compactions_total": seg_store.compactions_total,
                "sketch_samples": dict(
                    sorted(seg_store.sketch_samples_total.items())
                ),
            }
            from tpu_node_checker_torch.analytics import build_analytics_docs

            with timer.phase("analytics-query"):
                docs = build_analytics_docs(
                    seg_store, detector=detector,
                    predictions=self._last_predictions,
                )
        payload["timings_ms"] = timer.as_dict()
        result = checker.CheckResult(
            exit_code=exit_code,
            accel=accel,
            ready=effective_ready,
            slices=slices,
            multislices=multislices,
            payload=payload,
        )
        if docs is not None:
            result.analytics_docs = docs
        return result

    def _steady_result(self, timer):
        """Zero pending changes: a fresh result object wrapping the cached
        round.  The top-level payload dict is NEW (published snapshots
        reference the old one and must never see mutation); the heavy
        sub-objects — node entries, slices — are shared by reference.  The
        transition log is emptied: an actionable transition alerts on the
        tick that observed it, never again on every silent tick after.
        """
        from tpu_node_checker_torch import checker

        last = self._last_result
        payload = dict(last.payload)
        if payload.get("history") is not None:
            payload["history"] = {**payload["history"], "transitions": []}
        payload["watch_stream"] = self.stats.as_dict()
        # The steady tick is its own round: fresh trace identity, fresh
        # timings — only the heavy sub-objects are shared by reference.
        payload["trace_id"] = timer.trace_id
        payload["timings_ms"] = timer.as_dict()
        return checker.CheckResult(
            exit_code=last.exit_code,
            accel=last.accel,
            ready=last.ready,
            slices=last.slices,
            multislices=last.multislices,
            payload=payload,
        )

    def _fold_steady_analytics(self, timer, result) -> None:
        """The steady tick's analytics leg (``--analytics``): every cached
        node's CURRENT verdict folds into the roll-up buckets as steady
        evidence — no FSM observes, no history lines, no flips possible —
        then the query documents rebuild so the served SLO view keeps
        moving while the fleet holds still.  This is the tentpole fix for
        "a steady --watch-stream fleet has no roll-ups at all": before,
        zero ticks reached the segment store; now every tick does."""
        from tpu_node_checker_torch import checker
        from tpu_node_checker_torch.analytics import build_analytics_docs

        history = checker._build_history(self.args)
        analytics = (
            checker._build_analytics(self.args) if history is not None
            else None
        )
        if analytics is None:
            return
        accel = list(result.accel or [])
        with timer.span("fsm"):
            checker._update_history(
                history, [], analytics=analytics, args=self.args,
                trace_id=timer.trace_id,
                round_seq=getattr(timer, "round_seq", 0) or 0,
                steady=accel,
            )
            history["store"].flush()
        checker._fold_round_samples(analytics, accel, timer)
        detector, seg_store = analytics["detector"], analytics["store"]
        payload = result.payload
        payload["analytics"] = {
            "predictions": [],
            "predictions_total": detector.detections_total,
            "suspects": sorted(detector.active),
            "buckets": seg_store.bucket_counts(),
            "rollup_lines_total": seg_store.rollup_lines_total,
            "compactions_total": seg_store.compactions_total,
            "sketch_samples": dict(
                sorted(seg_store.sketch_samples_total.items())
            ),
        }
        with timer.phase("analytics-query"):
            result.analytics_docs = build_analytics_docs(
                seg_store, detector=detector, predictions=[],
            )
        # Refresh timings AFTER the analytics phases so the steady round's
        # cost is honest about its new analytics leg.
        payload["timings_ms"] = timer.as_dict()
