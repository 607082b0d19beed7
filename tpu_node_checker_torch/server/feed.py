"""Push-delta watch feed for the fleet API: ``GET /api/v1/watch``.

A copy of the JAX package's ``server/feed.py``, held equal to it by
``tests/test_torch_copies.py``.  A consumer long-polls
``GET /api/v1/watch?since=<ETag>[&timeout=<s>][&rev=<n>]`` and gets one JSON
frame: ``delta`` (only the changed entries and the removed names),
``resync`` (every entry, for an empty or unknown cursor) or ``heartbeat``
(nothing moved in the window).  Frames reuse the snapshot's cached
per-entry bytes; named blocks (summary, remediation, analytics) ride every
frame.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, FrozenSet, Iterable, Optional

from tpu_node_checker_torch.server.snapshot import (
    Entity,
    build_joined_entity,
)

# How many etag→etag transitions the feed remembers: a consumer more than
# RING_SIZE publishes behind gets a resync, not an unbounded delta.
RING_SIZE = 64

# Long-poll park bounds (seconds): the default keeps one frame per ~25 s
# on a quiet fleet; the ceiling keeps a stalled consumer's handler thread
# reclaimable on the same order as the pool's idle timeout.
DEFAULT_WAIT_S = 25.0
MAX_WAIT_S = 30.0

# The frame's entry-array key → the name field inside each entry (the
# checker tier serves nodes; an aggregator serves per-cluster blocks).
NAME_KEYS = {"nodes": "name", "clusters": "cluster"}


class _Transition:
    """One publish's edge in the cursor graph: ``frm → to`` with the names
    that changed or vanished.  Folding consecutive edges reproduces the
    delta between ANY remembered cursor and the current state."""

    __slots__ = ("frm", "to", "changed", "removed")

    def __init__(self, frm: str, to: str, changed: FrozenSet[str],
                 removed: FrozenSet[str]):
        self.frm = frm
        self.to = to
        self.changed = changed
        self.removed = removed


class FeedState:
    """The server side of the watch feed: current collection state, the
    transition ring, and the long-poll rendezvous.

    Installed state is references to IMMUTABLE publish-time objects (the
    snapshot's fragment dicts, the merge tier's block caches) — frame
    assembly may read them lock-free once captured.  The cursor IS the
    collection entity's ETag, so the feed and the conditional-GET surface
    can never disagree about what "current" means.
    """

    def __init__(self, ring_size: int = RING_SIZE):
        self._cond = threading.Condition()
        self._rev = 0
        self._closed = False
        self._etag: Optional[str] = None
        self._seq = 0
        self._ts = 0.0
        self._head: Optional[dict] = None
        self._key = "nodes"
        self._fragments: Optional[Dict[str, bytes]] = None
        self._gz: Dict[str, bytes] = {}
        self._blocks: dict = {}
        self._ring: deque = deque(maxlen=ring_size)
        # Served-frame counters (by kind / by resync reason): the
        # resync-exactly-once test seam and the feed telemetry source.
        self._frames_served = {"delta": 0, "resync": 0, "heartbeat": 0}
        self._resyncs: Dict[str, int] = {}

    # -- publisher side ------------------------------------------------------

    def publish(self, etag: str, seq: int, ts: float, head: dict, key: str,
                fragments: Dict[str, bytes],
                gz_fragments: Optional[Dict[str, bytes]],
                changed: Optional[Iterable[str]],
                removed: Iterable[str],
                blocks: Optional[dict] = None) -> None:
        """Install one publish's state and wake every parked consumer.

        ``fragments`` maps entry name → exact bytes inside the collection
        body, in body order — the dict the snapshot/merge builders already
        maintain, taken by reference.  ``changed=None`` means the publisher
        could not diff (first round, undiffable predecessor): the ring is
        cleared and every behind cursor resyncs.  ``blocks`` MERGES into
        the named side-channel blocks (copy-on-write; existing names such
        as a previously published remediation budget survive a round
        publish that only carries the summary).
        """
        with self._cond:
            if self._closed:
                return
            if self._etag is not None and etag == self._etag:
                # Content-identical publish (an aggregator steady round
                # reusing the whole entity): refresh stamps and blocks,
                # wake waiters — they answer a from==to blocks-only delta.
                self._seq, self._ts = seq, ts
                self._merge_blocks(blocks)
                self._rev += 1
                self._cond.notify_all()
                return
            if changed is None or self._etag is None:
                self._ring.clear()
            else:
                self._ring.append(_Transition(
                    self._etag, etag,
                    frozenset(changed), frozenset(removed or ()),
                ))
            self._etag = etag
            self._seq, self._ts = seq, ts
            self._head, self._key = head, key
            self._fragments = fragments
            self._gz = gz_fragments or {}
            self._merge_blocks(blocks)
            self._rev += 1
            self._cond.notify_all()

    def update_blocks(self, name: str, doc: Optional[dict]) -> None:
        """Set (or clear, ``doc=None``) ONE named block between publishes
        — how remediation budgets and analytics SLO docs ride the feed at
        delta speed.  Wakes parked consumers with a blocks-only frame."""
        with self._cond:
            if self._closed:
                return
            blocks = dict(self._blocks)
            if doc is None:
                blocks.pop(name, None)
            else:
                blocks[name] = doc
            self._blocks = blocks
            self._rev += 1
            self._cond.notify_all()

    def clear(self) -> None:
        """Withdraw the feed (an undiffable publish — e.g. duplicate entry
        names make fragment state unable to reproduce the body): consumers
        get 503 until a diffable publish lands, then resync."""
        with self._cond:
            self._etag = None
            self._fragments = None
            self._ring.clear()
            self._rev += 1
            self._cond.notify_all()

    def close(self) -> None:
        """Server shutdown: wake every parked consumer; they answer one
        final heartbeat and the pool tears the sockets down."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _merge_blocks(self, blocks: Optional[dict]) -> None:
        # Caller holds self._cond.  Copy-on-write: frame() hands the dict
        # reference out of the lock, so the installed dict never mutates.
        if blocks:
            merged = dict(self._blocks)
            merged.update(blocks)
            self._blocks = merged

    # -- consumer side -------------------------------------------------------

    def stats(self):
        """→ (frames-served-by-kind, resyncs-by-reason) copies — the
        metrics render and the resync-exactly-once test read this."""
        with self._cond:
            return dict(self._frames_served), dict(self._resyncs)

    def frame(self, since: str, wait: float,
              rev: Optional[int] = None) -> Optional[Entity]:
        """One watch request → one frame Entity (None = no feed state yet:
        the handler answers the same 503 the collection endpoints do).

        Parks up to ``wait`` seconds only when ``since`` IS the current
        cursor AND the consumer's ``rev`` (when it sent one) is current;
        any other cursor answers immediately (delta when the ring still
        chains from it, full resync otherwise — never a 404).  A current
        cursor with a stale ``rev`` means the consumer missed a
        blocks-only update between polls: it answers an immediate
        entry-less heartbeat carrying the current blocks, never a park —
        blocks stay at delta speed even for a consumer that was between
        polls when the publisher fired.
        """
        kind = None
        reason = None
        changed_set: FrozenSet[str] = frozenset()
        removed_set: FrozenSet[str] = frozenset()
        with self._cond:
            stale_rev = rev is not None and rev != self._rev
            if since and self._etag is not None and since == self._etag \
                    and not self._closed and not stale_rev:
                start_rev = self._rev
                deadline = time.monotonic() + max(wait, 0.0)
                while not self._closed and self._rev == start_rev:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._rev == start_rev:
                    kind = "heartbeat"
            if self._etag is None or self._fragments is None:
                return None
            if kind is None:
                if not since:
                    kind, reason = "resync", "requested"
                elif since == self._etag:
                    # from == to, no entries: a PARKED consumer woken by a
                    # blocks-only update (or an aggregator steady publish)
                    # counts as a delta; a stale-rev consumer that polled
                    # AFTER the update skipped the park and answers an
                    # immediate heartbeat — delta/resync counters move
                    # identically whichever side of the park the update
                    # landed on.
                    kind = "heartbeat" if stale_rev else "delta"
                else:
                    fold = self._fold(since)
                    if fold is None:
                        kind, reason = "resync", "stale-cursor"
                    else:
                        changed_set, removed_set = fold
                        kind = "delta"
            self._frames_served[kind] += 1
            if reason is not None:
                self._resyncs[reason] = self._resyncs.get(reason, 0) + 1
            etag, seq, ts = self._etag, self._seq, self._ts
            head, key = self._head, self._key
            fragments, gz, blocks = self._fragments, self._gz, self._blocks
            rev_now = self._rev
        # -- frame assembly, outside the lock --------------------------------
        if kind == "resync":
            names = list(fragments)
        elif kind == "delta":
            names = [n for n in fragments if n in changed_set]
        else:
            names = []
        meta = {
            "kind": kind,
            "round": seq,
            "ts": ts,
            "from": since or None,
            "to": etag,
            "key": key,
            "name_key": NAME_KEYS.get(key, "name"),
            "head": head,
            "removed": sorted(removed_set),
            "blocks": blocks,
            "rev": rev_now,
        }
        if reason is not None:
            meta["reason"] = reason
        frags = [fragments[n] for n in names]
        # Cached gzip members by reference when the publisher kept them
        # (the first fragment is re-deflated fused with the prefix anyway);
        # otherwise one whole-body deflate beats N fragment deflates.
        gz_frags = None
        if frags and all(n in gz for n in names[1:]):
            gz_frags = [gz.get(n, b"") for n in names]
        return build_joined_entity(meta, key, frags, gz_frags)

    def _fold(self, since: str):
        # Caller holds self._cond.  Chain the remembered transitions from
        # ``since`` to the current cursor; None = evicted/unknown → resync.
        ring = list(self._ring)
        start = None
        for i, t in enumerate(ring):
            if t.frm == since:
                start = i
                break
        if start is None or ring[-1].to != self._etag:
            return None
        changed: set = set()
        removed: set = set()
        for t in ring[start:]:
            changed = (changed | t.changed) - t.removed
            removed = (removed | t.removed) - t.changed
        return frozenset(changed), frozenset(removed)
