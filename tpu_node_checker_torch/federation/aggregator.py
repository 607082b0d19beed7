"""The federation fetch tier and the ``--federate`` mode loop.

A copy of the JAX package's ``federation/aggregator.py``, held equal to it
by ``tests/test_torch_copies.py``.  :class:`FederationEngine` polls the
per-cluster fleet state APIs named in ``endpoints.json`` with conditional
GETs (an unchanged cluster costs one 304 per endpoint), or with
``--federate-feed`` consumes each upstream's ``/api/v1/watch`` feed
(:class:`_FeedClient`), shards the clusters over ``--federate-workers``
fetcher threads by consistent hash, merges them
(:mod:`~tpu_node_checker_torch.federation.merge`) and publishes
``/api/v1/global/*``; with ``--fleet-disruption-budget`` it grants the
fleet-wide disruption lease.  A failed fetch degrades only its cluster's
shard; the aggregator is not ready only while it is blind.  :func:`federate`
is the mode loop, which ends on SIGTERM with 143.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
from typing import Dict, List, Optional

from tpu_node_checker_torch.federation.endpoints import (
    EndpointsError,
    load_endpoints,
    shard_clusters,
)
from tpu_node_checker_torch.federation.merge import (
    ClusterView,
    GlobalSnapshot,
    build_global_snapshot,
    extract_entries,
)
from tpu_node_checker_torch.server.snapshot import (build_fragment, entity_tag,
                                              joined_prefix)

DEFAULT_INTERVAL_S = 10.0
DEFAULT_WORKERS = 4
# Bound on any single upstream request (dial + head + body); retries on
# top ride the per-round policy budget.
FETCH_TIMEOUT_S = 10.0
# Stream mode (--federate-feed): the long-poll window a feed consumer
# asks its upstream for — capped below the server's 30 s ceiling so the
# socket timeout (FETCH_TIMEOUT_S on top) stays the tighter bound.
FEED_WAIT_CAP_S = 25.0
# Per-cluster fetch breaker (the WatchBreaker cadence, one tier up): after
# BREAKER_THRESHOLD consecutive failures, attempts widen to every 2nd,
# 4th, then every BREAKER_MAX_EVERY'th round.  A black-holed upstream
# (connect TIMEOUT, not a refusal) costs its worker up to 2 fetch
# timeouts per attempt — without the breaker that tax lands every round
# and stalls every shard-mate behind it.
BREAKER_THRESHOLD = 3
BREAKER_MAX_EVERY = 8


class FetchError(RuntimeError):
    """One cluster fetch failed (message says which endpoint and why)."""


def _fetch_entity(session, view: ClusterView, base_headers: dict,
                  path: str, etag: Optional[str]):
    """One conditional GET → ``(response | None-for-304, new etag)``.

    A 304 validates the cached state for free; anything other than 200/304
    — including an upstream 503 "no round yet" — is this shard's failure
    for the round.
    """
    headers = dict(base_headers)
    if etag:
        headers["If-None-Match"] = etag
    resp = session.get(view.url + path, headers=headers,
                       timeout=FETCH_TIMEOUT_S)
    if resp.status_code == 304:
        view.fetch_not_modified += 1
        return None, etag
    if resp.status_code != 200:
        raise FetchError(f"{path}: HTTP {resp.status_code}")
    view.fetch_fresh += 1
    return resp, resp.headers.get("etag")


class _FeedClient:
    """Stream-mode fetcher for ONE upstream: a long-poll consumer of its
    ``GET /api/v1/watch`` feed, consumed exactly like ``watchstream.py``
    consumes k8s events — deltas are folded into a cached fragment table,
    and today's conditional GET is the relist (the engine keeps polling
    until the client has verified state, and falls back to polling the
    moment the stream dies).

    The worker thread owns the HTTP loop; the engine's fetcher thread
    reads verified state through :meth:`apply_to` each round.  Everything
    shared crosses ``self._lock``.  Every applied frame is verified by
    reconstructing the full collection body from the fragment table and
    checking its sha256 against the frame's ``to`` cursor — a mismatch
    clears the cursor so the next poll resyncs (self-healing, no torn
    state can ever reach the merge).
    """

    def __init__(self, view: ClusterView, token: Optional[str],
                 poll_timeout: float):
        self.name = view.name
        self.url = view.url
        self._headers = {"Authorization": f"Bearer {token}"} if token else {}
        self._poll_timeout = poll_timeout
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._exit_reason: Optional[str] = None
        self._cursor = ""
        # Last feed revision a frame stamped; -1 (never matches a real
        # rev) until the first frame lands, so a stream that opens AFTER a
        # blocks-only publish gets an immediate catch-up heartbeat instead
        # of parking a full window behind the update it never saw.
        self._rev_seen = -1
        self._key = view.entries_key
        self._fragments: Optional[Dict[str, bytes]] = None
        self._head: Optional[dict] = None
        self._blocks: dict = {}
        # Latest VERIFIED state: (etag, head, key, entries_run, count,
        # round, reported_cluster) — swapped whole, read by apply_to().
        self._state: Optional[tuple] = None
        self._frames = {"delta": 0, "resync": 0, "heartbeat": 0}
        self._resyncs: Dict[str, int] = {}
        self._last_frame_wall: Optional[float] = None
        self._seed_from_view(view)
        from tpu_node_checker_torch.cluster import _StdlibSession

        self._session = _StdlibSession()
        self.thread = threading.Thread(
            target=self._run, name=f"tnc-feed-{view.name}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        # No join: a parked long-poll drains within its window; the thread
        # is a daemon and touches only its own state after this.
        self._stop.set()

    def exit_reason(self) -> Optional[str]:
        with self._lock:
            return self._exit_reason

    def stats(self) -> tuple:
        """→ (frames-by-kind, resyncs-by-reason, last-frame-walltime)."""
        with self._lock:
            return dict(self._frames), dict(self._resyncs), \
                self._last_frame_wall

    # -- seeding ---------------------------------------------------------------

    def _seed_from_view(self, view: ClusterView) -> None:
        """Resume from the last applied state: if the view already holds a
        verified entries run (a restart after polling, or a predecessor
        client's work), rebuild the fragment table from it and open the
        stream AT that cursor — the upstream answers a delta, not a full
        resync.  Any doubt → empty cursor → one resync frame."""
        import json

        head = view.nodes_head
        if not view.nodes_etag or view.nodes_entries is None \
                or not isinstance(head, dict):
            return
        try:
            entries = json.loads(b"[" + view.nodes_entries + b"]")
        except ValueError:
            return
        name_key = "cluster" if view.entries_key == "clusters" else "name"
        table: Dict[str, bytes] = {}
        for entry in entries:
            nm = entry.get(name_key) if isinstance(entry, dict) else None
            if not isinstance(nm, str) or nm in table:
                return
            table[nm] = build_fragment(entry)
        prefix = joined_prefix(head, view.entries_key)
        body = prefix + b", ".join(table.values()) + b"]}\n"
        digest = entity_tag(body)
        if digest != view.nodes_etag:
            # Poll-side bytes don't round-trip (foreign producer): start
            # from scratch rather than fold deltas onto a wrong base.
            return
        with self._lock:
            self._cursor = view.nodes_etag
            self._key = view.entries_key
            self._fragments = table
            self._head = head
            self._blocks = dict(view.feed_blocks or {})
            # The view's poll-fetched state just digest-verified against
            # the cursor: install it as this client's first verified
            # state, so the engine stops polling immediately and the
            # stream opens PARKED at the cursor (a restart resumes from
            # the last applied delta — no resync frame, no re-fetch).
            self._state = (
                view.nodes_etag, head, view.entries_key,
                view.nodes_entries, view.nodes_count, view.nodes_round,
                view.reported_cluster,
            )

    # -- the stream loop -------------------------------------------------------

    def _run(self) -> None:
        import urllib.parse

        try:
            while not self._stop.is_set():
                with self._lock:
                    cursor = self._cursor
                    rev_seen = self._rev_seen
                query = urllib.parse.urlencode(
                    {"since": cursor, "timeout": f"{self._poll_timeout:g}",
                     "rev": str(rev_seen)}
                )
                resp = self._session.get(
                    f"{self.url}/api/v1/watch?{query}",
                    headers=dict(self._headers),
                    # The read must outlive a full long-poll window.
                    timeout=FETCH_TIMEOUT_S + self._poll_timeout,
                )
                if resp.status_code == 404:
                    # Feed-less upstream (older build, feed disabled):
                    # permanent fallback to conditional-GET polling.
                    self._exit("unsupported")
                    return
                if resp.status_code != 200:
                    self._exit(f"HTTP {resp.status_code}")
                    return
                frame = resp.json()
                if not isinstance(frame, dict) or "kind" not in frame:
                    raise FetchError("watch: response is not a feed frame")
                self._apply(frame)
        except Exception as exc:  # tnc: allow-broad-except(any stream failure — socket loss, long-poll timeout, torn frame — is the ONE feed-degraded outcome; the engine falls back to conditional-GET polling and restarts the stream)
            self._exit(f"{type(exc).__name__}: {exc}")
        finally:
            self._session.close()

    def _exit(self, reason: str) -> None:
        with self._lock:
            if self._exit_reason is None:
                self._exit_reason = reason

    def _apply(self, frame: dict) -> None:
        kind = frame.get("kind")
        if kind not in ("delta", "resync", "heartbeat"):
            raise FetchError(f"watch: unknown frame kind {kind!r}")
        to = frame.get("to")
        blocks = frame.get("blocks")
        # Counters bump only once a frame is fully APPLIED (state
        # installed) — they are the "this much is visible" signal the
        # metrics and tests read, not a receipt log.
        with self._lock:
            self._last_frame_wall = time.time()
            reason = frame.get("reason")
            if kind == "resync" and isinstance(reason, str):
                self._resyncs[reason] = self._resyncs.get(reason, 0) + 1
            if isinstance(blocks, dict):
                self._blocks = blocks
            rev = frame.get("rev")
            if isinstance(rev, int) and not isinstance(rev, bool):
                self._rev_seen = rev
        if kind == "heartbeat":
            with self._lock:
                self._frames["heartbeat"] += 1
            return
        key = frame.get("key") or self._key
        name_key = frame.get("name_key") or (
            "cluster" if key == "clusters" else "name"
        )
        head = frame.get("head")
        if not isinstance(head, dict) or not isinstance(to, str):
            raise FetchError("watch: frame lacks head/to")
        if kind == "resync":
            table = {}
        else:
            with self._lock:
                base = self._fragments
                cursor = self._cursor
            if base is None or (frame.get("from") or "") != cursor:
                # A delta we have no base for (should not happen — the
                # server resyncs unknown cursors): drop the cursor and let
                # the next poll resync rather than fold onto a wrong base.
                with self._lock:
                    self._cursor = ""
                return
            table = dict(base)
            for nm in frame.get("removed") or ():
                table.pop(nm, None)
        for entry in frame.get(key) or ():
            nm = entry.get(name_key) if isinstance(entry, dict) else None
            if not isinstance(nm, str):
                raise FetchError(f"watch: entry lacks a {name_key!r} name")
            # Replace-in-place keeps body order for known names; brand-new
            # names append — if the upstream ordered them elsewhere, the
            # digest check below catches it and forces a resync.
            table[nm] = build_fragment(entry)
        prefix = joined_prefix(head, key)
        body = prefix + b", ".join(table.values()) + b"]}\n"
        digest = entity_tag(body)
        if digest != to:
            with self._lock:
                self._cursor = ""
                self._resyncs["digest-mismatch"] = (
                    self._resyncs.get("digest-mismatch", 0) + 1
                )
            return
        count = head.get("count")
        reported = head.get("cluster")
        state = (
            to, head, key, body[len(prefix):-3],
            count if isinstance(count, int) else 0,
            head.get("round"),
            reported if isinstance(reported, str) else None,
        )
        with self._lock:
            self._cursor = to
            self._key = key
            self._fragments = table
            self._head = head
            self._state = state
            self._frames[kind] += 1

    # -- the engine-side drain -------------------------------------------------

    def apply_to(self, view: ClusterView) -> bool:
        """Install the latest verified stream state into the view (False =
        nothing verified yet: the engine polls this round too).  The bytes
        installed are EXACTLY what a conditional GET would have fetched —
        digest-checked against the collection ETag — so the merge cannot
        tell stream mode from poll mode."""
        with self._lock:
            state = self._state
            blocks = self._blocks
        if state is None:
            return False
        etag, head, key, entries, count, rnd, reported = state
        view.nodes_entries = entries
        view.nodes_etag = etag
        view.nodes_fp = etag
        view.nodes_head = head
        view.entries_key = key
        if key == "clusters":
            # The feed outed this upstream as an aggregator — the poll
            # fallback must use its /global surface too.
            view.tier = "aggregator"
        view.nodes_count = count
        view.nodes_round = rnd
        view.reported_cluster = reported
        summary = blocks.get("summary")
        if isinstance(summary, dict):
            view.summary_doc = summary
        slo = blocks.get("analytics_slo")
        # Sketch blocks propagate at delta speed: the upstream's slo doc
        # rides the same frame as its node delta, so the global analytics
        # view moves without waiting for a poll round.  ``blocks`` is the
        # upstream's COMPLETE current block set — absence means it
        # stopped serving analytics, and the view must drop out of the
        # global doc rather than freeze in it.
        view.set_analytics(slo if isinstance(slo, dict) else None)
        view.feed_blocks = blocks or None
        view.record_success()
        return True


class FederationEngine:
    """Owns the cluster views, the fetcher sessions, and the merge.

    ``round()`` runs on the mode loop's thread; fetcher threads live only
    within a round (each writes ONLY its shard's views, joined before the
    merge reads anything).  ``readiness()`` is called from request
    threads and reads one atomically-swapped tuple — never the live views.
    """

    def __init__(self, args, obs=None):
        self.args = args
        self.path = args.federate
        self.interval = getattr(args, "federate_interval", None) or DEFAULT_INTERVAL_S
        self.workers = getattr(args, "federate_workers", None) or DEFAULT_WORKERS
        # Observability (obs.Observability): per-round merge traces with
        # per-cluster fetch spans, the federation fetch-duration histogram,
        # and shard-transition events.  None (unit tests) still traces each
        # round on a private tracer — nothing is recorded beyond it.
        self._obs = obs
        # Without an Observability, transitions still emit the same JSON
        # event lines to stderr (pod logs stay the primary surface).
        from tpu_node_checker_torch.obs.events import EventLog

        self._events = obs.events if obs is not None else EventLog()
        # Federated disruption budgets (--fleet-disruption-budget): the
        # aggregator owns ONE fleet-wide actuation window; per-cluster
        # checkers borrow against it through the lease endpoint.  None =
        # endpoint answers 404 and checkers use their local budgets.
        self.lease_budget = None
        raw = getattr(args, "fleet_disruption_budget", None)
        if raw:
            from tpu_node_checker_torch.remediation.budget import (
                FleetLeaseBudget,
                parse_disruption_budget,
            )

            count, window = parse_disruption_budget(raw)
            self.lease_budget = FleetLeaseBudget(
                count, window, events=self._events
            )
        self.last_tracer = None
        self.seq = 0
        self.views: Dict[str, ClusterView] = {}
        self._tokens: Dict[str, Optional[str]] = {}
        self._sessions: Dict[int, object] = {}
        self._prev: Optional[GlobalSnapshot] = None
        # (ok, reason, detail) swapped whole per round — the /readyz seam.
        self._ready: Optional[tuple] = None
        self.last_round_ms = 0.0
        # Stream mode (--federate-feed): one _FeedClient per upstream that
        # serves /api/v1/watch.  The dict is touched only by the fetcher
        # thread that OWNS the cluster's shard (and by close/_apply_
        # endpoints between rounds) — same ownership rule as the views.
        self.feed_mode = bool(getattr(args, "federate_feed", False))
        self._feeds: Dict[str, _FeedClient] = {}
        # Upstreams whose watch endpoint answered 404 (feed-less builds):
        # silently degraded to conditional-GET polling, re-probed only
        # when the endpoint moves.
        self._feed_unsupported: set = set()
        # Startup is fail-fast: a malformed endpoints file is a config
        # error the operator must see now, not a silently empty fleet.
        from tpu_node_checker_torch.history.store import file_signature

        self._signature = file_signature
        self._sig = file_signature(self.path)
        self._apply_endpoints(load_endpoints(self.path))

    # -- endpoints lifecycle ---------------------------------------------------

    def _apply_endpoints(self, endpoints) -> None:
        fresh: Dict[str, ClusterView] = {}
        for ep in endpoints:
            view = self.views.get(ep.name)
            if view is None or view.url != ep.url:
                # New cluster — or a moved URL, whose cached ETags/bytes
                # describe the OLD endpoint and must not validate the new.
                view = ClusterView(ep.name, ep.url)
                # Any stream consumer follows the OLD socket: drop it and
                # re-probe feed support at the new address.
                old = self._feeds.pop(ep.name, None)
                if old is not None:
                    old.stop()
                self._feed_unsupported.discard(ep.name)
            fresh[ep.name] = view
            self._tokens[ep.name] = ep.token
        for name in set(self._tokens) - set(fresh):
            self._tokens.pop(name, None)
            old = self._feeds.pop(name, None)
            if old is not None:
                old.stop()
            self._feed_unsupported.discard(name)
        self.views = fresh

    def _maybe_reload(self) -> None:
        """Between rounds: pick up an endpoints-file rewrite (ConfigMap
        rollout).  A malformed rewrite keeps the LAST GOOD cluster set —
        a fat-fingered edit must degrade nothing."""
        sig = self._signature(self.path)
        if sig == self._sig:
            return
        self._sig = sig  # never re-parse the same bad file every round
        try:
            endpoints = load_endpoints(self.path)
        except (OSError, EndpointsError) as exc:
            print(
                f"federation: endpoints reload failed — keeping the current "
                f"{len(self.views)} cluster(s): {exc}",
                file=sys.stderr,
            )
            return
        before = set(self.views)
        self._apply_endpoints(endpoints)
        after = set(self.views)
        for name in sorted(after - before):
            print(f"federation: cluster {name!r} joined the fleet view.",
                  file=sys.stderr)
        for name in sorted(before - after):
            print(
                f"federation: cluster {name!r} left the endpoints file — "
                "dropped from the fleet view.",
                file=sys.stderr,
            )

    # -- the fetch tier --------------------------------------------------------

    def _session(self, slot: int):
        session = self._sessions.get(slot)
        if session is None:
            from tpu_node_checker_torch.cluster import _StdlibSession

            session = _StdlibSession()
            self._sessions[slot] = session
        return session

    def _fetch_cluster(self, session, view: ClusterView,
                       tracer=None) -> None:
        if tracer is None:
            # Driven outside a round (tests): the fetch still spans itself
            # on a private tracer nothing records beyond.
            from tpu_node_checker_torch.obs.trace import Tracer

            tracer = Tracer()
        base_headers = {}
        token = self._tokens.get(view.name)
        if token:
            base_headers["Authorization"] = f"Bearer {token}"
        t0 = time.monotonic()
        try:
            with tracer.span("fetch", cluster=view.name):
                try:
                    self._fetch_view(session, view, base_headers)
                except FetchError as exc:
                    if view.tier is None and str(exc).startswith(
                            "/api/v1/summary: HTTP 404"):
                        # Tier discovery: an upstream without the per-
                        # cluster surface but reachable is itself an
                        # aggregator — retry one tier up, at its /global
                        # endpoints.  The pin survives on success only.
                        view.tier = "aggregator"
                        try:
                            self._fetch_view(session, view, base_headers)
                        except Exception:
                            view.tier = None
                            raise
                    else:
                        raise
        except Exception as exc:  # tnc: allow-broad-except(any fetch failure — refused dial, timeout, bad body, HTTP error — is the ONE shard-degraded outcome; the shard is labeled stale and the fleet keeps serving)
            view.record_failure(f"{type(exc).__name__}: {exc}")
            view.fetch_errors += 1
            if view.consecutive_failures >= BREAKER_THRESHOLD:
                view.backoff_skip = min(
                    2 ** (view.consecutive_failures - BREAKER_THRESHOLD + 1),
                    BREAKER_MAX_EVERY,
                ) - 1
            if self._obs is not None:
                self._obs.federation_fetch.record(
                    (time.monotonic() - t0) * 1e3, view.name
                )
            return
        view.record_success()
        if self._obs is not None:
            # Per-cluster fetch latency histogram — 304 rounds included;
            # they ARE the steady state the p99 should describe.
            self._obs.federation_fetch.record(
                (time.monotonic() - t0) * 1e3, view.name
            )

    def _fetch_view(self, session, view: ClusterView,
                    base_headers: dict) -> None:
        """The three conditional GETs against this upstream's tier
        surface: the per-cluster paths for a checker, ``/api/v1/global/*``
        when the upstream has been discovered to be an aggregator itself.
        Summary and nodes are mandatory (their failure degrades the
        shard); the analytics SLO doc is optional — a 404 just means the
        upstream runs without ``--analytics`` and drops out of the global
        analytics view."""
        base = ("/api/v1/global" if view.tier == "aggregator"
                else "/api/v1")
        fresh_before = view.fetch_fresh
        resp, etag = _fetch_entity(
            session, view, base_headers, base + "/summary",
            view.summary_etag,
        )
        if resp is not None:
            doc = resp.json()
            if not isinstance(doc, dict):
                raise FetchError(base + "/summary: not a JSON object")
            view.summary_doc = doc
        # The ETag lands only AFTER the body validated: a mangled
        # 200 must not leave the view holding the NEW validator
        # with the OLD data — the next round's 304 would launder
        # stale state as fresh indefinitely.
        view.summary_etag = etag
        resp, etag = _fetch_entity(
            session, view, base_headers, base + "/nodes",
            view.nodes_etag,
        )
        if resp is not None:
            entries, head, key = extract_entries(resp.content)
            view.nodes_entries = entries
            # What the entries ARE ("nodes" from a checker, "clusters"
            # from an aggregator) — the block head splices it back in.
            view.entries_key = key
            view.nodes_head = head
            if key == "clusters":
                view.tier = "aggregator"
            # Merge-cache identity for these bytes.  An upstream
            # behind a validator-stripping proxy sends no ETag —
            # every round is a fresh 200, and without a content key
            # the merge would keep serving its first-cached block
            # forever.
            view.nodes_fp = etag or (
                "sha256:" + hashlib.sha256(entries).hexdigest()
            )
            count = head.get("count")
            view.nodes_count = count if isinstance(count, int) else 0
            view.nodes_round = head.get("round")
            reported = head.get("cluster")
            view.reported_cluster = (
                reported if isinstance(reported, str) else None
            )
            self._stitch_upstream_trace(
                session, view, base_headers, resp
            )
        view.nodes_etag = etag
        if not view.analytics_unsupported or view.fetch_fresh != fresh_before:
            # 404-negative-cached: an upstream that answered "no
            # analytics" is not re-asked on steady (all-304) rounds —
            # only when a mandatory surface served fresh content, i.e.
            # the upstream observably changed (restart, new round shape).
            self._fetch_analytics(session, view, base_headers)

    def _fetch_analytics(self, session, view: ClusterView,
                         base_headers: dict) -> None:
        """The optional analytics leg: a checker serves its slo doc at
        ``/api/v1/analytics/slo``; a lower aggregator re-exports its
        MERGED doc at ``/api/v1/global/analytics`` (same entry shape, so
        tier stacking merges uniformly).  Conditional on the view's
        analytics fingerprint; 404 clears the doc without failing the
        shard; any other error is a real fetch failure like the mandatory
        legs (a flapping analytics endpoint must not be silently stale).
        """
        path = (
            "/api/v1/global/analytics" if view.tier == "aggregator"
            else "/api/v1/analytics/slo"
        )
        headers = dict(base_headers)
        if view.analytics_fp:
            headers["If-None-Match"] = view.analytics_fp
        resp = session.get(view.url + path, headers=headers,
                           timeout=FETCH_TIMEOUT_S)
        if resp.status_code == 304:
            view.fetch_not_modified += 1
            return
        if resp.status_code == 404:
            view.analytics_unsupported = True
            view.set_analytics(None)
            return
        if resp.status_code != 200:
            raise FetchError(f"{path}: HTTP {resp.status_code}")
        doc = resp.json()
        if not isinstance(doc, dict):
            raise FetchError(path + ": not a JSON object")
        view.analytics_unsupported = False
        view.fetch_fresh += 1
        view.set_analytics(doc, fp=resp.headers.get("etag"))

    def _stitch_upstream_trace(self, session, view: ClusterView,
                               base_headers: dict, resp) -> None:
        """Two-tier tracing: the nodes response named its round's trace
        (``X-TNC-Trace``); fetch that trace's Chrome-trace document from
        the upstream's debug ring ONCE per new upstream round, so the
        aggregator's own round trace can attach the upstream spans.
        Best-effort by design — an upstream without a debug ring (older
        build, ring already evicted) costs one 404 and stitches nothing.
        """
        upstream_trace = resp.headers.get("x-tnc-trace")
        if not upstream_trace or upstream_trace == view.upstream_trace:
            return
        try:
            doc_resp = session.get(
                view.url + f"/api/v1/debug/rounds/{upstream_trace}",
                headers=dict(base_headers), timeout=FETCH_TIMEOUT_S,
            )
            if doc_resp.status_code != 200:
                return
            doc = doc_resp.json()
            events = doc.get("traceEvents") if isinstance(doc, dict) else None
            if isinstance(events, list):
                view.upstream_trace = upstream_trace
                view.upstream_trace_events = events
        except Exception:  # tnc: allow-broad-except(trace stitching is best-effort telemetry; a failed debug fetch must never degrade the shard that just fetched fine)
            return

    # tnc: allow-exception-escape(every concrete fetch failure is caught inside _fetch_cluster's catch-all and recorded on the cluster view (record_failure + breaker); the residual escape set is dispatch widening on in-process stats/view record() calls that do not raise)
    def _fetch_shard(self, slot: int, names: List[str], tracer) -> None:
        session = self._session(slot)
        for name in names:
            view = self.views.get(name)
            if view is None:
                continue
            if self.feed_mode and self._feed_tick(view):
                # A live stream with verified state fed this cluster: no
                # dial at all this round — O(changed nodes), not O(nodes).
                continue
            if view.backoff_skip > 0:
                # Breaker open: no dial this round.  Staleness still
                # advances — the skipped shard stays honestly labeled.
                view.backoff_skip -= 1
                view.rounds_behind += 1
                continue
            self._fetch_cluster(session, view, tracer)
            if (self.feed_mode
                    and view.consecutive_failures == 0
                    and name not in self._feeds
                    and name not in self._feed_unsupported):
                # The upstream polls fine: (re)open its stream.  Until the
                # stream verifies its first frame, polling continues — the
                # relist IS today's conditional GET.
                self._feed_start(view)

    def _feed_tick(self, view: ClusterView) -> bool:
        """Stream-mode step for one cluster; True = this round's state came
        off the feed and the poll is skipped.  A dead stream is consumed
        exactly once (404 → permanent silent poll fallback; anything else →
        poll now, reopen the stream once polling succeeds) — the per-
        cluster fetch breaker and staleness labels stay untouched."""
        client = self._feeds.get(view.name)
        if client is None:
            return False
        if client.thread.is_alive():
            # Alive but not yet verified → poll this round too (warm-up).
            return client.apply_to(view)
        self._feeds.pop(view.name, None)
        reason = client.exit_reason()
        client.stop()
        if reason == "unsupported":
            self._feed_unsupported.add(view.name)
        else:
            self._events.emit(
                "feed-lost",
                cluster=view.name,
                error=reason or "stream ended",
                detail="falling back to conditional-GET polling",
            )
        return False

    def _feed_start(self, view: ClusterView) -> None:
        poll_timeout = min(max(self.interval, 1.0), FEED_WAIT_CAP_S)
        client = _FeedClient(
            view, self._tokens.get(view.name), poll_timeout
        )
        self._feeds[view.name] = client
        client.start()

    # -- the round -------------------------------------------------------------

    def round(self, server=None) -> GlobalSnapshot:
        """One federation round: reload → fetch (sharded) → merge → publish.

        Returns the merged snapshot (also swapped into ``server`` when one
        is wired).  Per-cluster failures never raise out of here — they
        mark shards; only a bug in the merge itself would, and the mode
        loop reports it and keeps the last snapshot serving.
        """
        from tpu_node_checker_torch.obs.trace import Tracer

        t0 = time.monotonic()
        self.seq += 1
        if self.lease_budget is not None:
            # Window-less fleet budgets are per merge round.
            self.lease_budget.reset_round()
        # One trace per merge round: per-cluster fetch spans (on the
        # fetcher threads, args carry the cluster), then merge and publish
        # on the round thread, then each upstream round's own spans
        # stitched in as separate process tracks — ONE document that spans
        # both tiers.
        tracer = (
            self._obs.tracer(self.seq, mode="federation")
            if self._obs is not None
            else Tracer(round_seq=self.seq, mode="federation")
        )
        self.last_tracer = tracer
        try:
            return self._round_inner(tracer, server, t0)
        except Exception as exc:
            # A failed merge round still completes its trace — labeled —
            # so the debug ring shows WHAT blew up, not a missing round.
            tracer.set_error(str(exc))
            raise
        finally:
            if self._obs is not None:
                self._obs.complete(tracer)
            else:
                tracer.finish()

    def _round_inner(self, tracer, server, t0: float) -> GlobalSnapshot:
        from tpu_node_checker_torch import checker

        self._maybe_reload()
        # Captured BEFORE the fetches run — record_failure/record_success
        # move view.stale, and the transition log diffs against the state
        # the operator last saw.  A never-attempted view (fresh start, new
        # cluster) is stale but has no fetch history: excluding it means a
        # first round that succeeds logs nothing and one that fails logs
        # DEGRADED — not "recovered" for shards that were never lost.
        before_degraded = {
            name for name, view in self.views.items()
            if view.stale and view.fetch_errors > 0
        }
        names = sorted(self.views)
        shards = shard_clusters(names, self.workers)
        threads = []
        for slot, shard in sorted(shards.items()):
            # Fresh retry policy (and budget) per worker per round — the
            # same graded ladder every API call in this codebase rides.
            self._session(slot).retry_policy = checker._build_retry_policy(
                self.args
            )
            thread = threading.Thread(
                target=self._fetch_shard,
                args=(slot, shard, tracer),
                name=f"tnc-federate-{slot}",
                daemon=True,
            )
            threads.append(thread)
            thread.start()
        for thread in threads:
            thread.join()
        views = list(self.views.values())
        with tracer.span("merge", clusters=len(views)):
            snap = build_global_snapshot(
                views, self.seq, round(time.time(), 3), prev=self._prev,
                trace_id=tracer.trace_id,
            )
        for view in views:
            if view.upstream_trace_events is not None:
                tracer.attach_subtrace(
                    f"cluster:{view.name}",
                    view.upstream_trace_events,
                    trace_id=view.upstream_trace,
                )
        self._prev = snap
        self._ready = self._compute_readiness(views)
        if server is not None:
            with tracer.span("publish"):
                server.publish_global(
                    snap, metrics_body=self.render_metrics().encode("utf-8")
                )
        self.last_round_ms = (time.monotonic() - t0) * 1e3
        self._log_transitions(before_degraded, tracer.trace_id)
        return snap

    def _log_transitions(self, before_degraded: set,
                         trace_id: Optional[str] = None) -> None:
        """Shard degraded/recovered transitions → the unified event log,
        stamped with the merge round's trace_id (without an Observability
        the EventLog still prints the same JSON line to stderr)."""
        after = {name for name, view in self.views.items() if view.stale}
        events = self._events
        for name in sorted(after - before_degraded):
            view = self.views[name]
            events.emit(
                "shard-degraded",
                trace_id=trace_id,
                shard=name,
                error=view.last_error,
                detail="last-known data keeps serving, staleness labeled",
            )
        for name in sorted(before_degraded - after):
            events.emit("shard-recovered", trace_id=trace_id, shard=name)

    def _compute_readiness(self, views: List[ClusterView]) -> tuple:
        detail = {
            "clusters": {
                v.name: {
                    "reachable": v.consecutive_failures == 0,
                    "consecutive_failures": v.consecutive_failures,
                    "staleness_rounds": v.rounds_behind,
                    **({"breaker_backoff_rounds": v.backoff_skip}
                       if v.backoff_skip else {}),
                    **({"error": v.last_error} if v.last_error else {}),
                }
                for v in views
            }
        }
        if not views:
            return False, "endpoints file registers no clusters", detail
        if not any(v.has_data for v in views):
            return False, "no cluster has been fetched successfully yet", detail
        if all(v.stale for v in views):
            # Blind, not just partially degraded: stale data keeps serving
            # (labeled) but must stop gating schedulers.
            return False, "every cluster shard is degraded", detail
        return True, "ok", detail

    def readiness(self) -> tuple:
        """The server's /readyz seam → ``(ok, reason, detail)``; reads one
        atomically-swapped tuple, never the live views."""
        ready = self._ready
        if ready is None:
            return False, "no federation round completed yet", {}
        return ready

    # -- metrics ---------------------------------------------------------------

    def render_metrics(self) -> str:
        """The aggregator's scrape body — federation families only (no
        check rounds run here)."""
        from tpu_node_checker_torch.metrics import _line

        views = sorted(self.views.values(), key=lambda v: v.name)
        lines = [
            "# HELP tpu_node_checker_federation_clusters Clusters in the "
            "federation view, by fetch state (degraded = unreachable or "
            "stale shard).",
            "# TYPE tpu_node_checker_federation_clusters gauge",
        ]
        counts = {
            "configured": len(views),
            "with_data": sum(1 for v in views if v.has_data),
            "fresh": sum(1 for v in views if not v.stale),
            "degraded": sum(1 for v in views if v.stale),
        }
        lines += [
            _line("tpu_node_checker_federation_clusters", float(n),
                  {"state": state})
            for state, n in sorted(counts.items())
        ]
        lines += [
            "# HELP tpu_node_checker_federation_cluster_up 1 while the "
            "cluster's last fetch round succeeded.",
            "# TYPE tpu_node_checker_federation_cluster_up gauge",
        ]
        lines += [
            _line("tpu_node_checker_federation_cluster_up",
                  0.0 if v.stale else 1.0, {"cluster": v.name})
            for v in views
        ]
        lines += [
            "# HELP tpu_node_checker_federation_staleness_rounds Federation "
            "rounds since the cluster was last fetched successfully "
            "(0 = fresh).",
            "# TYPE tpu_node_checker_federation_staleness_rounds gauge",
        ]
        lines += [
            _line("tpu_node_checker_federation_staleness_rounds",
                  float(v.rounds_behind), {"cluster": v.name})
            for v in views
        ]
        lines += [
            "# HELP tpu_node_checker_federation_fetch_total Upstream fleet-"
            "API fetches by cluster and result (fresh = 200, not_modified "
            "= 304, error = failed round).",
            "# TYPE tpu_node_checker_federation_fetch_total counter",
        ]
        for v in views:
            for result, n in (("fresh", v.fetch_fresh),
                              ("not_modified", v.fetch_not_modified),
                              ("error", v.fetch_errors)):
                lines.append(
                    _line("tpu_node_checker_federation_fetch_total", float(n),
                          {"cluster": v.name, "result": result})
                )
        if self.feed_mode:
            # Stream-mode telemetry: per-client counters reset when a
            # stream reopens — that's a normal Prometheus counter reset,
            # rate() absorbs it.
            now = time.time()
            lines += [
                "# HELP tpu_node_checker_federation_feed_frames_total Watch-"
                "feed frames applied per upstream, by kind (delta / resync "
                "/ heartbeat).",
                "# TYPE tpu_node_checker_federation_feed_frames_total "
                "counter",
            ]
            stats = {
                name: client.stats()
                for name, client in sorted(self._feeds.items())
            }
            for name, (frames, _, _) in stats.items():
                for kind in ("delta", "heartbeat", "resync"):
                    lines.append(_line(
                        "tpu_node_checker_federation_feed_frames_total",
                        float(frames.get(kind, 0)),
                        {"cluster": name, "kind": kind},
                    ))
            lines += [
                "# HELP tpu_node_checker_federation_feed_resyncs_total Full-"
                "resync frames per upstream, by reason (requested = cold "
                "start, stale-cursor = evicted from the upstream's ring, "
                "digest-mismatch = client-side reconstruction failed).",
                "# TYPE tpu_node_checker_federation_feed_resyncs_total "
                "counter",
            ]
            for name, (_, resyncs, _) in stats.items():
                for reason, n in sorted(resyncs.items()):
                    lines.append(_line(
                        "tpu_node_checker_federation_feed_resyncs_total",
                        float(n), {"cluster": name, "reason": reason},
                    ))
            lines += [
                "# HELP tpu_node_checker_federation_feed_lag_seconds Seconds "
                "since the last frame arrived on the upstream's stream "
                "(heartbeats bound this at the long-poll window).",
                "# TYPE tpu_node_checker_federation_feed_lag_seconds gauge",
            ]
            for name, (_, _, last_wall) in stats.items():
                if last_wall is not None:
                    lines.append(_line(
                        "tpu_node_checker_federation_feed_lag_seconds",
                        round(max(0.0, now - last_wall), 3),
                        {"cluster": name},
                    ))
        with_data = [v for v in views if v.has_data]
        lines += [
            "# HELP tpu_node_checker_federation_nodes Nodes in the merged "
            "global view, by state (summed over clusters' last-known "
            "summaries, stale shards included).",
            "# TYPE tpu_node_checker_federation_nodes gauge",
            _line("tpu_node_checker_federation_nodes",
                  float(sum(v.summary_doc.get("total_nodes") or 0
                            for v in with_data)),
                  {"state": "total"}),
            _line("tpu_node_checker_federation_nodes",
                  float(sum(v.summary_doc.get("ready_nodes") or 0
                            for v in with_data)),
                  {"state": "ready"}),
            "# HELP tpu_node_checker_federation_round_duration_ms Wall-clock "
            "of the last fetch+merge round.",
            "# TYPE tpu_node_checker_federation_round_duration_ms gauge",
            _line("tpu_node_checker_federation_round_duration_ms",
                  round(self.last_round_ms, 3)),
            "# HELP tpu_node_checker_federation_workers Fetcher threads the "
            "cluster set is consistent-hash sharded across.",
            "# TYPE tpu_node_checker_federation_workers gauge",
            _line("tpu_node_checker_federation_workers", float(self.workers)),
            "# HELP tpu_node_checker_last_run_timestamp_seconds Unix time "
            "of the last completed federation round (staleness detector).",
            "# TYPE tpu_node_checker_last_run_timestamp_seconds gauge",
            _line("tpu_node_checker_last_run_timestamp_seconds", time.time()),
        ]
        snap = self._prev
        analytics = getattr(snap, "analytics_doc", None) if snap else None
        if analytics is not None:
            lines += [
                "# HELP tpu_node_checker_analytics_global_clusters Clusters "
                "contributing a mergeable SLO sketch block to the global "
                "analytics view.",
                "# TYPE tpu_node_checker_analytics_global_clusters gauge",
                _line("tpu_node_checker_analytics_global_clusters",
                      float(len(analytics.get("clusters") or {}))),
                "# HELP tpu_node_checker_analytics_global_slo Fleet-wide "
                "SLO percentiles from merged sketches (availability in "
                "percent, MTBF/MTTR in seconds; quantiles within the "
                "sketch error bound).",
                "# TYPE tpu_node_checker_analytics_global_slo gauge",
            ]
            fleet = analytics.get("fleet") or {}
            for metric in ("availability_pct", "mtbf_s", "mttr_s"):
                pctls = fleet.get(metric)
                if not isinstance(pctls, dict):
                    continue
                for q, value in sorted(pctls.items()):
                    if isinstance(value, (int, float)):
                        lines.append(_line(
                            "tpu_node_checker_analytics_global_slo",
                            float(value), {"metric": metric, "q": q},
                        ))
            lines += [
                "# HELP tpu_node_checker_analytics_global_merge_ms Wall-"
                "clock of the last global analytics sketch merge (0 while "
                "the merged entity is being reused unchanged).",
                "# TYPE tpu_node_checker_analytics_global_merge_ms gauge",
                _line("tpu_node_checker_analytics_global_merge_ms",
                      round(getattr(snap, "analytics_merge_ms", 0.0), 3)),
            ]
        if self.lease_budget is not None:
            lines += [
                "# HELP tpu_node_checker_federation_lease_total Disruption "
                "leases served, by result (granted counts permits, denied "
                "counts refused requests).",
                "# TYPE tpu_node_checker_federation_lease_total counter",
                _line("tpu_node_checker_federation_lease_total",
                      float(self.lease_budget.granted_total),
                      {"result": "granted"}),
                _line("tpu_node_checker_federation_lease_total",
                      float(self.lease_budget.denied_total),
                      {"result": "denied"}),
                "# HELP tpu_node_checker_federation_fleet_budget_remaining "
                "Actuation permits left in the fleet disruption budget's "
                "current window/round.",
                "# TYPE tpu_node_checker_federation_fleet_budget_remaining "
                "gauge",
                _line("tpu_node_checker_federation_fleet_budget_remaining",
                      float(self.lease_budget.remaining())),
            ]
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        for client in self._feeds.values():
            client.stop()
        self._feeds = {}
        for session in self._sessions.values():
            session.close()
        self._sessions = {}


def federate(args) -> int:
    """``tnc --federate endpoints.json --serve PORT``: the aggregator mode.

    Serves ``/api/v1/global/{summary,clusters,clusters/{name},nodes}``
    plus ``/healthz``, ``/readyz`` (per-cluster fetch detail) and
    ``/metrics`` (federation families).  Control-plane writes are refused
    (403 deny-by-default — no ``--serve-token`` here; the control seam
    behind the gate answers 503) —
    remediation evidence lives one tier down, in each cluster's own
    checker.  Runs until SIGTERM (exit 143).
    """
    from tpu_node_checker_torch import checker
    from tpu_node_checker_torch.obs import Observability
    from tpu_node_checker_torch.server.app import FleetStateServer

    # One observability bundle for the whole tier: merge-round traces in
    # the debug ring (/api/v1/debug/rounds — with each upstream cluster's
    # round stitched in), fetch/phase histograms on /metrics, shard
    # transition events through the unified log (--event-log).
    obs = Observability.from_args(args)
    engine = FederationEngine(args, obs=obs)
    server = FleetStateServer(
        args.serve,
        federation=True,
        readiness=engine.readiness,
        obs=obs,
        lease=(engine.lease_budget.grant
               if engine.lease_budget is not None else None),
        **checker._serve_pool_kwargs(args),
    )
    requested_workers = getattr(args, "serve_workers", None) or 1
    if server.workers_active != requested_workers:
        print(
            f"--serve-workers {requested_workers}: SO_REUSEPORT unavailable "
            f"on this platform — serving with {server.workers_active} "
            "listener.",
            file=sys.stderr,
        )
    print(
        f"Federation aggregator on port {server.port} "
        f"({server.workers_active} worker"
        f"{'s' if server.workers_active != 1 else ''}): "
        f"{len(engine.views)} cluster(s) from {engine.path}, "
        f"{engine.workers} fetcher(s), round every {engine.interval:g}s "
        "(/api/v1/global/{summary,clusters,nodes}).",
        file=sys.stderr,
    )
    stop = threading.Event()
    prev_handler = checker._install_stop_signal(stop)
    try:
        while True:
            round_start = time.monotonic()
            try:
                engine.round(server)
            except Exception as exc:  # tnc: allow-broad-except(a merge bug must not kill the serving tier; the last global snapshot keeps serving and the next round retries)
                # round() already labeled (set_error) and completed the
                # failed round's trace before re-raising.
                print(f"Federation round failed: {exc}", file=sys.stderr)
            if getattr(args, "trace", None) and engine.last_tracer is not None:
                # --trace in federate mode: the last merge round's two-tier
                # Chrome-trace document, rewritten atomically per round.
                checker._write_trace_file(args.trace, engine.last_tracer)
            if checker._wait_for_next_round(
                stop,
                max(0.0, engine.interval - (time.monotonic() - round_start)),
            ):
                print(
                    "SIGTERM: federation aggregator stopped cleanly.",
                    file=sys.stderr,
                )
                return 128 + 15
    finally:
        checker._restore_stop_signal(prev_handler)
        engine.close()
        server.close()
