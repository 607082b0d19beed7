"""The fleet state API server: queryable node and slice health over HTTP.

A copy of the JAX package's ``server/app.py``, held equal to it by
``tests/test_torch_copies.py``.  ``--serve PORT`` rides a ``--watch`` loop or
serves a recorded ``--history`` store or ``--log-jsonl`` log standalone.
Reads: ``/api/v1/summary``, ``/api/v1/nodes[/NAME]``, ``/api/v1/slices``,
``/api/v1/trend``, ``/api/v1/remediation``, ``/api/v1/analytics/{slo,
offenders,flaps}``, ``/api/v1/watch``, ``/api/v1/debug/rounds``,
``/healthz``, ``/readyz`` (200 once a round completed and the breaker is
closed) and ``/metrics``; each snapshot read carries ``X-TNC-Round`` and
``X-TNC-Trace``.  Writes: ``POST /api/v1/nodes/NAME/cordon|uncordon``
(``?dry_run=1``), token-gated, rate-limited and evidence-gated.  Every GET
reads one immutable snapshot; publication is one attribute swap.
"""

from __future__ import annotations

import gzip as _gzip
import json
import sys
import threading
import time
from contextlib import nullcontext as _nullcontext
from typing import Callable, Dict, Optional, Tuple

from tpu_node_checker_torch.obs.events import EventLog
from tpu_node_checker_torch.obs.hist import (
    DEFAULT_LATENCY_BUCKETS_MS,
    HistogramFamily,
)
from tpu_node_checker_torch.server.auth import check_write_auth
from tpu_node_checker_torch.server.feed import (
    DEFAULT_WAIT_S as _WATCH_DEFAULT_WAIT_S,
    MAX_WAIT_S as _WATCH_MAX_WAIT_S,
    FeedState,
)
from tpu_node_checker_torch.server.ratelimit import retry_after_header
from tpu_node_checker_torch.server.router import (
    Request,
    Response,
    Router,
    json_response,
    negotiate,
)
from tpu_node_checker_torch.server.snapshot import (
    FleetSnapshot,
    TrendCache,
    build_snapshot,
    build_snapshot_delta,
)
from tpu_node_checker_torch.server.workers import (
    DEFAULT_MAX_CONNECTIONS,
    WorkerPool,
    build_fast_routes,
)

# At most one auth-failure notification per this many seconds: a scanner
# hammering the write path must not turn Slack into the amplifier.
_AUTH_EVENT_INTERVAL_S = 60.0

# /metrics compression split: the round-family prefix is static between
# publishes — compressed ONCE per publish at the thorough level — while the
# per-scrape stats block (it moves every scrape) gets the cheapest level;
# the two gzip members concatenate into one valid stream (RFC 1952).
_METRICS_PREFIX_GZIP_LEVEL = 6
_METRICS_STATS_GZIP_LEVEL = 1

# The read endpoints hot enough to earn prebuilt wire responses in the
# worker pool's fast table (everything else rides the routed fallback).
_FAST_PATHS = ("summary", "nodes", "slices")

# The federation aggregator's hot read surface (GlobalSnapshot entity keys
# → fast-table paths); per-cluster detail rides the routed fallback.  The
# global analytics entity earns a slot because a dashboard fleet polling
# SLOs is the same ≥100k req/s read shape as nodes/summary.
_GLOBAL_FAST_PATHS = ("global/summary", "global/clusters", "global/nodes",
                      "global/analytics")

# Reusable no-op context for publish paths running without a tracer.
_NULL_SPAN = _nullcontext()


class ServerStats:
    """Thread-safe request telemetry → ``tpu_node_checker_api_server_*``.

    Labeled by route PATTERN (``/api/v1/nodes/{name}``), never by raw path,
    so series cardinality tracks the route table, not the fleet size.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[Tuple[str, str, int], int] = {}
        # Native latency histogram, per route pattern: records are
        # lock-free per-thread index increments, merged only at scrape
        # time — histogram_quantile can finally answer "what is the p99"
        # (the old hand-built _sum/_count summary could not).
        self.durations = HistogramFamily(
            "tpu_node_checker_api_server_request_duration_ms",
            "Routed-path request latency by route pattern (fast-path "
            "requests are answered from prebuilt bytes inside a batch "
            "and carry no per-request sample).",
            DEFAULT_LATENCY_BUCKETS_MS,
            label="route",
        )
        self.in_flight = 0
        self.auth_failures = 0
        self.rate_limited = 0

    def track_in_flight(self, delta: int) -> None:
        with self._lock:
            self.in_flight += delta

    def observe(self, method: str, route: str, status: int, elapsed_ms: float) -> None:
        with self._lock:
            key = (method, route, status)
            self.requests[key] = self.requests.get(key, 0) + 1
        # Outside the lock: the histogram's own record path is per-thread
        # and lock-free by design.
        self.durations.record(elapsed_ms, route)

    def merge_fast(self, counts: Dict[Tuple[str, int], int]) -> None:
        """Batched fast-path GET counts (one lock round per flush, not per
        request — the 50k req/s path cannot afford per-request locking).
        Fast-path requests carry no per-request latency sample: they are
        answered from prebuilt bytes inside a batch, so the latency summary
        covers the routed path, where the timing is real.
        """
        with self._lock:
            for (route, status), n in counts.items():
                key = ("GET", route, status)
                self.requests[key] = self.requests.get(key, 0) + n

    def mark_auth_failure(self) -> None:
        with self._lock:
            self.auth_failures += 1

    def mark_rate_limited(self) -> None:
        with self._lock:
            self.rate_limited += 1

    def prometheus_lines(self) -> list:
        from tpu_node_checker_torch.metrics import _line  # shared escaping rules

        with self._lock:
            requests = dict(self.requests)
            in_flight = self.in_flight
            auth_failures = self.auth_failures
            rate_limited = self.rate_limited
        lines = [
            "# HELP tpu_node_checker_api_server_requests_total HTTP requests "
            "served by the fleet state API, by method/route/status.",
            "# TYPE tpu_node_checker_api_server_requests_total counter",
        ]
        for (method, route, status), n in sorted(requests.items()):
            lines.append(
                _line(
                    "tpu_node_checker_api_server_requests_total",
                    float(n),
                    {"method": method, "route": route, "status": str(status)},
                )
            )
        # The native histogram (merged across every recording thread at
        # scrape time), then ONE release of the deprecated pseudo-summary
        # it replaces: the old family's _sum/_count are now DERIVED from
        # the merged histogram, so the two can never disagree while the
        # alias lives.
        merged = self.durations.merged()
        lines += self.durations.prometheus_lines(merged)
        lines += [
            "# HELP tpu_node_checker_api_server_request_latency_ms "
            "DEPRECATED alias of ..._request_duration_ms (_sum/_count "
            "derived from the merged histogram); removed next release.",
            "# TYPE tpu_node_checker_api_server_request_latency_ms summary",
        ]
        for route, (_counts, total_ms, count) in sorted(merged.items()):
            lines.append(
                _line(
                    "tpu_node_checker_api_server_request_latency_ms_sum",
                    round(total_ms, 3),
                    {"route": route},
                )
            )
            lines.append(
                _line(
                    "tpu_node_checker_api_server_request_latency_ms_count",
                    float(count),
                    {"route": route},
                )
            )
        lines += [
            "# HELP tpu_node_checker_api_server_in_flight Requests currently "
            "being served.",
            "# TYPE tpu_node_checker_api_server_in_flight gauge",
            _line("tpu_node_checker_api_server_in_flight", float(in_flight)),
            "# HELP tpu_node_checker_api_server_auth_failures_total Rejected "
            "write-path requests (missing/invalid bearer token).",
            "# TYPE tpu_node_checker_api_server_auth_failures_total counter",
            _line(
                "tpu_node_checker_api_server_auth_failures_total",
                float(auth_failures),
            ),
            "# HELP tpu_node_checker_api_server_rate_limited_total "
            "Authenticated write requests refused 429 by the --write-rps "
            "token bucket.",
            "# TYPE tpu_node_checker_api_server_rate_limited_total counter",
            _line(
                "tpu_node_checker_api_server_rate_limited_total",
                float(rate_limited),
            ),
        ]
        return lines


class FleetStateServer:
    """Background fleet API fed by :meth:`publish` once per round.

    ``control(name, action, dry_run, node_doc, snapshot) -> (status,
    body_dict)`` is the write-path seam the checker wires with its
    evidence rules (the snapshot rides along for fleet-wide gates like the
    ``--cordon-max`` budget); when
    ``None`` (standalone store serving) writes answer 503.  ``refresh()``
    runs before reads in standalone mode to pick up store files another
    process rewrites.  ``on_event(kind, detail)`` surfaces lifecycle events
    (auth failures, rate-limited) to the notify layer.
    """

    def __init__(
        self,
        port: int,
        host: str = "0.0.0.0",
        token: Optional[str] = None,
        control: Optional[Callable] = None,
        trend_path: Optional[str] = None,
        refresh: Optional[Callable] = None,
        on_event: Optional[Callable] = None,
        pre_serialized: bool = True,
        workers: int = 1,
        max_connections: int = DEFAULT_MAX_CONNECTIONS,
        write_limiter=None,
        federation: bool = False,
        readiness: Optional[Callable] = None,
        obs=None,
        lease: Optional[Callable] = None,
        feed: bool = True,
    ):
        self._snap: Optional[FleetSnapshot] = None
        # The observability layer (obs.Observability): owns the debug ring
        # the /api/v1/debug/rounds endpoints serve and the histogram
        # families appended to every /metrics scrape.  None = no tracing
        # surface (the debug endpoints answer 404 naming the reason).
        self._obs = obs
        # Every write-path decision goes through the unified event log —
        # a server wired without an Observability still audits (to stderr).
        self._events = obs.events if obs is not None else EventLog()
        # Federation mode (--federate): the merged global view swaps in
        # through publish_global; the per-cluster round surface answers a
        # redirecting 404 instead of a forever-503.  ``readiness`` is the
        # aggregator's /readyz seam: () -> (ok, reason, detail_dict).
        self._federation = federation
        self._readiness = readiness
        # Federated disruption budgets: the aggregator's lease seam —
        # ``lease(body_dict) -> (status, body_dict)``; None answers 404 so
        # checkers pointed at a budget-less aggregator fall back to their
        # local budgets (the lease client treats 404 as unreachable).
        self._lease = lease
        # The checker's budget view (GET /api/v1/remediation): one
        # pre-serialized Entity swapped per round by publish_remediation —
        # request threads only ever negotiate an immutable reference.
        self._remediation = None
        # The analytics tier's view (GET /api/v1/analytics/{slo,offenders,
        # flaps}): dict of pre-serialized Entities, swapped as ONE
        # reference per round — same lock-free read discipline (TNC011).
        self._analytics: Optional[Dict[str, object]] = None
        self._global = None  # merge.GlobalSnapshot, swapped atomically
        self._seq = 0
        self._breaker: Optional[dict] = None
        default_metrics = b"# tpu-node-checker: no check completed yet\n"
        # (plain body, gzipped body) as ONE tuple so a scrape racing a
        # publish never pairs one round's prefix with another's gz.
        self._metrics = (
            default_metrics,
            _gzip.compress(default_metrics, _METRICS_PREFIX_GZIP_LEVEL, mtime=0),
        )
        self._token = token
        self._control = control
        self._refresh = refresh
        self.on_event = on_event
        self._trend = TrendCache(trend_path) if trend_path else None
        self._stats = ServerStats()
        self._write_limiter = write_limiter
        self._last_auth_event = 0.0
        # Bench seam: pre_serialized=False re-encodes the endpoint body on
        # every request — the pre-snapshot cost model, measured against the
        # cached path by bench.py's serve case.  Never used in production.
        self._pre_serialized = pre_serialized
        # The watch feed (DESIGN §20): push-delta frames over the same
        # validator the conditional GETs use.  ``feed=False`` simulates a
        # feed-less upstream — the route is not registered at all, so a
        # stream-mode aggregator sees the same 404 an older build answers
        # and silently degrades that cluster to conditional-GET polling.
        self._feed = FeedState() if feed else None
        # The worker pool's fast table: request-line bytes → prebuilt wire
        # responses, swapped atomically per publish (empty = every request
        # rides the routed path — standalone store mode keeps it empty so
        # the per-request refresh() seam always runs).
        self.fast_routes: dict = {}

        router = Router()
        router.add("GET", "/healthz", self._get_healthz)
        router.add("GET", "/readyz", self._get_readyz)
        router.add("GET", "/metrics", self._get_metrics)
        router.add("GET", "/api/v1/summary", self._get_collection("summary"))
        router.add("GET", "/api/v1/nodes", self._get_collection("nodes"))
        router.add("GET", "/api/v1/slices", self._get_collection("slices"))
        router.add("GET", "/api/v1/nodes/{name}", self._get_node)
        if feed:
            router.add("GET", "/api/v1/watch", self._get_watch)
        router.add("GET", "/api/v1/trend", self._get_trend)
        router.add("GET", "/api/v1/remediation", self._get_remediation)
        for key in ("slo", "offenders", "flaps"):
            router.add("GET", f"/api/v1/analytics/{key}",
                       self._get_analytics(key))
        router.add("POST", "/api/v1/global/disruption-lease",
                   self._post_lease)
        router.add("GET", "/api/v1/debug/rounds", self._get_debug_rounds)
        router.add("GET", "/api/v1/debug/rounds/{trace_id}",
                   self._get_debug_round)
        router.add("POST", "/api/v1/nodes/{name}/cordon", self._post_control)
        router.add("POST", "/api/v1/nodes/{name}/uncordon", self._post_control)
        # The federation surface (registered unconditionally so a plain
        # checker answers a helpful 404 there, not a route miss).
        router.add("GET", "/api/v1/global/summary",
                   self._get_global("global/summary"))
        router.add("GET", "/api/v1/global/clusters",
                   self._get_global("global/clusters"))
        router.add("GET", "/api/v1/global/nodes",
                   self._get_global("global/nodes"))
        router.add("GET", "/api/v1/global/analytics",
                   self._get_global_analytics)
        router.add("GET", "/api/v1/global/clusters/{name}",
                   self._get_global_cluster)
        self.router = router

        self._pool = WorkerPool(
            host, port, app=self, workers=workers,
            max_connections=max_connections,
        )

    # -- the worker pool's serving seam --------------------------------------

    def observe(self, method: str, route: str, status: int, ms: float) -> None:
        self._stats.observe(method, route, status, ms)

    def track_in_flight(self, delta: int) -> None:
        self._stats.track_in_flight(delta)

    def count_fast(self, counts: dict) -> None:
        self._stats.merge_fast(counts)

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        return self._pool.port

    @property
    def stats(self) -> ServerStats:
        return self._stats

    @property
    def workers_active(self) -> int:
        return self._pool.workers

    @property
    def reuseport(self) -> bool:
        return self._pool.reuseport

    def restart_worker(self, index: int) -> None:
        """Rolling-restart seam: replace one accept loop in place (the
        restart-hammer test drives this; ops can too, via SIGHUP one day)."""
        self._pool.restart(index)

    def close(self) -> None:
        if self._feed is not None:
            self._feed.close()
        self._pool.close()

    # -- publication (the check loop's side) ---------------------------------

    @staticmethod
    def _identity_headers(seq: int, trace_id: Optional[str]) -> Dict[str, str]:
        """The round/trace identity every snapshot read carries — baked
        into fast-path wire bytes at publish time, added to routed
        responses per request.  The federation fetch tier reads these to
        stitch one global trace across both tiers."""
        headers = {"X-TNC-Round": str(seq)}
        if trace_id:
            headers["X-TNC-Trace"] = trace_id
        return headers

    def publish(
        self, result, breaker: Optional[dict] = None, changed=None,
        tracer=None,
    ) -> FleetSnapshot:
        """One completed round → one immutable snapshot, atomically swapped.

        Called from the watch loop between rounds; request threads keep
        serving the PREVIOUS snapshot until the assignment lands, so a
        poller never observes a half-built round.

        ``changed`` (watch-stream mode) is the set of node names whose
        payload entries differ from the previous publish: the new snapshot
        is then DELTA-built — unchanged per-node entities, fragments,
        gzip members and evidence docs carried over from the live snapshot
        by reference
        (see :func:`~tpu_node_checker_torch.server.snapshot.build_snapshot_delta`)
        instead of re-encoded.  ``None`` (poll mode, first round, or a
        non-round previous snapshot) builds from scratch.
        """
        self._seq += 1
        prev = self._snap
        if (
            changed is not None
            and prev is not None
            and prev.source == "round"
        ):
            span = (
                tracer.span("delta-build", changed=len(changed))
                if tracer is not None
                else _NULL_SPAN
            )
            with span:
                snap = build_snapshot_delta(
                    prev, result.payload, result.exit_code, self._seq,
                    round(time.time(), 3), changed,
                )
        else:
            snap = build_snapshot(
                result.payload, result.exit_code, self._seq, round(time.time(), 3)
            )
        metrics = self._render_fleet_metrics(result, breaker)
        fast = (
            build_fast_routes(
                {f"/api/v1/{key}": snap.entities[key] for key in _FAST_PATHS},
                extra_headers=self._identity_headers(snap.seq, snap.trace_id),
            )
            if self._pre_serialized and self._refresh is None
            else {}
        )
        # The feed transition is derived BEFORE the swap (nothing feeds
        # off the published reference post-swap): woken watch consumers
        # serve from the feed's own captured references either way.
        if self._feed is not None:
            self._publish_feed(prev if prev is not None and
                               prev.source == "round" else None, snap)
        # Swap order: metrics and the fast table first, snapshot last — the
        # snapshot's seq is what readiness and the hammer test key on, and
        # each reference is internally consistent on its own.
        self._metrics = metrics
        self._breaker = breaker
        self.fast_routes = fast
        self._snap = snap
        return snap

    def _publish_feed(self, prev, snap) -> None:
        """One round publish → one watch-feed transition: diff the two
        rounds' per-node fragment tables (identity first — delta builds
        carry unchanged fragments by reference — then bytes, so poll-mode
        full builds still diff correctly)."""
        entity = snap.entities.get("nodes")
        doc = snap.docs.get("nodes")
        frags = snap.node_fragments
        if entity is None or doc is None or len(frags) != len(doc.get("nodes") or ()):
            # Unnamed/duplicate entries: fragment state cannot reproduce
            # the body — withdraw the feed; consumers fall back to polls.
            self._feed.clear()
            return
        head = {k: v for k, v in doc.items() if k != "nodes"}
        changed = None
        removed: Tuple[str, ...] = ()
        if prev is not None:
            pf = prev.node_fragments
            pdoc = prev.docs.get("nodes") or {}
            if len(pf) == len(pdoc.get("nodes") or ()):
                changed = []
                for name, frag in frags.items():
                    old = pf.get(name)
                    if old is not frag and old != frag:
                        changed.append(name)
                removed = tuple(n for n in pf if n not in frags)
        self._feed.publish(
            entity.etag, snap.seq, snap.ts, head, "nodes",
            frags, snap.node_gz_fragments, changed, removed,
            blocks={"summary": snap.docs.get("summary")},
        )

    def publish_global(self, gsnap, metrics_body: Optional[bytes] = None) -> None:
        """Federation mode: one merge round → the global view, atomically
        swapped exactly like a round snapshot.

        ``gsnap`` is a :class:`~tpu_node_checker_torch.federation.merge.GlobalSnapshot`;
        its hot entities earn fast-table wire responses, per-cluster detail
        rides the routed path.  ``metrics_body`` replaces the round-family
        scrape prefix (the aggregator runs no check rounds, so the
        federation families ARE its round surface).
        """
        self._seq = max(self._seq + 1, gsnap.seq)
        if metrics_body is not None:
            self._metrics = (
                metrics_body,
                _gzip.compress(metrics_body, _METRICS_PREFIX_GZIP_LEVEL, mtime=0),
            )
        fast = (
            build_fast_routes(
                {f"/api/v1/{key}": gsnap.entities[key]
                 for key in _GLOBAL_FAST_PATHS if key in gsnap.entities},
                extra_headers=self._identity_headers(
                    gsnap.seq, getattr(gsnap, "trace_id", None)
                ),
            )
            if self._pre_serialized
            else {}
        )
        if self._feed is not None:
            self._publish_feed_global(gsnap)
        # Same swap order discipline as publish(): metrics and the fast
        # table first, the snapshot (what readiness keys on) last.
        self.fast_routes = fast
        self._global = gsnap

    def _publish_feed_global(self, gsnap) -> None:
        """Federation mode's feed transition: the entries are per-cluster
        BLOCKS (the merge tier's cached byte splices), so an
        aggregator-of-aggregators consumes this feed exactly like an
        aggregator consumes a checker's — federation stacks by
        construction."""
        entity = gsnap.entities.get("global/nodes")
        blocks_map = getattr(gsnap, "cluster_blocks", None)
        head = getattr(gsnap, "nodes_head", None)
        if entity is None or not blocks_map or head is None:
            self._feed.clear()
            return
        prev = self._global
        changed = None
        removed: Tuple[str, ...] = ()
        prev_blocks = getattr(prev, "cluster_blocks", None) if prev is not None else None
        if prev_blocks:
            changed = []
            for name, block in blocks_map.items():
                old = prev_blocks.get(name)
                if old is not block and old != block:
                    changed.append(name)
            removed = tuple(n for n in prev_blocks if n not in blocks_map)
        summary_doc = getattr(gsnap, "summary_doc", None)
        self._feed.publish(
            entity.etag, gsnap.seq, gsnap.ts, head, "clusters",
            blocks_map, getattr(gsnap, "block_gz", None), changed, removed,
            blocks={"summary": summary_doc} if summary_doc is not None else None,
        )

    def publish_snapshot(self, snap: FleetSnapshot) -> None:
        """Standalone mode: install an externally built (store) snapshot.

        The fast table stays EMPTY on purpose: standalone reads must ride
        the routed path so the per-request ``refresh()`` seam keeps
        watching the store file for rewrites.
        """
        self._seq = max(self._seq + 1, snap.seq)
        self._snap = snap

    def publish_remediation(self, doc: Optional[dict]) -> None:
        """Swap the budget view one round's engine produced (None clears
        it).  Serialized once here, negotiated per request — the read path
        stays lock-free (TNC011)."""
        if doc is None:
            self._remediation = None
            if self._feed is not None:
                self._feed.update_blocks("remediation", None)
            return
        body = (json.dumps(doc, ensure_ascii=False) + "\n").encode("utf-8")
        from tpu_node_checker_torch.server.snapshot import Entity

        self._remediation = Entity(
            body, "application/json; charset=utf-8"
        )
        if self._feed is not None:
            # The budget rides the feed as a named block: downstream tiers
            # see lease arithmetic at delta speed, not at poll cadence.
            self._feed.update_blocks("remediation", doc)

    def publish_analytics(self, docs: Optional[dict]) -> None:
        """Swap the analytics query documents one round computed from its
        roll-ups (None clears back to 404).  Each doc is serialized ONCE
        here; request threads only negotiate immutable entities."""
        if docs is None:
            self._analytics = None
            if self._feed is not None:
                self._feed.update_blocks("analytics_slo", None)
            return
        from tpu_node_checker_torch.server.snapshot import json_entity

        self._analytics = {
            key: json_entity(doc) for key, doc in sorted(docs.items())
        }
        if self._feed is not None:
            # The SLO roll-up rides the feed too (offenders/flaps stay
            # poll-only: they are operator drill-downs, not tier state).
            self._feed.update_blocks("analytics_slo", docs.get("slo"))

    def refresh_metrics(self, result, breaker: Optional[dict] = None) -> None:
        """A steady watch-stream tick: served content is unchanged (no
        snapshot swap, every poller's ETag keeps 304-ing) but the scrape
        surface must keep breathing — ``last_run_timestamp_seconds`` and
        the stream-age gauge move every tick, or the staleness alerts
        would fire on a perfectly healthy, merely quiet fleet."""
        self._metrics = self._render_fleet_metrics(result, breaker)
        self._breaker = breaker

    def mark_error(self, breaker: Optional[dict] = None) -> None:
        """A check round failed: the last snapshot keeps serving (state is
        UNKNOWN, not gone), but an OPEN breaker flips ``/readyz`` — stale
        data must stop gating schedulers once the monitor itself is down."""
        self._breaker = breaker

    def _render_fleet_metrics(self, result, breaker) -> Tuple[bytes, bytes]:
        """→ (plain body, gzip member of it): the round-family prefix of
        every scrape, compressed once per publish, never per scrape."""
        from tpu_node_checker_torch.metrics import render_metrics

        body = render_metrics(result, breaker=breaker).encode("utf-8")
        return body, _gzip.compress(body, _METRICS_PREFIX_GZIP_LEVEL, mtime=0)

    # -- readiness -----------------------------------------------------------

    def ready(self) -> Tuple[bool, str]:
        if self._snap is None:
            return False, "no completed check round yet"
        if self._breaker and self._breaker.get("open"):
            return False, (
                "watch circuit breaker open "
                f"({self._breaker.get('consecutive_failures')} consecutive "
                "failed rounds) — snapshot may be stale"
            )
        return True, "ok"

    # -- read handlers --------------------------------------------------------

    def _current(self) -> Optional[FleetSnapshot]:
        if self._refresh is not None:
            try:
                self._refresh()
            except Exception as exc:  # tnc: allow-broad-except(refresh is best-effort)
                print(f"fleet API store refresh failed: {exc}", file=sys.stderr)
        return self._snap

    @staticmethod
    def _no_round() -> Response:
        return json_response(
            503, {"error": "no completed check round yet", "ready": False}
        )

    @staticmethod
    def _not_an_aggregator() -> Response:
        return json_response(
            404,
            {"error": "not a federation aggregator: the /api/v1/global/* "
                      "surface is served by tnc --federate"},
        )

    def _redirect_to_global(self) -> Response:
        return json_response(
            404,
            {"error": "this is a federation aggregator: per-cluster rounds "
                      "are served one tier down — query /api/v1/global/"
                      "{summary,clusters,nodes} here"},
        )

    @staticmethod
    def _stamp_round(resp: Response, seq, trace_id) -> Response:
        """Round/trace identity headers on a routed snapshot read (the
        fast path bakes the same pair in at publish time)."""
        resp.headers["X-TNC-Round"] = str(seq)
        if trace_id:
            resp.headers["X-TNC-Trace"] = trace_id
        return resp

    def _get_global(self, key: str):
        def handler(req: Request) -> Response:
            gsnap = self._global
            if gsnap is None:
                if not self._federation:
                    return self._not_an_aggregator()
                return json_response(
                    503, {"error": "no federation round completed yet",
                          "ready": False},
                )
            return self._stamp_round(
                negotiate(gsnap.entity(key), req.headers),
                gsnap.seq, getattr(gsnap, "trace_id", None),
            )

        return handler

    def _get_global_analytics(self, req: Request) -> Response:
        """``GET /api/v1/global/analytics`` — unlike the always-present
        global entities, this one exists only while at least one cluster
        reports a mergeable SLO block, so absence is a 404 with a cause,
        not a KeyError.  (When present it is normally answered by the
        fast table; this handler is the cold/routed fallback.)"""
        gsnap = self._global
        if gsnap is None:
            if not self._federation:
                return self._not_an_aggregator()
            return json_response(
                503, {"error": "no federation round completed yet",
                      "ready": False},
            )
        if "global/analytics" not in gsnap.entities:
            return json_response(
                404, {"error": "no cluster reports analytics "
                               "(upstreams run without --analytics, or no "
                               "analytics_slo block has arrived yet)"},
            )
        return self._stamp_round(
            negotiate(gsnap.entity("global/analytics"), req.headers),
            gsnap.seq, getattr(gsnap, "trace_id", None),
        )

    def _get_global_cluster(self, req: Request) -> Response:
        gsnap = self._global
        if gsnap is None:
            if not self._federation:
                return self._not_an_aggregator()
            return json_response(
                503, {"error": "no federation round completed yet",
                      "ready": False},
            )
        entity = gsnap.cluster_entity(req.params["name"])
        if entity is None:
            return json_response(
                404,
                {"error": f"cluster {req.params['name']!r} is not in the "
                          f"endpoints file (round {gsnap.seq})",
                 "round": gsnap.seq},
            )
        return self._stamp_round(
            negotiate(entity, req.headers),
            gsnap.seq, getattr(gsnap, "trace_id", None),
        )

    def _get_collection(self, key: str):
        def handler(req: Request) -> Response:
            if self._federation:
                return self._redirect_to_global()
            snap = self._current()
            if snap is None:
                return self._no_round()
            if not self._pre_serialized and key in snap.docs:
                # Bench-only cold-encode path: what every GET would cost
                # WITHOUT the snapshot cache — one full JSON encode per
                # request, no ETag, no pre-compressed variant.
                raw = (
                    json.dumps(snap.docs[key], ensure_ascii=False) + "\n"
                ).encode("utf-8")
                return Response(
                    200, raw,
                    {"Content-Type": "application/json; charset=utf-8"},
                )
            return self._stamp_round(
                negotiate(snap.entities[key], req.headers),
                snap.seq, snap.trace_id,
            )

        return handler

    def _get_node(self, req: Request) -> Response:
        if self._federation:
            return self._redirect_to_global()
        snap = self._current()
        if snap is None:
            return self._no_round()
        entity = snap.node_entities.get(req.params["name"])
        if entity is None:
            return json_response(
                404,
                {
                    "error": f"node {req.params['name']!r} not in round {snap.seq}",
                    "round": snap.seq,
                },
            )
        return self._stamp_round(
            negotiate(entity, req.headers), snap.seq, snap.trace_id
        )

    def _get_watch(self, req: Request) -> Response:
        """``GET /api/v1/watch?since=<ETag>[&timeout=s][&rev=n]`` — ONE
        feed frame per request (see :mod:`~tpu_node_checker_torch.server.feed`).

        The one deliberately blocking read path: the request thread parks
        until the state moves past ``since`` or the window closes.  It can
        only ride the worker pool's routed fallback (a query string never
        matches the fast table), and the pool pre-flushes batched
        responses before dispatching here — the fast-route responders stay
        lock-free and unparked (DESIGN §20)."""
        feed = self._feed
        if feed is None:
            return json_response(
                404, {"error": "watch feed disabled on this server"}
            )
        since = req.query.get("since") or ""
        raw_wait = req.query.get("timeout")
        try:
            wait = (
                float(raw_wait) if raw_wait is not None
                else _WATCH_DEFAULT_WAIT_S
            )
        except ValueError:
            return json_response(
                400, {"error": f"bad timeout {raw_wait!r}: must be seconds"}
            )
        raw_rev = req.query.get("rev")
        rev = None
        if raw_rev is not None:
            try:
                rev = int(raw_rev)
            except ValueError:
                return json_response(
                    400, {"error": f"bad rev {raw_rev!r}: must be an integer"}
                )
        entity = feed.frame(
            since, min(max(wait, 0.0), _WATCH_MAX_WAIT_S), rev
        )
        if entity is None:
            return self._no_round()
        return negotiate(entity, req.headers)

    def _get_trend(self, req: Request) -> Response:
        if self._trend is None:
            return json_response(
                404, {"error": "no trend log configured (--log-jsonl)"}
            )
        # _current() runs for its standalone-mode refresh side effect; the
        # cache keys purely on the log's content digest (never the seq).
        self._current()
        return negotiate(self._trend.entity(), req.headers)

    def _get_remediation(self, req: Request) -> Response:
        entity = self._remediation
        if entity is None:
            return json_response(
                404,
                {"error": "remediation is not active on this checker: no "
                          "actuator flag (--cordon-failed/--drain-failed) "
                          "ran this round"},
            )
        return negotiate(entity, req.headers)

    def _get_analytics(self, key: str):
        def handler(req: Request) -> Response:
            entities = self._analytics
            entity = entities.get(key) if entities is not None else None
            if entity is None:
                return json_response(
                    404,
                    {"error": "analytics is not active on this checker: "
                              "run with --analytics DIR (requires "
                              "--history) to build the roll-up store"},
                )
            return negotiate(entity, req.headers)

        return handler

    def _get_healthz(self, req: Request) -> Response:
        return json_response(200, {"ok": True})

    # -- debug: round traces (lock-free reads over finished tracers) ----------

    def _get_debug_rounds(self, req: Request) -> Response:
        obs = self._obs
        if obs is None:
            return json_response(
                404,
                {"error": "tracing not enabled: this server was started "
                          "without an observability layer"},
            )
        rounds = [t.summary() for t in obs.ring.entries()]
        return json_response(
            200, {"count": len(rounds), "ring_size": obs.ring.size,
                  "rounds": rounds},
        )

    def _get_debug_round(self, req: Request) -> Response:
        obs = self._obs
        if obs is None:
            return json_response(
                404,
                {"error": "tracing not enabled: this server was started "
                          "without an observability layer"},
            )
        tracer = obs.ring.find(req.params["trace_id"])
        if tracer is None:
            return json_response(
                404,
                {"error": f"trace {req.params['trace_id']!r} is not among "
                          f"the last {obs.ring.size} completed rounds"},
            )
        return Response(
            200, tracer.chrome_trace_bytes(),
            {"Content-Type": "application/json; charset=utf-8"},
        )

    def _get_readyz(self, req: Request) -> Response:
        if self._readiness is not None:
            # Federation mode: the aggregator's own rule (≥1 merge round,
            # not blind), with per-cluster fetch/breaker detail in the body.
            ok, reason, detail = self._readiness()
            body = {"ready": ok, "reason": reason, **(detail or {})}
            if self._global is not None:
                body["round"] = self._global.seq
            return json_response(200 if ok else 503, body)
        self._current()  # standalone: readiness reflects the refreshed store
        ok, reason = self.ready()
        body = {"ready": ok, "reason": reason}
        if self._snap is not None:
            body["round"] = self._snap.seq
        return json_response(200 if ok else 503, body)

    # tnc: allow-transitive-blocking(the per-scrape stats block reads counters under FleetStats._lock by design — DESIGN §13: /metrics is the one endpoint whose body moves every scrape, and a scrape is not the 50k req/s fast path; the fast-path responders stay lock-free and separately rooted)
    def _get_metrics(self, req: Request) -> Response:
        """The round's fleet families + this server's live request stats.

        The stats block moves on every scrape (it counts the scrape
        itself), so a conditional ETag could never hit.  Compression is
        split along the same line: the round-family prefix's gzip member
        was cached at publish time, so an opted-in scrape pays level-1
        deflate of the (small) moving stats block only — the two members
        concatenate into one stream whose plain-text decode is
        byte-identical to the uncompressed body.  The ``--metrics-port``
        surface, whose body IS round-static, keeps the full ETag treatment.
        """
        from tpu_node_checker_torch.metrics import METRICS_CONTENT_TYPE, _line

        prefix, prefix_gz = self._metrics
        lines = self._stats.prometheus_lines()
        lines += [
            "# HELP tpu_node_checker_api_server_workers Accept loops "
            "serving this fleet API (SO_REUSEPORT pool size; 1 = single "
            "listener).",
            "# TYPE tpu_node_checker_api_server_workers gauge",
            _line(
                "tpu_node_checker_api_server_workers",
                float(self._pool.workers),
            ),
            "# HELP tpu_node_checker_api_server_swr_stale_served_total "
            "/api/v1/trend responses served stale while a rebuild ran "
            "(stale-while-revalidate hits).",
            "# TYPE tpu_node_checker_api_server_swr_stale_served_total "
            "counter",
            _line(
                "tpu_node_checker_api_server_swr_stale_served_total",
                float(self._trend.stale_served if self._trend else 0),
            ),
        ]
        if self._obs is not None:
            # Round-phase / federation-fetch histograms: merged across
            # their per-thread recorders at scrape time, lock-free.
            lines += self._obs.prometheus_lines()
        stats_block = ("\n".join(lines) + "\n").encode("utf-8")
        headers = {"Content-Type": METRICS_CONTENT_TYPE, "Vary": "Accept-Encoding"}
        if "gzip" in (req.headers.get("Accept-Encoding") or "").lower():
            body = prefix_gz + _gzip.compress(
                stats_block, _METRICS_STATS_GZIP_LEVEL, mtime=0
            )
            headers["Content-Encoding"] = "gzip"
        else:
            body = prefix + stats_block
        return Response(200, body, headers)

    # -- write handlers -------------------------------------------------------

    def _post_lease(self, req: Request) -> Response:
        """``POST /api/v1/global/disruption-lease``: borrow from the fleet
        disruption budget.  No bearer gate — a lease moves budget numbers,
        never cluster state; the actuation it authorizes still happens one
        tier down, behind that cluster's own evidence rules and RBAC."""
        if self._lease is None:
            return json_response(
                404,
                {"error": "no fleet disruption budget configured "
                          "(--fleet-disruption-budget on the aggregator); "
                          "checkers fall back to their local budgets"},
            )
        try:
            body = json.loads(req.body) if req.body else {}
            if not isinstance(body, dict):
                raise ValueError("lease request must be a JSON object")
        except (ValueError, AttributeError) as exc:
            return json_response(400, {"error": f"bad lease request: {exc}"})
        try:
            status, resp = self._lease(body)
        except Exception as exc:  # tnc: allow-broad-except(a lease-seam bug is a response, not a serving-thread crash)
            status, resp = 500, {"error": f"lease failed: {exc}"}
        return json_response(status, resp)

    def _post_control(self, req: Request) -> Response:
        action = "cordon" if req.path.endswith("/cordon") else "uncordon"
        name = req.params["name"]
        status, reason = check_write_auth(
            self._token, req.headers.get("Authorization")
        )
        if status is not None:
            self._stats.mark_auth_failure()
            self._audit(name, action, status, applied=False, reason=reason,
                        remote=req.remote)
            self._auth_event(
                f"{action} {name!r} from {req.remote} rejected ({status}): {reason}"
            )
            resp = json_response(status, {"error": reason})
            if status == 401:
                resp.headers["WWW-Authenticate"] = "Bearer"
            return resp
        if self._write_limiter is not None:
            wait = self._write_limiter.try_acquire()
            if wait > 0.0:
                # Authenticated but over the --write-rps bucket: 429 with a
                # Retry-After the caller's retry ladder can honor — a token
                # holder's runaway loop backs off instead of turning every
                # eligible request into a control-plane PATCH.
                self._stats.mark_rate_limited()
                self._audit(
                    name, action, 429, applied=False,
                    reason="write rate limit exceeded", remote=req.remote,
                )
                resp = json_response(
                    429,
                    {"error": "write rate limit exceeded — retry after the "
                              "Retry-After delay", "node": name,
                     "action": action},
                )
                resp.headers["Retry-After"] = retry_after_header(wait)
                return resp
        if self._control is None:
            return json_response(
                503,
                {
                    "error": "control plane unavailable: this server runs over "
                    "a recorded store or a federated view, not a live check "
                    "loop — cordon through the cluster's own checker"
                },
            )
        snap = self._current()
        if snap is None:
            return self._no_round()
        node = snap.node_docs.get(name)
        if node is None:
            return json_response(
                404, {"error": f"node {name!r} not in round {snap.seq}"}
            )
        dry_run = self._dry_run(req)
        try:
            status, body = self._control(name, action, dry_run, node, snap)
        except Exception as exc:  # tnc: allow-broad-except(a PATCH failure is a response, not a crash)
            status, body = 502, {"error": f"{action} failed: {exc}"}
        body.setdefault("node", name)
        body.setdefault("action", action)
        body.setdefault("round", snap.seq)
        self._audit(
            name, action, status,
            applied=bool(body.get("applied")), reason=body.get("reason"),
            remote=req.remote, dry_run=dry_run,
        )
        return json_response(status, body)

    @staticmethod
    def _dry_run(req: Request) -> bool:
        flag = (req.query.get("dry_run") or "").lower()
        if flag in ("1", "true", "yes"):
            return True
        if req.body:
            try:
                return bool(json.loads(req.body).get("dry_run"))
            except (ValueError, AttributeError):
                return False
        return False

    # -- audit + events -------------------------------------------------------

    def _audit(self, name, action, status, applied, reason, remote,
               dry_run=False):
        """One event-log line per write-path decision — grantable or
        refused — so "who cordoned what, when, and why" is grep-able from
        pod logs AND joinable (via ``trace_id``) to the round trace whose
        evidence gated the decision."""
        snap = self._snap
        self._events.emit(
            "fleet-api-write",
            trace_id=snap.trace_id if snap is not None else None,
            action=action,
            node=name,
            status=status,
            applied=applied,
            dry_run=dry_run,
            remote=remote,
            reason=reason or None,
        )

    def _auth_event(self, detail: str) -> None:
        if self.on_event is None:
            return
        now = time.monotonic()
        if now - self._last_auth_event < _AUTH_EVENT_INTERVAL_S:
            return
        self._last_auth_event = now

        def _fire():
            try:
                self.on_event("auth-failure", detail)
            except Exception as exc:  # tnc: allow-broad-except(notification must not break serving)
                print(f"fleet API event hook failed: {exc}", file=sys.stderr)

        # Off the request thread: the hook may POST to Slack (10 s timeout),
        # and the 401/403 response must not wait on a slow webhook.
        threading.Thread(
            target=_fire, name="tnc-auth-event-notify", daemon=True
        ).start()
