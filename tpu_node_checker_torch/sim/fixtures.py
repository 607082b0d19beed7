"""Simulated-cluster building blocks: node builders, fault scripts, and
the fake Kubernetes API servers they drive.

A copy of the JAX package's ``sim/fixtures.py``, held equal to it by
``tests/test_torch_copies.py``.  :class:`FaultSchedule` scripts per-request
faults, :class:`WatchScript` scripted watch connections, and
:class:`StormSchedule` a seeded mass-failure and flap storm over a
multi-slice TPU fleet.  Nothing here reads the wall clock or the global
RNG: pacing rides an injectable clock
(:class:`~tpu_node_checker_torch.sim.clock.SimClock` or
:class:`~tpu_node_checker_torch.sim.clock.WallClock`) and randomness a
caller-owned ``random.Random``.
"""

from __future__ import annotations

from typing import List, Optional

from tpu_node_checker_torch.sim.clock import WallClock


def make_node(
    name: str,
    ready: bool = True,
    allocatable: Optional[dict] = None,
    capacity: Optional[dict] = None,
    labels: Optional[dict] = None,
    taints: Optional[list] = None,
    conditions: Optional[list] = None,
    unschedulable: bool = False,
    not_ready_reason: Optional[str] = None,
    not_ready_message: Optional[str] = None,
) -> dict:
    """One raw node dict, shaped like a k8s REST ``V1Node`` serialization."""
    alloc = {"cpu": "8", "memory": "32Gi", "pods": "110"}
    if allocatable:
        alloc.update(allocatable)
    cap = dict(capacity) if capacity is not None else dict(alloc)
    if conditions is None:
        ready_cond = {"type": "Ready", "status": "True" if ready else "False"}
        if not ready and not_ready_reason:
            ready_cond["reason"] = not_ready_reason
        if not ready and not_ready_message:
            ready_cond["message"] = not_ready_message
        conditions = [
            {"type": "MemoryPressure", "status": "False"},
            ready_cond,
        ]
    node = {
        "metadata": {"name": name, "labels": labels or {}},
        "spec": {},
        "status": {"allocatable": alloc, "capacity": cap, "conditions": conditions},
    }
    if taints:
        node["spec"]["taints"] = taints
    if unschedulable:
        node["spec"]["unschedulable"] = True
    return node


TPU_TAINT = {"key": "google.com/tpu", "value": "present", "effect": "NoSchedule"}


def node_list(items: List[dict]) -> dict:
    """Wrap items the way ``GET /api/v1/nodes`` does."""
    return {"kind": "NodeList", "apiVersion": "v1", "items": items}


def serve_http(handler_cls, tls_cert=None):
    """Silenced, daemon-threaded HTTP(S) server on an ephemeral port.

    Shared by every fixture that plays an HTTP endpoint (fake API server,
    probe-report webhooks); the caller defines behavior in ``handler_cls``
    and owns shutdown (``server.shutdown()``).

    Threaded (one handler thread per CONNECTION), because the checker's
    transport keeps sockets alive: a single-threaded server would sit in
    one connection's keep-alive read loop and never accept the next dial.
    The server counts accepted connections in ``server.connections_opened``
    — the ground truth the pool-reuse tests and bench assert against.
    ``tls_cert`` = ``(certfile, keyfile)`` wraps the listener in TLS.
    """
    import threading
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        connections_opened = 0

        def get_request(self):
            request = super().get_request()
            self.connections_opened += 1  # accept() is serialized: no race
            return request

    server = Server(("127.0.0.1", 0), handler_cls)
    if tls_cert is not None:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert[0], tls_cert[1])
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    threading.Thread(
        target=server.serve_forever, name="tnc-sim-http-fixture", daemon=True
    ).start()
    return server


class FaultSchedule:
    """Scripted per-request fault sequence for the fake API servers.

    Each arriving request consumes the next fault spec; after the list is
    exhausted every further request gets ``then`` (default: healthy).  This
    turns the old single-shot ``FaultyApiServer`` modes into composable
    scripts — fail-N-then-succeed, 429 + Retry-After, mid-body reset — that
    the retry tests, the fault-injection suite, bench.py and the chaos
    scenarios all share.

    Fault specs (strings, optional ``:`` suffix):

    * ``"ok"`` — healthy response;
    * ``"500"`` / ``"502"`` / ``"503"`` / ``"504"`` — that status with a
      small Status body;
    * ``"429"`` / ``"429:N"`` / ``"429:<HTTP-date>"`` — throttle, with the
      suffix sent as a ``Retry-After`` header (``"503:N"`` works too);
    * ``"reset"`` — RST the connection before any response bytes;
    * ``"close"`` — close cleanly without responding (stale-socket shape);
    * ``"mid_body_reset"`` — send headers + half the body, then slam;
    * ``"garbage_json"`` — HTTP 200, non-JSON body (broken proxy);
    * ``"slow:N"`` — trickle one byte then stall N seconds (client timeout).

    Thread-safe (the threaded fixture server handles connections in
    parallel); ``served`` records what each request actually got, in
    arrival order — the ground truth retry tests assert against.  Stalls
    (``slow:``) pace through the injectable ``clock`` — a ``SimClock``
    makes them free and virtual, the default ``WallClock`` stalls for real.
    """

    def __init__(self, faults: Optional[List[str]] = None, then: str = "ok",
                 clock=None):
        import threading

        self._faults = list(faults or [])
        self._then = then
        self.served: List[str] = []
        self._lock = threading.Lock()
        self.clock = clock if clock is not None else WallClock()

    def next(self) -> str:
        with self._lock:
            fault = self._faults.pop(0) if self._faults else self._then
            self.served.append(fault)
            return fault

    def pace(self, seconds: float) -> None:
        """Scripted stall, routed through the injectable clock seam."""
        self.clock.sleep(seconds)

    def reload(self, faults: List[str], then: str = "ok") -> None:
        """Swap in a fresh script (scenario round boundaries), keeping the
        ``served`` record intact."""
        with self._lock:
            self._faults = list(faults)
            self._then = then


def paged_nodelist_body(
    nodes: List[dict],
    path: str,
    requests_seen: Optional[list],
    resource_version: Optional[str] = None,
    page_cache: Optional[dict] = None,
) -> bytes:
    """The fake apiserver's ``limit``/``continue`` paging protocol — ONE
    definition shared by :func:`paged_nodelist_handler`,
    :func:`fault_scheduled_handler`, :func:`watch_nodelist_handler` and
    :func:`storm_apiserver`, so the fault-injection/bench/watch/chaos paths
    can never drift onto a different protocol than the pagination tests
    pin.  ``requests_seen`` (optional list) records each request's start
    offset; ``resource_version`` rides the list metadata (what a
    subsequent watch resumes from).

    ``page_cache`` (optional, caller-owned) memoizes serialized page bytes
    by ``(start, limit)``: bench latency runs keep the fixture server's
    per-request ``json.dumps`` of an unchanged 5k-node fleet OUT of the
    measured region (a real apiserver's serialization cost is not the
    checker's).  The caller owns invalidation — pop the affected keys (or
    clear) after mutating ``nodes``."""
    import json as _json
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    limit = int(q.get("limit", [str(len(nodes) or 1)])[0])
    start = int(q.get("continue", ["0"])[0])
    if requests_seen is not None:
        requests_seen.append(start)
    if page_cache is not None:
        cached = page_cache.get((start, limit))
        if cached is not None:
            return cached
    doc = {"kind": "NodeList", "items": nodes[start:start + limit]}
    meta = {}
    if start + limit < len(nodes):
        meta["continue"] = str(start + limit)
    if resource_version is not None:
        meta["resourceVersion"] = str(resource_version)
    if meta:
        doc["metadata"] = meta
    body = _json.dumps(doc).encode()
    if page_cache is not None:
        page_cache[(start, limit)] = body
    return body


def serve_scripted_fault(handler, schedule: FaultSchedule, ok_body_fn) -> bool:
    """Front one request with the schedule's next fault spec — the ONE
    interpreter of the fault grammar documented on :class:`FaultSchedule`
    (:func:`fault_scheduled_handler` and :func:`storm_apiserver` both
    route through it, so the two servers can never drift onto different
    fault semantics).

    Returns True when the request was consumed by an injected fault;
    ``"ok"`` returns False and the caller serves its healthy response.
    ``ok_body_fn`` lazily supplies the healthy body for the faults that
    need real bytes to corrupt (``mid_body_reset``, ``slow``).
    """
    import socket as _socket

    fault = schedule.next()
    kind, _, arg = fault.partition(":")
    if kind == "ok":
        return False

    def respond(status: int, body: bytes, extra=None) -> None:
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)

    def rst() -> None:
        # RST instead of FIN: connection reset by peer, no response.
        handler.connection.setsockopt(
            _socket.SOL_SOCKET, _socket.SO_LINGER,
            b"\x01\x00\x00\x00\x00\x00\x00\x00",
        )
        handler.connection.close()
        handler.close_connection = True

    if kind in ("500", "502", "503", "504", "429"):
        respond(
            int(kind),
            b'{"kind":"Status","message":"injected transient fault"}',
            {"Retry-After": arg} if arg else None,
        )
    elif kind == "reset":
        rst()
    elif kind == "close":
        handler.close_connection = True  # FIN without a response
    elif kind == "mid_body_reset":
        body = ok_body_fn()
        handler.send_response(200)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body[: len(body) // 2])
        handler.wfile.flush()
        rst()
    elif kind == "garbage_json":
        respond(200, b"<html>proxy error</html>")
    elif kind == "slow":
        body = ok_body_fn()
        handler.send_response(200)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body[:1])
        handler.wfile.flush()
        # The stall rides the schedule's injectable clock: virtual (free)
        # under a SimClock, real-but-interruptible otherwise.
        schedule.pace(float(arg or 10))
    else:
        raise AssertionError(f"unknown fault spec {fault!r}")
    return True


def fault_scheduled_handler(
    nodes: List[dict],
    schedule: FaultSchedule,
    requests_seen: Optional[list] = None,
    patches_seen: Optional[list] = None,
):
    """Paged-NodeList handler with a :class:`FaultSchedule` in front.

    Healthy requests serve ``nodes`` through :func:`paged_nodelist_body`
    (the same ``limit``/``continue`` pagination as
    :func:`paged_nodelist_handler`); PATCHes (recorded in ``patches_seen``
    as ``(path, body_bytes)``) answer ``{}``.  Every arriving request —
    method, path, retry or not — consumes one schedule entry, so a
    schedule's length IS the server-side request count the non-duplication
    tests pin.
    """
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _serve(self, ok_body: bytes):
            if serve_scripted_fault(self, schedule, lambda: ok_body):
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(ok_body)))
            self.end_headers()
            self.wfile.write(ok_body)

        def do_GET(self):
            self._serve(paged_nodelist_body(nodes, self.path, requests_seen))

        def do_PATCH(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if patches_seen is not None:
                patches_seen.append((self.path, body))
            self._serve(b"{}")

        def log_message(self, *args):
            pass

    return Handler


def watch_event(etype: str, obj: dict, resource_version: Optional[str] = None) -> dict:
    """One watch frame: ``{"type": ..., "object": ...}``, optionally
    stamping a ``resourceVersion`` onto the object's metadata (copied — the
    caller's node dict is not mutated)."""
    import copy

    obj = copy.deepcopy(obj)
    if resource_version is not None:
        obj.setdefault("metadata", {})["resourceVersion"] = str(resource_version)
    return {"type": etype, "object": obj}


def watch_bookmark(resource_version: str) -> dict:
    return {
        "type": "BOOKMARK",
        "object": {"metadata": {"resourceVersion": str(resource_version)}},
    }


def watch_error_gone() -> dict:
    """The in-band 410 replay: the ERROR Status frame an apiserver streams
    when the requested resourceVersion expired under an open watch."""
    return {
        "type": "ERROR",
        "object": {
            "kind": "Status",
            "code": 410,
            "reason": "Expired",
            "message": "too old resource version",
        },
    }


class WatchScript:
    """Scripted fake watch endpoint: one stanza per watch CONNECTION.

    Each arriving ``?watch=1`` request consumes the next stanza; when the
    list is exhausted, further connections get ``{"live": True}`` (an
    open stream fed by :meth:`push`).  Stanza keys:

    * ``"status"``: int — answer that HTTP status (410 for Gone) with a
      small Status body instead of streaming;
    * ``"events"``: list of event dicts — streamed as one chunked JSON
      frame each (use :func:`watch_event` / :func:`watch_bookmark` /
      :func:`watch_error_gone` to build them);
    * ``"frame_delay"``: seconds between frames (slow-drip stream; paced
      through the injectable clock — interruptible for real, free under a
      ``SimClock``);
    * ``"live"``: True — after any scripted ``events``, keep the stream
      open and relay whatever :meth:`push` feeds, until ``push(None)``;
    * ``"end"``: ``"close"`` (default — finish the chunked body cleanly:
      the client sees a server-side stream end) or ``"reset"`` (RST the
      socket mid-stream: an abrupt disconnect).

    ``connections`` counts watch connects (the relist/reconnect ground
    truth beside ``list_requests``); ``close()`` releases any live stream
    so fixture servers shut down promptly.
    """

    def __init__(self, stanzas: Optional[List[dict]] = None, clock=None):
        import queue
        import threading

        self._stanzas = list(stanzas or [])
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self._shutdown = threading.Event()
        self.clock = clock if clock is not None else WallClock(self._shutdown)
        self.connections = 0

    def next_stanza(self) -> dict:
        with self._lock:
            self.connections += 1
            return self._stanzas.pop(0) if self._stanzas else {"live": True}

    def push(self, event: Optional[dict]) -> None:
        """Feed one event to the current live stream; ``None`` ends it."""
        self._queue.put(event)

    def close(self) -> None:
        self._shutdown.set()
        self._queue.put(None)

    # -- handler side --------------------------------------------------------

    def pace(self, seconds: float) -> None:
        """Inter-frame delay via the injectable clock (the default
        ``WallClock`` waits on the shutdown event, so teardown interrupts)."""
        if seconds:
            self.clock.sleep(seconds)

    def next_live_event(self, timeout: float = 30.0) -> Optional[dict]:
        import queue as _queue

        if self._shutdown.is_set():
            return None
        try:
            return self._queue.get(timeout=timeout)
        except _queue.Empty:
            return None


def watch_nodelist_handler(
    nodes: List[dict],
    script: WatchScript,
    resource_version: str = "1000",
    list_requests: Optional[list] = None,
    page_cache: Optional[dict] = None,
):
    """Fake apiserver speaking BOTH halves of the watch-stream protocol.

    ``GET /api/v1/nodes`` without ``watch`` serves the paged LIST (shared
    ``limit``/``continue`` protocol, ``resourceVersion`` in the metadata);
    with ``watch=1`` the :class:`WatchScript`'s next stanza decides what the
    stream does — chunked JSON event frames, a 410, a mid-stream reset, a
    slow drip, or a live push-fed stream.  ``list_requests`` records each
    LIST page's start offset: its growth is the fixture-side proof of when
    full relists actually happened.
    """
    import json as _json
    import socket as _socket
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        def _end_chunks(self) -> None:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def _rst(self) -> None:
            self.connection.setsockopt(
                _socket.SOL_SOCKET, _socket.SO_LINGER,
                b"\x01\x00\x00\x00\x00\x00\x00\x00",
            )
            self.connection.close()
            self.close_connection = True

        def _serve_watch(self) -> None:
            stanza = script.next_stanza()
            status = stanza.get("status")
            if status:
                body = _json.dumps(
                    {"kind": "Status", "code": status, "reason": "Expired"}
                ).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            delay = stanza.get("frame_delay") or 0.0
            try:
                for event in stanza.get("events") or []:
                    script.pace(delay)
                    self._chunk(_json.dumps(event).encode() + b"\n")
                if stanza.get("live"):
                    while True:
                        event = script.next_live_event()
                        if event is None:
                            break
                        script.pace(delay)
                        self._chunk(_json.dumps(event).encode() + b"\n")
                if stanza.get("end") == "reset":
                    self._rst()
                    return
                self._end_chunks()
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True  # client hung up mid-stream

        def do_GET(self):
            q = parse_qs(urlparse(self.path).query)
            if q.get("watch"):
                self._serve_watch()
                return
            body = paged_nodelist_body(
                nodes, self.path, list_requests,
                resource_version=resource_version, page_cache=page_cache,
            )
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return Handler


def paged_nodelist_handler(nodes: List[dict], requests_seen: Optional[list] = None,
                           page_cache: Optional[dict] = None):
    """Handler class serving ``nodes`` as a NodeList with ``limit``/
    ``continue`` pagination — the paging semantics live in
    :func:`paged_nodelist_body` (shared with the fault-injecting handler),
    used by the pagination tests and ``bench.py``'s 5k-node run.
    ``requests_seen`` (optional list) records each request's start offset;
    ``page_cache`` (caller-owned, see :func:`paged_nodelist_body`) keeps
    the fixture's per-request serialization out of bench-measured walks."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so the checker's keep-alive pool can actually reuse the
        # connection across pages (1.0 closes per request); every response
        # carries Content-Length, which 1.1 keep-alive requires.
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            body = paged_nodelist_body(nodes, self.path, requests_seen,
                                       page_cache=page_cache)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return Handler


# ---------------------------------------------------------------------------
# Mass-failure storm harness (the remediation budget engine's acceptance
# surface — DESIGN.md §17, now a chaos-scenario building block).
# Deterministic by seed, replayable, driven against REAL checker rounds and
# a REAL fixture apiserver whose request log is the ground truth the storm
# invariants are asserted on.
# ---------------------------------------------------------------------------


def churn_flips(seed: int, nodes: int, rounds: int,
                fraction: float = 0.01) -> List[frozenset]:
    """Seeded churn-load plan for the watch-feed / federation tiers: one
    frozenset of node indices to flip per round (never empty — a churn
    round must change SOMETHING, or the publish dedups to a heartbeat and
    the load plan silently thins).  Same seed ⇒ same plan, so a hammer
    run or bench round that tore a frame replays exactly.
    """
    import random

    rng = random.Random(seed)
    k = max(1, int(nodes * fraction))
    return [frozenset(rng.sample(range(nodes), k)) for _ in range(rounds)]


class StormSchedule:
    """Seeded mass-failure + flap storm over a multi-slice TPU fleet.

    The fleet: ``slices`` multi-host slices of ``hosts_per_slice`` hosts ×
    ``chips_per_host`` chips (topology label = the full slice, so every
    slice is one failure domain).  The script:

    * at ``fail_round``, ``fail_fraction`` of each slice's hosts fail
      SIMULTANEOUSLY (probe verdict false) and stay failed — the mass
      storm a blind per-cluster cordon cap turns into self-inflicted
      capacity loss;
    * ``flappers_per_slice`` additional hosts flip verdict every round
      from round 0 — the churn the hysteresis/flap layers absorb.

    Same seed ⇒ same fleet, same failed sets, same flappers: a failing
    acceptance run replays exactly.
    """

    def __init__(self, seed: int = 0, slices: int = 2,
                 hosts_per_slice: int = 4, chips_per_host: int = 4,
                 fail_round: int = 1, fail_fraction: float = 0.75,
                 flappers_per_slice: int = 1, name_prefix: str = "storm"):
        import random

        rng = random.Random(seed)
        self.seed = seed
        self.fail_round = fail_round
        self.chips_per_host = chips_per_host
        self.topology = f"{chips_per_host}x{hosts_per_slice}"
        self.name_prefix = name_prefix
        self.by_slice: dict = {}
        self.failed: set = set()
        self.flappers: set = set()
        for s in range(slices):
            hosts = [f"{name_prefix}-s{s}-h{h}" for h in range(hosts_per_slice)]
            self.by_slice[f"{name_prefix}-pool-{s}"] = hosts
            n_fail = max(1, int(round(fail_fraction * len(hosts))))
            failed = rng.sample(hosts, n_fail)
            self.failed.update(failed)
            healthy = [h for h in hosts if h not in failed]
            self.flappers.update(
                rng.sample(healthy, min(flappers_per_slice, len(healthy)))
            )

    def node_names(self) -> list:
        return [h for hosts in self.by_slice.values() for h in hosts]

    def nodes(self) -> list:
        """The fleet as raw node dicts (one nodepool + topology per slice:
        each slice is one failure domain under ``slice_group_key``)."""
        out = []
        for pool, hosts in sorted(self.by_slice.items()):
            for name in hosts:
                out.append(make_node(
                    name,
                    allocatable={"google.com/tpu": str(self.chips_per_host)},
                    labels={
                        "cloud.google.com/gke-tpu-accelerator":
                            "tpu-v5p-slice",
                        "cloud.google.com/gke-tpu-topology": self.topology,
                        "cloud.google.com/gke-nodepool": pool,
                    },
                    taints=[TPU_TAINT],
                ))
        return out

    def verdicts(self, round_i: int) -> dict:
        """Per-host probe verdicts for one storm round."""
        out = {}
        for name in self.node_names():
            ok = True
            if name in self.failed and round_i >= self.fail_round:
                ok = False
            elif name in self.flappers:
                ok = round_i % 2 == 0
            out[name] = ok
        return out


def storm_apiserver(nodes: list, pods_by_node: Optional[dict] = None,
                    pdb_protected: Optional[set] = None,
                    schedule: Optional[FaultSchedule] = None):
    """A fixture apiserver whose REQUEST LOG is the storm's ground truth.

    Serves the (mutable) node list with the shared paging protocol,
    APPLIES cordon/uncordon PATCHes to it (so the next round's LIST — and
    the budget engine's already-cordoned math — sees prior actuations,
    exactly like a real apiserver), serves per-node pod lists, and answers
    Eviction POSTs (429 for ``pdb_protected`` pods — the PDB refusal).
    Returns ``(server, state)``; ``state["patches"]``/``state["evictions"]``
    count actuations SERVER-SIDE — the acceptance invariants are asserted
    on what the cluster actually received, never on the checker's
    self-report.

    ``schedule`` (or a later ``state["schedule"] = FaultSchedule(...)``
    swap — chaos scenarios re-script faults at round boundaries) puts a
    :class:`FaultSchedule` in front of every request, interpreted by the
    same :func:`serve_scripted_fault` grammar as
    :func:`fault_scheduled_handler`: API brownouts over the same server
    whose node state carries the storm.
    """
    import json as _json
    import re as _re
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    state = {
        "nodes": nodes,
        "patches": [],
        "evictions": [],
        "pods_by_node": pods_by_node or {},
        "pdb_protected": set(pdb_protected or ()),
        "schedule": schedule,
    }
    evict_re = _re.compile(
        r"^/api/v1/namespaces/([^/]+)/pods/([^/]+)/eviction$"
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, status: int, body: bytes):
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _faulted(self) -> bool:
            """Consult the fault front; True when this request was consumed
            by an injected fault instead of its healthy handler."""
            sched = state.get("schedule")
            if sched is None:
                return False
            # Faults that corrupt real bytes (mid_body_reset, slow) get the
            # node LIST body — the storm server's hot healthy response.
            return serve_scripted_fault(
                self, sched,
                lambda: paged_nodelist_body(
                    state["nodes"], self.path, None, resource_version="1"
                ),
            )

        def do_GET(self):
            if self._faulted():
                return
            parsed = urlparse(self.path)
            if parsed.path == "/api/v1/nodes":
                self._reply(200, paged_nodelist_body(
                    state["nodes"], self.path, None, resource_version="1"
                ))
                return
            if parsed.path == "/api/v1/pods":
                q = parse_qs(parsed.query)
                selector = (q.get("fieldSelector") or [""])[0]
                node = selector.rpartition("spec.nodeName=")[2]
                items = state["pods_by_node"].get(node, [])
                self._reply(200, _json.dumps(
                    {"kind": "PodList", "items": items}
                ).encode())
                return
            self._reply(200, b'{"kind": "List", "items": []}')

        def do_PATCH(self):
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            if self._faulted():
                return
            body = _json.loads(raw)
            name = self.path.rpartition("/")[2]
            state["patches"].append({"node": name, "body": body})
            for node in state["nodes"]:
                if node["metadata"]["name"] != name:
                    continue
                spec = body.get("spec") or {}
                if "unschedulable" in spec:
                    if spec["unschedulable"]:
                        node["spec"]["unschedulable"] = True
                    else:
                        node["spec"].pop("unschedulable", None)
                annotations = (body.get("metadata") or {}).get("annotations")
                if annotations:
                    merged = node["metadata"].setdefault("annotations", {})
                    for key, value in annotations.items():
                        if value is None:  # strategic-merge null = delete
                            merged.pop(key, None)
                        else:
                            merged[key] = value
            self._reply(200, b"{}")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            self.rfile.read(length)
            if self._faulted():
                return
            m = evict_re.match(urlparse(self.path).path)
            if not m:
                self._reply(404, b'{"error": "not found"}')
                return
            namespace, pod = m.group(1), m.group(2)
            if pod in state["pdb_protected"]:
                # The Eviction API's PDB refusal: 429 Too Many Requests.
                self._reply(429, _json.dumps({
                    "kind": "Status", "status": "Failure",
                    "reason": "TooManyRequests",
                    "message": "Cannot evict pod as it would violate the "
                               "pod's disruption budget.",
                }).encode())
                return
            state["evictions"].append(
                {"namespace": namespace, "pod": pod}
            )
            self._reply(201, b'{"kind": "Status", "status": "Success"}')

        def log_message(self, *args):
            pass

    return serve_http(Handler), state


def available_by_slice(by_slice: dict, chips_per_host: int,
                       nodes: list) -> dict:
    """Per-slice AVAILABLE chips from the apiserver's live node state —
    the slice-floor invariant's ground truth (cordoned = out of the
    pool).  ONE definition shared by the storm tests and the chaos
    scenarios, so the floor can never be graded against two realities."""
    cordoned = {
        n["metadata"]["name"]
        for n in nodes
        if n["spec"].get("unschedulable")
    }
    return {
        pool: chips_per_host * sum(1 for h in hosts if h not in cordoned)
        for pool, hosts in by_slice.items()
    }


def storm_available_by_slice(schedule: StormSchedule, nodes: list) -> dict:
    """:func:`available_by_slice` over a :class:`StormSchedule`'s fleet."""
    return available_by_slice(
        schedule.by_slice, schedule.chips_per_host, nodes
    )
