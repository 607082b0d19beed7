"""Multi-worker fleet-API serving (``--serve-workers``): N accept loops on
one port.

A copy of the JAX package's ``server/workers.py``, held equal to it by
``tests/test_torch_copies.py``.  :class:`WorkerPool` binds N listeners to one
port with ``SO_REUSEPORT`` (one listener where the option is missing); the
hot read endpoints' wire responses are prebuilt once per publish and served
from a table keyed on the request line; everything else takes the routed
fallback through :func:`~tpu_node_checker_torch.server.router.route_request`;
past a per-worker connection cap a new connection gets 503 and is closed.
"""

from __future__ import annotations

import http.client
import socket
import sys
import threading
from typing import Dict, Optional, Tuple

from tpu_node_checker_torch.server.router import (
    Response,
    _etag_matches,
    route_request,
)

# A slow-loris connection may trickle bytes forever; recv() is bounded by
# this idle timeout (same bound RoutedHandler.timeout applies).
DEFAULT_IDLE_TIMEOUT_S = 10.0
# Handler threads a single worker will dedicate to open connections; past
# this, new connections are shed with a fast 503 instead of queued.
DEFAULT_MAX_CONNECTIONS = 128

# Bounds mirrored from the routed stack: a request head larger than this is
# abuse (http.server's own line limit is 65536), and write bodies cap at
# 1 MiB (control-plane requests are tiny JSON).
_MAX_HEAD_BYTES = 65536
_BODY_CAP = 1 << 20
_RECV_SIZE = 1 << 18

_RESP_431 = (
    b"HTTP/1.1 431 Request Header Fields Too Large\r\n"
    b"Connection: close\r\nContent-Length: 0\r\n\r\n"
)
_RESP_400 = (
    b"HTTP/1.1 400 Bad Request\r\nConnection: close\r\nContent-Length: 0\r\n\r\n"
)
_RESP_503_SHED = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Connection: close\r\nRetry-After: 1\r\nContent-Length: 0\r\n\r\n"
)

_REASONS = http.client.responses


def reuseport_available() -> bool:
    """True when this platform exposes ``SO_REUSEPORT`` (Linux, BSDs)."""
    return hasattr(socket, "SO_REUSEPORT")


class FastRoute:
    """One hot path's prebuilt wire responses: 304 / 200 / 200+gzip.

    Everything a poller round-trip needs is bytes computed at publish time;
    request handling only chooses which bytes to append to the output
    buffer.  Immutable after construction — the pool swaps whole tables,
    never edits one in place (same discipline as the snapshot swap).
    """

    __slots__ = ("pattern", "etag", "etag_str", "resp_304", "head_200",
                 "body", "head_gz", "body_gz")

    def __init__(self, pattern: str, entity,
                 extra_headers: Optional[Dict[str, str]] = None):
        self.pattern = pattern
        self.etag_str = entity.etag
        self.etag = entity.etag.encode("latin-1")
        base = (
            f"ETag: {entity.etag}\r\n"
            "Vary: Accept-Encoding\r\n"
            "Cache-Control: no-cache\r\n"
            f"Content-Type: {entity.content_type}\r\n"
        )
        # Publish-time constants (the round/trace identity headers): baked
        # into every variant, 304 included, so the fast path matches the
        # routed path's headers byte-for-semantics.
        for key, value in (extra_headers or {}).items():
            base += f"{key}: {value}\r\n"
        self.resp_304 = (
            "HTTP/1.1 304 Not Modified\r\n" + base + "Content-Length: 0\r\n\r\n"
        ).encode("latin-1")
        self.head_200 = (
            "HTTP/1.1 200 OK\r\n" + base
            + f"Content-Length: {len(entity.raw)}\r\n\r\n"
        ).encode("latin-1")
        self.body = entity.raw
        if entity.gz is not None:
            self.head_gz = (
                "HTTP/1.1 200 OK\r\n" + base
                + "Content-Encoding: gzip\r\n"
                + f"Content-Length: {len(entity.gz)}\r\n\r\n"
            ).encode("latin-1")
            self.body_gz = entity.gz
        else:
            self.head_gz = None
            self.body_gz = None


def build_fast_routes(
    entities: Dict[str, object],
    extra_headers: Optional[Dict[str, str]] = None,
) -> Dict[bytes, FastRoute]:
    """``{path: Entity}`` → the request-line-keyed fast table.

    Only plain HTTP/1.1 GETs with no query string can match (the key is the
    exact request line); every other shape falls through to the routed
    stack, so the fast table can stay this simple.  ``extra_headers``
    (round/trace identity) are baked into every prebuilt response.
    """
    table: Dict[bytes, FastRoute] = {}
    for path, entity in entities.items():
        table[b"GET " + path.encode("latin-1") + b" HTTP/1.1"] = FastRoute(
            path, entity, extra_headers
        )
    return table


def _header_value(head: bytes, lower: bytes, name: bytes) -> Optional[bytes]:
    """Value of header ``name`` (b"\\r\\nif-none-match:") or None.

    ``lower`` is ``head.lower()`` — found offsets index into the original
    ``head`` so values keep their case (ETags are case-sensitive).
    """
    i = lower.find(name)
    if i == -1:
        return None
    start = i + len(name)
    end = lower.find(b"\r\n", start)
    if end == -1:
        end = len(head)
    return head[start:end].strip()


def _respond_fast(route: FastRoute, head: bytes, lower: bytes,
                  out: bytearray) -> Tuple[int, bool]:
    """The read path proper: pick the prebuilt response for this request.

    Pure byte work — no locks, no I/O, no allocation beyond header slices
    (TNC011-scanned).  Returns ``(status, close_connection)``.
    """
    conn_v = _header_value(head, lower, b"\r\nconnection:")
    close = conn_v is not None and b"close" in conn_v.lower()
    inm = _header_value(head, lower, b"\r\nif-none-match:")
    if inm is not None and (
        inm == route.etag
        or _etag_matches(inm.decode("latin-1"), route.etag_str)
    ):
        out += route.resp_304
        return 304, close
    if route.head_gz is not None:
        ae = _header_value(head, lower, b"\r\naccept-encoding:")
        if ae is not None and b"gzip" in ae.lower():
            out += route.head_gz
            out += route.body_gz
            return 200, close
    out += route.head_200
    out += route.body
    return 200, close


class _LowerHeaders:
    """Case-insensitive ``get`` over lowercased header keys — the only
    surface route handlers use (parity with http.client's HTTPMessage)."""

    __slots__ = ("_h",)

    def __init__(self, pairs: Dict[str, str]):
        self._h = pairs

    def get(self, name: str, default=None):
        return self._h.get(name.lower(), default)


def _parse_fallback_head(head: bytes):
    """Request head → (method, target, version, headers) for the routed
    stack; None when the request line is malformed."""
    lines = head.split(b"\r\n")
    parts = lines[0].split()
    if len(parts) != 3:
        return None
    pairs: Dict[str, str] = {}
    for raw in lines[1:]:
        key, sep, value = raw.partition(b":")
        if sep:
            pairs[key.strip().lower().decode("latin-1")] = value.strip().decode(
                "latin-1"
            )
    method, target, version = (p.decode("latin-1") for p in parts)
    return method, target, version, _LowerHeaders(pairs)


def _serialize_response(response: Response, head_only: bool,
                        close: bool, out: bytearray) -> None:
    """One routed :class:`Response` → wire bytes (parity with
    ``RoutedHandler._send``: default Content-Type, HEAD carries the GET's
    Content-Length with no body, 304 has zero body bytes)."""
    headers = dict(response.headers)
    headers.setdefault("Content-Type", "application/json; charset=utf-8")
    head = [f"HTTP/1.1 {response.status} {_REASONS.get(response.status, '')}"]
    for key, value in headers.items():
        head.append(f"{key}: {value}")
    head.append(f"Content-Length: {len(response.body)}")
    if close:
        head.append("Connection: close")
    out += ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
    if not head_only and response.status != 304 and response.body:
        out += response.body


def _serve_connection(app, conn, addr, idle_timeout: float) -> None:
    """One keep-alive connection's life: parse → respond → batch-flush.

    Requests already buffered are answered into ``out`` and flushed in one
    ``sendall`` when the input runs dry — pipelined pollers amortize their
    syscalls, request/response pollers flush per request.  Fast-path hits
    are counted locally and merged into the shared stats at each flush
    (BEFORE the bytes go out, so a scrape races no counts).
    """
    remote = addr[0] if isinstance(addr, tuple) else str(addr)
    buf = b""
    out = bytearray()
    fast_counts: Dict[Tuple[str, int], int] = {}
    close = False
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(idle_timeout)
        while not close:
            end = buf.find(b"\r\n\r\n")
            if end == -1:
                if len(buf) > _MAX_HEAD_BYTES:
                    out += _RESP_431
                    break
                if out:
                    _flush(app, conn, out, fast_counts)
                data = conn.recv(_RECV_SIZE)
                if not data:
                    break
                buf = buf + data if buf else data
                continue
            head = buf[:end]
            buf = buf[end + 4:]
            line_end = head.find(b"\r\n")
            line = head if line_end == -1 else head[:line_end]
            route = app.fast_routes.get(line)
            if route is not None:
                status, close = _respond_fast(route, head, head.lower(), out)
                key = (route.pattern, status)
                fast_counts[key] = fast_counts.get(key, 0) + 1
                continue
            parsed = _parse_fallback_head(head)
            if parsed is None:
                out += _RESP_400
                break
            if out and line.startswith(b"GET /api/v1/watch"):
                # The watch feed long-polls: its handler may park this
                # thread for seconds, and responses already batched for
                # pipelined requests must not wait behind it.
                _flush(app, conn, out, fast_counts)
            buf, close = _respond_routed(app, conn, parsed, buf, remote, out)
        if out:
            _flush(app, conn, out, fast_counts)
    except OSError:
        pass  # peer hung up / idle timeout: its problem, not a log line
    finally:
        if fast_counts:
            app.count_fast(fast_counts)
        try:
            conn.close()
        except OSError:
            pass


def _respond_routed(app, conn, parsed, buf: bytes, remote: str,
                    out: bytearray):
    """The non-fast shapes (POST control, HEAD, per-node GETs, query
    strings, scrapes) through the shared router core.  Returns the
    remaining input buffer and whether the connection must close."""
    import time as _time

    method, target, version, headers = parsed
    close = version != "HTTP/1.1"
    if (headers.get("Connection") or "").lower() == "close":
        close = True
    body = b""
    if method in ("POST", "PUT"):
        # Drain the body BEFORE answering, routed or not (the keep-alive
        # framing rule RoutedHandler._dispatch documents).
        try:
            length = int(headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        # Clamp below at 0 (parity with RoutedHandler._read_body): a
        # negative length must read nothing, not slice buffered pipelined
        # bytes off the END of the buffer and desync the framing.
        length = max(0, length)
        want = min(length, _BODY_CAP)
        if length > _BODY_CAP:
            close = True  # the unread remainder would desync framing
        while len(buf) < want:
            data = conn.recv(_RECV_SIZE)
            if not data:
                close = True
                break
            buf += data
        body, buf = buf[:want], buf[want:]
    t0 = _time.monotonic()
    status, pattern = 500, "(unmatched)"
    app.track_in_flight(+1)
    try:
        response, pattern = route_request(
            app.router, method, target, headers, body, remote
        )
        status = response.status
        _serialize_response(response, method == "HEAD", close, out)
    finally:
        app.track_in_flight(-1)
        app.observe(method, pattern, status, (_time.monotonic() - t0) * 1e3)
    return buf, close


def _flush(app, conn, out: bytearray, fast_counts: dict) -> None:
    """Commit batched stats, then ship the batched responses."""
    if fast_counts:
        app.count_fast(fast_counts)
        fast_counts.clear()
    conn.sendall(out)
    del out[:]


class _Worker:
    """One accept loop: a listener socket, its thread, and the registry of
    connections it has handed to handler threads (for the shed guard and
    for force-closing on restart/close)."""

    def __init__(self, pool: "WorkerPool", sock: socket.socket, index: int):
        self.pool = pool
        self.sock = sock
        self.index = index
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self.thread = threading.Thread(
            target=self._accept_loop,
            name=f"tnc-fleet-worker-{index}",
            daemon=True,
        )
        self.thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self.sock.accept()
            except OSError:
                return  # listener closed: the worker is done
            with self._conn_lock:
                over = 0 < self.pool.max_connections <= len(self._conns)
                if not over:
                    self._conns.add(conn)
            if over:
                self._shed(conn)
                continue
            threading.Thread(
                target=self._run_connection,
                args=(conn, addr),
                name=f"tnc-fleet-conn-{self.index}",
                daemon=True,
            ).start()

    @staticmethod
    def _shed(conn) -> None:
        """Over the cap: answer 503 from the accept loop and hang up — a
        slow-loris pool must not pin handler threads to earn its denial."""
        try:
            conn.settimeout(1.0)
            conn.sendall(_RESP_503_SHED)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _run_connection(self, conn, addr) -> None:
        try:
            _serve_connection(self.pool.app, conn, addr, self.pool.idle_timeout)
        except Exception as exc:  # tnc: allow-broad-except(a handler bug must not kill the connection thread silently — the death is recorded with its reason, the socket still closed, and the server keeps serving every other connection)
            print(
                f"fleet-server: connection from {addr!r} died: "
                f"{type(exc).__name__}: {exc}",
                file=sys.stderr,
            )
            try:
                conn.close()
            except OSError:
                pass
        finally:
            with self._conn_lock:
                self._conns.discard(conn)

    def close(self) -> None:
        # shutdown() BEFORE close(): the accept thread is blocked inside
        # accept(2), which pins the open file description — a bare close()
        # would leave the kernel's listen queue alive (and connects
        # succeeding) until the next accept returned.  shutdown wakes the
        # accept with an error and tears the queue down now.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


class WorkerPool:
    """N accept loops sharing one port (``SO_REUSEPORT``), or one loop
    where the option is unavailable.

    ``app`` is the serving seam (duck-typed; :class:`FleetStateServer` in
    production): ``fast_routes`` (atomic dict reference), ``router``,
    ``observe``/``track_in_flight``/``count_fast`` stats hooks.
    """

    def __init__(self, host: str, port: int, app, workers: int = 1,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 idle_timeout: float = DEFAULT_IDLE_TIMEOUT_S):
        self.app = app
        self.max_connections = max_connections
        self.idle_timeout = idle_timeout
        self.requested_workers = max(1, int(workers))
        self.reuseport = self.requested_workers > 1 and reuseport_available()
        self._host = host
        self._lock = threading.Lock()  # guards the worker list (control ops)
        first = self._bind(host, port)
        self.port = first.getsockname()[1]
        self._workers = [_Worker(self, first, 0)]
        if self.reuseport:
            for i in range(1, self.requested_workers):
                try:
                    sock = self._bind(host, self.port)
                except OSError:
                    break  # serve with what bound; the gauge tells the truth
                self._workers.append(_Worker(self, sock, i))

    def _bind(self, host: str, port: int) -> socket.socket:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.reuseport:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(128)
        return sock

    @property
    def workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def restart(self, index: int) -> None:
        """Replace one worker's listener (and force its connections to
        redial).  With ``SO_REUSEPORT`` the replacement binds BEFORE the
        old listener closes — a rolling restart never refuses a dial."""
        with self._lock:
            old = self._workers[index]
            if self.reuseport:
                sock = self._bind(self._host, self.port)
                self._workers[index] = _Worker(self, sock, index)
                old.close()
            else:
                old.close()
                sock = self._bind(self._host, self.port)
                self._workers[index] = _Worker(self, sock, index)

    def close(self) -> None:
        with self._lock:
            workers = list(self._workers)
            self._workers = []
        for worker in workers:
            worker.close()
