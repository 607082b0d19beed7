"""Minimal HTTP routing and conditional/encoding negotiation, stdlib only.

A copy of the JAX package's ``server/router.py``, held equal to it by
``tests/test_torch_copies.py``.  Both embedded HTTP surfaces (the
``--metrics-port`` scrape and the ``--serve`` fleet API) route through it:
unknown paths answer 404, a known path with the wrong method 405 with
``Allow``; HEAD is served from GET without a body; a strong ETag matched by
``If-None-Match`` answers 304 and ``Accept-Encoding: gzip`` gets the
pre-compressed variant.  Path segments are split on ``/`` first and then
percent-decoded once each.
"""

from __future__ import annotations

import gzip as _gzip
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple


class Request:
    """What a handler sees: method, path, captures, query, headers, body."""

    __slots__ = ("method", "path", "params", "query", "headers", "body", "remote")

    def __init__(self, method, path, params, query, headers, body, remote):
        self.method = method
        self.path = path
        self.params = params
        self.query = query
        self.headers = headers
        self.body = body
        self.remote = remote


class Response:
    """status + raw body bytes + extra headers (Content-Length is implied)."""

    __slots__ = ("status", "body", "headers")

    def __init__(self, status: int, body: bytes = b"", headers: Optional[dict] = None):
        self.status = status
        self.body = body
        self.headers = headers or {}


def json_response(status: int, obj) -> Response:
    import json

    return Response(
        status,
        (json.dumps(obj, ensure_ascii=False) + "\n").encode("utf-8"),
        {"Content-Type": "application/json; charset=utf-8"},
    )


def _etag_matches(if_none_match: str, etag: str) -> bool:
    """RFC 7232 ``If-None-Match`` evaluation against one strong ETag.

    ``*`` matches any current representation; otherwise the header is a
    comma-separated list of (possibly ``W/``-prefixed) entity tags, compared
    WEAKLY — the weak comparison is what the RFC specifies for
    ``If-None-Match``, and our tags are strong, so stripping ``W/`` is safe.
    """
    if if_none_match.strip() == "*":
        return True
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


def negotiate(entity, headers, status: int = 200) -> Response:
    """One pre-serialized entity → the right wire response for this request.

    * ``If-None-Match`` hit → **304** with the ETag and zero body bytes —
      the cached path every poller after the first round rides;
    * ``Accept-Encoding: gzip`` → the entity's pre-compressed variant (when
      one exists and actually saved bytes) with ``Content-Encoding: gzip``;
    * always: strong ``ETag`` + ``Vary: Accept-Encoding`` + ``Cache-Control:
      no-cache`` (clients MUST revalidate — the 304 is the cheap path, a
      stale-for-60s snapshot is not acceptable for scheduler gates).
    """
    base = {
        "ETag": entity.etag,
        "Vary": "Accept-Encoding",
        "Cache-Control": "no-cache",
    }
    inm = headers.get("If-None-Match")
    if status == 200 and inm and _etag_matches(inm, entity.etag):
        return Response(304, b"", base)
    body = entity.raw
    out = dict(base)
    out["Content-Type"] = entity.content_type
    accept = (headers.get("Accept-Encoding") or "").lower()
    if entity.gz is not None and "gzip" in accept:
        body = entity.gz
        out["Content-Encoding"] = "gzip"
    return Response(status, body, out)


def gunzip(data: bytes) -> bytes:
    """Test/debug helper: undo :func:`negotiate`'s gzip variant."""
    return _gzip.decompress(data)


def split_path_segments(path: str) -> List[str]:
    """A raw request path → its percent-DECODED segments, decoding applied
    exactly once per segment AFTER the split on literal ``/``.

    This is the one normalization point both matching sides share: static
    route segments compare against decoded text, and ``{name}`` captures
    are the decoded segment verbatim — so ``a%2Fb`` reaches a handler as
    ``a/b`` while ``/a/b`` stays two segments.  Before this, static
    segments compared ENCODED while captures decoded, so
    ``/api/v1/nodes/a%2Fb`` and ``/api/v1/%6Eodes/x`` resolved by two
    different rules (the ambiguity the ``cluster/node`` key shape cannot
    live with).
    """
    return [urllib.parse.unquote(s) for s in path.split("/") if s]


def route_request(router: "Router", method: str, target: str, headers,
                  body: bytes, remote: str) -> Tuple[Response, str]:
    """The dispatch core both HTTP stacks share → ``(response, pattern)``.

    :class:`RoutedHandler` (the ``--metrics-port`` surface) and the
    fleet-API worker pool's fallback path
    (:mod:`~tpu_node_checker_torch.server.workers`) parse bytes differently but
    MUST route identically — query parsing, 404/405 shapes, the handler
    try/except — so that logic lives here exactly once.  ``pattern`` is
    the matched route pattern (``"(unmatched)"`` for 404/405), the label
    request metrics key on.
    """
    parsed = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parsed.query)) if parsed.query else {}
    resolved = router.resolve(method, parsed.path)
    if isinstance(resolved, Response):
        return resolved, "(unmatched)"
    handler, params, pattern = resolved
    request = Request(method, parsed.path, params, query, headers, body, remote)
    try:
        response = handler(request)
    except Exception as exc:  # tnc: allow-broad-except(a handler bug must not kill the serving thread)
        response = json_response(500, {"error": f"internal error: {exc}"})
    return response, pattern


class Router:
    """Ordered route table: ``(method, pattern)`` → handler.

    ``resolve`` returns ``(handler, params, pattern)`` or a ready-made
    404/405 :class:`Response`.  HEAD resolves through GET routes — the
    HTTP layer suppresses the body.
    """

    def __init__(self):
        # [(method, segments, pattern, handler)]
        self._routes: List[Tuple[str, Tuple[str, ...], str, Callable]] = []

    def add(self, method: str, pattern: str, handler: Callable) -> None:
        segments = tuple(s for s in pattern.split("/") if s)
        self._routes.append((method.upper(), segments, pattern, handler))

    @staticmethod
    def _match(segments: Tuple[str, ...], path_segs: List[str]) -> Optional[Dict[str, str]]:
        """``path_segs`` arrive already percent-decoded
        (:func:`split_path_segments`), so static segments and captures are
        judged by the same text — no second decode here."""
        if len(segments) != len(path_segs):
            return None
        params: Dict[str, str] = {}
        for pat, seg in zip(segments, path_segs):
            if pat.startswith("{") and pat.endswith("}"):
                params[pat[1:-1]] = seg
            elif pat != seg:
                return None
        return params

    def resolve(self, method: str, path: str):
        """→ ``(handler, params, pattern)`` | :class:`Response` (404/405)."""
        method = method.upper()
        lookup = "GET" if method == "HEAD" else method
        path_segs = split_path_segments(path)
        allowed: set = set()
        for m, segments, pattern, handler in self._routes:
            params = self._match(segments, path_segs)
            if params is None:
                continue
            if m == lookup:
                return handler, params, pattern
            allowed.add(m)
        if allowed:
            # The path exists; the verb is wrong.  Name what would work —
            # GET routes also answer HEAD.
            if "GET" in allowed:
                allowed.add("HEAD")
            resp = json_response(405, {"error": f"method {method} not allowed"})
            resp.headers["Allow"] = ", ".join(sorted(allowed))
            return resp
        return json_response(404, {"error": f"no route for {path}"})


class RoutedHandler(BaseHTTPRequestHandler):
    """``BaseHTTPRequestHandler`` driven by a :class:`Router`.

    Subclasses (closures in practice) set ``router`` and optionally
    ``observe(method, route_pattern, status, elapsed_ms)`` /
    ``track_in_flight(delta)`` hooks for request metrics.  HTTP/1.1 with an
    explicit ``Content-Length`` on every response, so pollers keep their
    connections alive across rounds instead of re-dialing per poll.
    """

    router: Router = None  # set by subclass
    protocol_version = "HTTP/1.1"
    # A stalled client must never wedge a handler thread forever.
    timeout = 10

    # -- hooks (no-ops by default) -------------------------------------------
    def observe(self, method: str, route: str, status: int, elapsed_ms: float) -> None:
        pass

    def track_in_flight(self, delta: int) -> None:
        pass

    # -- verb plumbing -------------------------------------------------------
    def do_GET(self):
        self._dispatch("GET")

    def do_HEAD(self):
        self._dispatch("HEAD")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def _read_body(self) -> bytes:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return b""
        if length <= 0:
            return b""
        # Bound write bodies: control-plane requests are tiny JSON; a
        # multi-MB body is abuse, not a request.  Truncating leaves the
        # rest of the body in the socket, which would desync keep-alive
        # framing — drop the connection after answering instead.
        cap = 1 << 20
        if length > cap:
            self.close_connection = True
        return self.rfile.read(min(length, cap))

    def _dispatch(self, method: str) -> None:
        import time as _time

        t0 = _time.monotonic()
        self.track_in_flight(+1)
        route_label = "(unmatched)"
        status = 500
        try:
            # Drain the body BEFORE answering, resolved or not: a 404/405
            # that skips an unread POST body leaves its bytes in the
            # socket, and the next keep-alive request on the connection
            # would be parsed starting at the leftovers.
            body = self._read_body() if method in ("POST", "PUT") else b""
            response, route_label = route_request(
                self.router, method, self.path, self.headers, body,
                self.client_address[0],
            )
            status = response.status
            self._send(response, head_only=(method == "HEAD"))
        except (BrokenPipeError, ConnectionResetError):
            # The poller hung up mid-response; its problem, not a log line.
            self.close_connection = True
        finally:
            self.track_in_flight(-1)
            self.observe(
                method, route_label, status, (_time.monotonic() - t0) * 1e3
            )

    def _send(self, response: Response, head_only: bool = False) -> None:
        self.send_response(response.status)
        headers = dict(response.headers)
        headers.setdefault("Content-Type", "application/json; charset=utf-8")
        for key, value in headers.items():
            self.send_header(key, value)
        # HEAD carries the GET's Content-Length with no body (RFC 7231
        # §4.3.2); 304 always has zero body bytes.
        self.send_header("Content-Length", str(len(response.body)))
        self.end_headers()
        if not head_only and response.status != 304 and response.body:
            self.wfile.write(response.body)

    def log_message(self, *args):  # scrapes and polls must not spam stderr
        pass
