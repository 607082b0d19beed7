"""Minimal HTTP routing and conditional/encoding negotiation, stdlib only.

A copy of what the JAX package's metrics endpoint uses from its
``server/router.py`` (``Request``, ``Response``, ``json_response``,
``_etag_matches``, ``negotiate``, ``split_path_segments``,
``route_request``, ``Router``, ``RoutedHandler``) and ``server/snapshot.py``
(``entity_tag``, ``Entity``), so the port's scrape keeps the same contract:

* unknown paths answer **404**; a known path with the wrong method **405**
  with an ``Allow`` header;
* **HEAD** is served from the GET handler: same status and headers
  (``Content-Length`` and ``ETag`` included), no body;
* a strong ETag matched by ``If-None-Match`` answers **304**, and
  ``Accept-Encoding: gzip`` gets the pre-compressed variant;
* every negotiated response carries ``ETag``, ``Vary: Accept-Encoding`` and
  ``Cache-Control: no-cache``.

Path segments are split on literal ``/`` first and then percent-decoded
once each, so static segments and ``{name}`` captures are judged by the
same text.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

JSON_CONTENT_TYPE = "application/json; charset=utf-8"

# Level 6 is zlib's sweet spot; below this size the gzip header overhead
# beats the savings and the raw bytes are served instead.
_GZIP_LEVEL = 6
_GZIP_MIN_BYTES = 256


def entity_tag(raw: bytes) -> str:
    """The strong ETag for a body: a quoted, truncated sha256."""
    return '"' + hashlib.sha256(raw).hexdigest()[:32] + '"'


class Entity:
    """One immutable HTTP representation: raw bytes, gzip variant, ETag.

    The gzip variant is served only when it actually saved bytes.
    """

    __slots__ = ("raw", "gz", "etag", "content_type")

    def __init__(self, raw: bytes, content_type: str = JSON_CONTENT_TYPE,
                 gz: Optional[bytes] = None):
        self.raw = raw
        self.content_type = content_type
        if gz is None:
            # mtime=0 pins the gzip header, so identical bodies compress to
            # identical bytes: representation equality mirrors ETag equality.
            gz = (
                gzip.compress(raw, _GZIP_LEVEL, mtime=0)
                if len(raw) >= _GZIP_MIN_BYTES
                else None
            )
        self.gz = gz if gz is not None and len(gz) < len(raw) else None
        self.etag = entity_tag(raw)


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
    return Response(
        status,
        (json.dumps(obj, ensure_ascii=False) + "\n").encode("utf-8"),
        {"Content-Type": JSON_CONTENT_TYPE},
    )


def _etag_matches(if_none_match: str, etag: str) -> bool:
    """RFC 7232 ``If-None-Match`` against one strong ETag: ``*`` matches
    any representation; otherwise a comma-separated list of (possibly
    ``W/``-prefixed) tags, compared weakly as the RFC specifies."""
    if if_none_match.strip() == "*":
        return True
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


def negotiate(entity: Entity, headers, status: int = 200) -> Response:
    """One pre-serialized entity → the wire response for this request:
    304 on an ``If-None-Match`` hit, the gzip variant when accepted, and
    always the strong ``ETag``, ``Vary`` and ``Cache-Control: no-cache``
    (clients must revalidate; the 304 is the cheap path)."""
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


def split_path_segments(path: str) -> List[str]:
    """A raw request path → its segments, each percent-decoded exactly once
    after the split on literal ``/``."""
    return [urllib.parse.unquote(s) for s in path.split("/") if s]


def route_request(router: "Router", method: str, target: str, headers,
                  body: bytes, remote: str) -> Response:
    """The dispatch core: the routed handler's response, or the router's
    404/405.  A handler that raises answers 500 instead of killing the
    serving thread."""
    parsed = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parsed.query)) if parsed.query else {}
    resolved = router.resolve(method, parsed.path)
    if isinstance(resolved, Response):
        return resolved
    handler, params, _ = resolved
    request = Request(method, parsed.path, params, query, headers, body, remote)
    try:
        return handler(request)
    except Exception as exc:  # a handler bug must not kill the serving thread
        return json_response(500, {"error": f"internal error: {exc}"})


class Router:
    """Ordered route table: ``(method, pattern)`` → handler.

    ``resolve`` returns ``(handler, params, pattern)`` or a ready-made
    404/405 :class:`Response`.  HEAD resolves through GET routes; the HTTP
    layer suppresses the body.
    """

    def __init__(self):
        # [(method, segments, pattern, handler)]
        self._routes: List[Tuple[str, Tuple[str, ...], str, Callable]] = []

    def add(self, method: str, pattern: str, handler: Callable) -> None:
        segments = tuple(s for s in pattern.split("/") if s)
        self._routes.append((method.upper(), segments, pattern, handler))

    @staticmethod
    def _match(segments: Tuple[str, ...], path_segs: List[str]) -> Optional[Dict[str, str]]:
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
            # The path exists; the verb is wrong.  GET routes also answer HEAD.
            if "GET" in allowed:
                allowed.add("HEAD")
            resp = json_response(405, {"error": f"method {method} not allowed"})
            resp.headers["Allow"] = ", ".join(sorted(allowed))
            return resp
        return json_response(404, {"error": f"no route for {path}"})


class RoutedHandler(BaseHTTPRequestHandler):
    """``BaseHTTPRequestHandler`` driven by a :class:`Router` (subclasses
    set ``router``).  HTTP/1.1 with an explicit ``Content-Length`` on every
    response, so pollers keep their connections alive."""

    router: Router = None  # set by subclass
    protocol_version = "HTTP/1.1"
    # A stalled client must never wedge a handler thread forever.
    timeout = 10

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
        # Bound request bodies; past the cap the connection is dropped after
        # answering, since the unread rest would desync keep-alive framing.
        cap = 1 << 20
        if length > cap:
            self.close_connection = True
        return self.rfile.read(min(length, cap))

    def _dispatch(self, method: str) -> None:
        try:
            # Drain the body before answering, resolved or not, so a 404/405
            # leaves no bytes in the socket for the next keep-alive request.
            body = self._read_body() if method in ("POST", "PUT") else b""
            response = route_request(
                self.router, method, self.path, self.headers, body,
                self.client_address[0],
            )
            self._send(response, head_only=(method == "HEAD"))
        except (BrokenPipeError, ConnectionResetError):
            # The poller hung up mid-response.
            self.close_connection = True

    def _send(self, response: Response, head_only: bool = False) -> None:
        self.send_response(response.status)
        headers = dict(response.headers)
        headers.setdefault("Content-Type", JSON_CONTENT_TYPE)
        for key, value in headers.items():
            self.send_header(key, value)
        # HEAD carries the GET's Content-Length with no body (RFC 7231
        # §4.3.2); a 304 always has zero body bytes.
        self.send_header("Content-Length", str(len(response.body)))
        self.end_headers()
        if not head_only and response.status != 304 and response.body:
            self.wfile.write(response.body)

    def log_message(self, *args):  # scrapes must not spam stderr
        pass
