"""Cluster access: kubeconfig and in-cluster discovery, and a small k8s REST client.

A copy of the JAX package's ``cluster.py``, held equal to it by
``tests/test_torch_copies.py``.  The client rides the standard library's
``http.client`` with keep-alive pooling (:class:`_StdlibSession`, TLS and
graded retries), and hands the raw REST dicts to ``detect``.

Config discovery: ``--kubeconfig`` → ``$KUBECONFIG`` (a path list; paths
that exist) → ``~/.kube/config`` → the in-cluster service account.
Kubeconfig auth: CA, client certificate and key as paths or inline
``*-data``, bearer ``token``/``tokenFile``, basic auth, and ``exec``
credential plugins (``gke-gcloud-auth-plugin``).

:class:`KubeClient` walks the node LIST in ``limit``/``continue`` pages
(restarting once on 410 Gone, the next page prefetched while this one
decodes), projects it for the relist fast path (``list_nodes_projected``),
walks a node's events (``list_node_events_paged``), and reports its
transport counters (``transport_stats``).
"""

from __future__ import annotations

import atexit
import base64
import json
import os
import subprocess
import sys
import tempfile
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Stamped on nodes cordoned by --cordon-failed; --uncordon-recovered only
# ever lifts cordons carrying it, so human cordons stay untouched.
from tpu_node_checker_torch.detect import QUARANTINE_ANNOTATION

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
DEFAULT_KUBECONFIG = os.path.join(os.path.expanduser("~"), ".kube", "config")
DEFAULT_TIMEOUT_S = 10.0


class ClusterConfigError(RuntimeError):
    """Raised when no usable cluster configuration can be resolved."""


class ClusterAPIError(RuntimeError):
    """Non-2xx response from the API server (the stdlib transport's analog
    of ``requests.HTTPError`` — callers rely only on the exit-1 catch-all).

    ``status_code`` carries the HTTP status so control flow (the paginated
    LIST's 410-restart) never string-matches the message."""

    def __init__(self, message: str, status_code: Optional[int] = None):
        super().__init__(message)
        self.status_code = status_code


class WatchGone(ClusterAPIError):
    """410 Gone on a watch connect: the requested ``resourceVersion`` has
    been compacted out of etcd.  The one recovery is a fresh LIST — the
    caller (the watch-stream engine) relists and reseeds its cache rather
    than retrying the dead resourceVersion forever."""

    def __init__(self, message: str):
        super().__init__(message, status_code=410)


class _Response:
    """Minimal requests-Response-shaped result for :class:`_StdlibSession`.

    ``headers`` carries the response headers with lower-cased names — the
    retry layer reads ``retry-after`` from throttling responses."""

    def __init__(self, status_code: int, body: bytes, url: str, headers=None):
        self.status_code = status_code
        self._body = body
        self._url = url
        self.headers = headers or {}

    def raise_for_status(self) -> None:
        # Anything non-2xx is an error — INCLUDING 3xx: redirects are never
        # followed (see _StdlibSession), because re-sending the request
        # would forward the Authorization header to wherever the redirect
        # points, leaking the cluster token off-host.
        if not 200 <= self.status_code < 300:
            snippet = self._body[:300].decode("utf-8", errors="replace")
            raise ClusterAPIError(
                f"HTTP {self.status_code} from {self._url}: {snippet}",
                status_code=self.status_code,
            )

    def json(self):
        return json.loads(self._body)

    @property
    def content(self) -> bytes:
        """Raw body bytes (requests-shaped) — the federation fetch tier
        re-frames node bodies by bytes instead of parsing them."""
        return self._body


class _StreamingResponse:
    """One live streaming HTTP response (a k8s ``watch``): line-iterated,
    owning a DEDICATED connection that is never pooled.

    A watch monopolizes its socket for minutes — returning it to the
    free-list would hand a half-consumed chunked stream to the next LIST.
    ``close()`` tears the connection down; it is also how a reader blocked
    in ``readline`` gets unblocked at shutdown (the socket close surfaces
    as EOF/OSError in the reading thread).
    """

    def __init__(self, conn, raw, url: str):
        self.status_code = raw.status
        self.headers = {k.lower(): v for k, v in raw.getheaders()}
        self._conn = conn
        self._raw = raw
        self._url = url

    def raise_for_status(self) -> None:
        if not 200 <= self.status_code < 300:
            # Error bodies are small Status objects; bound the read anyway —
            # a misbehaving server must not stall connect-time error
            # handling behind an unbounded body.
            snippet = self._raw.read(300).decode("utf-8", errors="replace")
            self.close()
            if self.status_code == 410:
                raise WatchGone(f"HTTP 410 from {self._url}: {snippet}")
            raise ClusterAPIError(
                f"HTTP {self.status_code} from {self._url}: {snippet}",
                status_code=self.status_code,
            )

    def iter_lines(self):
        """Yield one non-empty line (stripped bytes) per watch frame.

        ``http.client`` dechunks transparently, so ``readline`` returns one
        newline-delimited JSON event per call.  A clean stream end (server
        closed, 0-chunk) yields nothing further; socket timeouts and
        resets propagate to the caller, whose reconnect policy this layer
        deliberately does not own.
        """
        while True:
            line = self._raw.readline()
            if not line:
                return
            line = line.strip()
            if line:
                yield line

    def close(self) -> None:
        # Shut the socket down BEFORE closing the connection object:
        # ``conn.close()`` ends up waiting on the buffered response's
        # internal lock, which a reader thread parked in ``readline`` holds
        # until its recv returns — shutdown() forces that recv to return
        # NOW (EOF) instead of whenever the peer next says something, so a
        # stream teardown takes milliseconds, not a read-timeout.
        import socket as _socket

        sock = getattr(self._conn, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._conn.close()
        except OSError:
            pass


class _StdlibSession:
    """``requests.Session``-shaped keep-alive transport over ``http.client``.

    Importing requests costs ~200 ms — more than half of what the checker
    actually spends against its <2 s budget.  The Slack notifier keeps
    requests (its retry classification is pinned to requests' exception
    taxonomy by the reference contract, check-gpu-node.py:86-99), but that
    import only happens when a webhook is configured, off the happy path.

    Connections are POOLED, keyed by ``(scheme, host, port)``: a paginated
    LIST, the per-sick-node events fetches, every watch round, and the
    cordon/uncordon PATCHes all reuse one TCP+TLS connection per concurrent
    caller instead of paying the handshake per request (the kubectl /
    client-go shared-transport model).  The pool is a free-list: a thread
    pops an idle connection (or dials a new one — bounded in practice by
    the ``--api-concurrency`` fan-out width) and returns it after reading
    the full response, so concurrent workers never interleave on a socket.

    A keep-alive socket the server quietly closed between rounds surfaces
    as ``RemoteDisconnected``/``BrokenPipeError`` on the next use; for an
    idempotent GET on a REUSED connection the session transparently redials
    once.  Non-idempotent methods (PATCH) are NEVER blind-retried: a socket
    that died after the bytes left may have applied the patch, and
    re-sending could double-apply — the error surfaces to the caller, whose
    per-node failure handling already treats it as a note, not a round
    failure.

    Security posture (unchanged from the urllib transport, pinned by
    tests): redirects are never followed — ``http.client`` performs no
    redirect handling, so a 3xx comes back as a plain ``_Response`` that
    ``raise_for_status`` rejects, and the Authorization header can never
    cross a redirect off-host.  The TLS context is built once per session
    and ONLY when an https target is contacted: plain-http endpoints
    (local test servers, port-forwards) never pay the ~20 ms system CA
    store load.  Unlike urllib, no proxy environment variables are
    honored — the API server is dialed directly.

    Attribute contract shared with requests.Session (and the test fakes):
    ``headers`` dict, ``verify`` (True | False | CA path), ``cert``
    ((cert, key) paths), ``auth`` ((user, password)).  Transport telemetry:
    ``connections_opened`` / ``requests_sent`` / ``requests_reused``
    monotonic counters (surfaced as Prometheus counters in watch mode).
    """

    def __init__(self, keep_alive: bool = True):
        self.headers: dict = {}
        self.verify = True
        self.cert: Optional[Tuple[str, str]] = None
        self.auth: Optional[Tuple[str, str]] = None
        self.keep_alive = keep_alive
        self.connections_opened = 0
        self.requests_sent = 0
        self.requests_reused = 0
        # Graded retry layer (utils/retry.py), installed per check round by
        # the checker (`KubeClient.set_retry_policy`) so every round gets a
        # fresh shared wall-clock budget.  None = no retries: the transport
        # behaves exactly as before (the stale-socket redial below is
        # connection management, not a retry, and stays either way).
        self.retry_policy = None
        self.retries = 0
        self.retries_by_reason: dict = {}
        self._ssl_ctx = None
        self._pool: dict = {}  # (scheme, host, port) -> [idle connections]
        self._lock = threading.Lock()

    def _context(self):
        """TLS context, built once per session (verify/cert are set by
        KubeClient before the first request and never change after)."""
        if self._ssl_ctx is None:
            import ssl

            if self.verify is False:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            elif isinstance(self.verify, str):
                ctx = ssl.create_default_context(cafile=self.verify)
            else:
                ctx = ssl.create_default_context()
            if self.cert:
                ctx.load_cert_chain(self.cert[0], self.cert[1])
            self._ssl_ctx = ctx
        return self._ssl_ctx

    def _new_connection(self, scheme: str, host: str, port: int, timeout):
        import http.client

        if scheme == "https":
            conn = http.client.HTTPSConnection(
                host, port, timeout=timeout, context=self._context()
            )
        else:
            # Plain-http never touches ssl at all — no CA store load, and
            # no code path by which an https URL could reach a TLS-free
            # socket (the scheme picks the connection class directly).
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        with self._lock:
            self.connections_opened += 1
        return conn

    def _acquire(self, key, timeout):
        """Pop a LIVE idle pooled connection for ``key``, else dial fresh.

        Every popped connection is liveness-peeked first (an idle
        keep-alive socket the peer closed — LB idle timeout between watch
        rounds — reads as EOF): knowably-dead sockets are discarded here so
        they are never handed to a non-retryable PATCH, and a GET does not
        burn its one stale-socket retry on them.  The peek is inherently
        racy (the peer can close between peek and send); the reused-GET
        redial in ``_request`` covers that residue.

        Returns ``(conn, reused)`` — ``reused`` gates the one-shot
        stale-socket retry (a FRESH connection failing is a real error).
        """
        while True:
            with self._lock:
                idle = self._pool.get(key)
                conn = idle.pop() if idle else None
            if conn is None:
                return self._new_connection(*key, timeout), False
            if self._sock_is_dead(conn):
                conn.close()
                continue
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True

    @staticmethod
    def _sock_is_dead(conn) -> bool:
        """Zero-timeout readability peek: an idle keep-alive HTTP socket has
        nothing to say, so readable means EOF (peer closed) or protocol
        garbage — either way the connection is unusable.  Works for TLS
        sockets too (select on the underlying fd; a clean close shows as a
        readable close_notify/EOF)."""
        sock = conn.sock
        if sock is None:
            return True
        import select

        try:
            return bool(select.select([sock], [], [], 0)[0])
        except (OSError, ValueError):
            return True

    def _discard_idle(self, key) -> None:
        """Close every idle connection for ``key`` — when one pooled socket
        proves stale mid-request, its pool-mates idled exactly as long and
        are suspect too; the subsequent redial must reach a fresh dial, not
        the next corpse (which would exhaust the one-shot retry)."""
        with self._lock:
            idle = self._pool.pop(key, [])
        for conn in idle:
            conn.close()

    def _release(self, key, conn, raw) -> None:
        """Return a connection to the pool unless the response ended it."""
        if not self.keep_alive or raw.will_close or conn.sock is None:
            conn.close()
            return
        with self._lock:
            self._pool.setdefault(key, []).append(conn)

    def close(self) -> None:
        """Close every pooled connection (tests / bench hygiene; a one-shot
        process exits anyway and the kernel reaps the sockets)."""
        with self._lock:
            pools, self._pool = self._pool, {}
        for idle in pools.values():
            for conn in idle:
                conn.close()

    def _request(self, method, url, *, params=None, data=None, headers=None, timeout=None):
        import urllib.parse

        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        parts = urllib.parse.urlsplit(url)
        # Scheme per RFC 3986 is case-insensitive; "HTTPS://…" must select
        # the TLS connection class like "https://…" does.
        scheme = parts.scheme.lower()
        if scheme not in ("http", "https"):
            raise ClusterAPIError(f"unsupported URL scheme in {url}")
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        hdrs = {**self.headers, **(headers or {})}
        if self.auth and "Authorization" not in hdrs:
            cred = base64.b64encode(f"{self.auth[0]}:{self.auth[1]}".encode()).decode()
            hdrs["Authorization"] = f"Basic {cred}"
        body = data.encode() if isinstance(data, str) else data
        key = (scheme, host, port)
        policy = self.retry_policy
        if policy is None:
            # No-retry fast path: identical to the pre-retry transport.
            return self._attempt(method, key, path, body, hdrs, timeout, url)
        from tpu_node_checker_torch.utils import retry as retry_mod

        attempt = 0
        while True:
            t0 = policy.monotonic()
            try:
                resp = self._attempt(method, key, path, body, hdrs, timeout, url)
            except Exception as exc:  # tnc: allow-broad-except(classifier decides)
                reason = retry_mod.classify_retriable(exc)
                if reason is not None and method != "GET" and not getattr(
                    exc, "request_never_sent", False
                ):
                    # Strict idempotency gate: a non-idempotent request whose
                    # bytes (may have) left the socket is NEVER re-sent — the
                    # server may have applied it.  Only connect-phase
                    # failures, tagged by _attempt, qualify.
                    reason = None
                if reason is None:
                    raise
                # The failed attempt's own wall-clock (a 10 s timeout, say)
                # is retry overhead too: charge it so a timeout-looping
                # server exhausts the budget by attempt cost alone.
                policy.budget.charge(policy.monotonic() - t0)
                delay = policy.plan_retry(attempt, reason)
                if delay is None:
                    raise
                self._count_retry(reason)
                policy.wait(delay)
                attempt += 1
                continue
            reason = (
                retry_mod.status_retry_reason(resp.status_code)
                if method == "GET"
                else None  # status-retries are idempotent-only, like above
            )
            if reason is not None:
                # Same rule as the exception path: a failed attempt's own
                # wall-clock (a 500 the server took seconds to emit) is
                # retry overhead and must count against the budget.
                policy.budget.charge(policy.monotonic() - t0)
                delay = policy.plan_retry(
                    attempt,
                    reason,
                    retry_after=retry_mod.parse_retry_after(
                        resp.headers.get("retry-after"), now=policy.now()
                    ),
                )
                if delay is not None:
                    self._count_retry(reason)
                    policy.wait(delay)
                    attempt += 1
                    continue
            # Out of retries (or nothing to retry): the response surfaces
            # through the unchanged raise_for_status contract — an exhausted
            # budget still lands on the documented exit-1 path.
            return resp

    def _count_retry(self, reason: str) -> None:
        with self._lock:
            self.retries += 1
            self.retries_by_reason[reason] = self.retries_by_reason.get(reason, 0) + 1

    def _attempt(self, method, key, path, body, hdrs, timeout, url):
        """One transport-level try: acquire/dial, send, drain, pool.

        The in-built stale-socket redial (a REUSED keep-alive socket the
        peer quietly closed, idempotent GETs only) lives here — it is
        connection management, not a retry, and costs no budget.  Fresh
        dials are connected EXPLICITLY so a connect-phase failure can be
        tagged ``request_never_sent`` — the proof the retry layer's
        idempotency gate demands before re-sending a PATCH.
        """
        import http.client

        retried = False
        while True:
            conn, reused = self._acquire(key, timeout)
            if conn.sock is None:
                try:
                    conn.connect()
                except Exception as exc:  # tnc: allow-broad-except(tag, then surface)
                    conn.close()
                    # Bytes provably never left this socket: safe to retry
                    # even for non-idempotent methods.
                    exc.request_never_sent = True
                    raise
            try:
                conn.request(method, path, body=body, headers=hdrs)
                raw = conn.getresponse()
                # Drain the body BEFORE pooling: http.client refuses a new
                # request while a response is pending on the socket.
                payload = raw.read()
            except (
                http.client.BadStatusLine,  # covers RemoteDisconnected
                BrokenPipeError,
                ConnectionResetError,
                ConnectionAbortedError,
            ):
                # The keep-alive peer closed the socket between requests.
                # Deliberately NOT OSError: a timeout or a refused dial is a
                # real failure, not a stale pooled socket.
                conn.close()
                if reused and method == "GET" and not retried:
                    # Stale pooled socket on an idempotent request: one
                    # transparent redial.  Never for PATCH (may have
                    # applied), never twice, never for a fresh connection.
                    # Pool-mates idled just as long — flush them so the
                    # retry dials fresh instead of popping the next corpse.
                    self._discard_idle(key)
                    retried = True
                    continue
                raise
            except Exception:
                conn.close()
                raise
            with self._lock:
                self.requests_sent += 1
                if reused:
                    self.requests_reused += 1
            self._release(key, conn, raw)
            # Non-2xx needs no exception mapping here: the status (3xx
            # included — redirects are never followed) rides the _Response
            # and surfaces through the raise_for_status contract.
            return _Response(
                raw.status,
                payload,
                url,
                headers={k.lower(): v for k, v in raw.getheaders()},
            )

    def stream(self, url, *, params=None, headers=None, timeout=None,
               read_timeout=None):
        """Open a streaming GET on a DEDICATED (never pooled) connection.

        The watch-stream transport: the response is handed back live for
        incremental ``readline`` decode instead of being drained into one
        body.  ``timeout`` bounds the dial and the response HEAD (a wedged
        server must fail the connect in seconds, like any API call);
        ``read_timeout`` then replaces it on the established socket — a
        silent stream past it raises in the reader, which the watch engine
        treats as stream loss.  No retry policy applies: reconnect policy
        belongs to the stream's owner, which knows whether a
        resourceVersion is still worth resuming from.
        """
        import urllib.parse

        if params:
            url = f"{url}?{urllib.parse.urlencode(params)}"
        parts = urllib.parse.urlsplit(url)
        scheme = parts.scheme.lower()
        if scheme not in ("http", "https"):
            raise ClusterAPIError(f"unsupported URL scheme in {url}")
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        hdrs = {**self.headers, **(headers or {})}
        if self.auth and "Authorization" not in hdrs:
            cred = base64.b64encode(f"{self.auth[0]}:{self.auth[1]}".encode()).decode()
            hdrs["Authorization"] = f"Basic {cred}"
        conn = self._new_connection(scheme, host, port, timeout)
        try:
            conn.request("GET", path, headers=hdrs)
            raw = conn.getresponse()
            if read_timeout is not None and conn.sock is not None:
                conn.sock.settimeout(read_timeout)
        except Exception:
            conn.close()
            raise
        with self._lock:
            self.requests_sent += 1
        return _StreamingResponse(conn, raw, url)

    def get(self, url, params=None, timeout=None, headers=None):
        return self._request(
            "GET", url, params=params, headers=headers, timeout=timeout
        )

    def patch(self, url, data=None, headers=None, timeout=None):
        return self._request("PATCH", url, data=data, headers=headers, timeout=timeout)

    def post(self, url, data=None, headers=None, timeout=None):
        """Non-idempotent POST (Eviction API, disruption leases, repair
        webhooks): rides the same pooled transport and retry ladder as
        PATCH — transparent retry only when the request provably never
        left the socket."""
        return self._request("POST", url, data=data, headers=headers, timeout=timeout)


@dataclass
class ClusterConfig:
    """Resolved connection parameters for one API server."""

    server: str
    ca_file: Optional[str] = None
    insecure_skip_tls_verify: bool = False
    client_cert: Optional[Tuple[str, str]] = None  # (cert_path, key_path)
    token: Optional[str] = None
    basic_auth: Optional[Tuple[str, str]] = None
    source: str = "unknown"  # "kubeconfig:<path>" | "in-cluster"
    # The kubeconfig context this config resolved through (None in-cluster /
    # offline) — the default cluster identity ``--cluster-name`` falls back
    # to before the hostname.
    context_name: Optional[str] = None
    _temp_files: List[str] = field(default_factory=list, repr=False)

    @property
    def verify(self):
        if self.insecure_skip_tls_verify:
            return False
        return self.ca_file if self.ca_file else True


def _cleanup_temp(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _materialize(data_b64: str, suffix: str, temp_files: List[str]) -> str:
    """Write base64 ``*-data`` kubeconfig material to a temp file, return path."""
    return _materialize_bytes(base64.b64decode(data_b64), suffix, temp_files)


# Content-addressed materialization cache: (sha256(bytes), suffix) -> path.
# resolve_cluster_config runs once per watch round; without this, inline
# ``*-data`` kubeconfigs (the GKE default shape) would mint a NEW temp path
# every round — so the keep-alive client cache (keyed on the resolved
# config, credential paths included) would never hit, and /tmp would
# accumulate one credential file per round until exit.
_MATERIALIZED: dict = {}


def _materialize_bytes(raw: bytes, suffix: str, temp_files: List[str]) -> str:
    """Write credential bytes to a mode-0600 temp file, return path —
    content-addressed, so identical bytes reuse one stable path per process.

    Files hold credential material (client keys), so each is registered for
    unconditional removal at interpreter exit — a cron-driven checker must not
    accumulate key files in /tmp.
    """
    import hashlib

    cache_key = (hashlib.sha256(raw).hexdigest(), suffix)
    cached = _MATERIALIZED.get(cache_key)
    if cached is not None and os.path.exists(cached):
        temp_files.append(cached)
        return cached
    fd, path = tempfile.mkstemp(prefix="tpu-node-checker-", suffix=suffix)
    try:
        os.write(fd, raw)
    finally:
        os.close(fd)
    os.chmod(path, 0o600)
    temp_files.append(path)
    atexit.register(_cleanup_temp, path)
    _MATERIALIZED[cache_key] = path
    return path


def _named(entries: list, name: str, kind: str) -> dict:
    for e in entries or []:
        if e.get("name") == name:
            return e.get(kind) or {}
    raise ClusterConfigError(f"kubeconfig references unknown {kind} {name!r}")


def _run_exec_plugin(spec: dict) -> dict:
    """Run a client-go exec credential plugin and return its ``status`` dict."""
    cmd = [spec["command"], *(spec.get("args") or [])]
    env = dict(os.environ)
    for pair in spec.get("env") or []:
        env[pair["name"]] = pair["value"]
    try:
        out = subprocess.run(
            cmd, capture_output=True, env=env, timeout=30, check=True, text=True
        ).stdout
    except FileNotFoundError as exc:
        raise ClusterConfigError(f"exec auth plugin not found: {spec['command']}") from exc
    except subprocess.CalledProcessError as exc:
        raise ClusterConfigError(
            f"exec auth plugin failed ({exc.returncode}): {exc.stderr.strip()[:500]}"
        ) from exc
    except subprocess.TimeoutExpired as exc:
        raise ClusterConfigError(f"exec auth plugin timed out: {spec['command']}") from exc
    try:
        return json.loads(out).get("status") or {}
    except json.JSONDecodeError as exc:
        raise ClusterConfigError("exec auth plugin emitted invalid JSON") from exc


def load_kubeconfig(path: str, context: Optional[str] = None) -> ClusterConfig:
    """Parse one kubeconfig file into a :class:`ClusterConfig`.

    Parsing tries the stdlib YAML-subset reader first (kubectl-written
    configs are plain block style; PyYAML's import alone is ~55 ms — a
    third of the checker's cold start) and falls back to PyYAML for
    anything beyond the subset, so exotic configs stay fully supported.
    """
    with open(path) as f:
        text = f.read()
    from tpu_node_checker_torch.utils.miniyaml import UnsupportedYAML, safe_load_subset

    try:
        doc = safe_load_subset(text) or {}
    except UnsupportedYAML:
        import yaml

        doc = yaml.safe_load(text) or {}
    ctx_name = context or doc.get("current-context")
    if not ctx_name:
        raise ClusterConfigError(f"kubeconfig {path} has no current-context")
    ctx = _named(doc.get("contexts"), ctx_name, "context")
    cluster = _named(doc.get("clusters"), ctx.get("cluster"), "cluster")
    user = _named(doc.get("users"), ctx.get("user"), "user") if ctx.get("user") else {}

    server = cluster.get("server")
    if not server:
        raise ClusterConfigError(f"kubeconfig {path}: cluster has no server URL")

    temp_files: List[str] = []
    cfg = ClusterConfig(server=server.rstrip("/"), source=f"kubeconfig:{path}",
                        context_name=ctx_name, _temp_files=temp_files)
    cfg.insecure_skip_tls_verify = bool(cluster.get("insecure-skip-tls-verify"))
    if cluster.get("certificate-authority"):
        cfg.ca_file = cluster["certificate-authority"]
    elif cluster.get("certificate-authority-data"):
        cfg.ca_file = _materialize(cluster["certificate-authority-data"], ".ca.crt", temp_files)

    cert = user.get("client-certificate")
    key = user.get("client-key")
    if user.get("client-certificate-data"):
        cert = _materialize(user["client-certificate-data"], ".client.crt", temp_files)
    if user.get("client-key-data"):
        key = _materialize(user["client-key-data"], ".client.key", temp_files)
    if cert and key:
        cfg.client_cert = (cert, key)

    if user.get("token"):
        cfg.token = user["token"]
    elif user.get("tokenFile"):
        with open(user["tokenFile"]) as f:
            cfg.token = f.read().strip()
    elif user.get("username") and user.get("password"):
        cfg.basic_auth = (user["username"], user["password"])
    elif user.get("exec"):
        status = _run_exec_plugin(user["exec"])
        if status.get("token"):
            cfg.token = status["token"]
        if status.get("clientCertificateData") and status.get("clientKeyData"):
            # ExecCredential status carries plaintext PEM, not base64.
            cfg.client_cert = (
                _materialize_bytes(
                    status["clientCertificateData"].encode(), ".exec.crt", temp_files
                ),
                _materialize_bytes(status["clientKeyData"].encode(), ".exec.key", temp_files),
            )
    return cfg


def load_incluster_config(sa_dir: Optional[str] = None) -> ClusterConfig:
    """Service-account config for pods — the reference never implements this
    (``config.load_incluster_config`` is never called; SURVEY §2.1), yet the
    in-pod chip probe requires it."""
    sa_dir = sa_dir or SERVICE_ACCOUNT_DIR
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(sa_dir, "token")
    ca_path = os.path.join(sa_dir, "ca.crt")
    if not host or not os.path.exists(token_path):
        raise ClusterConfigError("not running in a cluster (no service account present)")
    with open(token_path) as f:
        token = f.read().strip()
    return ClusterConfig(
        server=f"https://{host}:{port}",
        ca_file=ca_path if os.path.exists(ca_path) else None,
        token=token,
        source="in-cluster",
    )


def resolve_cluster_config(
    kubeconfig_flag: Optional[str] = None, context: Optional[str] = None
) -> ClusterConfig:
    """Discovery precedence: flag → $KUBECONFIG (if exists) → ~/.kube/config →
    in-cluster.  First three mirror check-gpu-node.py:160-169; the last is new."""
    if kubeconfig_flag:
        return load_kubeconfig(kubeconfig_flag, context)
    env_value = os.environ.get("KUBECONFIG")
    if env_value:
        # $KUBECONFIG may be a pathsep-separated list (kubectl semantics);
        # use the first existing entry rather than silently ignoring the
        # variable and checking a different cluster than kubectl would.
        for env_path in env_value.split(os.pathsep):
            if env_path and os.path.exists(env_path):
                return load_kubeconfig(env_path, context)
    if os.path.exists(DEFAULT_KUBECONFIG):
        return load_kubeconfig(DEFAULT_KUBECONFIG, context)
    return load_incluster_config()


def _oracle_page_decoder(resp, page_index):
    """Default page decoder: the sanctioned full-body decode in
    ``tpu_node_checker_torch.fastpath`` (events walks, raw-dict node LISTs,
    drop-in session doubles that carry no raw bytes)."""
    from tpu_node_checker_torch import fastpath

    return fastpath.oracle_decode_page(resp)


_PREFETCH_STOP = object()

# Decode time above which pipelining the next page pays for its worker
# handoff (~0.4 ms measured): full decodes of a 500-node page run ~10-20 ms
# (pipeline on), tier-0 page reuse runs ~10 µs (pipeline off).  ≤ 0 forces
# the pipeline always-on (test seam).
_PREFETCH_MIN_DECODE_S = 0.001


class _PrefetchSlot:
    """Single-slot fetch/decode pipeline for one paginated walk.

    While the caller thread decodes page N, the next page (whose continue
    token was peeked from page N's raw bytes) is already in flight on ONE
    persistent named daemon worker over the same pooled session (spawning
    a thread per page costs ~0.5 ms × pages — real money once decode is
    near-free).  One slot, by design: the walk is serial in tokens, so
    deeper prefetch could only speculate.  ``take`` re-raises the fetch's
    exception on the caller thread, so the 410-restart and retry/breaker
    semantics are exactly the serial walk's.
    """

    def __init__(self, fetch):
        self._fetch = fetch
        self._requests: queue.Queue = queue.Queue(1)
        self._results: queue.Queue = queue.Queue(1)
        self._worker = None
        self._pending = None

    def _run(self) -> None:
        while True:
            params = self._requests.get()
            if params is _PREFETCH_STOP:
                return
            try:
                outcome = ("resp", self._fetch(params))
            except BaseException as exc:  # tnc: allow-broad-except(carried to the caller thread and re-raised by take())
                outcome = ("exc", exc)
            self._results.put(outcome)

    def start(self, params: dict) -> None:
        self.discard()
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="tnc-list-prefetch", daemon=True
            )
            self._worker.start()
        self._pending = params
        self._requests.put(params)

    def take(self, params: dict):
        """The response for ``params`` — the pending prefetch when it was
        started for exactly these params, a fresh inline fetch otherwise."""
        if self._pending == params:
            self._pending = None
            kind, value = self._results.get()
            if kind == "exc":
                raise value
            return value
        self.discard()
        return self._fetch(params)

    def discard(self) -> None:
        """Drop any pending fetch (walk restart, mispeeked token, walk
        end): wait out the in-flight request and swallow its outcome — a
        discarded response is never consumed, a discarded error never
        raised."""
        if self._pending is not None:
            self._pending = None
            self._results.get()

    def close(self) -> None:
        """End the worker (walk over).  Any pending fetch is discarded
        first so the stop sentinel is the queue's next item."""
        self.discard()
        if self._worker is not None:
            self._requests.put(_PREFETCH_STOP)
            self._worker = None


class KubeClient:
    """Just enough Kubernetes API for this tool: one LIST, plus an opt-in
    PATCH for ``--cordon-failed``.

    RBAC footprint is identical to the reference's (ClusterRole with
    ``nodes: get,list`` — README.md:144-159 of the reference) unless
    cordoning is enabled, which additionally needs the ``patch`` verb.
    """

    def __init__(self, config: ClusterConfig, session=None):
        self.config = config
        # LIST-truncation counters by resource (no-silent-caps rule): a
        # walk that exhausted its page budget with the continue token
        # still set lost its tail — surfaced via transport_stats →
        # payload.api_transport.list_truncated → the
        # tpu_node_checker_api_list_truncated_total metric family.
        self.truncations: dict = {}
        self._trunc_lock = threading.Lock()
        # Projection page cache (tpu_node_checker_torch.fastpath), built on
        # first projected LIST; lives with the client so the keep-alive
        # client cache also carries the relist reuse state across rounds.
        self._projector = None
        if session is None:
            # Stdlib transport by default (see _StdlibSession: requests'
            # import cost has no place on the latency budget).  Anything
            # session-shaped — including a requests.Session — drops in.
            session = _StdlibSession()
        self._session = session
        self._session.verify = config.verify
        if config.client_cert:
            self._session.cert = config.client_cert
        if config.token:
            self._session.headers["Authorization"] = f"Bearer {config.token}"
        elif config.basic_auth:
            self._session.auth = config.basic_auth

    # LIST page size.  kubectl's chunk size (500) suits a walk whose
    # per-page cost is DECODE-bound (~30 ms of json.loads per page);
    # with projection decode + page reuse the walk is ROUND-TRIP-bound
    # (~2 ms turnaround per request vs microseconds of decode), so larger
    # pages halve what a relist actually waits on.  1000 keeps bodies
    # ~1 MB — bounded memory, same etcd range-read shape — while a 64-host
    # slice still fits one request (the single-request fast path is
    # unchanged: one GET, no continue token in the response).
    LIST_PAGE_LIMIT = 1000

    def _paged_list(
        self, path: str, params: dict, timeout: float, max_pages: int,
        decode_page=None,
    ) -> Tuple[list, Optional[str], Optional[str]]:
        """Follow ``limit``/``continue`` for one GET list — the single
        pagination walk both node and event LISTs share, PIPELINED: while
        page N decodes on this thread, page N+1 (continue token peeked
        from page N's raw bytes — ``fastpath.peek_continue``) is already
        in flight on the prefetch slot.  The peek is trust-but-verify:
        decode yields the authoritative token, and a mismatch discards the
        speculative fetch instead of ever consuming a wrong page.

        ``decode_page(resp, page_index) -> (items, meta)`` is the page
        decoder — the projection path for node LISTs, the sanctioned
        ``fastpath.oracle_decode_page`` otherwise; no full-body
        ``json.loads`` lives on this walk (tnc-lint TNC018).

        Returns ``(items, leftover_continue, resource_version)``:
        ``leftover_continue`` is non-None iff ``max_pages`` was exhausted
        with the token still set (the caller surfaces the truncation —
        never silently); ``resource_version`` is the list's
        ``metadata.resourceVersion`` — the point-in-time a subsequent
        ``watch`` resumes from.  A 410 Gone mid-walk (expired snapshot;
        status read from either the stdlib ClusterAPIError or a drop-in
        requests.HTTPError) restarts the walk from scratch once.
        """
        from tpu_node_checker_torch import fastpath

        if decode_page is None:
            decode_page = _oracle_page_decoder

        def fetch(p):
            return self._session.get(
                f"{self.config.server}{path}", params=p, timeout=timeout
            )

        prefetch = _PrefetchSlot(fetch)
        try:
            for attempt in (0, 1):
                page_params = dict(params)
                items: list = []
                rv: Optional[str] = None
                # Prefetch pays only when decode is worth overlapping: a
                # tier-0 page-reuse walk decodes in microseconds, and the
                # worker handoff would cost ~0.4 ms/page of pure overhead.
                # Adaptive: pipeline page N+1 iff page N-1's decode was
                # slower than the handoff (cold walks, oracle mode, churn
                # windows) — measured, not guessed.
                decode_was_slow = _PREFETCH_MIN_DECODE_S <= 0
                try:
                    for page_idx in range(max_pages):
                        resp = prefetch.take(page_params)
                        resp.raise_for_status()
                        peeked = fastpath.peek_continue(
                            getattr(resp, "content", None)
                        )
                        if peeked and decode_was_slow and page_idx + 1 < max_pages:
                            prefetch.start(
                                dict(page_params, **{"continue": peeked})
                            )
                        decode_t0 = time.perf_counter()
                        page_items, meta = decode_page(resp, page_idx)
                        decode_was_slow = (
                            time.perf_counter() - decode_t0
                            > _PREFETCH_MIN_DECODE_S
                        )
                        items.extend(page_items)
                        if meta.get("resourceVersion"):
                            rv = str(meta["resourceVersion"])
                        cont = meta.get("continue")
                        if not cont:
                            # Last page (or a mispeek that "found" a token
                            # the metadata does not carry): nothing left.
                            prefetch.discard()
                            return items, None, rv
                        page_params = dict(page_params, **{"continue": cont})
                        if cont != peeked:
                            prefetch.discard()
                    return items, page_params.get("continue"), rv
                except Exception as exc:  # tnc: allow-broad-except(re-raised unless 410)
                    prefetch.discard()
                    status = getattr(exc, "status_code", None)
                    if status is None:
                        status = getattr(
                            getattr(exc, "response", None), "status_code", None
                        )
                    if attempt == 0 and status == 410 and page_params.get("continue"):
                        continue  # expired token: one clean restart
                    raise
            raise AssertionError("unreachable")  # pragma: no cover
        finally:
            prefetch.close()

    def list_nodes(
        self,
        label_selector: Optional[str] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
        page_limit: Optional[int] = LIST_PAGE_LIMIT,
    ) -> List[dict]:
        """``GET /api/v1/nodes`` with ``limit``/``continue`` pagination.

        The reference pulls the whole NodeList in one unbounded response
        (check-gpu-node.py:217); here responses are chunked (``page_limit``,
        ``None``/0 disables) and followed via the ``continue`` token, with
        server-side label filtering so a v5e-256 check pulls 64 node objects,
        not the cluster.  A 410 Gone mid-pagination (continue token expired —
        the API server compacted the snapshot under a slow walk) restarts the
        LIST from scratch once rather than failing the round.
        """
        items, _rv = self.list_nodes_with_rv(
            label_selector=label_selector, timeout=timeout, page_limit=page_limit
        )
        return items

    def list_nodes_with_rv(
        self,
        label_selector: Optional[str] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
        page_limit: Optional[int] = LIST_PAGE_LIMIT,
        decode_page=None,
    ) -> Tuple[list, Optional[str]]:
        """:meth:`list_nodes` plus the list's ``metadata.resourceVersion`` —
        the seed a :meth:`watch_nodes` stream resumes from.  One walk, same
        pagination/410 semantics; ``resource_version`` is ``None`` when the
        server reports none (offline fixtures).  ``decode_page`` overrides
        the page decoder (the projection fast path rides through here so
        the params/bound/truncation handling cannot fork per caller)."""
        params = {}
        if label_selector:
            params["labelSelector"] = label_selector
        if page_limit:
            params["limit"] = str(page_limit)
        # Bound the walk: per-request timeouts never bound a server that
        # keeps 200-ing with a non-advancing continue token.  1000 pages =
        # a million nodes at the default page size — far past any real
        # cluster, so hitting the cap is a broken server, graded exit 1.
        items, leftover, rv = self._paged_list(
            "/api/v1/nodes", params, timeout, max_pages=1000,
            decode_page=decode_page,
        )
        if leftover:
            self._count_truncation("nodes")
            raise ClusterAPIError(
                "LIST /api/v1/nodes did not terminate within 1000 pages "
                "(non-advancing continue token?)"
            )
        return items, rv

    def list_nodes_projected(
        self,
        label_selector: Optional[str] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
        page_limit: Optional[int] = LIST_PAGE_LIMIT,
    ):
        """The relist fast path: :meth:`list_nodes_with_rv` through the
        projection decoder (``fastpath.ListProjector``) instead of a full
        ``json.loads`` per page.

        Returns a :class:`~tpu_node_checker_torch.fastpath.ProjectedFleet` —
        pruned grading-view docs plus per-node content digests — with
        unchanged pages/byte-runs reused by reference from the previous
        walk (the projector lives on this client, which the checker's
        keep-alive client cache carries across rounds).  Pagination, the
        410 restart, the 1000-page bound and the retry ladder are exactly
        :meth:`list_nodes_with_rv`'s — it IS that walk, with the decoder
        swapped.
        """
        from tpu_node_checker_torch import fastpath

        if self._projector is None:
            self._projector = fastpath.ListProjector()
        items, rv = self.list_nodes_with_rv(
            label_selector=label_selector, timeout=timeout,
            page_limit=page_limit, decode_page=self._projector.decode_page,
        )
        return fastpath.ProjectedFleet(
            items, rv, self._projector.reuse,
            pages=self._projector.take_walk_pages(),
        )

    @property
    def projector_stats(self) -> Optional[dict]:
        """The projection decoder's reuse counters (None before the first
        projected LIST) — bench/test seam, not a payload surface."""
        return self._projector.stats if self._projector is not None else None

    # A healthy-but-quiet watch stream with bookmarks enabled still ticks
    # about once a minute; silence past this long means the connection is
    # dead in a way no FIN ever announced (NAT timeout, yanked cable) and
    # the reader should surface stream loss instead of waiting forever.
    WATCH_READ_TIMEOUT_S = 300.0

    def watch_nodes(
        self,
        resource_version: Optional[str],
        label_selector: Optional[str] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
        read_timeout: float = WATCH_READ_TIMEOUT_S,
        allow_bookmarks: bool = True,
    ):
        """Open ``GET /api/v1/nodes?watch=1`` as a live line stream.

        Returns a :class:`_StreamingResponse` whose ``iter_lines`` yields
        one JSON watch event per frame (ADDED/MODIFIED/DELETED/BOOKMARK/
        ERROR).  Raises :class:`WatchGone` when the server answers 410 —
        the resourceVersion was compacted away and the caller must relist.
        Bookmarks are requested by default so the cache's resumption point
        keeps advancing through quiet stretches.
        """
        params = {"watch": "1"}
        if resource_version:
            params["resourceVersion"] = str(resource_version)
        if allow_bookmarks:
            params["allowWatchBookmarks"] = "true"
        if label_selector:
            params["labelSelector"] = label_selector
        stream = self._session.stream(
            f"{self.config.server}/api/v1/nodes",
            params=params,
            timeout=timeout,
            read_timeout=read_timeout,
        )
        stream.raise_for_status()
        return stream

    # Events-walk bounds: these fetches run against an API server that is
    # ALREADY degraded (the node is sick), possibly for several nodes at
    # once — 10 pages × 100 events is far past any TTL'd per-node stream,
    # and the hard cap keeps a runaway event storm from turning triage into
    # more load on the wounded control plane.
    EVENTS_PAGE_LIMIT = 100
    EVENTS_MAX_PAGES = 10

    def list_node_events(
        self,
        name: str,
        timeout: float = DEFAULT_TIMEOUT_S,
        limit: int = EVENTS_PAGE_LIMIT,
    ) -> List[dict]:
        """Recent Events for one Node object — the ``kubectl describe node``
        triage block, fetched only for sick nodes under ``--node-events``.

        ``GET /api/v1/events`` with a server-side fieldSelector (Node events
        live in the ``default`` namespace but the cluster-scoped list with
        ``involvedObject`` filtering covers every writer), paged in
        ``limit``-sized chunks through the same walk the node LIST uses
        (410-restart included).  The continue token IS followed to the end
        whenever possible: etcd returns events oldest-first, so abandoning
        the walk early would keep a week-old Normal and drop the fresh
        SystemOOM that explains the outage.  ``EVENTS_MAX_PAGES`` pages
        (1000 events at the default limit) is far past any TTL'd per-node
        stream; past it the shortfall is NOTED on stderr — the newest tail
        may be missing, and pretending otherwise would be worse.  Needs
        ``events: list`` RBAC (deploy/rbac.yaml).
        """
        return self.list_node_events_paged(name, timeout=timeout, limit=limit)[0]

    def list_node_events_paged(
        self,
        name: str,
        timeout: float = DEFAULT_TIMEOUT_S,
        limit: int = EVENTS_PAGE_LIMIT,
    ) -> Tuple[List[dict], bool]:
        """:meth:`list_node_events` plus an explicit truncation verdict.

        ``(items, truncated)`` — ``truncated`` is True when the walk
        exhausted :data:`EVENTS_MAX_PAGES` with the continue token still
        set, meaning the NEWEST events (etcd returns oldest-first) may be
        missing from triage.  The shortfall is counted
        (``transport_stats()['list_truncated']``) and noted on stderr;
        the checker additionally stamps it into the payload's degradation
        detail — a capped walk must never read as a complete one.
        """
        params = {
            "fieldSelector": (
                f"involvedObject.kind=Node,involvedObject.name={name}"
            ),
            "limit": str(limit),
        }
        items, leftover, _rv = self._paged_list(
            "/api/v1/events", params, timeout, max_pages=self.EVENTS_MAX_PAGES
        )
        if leftover:
            self._count_truncation("events")
            print(
                f"node {name}: event list exceeded {self.EVENTS_MAX_PAGES} "
                "pages; the newest events may be missing from triage",
                file=sys.stderr,
            )
        return items, bool(leftover)

    def _count_truncation(self, resource: str) -> None:
        # Locked: the per-sick-node events walks fan out across threads.
        with self._trunc_lock:
            self.truncations[resource] = self.truncations.get(resource, 0) + 1

    def set_retry_policy(self, policy) -> None:
        """Install (or clear) the graded retry policy on the transport.

        Called by the checker once per round with a fresh shared budget.
        Sessions that don't declare the attribute (a drop-in
        ``requests.Session``) are left untouched — they bring their own
        retry story."""
        if hasattr(self._session, "retry_policy"):
            self._session.retry_policy = policy

    def transport_stats(self) -> dict:
        """Connection-pool + retry telemetry from the session, when it keeps
        any (the stdlib transport does; a drop-in requests.Session reports
        nothing).  Counters are session-lifetime monotonic."""
        stats = {}
        for key in ("connections_opened", "requests_sent", "requests_reused", "retries"):
            value = getattr(self._session, key, None)
            if isinstance(value, int) and not isinstance(value, bool):
                stats[key] = value
        by_reason = getattr(self._session, "retries_by_reason", None)
        if isinstance(by_reason, dict) and by_reason:
            stats["retries_by_reason"] = dict(by_reason)
        with self._trunc_lock:
            if self.truncations:
                # Only when a truncation actually happened: healthy rounds'
                # payloads stay byte-identical to the pre-truncation-stat
                # surface (pinned by the fast-path parity tests).
                stats["list_truncated"] = dict(self.truncations)
        return stats

    def close(self) -> None:
        """Release pooled connections, when the session pools any."""
        close = getattr(self._session, "close", None)
        if callable(close):
            close()

    def cordon_node(self, name: str, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        """``PATCH /api/v1/nodes/{name}`` → ``spec.unschedulable=true``.

        The same strategic-merge patch ``kubectl cordon`` sends, plus the
        :data:`QUARANTINE_ANNOTATION` marking the cordon as OURS — the
        uncordon path refuses to touch nodes a human cordoned.  Requires
        the ``patch`` verb on nodes (see deploy/rbac.yaml).
        """
        import time as _time

        self._patch_node(
            name,
            {
                "metadata": {
                    "annotations": {QUARANTINE_ANNOTATION: str(round(_time.time(), 3))}
                },
                "spec": {"unschedulable": True},
            },
            timeout,
        )

    def uncordon_node(self, name: str, timeout: float = DEFAULT_TIMEOUT_S) -> None:
        """Lift a quarantine: ``spec.unschedulable=false`` + drop the
        annotation (strategic-merge ``null`` removes a map key)."""
        self._patch_node(
            name,
            {
                "metadata": {"annotations": {QUARANTINE_ANNOTATION: None}},
                "spec": {"unschedulable": False},
            },
            timeout,
        )

    def clear_quarantine_annotation(
        self, name: str, timeout: float = DEFAULT_TIMEOUT_S
    ) -> None:
        """Drop a stale quarantine annotation WITHOUT touching spec.

        Hygiene for the out-of-band-uncordon case: ``kubectl uncordon`` only
        flips ``spec.unschedulable`` and leaves our annotation behind; were
        it kept, a later *human* cordon on the node would read as ours and
        be auto-lifted."""
        self._patch_node(
            name,
            {"metadata": {"annotations": {QUARANTINE_ANNOTATION: None}}},
            timeout,
        )

    # Pods-per-node walk bound: a TPU host runs a handful of pods; one page
    # is the steady state and 10 pages (2500 pods) is far past any node.
    PODS_PAGE_LIMIT = 250
    PODS_MAX_PAGES = 10

    def list_node_pods(
        self, name: str, timeout: float = DEFAULT_TIMEOUT_S
    ) -> List[dict]:
        """Pods scheduled on one node — the drain actuator's eviction list.

        ``GET /api/v1/pods`` with a server-side ``spec.nodeName`` field
        selector, paged through the same walk the node LIST uses.  Needs
        ``pods: list`` RBAC (deploy/rbac.yaml).  A walk that exhausts its
        page budget is counted (``list_truncated``) like any other capped
        LIST — a drain must never silently believe it saw every pod.
        """
        params = {
            "fieldSelector": f"spec.nodeName={name}",
            "limit": str(self.PODS_PAGE_LIMIT),
        }
        items, leftover, _rv = self._paged_list(
            "/api/v1/pods", params, timeout, max_pages=self.PODS_MAX_PAGES
        )
        if leftover:
            self._count_truncation("pods")
            print(
                f"node {name}: pod list exceeded {self.PODS_MAX_PAGES} "
                "pages; the drain's eviction list may be incomplete",
                file=sys.stderr,
            )
        return items

    def evict_pod(
        self,
        namespace: str,
        name: str,
        grace_seconds: Optional[int] = None,
        timeout: float = DEFAULT_TIMEOUT_S,
    ) -> None:
        """``POST .../pods/{name}/eviction`` — the polite delete.

        The Eviction subresource gives PodDisruptionBudgets their vote: a
        409/429 refusal surfaces as :class:`ClusterAPIError` with the
        status code attached, which the drain actuator maps to a budget
        denial (``reason="pdb"``), never an error.  Requires the
        ``create`` verb on ``pods/eviction`` (deploy/rbac.yaml).
        """
        body: dict = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        if grace_seconds is not None:
            body["deleteOptions"] = {"gracePeriodSeconds": int(grace_seconds)}
        resp = self._session.post(
            f"{self.config.server}/api/v1/namespaces/{namespace}/pods/"
            f"{name}/eviction",
            data=json.dumps(body),
            headers={"Content-Type": "application/json"},
            timeout=timeout,
        )
        resp.raise_for_status()

    def _patch_node(self, name: str, body: dict, timeout: float) -> None:
        resp = self._session.patch(
            f"{self.config.server}/api/v1/nodes/{name}",
            data=json.dumps(body),
            headers={"Content-Type": "application/strategic-merge-patch+json"},
            timeout=timeout,
        )
        resp.raise_for_status()
