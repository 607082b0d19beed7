"""Invariant lints: rules that pin prose invariants from DESIGN.md/CHANGES.md.

Each rule's ``doc`` states the invariant; the rationale back-pointers live in
the DESIGN.md §11 table.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from tpu_node_checker_torch.analysis.engine import FileContext, Finding
from tpu_node_checker_torch.analysis.rules.base import (
    Rule,
    call_name,
    const_str,
    dotted_name,
    fstring_head,
    fstring_tail,
    iter_type_lines,
    walk_skipping_nested_functions,
)

# Call names that block: sleeps, file/socket I/O, subprocesses.  A heuristic
# allowlist by design — the point is to catch the obvious regressions a
# refactor introduces, not to prove non-blocking-ness.
BLOCKING_CALLS = {
    "time.sleep",
    "open",
    "io.open",
    "os.open", "os.read", "os.write", "os.fsync",
    "socket.socket", "socket.create_connection",
    "subprocess.run", "subprocess.Popen", "subprocess.check_output",
    "subprocess.check_call", "subprocess.call",
    "urllib.request.urlopen", "urlopen",
}

METRIC_PREFIX = "tpu_node_checker_"


def _is_broad(handler: ast.ExceptHandler) -> bool:
    def broad_name(node) -> bool:
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        return name in ("Exception", "BaseException")

    if handler.type is None:
        return True
    if broad_name(handler.type):
        return True
    if isinstance(handler.type, ast.Tuple):
        return any(broad_name(elt) for elt in handler.type.elts)
    return False


class BroadExcept(Rule):
    slug = "broad-except"
    code = "TNC010"
    doc = ("``except Exception``/bare ``except`` must re-raise or carry an "
           "allow-comment naming why swallowing everything is the contract "
           "at that site")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
                continue
            if any(isinstance(n, ast.Raise) for n in ast.walk(node)):
                continue  # re-raises (even conditionally) — error still surfaces
            yield self.finding(
                ctx.path, node,
                "broad except without re-raise: narrow the exception type, "
                "or state the contract with "
                "'# tnc: allow-broad-except(reason)'",
            )


class BlockingReadPath(Rule):
    slug = "blocking-read-path"
    code = "TNC011"
    doc = ("the fleet API snapshot read path (server GET handlers, "
           "``negotiate``, the worker pool's fast-path responders, "
           "everything in snapshot.py that is not a builder) takes no "
           "locks and does no blocking I/O")

    # Builder-side functions in snapshot.py: run once per round, off the
    # request path, so blocking work is their job.  The TrendCache's
    # ``_rebuild``/``_build_entity`` belong here too: they execute on the
    # tnc-trend-swr thread (or the sanctioned first build), and the
    # transitive rule (TNC111) surfaced them as phantom read roots when
    # they were enumerated as such.
    _SNAPSHOT_BUILDERS = ("build_", "json_entity", "__init__",
                          "_rebuild", "_build_entity")

    def _read_path_functions(self, ctx: FileContext):
        if ctx.path == "tpu_node_checker_torch/server/snapshot.py":
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef) and not any(
                    node.name.startswith(p) or node.name == p
                    for p in self._SNAPSHOT_BUILDERS
                ):
                    yield node
        elif ctx.path == "tpu_node_checker_torch/server/app.py":
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef) and (
                    node.name.startswith("_get")
                    or node.name in ("_current", "handler", "ready", "_no_round")
                ):
                    yield node
        elif ctx.path == "tpu_node_checker_torch/server/router.py":
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef) and node.name == "negotiate":
                    yield node
        elif ctx.path == "tpu_node_checker_torch/federation/merge.py":
            # The merged-snapshot read path: GlobalSnapshot's accessors
            # answer every /api/v1/global/* GET — a lock there serializes
            # the aggregator's whole read surface.  Builders (build_*) and
            # the per-cluster byte caches (block/gz_member: written only by
            # the round thread, after the fetch workers joined) are the
            # merge's job and legitimately do heavy work.
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef) and (
                    node.name in ("entity", "cluster_entity")
                    or node.name.startswith("_get")
                ):
                    yield node
        elif ctx.path == "tpu_node_checker_torch/server/workers.py":
            # The accept-loop read path: the serve loop, fast-table
            # responders and header extraction run per request — a lock
            # there serializes every worker at 50k req/s.  The routed
            # fallback (`_respond_routed`) legitimately does socket I/O
            # (body reads), and accept-side bookkeeping (connection
            # registry, shed guard) may lock — neither is scanned.
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.FunctionDef) and (
                    node.name in ("_respond_fast", "_header_value",
                                  "_serve_connection")
                    or node.name.startswith("_get")
                ):
                    yield node

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for func in self._read_path_functions(ctx):
            for node in walk_skipping_nested_functions(func):
                finding = _blocking_in(self, ctx, node, f"read path {func.name!r}")
                if finding is not None:
                    yield finding


def _blocking_in(rule: Rule, ctx: FileContext, node: ast.AST,
                 where: str) -> Optional[Finding]:
    """One node's verdict under the shared blocking/locking ban."""
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in BLOCKING_CALLS:
            return rule.finding(
                ctx.path, node,
                f"blocking call {name}() on {where}",
            )
        if name is not None and name.endswith(".acquire"):
            return rule.finding(
                ctx.path, node, f"lock acquire on {where}"
            )
    if isinstance(node, ast.withitem):
        if isinstance(node.context_expr, ast.Call):
            target = call_name(node.context_expr)
        else:
            target = dotted_name(node.context_expr)
        if target is not None and "lock" in target.lower():
            return rule.finding(
                ctx.path, node.context_expr,
                f"'with {target}' takes a lock on {where}",
            )
    return None


class SignalHandlerBlocking(Rule):
    slug = "signal-handler-blocking"
    code = "TNC012"
    doc = ("functions registered via ``signal.signal`` only flip flags/events "
           "— no sleeps, no I/O, no locks (they preempt arbitrary frames)")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        handler_names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and call_name(node) == "signal.signal"
                    and len(node.args) == 2
                    and isinstance(node.args[1], ast.Name)):
                handler_names.add(node.args[1].id)
        if not handler_names:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef) and node.name in handler_names:
                for inner in walk_skipping_nested_functions(node):
                    finding = _blocking_in(
                        self, ctx, inner, f"signal handler {node.name!r}"
                    )
                    if finding is not None:
                        yield finding


class MutableDefault(Rule):
    slug = "mutable-default"
    code = "TNC013"
    doc = "no mutable default arguments (list/dict/set literals or constructors)"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for default in defaults:
                bad = isinstance(default, (ast.List, ast.Dict, ast.Set))
                if isinstance(default, ast.Call):
                    bad = call_name(default) in ("list", "dict", "set")
                if bad:
                    yield self.finding(
                        ctx.path, default,
                        f"mutable default argument in {node.name}() — "
                        "shared across calls; use None and create inside",
                    )


class MetricName(Rule):
    slug = "metric-name"
    code = "TNC014"
    doc = (f"every emitted metric family starts ``{METRIC_PREFIX}`` and "
           "counter families end ``_total``")

    def _family_name(self, arg: ast.AST):
        """(display_name, startswith_ok, tail) for a literal or f-string."""
        lit = const_str(arg)
        if lit is not None:
            return lit, lit.startswith(METRIC_PREFIX), lit
        head = fstring_head(arg)
        if head is not None:
            tail = fstring_tail(arg) or ""
            return head + "{…}", head.startswith(METRIC_PREFIX), tail
        return None, True, None

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name in ("family", "_line") and node.args:
                    display, ok, tail = self._family_name(node.args[0])
                    if display is None:
                        continue
                    if not ok:
                        yield self.finding(
                            ctx.path, node.args[0],
                            f"metric {display!r} does not start with "
                            f"'{METRIC_PREFIX}' — one namespace, grep-able "
                            "fleet-wide",
                        )
                    if (name == "family" and len(node.args) >= 2
                            and const_str(node.args[1]) == "counter"
                            and tail is not None
                            and not tail.endswith("_total")):
                        yield self.finding(
                            ctx.path, node.args[0],
                            f"counter family {display!r} does not end "
                            "'_total' (Prometheus naming contract)",
                        )
            # Hand-built exposition blocks ("# TYPE name counter" literals,
            # e.g. the server stats block) follow the same contract.
            lit = const_str(node) if isinstance(node, ast.Constant) else None
            if lit:
                for mname, mtype in iter_type_lines(lit):
                    if not mname.startswith(METRIC_PREFIX):
                        yield self.finding(
                            ctx.path, node,
                            f"metric {mname!r} in TYPE line does not "
                            f"start with '{METRIC_PREFIX}'",
                        )
                    if mtype == "counter" and not mname.endswith("_total"):
                        yield self.finding(
                            ctx.path, node,
                            f"counter {mname!r} in TYPE line does not "
                            "end '_total'",
                        )


class ExitCode(Rule):
    slug = "exit-code"
    code = "TNC015"
    doc = ("``sys.exit``/``SystemExit`` with a bare integer is cli.py's "
           "privilege — everywhere else uses the symbolic EXIT_* constants "
           "(the exit-code contract is documented API)")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package() or ctx.path == "tpu_node_checker_torch/cli.py":
            return
        for node in ast.walk(ctx.tree):
            arg = None
            # SystemExit is matched only on the Raise node, never the bare
            # Call — otherwise `raise SystemExit(n)` reports twice (the walk
            # visits both the Raise and the Call inside it).
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name in ("sys.exit", "exit", "os._exit") and node.args:
                    arg = node.args[0]
            elif isinstance(node, ast.Raise) and isinstance(
                    node.exc, ast.Call) and call_name(node.exc) == "SystemExit":
                arg = node.exc.args[0] if node.exc.args else None
            if (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, int)
                    and not isinstance(arg.value, bool)):
                yield self.finding(
                    ctx.path, node,
                    f"non-symbolic exit code {arg.value} outside cli.py — "
                    "use the EXIT_* constants so the documented contract "
                    "has one source of truth",
                )


class ObsDiscipline(Rule):
    slug = "obs-discipline"
    code = "TNC017"
    doc = ("spans close via ``with`` — a bare ``start_span()`` call outside "
           "a with-context is never closed and silently corrupts every span "
           "offset after it — and ``HistogramFamily`` names carry an explicit "
           "unit suffix (``_ms``, or ``_us`` for microsecond-scale mesh link "
           "timings) with their buckets declared at the instantiation (an "
           "implicit default would mis-bucket the next family measured in "
           "seconds)")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        with_calls: Set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        with_calls.add(id(item.context_expr))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if ((name == "start_span" or name.endswith(".start_span"))
                    and id(node) not in with_calls):
                yield self.finding(
                    ctx.path, node,
                    "bare start_span() outside a 'with' — an unclosed span "
                    "corrupts every offset recorded after it; use "
                    "'with tracer.span(...)'",
                )
            if name == "HistogramFamily" or name.endswith(".HistogramFamily"):
                lit = const_str(node.args[0]) if node.args else None
                if lit is not None and not (lit.endswith("_ms")
                                            or lit.endswith("_us")):
                    yield self.finding(
                        ctx.path, node.args[0],
                        f"histogram family {lit!r} does not end '_ms' or "
                        "'_us' — every latency family in this tree declares "
                        "its unit in the name; a mixed unit poisons "
                        "histogram_quantile() across families",
                    )
                if (len(node.args) < 3
                        and not any(kw.arg == "buckets"
                                    for kw in node.keywords)):
                    yield self.finding(
                        ctx.path, node,
                        "HistogramFamily without declared buckets — an "
                        "implicit default silently mis-buckets the next "
                        "family measured on a different scale; pass the "
                        "bucket tuple explicitly",
                    )


class ListHotPathDecode(Rule):
    slug = "list-hotpath-decode"
    code = "TNC018"
    doc = ("no full-body JSON decode on the paginated LIST hot path — "
           "cluster.py's walk/list functions and everything in "
           "tpu_node_checker_torch/fastpath/ decode pages through "
           "``fastpath.oracle_decode_page`` (the one sanctioned "
           "``json.loads`` site) or the projection scanner; a stray "
           "``loads``/``resp.json()`` there re-materializes managedFields "
           "for 5k nodes per round and silently undoes the relist fast "
           "path")

    # The LIST walk and every list method riding it: the functions whose
    # per-page cost model the fast path owns.  _Response.json() and the
    # kubeconfig/identity paths are deliberately out of scope — they are
    # not per-page work.
    _CLUSTER_FUNCS = (
        "_paged_list", "_oracle_page_decoder", "list_nodes",
        "list_nodes_with_rv", "list_nodes_projected", "list_node_events",
        "list_node_events_paged",
    )
    # The one sanctioned full-body decode (fastpath/projection.py).
    _SANCTIONED = "oracle_decode_page"

    def _scanned_functions(self, ctx: FileContext):
        if ctx.path == "tpu_node_checker_torch/cluster.py":
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.FunctionDef)
                        and node.name in self._CLUSTER_FUNCS):
                    yield node
        elif ctx.path.startswith("tpu_node_checker_torch/fastpath/"):
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.FunctionDef)
                        and node.name != self._SANCTIONED):
                    yield node

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for func in self._scanned_functions(ctx):
            for node in walk_skipping_nested_functions(func):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name is None:
                    continue
                if (name in ("json.loads", "loads")
                        or name.endswith(".json")):
                    yield self.finding(
                        ctx.path, node,
                        f"full-body decode {name}() in {func.name}() on "
                        "the LIST hot path — route the page through "
                        "fastpath.oracle_decode_page (the sanctioned "
                        "fallback) or the projection scanner",
                    )


class ActuatorGate(Rule):
    slug = "actuator-gate"
    code = "TNC019"
    doc = ("every actuator call site (cordon_node/uncordon_node/"
           "clear_quarantine_annotation/evict_pod) lives in "
           "remediation/actuate.py, reachable only through the budget "
           "engine's Decision — and each actuating function there takes a "
           "``decision`` parameter and emits an audit event")

    _ACTUATORS = ("cordon_node", "uncordon_node",
                  "clear_quarantine_annotation", "evict_pod")
    _SANCTIONED = "tpu_node_checker_torch/remediation/actuate.py"
    # cluster.py DEFINES the client methods (their bodies call the raw
    # transport, not each other) — definitions are not call sites.
    _DEFINER = "tpu_node_checker_torch/cluster.py"

    def _actuator_calls(self, tree: ast.AST):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name is not None and name.split(".")[-1] in self._ACTUATORS:
                    yield node, name

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package() or ctx.path == self._DEFINER:
            return
        if ctx.path != self._SANCTIONED:
            for node, name in self._actuator_calls(ctx.tree):
                yield self.finding(
                    ctx.path, node,
                    f"actuator call {name}() outside the budget-gated "
                    "actuate module — route it through "
                    "remediation.actuate so the Decision gate and the "
                    "audit event cannot be skipped",
                )
            return
        # Inside the sanctioned module: every function that actuates must
        # carry the Decision (the proof the budget engine ran) and emit
        # the audit event — an audit-free actuator is a silent one.
        for func in ast.walk(ctx.tree):
            if not isinstance(func, ast.FunctionDef):
                continue
            calls = [
                name
                for node in walk_skipping_nested_functions(func)
                if isinstance(node, ast.Call)
                and (name := call_name(node)) is not None
                and name.split(".")[-1] in self._ACTUATORS
            ]
            if not calls:
                continue
            arg_names = {a.arg for a in func.args.args}
            arg_names |= {a.arg for a in func.args.kwonlyargs}
            if "decision" not in arg_names:
                yield self.finding(
                    ctx.path, func,
                    f"{func.name}() calls {calls[0]}() without taking a "
                    "'decision' parameter — the budget engine's Decision "
                    "is the proof the gate ran",
                )
            emits = any(
                isinstance(node, ast.Call)
                and (name := call_name(node)) is not None
                and name.split(".")[-1] in ("emit", "_audit")
                for node in walk_skipping_nested_functions(func)
            )
            if not emits:
                yield self.finding(
                    ctx.path, func,
                    f"{func.name}() actuates ({calls[0]}) but emits no "
                    "audit event — every actuation is one event-log line",
                )


class RollupWriteGate(Rule):
    slug = "rollup-write-gate"
    code = "TNC021"
    doc = ("analytics roll-up bytes reach disk only through "
           "``segments.append_bucket`` (or compaction's schema-checked "
           "rewrite): the raw segment I/O primitives "
           "(``rollup_append_lines``/``rollup_replace_file``) may be "
           "called only inside analytics/segments.py, and every caller "
           "there must reference ``ROLLUP_SCHEMA_VERSION`` — the proof "
           "its lines are schema-stamped (the TNC019 actuator-gate "
           "pattern, applied to the store); the sketch persistence "
           "entry points (``sketch_state``/``sketch_from_state``) ride "
           "the same gate — callable only from segments.py and their "
           "definer sketch.py, so sketch bytes reach segment records "
           "only inside schema-stamped lines (the free read/merge "
           "surface is ``Sketch.to_doc``/``merge_state_docs``)")

    _PRIMITIVES = ("rollup_append_lines", "rollup_replace_file")
    # Sketch serialization/deserialization against SEGMENT RECORDS: a
    # persistence surface, not a query surface — gated like the raw I/O
    # (the wire/query shape has its own ungated entry points).
    _SKETCH_PRIMITIVES = ("sketch_state", "sketch_from_state")
    _SANCTIONED = "tpu_node_checker_torch/analytics/segments.py"
    # Where the sketch primitives are DEFINED (and self-referenced).
    _DEFINER = "tpu_node_checker_torch/analytics/sketch.py"
    _SCHEMA_CONST = "ROLLUP_SCHEMA_VERSION"

    def _primitive_calls(self, tree: ast.AST, names=None):
        primitives = names if names is not None else self._PRIMITIVES
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if (name is not None
                        and name.split(".")[-1] in primitives):
                    yield node, name

    @classmethod
    def _references_schema(cls, func: ast.FunctionDef) -> bool:
        # Either the constant itself, or a call to the stamp helper that
        # applies it (stamp_bucket) — both prove the lines carry the
        # major.
        for node in walk_skipping_nested_functions(func):
            if isinstance(node, ast.Name) and node.id == cls._SCHEMA_CONST:
                return True
            if (isinstance(node, ast.Attribute)
                    and node.attr == cls._SCHEMA_CONST):
                return True
            if (isinstance(node, ast.Call)
                    and (name := call_name(node)) is not None
                    and name.split(".")[-1] == "stamp_bucket"):
                return True
        return False

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        if ctx.path not in (self._SANCTIONED, self._DEFINER):
            for node, name in self._primitive_calls(
                    ctx.tree, self._SKETCH_PRIMITIVES):
                yield self.finding(
                    ctx.path, node,
                    f"sketch persistence {name}() outside "
                    "analytics/segments.py — sketch bytes reach segment "
                    "records only through the store's schema-stamped "
                    "append path; read or merge sketches through "
                    "Sketch.to_doc()/merge_state_docs() instead",
                )
        if ctx.path != self._SANCTIONED:
            for node, name in self._primitive_calls(ctx.tree):
                yield self.finding(
                    ctx.path, node,
                    f"raw segment write {name}() outside the gated "
                    "segments module — route roll-up writes through "
                    "segments.append_bucket so the schema stamp and the "
                    "append-only/compaction discipline cannot be skipped",
                )
            return
        # Inside the sanctioned module: every function touching the raw
        # I/O must reference the schema major — unstamped lines would be
        # refused by the next load (the history store's version rule).
        for func in ast.walk(ctx.tree):
            if not isinstance(func, ast.FunctionDef):
                continue
            if func.name in self._PRIMITIVES:
                continue  # the primitives themselves only do I/O
            calls = [
                name
                for node in walk_skipping_nested_functions(func)
                if isinstance(node, ast.Call)
                and (name := call_name(node)) is not None
                and name.split(".")[-1] in self._PRIMITIVES
            ]
            if calls and not self._references_schema(func):
                yield self.finding(
                    ctx.path, func,
                    f"{func.name}() writes segment lines ({calls[0]}) "
                    f"without referencing {self._SCHEMA_CONST} — roll-up "
                    "lines must be schema-stamped (append_bucket is the "
                    "gate; compaction must filter/stamp by the major)",
                )


class SimDeterminism(Rule):
    slug = "sim-determinism"
    code = "TNC020"
    doc = ("inside ``tpu_node_checker_torch/sim/`` all randomness flows from a "
           "seeded ``random.Random`` and all time from the injectable "
           "clock seam (``sim/clock.py``, the one exempt file): "
           "module-level ``random.*`` calls, wall-clock reads "
           "(``time.time``/``monotonic``/``perf_counter``, "
           "``datetime.now``/``utcnow``), ``time.sleep`` pacing, "
           "``os.urandom`` and ``uuid4`` are findings — each one breaks "
           "the same-seed-byte-identical replay contract")

    _SEAM = "tpu_node_checker_torch/sim/clock.py"
    # The stdlib's GLOBAL RNG surface — process-wide hidden state no seed
    # argument reaches.  random.Random(seed) instances are the sanctioned
    # shape and deliberately absent.
    _GLOBAL_RNG = {
        f"random.{fn}" for fn in (
            "random", "randint", "randrange", "choice", "choices",
            "shuffle", "sample", "uniform", "gauss", "getrandbits",
            "seed", "betavariate", "expovariate", "triangular",
        )
    }
    _WALL = {
        "time.time": "wall-clock read",
        "time.time_ns": "wall-clock read",
        "time.monotonic": "wall-clock read",
        "time.monotonic_ns": "wall-clock read",
        "time.perf_counter": "wall-clock read",
        "time.perf_counter_ns": "wall-clock read",
        "datetime.now": "wall-clock read",
        "datetime.utcnow": "wall-clock read",
        "datetime.datetime.now": "wall-clock read",
        "datetime.datetime.utcnow": "wall-clock read",
        "time.sleep": "real sleep",
        "os.urandom": "entropy read",
        "uuid.uuid4": "entropy read",
        "uuid4": "entropy read",
    }

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if (not ctx.path.startswith("tpu_node_checker_torch/sim/")
                or ctx.path == self._SEAM):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name in self._GLOBAL_RNG:
                yield self.finding(
                    ctx.path, node,
                    f"global-RNG call {name}() in the simulator — draw "
                    "from the run's seeded random.Random so the same "
                    "seed replays byte-identically",
                )
            kind = self._WALL.get(name)
            if kind == "entropy read":
                yield self.finding(
                    ctx.path, node,
                    f"entropy read {name}() in the simulator — "
                    "unseedable randomness can never replay; draw from "
                    "the run's seeded random.Random instead",
                )
            elif kind:
                yield self.finding(
                    ctx.path, node,
                    f"{kind} {name}() in the simulator — route time "
                    "through the injectable clock seam (sim/clock.py) so "
                    "scenario replay stays deterministic",
                )


class TestWallClock(Rule):
    slug = "test-wall-clock"
    code = "TNC016"
    doc = ("tests never really sleep or read the wall clock for pacing — "
           "inject a fake clock (see tests/test_retry.py); a bounded "
           "thread-join poll needs an allow-comment")

    _BANNED = {
        "time.sleep": "real sleep",
        "datetime.now": "wall-clock read",
        "datetime.utcnow": "wall-clock read",
        "datetime.datetime.now": "wall-clock read",
        "datetime.datetime.utcnow": "wall-clock read",
    }

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_tests():
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                kind = self._BANNED.get(name or "")
                if kind:
                    yield self.finding(
                        ctx.path, node,
                        f"{kind} {name}() in tests — fake the clock, or "
                        "justify a bounded wait with "
                        "'# tnc: allow-test-wall-clock(reason)'",
                    )


RULES: List[Rule] = [
    BroadExcept(),
    BlockingReadPath(),
    SignalHandlerBlocking(),
    MutableDefault(),
    MetricName(),
    ExitCode(),
    ObsDiscipline(),
    ListHotPathDecode(),
    ActuatorGate(),
    RollupWriteGate(),
    SimDeterminism(),
    TestWallClock(),
]
