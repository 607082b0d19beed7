"""Typestate tier: exception escape + resource lifecycle as abstract
interpretation (TNC114–TNC117).

The PR 13 graph answers "who calls whom"; this module answers "what can
go WRONG along those calls" with two interprocedural summaries and one
intraprocedural abstract interpreter:

* **escape summaries** — per function, the set of exception *class names*
  that can propagate out of it: explicit ``raise`` sites ∪ resolved-callee
  escapes − classes handled by enclosing ``try``/``except`` edges, run to
  a fixpoint over the call graph.  Dynamic-dispatch fallback edges widen
  to ``Exception`` (an unknown receiver is an unknown raise); external
  and unresolved calls contribute nothing (their failure modes are the
  stdlib's, not this tree's — counted as a soundness caveat, DESIGN §11).
* **release/store summaries** — per function, which positional parameters
  it releases (``close``/``shutdown``/``join``/``release``) or stores
  into outliving state (``self.x = p``, container sinks), again to a
  fixpoint so ``adopt(sock)`` → ``self._register(sock)`` transfers.
* **the interpreter** — a structural walk of each function body carrying
  an obligation environment through branch joins (OPEN wins), loop
  bodies (one-pass join), ``with`` desugaring (a managed resource is
  born released), and ``try``/``except``/``finally`` edges (the finally
  block runs on every exit path; handler entry is the OPEN-biased merge
  of every body program point).  A statement whose calls can raise (per
  the escape summaries) forks an exceptional exit, so "closed on the
  happy path, leaked when the callee throws" — the PR 7 accept-loop
  bug's exact shape — is a path the interpreter actually walks.

The four rules riding it are defined here and appended to
``flow.rules.RULES`` (no registry surgery per rule — ROADMAP item 5's
backend plugins will land under them the same way).

Soundness caveats, counted once and documented in DESIGN §11: ``assert``
is ignored (disabled under ``-O``); externals neither raise nor leak;
handing a tracked value to an external/unresolved callee transfers the
obligation (benefit of the doubt); aliasing is one level (``y = x``
moves the obligation, blame stays on the acquire line); the loop join is
one-pass; ``raise`` from a computed value widens to ``Exception``.
"""

from __future__ import annotations

import ast
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.engine import Finding, Project
from tpu_node_checker_torch.analysis.rules.base import (
    Rule,
    walk_skipping_nested_functions,
)
from tpu_node_checker_torch.analysis.flow.graph import (
    CallGraph,
    FunctionNode,
    _dotted,
)

# -- exception-name lattice -------------------------------------------------

# Pragmatic builtin hierarchy: parent links for every class this tree
# raises or catches, so ``except OSError`` covers a ConnectionResetError
# escape.  Project-defined exception classes graft on via their resolved
# base names (``_project_exc_parents``).
_BUILTIN_EXC_PARENT: Dict[str, Optional[str]] = {
    "BaseException": None,
    "Exception": "BaseException",
    "SystemExit": "BaseException",
    "KeyboardInterrupt": "BaseException",
    "GeneratorExit": "BaseException",
    "ArithmeticError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "AssertionError": "Exception",
    "AttributeError": "Exception",
    "EOFError": "Exception",
    "ImportError": "Exception",
    "ModuleNotFoundError": "ImportError",
    "LookupError": "Exception",
    "IndexError": "LookupError",
    "KeyError": "LookupError",
    "MemoryError": "Exception",
    "NameError": "Exception",
    "OSError": "Exception",
    "IOError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "PermissionError": "OSError",
    "InterruptedError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "TimeoutError": "OSError",
    "ConnectionError": "OSError",
    "BrokenPipeError": "ConnectionError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "ReferenceError": "Exception",
    "RuntimeError": "Exception",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "StopIteration": "Exception",
    "StopAsyncIteration": "Exception",
    "SyntaxError": "Exception",
    "IndentationError": "SyntaxError",
    "SystemError": "Exception",
    "TypeError": "Exception",
    "ValueError": "Exception",
    "UnicodeError": "ValueError",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
    "Warning": "Exception",
}

# The abstract "could be anything raisable" element (dynamic dispatch,
# re-raise of an unknown in-flight exception, computed raise values).
WIDENED = "Exception"


def _terminal(dotted: Optional[str]) -> Optional[str]:
    return dotted.rpartition(".")[2] if dotted else None


def _project_exc_parents(graph: CallGraph) -> Dict[str, Set[str]]:
    """Class NAME -> base terminal names, for every project class.  Keyed
    by bare name (module-level collisions union — conservative: a name
    with two parents is covered by a handler for either)."""
    parents: Dict[str, Set[str]] = {}
    for cls in graph.classes.values():
        bases = {t for t in (_terminal(b) for b in cls.bases) if t}
        if bases:
            parents.setdefault(cls.name, set()).update(bases)
    return parents


def covers(handler: str, esc: str,
           exc_parents: Dict[str, Set[str]]) -> bool:
    """Does ``except <handler>`` catch an escape named ``esc``?  Walks
    esc's ancestor chain through project bases + the builtin table."""
    if handler == "BaseException":
        return True
    seen: Set[str] = set()
    stack = [esc]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        if name == handler:
            return True
        project = exc_parents.get(name)
        if project:
            stack.extend(project)
        parent = _BUILTIN_EXC_PARENT.get(name)
        if parent:
            stack.append(parent)
        elif parent is None and name not in _BUILTIN_EXC_PARENT \
                and not project:
            # Unknown class (stdlib-but-not-builtin — BadStatusLine,
            # JSONDecodeError — or an aliased import): every raisable
            # class except the BaseException trio derives from
            # Exception, so assume that link.  Caveat (DESIGN §11): an
            # unknown SystemExit-alike would be wrongly considered
            # caught by ``except Exception``.
            stack.append("Exception")
    return False


def _handler_names(handler: ast.ExceptHandler) -> Tuple[str, ...]:
    """Caught class names of one except clause (bare → BaseException)."""
    t = handler.type
    if t is None:
        return ("BaseException",)
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    names = tuple(n for n in (_terminal(_dotted(e)) for e in elts) if n)
    return names or ("BaseException",)


# -- tracked resources ------------------------------------------------------

# Acquisition call (as written, dotted) -> (label, release verbs).  Any
# verb releases; ``with``-managing the value or transferring it (return /
# store into self / hand to a releasing or unknown callee) also
# discharges the obligation.
_ACQUIRERS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "socket.socket": ("socket", ("close", "detach")),
    "socket.create_connection": ("socket", ("close", "detach")),
    "socket.create_server": ("listener", ("close",)),
    "open": ("file", ("close",)),
    "io.open": ("file", ("close",)),
    "gzip.open": ("file", ("close",)),
}
# Terminal-name acquirers (imported bare: ``from http.client import …``).
_ACQUIRER_TERMINALS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "HTTPConnection": ("http-connection", ("close",)),
    "HTTPSConnection": ("http-connection", ("close",)),
    "_StdlibSession": ("session", ("close",)),
}

_RELEASE_VERBS = frozenset(("close", "shutdown", "join", "detach", "release"))
# Container/queue sinks: storing the value hands its lifetime to the
# container's owner.
_SINK_METHODS = frozenset(("append", "add", "put", "put_nowait", "insert",
                           "register", "setdefault", "update"))


def _acquisition(call: ast.Call) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """(label, verbs) when ``call`` constructs a tracked resource."""
    dotted = _dotted(call.func)
    if dotted is None:
        return None
    hit = _ACQUIRERS.get(dotted)
    if hit is not None:
        # open(..., "r"-ish) still returns a file object needing close —
        # every mode is tracked; TNC116 separately polices write modes.
        return hit
    hit = _ACQUIRER_TERMINALS.get(_terminal(dotted) or "")
    if hit is not None:
        return hit
    if dotted in ("threading.Thread", "Thread"):
        for kw in call.keywords:
            if (kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False):
                return ("non-daemon thread", ("join",))
    return None


# -- interprocedural summaries ---------------------------------------------


@dataclass
class TypestateState:
    """One summary build per Project, shared by TNC114–117."""

    escapes: Dict[str, FrozenSet[str]]  # fid -> escaping class names
    releases: Dict[str, FrozenSet[int]]  # fid -> param idx it releases
    stores: Dict[str, FrozenSet[int]]  # fid -> param idx it stores
    exc_parents: Dict[str, Set[str]]
    build_ms: float = 0.0
    # fids whose summaries a rule consulted (cache-slice bookkeeping)
    consulted: Set[str] = field(default_factory=set)
    # per-function call-expression resolution, stable across fixpoint
    # passes (id(Call node) -> (targets, kind)) — resolution is the hot
    # half of the escape fixpoint, computed once instead of per pass
    callres: Dict[int, Tuple[Tuple[str, ...], str]] = field(
        default_factory=dict)
    # one obligation-interpreter pass per function, shared by TNC115/117
    interps: Dict[str, "Interp"] = field(default_factory=dict)


def interp_results(state: TypestateState,
                   graph: CallGraph) -> Dict[str, "Interp"]:
    if not state.interps:
        for fid in sorted(graph.functions):
            interp = Interp(graph, state, graph.functions[fid])
            interp.run()
            state.interps[fid] = interp
    return state.interps


def typestate_state(project: Project) -> TypestateState:
    """Build (once per Project) the escape + release/store summaries.
    Triggers the graph build first so ``build_ms`` is summaries-only."""
    from tpu_node_checker_torch.analysis.flow.rules import flow_state

    state = getattr(project, "_typestate_state", None)
    if state is None:
        graph = flow_state(project).graph
        t0 = time.perf_counter()
        state = build_summaries(graph)
        state.build_ms = (time.perf_counter() - t0) * 1e3
        project._typestate_state = state
    return state


def build_summaries(graph: CallGraph) -> TypestateState:
    exc_parents = _project_exc_parents(graph)
    state = TypestateState(escapes={}, releases={}, stores={},
                           exc_parents=exc_parents)
    fids = sorted(graph.functions)
    callers_of: Dict[str, Set[str]] = {}
    for site in graph.calls:
        for target in site.targets:
            callers_of.setdefault(target, set()).add(site.caller)
    for fid in fids:
        state.escapes[fid] = frozenset()
        state.releases[fid] = frozenset()
        state.stores[fid] = frozenset()
    # Escape fixpoint: monotone over a finite name universe, worklist
    # seeded with every function, callers re-queued when a callee grows.
    work = list(reversed(fids))
    passes = 0
    while work and passes < 200_000:  # belt: monotonicity bounds this far lower
        passes += 1
        fid = work.pop()
        fn = graph.functions[fid]
        new = frozenset(_EscapeEval(graph, state, fn).run())
        if new != state.escapes[fid]:
            state.escapes[fid] = new
            work.extend(sorted(callers_of.get(fid, ())))
    # Release/store fixpoint (same shape, cheaper lattice).
    work = list(reversed(fids))
    passes = 0
    while work and passes < 200_000:
        passes += 1
        fid = work.pop()
        fn = graph.functions[fid]
        rel, sto = _param_summary(graph, state, fn)
        if rel != state.releases[fid] or sto != state.stores[fid]:
            state.releases[fid] = rel
            state.stores[fid] = sto
            work.extend(sorted(callers_of.get(fid, ())))
    return state


class _EscapeEval:
    """One intraprocedural escape evaluation against current summaries."""

    def __init__(self, graph: CallGraph, state: TypestateState,
                 fn: FunctionNode) -> None:
        self.graph = graph
        self.state = state
        self.fn = fn
        self.env = graph.resolver.function_env(fn)

    def run(self) -> Set[str]:
        if isinstance(self.fn.node, ast.Lambda):
            return self._calls(self.fn.node.body)
        return self._block(self.fn.node.body, ctx=None)

    def _block(self, stmts: Iterable[ast.stmt],
               ctx: Optional[Tuple[str, ...]]) -> Set[str]:
        out: Set[str] = set()
        for stmt in stmts:
            out |= self._stmt(stmt, ctx)
        return out

    def _stmt(self, stmt: ast.stmt,
              ctx: Optional[Tuple[str, ...]]) -> Set[str]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return set()
        if isinstance(stmt, ast.Raise):
            return self.raise_names(stmt, ctx)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, ctx)
        if isinstance(stmt, ast.If):
            return (self._calls(stmt.test)
                    | self._block(stmt.body, ctx)
                    | self._block(stmt.orelse, ctx))
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = stmt.test if isinstance(stmt, ast.While) else stmt.iter
            return (self._calls(head)
                    | self._block(stmt.body, ctx)
                    | self._block(stmt.orelse, ctx))
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            out: Set[str] = set()
            for item in stmt.items:
                out |= self._calls(item.context_expr)
            return out | self._block(stmt.body, ctx)
        return self._calls(stmt)

    def _try(self, node: ast.Try,
             ctx: Optional[Tuple[str, ...]]) -> Set[str]:
        body = self._block(node.body, ctx)
        handled: List[Tuple[str, ...]] = []
        out: Set[str] = set()
        for h in node.handlers:
            names = _handler_names(h)
            handled.append(names)
            out |= self._block(h.body, ctx=names)
        for esc in body:
            if not any(covers(h, esc, self.state.exc_parents)
                       for names in handled for h in names):
                out.add(esc)
        # else runs post-body, its raises bypass this try's handlers;
        # finally runs on every path and can raise in its own right.
        out |= self._block(node.orelse, ctx)
        out |= self._block(node.finalbody, ctx)
        return out

    def raise_names(self, node: ast.Raise,
                    ctx: Optional[Tuple[str, ...]]) -> Set[str]:
        out = self._calls(node)  # the constructor args can themselves call
        if node.exc is None:  # bare re-raise: the in-flight exception
            out |= set(ctx) if ctx else {WIDENED}
            return out
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        name = _terminal(_dotted(exc))
        out.add(name if name else WIDENED)
        return out

    def _calls(self, root: ast.AST) -> Set[str]:
        """Escape contribution of every call expression under ``root``
        (nested function/lambda bodies excluded — they run elsewhere)."""
        out: Set[str] = set()
        for node in walk_skipping_nested_functions(root):
            if not isinstance(node, ast.Call):
                continue
            targets, kind = _resolve_cached(self.state, self.env, node)
            if kind == "fallback":
                out.add(WIDENED)  # unknown receiver: unknown raise
                continue
            for target in targets:
                self.state.consulted.add(target)
                out |= self.state.escapes.get(target, frozenset())
        return out


def _resolve_cached(state: TypestateState, env, call: ast.Call):
    """Resolution is pass-invariant: cache per Call node.  The AST nodes
    are pinned by Project.files for the build's lifetime, so id() keys
    are stable."""
    key = id(call)
    hit = state.callres.get(key)
    if hit is None:
        hit = env.resolve_value(call.func)
        state.callres[key] = hit
    return hit


def _param_summary(graph: CallGraph, state: TypestateState,
                   fn: FunctionNode) -> Tuple[FrozenSet[int], FrozenSet[int]]:
    """(released param indices, stored param indices) for one function,
    against current callee summaries."""
    params = {name: i for i, name in enumerate(fn.params)}
    env = graph.resolver.function_env(fn)
    released: Set[int] = set()
    stored: Set[int] = set()

    def param_idx(expr: ast.AST) -> Optional[int]:
        if isinstance(expr, ast.Name):
            return params.get(expr.id)
        return None

    for node in walk_skipping_nested_functions(fn.node):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                idx = param_idx(func.value)
                if idx is not None and func.attr in _RELEASE_VERBS:
                    released.add(idx)
                if func.attr in _SINK_METHODS:
                    for arg in node.args:
                        idx = param_idx(arg)
                        if idx is not None:
                            stored.add(idx)
            targets, _kind = _resolve_cached(state, env, node)
            for target in targets:
                callee = graph.functions.get(target)
                if callee is None:
                    continue
                offset = 1 if (callee.params[:1]
                               and callee.params[0] in ("self", "cls")) else 0
                for i, arg in enumerate(node.args):
                    idx = param_idx(arg)
                    if idx is None:
                        continue
                    state.consulted.add(target)
                    pos = i + offset
                    if pos in state.releases.get(target, frozenset()):
                        released.add(idx)
                    if pos in state.stores.get(target, frozenset()):
                        stored.add(idx)
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in node.targets):
                for sub in ast.walk(node.value):
                    idx = param_idx(sub)
                    if idx is not None:
                        stored.add(idx)
    return frozenset(released), frozenset(stored)


# -- the obligation interpreter (TNC115/TNC117) -----------------------------

_OPEN, _DONE = "open", "done"


@dataclass
class _Obl:
    key: str
    var: str
    line: int
    col: int
    label: str
    verbs: Tuple[str, ...]
    release_lines: List[int] = field(default_factory=list)


@dataclass
class _Exit:
    kind: str  # return | break | continue | raise
    env: Dict[str, Tuple[str, str]]  # var -> (obl key, status)
    node: Optional[ast.AST]
    names: FrozenSet[str] = frozenset()  # raise exits: escaping classes


def _merge(envs: List[Optional[Dict[str, Tuple[str, str]]]]
           ) -> Optional[Dict[str, Tuple[str, str]]]:
    """Join: a var is OPEN if OPEN on any contributing path."""
    live = [e for e in envs if e is not None]
    if not live:
        return None
    out: Dict[str, Tuple[str, str]] = {}
    for env in live:
        for var, (key, status) in env.items():
            old = out.get(var)
            if old is None or (status == _OPEN and old[1] != _OPEN):
                out[var] = (key, status)
    return out


class Interp:
    """Abstract-interpret one function body for release obligations."""

    def __init__(self, graph: CallGraph, state: TypestateState,
                 fn: FunctionNode) -> None:
        self.graph = graph
        self.state = state
        self.fn = fn
        self.env_r = graph.resolver.function_env(fn)
        self.obls: Dict[str, _Obl] = {}
        # obl key -> earliest return/break that left it OPEN (TNC117 site)
        self.skip_sites: Dict[str, ast.AST] = {}
        # (obl key, path kind) leaks collected at function exits
        self.leaks: Dict[str, str] = {}  # key -> "normal" | "exception"

    def run(self) -> None:
        if isinstance(self.fn.node, ast.Lambda):
            return  # an expression can't hold a release obligation
        out, exits = self.exec_block(self.fn.node.body, {})
        for env in ([out] if out is not None else []):
            self._flag(env, "normal")
        for ex in exits:
            self._flag(ex.env, "exception" if ex.kind == "raise"
                       else "normal")

    def _flag(self, env: Dict[str, Tuple[str, str]], path: str) -> None:
        for _var, (key, status) in env.items():
            if status == _OPEN:
                # normal-path evidence outranks exception-path evidence
                if self.leaks.get(key) != "normal":
                    self.leaks[key] = path

    # -- block/statement execution --------------------------------------

    def exec_block(self, stmts, env):
        exits: List[_Exit] = []
        for stmt in stmts:
            if env is None:
                break
            env, stmt_exits = self.exec_stmt(stmt, env)
            exits.extend(stmt_exits)
        return env, exits

    def exec_block_any(self, stmts, env):
        """Like exec_block, also returning the OPEN-biased merge of every
        program point (the handler-entry approximation)."""
        exits: List[_Exit] = []
        anypoint = dict(env)
        for stmt in stmts:
            if env is None:
                break
            env, stmt_exits = self.exec_stmt(stmt, env)
            exits.extend(stmt_exits)
            anypoint = _merge([anypoint, env]) or anypoint
        return env, exits, anypoint

    def exec_stmt(self, stmt, env):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return env, []
        if isinstance(stmt, ast.Return):
            return self._exec_return(stmt, env)
        if isinstance(stmt, ast.Break):
            self._note_skips(stmt, env)
            return None, [_Exit("break", env, stmt)]
        if isinstance(stmt, ast.Continue):
            return None, [_Exit("continue", env, stmt)]
        if isinstance(stmt, ast.Raise):
            names = _EscapeEval(self.graph, self.state,
                                self.fn).raise_names(stmt, None)
            env2 = self._apply_effects(stmt, env)
            return None, [_Exit("raise", env2, stmt,
                                frozenset(names or {WIDENED}))]
        if isinstance(stmt, ast.If):
            return self._exec_if(stmt, env)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._exec_loop(stmt, env)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._exec_with(stmt, env)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, env)
        # Simple statement: exceptional fork first (pre-effect state —
        # if the acquiring call itself raises, nothing was acquired),
        # then effects.
        exits: List[_Exit] = []
        names = self._may_raise(stmt)
        if names and any(s == _OPEN for _k, s in env.values()):
            exits.append(_Exit("raise", dict(env), stmt, names))
        return self._apply_effects(stmt, env), exits

    def _exec_return(self, stmt, env):
        env2 = self._apply_effects(stmt, env)
        if stmt.value is not None:  # returning the value transfers it
            for sub in ast.walk(stmt.value):
                if isinstance(sub, ast.Name) and sub.id in env2:
                    key, _s = env2[sub.id]
                    env2[sub.id] = (key, _DONE)
        self._note_skips(stmt, env2)
        return None, [_Exit("return", env2, stmt)]

    def _note_skips(self, stmt, env) -> None:
        """An early return/break leaving an obligation OPEN is the skip
        site TNC117 reports — when a release site exists further down."""
        for _var, (key, status) in env.items():
            if status == _OPEN:
                self.skip_sites.setdefault(key, stmt)

    def _exec_if(self, stmt, env):
        exits: List[_Exit] = []
        names = self._may_raise(stmt.test)
        if names and any(s == _OPEN for _k, s in env.values()):
            exits.append(_Exit("raise", dict(env), stmt, names))
        then_out, then_exits = self.exec_block(stmt.body, dict(env))
        else_out, else_exits = self.exec_block(stmt.orelse, dict(env))
        return _merge([then_out, else_out]), exits + then_exits + else_exits

    def _exec_loop(self, stmt, env):
        head = stmt.test if isinstance(stmt, ast.While) else stmt.iter
        exits: List[_Exit] = []
        names = self._may_raise(head)
        if names and any(s == _OPEN for _k, s in env.values()):
            exits.append(_Exit("raise", dict(env), stmt, names))
        body_out, body_exits = self.exec_block(stmt.body, dict(env))
        passing: List[_Exit] = []
        fallthroughs: List[Optional[dict]] = [env, body_out]
        for ex in body_exits:
            if ex.kind in ("break", "continue"):
                fallthroughs.append(ex.env)  # loop consumes it
            else:
                passing.append(ex)
        out = _merge(fallthroughs)
        if stmt.orelse and out is not None:
            out, else_exits = self.exec_block(stmt.orelse, out)
            passing.extend(else_exits)
        return out, exits + passing

    def _exec_with(self, stmt, env):
        env = dict(env)
        exits: List[_Exit] = []
        for item in stmt.items:
            ctx_expr = item.context_expr
            handled = False
            if isinstance(ctx_expr, ast.Call):
                acq = _acquisition(ctx_expr)
                if acq is not None:
                    handled = True  # managed: __exit__ releases on all paths
            if isinstance(ctx_expr, ast.Name) and ctx_expr.id in env:
                key, _s = env[ctx_expr.id]
                env[ctx_expr.id] = (key, _DONE)  # ``with sock:`` closes it
                self.obls[key].release_lines.append(stmt.lineno)
                handled = True
            if not handled:
                env = self._apply_effects(ast.Expr(value=ctx_expr), env)
        body_out, body_exits = self.exec_block(stmt.body, env)
        return body_out, exits + body_exits

    def _exec_try(self, stmt, env):
        body_out, body_exits, body_any = self.exec_block_any(
            stmt.body, dict(env))
        handler_sets = [_handler_names(h) for h in stmt.handlers]
        passing: List[_Exit] = []
        consumed: List[dict] = []
        for ex in body_exits:
            if ex.kind != "raise":
                passing.append(ex)
                continue
            caught = {n for n in ex.names
                      if any(covers(h, n, self.state.exc_parents)
                             for names in handler_sets for h in names)}
            if caught:
                consumed.append(ex.env)
            uncaught = ex.names - caught
            if uncaught:
                passing.append(_Exit("raise", ex.env, ex.node,
                                     frozenset(uncaught)))
        handler_entry = _merge([body_any] + consumed) or dict(env)
        outs: List[Optional[dict]] = [body_out]
        for h in stmt.handlers:
            h_out, h_exits = self.exec_block(h.body, dict(handler_entry))
            outs.append(h_out)
            passing.extend(h_exits)
        if stmt.orelse and outs[0] is not None:
            else_out, else_exits = self.exec_block(stmt.orelse, outs[0])
            outs[0] = else_out
            passing.extend(else_exits)
        merged = _merge(outs)
        if not stmt.finalbody:
            return merged, passing
        # finally runs on the fall-through AND on every exit path.
        f_out, f_exits = (self.exec_block(stmt.finalbody, merged)
                          if merged is not None else (None, []))
        adjusted: List[_Exit] = list(f_exits)
        for ex in passing:
            ex_env, ex_inner = self.exec_block(stmt.finalbody, dict(ex.env))
            adjusted.extend(ex_inner)  # a return inside finally, etc.
            if ex_env is not None:
                adjusted.append(_Exit(ex.kind, ex_env, ex.node, ex.names))
        return f_out, adjusted

    # -- effects of one simple statement ---------------------------------

    def _apply_effects(self, stmt, env):
        env = dict(env)
        # 1) releases / sinks / transfers via calls
        for node in walk_skipping_nested_functions(stmt):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id in env):
                var = func.value.id
                key, _s = env[var]
                if func.attr in self.obls[key].verbs:
                    env[var] = (key, _DONE)
                    self.obls[key].release_lines.append(node.lineno)
            self._transfer_args(node, env)
        # 2) acquisitions and stores
        if isinstance(stmt, ast.Assign):
            value = stmt.value
            acq = _acquisition(value) if isinstance(value, ast.Call) else None
            stored_target = any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in stmt.targets)
            if stored_target:
                # self.x = <rhs>: everything tracked in the rhs is stored
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Name) and sub.id in env:
                        key, _s = env[sub.id]
                        env[sub.id] = (key, _DONE)
            elif (acq is not None and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                self._bind(env, stmt.targets[0].id, value, acq)
                return env
            elif (len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(value, ast.Name) and value.id in env):
                # alias move: y = x — blame stays on the acquire line
                var = stmt.targets[0].id
                key, status = env[value.id]
                env[value.id] = (key, _DONE)
                self._rebind_guard(env, var, stmt)
                env[var] = (key, status)
                return env
            if acq is not None and not stored_target:
                # tuple targets etc.: acquired into a shape we don't
                # track — conservative no-finding
                pass
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            acq = _acquisition(call)
            if acq is not None:
                # bare ``open(p)`` — nothing can ever release it
                self._bind(env, f"@{call.lineno}", call, acq)
            elif isinstance(call.func, ast.Attribute):
                inner = call.func.value
                if isinstance(inner, ast.Call):
                    acq = _acquisition(inner)
                    if acq is not None and call.func.attr not in acq[1]:
                        # ``open(p).read()`` — acquired, used, dropped
                        self._bind(env, f"@{inner.lineno}", inner, acq)
        elif isinstance(stmt, (ast.Return,)):
            pass  # handled in _exec_return
        return env

    def _bind(self, env, var: str, call: ast.Call,
              acq: Tuple[str, Tuple[str, ...]]) -> None:
        label, verbs = acq
        self._rebind_guard(env, var, call)
        key = f"{var}@{call.lineno}"
        self.obls[key] = _Obl(key=key, var=var, line=call.lineno,
                              col=call.col_offset, label=label, verbs=verbs)
        env[var] = (key, _OPEN)

    def _rebind_guard(self, env, var: str, node) -> None:
        """Rebinding a var whose obligation is OPEN orphans the old
        resource — keep it leaking under an unreachable key."""
        old = env.get(var)
        if old is not None and old[1] == _OPEN:
            env[f"{var}@@{getattr(node, 'lineno', 0)}"] = old

    def _transfer_args(self, call: ast.Call, env) -> None:
        """A tracked value passed to a callee: released/stored per the
        callee's summary; unknown callees get the benefit of the doubt."""
        args = list(call.args) + [kw.value for kw in call.keywords]
        tracked = [a for a in args
                   if isinstance(a, ast.Name) and a.id in env
                   and env[a.id][1] == _OPEN]
        if not tracked:
            return
        func = call.func
        if (isinstance(func, ast.Attribute) and func.attr in _SINK_METHODS):
            for arg in tracked:
                key, _s = env[arg.id]
                env[arg.id] = (key, _DONE)
            return
        targets, kind = _resolve_cached(self.state, self.env_r, call)
        if kind in ("external", "unresolved", "fallback") or not targets:
            for arg in tracked:  # unknown custody: assume transferred
                key, _s = env[arg.id]
                env[arg.id] = (key, _DONE)
            return
        for target in targets:
            callee = self.graph.functions.get(target)
            if callee is None:
                continue
            self.state.consulted.add(target)
            offset = 1 if (callee.params[:1]
                           and callee.params[0] in ("self", "cls")) else 0
            for i, arg in enumerate(call.args):
                if not (isinstance(arg, ast.Name) and arg.id in env):
                    continue
                pos = i + offset
                if (pos in self.state.releases.get(target, frozenset())
                        or pos in self.state.stores.get(target, frozenset())):
                    key, _s = env[arg.id]
                    env[arg.id] = (key, _DONE)

    def _may_raise(self, root: ast.AST) -> FrozenSet[str]:
        """Escaping names of the calls under one statement/expression."""
        out: Set[str] = set()
        for node in walk_skipping_nested_functions(root):
            if isinstance(node, ast.Raise) and node is not root:
                out.add(WIDENED)
            if not isinstance(node, ast.Call):
                continue
            targets, kind = _resolve_cached(self.state, self.env_r, node)
            if kind == "fallback":
                out.add(WIDENED)
            for target in targets:
                out |= self.state.escapes.get(target, frozenset())
        return frozenset(out)


# -- the rules --------------------------------------------------------------

# Thread-entry kinds whose escapes die silently.  http handlers unwind
# into the worker's dispatch try/except (a 500, not a death), executor
# escapes are recorded on the Future, and signal handlers re-raise into
# the main frame by design — all three excluded with that reasoning.
_SILENT_KINDS = frozenset(("thread", "thread-subclass", "spawner-arg"))

_CLI_MAIN = "tpu_node_checker_torch/cli.py::main"


def _package_files(graph: CallGraph) -> Set[str]:
    return set(graph.modules.values())


def _import_closure(graph: CallGraph, inputs: Set[str]) -> None:
    """Extend ``inputs`` with every module an input file imports — the
    TNC111 precedent: a previously-unresolvable import gaining its symbol
    can create a new edge out of the slice."""
    for path in list(inputs):
        env = graph.envs.get(path)
        if env is None:
            continue
        for _kind, target in env.imports.values():
            mod = target
            while mod:
                hit = graph.modules.get(mod)
                if hit is not None:
                    inputs.add(hit)
                    break
                mod = mod.rpartition(".")[0]


class ExceptionEscape(Rule):
    slug = "exception-escape"
    code = "TNC114"
    doc = ("no thread entry may die silently: its interprocedural raise-"
           "escape set (raises ∪ resolved-callee escapes − handled "
           "classes; dynamic dispatch widens to Exception) must be empty "
           "— a dead worker records WHY it died; and only SystemExit may "
           "escape cli.main's dispatch surface (TNC015 whole-program)")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from tpu_node_checker_torch.analysis.flow.rules import flow_state

        fstate = flow_state(project)
        graph = fstate.graph
        ts = typestate_state(project)
        findings: List[Finding] = []
        inputs: Set[str] = {"tpu_node_checker_torch/cli.py"}
        roots = [e.fid for e in fstate.entries] + [_CLI_MAIN]
        for fid in graph.reachable(roots):
            inputs.add(graph.functions[fid].path)
        for entry in fstate.entries:
            inputs.add(entry.path)
            if entry.kind not in _SILENT_KINDS:
                continue
            esc = ts.escapes.get(entry.fid, frozenset())
            if not esc:
                continue
            fn = graph.functions[entry.fid]
            findings.append(Finding(
                self.slug, self.code, fn.path, fn.lineno, 0,
                f"thread entry {fn.name!r} ({entry.kind}, spawned at "
                f"{entry.path}:{entry.lineno}) can die silently — "
                f"{', '.join(sorted(esc))} escape(s) the thread body; "
                "catch at the top, record WHY the worker died (the "
                "_StreamWorker pattern), or explain with "
                f"'# tnc: allow-{self.slug}(reason)' on the def line",
            ))
        main_esc = ts.escapes.get(_CLI_MAIN, frozenset())
        bad = sorted(n for n in main_esc if n != "SystemExit")
        if bad:
            fn = graph.functions.get(_CLI_MAIN)
            if fn is not None:
                findings.append(Finding(
                    self.slug, self.code, fn.path, fn.lineno, 0,
                    f"cli.main's dispatch surface lets {', '.join(bad)} "
                    "escape — only SystemExit (with the symbolic EXIT_* "
                    "codes, per TNC015) may cross the CLI boundary; the "
                    "catch-all ladder must stay whole-program-tight",
                ))
        _import_closure(graph, inputs)
        fstate.rule_inputs[self.code] = inputs
        return findings


class MustRelease(Rule):
    slug = "must-release"
    code = "TNC115"
    doc = ("a value acquired from a tracked constructor (socket/listener, "
           "HTTP connection/session, open(), Thread(daemon=False)) must "
           "reach its release verb on every normal AND exception path; "
           "returning it, storing it into self, or handing it to a "
           "releasing callee transfers the obligation (the PR 7 accept-"
           "loop leak, checked by machine)")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from tpu_node_checker_torch.analysis.flow.rules import flow_state

        fstate = flow_state(project)
        graph = fstate.graph
        ts = typestate_state(project)
        findings: List[Finding] = []
        for fid, interp in sorted(interp_results(ts, graph).items()):
            fn = graph.functions[fid]
            for key, path_kind in sorted(interp.leaks.items()):
                obl = interp.obls[key]
                skip = interp.skip_sites.get(key)
                if (skip is not None and obl.release_lines
                        and skip.lineno < max(obl.release_lines)):
                    continue  # TNC117 owns this shape, at the skip site
                how = ("on an exception path (a callee can raise before "
                       "the release)" if path_kind == "exception"
                       else "on a normal path")
                findings.append(Finding(
                    self.slug, self.code, fn.path, obl.line, obl.col,
                    f"{obl.label} acquired here never reaches "
                    f"{'/'.join(obl.verbs)} {how} of {fn.name!r} — use "
                    "'with', release in 'finally', or transfer the "
                    "obligation (return it, store it on self, hand it "
                    "to a releasing callee); or explain with "
                    f"'# tnc: allow-{self.slug}(reason)'",
                ))
        # A new acquisition can appear in any package file, and every
        # verdict leans on callee summaries — the honest slice is the
        # examined package (narrows automatically if that set ever does).
        fstate.rule_inputs[self.code] = _package_files(graph)
        return findings


class FinallyHygiene(Rule):
    slug = "finally-hygiene"
    code = "TNC117"
    doc = ("cleanup reachable only on the fall-through path: an early "
           "return/break that skips a release sitting further down is "
           "reported at the skip site (the shape TNC115 leaks most often "
           "reduce to — move the release into 'finally' or 'with')")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from tpu_node_checker_torch.analysis.flow.rules import flow_state

        fstate = flow_state(project)
        graph = fstate.graph
        ts = typestate_state(project)
        findings: List[Finding] = []
        for fid, interp in sorted(interp_results(ts, graph).items()):
            fn = graph.functions[fid]
            for key, _path_kind in sorted(interp.leaks.items()):
                obl = interp.obls[key]
                skip = interp.skip_sites.get(key)
                if not (skip is not None and obl.release_lines
                        and skip.lineno < max(obl.release_lines)):
                    continue  # plain leak: TNC115's finding, at the acquire
                findings.append(Finding(
                    self.slug, self.code, fn.path, skip.lineno,
                    getattr(skip, "col_offset", 0),
                    f"early exit skips the release of the {obl.label} "
                    f"acquired on line {obl.line} — the "
                    f"{'/'.join(obl.verbs)} below only runs on the "
                    "fall-through path; move it into 'finally' (or "
                    "manage the resource with 'with'); or explain with "
                    f"'# tnc: allow-{self.slug}(reason)'",
                ))
        fstate.rule_inputs[self.code] = _package_files(graph)
        return findings


# Torn-tolerant loader names: a module that reads through one of these
# owns store-family paths, and every truncating write it makes must be
# the tmp-then-os.replace idiom those loaders were built to trust.
TOLERANT_LOADERS = frozenset((
    "read_jsonl_tolerant", "read_jsonl_tail", "load_cache",
))


class AtomicWrite(Rule):
    slug = "atomic-write"
    code = "TNC116"
    doc = ("in any module that reads through a torn-tolerant loader, a "
           "truncating write-mode open() must write a tmp path that "
           "os.replace()s over the real one (appends are the loaders' "
           "designed tolerance; a direct 'w' overwrite hands readers a "
           "torn file — TNC021's 'who writes' generalized to 'how')")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from tpu_node_checker_torch.analysis.flow.rules import flow_state

        fstate = flow_state(project)
        graph = fstate.graph
        findings: List[Finding] = []
        store_files = [
            path for path in sorted(set(graph.modules.values()))
            if self._is_store_module(project.files.get(path))
        ]
        for path in store_files:
            ctx = project.files.get(path)
            for scope in self._scopes(ctx.tree):
                findings.extend(self._check_scope(path, scope))
        fstate.rule_inputs[self.code] = _package_files(graph)
        return findings

    @staticmethod
    def _is_store_module(ctx) -> bool:
        if ctx is None or ctx.tree is None:
            return False
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = _terminal(_dotted(node.func))
                if name in TOLERANT_LOADERS:
                    return True
        return False

    @staticmethod
    def _scopes(tree: ast.AST) -> Iterable[ast.AST]:
        """Every function body plus the module body — one-level dataflow
        stays scope-local, the TNC113 feeds discipline."""
        yield tree
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def _check_scope(self, path: str, scope: ast.AST) -> Iterable[Finding]:
        own = (list(walk_skipping_nested_functions(scope))
               if not isinstance(scope, ast.Module)
               else [n for s in scope.body
                     for n in walk_skipping_nested_functions(s)
                     if not isinstance(s, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))])
        # One-level assignment table: name -> load names of its value.
        assigns: Dict[str, Set[str]] = {}
        replace_roots: Set[str] = set()
        opens: List[Tuple[ast.Call, str]] = []
        for node in own:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns[node.targets[0].id] = self._loads(node.value)
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted == "os.replace" and node.args:
                replace_roots |= self._roots(node.args[0])
            if dotted in ("open", "io.open", "gzip.open") and node.args:
                mode = self._mode(node)
                if mode is not None and "w" in mode and "x" not in mode:
                    opens.append((node, mode))
        for call, mode in opens:
            cands = self._roots(call.args[0])
            for name in list(cands):
                cands |= assigns.get(name, set())  # one dataflow level
            if cands & replace_roots:
                continue  # the tmp-then-replace idiom
            yield Finding(
                self.slug, self.code, path, call.lineno, call.col_offset,
                f"truncating open(…, {mode!r}) in a torn-tolerant store "
                "module without the tmp-then-os.replace idiom — readers "
                "mid-write see a torn file the loaders cannot distinguish "
                "from corruption; write '<path>.tmp.<pid>' then "
                "os.replace, append instead, or explain with "
                f"'# tnc: allow-{self.slug}(reason)'",
            )

    @staticmethod
    def _mode(call: ast.Call) -> Optional[str]:
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
                and isinstance(call.args[1].value, str):
            return call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        return None  # no mode → "r"

    @staticmethod
    def _loads(expr: ast.AST) -> Set[str]:
        return {n.id for n in ast.walk(expr)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}

    @staticmethod
    def _roots(expr: ast.AST) -> Set[str]:
        """Name/dotted roots a path expression is built from."""
        out: Set[str] = set()
        dotted = _dotted(expr)
        if dotted:
            out.add(dotted)
        for n in ast.walk(expr):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                d = _dotted(n)
                if d:
                    out.add(d)
        return out


TYPESTATE_RULES: List[Rule] = [
    ExceptionEscape(), MustRelease(), AtomicWrite(), FinallyHygiene(),
]
