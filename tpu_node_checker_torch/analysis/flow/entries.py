"""Thread-entry inference: where concurrency starts, per the codebase's
own idioms.

Each entry roots a *reachability domain* — the set of functions a spawned
thread can execute.  The lock-set rule (TNC112) asks "can two domains
touch this attribute?", so missing an entry under-approximates races and
inventing one over-approximates; the detectors below are exactly the
spawn shapes this tree uses (grep-audited in the PR that added them):

* ``threading.Thread(target=…)`` — incl. ``functools.partial``/lambda
  targets and bound methods;
* ``threading.Thread`` **subclasses** — their ``run`` is the entry
  (``watchstream._StreamWorker``);
* executor ``submit``/``map`` — incl. *parameter spawners*: a function
  that submits its own parameter (``utils.fanout.bounded_map``) turns
  every call site's argument into an entry;
* ``router.add(METHOD, pattern, handler)`` — registered HTTP handlers
  run on server/accept threads;
* ``signal.signal(sig, handler)`` — handlers preempt arbitrary frames
  (their own domain by construction).

``main_roots`` returns the synchronous world's roots (the CLI surface);
functions reachable from nothing are *assigned* to main — an unknown
caller must widen the race check, not silence it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.flow.graph import (
    CallGraph,
    _dotted,
    _FuncEnv,
    FunctionNode,
)

_HTTP_METHODS = frozenset(("GET", "HEAD", "POST", "PUT", "PATCH", "DELETE"))


@dataclass(frozen=True)
class ThreadEntry:
    domain: str  # stable label, e.g. "thread:server/workers.py::Worker._accept_loop"
    fid: str  # the entry function
    path: str  # file the spawn site lives in
    lineno: int
    kind: str  # thread | thread-subclass | executor | http-handler | signal | spawner-arg


def _entry(kind: str, fid: str, site_path: str, lineno: int) -> ThreadEntry:
    short = fid.replace("tpu_node_checker_torch/", "", 1)
    return ThreadEntry(domain=f"{kind}:{short}", fid=fid, path=site_path,
                       lineno=lineno, kind=kind)


def _is_thread_ctor(name: Optional[str]) -> bool:
    return name in ("threading.Thread", "Thread")


def infer_entries(graph: CallGraph) -> List[ThreadEntry]:
    resolver = graph.resolver
    entries: List[ThreadEntry] = []
    seen: Set[Tuple[str, str]] = set()
    # fid -> parameter indices that get spawned (Thread target / submit arg)
    spawners: Dict[str, Set[int]] = {}

    def add(kind: str, fids, path: str, lineno: int) -> None:
        for fid in fids:
            if (kind, fid) not in seen:
                seen.add((kind, fid))
                entries.append(_entry(kind, fid, path, lineno))

    # Thread subclasses: run() is the entry regardless of where (or
    # whether) the instance is constructed — the class exists to be run.
    for cls in graph.classes.values():
        if any(_is_thread_ctor(base) for base in cls.bases):
            run_fid = resolver.lookup_method(cls.cid, "run")
            if run_fid:
                add("thread-subclass", (run_fid,), cls.path,
                    graph.functions[run_fid].lineno)

    def resolve_target(env: _FuncEnv, expr: ast.AST,
                       spawner_of: FunctionNode) -> Tuple[str, ...]:
        """Target expr -> fids; records parameter spawners as a side effect."""
        if (isinstance(expr, ast.Name)
                and expr.id in spawner_of.params):
            spawners.setdefault(spawner_of.fid, set()).add(
                spawner_of.params.index(expr.id))
            return ()
        fids, _kind = env.resolve_value(expr)
        return fids

    def scan(fn: FunctionNode, propagate: bool) -> None:
        env = resolver.function_env(fn)
        for node in env._own_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if not propagate:
                if _is_thread_ctor(name):
                    for kw in node.keywords:
                        if kw.arg == "target":
                            add("thread",
                                resolve_target(env, kw.value, fn),
                                fn.path, node.lineno)
                elif name == "signal.signal" and len(node.args) == 2:
                    add("signal", resolve_target(env, node.args[1], fn),
                        fn.path, node.lineno)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "submit" and node.args):
                    add("executor",
                        resolve_target(env, node.args[0], fn),
                        fn.path, node.lineno)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "map" and node.args
                      and name is not None
                      and any(hint in name.lower()
                              for hint in ("pool", "executor"))):
                    add("executor",
                        resolve_target(env, node.args[0], fn),
                        fn.path, node.lineno)
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "add"
                      and len(node.args) >= 3
                      and isinstance(node.args[0], ast.Constant)
                      and node.args[0].value in _HTTP_METHODS):
                    add("http-handler",
                        resolve_target(env, node.args[2], fn),
                        fn.path, node.lineno)
            else:
                # Parameter spawners: a call into a spawner roots the
                # argument it passes at the spawned index.
                fids, _ = env.resolve_value(node.func)
                for target in fids:
                    idxs = spawners.get(target)
                    if not idxs:
                        continue
                    callee = graph.functions.get(target)
                    offset = 1 if (callee is not None and callee.params[:1]
                                   and callee.params[0] in ("self", "cls")
                                   ) else 0
                    for idx in idxs:
                        pos = idx - offset
                        if 0 <= pos < len(node.args):
                            arg = node.args[pos]
                            if (isinstance(arg, ast.Name)
                                    and arg.id in fn.params):
                                # spawner composed with spawner: propagate
                                spawners.setdefault(fn.fid, set()).add(
                                    fn.params.index(arg.id))
                                continue
                            got, _k = env.resolve_value(arg)
                            add("spawner-arg", got, fn.path, node.lineno)

    for fn in list(graph.functions.values()):
        scan(fn, propagate=False)
    # Two propagation rounds (spawner -> wrapper-spawner -> call site),
    # scanning only functions that actually call a spawner.
    callers_of: Dict[str, Set[str]] = {}
    for site in graph.calls:
        for target in site.targets:
            callers_of.setdefault(target, set()).add(site.caller)
    for _ in range(2):
        wanted: Set[str] = set()
        for spawner in spawners:
            wanted |= callers_of.get(spawner, set())
        for fid in sorted(wanted):
            fn = graph.functions.get(fid)
            if fn is not None:
                scan(fn, propagate=True)
    entries.sort(key=lambda e: (e.kind, e.fid))
    return entries


def main_roots(graph: CallGraph) -> List[str]:
    """The synchronous world's roots: every function on the CLI surface."""
    return sorted(
        fid for fid, fn in graph.functions.items()
        if fn.path in ("tpu_node_checker_torch/cli.py",
                       "tpu_node_checker_torch/__main__.py",
                       "tpu_node_checker_torch/checker.py")
    )


def compute_domains(graph: CallGraph,
                    entries: List[ThreadEntry]) -> Dict[str, Set[str]]:
    """fid -> set of domain labels whose threads can execute it.

    ``main`` roots at the CLI surface AND at every function no resolved
    call site reaches (an unknown caller is assumed synchronous — it
    widens the race surface, never narrows it), then propagates over the
    call graph like any other domain.
    """
    domains: Dict[str, Set[str]] = {}
    entry_fids: Set[str] = set()
    for entry in entries:
        entry_fids.add(entry.fid)
        for fid in graph.reachable([entry.fid]):
            domains.setdefault(fid, set()).add(entry.domain)
    incoming: Set[str] = set()
    for site in graph.calls:
        incoming.update(site.targets)
    main_seed = set(main_roots(graph)) | {
        fid for fid in graph.functions
        if fid not in incoming and fid not in entry_fids
    }
    for fid in graph.reachable(main_seed):
        domains.setdefault(fid, set()).add("main")
    for fid in graph.functions:
        if fid not in domains:
            domains[fid] = {"main"}  # unreached cycle: assume synchronous
    return domains
