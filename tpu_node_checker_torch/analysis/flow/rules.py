"""The graph-powered rules: TNC111/TNC112/TNC113.

Each upgrades a per-file tripwire into a whole-program analysis and cites
it as the shallow precursor; the per-file rule keeps running (it is fast,
and it anchors suppressions at the exact site) while the graph rule covers
what a single AST cannot see:

* **TNC111** (`transitive-blocking`) — TNC011's blocking/locking ban on
  the snapshot read path, propagated along the call graph: the same
  roots, but the sleep/lock may sit N calls deep in another module.
  Findings land on the ROOT function's ``def`` line, so one
  ``# tnc: allow-transitive-blocking(reason)`` on the root sanctions a
  whole subtree — and surfaces as an unused suppression the day the
  path disappears.
* **TNC112** (`lockset-race`) — Eraser-style lock-set checking over
  thread domains: an attribute written from ≥2 domains must share a
  common lock across every write site project-wide, with lock-sets
  inherited through call chains (a helper called only under the lock is
  guarded, wherever it lives).  Sites the per-file TNC101 already flags
  are skipped — this rule exists for the cross-file view.
* **TNC113** (`snapshot-escape`) — TNC102's publish-path freeze as
  dataflow: after the atomic swap, neither the published object, nor
  the locals that BUILT it, nor its internals may be mutated, stored
  into longer-lived state, returned, or passed to a callee that
  mutates its parameter.

Soundness caveats (counted, documented in DESIGN §11): resolution gaps
land in the graph's ``unresolved`` bucket; lock-set inheritance meets
over *resolved* callers only; argument-type propagation is one level
deep; tests, bench and embedded ``*_SCRIPT`` files are outside the
graph.  The sanctioned-pattern list below is the one place lock-free-by-
construction seams are excused — each entry names its reason.
"""

from __future__ import annotations

import ast
import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.engine import Finding, Project
from tpu_node_checker_torch.analysis.rules.base import (
    Rule,
    call_name,
    dotted_name,
    walk_skipping_nested_functions,
)
from tpu_node_checker_torch.analysis.flow.graph import (
    AttrAccess,
    CallGraph,
    build_graph,
)
from tpu_node_checker_torch.analysis.flow.entries import (
    ThreadEntry,
    compute_domains,
    infer_entries,
    main_roots,
)

# Attributes excused from the lock-set rule, each with the invariant that
# makes the lock-free access correct.  (class name or "*", attr) -> reason.
# Additions require the same review as a suppression: name the mechanism,
# not the inconvenience.
SANCTIONED_LOCKFREE: Dict[Tuple[str, str], str] = {
    ("*", "_snap"): (
        "atomic snapshot swap: one GIL-atomic slot store publishes a fully "
        "built immutable object; readers see old or new, both complete "
        "(DESIGN §10)"
    ),
    ("*", "_snapshot"): "atomic snapshot swap (see _snap)",
}

# The swap attributes that mark a function as a publish path (TNC102's
# set, shared so the two rules cannot disagree on what publishing is).
_SWAP_ATTRS = ("_snap", "_snapshot")


@dataclass
class FlowState:
    """One graph build shared by every flow rule in a run."""

    graph: CallGraph
    entries: List[ThreadEntry]
    domains: Dict[str, Set[str]]
    build_ms: float
    # code -> root-relative paths whose content feeds that rule's verdict
    # (the incremental cache's invalidation slices)
    rule_inputs: Dict[str, Set[str]] = field(default_factory=dict)


def flow_state(project: Project) -> FlowState:
    """Build (once per Project) the graph + entries + domains."""
    state = getattr(project, "_flow_state", None)
    if state is None:
        t0 = time.perf_counter()
        graph = build_graph(project)
        entries = infer_entries(graph)
        domains = compute_domains(graph, entries)
        state = FlowState(graph=graph, entries=entries, domains=domains,
                          build_ms=(time.perf_counter() - t0) * 1e3)
        project._flow_state = state
    return state


def _suppressed_lines(project: Project, path: str,
                      rules: Tuple[str, ...]) -> Set[int]:
    """Lines in ``path`` carrying an allow-comment for any of ``rules``
    (incl. the standalone-above form)."""
    ctx = project.files.get(path)
    if ctx is None:
        return set()
    lines: Set[int] = set()
    for sup in ctx.suppressions:
        if sup.rule in rules:
            lines.add(sup.line)
            if sup.standalone:
                lines.add(sup.line + 1)
    return lines


class TransitiveBlocking(Rule):
    slug = "transitive-blocking"
    code = "TNC111"
    doc = ("TNC011's blocking/lock ban on snapshot read paths, followed "
           "through the call graph: no function reachable from a read "
           "root may sleep, do I/O, or take a lock — however many calls "
           "deep; findings land on the root so one allow-comment "
           "sanctions (and later expires with) the whole path")

    def check_project(self, project: Project) -> Iterable[Finding]:
        from tpu_node_checker_torch.analysis.rules.invariants import (
            BLOCKING_CALLS,
            BlockingReadPath,
        )

        state = flow_state(project)
        graph = state.graph
        node_index = {id(fn.node): fid
                      for fid, fn in graph.functions.items()}
        precursor = BlockingReadPath()
        roots: List[str] = []
        for ctx in project.files.values():
            if ctx.tree is None or "#" in ctx.path:
                continue
            for func in precursor._read_path_functions(ctx):
                fid = node_index.get(id(func))
                if fid is not None:
                    roots.append(fid)
        inputs: Set[str] = set()
        findings: List[Finding] = []
        for root in sorted(set(roots)):
            findings.extend(self._check_root(project, graph, root, inputs,
                                             BLOCKING_CALLS))
        # Invalidation slice: the files reached, plus every module a
        # reached file imports — a previously-unresolvable import gaining
        # its symbol can create a new edge out of the slice, so the
        # import closure rides along (soundness note in DESIGN §11).
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
        state.rule_inputs[self.code] = inputs
        return findings

    def _check_root(self, project: Project, graph: CallGraph, root: str,
                    inputs: Set[str],
                    blocking_calls) -> Iterable[Finding]:
        root_fn = graph.functions[root]
        inputs.add(root_fn.path)
        # BFS over RESOLVED edges with parent pointers so the finding can
        # name the path.  Fallback-dispatch edges are not followed here —
        # a shared method name must not wire every same-named class into
        # the read path; the graph summary counts them as soundness gaps.
        parents: Dict[str, Optional[str]] = {root: None}
        order = [root]
        i = 0
        while i < len(order):
            fid = order[i]
            i += 1
            for site in graph.callees(fid):
                if site.kind == "fallback":
                    continue
                for target in site.targets:
                    if target not in parents:
                        parents[target] = fid
                        order.append(target)
        for fid in order:
            if fid == root:
                continue  # depth 0 is TNC011's, reported there already
            fn = graph.functions[fid]
            inputs.add(fn.path)
            # Only TNC011's OWN waiver sanctions a blocking site in place —
            # this rule's waiver belongs on the ROOT def line, where the
            # engine's suppression accounting can see it being used (a
            # site-level allow-transitive-blocking would suppress silently
            # and then nag as unused forever).
            sanctioned = _suppressed_lines(
                project, fn.path, ("blocking-read-path",))
            for node in walk_skipping_nested_functions(fn.node):
                blocked = self._blocking_site(node, blocking_calls)
                if blocked is None:
                    continue
                what, line = blocked
                if line in sanctioned:
                    continue  # sanctioned at the site (TNC011's exception)
                chain: List[str] = []
                cursor: Optional[str] = fid
                while cursor is not None:
                    chain.append(graph.functions[cursor].name)
                    cursor = parents[cursor]
                path_str = " <- ".join(chain[::-1][1:]) or fn.name
                yield Finding(
                    self.slug, self.code, root_fn.path, root_fn.lineno, 0,
                    f"read-path root {root_fn.name!r} transitively reaches "
                    f"{what} at {fn.path}:{line} via {path_str} — the "
                    "TNC011 ban follows calls; hoist the work off the "
                    "read path or sanction the root with "
                    f"'# tnc: allow-{self.slug}(reason)'",
                )

    @staticmethod
    def _blocking_site(node: ast.AST,
                       blocking_calls) -> Optional[Tuple[str, int]]:
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in blocking_calls:
                return f"blocking call {name}()", node.lineno
            if name is not None and name.endswith(".acquire"):
                return f"lock acquire {name}()", node.lineno
        if isinstance(node, ast.withitem):
            expr = node.context_expr
            target = (call_name(expr) if isinstance(expr, ast.Call)
                      else dotted_name(expr))
            if target is not None and "lock" in target.lower():
                return f"'with {target}'", expr.lineno
        return None


class LocksetRace(Rule):
    slug = "lockset-race"
    code = "TNC112"
    doc = ("an attribute written from two or more thread domains must "
           "hold one common lock at EVERY write site project-wide, with "
           "lock-sets inherited through resolved call chains — the "
           "whole-program upgrade of TNC101, which keeps the same-file "
           "sites; sanctioned lock-free seams (atomic snapshot swaps) "
           "are excused by the annotated SANCTIONED_LOCKFREE list")

    _CONSTRUCTORS = ("__init__", "__new__", "__post_init__")

    def check_project(self, project: Project) -> Iterable[Finding]:
        state = flow_state(project)
        graph, domains = state.graph, state.domains
        # Any package file can add a thread entry, a lock, or a write
        # site through an alias — the race verdict is global, so the
        # invalidation slice is every package file the graph covers.
        inputs: Set[str] = set(graph.modules.values())
        entry_locks = self._entry_locksets(graph, state)
        by_attr: Dict[Tuple[str, str], List[AttrAccess]] = {}
        for acc in graph.accesses:
            by_attr.setdefault((acc.cid, acc.attr), []).append(acc)
        tnc101_guarded = self._tnc101_guarded_attrs(graph)
        findings: List[Finding] = []
        for (cid, attr), sites in sorted(by_attr.items()):
            cls = graph.classes.get(cid)
            if cls is None or not cls.path.startswith("tpu_node_checker_torch/"):
                continue
            if ((cls.name, attr) in SANCTIONED_LOCKFREE
                    or ("*", attr) in SANCTIONED_LOCKFREE):
                continue
            live = [s for s in sites
                    if graph.functions[s.fid].name not in self._CONSTRUCTORS]
            if not live:
                continue
            effective = [
                (s, s.locks_held | entry_locks.get(s.fid, frozenset()))
                for s in live
            ]
            if not any(locks for _s, locks in effective):
                continue  # never guarded anywhere: not lock-discipline state
            site_domains: Set[str] = set()
            for s in live:
                site_domains |= domains.get(s.fid, {"main"})
            if len(site_domains) < 2:
                continue  # single-threaded by reachability
            common = None
            for _s, locks in effective:
                common = locks if common is None else (common & locks)
            if common:
                continue  # one lock protects every site
            for s, locks in effective:
                if locks:
                    continue  # this site is guarded; the OTHER one reports
                if s.via == "self" and attr in tnc101_guarded.get(cid, ()):
                    continue  # the per-file tripwire already owns this site
                inputs.add(s.path)
                inputs.add(cls.path)
                findings.append(Finding(
                    self.slug, self.code, s.path, s.lineno, s.col,
                    f"{cls.name}.{attr} is written here with no lock but "
                    "is lock-guarded elsewhere, and the attribute is "
                    f"reachable from {len(site_domains)} thread domains "
                    f"({', '.join(sorted(site_domains)[:3])}…) — hold the "
                    "guarding lock, add the seam to SANCTIONED_LOCKFREE "
                    "with its invariant, or explain with "
                    f"'# tnc: allow-{self.slug}(reason)' (cross-file "
                    "upgrade of TNC101)",
                ))
        state.rule_inputs[self.code] = inputs
        return findings

    def _entry_locksets(self, graph: CallGraph,
                        state: FlowState) -> Dict[str, FrozenSet[str]]:
        """fid -> locks held on EVERY resolved path into it (meet = ∩,
        entries/main start with none).  A fixpoint over ≤ |functions|
        nodes; unknown callers simply contribute nothing, which widens
        races, never hides them."""
        TOP = None
        held: Dict[str, Optional[FrozenSet[str]]] = {
            fid: TOP for fid in graph.functions
        }
        incoming: Set[str] = set()
        for site in graph.calls:
            incoming.update(site.targets)
        work: List[str] = []
        for entry in state.entries:
            held[entry.fid] = frozenset()
            work.append(entry.fid)
        for fid in main_roots(graph):
            held[fid] = frozenset()
            work.append(fid)
        for fid in graph.functions:
            # No resolved caller at all: an unknown caller holds no locks.
            if fid not in incoming and held[fid] is TOP:
                held[fid] = frozenset()
                work.append(fid)
        while work:
            fid = work.pop()
            current = held.get(fid)
            if current is TOP:
                continue
            for site in graph.callees(fid):
                contribution = current | site.locks_held
                for target in site.targets:
                    old = held.get(target, TOP)
                    new = (contribution if old is TOP
                           else old & contribution)
                    if new != old:
                        held[target] = new
                        work.append(target)
        return {fid: locks for fid, locks in held.items()
                if locks}  # TOP and ∅ both read as "no inherited locks"

    @staticmethod
    def _tnc101_guarded_attrs(graph: CallGraph) -> Dict[str, Set[str]]:
        """cid -> attrs the per-file TNC101 already treats as guarded
        (lexically assigned under ``with self.<lock>`` in the class)."""
        guarded: Dict[str, Set[str]] = {}
        for acc in graph.accesses:
            if acc.via == "self" and acc.locks_held:
                guarded.setdefault(acc.cid, set()).add(acc.attr)
        return guarded


class SnapshotEscape(Rule):
    slug = "snapshot-escape"
    code = "TNC113"
    doc = ("after the atomic publish swap nothing of the snapshot "
           "escapes the publish path: neither the published object, nor "
           "the locals that built it, nor its internals may be mutated, "
           "stored into outliving state, returned, or passed to a "
           "callee that mutates its parameter — TNC102's single-file "
           "freeze, upgraded to dataflow")

    def check_project(self, project: Project) -> Iterable[Finding]:
        state = flow_state(project)
        graph = state.graph
        # A swap statement can appear in ANY package file — the publish-
        # path set itself is input, so the slice is the whole package.
        inputs: Set[str] = set(graph.modules.values())
        findings: List[Finding] = []
        # callee fid -> parameter names it mutates (via graph accesses)
        param_mutators: Dict[str, Set[str]] = {}
        for acc in graph.accesses:
            if acc.via == "param":
                param_mutators.setdefault(acc.fid, set()).add(acc.recv)
        for fn in graph.functions.values():
            if not fn.path.startswith("tpu_node_checker_torch/"):
                continue
            swap = self._find_swap(fn.node)
            if swap is None:
                continue
            name, swap_line, feeds = swap
            inputs.add(fn.path)
            findings.extend(self._check_publish(
                project, graph, fn, name, swap_line, feeds,
                param_mutators, inputs))
        state.rule_inputs[self.code] = inputs
        return findings

    @staticmethod
    def _find_swap(func: ast.AST
                   ) -> Optional[Tuple[str, int, Set[str]]]:
        """Last ``self._snap = NAME`` in the body + the locals that fed
        the published object before the swap."""
        name: Optional[str] = None
        swap_line = 0
        feeds: Set[str] = set()
        for node in walk_skipping_nested_functions(func):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and target.attr in _SWAP_ATTRS
                    and isinstance(node.value, ast.Name)):
                name = node.value.id
                swap_line = node.lineno
        if name is None:
            return None
        # Everything that flowed INTO the published name pre-swap: its
        # constructor/display arguments and values stored into it.
        for node in walk_skipping_nested_functions(func):
            if getattr(node, "lineno", swap_line + 1) > swap_line:
                continue
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    root = target
                    while isinstance(root, (ast.Attribute, ast.Subscript)):
                        root = root.value
                    if isinstance(root, ast.Name) and root.id == name:
                        if target is not root:  # NAME.x = v / NAME[k] = v
                            feeds |= _load_names(node.value)
                        elif isinstance(node.targets[0], ast.Name):
                            feeds |= _load_names(node.value)
        feeds.discard(name)
        return name, swap_line, feeds

    def _check_publish(self, project: Project, graph: CallGraph, fn,
                       name: str, swap_line: int, feeds: Set[str],
                       param_mutators: Dict[str, Set[str]],
                       inputs: Set[str]) -> Iterable[Finding]:
        in_server = fn.path.startswith("tpu_node_checker_torch/server/")
        watched = {name} | feeds
        env = graph.resolver.function_env(fn)
        for node in walk_skipping_nested_functions(fn.node):
            line = getattr(node, "lineno", 0)
            if line <= swap_line:
                continue
            # 1) mutation of the snapshot or anything that built it
            mutated = _mutation_root(node)
            if mutated in watched:
                if mutated == name and in_server:
                    continue  # direct post-swap mutation: TNC102's finding
                label = ("the published snapshot" if mutated == name else
                         f"{mutated!r}, which the published snapshot was "
                         "built from")
                yield Finding(
                    self.slug, self.code, fn.path, line,
                    getattr(node, "col_offset", 0),
                    f"publish path {fn.name!r} mutates {label} after the "
                    f"atomic swap on line {swap_line} — request threads "
                    "already hold references; build fully, then swap "
                    "(dataflow upgrade of TNC102)",
                )
            # 2) internals stored into outliving state
            if isinstance(node, ast.Assign):
                escaping = _internals_of(node.value, name)
                if escaping and any(
                        isinstance(t, (ast.Attribute, ast.Subscript))
                        for t in node.targets):
                    yield Finding(
                        self.slug, self.code, fn.path, line,
                        node.col_offset,
                        f"publish path {fn.name!r} stores {escaping} into "
                        "longer-lived state after the swap — a second "
                        "reference to the published snapshot's internals "
                        "outlives the publish and can mutate it later",
                    )
            # 3) internals returned
            if isinstance(node, ast.Return) and node.value is not None:
                escaping = _internals_of(node.value, name)
                if escaping:
                    yield Finding(
                        self.slug, self.code, fn.path, line,
                        node.col_offset,
                        f"publish path {fn.name!r} returns {escaping} "
                        "after the swap — handing out a mutable internal "
                        "of the published snapshot (return the snapshot "
                        "itself; its entity accessors are the read API)",
                    )
            # 4) passed to a callee that mutates its parameter
            if isinstance(node, ast.Call):
                targets, _kind = env.resolve_value(node.func)
                for i, arg in enumerate(node.args):
                    root = arg
                    while isinstance(root, (ast.Attribute, ast.Subscript)):
                        root = root.value
                    if not (isinstance(root, ast.Name)
                            and root.id in watched):
                        continue
                    for target in targets:
                        callee = graph.functions.get(target)
                        if callee is None:
                            continue
                        inputs.add(callee.path)
                        offset = 1 if (callee.params[:1]
                                       and callee.params[0] in
                                       ("self", "cls")) else 0
                        idx = i + offset
                        if idx >= len(callee.params):
                            continue
                        pname = callee.params[idx]
                        if pname in param_mutators.get(target, ()):
                            yield Finding(
                                self.slug, self.code, fn.path, line,
                                node.col_offset,
                                f"publish path {fn.name!r} passes the "
                                f"published snapshot (via {root.id!r}) to "
                                f"{callee.name}(), which mutates that "
                                f"parameter ({callee.path}:"
                                f"{callee.lineno}) — the swap froze it",
                            )


def _load_names(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


_MUTATORS = frozenset((
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "sort", "reverse",
))


def _mutation_root(node: ast.AST) -> Optional[str]:
    """Var name whose object this statement mutates (not rebinds)."""
    targets: List[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = [t for t in node.targets
                   if isinstance(t, (ast.Attribute, ast.Subscript))]
    elif isinstance(node, ast.AugAssign):
        if isinstance(node.target, (ast.Attribute, ast.Subscript)):
            targets = [node.target]
    elif (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS):
        targets = [node.func.value]
    for target in targets:
        while isinstance(target, (ast.Attribute, ast.Subscript)):
            target = target.value
        if isinstance(target, ast.Name):
            return target.id
    return None


def _internals_of(expr: ast.AST, name: str) -> Optional[str]:
    """A description when ``expr`` reaches into ``name``'s internals
    (``name.attr`` / ``name[k]``) — bare ``name`` is the published handle
    and fine to share."""
    for node in ast.walk(expr):
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            root = node.value
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and root.id == name:
                if isinstance(node, ast.Attribute):
                    return f"'{name}.{node.attr}'"
                return f"'{name}[…]'"
    return None


from tpu_node_checker_torch.analysis.flow.typestate import (  # noqa: E402
    TYPESTATE_RULES,
)

RULES: List[Rule] = [TransitiveBlocking(), LocksetRace(), SnapshotEscape(),
                     *TYPESTATE_RULES]
