"""Project symbol table + call graph over the stdlib ``ast``.

Resolution model (the honest version — every gap is counted):

* **Names** resolve lexically: enclosing function's nested defs, then the
  module's top-level functions/classes, then imported symbols
  (``from a import b as c`` / ``import a.b as m``), followed through the
  project's own modules.  Python builtins and imports that leave the
  package are *external* (not a soundness gap — their blocking-ness is
  the per-file rules' allowlist problem).
* **Methods** dispatch via self-type heuristics: ``self``/``cls`` bind to
  the enclosing class (then its resolved MRO); locals bind through
  ``x = ClassName(...)`` constructor assignments and annotations
  (``x: ClassName``, parameter annotations); instance attributes bind
  through ``self.attr = ClassName(...)`` seen anywhere in the class; a
  second resolution pass propagates argument types into callee
  parameters (``helper(self)`` types helper's first parameter), so a
  helper in another module dispatches like the method that calls it.
* **Dynamic-dispatch fallback**: a method call on an *unknown* receiver
  resolves to every project class defining that method — but only when
  at most :data:`DISPATCH_FANOUT_CAP` classes do and the name is not a
  stdlib-container method (``get``/``append``/… would weld the graph
  into one blob).  Fallback edges are tagged so rules can weigh them.
* **Decorators** are unwrapped: a decorated function is registered under
  its own name (the body is what executes), ``@property`` getters are
  resolvable through plain ``self.attr`` loads, and
  ``functools.partial(f, …)``/``lambda`` targets resolve to ``f``/the
  lambda body.
* Everything else — computed receivers past the heuristics, ``getattr``
  strings, callables from containers — lands in the **unresolved
  bucket**, surfaced in ``--graph json`` and the graph summary so the
  blind spots are a number, not a feeling.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

# A method call on an unknown receiver falls back to "every class defining
# the name" only below this fan-out; past it the call is honestly unresolved.
DISPATCH_FANOUT_CAP = 3

_BUILTIN_NAMES = frozenset(dir(builtins))
# Methods of stdlib containers/primitives: calls to these on unknown
# receivers are external, never fallback-dispatched onto project classes
# that happen to share the name.
_BUILTIN_METHODS = frozenset(
    name
    for t in (str, bytes, bytearray, list, dict, set, frozenset, tuple, int,
              float, complex)
    for name in dir(t)
    if not name.startswith("__")
) | frozenset((
    # lock/event/queue/socket/file-object surface — receiver types the
    # heuristics never see but whose methods are unambiguous stdlib
    "acquire", "release", "locked", "wait", "notify", "notify_all",
    "set", "is_set", "put", "put_nowait", "get_nowait", "task_done",
    "recv", "recv_into", "send", "sendall", "close", "shutdown", "fileno",
    "read", "readline", "readinto", "write", "flush", "seek", "tell",
    "join", "start", "is_alive", "cancel", "result", "done",
    # argparse / re / http.server / socket objects on unknown receivers
    "add_argument", "add_argument_group", "add_mutually_exclusive_group",
    "parse_args", "error", "group", "groups", "groupdict", "span",
    "match", "fullmatch", "search", "finditer", "findall", "sub",
    "send_header", "end_headers", "send_response", "send_error",
    "log_message", "makefile", "settimeout", "setsockopt", "getsockname",
    "bind", "listen", "accept", "connect", "getheader", "getheaders",
))


@dataclass
class FunctionNode:
    """One function/method/lambda, keyed by ``path::qualname``."""

    fid: str
    path: str
    module: str
    qualname: str
    name: str
    node: ast.AST
    lineno: int
    cls: Optional[str] = None  # owning ClassNode cid
    decorators: Tuple[str, ...] = ()
    is_property: bool = False
    params: Tuple[str, ...] = ()


@dataclass
class ClassNode:
    cid: str
    path: str
    module: str
    name: str
    lineno: int
    bases: Tuple[str, ...] = ()  # raw dotted names, resolved lazily
    methods: Dict[str, str] = field(default_factory=dict)  # name -> fid
    properties: Set[str] = field(default_factory=set)
    # self.attr = ClassName(...) anywhere in the class -> attr type (cid)
    attr_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class CallSite:
    """One call expression, resolved or counted."""

    caller: str  # fid
    name: str  # display name as written ("self._rebuild", "fx.serve_http")
    lineno: int
    kind: str  # direct | method | fallback | external | unresolved
    targets: Tuple[str, ...] = ()  # fids (fallback may carry several)
    locks_held: FrozenSet[str] = frozenset()  # normalized lock names


@dataclass
class AttrAccess:
    """One ``<recv>.attr`` write (or mutator-method call) with its receiver
    class resolved — the lock-set rule's unit of work."""

    cid: str  # receiver ClassNode cid
    attr: str
    fid: str  # enclosing function
    path: str
    lineno: int
    col: int
    is_write: bool
    via: str  # "self" | "alias" | "param"
    recv: str = ""  # receiver root variable name ("self", "obj", …)
    locks_held: FrozenSet[str] = frozenset()


class CallGraph:
    """The whole-program view: symbols, edges, buckets, reachability."""

    def __init__(self) -> None:
        self.functions: Dict[str, FunctionNode] = {}
        self.classes: Dict[str, ClassNode] = {}
        self.calls: List[CallSite] = []
        self.edges: Dict[str, List[CallSite]] = {}
        self.accesses: List[AttrAccess] = []
        self.counts = {"resolved": 0, "fallback": 0, "external": 0,
                       "unresolved": 0}
        self.unresolved: List[CallSite] = []
        self.modules: Dict[str, str] = {}  # dotted module -> path
        self.resolver: Optional["Resolver"] = None  # set by build_graph
        self.envs: Dict[str, "_ModuleEnv"] = {}

    def add_call(self, site: CallSite) -> None:
        self.calls.append(site)
        if site.kind == "unresolved":
            self.counts["unresolved"] += 1
            self.unresolved.append(site)
            return
        if site.kind == "external":
            self.counts["external"] += 1
            return
        self.counts["fallback" if site.kind == "fallback" else "resolved"] += 1
        self.edges.setdefault(site.caller, []).append(site)

    def callees(self, fid: str) -> Iterable[CallSite]:
        return self.edges.get(fid, ())

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        """Every fid reachable from ``roots`` over resolved+fallback edges."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            fid = stack.pop()
            if fid in seen:
                continue
            seen.add(fid)
            for site in self.callees(fid):
                for target in site.targets:
                    if target not in seen:
                        stack.append(target)
        return seen

    def to_dict(self) -> dict:
        """The ``--graph json`` document (stable ordering throughout)."""
        return {
            "modules": sorted(self.modules),
            "functions": [
                {"id": f.fid, "module": f.module, "qualname": f.qualname,
                 "line": f.lineno, "class": f.cls,
                 "property": f.is_property}
                for f in sorted(self.functions.values(),
                                key=lambda f: f.fid)
            ],
            "classes": [
                {"id": c.cid, "bases": list(c.bases),
                 "methods": sorted(c.methods)}
                for c in sorted(self.classes.values(), key=lambda c: c.cid)
            ],
            "edges": sorted(
                {(s.caller, t, s.kind)
                 for s in self.calls for t in s.targets}
            ),
            "counts": dict(self.counts),
            "unresolved": [
                {"caller": s.caller, "name": s.name, "line": s.lineno}
                for s in sorted(self.unresolved,
                                key=lambda s: (s.caller, s.lineno))
            ],
        }


def _module_name(path: str) -> str:
    mod = path[:-3] if path.endswith(".py") else path
    mod = mod.replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class _ModuleEnv:
    """Phase-1 product for one module: what names mean here."""

    def __init__(self, path: str, module: str) -> None:
        self.path = path
        self.module = module
        # alias -> ("module", dotted) | ("symbol", "dotted.name")
        self.imports: Dict[str, Tuple[str, str]] = {}
        self.functions: Dict[str, str] = {}  # top-level name -> fid
        self.classes: Dict[str, str] = {}  # top-level name -> cid


class _Builder(ast.NodeVisitor):
    """Phase 1: symbols.  One instance per module."""

    def __init__(self, graph: CallGraph, env: _ModuleEnv, tree: ast.AST):
        self.graph = graph
        self.env = env
        self.stack: List[str] = []  # qualname parts
        self.cls_stack: List[ClassNode] = []
        self.tree = tree

    def _qual(self, name: str) -> str:
        return ".".join(self.stack + [name])

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self.env.imports[alias.asname] = ("module", alias.name)
            else:
                # `import a.b.c` binds `a`; dotted uses spell the full path
                # through the bound root, which the resolver re-joins.
                root = alias.name.split(".")[0]
                self.env.imports[root] = ("module", root)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level or node.module is None:
            return  # relative imports: absent from this codebase; counted nowhere
        for alias in node.names:
            self.env.imports[alias.asname or alias.name] = (
                "symbol", f"{node.module}.{alias.name}"
            )

    def _add_function(self, node, is_lambda: bool = False) -> FunctionNode:
        name = "<lambda>" if is_lambda else node.name
        qual = self._qual(f"{name}@{node.lineno}" if is_lambda else name)
        fid = f"{self.env.path}::{qual}"
        decorators = tuple(
            d for d in (
                _dotted(dec) for dec in getattr(node, "decorator_list", ())
            ) if d
        )
        params: Tuple[str, ...] = ()
        if not is_lambda or isinstance(node, ast.Lambda):
            args = node.args
            params = tuple(a.arg for a in args.posonlyargs + args.args)
        fn = FunctionNode(
            fid=fid, path=self.env.path, module=self.env.module,
            qualname=qual, name=name, node=node, lineno=node.lineno,
            cls=self.cls_stack[-1].cid if self.cls_stack else None,
            decorators=decorators,
            is_property=any(d in ("property", "cached_property",
                                  "functools.cached_property")
                            for d in decorators),
            params=params,
        )
        self.graph.functions[fid] = fn
        return fn

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        fn = self._add_function(node)
        if not self.stack:
            self.env.functions[node.name] = fn.fid
        elif self.cls_stack and self.stack[-1] == self.cls_stack[-1].name:
            # Immediate parent is the class body — a method, not a nested def.
            cls = self.cls_stack[-1]
            cls.methods[node.name] = fn.fid
            if fn.is_property:
                cls.properties.add(node.name)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # same registration shape

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._add_function(node, is_lambda=True)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = self._qual(node.name)
        cid = f"{self.env.path}::{qual}"
        cls = ClassNode(
            cid=cid, path=self.env.path, module=self.env.module,
            name=node.name, lineno=node.lineno,
            bases=tuple(b for b in (_dotted(base) for base in node.bases)
                        if b),
        )
        self.graph.classes[cid] = cls
        if not self.stack:
            self.env.classes[node.name] = cid
        self.cls_stack.append(cls)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()
        self.cls_stack.pop()


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Call):  # @decorator(args) — unwrap to the name
        return _dotted(node.func)
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Resolver:
    """Phase 2: resolve call sites, type locals, record attr accesses."""

    def __init__(self, graph: CallGraph,
                 envs: Dict[str, _ModuleEnv]) -> None:
        self.graph = graph
        self.envs = envs
        self.symbol_index = self._index_symbols()
        self.method_index = self._index_methods()
        # (callee fid, param index) -> set of cids bound by call arguments
        self.param_types: Dict[Tuple[str, int], Set[str]] = {}
        # fid -> _FuncEnv from the FINAL resolution pass (entry inference
        # and the graph rules reuse these instead of re-typing every body)
        self.env_cache: Dict[str, "_FuncEnv"] = {}

    def _index_symbols(self) -> Dict[str, str]:
        """dotted "module.symbol" -> fid/cid across the project."""
        index: Dict[str, str] = {}
        for env in self.envs.values():
            for name, fid in env.functions.items():
                index[f"{env.module}.{name}"] = fid
            for name, cid in env.classes.items():
                index[f"{env.module}.{name}"] = cid
        return index

    def _index_methods(self) -> Dict[str, List[str]]:
        index: Dict[str, List[str]] = {}
        for cls in self.graph.classes.values():
            for mname, fid in cls.methods.items():
                index.setdefault(mname, []).append(fid)
        return index

    # -- class/base resolution ------------------------------------------

    def resolve_class_name(self, env: _ModuleEnv,
                           dotted: str) -> Optional[str]:
        """A dotted name in module scope -> cid, following imports."""
        head, _, rest = dotted.partition(".")
        if not rest and dotted in env.classes:
            return env.classes[dotted]
        imp = env.imports.get(head)
        if imp is None:
            return None
        kind, target = imp
        full = f"{target}.{rest}" if (kind == "module" and rest) else (
            target if not rest else f"{target}.{rest}")
        hit = self.symbol_index.get(full)
        if hit in self.graph.classes:
            return hit
        return None

    def mro(self, cid: str) -> List[str]:
        out, stack = [], [cid]
        while stack:
            c = stack.pop(0)
            if c in out or c not in self.graph.classes:
                continue
            out.append(c)
            cls = self.graph.classes[c]
            env = self.envs.get(cls.path)
            for base in cls.bases:
                resolved = self.resolve_class_name(env, base) if env else None
                if resolved:
                    stack.append(resolved)
        return out

    def lookup_method(self, cid: str, name: str) -> Optional[str]:
        for c in self.mro(cid):
            fid = self.graph.classes[c].methods.get(name)
            if fid:
                return fid
        return None

    def class_attr_type(self, cid: str, attr: str) -> Optional[str]:
        for c in self.mro(cid):
            hit = self.graph.classes[c].attr_types.get(attr)
            if hit:
                return hit
        return None

    # -- per-function resolution ----------------------------------------

    def function_env(self, fn: FunctionNode) -> "_FuncEnv":
        env = self.env_cache.get(fn.fid)
        if env is None:
            env = _FuncEnv(self, fn)
            self.env_cache[fn.fid] = env
        return env

    def run(self) -> None:
        """Two passes: pass 1 resolves with local evidence and records the
        argument types flowing into callees; pass 2 re-resolves ONLY the
        functions whose parameters got typed, so ``helper(self)``'s body
        dispatches like its caller (one propagation level — the documented
        soundness bound; deeper chains stay in the unresolved bucket)."""
        self._collect_class_attr_types()
        results: Dict[str, Tuple[List[CallSite], List[AttrAccess]]] = {}
        for fn in list(self.graph.functions.values()):
            env = _FuncEnv(self, fn)
            self.env_cache[fn.fid] = env
            results[fn.fid] = env.resolve()
        for fid in sorted({fid for (fid, _idx) in self.param_types}):
            fn = self.graph.functions.get(fid)
            if fn is None:
                continue
            env = _FuncEnv(self, fn)
            self.env_cache[fid] = env
            results[fid] = env.resolve()
        for fid in sorted(results):
            calls, accesses = results[fid]
            for site in calls:
                self.graph.add_call(site)
            self.graph.accesses.extend(accesses)

    def _collect_class_attr_types(self) -> None:
        """Instance-attribute types: ``self.attr = ClassName(...)`` and
        ``self.attr = param`` for annotated parameters (the dependency-
        injection idiom — ``def __init__(self, pool: WorkerPool)``)."""
        for fn in self.graph.functions.values():
            if fn.cls is None:
                continue
            cls = self.graph.classes.get(fn.cls)
            env = self.envs.get(fn.path)
            if cls is None or env is None:
                continue
            param_anns: Dict[str, str] = {}
            args = getattr(fn.node, "args", None)
            if args is not None:
                for arg in list(getattr(args, "posonlyargs", [])) + \
                        list(args.args) + list(args.kwonlyargs):
                    if arg.annotation is None:
                        continue
                    ann = arg.annotation
                    if (isinstance(ann, ast.Constant)
                            and isinstance(ann.value, str)):
                        try:
                            ann = ast.parse(ann.value, mode="eval").body
                        except SyntaxError:
                            continue
                    dotted = _dotted(ann)
                    if dotted:
                        cid = self.resolve_class_name(env, dotted)
                        if cid:
                            param_anns[arg.arg] = cid
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                target = node.targets[0]
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    continue
                if isinstance(node.value, ast.Call):
                    dotted = _dotted(node.value.func)
                    if dotted:
                        cid = self.resolve_class_name(env, dotted)
                        if cid:
                            cls.attr_types.setdefault(target.attr, cid)
                elif (isinstance(node.value, ast.Name)
                        and node.value.id in param_anns):
                    cls.attr_types.setdefault(
                        target.attr, param_anns[node.value.id])


class _FuncEnv:
    """Everything needed to resolve one function's body."""

    def __init__(self, resolver: Resolver, fn: FunctionNode) -> None:
        self.r = resolver
        self.fn = fn
        self.graph = resolver.graph
        self.env = resolver.envs[fn.path]
        self.local_types: Dict[str, str] = {}  # var -> cid
        self.local_funcs: Dict[str, str] = {}  # nested def name -> fid
        self.calls: List[CallSite] = []
        self.accesses: List[AttrAccess] = []
        self._type_locals()

    # -- typing ----------------------------------------------------------

    def _type_locals(self) -> None:
        fn, node = self.fn, self.fn.node
        if fn.cls is not None and fn.params:
            if fn.params[0] in ("self", "cls"):
                self.local_types[fn.params[0]] = fn.cls
        args = node.args
        for i, arg in enumerate(getattr(args, "posonlyargs", []) +
                                list(args.args)):
            if arg.annotation is not None:
                cid = self._annotation_class(arg.annotation)
                if cid:
                    self.local_types[arg.arg] = cid
            bound = self.r.param_types.get((fn.fid, i))
            if bound and len(bound) == 1 and arg.arg not in self.local_types:
                self.local_types[arg.arg] = next(iter(bound))
        for stmt in self._own_walk(node):
            if isinstance(stmt, ast.FunctionDef):
                qual = f"{fn.qualname}.{stmt.name}"
                fid = f"{fn.path}::{qual}"
                if fid in self.graph.functions:
                    self.local_funcs[stmt.name] = fid
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                dotted = _dotted(stmt.value.func)
                if dotted:
                    cid = self.r.resolve_class_name(self.env, dotted)
                    if cid:
                        self.local_types[stmt.targets[0].id] = cid
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                cid = self._annotation_class(stmt.annotation)
                if cid:
                    self.local_types[stmt.target.id] = cid

    def _annotation_class(self, ann: ast.AST) -> Optional[str]:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        dotted = _dotted(ann)
        return self.r.resolve_class_name(self.env, dotted) if dotted else None

    def _own_walk(self, root: ast.AST):
        """The function's own body: no nested function/class bodies (they
        resolve as their own FunctionNodes)."""
        stack = list(ast.iter_child_nodes(root))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def expr_type(self, expr: ast.AST) -> Optional[str]:
        """cid of an expression, where the heuristics can see one."""
        if isinstance(expr, ast.Name):
            return self.local_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.expr_type(expr.value)
            if base is not None:
                return self.r.class_attr_type(base, expr.attr)
        if isinstance(expr, ast.Call):
            dotted = _dotted(expr.func)
            if dotted:
                return self.r.resolve_class_name(self.env, dotted)
        return None

    # -- lock tracking ---------------------------------------------------

    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Call):
            expr = expr.func
        dotted = _dotted(expr)
        if dotted is None or "lock" not in dotted.lower():
            return None
        head, _, rest = dotted.partition(".")
        cid = self.local_types.get(head)
        if cid is not None and rest:
            cls = self.graph.classes.get(cid)
            if cls is not None:
                return f"{cls.name}.{rest}"
        return dotted

    # -- resolution ------------------------------------------------------

    def resolve_value(self, expr: ast.AST) -> Tuple[Tuple[str, ...], str]:
        """A callable-valued expression -> (fids, kind).  Used for call
        functions AND thread/executor targets."""
        if isinstance(expr, ast.Lambda):
            fid = self._lambda_fid(expr)
            return ((fid,), "direct") if fid else ((), "unresolved")
        if isinstance(expr, ast.Call):
            # functools.partial(f, ...) — the target is f.
            dotted = _dotted(expr.func)
            if dotted in ("partial", "functools.partial") and expr.args:
                return self.resolve_value(expr.args[0])
            return (), "unresolved"
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.local_funcs:
                return (self.local_funcs[name],), "direct"
            if name in self.local_types:
                return (), "unresolved"  # calling an instance — __call__
            hit = self._module_symbol(name)
            if hit is not None:
                return hit
            if name in _BUILTIN_NAMES:
                return (), "external"
            return (), "unresolved"
        if isinstance(expr, ast.Attribute):
            return self._resolve_attribute(expr)
        return (), "unresolved"

    def _lambda_fid(self, expr: ast.Lambda) -> Optional[str]:
        index = getattr(self.graph, "_node_index", None)
        if index is None:
            index = {id(fn.node): fid
                     for fid, fn in self.graph.functions.items()}
            self.graph._node_index = index
        return index.get(id(expr))

    def _module_symbol(self, name: str) -> Optional[Tuple[Tuple[str, ...], str]]:
        env = self.env
        if name in env.functions:
            return (env.functions[name],), "direct"
        if name in env.classes:
            ctor = self.r.lookup_method(env.classes[name], "__init__")
            return ((ctor,), "direct") if ctor else ((), "external")
        imp = env.imports.get(name)
        if imp is not None:
            kind, target = imp
            if kind == "symbol":
                hit = self.r.symbol_index.get(target)
                if hit is None:
                    return (), "external"
                if hit in self.graph.classes:
                    ctor = self.r.lookup_method(hit, "__init__")
                    return ((ctor,), "direct") if ctor else ((), "external")
                return (hit,), "direct"
            return (), "external"  # a bare module is not callable
        return None

    def _resolve_attribute(self, expr: ast.Attribute
                           ) -> Tuple[Tuple[str, ...], str]:
        recv_type = self.expr_type(expr.value)
        if recv_type is not None:
            fid = self.r.lookup_method(recv_type, expr.attr)
            if fid is not None:
                return (fid,), "method"
            if expr.attr in _BUILTIN_METHODS:
                return (), "external"
            return (), "unresolved"
        # module-qualified: mod.f / pkg.mod.f through the import table
        dotted = _dotted(expr)
        if dotted is not None:
            head, _, rest = dotted.partition(".")
            imp = self.env.imports.get(head)
            if imp is not None and rest:
                _, target = imp
                full = f"{target}.{rest}"
                hit = self.r.symbol_index.get(full)
                if hit is not None:
                    if hit in self.graph.classes:
                        ctor = self.r.lookup_method(hit, "__init__")
                        return ((ctor,), "direct") if ctor else ((), "external")
                    return (hit,), "direct"
                if full.rpartition(".")[0] in self.graph.modules:
                    return (), "unresolved"  # project module, symbol unseen
                return (), "external"
        # unknown receiver: dynamic-dispatch fallback under the cap
        if expr.attr in _BUILTIN_METHODS:
            return (), "external"
        candidates = self.r.method_index.get(expr.attr, [])
        if 0 < len(candidates) <= DISPATCH_FANOUT_CAP:
            return tuple(sorted(candidates)), "fallback"
        return (), "unresolved"

    def resolve(self) -> Tuple[List[CallSite], List[AttrAccess]]:
        """Walk the body once: calls, arg-type propagation, attr accesses,
        all annotated with the lexically-held lock set."""
        self.calls, self.accesses = [], []
        self._walk_with_locks(self.fn.node, frozenset())
        return self.calls, self.accesses

    def _walk_with_locks(self, root: ast.AST, locks: FrozenSet[str]) -> None:
        for node in ast.iter_child_nodes(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            held = locks
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = self._lock_name(item.context_expr)
                    if lock is not None:
                        held = held | {lock}
            if isinstance(node, ast.Call):
                self._record_call(node, locks)
            self._record_writes(node, locks)
            self._walk_with_locks(node, held)

    def _record_call(self, node: ast.Call, locks: FrozenSet[str]) -> None:
        targets, kind = self.resolve_value(node.func)
        name = _dotted(node.func) or "<computed>"
        site = CallSite(caller=self.fn.fid, name=name, lineno=node.lineno,
                        kind=kind if targets else (
                            kind if kind in ("external", "unresolved")
                            else "unresolved"),
                        targets=targets, locks_held=locks)
        self.calls.append(site)
        # Argument-type propagation (pass 1 feeds pass 2): a known-class
        # argument types the callee's positional parameter.
        for fid in targets:
            callee = self.graph.functions.get(fid)
            if callee is None:
                continue
            # A bound method (incl. a resolved constructor) receives self
            # implicitly: caller arg i lands on callee param i+1.
            offset = 1 if (callee.params[:1]
                           and callee.params[0] in ("self", "cls")) else 0
            for i, arg in enumerate(node.args):
                cid = self.expr_type(arg)
                if cid is not None:
                    self.r.param_types.setdefault(
                        (fid, i + offset), set()).add(cid)

    _MUTATORS = frozenset((
        "append", "extend", "insert", "add", "update", "setdefault", "pop",
        "popitem", "remove", "discard", "clear", "sort", "reverse",
    ))

    def _record_writes(self, node: ast.AST, locks: FrozenSet[str]) -> None:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._MUTATORS):
            inner = node.func.value
            if isinstance(inner, (ast.Attribute, ast.Subscript)):
                targets = [inner]
        for target in targets:
            base = target
            if isinstance(base, ast.Subscript):
                base = base.value
            if not isinstance(base, ast.Attribute):
                continue
            recv = base.value
            cid = self.expr_type(recv)
            if cid is None:
                continue
            via = "self"
            if not (isinstance(recv, ast.Name)
                    and recv.id in ("self", "cls")):
                via = ("param" if isinstance(recv, ast.Name)
                       and recv.id in self.fn.params else "alias")
            self.accesses.append(AttrAccess(
                cid=cid, attr=base.attr, fid=self.fn.fid, path=self.fn.path,
                lineno=getattr(node, "lineno", base.lineno),
                col=getattr(node, "col_offset", 0),
                is_write=True, via=via,
                recv=recv.id if isinstance(recv, ast.Name) else "",
                locks_held=locks,
            ))


def build_graph(project) -> CallGraph:
    """``Project`` (engine.load_project) -> resolved CallGraph.

    Package files only; virtual ``#*_SCRIPT`` files and tests are excluded
    (separate processes / deliberate internals-poking would weld domains).
    """
    graph = CallGraph()
    envs: Dict[str, _ModuleEnv] = {}
    for path, ctx in sorted(project.files.items()):
        if "#" in path or not path.startswith("tpu_node_checker_torch/"):
            continue
        if ctx.tree is None:
            continue
        env = _ModuleEnv(path, _module_name(path))
        envs[path] = env
        graph.modules[env.module] = path
        _Builder(graph, env, ctx.tree).visit(ctx.tree)
    resolver = Resolver(graph, envs)
    resolver.run()
    graph.resolver = resolver  # entries.py reuses the resolution machinery
    graph.envs = envs
    return graph
