"""Heuristic lock-discipline race checker.

Not a proof system — a tripwire tuned to this codebase's conventions:
instance locks are attributes with "lock" in the name, guarded state is
``self._x``, publication is the single atomic ``self._snap = …`` swap.  The
goal is catching the classic refactor bug: a new method mutating state whose
every *other* mutation is lock-guarded.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.engine import FileContext, Finding
from tpu_node_checker_torch.analysis.rules.base import (
    Rule,
    call_name,
    dotted_name,
    self_attr,
)

# Methods whose self-assignments are construction, not shared-state mutation.
_CONSTRUCTORS = ("__init__", "__new__", "__post_init__")

_MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "sort", "reverse",
}


def _is_lock_with(node: ast.With) -> bool:
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            expr = expr.func
        name = dotted_name(expr)
        if name is not None and "lock" in name.lower():
            return True
    return False


def _assigned_self_attrs(node: ast.AST) -> Iterable[Tuple[str, ast.AST]]:
    """(attr, node) for every ``self.x = …`` / ``self.x += …`` under node."""
    for inner in ast.walk(node):
        targets: List[ast.AST] = []
        if isinstance(inner, ast.Assign):
            targets = inner.targets
        elif isinstance(inner, (ast.AugAssign, ast.AnnAssign)):
            targets = [inner.target]
        for target in targets:
            attr = self_attr(target)
            if attr is not None:
                yield attr, inner
            # self.x[k] = … mutates self.x just the same
            if isinstance(target, ast.Subscript):
                attr = self_attr(target.value)
                if attr is not None:
                    yield attr, inner


class UnlockedWrite(Rule):
    slug = "unlocked-write"
    code = "TNC101"
    doc = ("an attribute ever assigned under ``with self.<lock>`` is "
           "lock-guarded state: every mutation outside ``__init__`` must "
           "hold the lock")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_package():
            return
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guarded: Set[str] = set()
            locked_nodes: Set[int] = set()  # id()s of nodes inside lock blocks
            for node in ast.walk(cls):
                if isinstance(node, ast.With) and _is_lock_with(node):
                    for attr, stmt in _assigned_self_attrs(node):
                        guarded.add(attr)
                        locked_nodes.add(id(stmt))
            if not guarded:
                continue
            for method in cls.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                if method.name in _CONSTRUCTORS:
                    continue
                for attr, stmt in _assigned_self_attrs(method):
                    if attr in guarded and id(stmt) not in locked_nodes:
                        yield self.finding(
                            ctx.path, stmt,
                            f"self.{attr} is mutated without the lock, but "
                            f"other sites in {cls.name} guard it with "
                            "'with self.<lock>' — take the lock or explain "
                            "with '# tnc: allow-unlocked-write(reason)'",
                        )


class SnapshotMutation(Rule):
    slug = "snapshot-mutation"
    code = "TNC102"
    doc = ("after the atomic publish (``self._snap = x``) the published "
           "object never mutates — request threads hold references to it")

    _SWAP_ATTRS = ("_snap", "_snapshot")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.path.startswith("tpu_node_checker_torch/server/"):
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            published: Optional[str] = None
            publish_line = 0
            for stmt in ast.walk(func):
                if (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and self_attr(stmt.targets[0]) in self._SWAP_ATTRS
                        and isinstance(stmt.value, ast.Name)):
                    published = stmt.value.id
                    publish_line = stmt.lineno
            if published is None:
                continue
            for stmt in ast.walk(func):
                if stmt is None or getattr(stmt, "lineno", 0) <= publish_line:
                    continue
                if self._mutates(stmt, published):
                    yield self.finding(
                        ctx.path, stmt,
                        f"{published!r} was published as the immutable "
                        f"snapshot on line {publish_line} and is mutated "
                        "afterwards — build fully, then swap",
                    )

    @staticmethod
    def _mutates(node: ast.AST, name: str) -> bool:
        def rooted_at(target: ast.AST) -> bool:
            while isinstance(target, (ast.Attribute, ast.Subscript)):
                target = target.value
            return isinstance(target, ast.Name) and target.id == name

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            return any(
                isinstance(t, (ast.Attribute, ast.Subscript)) and rooted_at(t)
                for t in targets
            )
        if isinstance(node, ast.Call):
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _MUTATOR_METHODS):
                return rooted_at(func.value)
        return False


class ThreadHygiene(Rule):
    slug = "thread-hygiene"
    code = "TNC103"
    doc = ("every ``threading.Thread`` carries ``name=`` and ``daemon=`` "
           "(attributable stack dumps, no shutdown hangs); package "
           "``ThreadPoolExecutor``s carry ``thread_name_prefix=``")

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in ("threading.Thread", "Thread"):
                kwargs = {kw.arg for kw in node.keywords}
                missing = [k for k in ("name", "daemon") if k not in kwargs]
                if missing:
                    yield self.finding(
                        ctx.path, node,
                        f"Thread(...) without {'/'.join(missing)}= — name "
                        "threads so stack dumps and race findings are "
                        "attributable, and pick daemon-ness explicitly",
                    )
            elif name and name.endswith("ThreadPoolExecutor") and ctx.in_package():
                kwargs = {kw.arg for kw in node.keywords}
                if "thread_name_prefix" not in kwargs:
                    yield self.finding(
                        ctx.path, node,
                        "ThreadPoolExecutor without thread_name_prefix= — "
                        "pool workers show up as Thread-N in dumps",
                    )


RULES: List[Rule] = [UnlockedWrite(), SnapshotMutation(), ThreadHygiene()]
