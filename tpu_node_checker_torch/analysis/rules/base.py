"""Shared rule plumbing: the Rule base class and small AST helpers."""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from tpu_node_checker_torch.analysis.engine import FileContext, Finding, Project


class Rule:
    """One named, stable check.

    ``slug`` is the suppression key (``# tnc: allow-<slug>(reason)``) and
    ``code`` the short table ID — both are frozen once shipped: renaming
    either silently orphans every suppression in the tree.
    """

    slug: str = ""
    code: str = ""
    doc: str = ""  # one-line invariant statement for --list-rules / DESIGN §11

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project) -> Iterable[Finding]:
        return ()

    def finding(self, path: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(self.slug, self.code, path, line, col, message)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_head(node: ast.AST) -> Optional[str]:
    """The leading constant of an f-string (``f"tpu_..._{x}"`` → ``tpu_..._``)."""
    if isinstance(node, ast.JoinedStr) and node.values:
        return const_str(node.values[0])
    return None


def fstring_tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.JoinedStr) and node.values:
        return const_str(node.values[-1])
    return None


def walk_skipping_nested_functions(root: ast.AST):
    """Yield nodes below ``root`` without descending into nested function or
    class definitions — "inside THIS body" semantics for scope-sensitive
    rules (a handler that *defines* a worker is not itself blocking)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` → ``"x"`` (Attribute on the literal name ``self``)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def iter_type_lines(literal: str):
    """``(name, mtype)`` for each ``# TYPE <name> <type>`` exposition line in
    a string literal — the ONE parser for hand-built Prometheus blocks,
    shared by the metric-name lint and the drift detector so the two can
    never disagree on what counts as an emitted family."""
    if "# TYPE " not in literal:
        return
    for raw in literal.splitlines():
        parts = raw.strip().split()
        if len(parts) >= 4 and parts[0] == "#" and parts[1] == "TYPE":
            yield parts[2], parts[3]
