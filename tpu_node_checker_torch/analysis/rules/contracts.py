"""Contract-drift detectors: one fact, many surfaces, zero drift.

The same metric or CLI flag lives in several places — the code that emits
it, the PrometheusRule that alerts on it, the README table that documents it.
Each detector parses every surface and fails when a name exists on one but
not another: an alert on a metric nobody emits is a pager that can never
fire; an undocumented flag is an API nobody can find.

Name extraction understands the documentation shorthands the project already
uses: ``tpu_node_checker_probe_*`` (wildcard prefix) and
``tpu_node_checker_{cordoned,uncordoned}_nodes`` (brace alternation).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.engine import Finding, Project
from tpu_node_checker_torch.analysis.rules.base import (
    Rule,
    call_name,
    const_str,
    iter_type_lines,
)

METRIC_PREFIX = "tpu_node_checker_"
_METRIC_TOKEN = re.compile(r"tpu_node_checker_[a-zA-Z0-9_{},*]+")
_FLAG_TOKEN = re.compile(r"--[a-z][a-z0-9-]*")


def normalize_token(token: str) -> List[str]:
    """One raw token → the metric names/patterns it denotes.

    Brace disambiguation mirrors how the docs are actually written:

    * ``name{state="x"}`` / ``name{reason}`` — a *trailing* ``{…}`` group is
      a label selector: stripped;
    * ``name{state="x"`` — the regex cut a PromQL selector at ``=``; the
      unmatched ``{`` truncates the name the same way;
    * ``a_{x,y}_b`` — an *infix* group is alternation: expanded, every
      alternative combined with its surroundings;
    * a trailing ``*`` survives as a wildcard prefix pattern.
    """
    out: List[str] = []

    def rec(t: str) -> None:
        i = t.find("{")
        if i == -1:
            name = t.rstrip("_.")
            if name and name != METRIC_PREFIX.rstrip("_"):
                out.append(name)
            return
        j = t.find("}", i)
        if j == -1:  # unmatched: a selector the token regex cut at '='
            rec(t[:i])
        elif j == len(t) - 1:  # trailing {...}: label group
            rec(t[:i])
        else:  # infix {a,b}: alternation
            for alt in t[i + 1:j].split(","):
                rec(t[:i] + alt.strip() + t[j + 1:])

    rec(token)
    return out


class NamePatterns:
    """A set of exact names + wildcard prefixes, with membership tests."""

    def __init__(self):
        self.exact: Set[str] = set()
        self.prefixes: Set[str] = set()

    def add_token(self, token: str) -> None:
        for name in normalize_token(token):
            if name.endswith("*"):
                self.prefixes.add(name.rstrip("*"))
            else:
                self.exact.add(name)

    def covers(self, name: str) -> bool:
        if name in self.exact:
            return True
        return any(name.startswith(p) for p in self.prefixes)

    def covers_pattern(self, token: str) -> bool:
        """A documented shorthand is covered when every expansion is.

        Summary/histogram children (``_sum``/``_count``/``_bucket``) are
        folded to their family before the check.
        """
        for name in normalize_token(token):
            if name.endswith("*"):
                prefix = name.rstrip("*")
                if not (any(e.startswith(prefix) for e in self.exact)
                        or any(p.startswith(prefix) or prefix.startswith(p)
                               for p in self.prefixes)):
                    return False
            elif not self.covers(family_name(name)):
                return False
        return True


def _metric_tokens_with_lines(text: str) -> Iterable[Tuple[int, str]]:
    for lineno, line in enumerate(text.splitlines(), start=1):
        for match in _METRIC_TOKEN.finditer(line):
            yield lineno, match.group(0)


def emitted_metrics(project: Project) -> NamePatterns:
    """Every metric name the package can emit or documents emitting.

    Sources, in decreasing exactness:

    * full ``tpu_node_checker_…`` string constants anywhere in the package
      (includes module docstrings, which use the ``*``/``{a,b}`` shorthands);
    * bare suffix literals in metrics.py (the telemetry/fabric suffix tables
      feeding ``f"tpu_node_checker_{suffix}"``), prefixed.

    The analysis package itself is excluded: its own docstrings cite metric
    tokens as *examples*, and example text must never count as emission —
    a wildcard quoted in a linter docstring would otherwise mask real drift
    forever.
    """
    patterns = NamePatterns()
    for ctx in project.files.values():
        if (not ctx.in_package() or ctx.tree is None
                or ctx.path.startswith("tpu_node_checker_torch/analysis/")):
            continue
        for node in ast.walk(ctx.tree):
            lit = const_str(node)
            if lit is None:
                continue
            for match in _METRIC_TOKEN.finditer(lit):
                patterns.add_token(match.group(0))
            if ctx.path == "tpu_node_checker_torch/metrics.py":
                if re.fullmatch(r"probe_[a-z0-9_]+", lit):
                    patterns.add_token(METRIC_PREFIX + lit)
    return patterns


# Summary families expose _sum/_count children; histogram adds _bucket.
_CHILD_SUFFIXES = ("_sum", "_count", "_bucket")


def family_name(name: str) -> str:
    for suffix in _CHILD_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


class PrometheusRuleDrift(Rule):
    slug = "drift-prometheusrule"
    code = "TNC201"
    doc = ("every metric named in deploy/prometheusrule.yaml is one the "
           "package emits — an alert on a ghost metric can never fire")

    def check_project(self, project: Project) -> Iterable[Finding]:
        text = project.texts.get("deploy/prometheusrule.yaml")
        if text is None:
            return
        emitted = emitted_metrics(project)
        seen: Set[Tuple[int, str]] = set()
        for lineno, token in _metric_tokens_with_lines(text):
            if (lineno, token) in seen:
                continue
            seen.add((lineno, token))
            if not emitted.covers_pattern(token):
                names = ", ".join(normalize_token(token)) or token
                yield Finding(
                    self.slug, self.code, "deploy/prometheusrule.yaml",
                    lineno, 0,
                    f"alert references metric {names!r} which nothing in the "
                    "package emits — the alert is dead, or the metric was "
                    "renamed without updating the rule",
                )


class ReadmeMetricsDrift(Rule):
    slug = "drift-readme-metrics"
    code = "TNC202"
    doc = ("README metric mentions must be emittable, and every family "
           "metrics.py/app.py emit must be documented (README or the "
           "metrics.py docstring)")

    def check_project(self, project: Project) -> Iterable[Finding]:
        emitted = emitted_metrics(project)
        readme = project.texts.get("README.md")
        documented = NamePatterns()
        if readme is not None:
            for lineno, token in _metric_tokens_with_lines(readme):
                documented.add_token(token)
                if not emitted.covers_pattern(token):
                    names = ", ".join(normalize_token(token)) or token
                    yield Finding(
                        self.slug, self.code, "README.md", lineno, 0,
                        f"README documents metric {names!r} which nothing in "
                        "the package emits",
                    )
        # The metrics.py module docstring is the package's own metric index —
        # names there count as documented.
        metrics_ctx = project.files.get("tpu_node_checker_torch/metrics.py")
        if metrics_ctx is not None and metrics_ctx.tree is not None:
            doc = ast.get_docstring(metrics_ctx.tree) or ""
            for match in _METRIC_TOKEN.finditer(doc):
                documented.add_token(match.group(0))
        # Reverse direction: families actually handed to the exposition
        # layer (family()/_line() literals, hand-built "# TYPE" lines).
        # One finding per family, at its first emitting site.
        reported: Set[str] = set()
        for path, lineno, name in self._emitting_sites(project):
            fam = family_name(name)
            if fam in reported:
                continue
            if not documented.covers(fam):
                reported.add(fam)
                yield Finding(
                    self.slug, self.code, path, lineno, 0,
                    f"metric family {fam!r} is emitted but documented "
                    "nowhere (README or the metrics.py docstring) — "
                    "undocumented telemetry is telemetry nobody graphs",
                )

    @staticmethod
    def _emitting_sites(project: Project) -> Iterable[Tuple[str, int, str]]:
        for ctx in project.files.values():
            if (not ctx.in_package() or ctx.tree is None
                    or ctx.path.startswith("tpu_node_checker_torch/analysis/")):
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call):
                    if call_name(node) in ("family", "_line") and node.args:
                        lit = const_str(node.args[0])
                        if lit and lit.startswith(METRIC_PREFIX):
                            yield ctx.path, node.args[0].lineno, lit
                lit = const_str(node) if isinstance(node, ast.Constant) else None
                if lit:
                    for mname, _mtype in iter_type_lines(lit):
                        if mname.startswith(METRIC_PREFIX):
                            yield ctx.path, node.lineno, mname


class ReadmeFlagsDrift(Rule):
    slug = "drift-readme-flags"
    code = "TNC203"
    doc = ("the README ## Flags table and cli.py's add_argument calls list "
           "the same flags, in both directions")

    def check_project(self, project: Project) -> Iterable[Finding]:
        cli = project.files.get("tpu_node_checker_torch/cli.py")
        readme = project.texts.get("README.md")
        if cli is None or cli.tree is None or readme is None:
            return
        cli_flags: Dict[str, int] = {}
        for node in ast.walk(cli.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_argument"):
                for arg in node.args:
                    lit = const_str(arg)
                    if lit and lit.startswith("--"):
                        cli_flags.setdefault(lit, node.lineno)
        doc_flags: Dict[str, int] = {}
        in_table = False
        for lineno, line in enumerate(readme.splitlines(), start=1):
            if line.startswith("## "):
                in_table = line.strip() == "## Flags"
                continue
            if in_table and line.startswith("|"):
                first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
                for match in _FLAG_TOKEN.finditer(first_cell):
                    doc_flags.setdefault(match.group(0), lineno)
        if not doc_flags:
            return  # no table → nothing to diff (fixture minimalism)
        for flag, lineno in sorted(cli_flags.items()):
            if flag not in doc_flags and flag != "--help":
                yield Finding(
                    self.slug, self.code, "tpu_node_checker_torch/cli.py",
                    lineno, 0,
                    f"flag {flag!r} is parsed by cli.py but missing from the "
                    "README ## Flags table",
                )
        for flag, lineno in sorted(doc_flags.items()):
            if flag not in cli_flags:
                yield Finding(
                    self.slug, self.code, "README.md", lineno, 0,
                    f"README ## Flags table documents {flag!r} which cli.py "
                    "does not parse",
                )


RULES: List[Rule] = [
    PrometheusRuleDrift(),
    ReadmeMetricsDrift(),
    ReadmeFlagsDrift(),
]
