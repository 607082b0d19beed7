"""The tnc-lint engine: file walker, rule registry, suppressions, output.

The engine owns everything rule-independent:

* walking a project root (``tpu_node_checker_torch/**``, ``tests/**``, ``bench.py``,
  plus the non-Python contract surfaces README.md and
  ``deploy/prometheusrule.yaml``), skipping ``__pycache__`` and the seeded
  violation corpus under ``tests/analysis_fixtures/``;
* parsing each Python file once into an :class:`ast.AST` shared by every rule;
* suppression comments — ``# tnc: allow-<rule>(reason)`` — extracted with
  :mod:`tokenize` so a *string literal* that happens to contain the marker
  (e.g. in the engine's own tests) never acts as a suppression.  A comment
  suppresses matching findings on its own line, or on the following line when
  it stands alone.  The reason is mandatory; an empty reason or an unknown
  rule slug is reported through the engine's own meta rules (TNC002/TNC003),
  which — like a parse failure (TNC001) — cannot themselves be suppressed;
* stable output: human one-line-per-finding, or ``--format json`` with a
  versioned schema, both sorted by (path, line, rule).

Rules come in two shapes (see :mod:`tpu_node_checker_torch.analysis.rules`):
per-file rules get a :class:`FileContext`, project rules get the whole
:class:`Project` (for cross-surface drift checks).
"""

from __future__ import annotations

import ast
import io
import json
import re
import time
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

# Engine meta findings — not suppressable, not in the rule registry.
CODE_SYNTAX_ERROR = ("syntax-error", "TNC001")
CODE_SUPPRESSION_NO_REASON = ("suppression-missing-reason", "TNC002")
CODE_SUPPRESSION_UNKNOWN = ("suppression-unknown-rule", "TNC003")

_ALLOW_RE = re.compile(r"tnc:\s*allow-([a-z0-9-]+)\(([^)]*)\)")

# The default walk: Python sources under these top-level entries.  The
# violation corpus is excluded — it exists to *contain* findings.
_PY_ROOTS = ("tpu_node_checker_torch", "tests")
_PY_EXTRAS = ("bench.py",)
_EXCLUDE_PARTS = ("__pycache__", "analysis_fixtures")

# v2: adds top-level ``timings_ms`` (parse, graph_build, per-rule, total)
# — additive, but versioned so CI artifact consumers can tell.
# v3: the typestate tier — TNC114–117 rule codes appear in findings and
# ``timings_ms`` (incl. the "typestate_build" phase); a SARIF 2.1.0
# surface exists alongside (--format sarif), versioned by its own
# $schema, not by this number.
JSON_SCHEMA_VERSION = 3


@dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""

    rule: str  # stable slug, e.g. "broad-except" — the suppression key
    code: str  # stable short code, e.g. "TNC010" — the docs/table key
    path: str  # root-relative POSIX path
    line: int
    col: int
    message: str

    def sort_key(self) -> Tuple:
        return (self.path, self.line, self.col, self.code)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclass
class Suppression:
    line: int  # line the comment sits on
    rule: str
    reason: str
    standalone: bool  # comment-only line → applies to the NEXT line
    used: bool = False


@dataclass
class FileContext:
    """One parsed Python file, shared by every per-file rule.

    A module-level raw-string constant named ``*_SCRIPT`` (the probe child
    script pattern in ``probe/liveness.py``) is real production code the
    host file's AST cannot see — the walker lifts each into its own
    *virtual* FileContext (``path#NAME``) with ``line_offset`` set so every
    finding and suppression lands on the host file's real line numbers.
    """

    path: str  # root-relative POSIX (virtual files: "host.py#CONST_NAME")
    source: str
    tree: Optional[ast.AST]
    line_offset: int = 0
    suppressions: List[Suppression] = field(default_factory=list)

    def in_package(self) -> bool:
        return self.path.startswith("tpu_node_checker_torch/")

    def in_tests(self) -> bool:
        return self.path.startswith("tests/")


@dataclass
class Project:
    """Everything the rules may look at, parsed once."""

    root: str
    files: Dict[str, FileContext] = field(default_factory=dict)
    # Non-Python contract surfaces: root-relative path -> text (absent keys
    # mean the file does not exist in this project root).
    texts: Dict[str, str] = field(default_factory=dict)


@dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Finding]
    files_scanned: int
    # Suppressions whose rule produced no finding at their site — the waiver
    # outlived the code it excused (fixed, moved, or mistyped).  Reported as
    # information, never as failure: some annotate sites a rule *could*
    # reach after a refactor (e.g. a broad except that currently re-raises),
    # and that documentation is worth keeping.
    unused_suppressions: List[dict] = field(default_factory=list)
    # Per-rule wall cost in ms (keyed by rule code), plus the engine's own
    # phases: "parse", "graph_build" (the flow tier, when it ran), "total".
    # The whole-repo run is a CI gate — it stays benchmarkable or it rots.
    timings_ms: Dict[str, float] = field(default_factory=dict)
    # How many files were replayed from the incremental cache (0 on full
    # runs) — surfaced so a cached verdict is never mistaken for a scan.
    cached_files: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self) -> dict:
        return {
            "schema": JSON_SCHEMA_VERSION,
            "files_scanned": self.files_scanned,
            "cached_files": self.cached_files,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "unused_suppressions": self.unused_suppressions,
            "timings_ms": {k: round(v, 2)
                           for k, v in sorted(self.timings_ms.items())},
        }


def extract_suppressions(source: str) -> Tuple[List[Suppression], List[Finding]]:
    """Real COMMENT tokens only → (suppressions, malformed-suppression findings).

    Findings carry empty ``path`` — the caller stamps it.  A suppression with
    an empty reason or an unknown rule slug is *invalid*: it is reported and
    does NOT suppress anything (a blanket or unaccountable waiver must never
    silently win).
    """
    from tpu_node_checker_torch.analysis.rules import RULE_SLUGS

    sups: List[Suppression] = []
    findings: List[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [], []  # the parse-failure finding covers this file already
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        for match in _ALLOW_RE.finditer(tok.string):
            rule, reason = match.group(1), match.group(2).strip()
            line = tok.start[0]
            standalone = tok.line.strip().startswith("#")
            if not reason:
                slug, code = CODE_SUPPRESSION_NO_REASON
                findings.append(Finding(
                    slug, code, "", line, tok.start[1],
                    f"suppression 'allow-{rule}' has no reason — "
                    "'# tnc: allow-<rule>(why this site is exempt)' is the "
                    "contract; an unexplained waiver does not suppress",
                ))
                continue
            if rule not in RULE_SLUGS:
                slug, code = CODE_SUPPRESSION_UNKNOWN
                findings.append(Finding(
                    slug, code, "", line, tok.start[1],
                    f"suppression names unknown rule 'allow-{rule}' "
                    f"(known: {', '.join(sorted(RULE_SLUGS))})",
                ))
                continue
            sups.append(Suppression(line, rule, reason, standalone))
    return sups, findings


def _apply_suppressions(
    ctx: FileContext, findings: List[Finding]
) -> Tuple[List[Finding], List[Finding]]:
    """Split one file's rule findings into (active, suppressed).

    ``by_key`` is a multimap: a standalone waiver above a line AND a
    same-line waiver for the same rule can both cover one finding, and
    each is an independent (rule, file, line) account — marking only one
    ``used`` would report the other as spuriously unused.
    """
    by_key: Dict[Tuple[int, str], List[Suppression]] = {}
    for sup in ctx.suppressions:
        by_key.setdefault((sup.line, sup.rule), []).append(sup)
        if sup.standalone:
            by_key.setdefault((sup.line + 1, sup.rule), []).append(sup)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for finding in findings:
        sups = by_key.get((finding.line, finding.rule))
        if sups:
            for sup in sups:
                sup.used = True
            suppressed.append(finding)
        else:
            active.append(finding)
    return active, suppressed


# Non-Python contract surfaces the drift rules read.
TEXT_SURFACES = ("README.md", "deploy/prometheusrule.yaml", "docs/DESIGN.md")


def check_project_root(root: str) -> None:
    import os

    if not os.path.isdir(os.path.join(root, "tpu_node_checker_torch")):
        raise NotAProjectRoot(
            f"{root!r} does not contain a tpu_node_checker_torch/ package — "
            "run from a checkout or pass --root"
        )


def walk_py_paths(root: str) -> List[str]:
    """Root-relative POSIX paths of every Python file in the walk — the
    ONE enumeration shared by full runs and the incremental cache."""
    import os

    py_paths: List[str] = []
    for top in _PY_ROOTS:
        top_abs = os.path.join(root, top)
        for dirpath, dirnames, filenames in os.walk(top_abs):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _EXCLUDE_PARTS
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    rel = os.path.relpath(
                        os.path.join(dirpath, name), root
                    ).replace(os.sep, "/")
                    py_paths.append(rel)
    for extra in _PY_EXTRAS:
        if os.path.isfile(os.path.join(root, extra)):
            py_paths.append(extra)
    return py_paths


def load_py_file(root: str, rel: str, project: Project) -> None:
    """Parse one walked file (plus its embedded-script virtual files)
    into ``project.files``."""
    import os

    with open(os.path.join(root, rel), "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        tree = None
    project.files[rel] = FileContext(path=rel, source=source, tree=tree)
    if tree is not None:
        for virt in _embedded_scripts(rel, tree):
            project.files[virt.path] = virt


def load_project(root: str) -> Project:
    """Parse every walked file once.  Raises ``NotAProjectRoot`` when the
    root does not look like a checkout (no ``tpu_node_checker_torch/`` dir)."""
    import os

    check_project_root(root)
    project = Project(root=root)
    for rel in walk_py_paths(root):
        load_py_file(root, rel, project)
    for rel in TEXT_SURFACES:
        abs_path = os.path.join(root, rel)
        if os.path.isfile(abs_path):
            with open(abs_path, "r", encoding="utf-8") as fh:
                project.texts[rel] = fh.read()
    return project


class NotAProjectRoot(Exception):
    """The --root (or cwd) is not a repository checkout."""


def _embedded_scripts(rel: str, tree: ast.AST) -> Iterable[FileContext]:
    """Module-level ``NAME_SCRIPT = "…"`` constants, parsed as virtual files.

    The probe child (``probe/liveness.py``'s ``_CHILD_SCRIPT``) is ~500
    lines of production code shipped as a string literal — invisible to the
    host file's AST, and exactly where a swallowed exception hurts most (it
    runs on the TPU host, far from a debugger).  Line numbers are shifted to
    the HOST file's coordinates so findings are clickable and suppressions
    (real comments *inside* the script string) line up.
    """
    for node in getattr(tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not (isinstance(target, ast.Name) and target.id.endswith("_SCRIPT")):
            continue
        value = node.value
        if not (isinstance(value, ast.Constant) and isinstance(value.value, str)):
            continue
        try:
            sub_tree = ast.parse(value.value)
        except SyntaxError:
            continue  # not Python (a shell template, say) — not ours to lint
        offset = value.lineno - 1
        ast.increment_lineno(sub_tree, offset)
        yield FileContext(
            path=f"{rel}#{target.id}",
            source=value.value,
            tree=sub_tree,
            line_offset=offset,
        )


def lint_file(ctx: FileContext, wanted: Optional[set],
              timings: Optional[Dict[str, float]] = None,
              ) -> Tuple[List[Finding], List[Finding]]:
    """One file through suppression extraction + every per-file rule.

    Returns ``(active, suppressed)``; marks ``ctx.suppressions`` used.
    Shared verbatim by the full run and the incremental cache's
    changed-file path, so the two can never disagree on a file's verdict.
    """
    from tpu_node_checker_torch.analysis.rules import FILE_RULES

    findings: List[Finding] = []
    if ctx.tree is None:
        slug, code = CODE_SYNTAX_ERROR
        return [Finding(slug, code, ctx.path, 1, 0,
                        "file does not parse as Python")], []
    sups, meta = extract_suppressions(ctx.source)
    for sup in sups:  # virtual files: shift to host-file coordinates
        sup.line += ctx.line_offset
    ctx.suppressions = sups
    for m in meta:  # malformed suppressions: never suppressable
        findings.append(Finding(m.rule, m.code, ctx.path,
                                m.line + ctx.line_offset, m.col,
                                m.message))
    file_findings: List[Finding] = []
    for rule in FILE_RULES:
        if wanted is not None and rule.slug not in wanted:
            continue
        t0 = time.perf_counter()
        file_findings.extend(rule.check_file(ctx))
        if timings is not None:
            timings[rule.code] = (timings.get(rule.code, 0.0)
                                  + (time.perf_counter() - t0) * 1e3)
    active, shushed = _apply_suppressions(ctx, file_findings)
    return findings + active, shushed


def run_project_rules(project: Project, wanted: Optional[set],
                      timings: Optional[Dict[str, float]] = None,
                      only_codes: Optional[set] = None,
                      ) -> Dict[str, List[Finding]]:
    """Every project rule (drift + graph) -> raw findings per rule code.

    ``only_codes`` lets the incremental cache re-run just the rules whose
    input slice changed.  Timing attributes the flow tier's one-time graph
    build to ``graph_build``, not to whichever rule happened to go first.
    """
    from tpu_node_checker_torch.analysis.rules import PROJECT_RULES

    out: Dict[str, List[Finding]] = {}
    prev_build = {"_flow_state": 0.0, "_typestate_state": 0.0}
    phase_key = {"_flow_state": "graph_build",
                 "_typestate_state": "typestate_build"}
    for rule in PROJECT_RULES:
        if wanted is not None and rule.slug not in wanted:
            continue
        if only_codes is not None and rule.code not in only_codes:
            continue
        t0 = time.perf_counter()
        out[rule.code] = list(rule.check_project(project))
        elapsed = (time.perf_counter() - t0) * 1e3
        if timings is not None:
            for attr, phase in phase_key.items():
                state = getattr(project, attr, None)
                build = state.build_ms if state is not None else 0.0
                if build != prev_build[attr]:  # this rule triggered it
                    timings[phase] = build
                    elapsed = max(0.0, elapsed - (build - prev_build[attr]))
                    prev_build[attr] = build
            timings[rule.code] = timings.get(rule.code, 0.0) + elapsed
    return out


def apply_project_findings(project: Project,
                           per_rule: Dict[str, List[Finding]],
                           findings: List[Finding],
                           suppressed: List[Finding]) -> None:
    """Project findings land on concrete files too — honor suppressions in
    Python surfaces (e.g. a deliberately-undocumented internal flag, or a
    graph-rule waiver on a read-path ROOT function)."""
    by_path: Dict[str, List[Finding]] = {}
    for group in per_rule.values():
        for f in group:
            by_path.setdefault(f.path, []).append(f)
    for path, group in by_path.items():
        ctx = project.files.get(path)
        if ctx is None:
            findings.extend(group)
            continue
        active, shushed = _apply_suppressions(ctx, group)
        findings.extend(active)
        suppressed.extend(shushed)


def collect_unused_suppressions(project: Project) -> List[dict]:
    unused = [
        {"path": ctx.path, "line": sup.line, "rule": sup.rule,
         "reason": sup.reason}
        for ctx in project.files.values()
        for sup in ctx.suppressions
        if not sup.used
    ]
    unused.sort(key=lambda u: (u["path"], u["line"], u["rule"]))
    return unused


def run_project(root: str, only_rules: Optional[Iterable[str]] = None) -> Report:
    """Walk + parse + run every registered rule; apply suppressions."""
    t_start = time.perf_counter()
    timings: Dict[str, float] = {}
    wanted = set(only_rules) if only_rules else None
    t0 = time.perf_counter()
    project = load_project(root)
    timings["parse"] = (time.perf_counter() - t0) * 1e3
    findings: List[Finding] = []
    suppressed: List[Finding] = []

    for ctx in project.files.values():
        active, shushed = lint_file(ctx, wanted, timings)
        findings.extend(active)
        suppressed.extend(shushed)

    per_rule = run_project_rules(project, wanted, timings)
    apply_project_findings(project, per_rule, findings, suppressed)

    unused = collect_unused_suppressions(project)
    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    timings["total"] = (time.perf_counter() - t_start) * 1e3
    return Report(findings, suppressed, files_scanned=len(project.files),
                  unused_suppressions=unused, timings_ms=timings)


def render_human(report: Report) -> str:
    lines = []
    for f in report.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.code}[{f.rule}] {f.message}")
    for u in report.unused_suppressions:
        lines.append(
            f"{u['path']}:{u['line']}: note: suppression 'allow-{u['rule']}' "
            "matched no finding (informational — the waiver may have "
            "outlived the code it excused)"
        )
    cached = (f" ({report.cached_files} replayed from cache)"
              if report.cached_files else "")
    lines.append(
        f"tnc-lint: {len(report.findings)} finding(s), "
        f"{len(report.suppressed)} suppressed, "
        f"{len(report.unused_suppressions)} unused suppression(s), "
        f"{report.files_scanned} files scanned{cached}"
    )
    t = report.timings_ms
    if t:
        phases = ", ".join(
            f"{key} {t[key]:.0f}ms"
            for key in ("parse", "graph_build", "typestate_build")
            if key in t
        )
        rules = sorted(
            ((k, v) for k, v in t.items()
             if k not in ("parse", "graph_build", "typestate_build",
                          "total")),
            key=lambda kv: -kv[1],
        )[:3]
        slowest = ", ".join(f"{k} {v:.0f}ms" for k, v in rules)
        lines.append(
            f"tnc-lint timings: total {t.get('total', 0.0):.0f}ms"
            + (f" ({phases}; slowest rules: {slowest})" if phases or slowest
               else "")
        )
    return "\n".join(lines)


def render_json(report: Report) -> str:
    return json.dumps(report.to_dict(), indent=2, sort_keys=True)
