"""``tnc-lint --changed-only``: incremental runs off a content-addressed
finding cache.

The contract is equality with the full run: a cached verdict is only
replayed when the inputs that produced it are provably identical —

* **per-file rules** are keyed by the file's content sha256: unchanged
  file, unchanged findings/suppressions (the rule reads nothing else);
* **project rules** carry an *input slice*: the graph rules (TNC111-113)
  record the files their reachability actually touched
  (``FlowState.rule_inputs``), the contract-drift rules are conservative
  ("everything" — they read every docstring plus README/prometheusrule);
  a rule re-runs when any slice file's hash moved, when the walked file
  LIST changed (a new file can add a call edge or a thread entry), or
  when the rule registry itself changed (the cache fingerprints the
  registry, so adding a rule invalidates every cached verdict);
* the ``unused_suppressions`` roll-up is replayed from cached per-file
  suppression tables and the union of used-keys across file and project
  rules, so a graph-rule waiver whose path disappeared still surfaces.

The cache file lives at ``<root>/.tnc-lint-cache.json`` (override with
``--cache``), is written atomically (tmp+rename, the history-store
idiom), and is never fatal: an unreadable or stale cache degrades to a
full run, a failed write to a warning.  ``--rule`` filters bypass the
cache entirely — a filtered run is not the repo verdict.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tpu_node_checker_torch.analysis.engine import (
    JSON_SCHEMA_VERSION,
    Finding,
    Project,
    Report,
    TEXT_SURFACES,
    _apply_suppressions,
    apply_project_findings,
    check_project_root,
    collect_unused_suppressions,
    extract_suppressions,
    lint_file,
    load_project,
    load_py_file,
    run_project_rules,
    walk_py_paths,
)

CACHE_SCHEMA = 1
DEFAULT_CACHE_NAME = ".tnc-lint-cache.json"


def _fingerprint(analysis_sha: str) -> str:
    """Registry + the analyzer's own source content: editing a rule's
    LOGIC (new blocking name, changed heuristic) must invalidate every
    cached verdict even though no code/slug moved — otherwise CI's
    restored cache replays clean verdicts under the old semantics."""
    from tpu_node_checker_torch.analysis.rules import ALL_RULES

    basis = ",".join(sorted(f"{r.code}:{r.slug}" for r in ALL_RULES))
    basis += f"|schema={JSON_SCHEMA_VERSION}|cache={CACHE_SCHEMA}"
    basis += f"|analysis={analysis_sha}"
    return hashlib.sha256(basis.encode()).hexdigest()


def _analysis_sources_sha() -> str:
    """Content hash of the INSTALLED analyzer package — the code that
    actually produced the cached verdicts, regardless of which root is
    being linted."""
    import tpu_node_checker_torch.analysis as pkg

    base = os.path.dirname(os.path.abspath(pkg.__file__))
    parts: List[str] = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name), "rb") as fh:
                parts.append(hashlib.sha256(fh.read()).hexdigest())
    return hashlib.sha256(",".join(parts).encode()).hexdigest()


def _sha_file(root: str, rel: str) -> Optional[str]:
    try:
        with open(os.path.join(root, rel), "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except OSError:
        return None


def _row(f: Finding) -> list:
    return [f.rule, f.code, f.path, f.line, f.col, f.message]


def _unrow(row: list) -> Finding:
    return Finding(*row)


def load_cache(path: str, fingerprint: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA:
        return None
    if doc.get("fingerprint") != fingerprint:
        return None  # rule registry/logic changed: every verdict is stale
    return doc


def save_cache(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, sort_keys=True)
        os.replace(tmp, path)
    except OSError as exc:
        print(f"tnc-lint: cache write failed ({exc}) — next run is full",
              file=sys.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _contexts_of(project: Project, rel: str):
    """The host FileContext plus its embedded-script virtual files."""
    ctx = project.files.get(rel)
    if ctx is not None:
        yield ctx
    prefix = f"{rel}#"
    for path, virt in project.files.items():
        if path.startswith(prefix):
            yield virt


def _populate_suppressions(project: Project, rel: str) -> None:
    """Extract suppression tables for a file the file rules did NOT run
    on this round (project-rule findings may still land there)."""
    for ctx in _contexts_of(project, rel):
        sups, _meta = extract_suppressions(ctx.source)
        for sup in sups:
            sup.line += ctx.line_offset
        ctx.suppressions = sups


def _mark_used_by_supline(project: Project, rel: str,
                          rows: Iterable[list]) -> None:
    """Replay cached file-rule 'used' marks: rows are suppression lines."""
    keys = {(line, rule) for line, rule in rows}
    for ctx in _contexts_of(project, rel):
        for sup in ctx.suppressions:
            if (sup.line, sup.rule) in keys:
                sup.used = True


def _mark_used_by_finding(project: Project, path: str, line: int,
                          rule_slug: str) -> None:
    """Replay a project rule's 'used' mark: (path, finding line, rule) —
    the same matching the engine applies (same line, or standalone one
    line above)."""
    for ctx in _contexts_of(project, path.split("#")[0]):
        for sup in ctx.suppressions:
            if sup.rule != rule_slug:
                continue
            if sup.line == line or (sup.standalone
                                    and sup.line + 1 == line):
                sup.used = True


def _file_entry(project: Project, sha: Optional[str], rel: str,
                active: List[Finding], shushed: List[Finding],
                file_used: List[list]) -> dict:
    """What a later run needs to replay this file without parsing it.

    ``sha`` is the hash taken BEFORE linting — re-hashing here would pair
    a mid-run edit's new content with the pre-edit verdict (TOCTOU).
    ``file_used`` is captured right after the FILE rules ran — project-
    rule marks are deliberately excluded (they replay with their rule's
    own cache entry, or re-derive when the rule re-runs; baking them in
    here would keep a graph-rule waiver alive after its path vanished).
    """
    entry = {
        "sha": sha,
        "nfiles": 0,
        "findings": [_row(f) for f in active],
        "suppressed": [_row(f) for f in shushed],
        "suppressions": [],
        "used": file_used,
    }
    for ctx in _contexts_of(project, rel):
        entry["nfiles"] += 1
        entry["suppressions"].extend(
            [[s.line, s.rule, s.reason, s.standalone]
             for s in ctx.suppressions])
    return entry


def _rule_entries(project: Project, shas: Dict[str, Optional[str]],
                  per_rule: Dict[str, List[Finding]]) -> Dict[str, dict]:
    """Per project rule: input slice (path -> sha) + replayable outputs.
    Must be called AFTER apply_project_findings (the split re-derivation
    uses the engine's own matcher, so the two cannot disagree)."""
    state = getattr(project, "_flow_state", None)
    slices = state.rule_inputs if state is not None else {}
    out: Dict[str, dict] = {}
    for code, group in per_rule.items():
        by_path: Dict[str, List[Finding]] = {}
        for f in group:
            by_path.setdefault(f.path, []).append(f)
        active: List[Finding] = []
        shushed: List[Finding] = []
        for path, fs in by_path.items():
            ctx = project.files.get(path)
            if ctx is None:
                active.extend(fs)
                continue
            a, s = _apply_suppressions(ctx, fs)
            active.extend(a)
            shushed.extend(s)
        slice_paths = slices.get(code)
        out[code] = {
            "inputs": ("all" if slice_paths is None else
                       {p: shas.get(p) for p in sorted(slice_paths)}),
            "findings": [_row(f) for f in sorted(active,
                                                 key=Finding.sort_key)],
            "suppressed": [_row(f) for f in sorted(shushed,
                                                   key=Finding.sort_key)],
            "used": sorted([f.path, f.line, f.rule] for f in shushed),
        }
    return out


def _save(cache_file: str, fingerprint: str,
          file_entries: Dict[str, dict], rule_entries: Dict[str, dict],
          py_paths: List[str], text_shas: Dict[str, str]) -> None:
    save_cache(cache_file, {
        "schema": CACHE_SCHEMA,
        "fingerprint": fingerprint,
        "files": file_entries,
        "texts": text_shas,
        "file_list": sorted(py_paths),
        "project_rules": rule_entries,
    })


def _text_shas(root: str) -> Dict[str, str]:
    out = {}
    for rel in TEXT_SURFACES:
        sha = _sha_file(root, rel)
        if sha is not None:
            out[rel] = sha
    return out


def run_incremental(root: str, cache_path: Optional[str] = None) -> Report:
    """The ``--changed-only`` entry point: replay what provably did not
    change, re-run what did, refresh the cache either way."""
    t_start = time.perf_counter()
    check_project_root(root)
    cache_file = cache_path or os.path.join(root, DEFAULT_CACHE_NAME)
    py_paths = walk_py_paths(root)
    shas = {rel: _sha_file(root, rel) for rel in py_paths}
    text_shas = _text_shas(root)
    fingerprint = _fingerprint(_analysis_sources_sha())
    cached = load_cache(cache_file, fingerprint)

    from tpu_node_checker_torch.analysis.rules import PROJECT_RULES

    old_files: Dict[str, dict] = (cached or {}).get("files", {})
    old_rules: Dict[str, dict] = (cached or {}).get("project_rules", {})
    if cached is None:
        changed = set(py_paths)
        rerun_codes = {r.code for r in PROJECT_RULES}
        list_changed = True
    else:
        changed = {rel for rel in py_paths
                   if old_files.get(rel, {}).get("sha") != shas.get(rel)}
        removed = set(old_files) - set(py_paths)
        list_changed = (sorted(py_paths) != cached.get("file_list", [])
                        or bool(removed))
        texts_changed = text_shas != cached.get("texts", {})
        rerun_codes = set()
        for rule in PROJECT_RULES:
            entry = old_rules.get(rule.code)
            if entry is None:
                rerun_codes.add(rule.code)
            elif entry.get("inputs") == "all":
                if changed or list_changed or texts_changed:
                    rerun_codes.add(rule.code)
            elif list_changed or any(
                    shas.get(p) != h
                    for p, h in (entry.get("inputs") or {}).items()):
                rerun_codes.add(rule.code)

    timings: Dict[str, float] = {}
    # Parse what the re-runs need: everything when a project rule moved
    # (the graph spans the tree), else just the changed files.
    t0 = time.perf_counter()
    if rerun_codes:
        project = load_project(root)
    else:
        project = Project(root=root)
        for rel in sorted(changed):
            load_py_file(root, rel, project)
    timings["parse"] = (time.perf_counter() - t0) * 1e3

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    file_entries: Dict[str, Tuple[List[Finding], List[Finding]]] = {}
    fresh_files: Set[str] = set()
    fresh_used: Dict[str, List[list]] = {}
    files_scanned = 0
    cached_files = 0
    for rel in py_paths:
        entry = old_files.get(rel)
        if rel in changed or entry is None:
            active: List[Finding] = []
            shushed: List[Finding] = []
            for ctx in _contexts_of(project, rel):  # host + virtual files
                a, s = lint_file(ctx, None, timings)
                active.extend(a)
                shushed.extend(s)
            findings.extend(active)
            suppressed.extend(shushed)
            fresh_files.add(rel)
            files_scanned += sum(1 for _ in _contexts_of(project, rel))
            file_entries[rel] = (active, shushed)
            # File-rule used marks, snapshotted BEFORE project rules add
            # theirs — the two replay through different cache entries.
            fresh_used[rel] = [
                [s.line, s.rule]
                for ctx in _contexts_of(project, rel)
                for s in ctx.suppressions if s.used
            ]
        else:
            cached_files += 1
            files_scanned += entry.get("nfiles", 1)
            findings.extend(_unrow(r) for r in entry["findings"])
            suppressed.extend(_unrow(r) for r in entry["suppressed"])
            file_entries[rel] = (
                [_unrow(r) for r in entry["findings"]],
                [_unrow(r) for r in entry["suppressed"]],
            )
            if rerun_codes:
                # The file rules did not run here, but re-running project
                # rules may land findings on this file: restore its live
                # suppression table and the cached file-rule used marks.
                _populate_suppressions(project, rel)
                _mark_used_by_supline(project, rel, entry["used"])

    # Project rules: re-run the invalidated, replay the rest.
    per_rule = run_project_rules(project, None, timings,
                                 only_codes=rerun_codes)
    apply_project_findings(project, per_rule, findings, suppressed)
    rule_entries: Dict[str, dict] = _rule_entries(project, shas, per_rule)
    for rule in PROJECT_RULES:
        if rule.code in per_rule:
            continue
        entry = old_rules.get(rule.code, {})
        findings.extend(_unrow(r) for r in entry.get("findings", []))
        suppressed.extend(_unrow(r) for r in entry.get("suppressed", []))
        for path, line, rule_slug in entry.get("used", []):
            _mark_used_by_finding(project, path, line, rule_slug)
        rule_entries[rule.code] = entry

    # Unused suppressions: live contexts carry fresh + replayed used
    # marks; files never parsed this round replay their cached tables,
    # subtracting file-rule marks AND replayed project-rule marks (those
    # are finding positions: same line, or standalone one line above).
    unused = collect_unused_suppressions(project)
    parsed_hosts = {p.split("#")[0] for p in project.files}
    proj_used: Set[Tuple[str, int, str]] = set()
    for code, entry in rule_entries.items():
        if code in per_rule and code in (rerun_codes or set()):
            continue  # fresh rules marked live contexts already
        for path, line, rule_slug in entry.get("used", []):
            proj_used.add((path.split("#")[0], line, rule_slug))
    for rel in py_paths:
        if rel in parsed_hosts:
            continue
        entry = old_files.get(rel)
        if entry is None:
            continue
        used = {(line, rule) for line, rule in entry["used"]}
        for line, rule_slug, reason, standalone in entry["suppressions"]:
            if (line, rule_slug) in used:
                continue
            if (rel, line, rule_slug) in proj_used or (
                    standalone and (rel, line + 1, rule_slug) in proj_used):
                continue
            unused.append({"path": rel, "line": line,
                           "rule": rule_slug, "reason": reason})
    unused.sort(key=lambda u: (u["path"], u["line"], u["rule"]))

    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    timings["total"] = (time.perf_counter() - t_start) * 1e3
    report = Report(findings, suppressed, files_scanned=files_scanned,
                    unused_suppressions=unused, timings_ms=timings,
                    cached_files=cached_files)

    # Refresh the cache: fresh files snapshot live state, replayed files
    # carry over verbatim (their used tables are file-rule-only by
    # construction, so no post-apply refresh may contaminate them).
    out_files: Dict[str, dict] = {}
    for rel in py_paths:
        if rel in fresh_files:
            active, shushed = file_entries[rel]
            out_files[rel] = _file_entry(project, shas.get(rel), rel,
                                         active, shushed,
                                         fresh_used.get(rel, []))
        else:
            out_files[rel] = dict(old_files[rel])
    _save(cache_file, fingerprint, out_files, rule_entries, py_paths,
          text_shas)
    return report
