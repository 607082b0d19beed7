"""The port's tnc-lint (``tpu_node_checker_torch/analysis/``), held to the JAX lint.

The port's ``analysis/`` is a copy of the JAX package's
(``tests/test_torch_copies.py``) that walks ``tpu_node_checker_torch/``,
``tests/`` and ``bench.py``.  So on a copy of the seeded corpus
``tests/analysis_fixtures/repo`` whose package is renamed
``tpu_node_checker_torch`` (the directory, and the package name in every
file; the metric prefix ``tpu_node_checker_`` stays), the port must say
what the JAX lint says over the original, once the package name is mapped
back:

* the same findings (code, path, line, column, message), in human, JSON
  and SARIF form (timings masked), and the ``EXPECT[TNCxxx]`` markers
  match the port's findings both ways, one case per rule code;
* the same exit codes: 0 clean, 1 findings, 2 usage error, 3 a rule that
  raised;
* ``--changed-only --cache`` gives the full run's report, cold and warm
  with one file touched; the two linters, run in turn against one default
  ``.tnc-lint-cache.json``, replay nothing of each other's (their
  fingerprints hash their own sources);
* ``--list-rules`` prints the same table.

And the port lints this repository clean: zero unsuppressed findings, a
reason on every suppression, the port and the tests walked.  A fresh
interpreter that imports ``…analysis.flow.rules`` first gets its rules
whole (the JAX package's ``analysis/__init__.py`` lacks the one import that
breaks the cycle) and loads no ``torch``, ``jax`` or JAX package module
while it lints.

The JAX package's ``analysis.rules`` is imported before anything that
reaches its ``analysis.flow.rules``: the other order fails on the
reference's circular import.  The port is reached through
``importlib.import_module``: tests/test_dependency_surface.py rejects any
other ``import`` in tests/.
"""

import concurrent.futures
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_node_checker.analysis import rules as jax_rules  # first: the reference's import cycle
from tpu_node_checker.analysis import __main__ as jax_cli
from tpu_node_checker.analysis import cache as jax_cache
from tpu_node_checker.analysis import engine as jax_engine

port_rules = importlib.import_module("tpu_node_checker_torch.analysis.rules")
port_cli = importlib.import_module("tpu_node_checker_torch.analysis.__main__")
port_cache = importlib.import_module("tpu_node_checker_torch.analysis.cache")
port_engine = importlib.import_module("tpu_node_checker_torch.analysis.engine")

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "analysis_fixtures" / "repo"
_MARKER = re.compile(r"EXPECT\[(TNC\d+)\]")
_PORT_NAME = re.compile(r"\btpu_node_checker_torch\b")
_TIMINGS = re.compile(r"^tnc-lint timings: .*$", re.MULTILINE)
CODES = sorted({r.code for r in jax_rules.ALL_RULES} | {"TNC001", "TNC002", "TNC003"})


def _rename_tree(src: Path, dst: Path) -> None:
    """A copy of a corpus root with its package renamed for the port."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "tpu_node_checker").rename(dst / "tpu_node_checker_torch")
    for path in dst.rglob("*"):
        if path.is_file():
            path.write_text(re.sub(r"\btpu_node_checker\b", "tpu_node_checker_torch",
                                   path.read_text()))


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_corpus") / "repo"
    _rename_tree(CORPUS, root)
    return root


def _back(text: str) -> str:
    """The port's output with its package name mapped back to the JAX one."""
    return _PORT_NAME.sub("tpu_node_checker", text)


def _rows(report) -> list:
    return [(f.code, _back(f.path), f.line, f.col, _back(f.message)) for f in report.findings]


def _verdict(doc: dict) -> dict:
    """A report's document less its timings and its cache count."""
    return {k: v for k, v in doc.items() if k not in ("timings_ms", "cached_files")}


def test_corpus_findings_equal_jax(port_corpus):
    ref = jax_engine.run_project(str(CORPUS))
    port = port_engine.run_project(str(port_corpus))
    assert _rows(port) == [(f.code, f.path, f.line, f.col, f.message) for f in ref.findings]
    assert len(ref.findings) == 75 and port.exit_code == ref.exit_code == 1
    assert json.loads(_back(json.dumps(_verdict(port.to_dict())))) == _verdict(ref.to_dict())


def _masked(fmt: str, text: str) -> str:
    if fmt == "json":
        doc = json.loads(text)
        doc.pop("timings_ms")
        return json.dumps(doc, indent=2, sort_keys=True)
    return _TIMINGS.sub("tnc-lint timings: <masked>", text).rstrip("\n")


@pytest.mark.parametrize("fmt", ["human", "json", "sarif"])
def test_corpus_output_equals_jax_in_each_format(port_corpus, capsys, fmt):
    assert jax_cli.main(["--root", str(CORPUS), "--format", fmt]) == 1
    ref = capsys.readouterr().out
    assert port_cli.main(["--root", str(port_corpus), "--format", fmt]) == 1
    assert _masked(fmt, _back(capsys.readouterr().out)) == _masked(fmt, ref)


@pytest.fixture(scope="module")
def port_corpus_report(port_corpus):
    return port_engine.run_project(str(port_corpus))


def _markers(root: Path, code: str) -> set:
    found = set()
    for path in sorted(root.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(root).as_posix()
            for lineno, line in enumerate(path.read_text().splitlines(), start=1):
                if code in _MARKER.findall(line):
                    found.add((rel, lineno))
    return found


@pytest.mark.parametrize("code", CODES)
def test_port_findings_match_corpus_markers(port_corpus, port_corpus_report, code):
    got = {(f.path.split("#")[0], f.line)
           for f in port_corpus_report.findings if f.code == code}
    expected = _markers(port_corpus, code)
    assert got - expected == set(), f"{code} false positives: {sorted(got - expected)}"
    assert expected - got == set(), f"{code} false negatives: {sorted(expected - got)}"


def _package_only_root(root: Path, package: str) -> Path:
    (root / package).mkdir(parents=True)
    (root / package / "__init__.py").write_text('"""A clean package."""\n')
    return root


_EXIT_CASES = {
    "clean": (0, lambda root, corpus: ["--root", str(root), "--format", "json"]),
    "findings": (1, lambda root, corpus: ["--root", str(corpus), "--format", "json"]),
    "unknown-rule": (2, lambda root, corpus: ["--root", str(corpus), "--rule", "no-such-rule"]),
    "not-a-checkout": (2, lambda root, corpus: ["--root", str(root / "nowhere")]),
    "rule-with-cache": (2, lambda root, corpus: ["--root", str(corpus), "--changed-only",
                                                 "--rule", "broad-except"]),
    "rule-raised": (3, lambda root, corpus: ["--root", str(corpus)]),
}


@pytest.mark.parametrize("case", list(_EXIT_CASES))
def test_exit_codes_equal_jax(port_corpus, tmp_path, monkeypatch, capsys, case):
    rc, argv = _EXIT_CASES[case]

    def boom(ctx):
        raise AttributeError("rule crashed mid-walk")

    outs = []
    for cli, rules, package, corpus in ((jax_cli, jax_rules, "tpu_node_checker", CORPUS),
                                        (port_cli, port_rules, "tpu_node_checker_torch",
                                         port_corpus)):
        root = _package_only_root(tmp_path / package, package)
        if case == "rule-raised":
            (rule,) = [r for r in rules.ALL_RULES if r.code == "TNC013"]
            monkeypatch.setattr(rule, "check_file", boom)
        assert cli.main(argv(root, corpus)) == rc
        out, err = capsys.readouterr()
        outs.append((_masked("json", out) if out.startswith("{") else out,
                     err.splitlines()[-1] if err else ""))
    # Each root is tmp_path/<package>, so the port's maps back onto the JAX one's.
    ref, port = outs
    assert (_back(port[0]), _back(port[1])) == ref


def _json(cli, argv, capsys) -> dict:
    assert cli.main(argv + ["--format", "json"]) in (0, 1)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_changed_only_cache_equals_full_run(port_corpus, tmp_path, capsys, side):
    cli = jax_cli if side == "jax" else port_cli
    root = tmp_path / "repo"
    shutil.copytree(CORPUS if side == "jax" else port_corpus, root)
    cache = str(tmp_path / "lint-cache.json")
    full = _json(cli, ["--root", str(root)], capsys)
    cold = _json(cli, ["--root", str(root), "--changed-only", "--cache", cache], capsys)
    assert cold["cached_files"] == 0 and _verdict(cold) == _verdict(full)

    touched = next(root.glob("tpu_node_checker*/sample_broad.py"))
    touched.write_text(touched.read_text() + "# touched\n")
    full = _json(cli, ["--root", str(root)], capsys)
    warm = _json(cli, ["--root", str(root), "--changed-only", "--cache", cache], capsys)
    assert 0 < warm["cached_files"] < warm["files_scanned"]
    assert _verdict(warm) == _verdict(full)
    assert any(f["path"] == touched.relative_to(root).as_posix() for f in warm["findings"])


def test_two_linters_share_a_default_cache_and_replay_nothing_stale(port_corpus, tmp_path):
    # One checkout holding both packages; each linter's default cache file
    # is the same <root>/.tnc-lint-cache.json.
    root = tmp_path / "repo"
    shutil.copytree(CORPUS, root)
    shutil.copytree(port_corpus / "tpu_node_checker_torch", root / "tpu_node_checker_torch")
    full = {"jax": _verdict(jax_engine.run_project(str(root)).to_dict()),
            "port": _verdict(port_engine.run_project(str(root)).to_dict())}
    assert full["jax"] != full["port"]
    runs = {"jax": jax_cache.run_incremental, "port": port_cache.run_incremental}
    for side in ("jax", "port", "jax", "port"):
        report = runs[side](str(root))
        assert report.cached_files == 0, f"{side} replayed the other linter's cache"
        assert _verdict(report.to_dict()) == full[side]
    assert (root / ".tnc-lint-cache.json").is_file()
    again = port_cache.run_incremental(str(root))
    assert again.cached_files > 0 and _verdict(again.to_dict()) == full["port"]


def test_rule_tables_equal_jax(capsys):
    assert jax_cli.main(["--list-rules"]) == 0
    ref = capsys.readouterr().out
    assert port_cli.main(["--list-rules"]) == 0
    assert _back(capsys.readouterr().out) == ref
    assert [(r.code, r.slug, _back(r.doc)) for r in port_rules.ALL_RULES] == \
        [(r.code, r.slug, r.doc) for r in jax_rules.ALL_RULES]


@pytest.fixture(scope="module")
def repo_report():
    return port_engine.run_project(str(REPO))


def test_port_lints_the_repo_clean(repo_report):
    assert repo_report.findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.code}[{f.rule}] {f.message}" for f in repo_report.findings)


def test_every_port_suppression_carries_a_reason(repo_report):
    paths = sorted((REPO / "tpu_node_checker_torch").rglob("*.py"))
    assert len(paths) > 100
    for path in paths:
        sups, meta = port_engine.extract_suppressions(path.read_text())
        assert meta == []
        for sup in sups:
            assert len(sup.reason) >= 10, f"{path}:{sup.line}: thin reason {sup.reason!r}"
    assert any(f.path.startswith("tpu_node_checker_torch/") for f in repo_report.suppressed)


def test_port_repo_scan_covers_the_port_and_tests(repo_report):
    walked = port_engine.walk_py_paths(str(REPO))
    assert "tpu_node_checker_torch/analysis/engine.py" in walked
    assert "tests/test_torch_analysis.py" in walked and "bench.py" in walked
    assert not any(p.startswith("tpu_node_checker/") for p in walked)
    assert not any("analysis_fixtures" in p for p in walked)
    # The probe child script rides along as a virtual file, its waiver used.
    assert repo_report.files_scanned > len(walked)
    assert ("tpu_node_checker_torch/probe/liveness.py#_CHILD_SCRIPT", "TNC010") in \
        {(f.path, f.code) for f in repo_report.suppressed}


def _cold(argv, cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable] + argv, cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_import_order_and_modules_of_a_lint_process(port_corpus):
    code = (
        "import json, sys\n"
        "import tpu_node_checker_torch.analysis.flow.rules as flow\n"
        "from tpu_node_checker_torch.analysis.engine import run_project\n"
        f"report = run_project({str(port_corpus)!r})\n"
        "print(json.dumps({'flow_rules': [r.code for r in flow.RULES],\n"
        "                  'findings': len(report.findings), 'modules': sorted(sys.modules)}))\n"
    )
    proc = _cold(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["flow_rules"] == [r.code for r in
                                 importlib.import_module("tpu_node_checker.analysis.flow.rules").RULES]
    assert len(doc["flow_rules"]) == 7 and doc["findings"] == 75
    roots = {m.split(".")[0] for m in doc["modules"]}
    assert not roots & {"torch", "jax", "jaxlib", "numpy", "tpu_node_checker"}


def test_cli_processes_equal_jax_on_the_corpus(port_corpus):
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        ref, port = pool.map(lambda argv: _cold(argv, REPO), [
            ["-m", "tpu_node_checker.analysis", "--root", str(CORPUS), "--format", "sarif"],
            ["-m", "tpu_node_checker_torch.analysis", "--root", str(port_corpus),
             "--format", "sarif"],
        ])
    assert ref.returncode == port.returncode == 1, (ref.stderr, port.stderr)
    assert _back(port.stdout) == ref.stdout and len(json.loads(ref.stdout)["runs"][0]["results"]) > 75
