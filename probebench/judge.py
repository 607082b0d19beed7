"""The comparison that decides ``correct``.

Every round's captures (what the probe child's timed path produced, and
each rank it spawned, recorded by ``hook/sitecustomize.py`` and its taps)
are held against the plain reference, worked out again on the same device
once the window has closed.  Each compared number is the worst over every
round of the run and has its own limit, from the cell's ``limits``; a run
reports its cell's ``limits`` keys, in their order:

* ``rounds_failed``: rounds whose exit code is not 0 or whose report is not ok;
* ``outputs_missing``: outputs the traffic's ``judged`` counts expect and no
  capture of the round holds (a child or rank that died, hung or skipped a
  probe), counted for each probe round (a warm-up round by ``warmup_judged``
  where the traffic gives it), and for each round of a soak;
* ``report_mismatches``: rounds whose report file breaks the configuration's
  guarantee, that each round's report is schema-valid and written
  atomically: the file is missing or unreadable, differs from the report the
  round returned, was not replaced by a new file, left a file of its name
  beside it, was written before the round began, or departs from the
  declared schema (``reference/report_schema.py``);
* ``burn_checksum_gap``: |checksum - reference| / ||last product||_F, the
  worst run of the compute stage's chain (each burn runs its chain twice);
* ``soak_checksum_gap``: the same over every soak round's chain runs;
* ``burn_invariant_gap``: the tensor-core trace(A A^T) and the elementwise
  ||A||_F^2, each against float64, relative;
* one number for each other output kind: ``reference/<kind>.py`` names it
  (``CHECK``), says whether it is a gap, the largest over the outputs
  (``REDUCE = "max"``), or a count, summed (``"sum"``), and gives
  ``compare(args, idx, got, device) -> (check, value)``.  ``idx`` is the
  array the capture names beside the output: the sampled indices, or the
  inputs the reference starts from.

A cell compares the numbers of the outputs its traffic judges.
"""

from __future__ import annotations

import importlib.util
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List

import numpy as np

from probebench.reference import probes as ref
from probebench.reference import report_schema

REFERENCE_DIR = Path(__file__).resolve().parent / "reference"
# The compared numbers of every cell, and those of the burn chain and its
# invariant, whose captures are the hook's own records; "soak:" names a
# kind of the soak rounds.
BASE_CHECKS = ("rounds_failed", "outputs_missing", "report_mismatches")
CHAIN_CHECKS = {"burn_chain": "burn_checksum_gap", "soak:burn_chain": "soak_checksum_gap",
                "burn_invariant": "burn_invariant_gap", "soak:burn_invariant": "burn_invariant_gap"}
_references: dict = {}


def reference_of(kind: str):
    """``reference/<kind>.py``, loaded once."""
    if kind not in _references:
        path = REFERENCE_DIR / f"{kind}.py"
        if not path.is_file():
            raise ValueError(f"no reference for output kind {kind!r}")
        spec = importlib.util.spec_from_file_location(
            f"probebench_reference_{kind.replace('.', '_').replace('-', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _references[kind] = module
    return _references[kind]


def checks_of(traffic: dict) -> list:
    """The numbers a cell with this traffic compares."""
    kinds = list(traffic["judged"]) + [f"soak:{k}" for k in traffic.get("soak_judged", {})]
    names = list(BASE_CHECKS)
    for kind in kinds:
        name = CHAIN_CHECKS.get(kind) or reference_of(kind.split(":", 1)[-1]).CHECK
        if name not in names:
            names.append(name)
    return names


def captures(r: dict) -> list:
    """(capture, arrays) of every process of a round: the probe child's,
    then each spawned rank's in rank order; a capture may be None."""
    return [(r.get("capture"), r.get("arrays") or {})] + [
        (k.get("capture"), k.get("arrays") or {}) for k in r.get("ranks") or []]


def _kinds(meta: dict, soak: bool, round_: int = 0) -> Counter:
    """Outputs of each kind in one capture, of the compute stage or of one
    soak round (numbered from 1)."""
    def mine(entry):
        return entry["soak"] == soak and (not soak or entry["round"] == round_)

    got = Counter()
    got["burn_chain"] = sum(1 for c in meta["chain"] if mine(c))
    got["burn_invariant"] = sum(1 for c in meta["invariant"] if mine(c))
    for o in meta["outputs"]:
        if mine(o):
            got[o["kind"]] += 1
    return got


def missing_outputs(rounds: List[dict], traffic: dict) -> int:
    """Expected outputs that no capture holds: ``judged`` gives the least
    of each kind a probe round yields (``warmup_judged``, where given, a
    warm-up round's), ``soak_judged`` each soak round."""
    missing = 0
    for r in rounds:
        meta = r.get("capture")
        expect = traffic.get("warmup_judged", traffic["judged"]) if r.get("warm") \
            else traffic["judged"]
        if meta is None:
            missing += sum(expect.values())
            continue
        got = Counter()
        for rank_meta, _ in captures(r):
            if rank_meta is not None:
                got.update(_kinds(rank_meta, soak=False))
        missing += sum(max(0, n - got[k]) for k, n in expect.items())
        soak_expect = traffic.get("soak_judged")
        if soak_expect:
            n_rounds = (meta.get("soak") or {}).get("rounds") or 0
            if n_rounds < 1:
                missing += sum(soak_expect.values())
            for i in range(1, n_rounds + 1):
                got = _kinds(meta, soak=True, round_=i)
                missing += sum(max(0, n - got[k]) for k, n in soak_expect.items())
    return missing


def report_faults(rounds: List[dict]) -> List[str]:
    """How each round's report file breaks the guarantee; [] if none does."""
    faults = []
    for i, r in enumerate(rounds):
        w = r.get("written")
        if w is None:
            continue  # the round wrote to standard output
        doc, why = w["doc"], []
        if doc is None:
            why.append("no report file read back")
        else:
            if json.dumps(doc, sort_keys=True) != json.dumps(r.get("report"), sort_keys=True):
                why.append("the file differs from the round's report")
            if not w["new_file"]:
                why.append("the file was not replaced by a new one")
            written_at = doc.get("written_at")
            if not isinstance(written_at, (int, float)) or written_at < r["start_wall"]:
                why.append(f"written_at {written_at!r} precedes the round")
            why += report_schema.violations(doc)[:3]
        if w["beside"]:
            why.append(f"left beside it: {', '.join(w['beside'])}")
        if why:
            faults.append(f"round {i}: " + "; ".join(why))
    return faults


def judge(rounds: List[dict], traffic: dict, limits: Dict[str, float], device) -> List[dict]:
    """The compared numbers of a run, each with its limit and verdict.

    ``rounds``: one dict per probe round with ``rc``, ``report`` (the emitted
    document), ``capture`` (the hook's JSON, or None) and ``arrays`` (its
    npz contents).
    """
    names = list(limits)
    expected = checks_of(traffic)
    if set(names) != set(expected):
        raise ValueError(f"the cell's limits {sorted(names)} are not the numbers its traffic "
                         f"compares {sorted(expected)}")
    values = {name: 0.0 for name in names}
    values["rounds_failed"] = sum(
        1 for r in rounds if r["rc"] != 0 or not (r.get("report") or {}).get("ok"))
    values["outputs_missing"] = missing_outputs(rounds, traffic)
    faults = report_faults(rounds)
    values["report_mismatches"] = len(faults)
    chains: Dict[tuple, tuple] = {}
    invariants: Dict[int, float] = {}
    for r in rounds:
        for meta, arrays in captures(r):
            if meta is None:
                continue
            for c in meta["chain"]:
                key = (c["n"], c["iters"])
                if key not in chains:
                    chains[key] = ref.burn_chain(c["n"], c["iters"], device)
                checksum, frob = chains[key]
                gap = abs(c["checksum"] - checksum) / frob if np.isfinite(c["checksum"]) else np.inf
                name = "soak_checksum_gap" if c["soak"] else "burn_checksum_gap"
                values[name] = max(values.get(name, 0.0), gap)
            for c in meta["invariant"]:
                if c["n"] not in invariants:
                    invariants[c["n"]] = ref.burn_invariant(c["n"], device)
                want = invariants[c["n"]]
                gap = max(abs(c["trace"] - want), abs(c["sumsq"] - want)) / want
                values["burn_invariant_gap"] = max(values.get("burn_invariant_gap", 0.0),
                                                   gap if np.isfinite(gap) else np.inf)
            for o in meta["outputs"]:
                idx, got = arrays[o["idx"]], arrays[f"{o['key']}_val"]
                name, value = compare(o["kind"], o["args"], idx, got, device)
                if reference_of(o["kind"]).REDUCE == "max":
                    values[name] = max(values.get(name, 0.0), value)
                else:
                    values[name] = values.get(name, 0.0) + value
    return [{"name": name, "value": float(values[name]), "limit": float(limits[name]),
             "ok": bool(values[name] <= limits[name]),
             **({"faults": faults} if name == "report_mismatches" and faults else {})}
            for name in names]


def compare(kind: str, args: dict, idx: np.ndarray, got: np.ndarray, device) -> tuple:
    """(check name, gap or mismatch count) of one output, by its kind's reference."""
    return reference_of(kind).compare(args, idx, got, device)
