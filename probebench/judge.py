"""The comparison that decides ``correct``.

Every round's capture (what the probe child's timed path produced, recorded
by ``hook/sitecustomize.py``) is held against ``reference/probes.py``, worked
out again on the same device once the window has closed.  Each compared
number is the worst over every round of the run and has its own limit,
from the cell's ``limits``:

* ``rounds_failed``: rounds whose exit code is not 0 or whose report is not ok;
* ``outputs_missing``: outputs the traffic's ``judged`` counts expect and no
  capture holds (a child that died, hung or skipped a probe), counted for
  each probe round, and for each round of a soak;
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
* ``tiled_gap``: max |out - ref| / max(|ref|, 1) over the sampled entries;
* ``flash_gap``: max |out - ref| over the output;
* ``int8_mismatches``, ``stream_mismatches``, ``dma_mismatches``,
  ``memtest_mismatches``: sampled words that differ from the exact answer.

A cell compares the numbers of the outputs its traffic judges.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List

import numpy as np

from probebench.reference import probes as ref
from probebench.reference import report_schema

# Each compared number, and the output kind it needs the traffic to judge
# (None: every cell); "soak:" names a kind of the soak rounds.
CHECKS = {
    "rounds_failed": None, "outputs_missing": None, "report_mismatches": None,
    "burn_checksum_gap": "burn_chain", "soak_checksum_gap": "soak:burn_chain",
    "burn_invariant_gap": "burn_invariant", "tiled_gap": "tiled", "flash_gap": "flash",
    "int8_mismatches": "int8", "stream_mismatches": "stream", "dma_mismatches": "dma",
    "memtest_mismatches": "memtest",
}


def checks_of(traffic: dict) -> list:
    """The numbers a cell with this traffic compares."""
    kinds = set(traffic["judged"]) | {f"soak:{k}" for k in traffic.get("soak_judged", {})}
    return [name for name, kind in CHECKS.items() if kind is None or kind in kinds]


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
    of each kind a probe round yields, ``soak_judged`` each soak round."""
    missing = 0
    for r in rounds:
        meta = r.get("capture")
        expect = traffic["judged"]
        if meta is None:
            missing += sum(expect.values())
            continue
        got = _kinds(meta, soak=False)
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
    values = {name: 0.0 for name in CHECKS}
    values["rounds_failed"] = sum(
        1 for r in rounds if r["rc"] != 0 or not (r.get("report") or {}).get("ok"))
    values["outputs_missing"] = missing_outputs(rounds, traffic)
    faults = report_faults(rounds)
    values["report_mismatches"] = len(faults)
    chains: Dict[tuple, tuple] = {}
    invariants: Dict[int, float] = {}
    for r in rounds:
        meta, arrays = r.get("capture"), r.get("arrays") or {}
        if meta is None:
            continue
        for c in meta["chain"]:
            key = (c["n"], c["iters"])
            if key not in chains:
                chains[key] = ref.burn_chain(c["n"], c["iters"], device)
            checksum, frob = chains[key]
            gap = abs(c["checksum"] - checksum) / frob if np.isfinite(c["checksum"]) else np.inf
            name = "soak_checksum_gap" if c["soak"] else "burn_checksum_gap"
            values[name] = max(values[name], gap)
        for c in meta["invariant"]:
            if c["n"] not in invariants:
                invariants[c["n"]] = ref.burn_invariant(c["n"], device)
            want = invariants[c["n"]]
            gap = max(abs(c["trace"] - want), abs(c["sumsq"] - want)) / want
            values["burn_invariant_gap"] = max(values["burn_invariant_gap"],
                                               gap if np.isfinite(gap) else np.inf)
        for o in meta["outputs"]:
            idx, got = arrays[o["idx"]], arrays[f"{o['key']}_val"]
            name, gap = compare(o["kind"], o["args"], idx, got, device)
            values[name] = max(values[name], gap) if name.endswith("_gap") else values[name] + gap
    return [{"name": name, "value": float(values[name]), "limit": float(limits[name]),
             "ok": bool(values[name] <= limits[name]),
             **({"faults": faults} if name == "report_mismatches" and faults else {})}
            for name in checks_of(traffic)]


def compare(kind: str, args: dict, idx: np.ndarray, got: np.ndarray, device) -> tuple:
    """(check name, gap or mismatch count) of one sampled output."""
    if kind == "tiled":
        want = ref.tiled_entries(args["m"], args["k"], args["n"], idx, device)
        gap = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1.0)
        return "tiled_gap", _worst(gap)
    if kind == "flash":
        want = ref.causal_attention(args["batch"], args["heads"], args["seq"],
                                    args["head_dim"], device)[idx]
        return "flash_gap", _worst(np.abs(got.astype(np.float64) - want))
    if kind == "int8":
        want = ref.int8_entries(args["m"], args["k"], args["n"], args["iters"], idx)
        return "int8_mismatches", int(np.count_nonzero(got.astype(np.int64) != want))
    if kind == "stream":
        return "stream_mismatches", int(np.count_nonzero(got != ref.stream_expected(args["iters"])))
    if kind == "dma":
        want = ref.dma_expected(args["rows"], args["cols"], idx, device)
        return "dma_mismatches", int(np.count_nonzero(got != want))
    if kind == "memtest":
        want = ref.memtest_expected(args["pattern"], idx)
        return "memtest_mismatches", int(np.count_nonzero(got.astype(np.int32) != want))
    raise ValueError(f"no reference for output kind {kind!r}")


def _worst(gap: np.ndarray) -> float:
    """The largest gap; a non-finite one (NaN included) reads as infinite."""
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")
