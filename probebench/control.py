"""The control of the comparison that decides ``correct``.

Runs a cell's real rounds (a short window), then judges two sets of
outputs with the cell's limits: the program's, and the control's, which is
the plain reference put in the program's place and computed one precision
below the configuration's: fp8 operands for the bf16 products (the burn
chain and its invariant here; each other kind's ``control`` in
``reference/<kind>.py``: the tiled matmul, flash attention, the burn-in
training step), bf16 for the float32 DMA stream.  A kind whose reference
gives no ``control`` is exact (int8, whose inputs in [-8, 8) int4 holds
exactly; the HBM stream's small integers; the memtest's bit patterns) and
is its own control.  The control has to come out not correct.

    python3 probebench/control.py --workload emitter-compute --seconds 2 --seed 11 12 13

Prints one JSON line a seed: the program's numbers and the control's.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from probebench import judge  # noqa: E402
from probebench.core import run_cell  # noqa: E402
from probebench.reference import probes as ref  # noqa: E402

LOWER = "fp8"  # the burn chain's and its invariant's


def _controlled(capture, arrays: dict, device, chains: dict, invariants: dict) -> tuple:
    """A copy of one capture with every answer replaced by the control's."""
    if capture is None:
        return capture, arrays
    meta, arrays = copy.deepcopy(capture), dict(arrays)
    for c in meta["chain"]:
        key = (c["n"], c["iters"])
        if key not in chains:
            chains[key] = ref.burn_chain(c["n"], c["iters"], device, LOWER)[0]
        c["checksum"] = chains[key]
    for c in meta["invariant"]:
        if c["n"] not in invariants:
            invariants[c["n"]] = ref.burn_invariant(c["n"], device, LOWER)
        c["trace"] = c["sumsq"] = invariants[c["n"]]
    for o in meta["outputs"]:
        lower = getattr(judge.reference_of(o["kind"]), "control", None)
        if lower is not None:
            key = f"{o['key']}_val"
            arrays[key] = lower(o["args"], arrays[o["idx"]], arrays[key], device)
    return meta, arrays


def control_rounds(rounds: list, device) -> list:
    """``rounds`` with every captured answer, the spawned ranks' included,
    replaced by the control's."""
    out = []
    chains, invariants = {}, {}
    for r in rounds:
        r = dict(r)
        r["capture"], r["arrays"] = _controlled(r["capture"], r["arrays"], device, chains,
                                                invariants)
        ranks = []
        for k in r.get("ranks") or []:
            k = dict(k)
            k["capture"], k["arrays"] = _controlled(k["capture"], k["arrays"], device, chains,
                                                    invariants)
            ranks.append(k)
        r["ranks"] = ranks
        out.append(r)
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="probebench/control.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seed:
        out = run_cell(args.workload, seed, args.seconds, False, device)
        if isinstance(out, int):
            return out
        run = out["run"]
        controlled = judge.judge(control_rounds(run.warm + run.rounds, out["device_name"]),
                                 run.traffic, run.cell["limits"], out["device_name"])
        print(json.dumps({
            "workload": args.workload, "seed": seed, "card": out["card"],
            "program": {c["name"]: c["value"] for c in out["checks"]},
            "program_correct": all(c["ok"] for c in out["checks"]),
            "control": {c["name"]: c["value"] for c in controlled},
            "control_correct": all(c["ok"] for c in controlled),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
