"""The control of the comparison that decides ``correct``.

Runs a cell's real rounds (a short window), then judges two sets of
outputs with the cell's limits: the program's, and the control's, which is
the plain reference put in the program's place and computed one precision
below the configuration's: fp8 operands for the bf16 products (the burn
chain, its invariant, the tiled matmul, flash attention), bf16 for the
float32 DMA stream.  The exact answers (int8, whose inputs in [-8, 8) int4
holds exactly; the HBM stream's small integers; the memtest's bit patterns)
are their own control.  The control has to come out not correct.

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

LOWER = {"tiled": "fp8", "flash": "fp8", "burn": "fp8", "dma": "bf16"}


def control_rounds(rounds: list, device) -> list:
    """``rounds`` with every captured answer replaced by the control's."""
    out = []
    chains, invariants = {}, {}
    for r in rounds:
        r = dict(r)
        meta, arrays = copy.deepcopy(r["capture"]), dict(r["arrays"])
        if meta is None:
            out.append(r)
            continue
        for c in meta["chain"]:
            key = (c["n"], c["iters"])
            if key not in chains:
                chains[key] = ref.burn_chain(c["n"], c["iters"], device, LOWER["burn"])[0]
            c["checksum"] = chains[key]
        for c in meta["invariant"]:
            if c["n"] not in invariants:
                invariants[c["n"]] = ref.burn_invariant(c["n"], device, LOWER["burn"])
            c["trace"] = c["sumsq"] = invariants[c["n"]]
        for o in meta["outputs"]:
            idx, a = arrays[o["idx"]], o["args"]
            if o["kind"] == "tiled":
                arrays[f"{o['key']}_val"] = ref.tiled_entries(a["m"], a["k"], a["n"], idx, device,
                                                              LOWER["tiled"])
            elif o["kind"] == "flash":
                arrays[f"{o['key']}_val"] = ref.causal_attention(
                    a["batch"], a["heads"], a["seq"], a["head_dim"], device, LOWER["flash"])[idx]
            elif o["kind"] == "dma":
                arrays[f"{o['key']}_val"] = ref.dma_expected(a["rows"], a["cols"], idx, device,
                                                             LOWER["dma"])
        r["capture"], r["arrays"] = meta, arrays
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
