"""``--calibrate N``: measure this host's healthy perf expectations.

The built-in floor table describes TPUs only, so on an H100 ``--perf-floor``
grades nothing until ``TNC_PERF_EXPECT`` names the expected figures.  This
mode produces them from a known-good host, as the JAX checker's
``calibrate`` (``checker.py``) does::

    export TNC_PERF_EXPECT="$(python -m tpu_node_checker_torch \\
        --calibrate 5 --probe-level compute)"
    python -m tpu_node_checker_torch --emit-probe - --probe-level compute \\
        --perf-floor 0.4

Calibrating on a sick host would bless its sickness as "expected", so any
failed rep aborts with exit 3 and no JSON.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

from tpu_node_checker_torch.probe.floors import (
    DEFAULT_CALIBRATION_MARGIN,
    calibrate_expectations,
)
from tpu_node_checker_torch.probe.liveness import run_local_probe

EXIT_OK = 0
EXIT_NONE_READY = 3


def calibrate(
    reps: int,
    margin: float = DEFAULT_CALIBRATION_MARGIN,
    out: Optional[str] = None,
    level: str = "compute",
    timeout_s: Optional[float] = None,
    topology: Optional[str] = None,
    soak_s: float = 0.0,
    device: str = "cuda:0",
) -> int:
    """Run the probe ``reps`` times at ``level``, print each rep's
    one-sample projection on stderr, and write ``margin`` × the per-metric
    median as ``TNC_PERF_EXPECT`` JSON to stdout (or atomically to ``out``).
    Returns 0, or 3 when a rep failed or no metric was measured."""
    samples = []
    for i in range(reps):
        r = run_local_probe(
            level=level, timeout_s=timeout_s, topology=topology, soak_s=soak_s,
            # Floors are what is being calibrated for; grading a rep (against
            # an earlier TNC_PERF_EXPECT) would reject the very host at hand.
            perf_floor=0, device=device,
        )
        if not r.ok:
            print(
                f"calibration rep {i + 1}/{reps} FAILED: {r.error} — "
                "refusing to calibrate on an unhealthy host",
                file=sys.stderr,
            )
            return EXIT_NONE_READY
        doc = r.to_dict()
        samples.append(doc)
        # One-sample calibration at margin 1.0 is exactly what the median
        # will consume (the soak's sustained figure included), so no figure
        # is calibrated without having been shown.
        shown = calibrate_expectations([doc], margin=1.0)
        print(f"rep {i + 1}/{reps}: {shown}", file=sys.stderr)
    expect = calibrate_expectations(samples, margin=margin)
    if not expect:
        print(
            "calibration produced no graded metrics (did the level measure "
            "any perf figures?)",
            file=sys.stderr,
        )
        return EXIT_NONE_READY
    payload = json.dumps(expect, ensure_ascii=False)
    if not out or out == "-":
        print(payload)
    else:
        tmp = f"{out}.tmp"
        with open(tmp, "w") as f:
            f.write(payload + "\n")
        os.replace(tmp, out)
    print(
        f"Calibrated {len(expect)} metric(s) over {reps} rep(s) "
        f"(margin {margin}): set TNC_PERF_EXPECT to grade "
        "perf floors on this transport/hardware.",
        file=sys.stderr,
    )
    return EXIT_OK
