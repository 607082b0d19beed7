"""``--emit-probe``: probe this host once and write the report atomically.

The report is the probe child's, plus the envelope the fleet checker grades
it by: ``schema`` (the contract's major version) and ``written_at`` (its
staleness anchor), as the JAX package's emitter writes it.  The JAX fleet
checker reads such files through ``--probe-results DIR``; that is the only
way the two packages meet.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Tuple

from tpu_node_checker_torch.probe.liveness import run_local_probe
from tpu_node_checker_torch.probe.schema import strict_mode, validate_report

REPORT_SCHEMA_VERSION = 1
EXIT_OK = 0
EXIT_NONE_READY = 3


def emit_probe_once(
    target: str,
    level: str = "enumerate",
    timeout_s: Optional[float] = None,
    device: str = "cuda:0",
) -> Tuple[int, dict]:
    """One probe and one atomic report write (``-`` writes to stdout).

    Returns ``(exit_code, report)``: 0 when the host is healthy, 3 otherwise.
    A report that violates the declared schema warns on stderr, or raises
    under ``TNC_SCHEMA_STRICT``.
    """
    probed = run_local_probe(level=level, timeout_s=timeout_s, device=device)
    doc = probed.to_dict()
    doc["schema"] = REPORT_SCHEMA_VERSION
    doc["written_at"] = time.time()
    violations = validate_report(doc)
    if violations:
        msg = "probe report violates its declared schema: " + "; ".join(violations[:5])
        if strict_mode():
            raise ValueError(msg)
        print(f"WARNING: {msg}", file=sys.stderr)
    payload = json.dumps(doc, ensure_ascii=False, indent=2)
    if target == "-":
        print(payload)
    else:
        tmp = f"{target}.tmp"
        with open(tmp, "w") as f:
            f.write(payload + "\n")
        os.replace(tmp, target)
        print(f"Probe report written to {target} (ok={probed.ok}).", file=sys.stderr)
    return (EXIT_OK if probed.ok else EXIT_NONE_READY), doc
