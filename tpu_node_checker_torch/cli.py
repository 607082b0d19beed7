"""Command line of the PyTorch/CUDA probe.

::

    python -m tpu_node_checker_torch --emit-probe FILE|- \
        [--probe-level {enumerate,compute,collective,mesh,workload}]
        [--probe-timeout S] [--device cpu]

Exit codes: 0 when the report is healthy, 3 when it is not, 1 on an error
that left no report, 2 on a usage error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from tpu_node_checker_torch.probe.levels import LEVELS

EXIT_ERROR = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_node_checker_torch",
        description="Probe this host's NVIDIA card(s) and write one probe report.",
    )
    p.add_argument("--emit-probe", metavar="FILE", required=True,
                   help="write the probe report to FILE atomically ('-' for stdout)")
    p.add_argument("--probe-level", choices=LEVELS, default="enumerate",
                   help="enumerate, compute, collective, mesh or workload (each "
                   "includes the previous); collective and up run one rank per card")
    p.add_argument("--probe-timeout", type=float, default=None, metavar="S",
                   help="kill the probe child after S seconds (default: the level's budget)")
    p.add_argument("--device", default="cuda:0",
                   help="device to probe: cuda:0 (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_node_checker_torch.emit import emit_probe_once

    try:
        rc, _ = emit_probe_once(
            args.emit_probe, level=args.probe_level,
            timeout_s=args.probe_timeout, device=args.device,
        )
    except (OSError, ValueError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return EXIT_ERROR
    return rc


def entrypoint() -> None:
    sys.exit(main())
