"""Benchmark of the PyTorch/CUDA probe (``tpu_node_checker_torch``) on the cards a cell names.

Run from the root of a checkout::

    python3 probebench/run.py --workload emitter-compute --seed 7 --seconds 50 --trace 0

It prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and the
compared numbers under ``checks``), and the compared numbers beside their
limits as the last lines of standard error.  Without the card the cell needs
it exits 2 and prints no result.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from probebench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
