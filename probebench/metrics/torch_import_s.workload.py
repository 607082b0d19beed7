"""torch_import_s.workload: seconds of the probe child's ``import torch`` a
workload round.

Read as ``torch_import_s.emitter`` reads it, one formula in that file, over
the window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("torch_import_s.emitter")
