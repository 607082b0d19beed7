"""child_import_s.workload: the probe child's start-up seconds a workload
round.

Read as ``child_import_s.emitter`` reads it, one formula in that file, over
the window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("child_import_s.emitter")
