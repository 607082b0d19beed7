"""child_exit_s.workload: seconds from the child's report to the child reaped,
a workload round.

Read as ``child_exit_s.emitter`` reads it, one formula in that file, over
the window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("child_exit_s.emitter")
