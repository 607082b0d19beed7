"""kernel_build_s.workload: seconds of the child's kernel build check a
workload round.

Read as ``kernel_build_s.emitter`` reads it, one formula in that file, over
the window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("kernel_build_s.emitter")
