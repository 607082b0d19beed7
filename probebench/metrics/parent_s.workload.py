"""parent_s.workload: the emitter and probe parent's seconds a workload round.

Read as ``parent_s.emitter`` reads it, one formula in that file, over the
window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("parent_s.emitter")
