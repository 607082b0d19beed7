"""round_s.workload: seconds per workload round, the window's rounds back to
back, less the hook's own seconds (the child's, and the most one spawned
rank spent).

Read as ``round_s.emitter`` reads it, one formula in that file, over the
window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("round_s.emitter")
