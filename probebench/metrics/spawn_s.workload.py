"""spawn_s.workload: seconds from the parent's spawn to the child's first
statement, a workload round.

Read as ``spawn_s.emitter`` reads it, one formula in that file, over the
window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("spawn_s.emitter")
