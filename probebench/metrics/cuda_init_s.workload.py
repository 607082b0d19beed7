"""cuda_init_s.workload: seconds of CUDA's start in the probe child a workload
round.

Read as ``cuda_init_s.emitter`` reads it, one formula in that file, over the
window's rounds of the four-card workload cell.
"""

from probebench.core import load_reader

read = load_reader("cuda_init_s.emitter")
