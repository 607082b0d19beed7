"""kernel_build_s.emitter: seconds of the child's kernel build check a round.

The program's ``child.kernel_build`` span (``ops/_build.py`` ``build_all``:
each library looked up by the hash of its sources, nvcc only where one is
missing), the mean over the window's rounds.
"""

from probebench import spans


def read(run):
    return spans.mean_round_s(run, "child.kernel_build")
