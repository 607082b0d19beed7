"""spawn_s.emitter: seconds from the parent's spawn to the child's first statement.

The program's ``probe.spawn`` span (the parent's ``Popen``, the
interpreter's start and its site hooks, up to the child's first line),
the mean over the window's rounds.
"""

from probebench import spans


def read(run):
    return spans.mean_round_s(run, "probe.spawn")
