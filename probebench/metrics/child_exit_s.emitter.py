"""child_exit_s.emitter: seconds from the child's report to the child reaped.

The program's ``probe.child_exit`` span (serialising and printing the
report, the exit handlers, the CUDA context's teardown, the pipe), less the
benchmark hook's exit-time work inside it (``write_s``); the mean over the
window's rounds.
"""

from probebench import spans


def read(run):
    return spans.mean_round_s(run, "probe.child_exit",
                              lambda r: (r["capture"] or {}).get("write_s") or 0.0)
