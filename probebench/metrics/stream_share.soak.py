"""stream_share.soak: % of the soak's round time spent in the stream leg.

The program's ``soak.stream`` spans' total over its ``soak.round`` spans'
total, host time: the 128 MiB stream's allocation, graph capture and
replays, against whole rounds.  The benchmark hook's own seconds are taken
out of both: its output samples (``hook_s``; all but the compute stage's
few fall in the streams) and its profiler's start (``trace_start_cost_s``,
in a round's burn).
"""

from probebench import spans


def read(run):
    if run.traffic["window"] != "soak" or not run.rounds:
        return None
    r = run.rounds[0]
    stream, whole = spans.row(r, "soak.stream"), spans.row(r, "soak.round")
    if stream is None or whole is None:
        return None
    cap = r["capture"] or {}
    hook_ms = 1e3 * (cap.get("hook_s") or 0.0)
    start_ms = 1e3 * (cap.get("trace_start_cost_s") or 0.0)
    denominator = whole[1] - hook_ms - start_ms
    if denominator <= 0:
        return None
    return 100.0 * max(0.0, stream[1] - hook_ms) / denominator
