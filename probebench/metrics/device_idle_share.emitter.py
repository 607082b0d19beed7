"""device_idle_share.emitter: % of the traced rounds' wall with card 0 idle.

Busy time is the union of every kernel, copy and fill in each round's device
trace (taken in the probe child from its first probe to its exit); the wall
is the rounds' own, less the benchmark hook's seconds.
"""


def read(run):
    if run.traffic["window"] != "rounds":
        return None
    window = run.device_window()
    if window is None or window[1] <= 0:
        return None
    busy, wall = window
    return 100.0 * (1.0 - busy / wall)
