"""device_idle_share.soak: % of the traced soak rounds with card 0 idle.

The traced slice runs from the first traced soak round's start to the last
one's stream's end; busy time is the union of every kernel, copy and fill
in it.
"""


def read(run):
    if run.traffic["window"] != "soak":
        return None
    window = run.device_window()
    if window is None or window[1] <= 0:
        return None
    busy, span = window
    return 100.0 * (1.0 - busy / span)
