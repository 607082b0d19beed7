"""graph_launch_ms.soak: host milliseconds in one launch of the burn chain's graph.

The program's ``graph.launch.burn`` spans (the host's time inside
``graph.replay()``), total over count: the soak's 1024-product replays and
the compute stage's few 64-product ones.
"""

from probebench import spans


def read(run):
    if run.traffic["window"] != "soak" or not run.rounds:
        return None
    found = spans.row(run.rounds[0], "graph.launch.burn")
    if found is None or found[0] <= 0:
        return None
    return found[1] / found[0]
