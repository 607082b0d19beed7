"""setup_s: from the benchmark process's start to the window's start.

For back-to-back rounds that is the harness's start and the warm-up round;
for the soak, the harness's start and the probe child up to its first soak
round (start-up, the kernels' build or load, the compute probes).
"""


def read(run):
    soak = run.soak
    start = soak["start_wall"] if soak is not None else run.window_start_wall
    return start - run.process_start_wall
