"""soak_tflops: the soak's bf16 products over its whole wall time.

The products are those the benchmark's hook in the probe child saw run
inside the soak: every run of the burn chain (``iters`` products of 2 n^3
operations each) and every tensor-core invariant (one such product).  The
seconds run from the first soak round's start to the soak's return, on the
host clock, as the hook reads them: host gaps, the streams and the checks
count as time.
"""


def read(run):
    soak = run.soak
    if soak is None:
        return None
    cap = run.rounds[0]["capture"]
    ops = sum(2.0 * c["n"] ** 3 * c["iters"] for c in cap["chain"] if c["soak"])
    ops += sum(2.0 * c["n"] ** 3 for c in cap["invariant"] if c["soak"])
    return ops / (soak["end_s"] - soak["start_s"]) / 1e12
