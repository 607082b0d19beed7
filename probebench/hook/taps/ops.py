"""Tap: the compute probes of ``tpu_node_checker_torch.ops``.

Wraps the probes the child calls (``ops.<name>``, and the same names in
their modules) and the internal functions whose results the probes check:
each probe's output is sampled after it returns (kinds ``stream``,
``int8``, ``tiled``, ``flash``, ``dma``, ``memtest``), every burn-chain run
and tensor-core invariant recorded, the soak's rounds timed, and, in a
traced round, the profiler started at the first probe.
"""

import sys
import time

MODULE = OPS = "tpu_node_checker_torch.ops"


def install(cap, ops) -> None:
    """Wrap the probes of the imported ``ops`` package."""
    burn = sys.modules[f"{OPS}.burn"]
    hbm = sys.modules[f"{OPS}.hbm"]
    int8 = sys.modules[f"{OPS}.int8_probe"]
    tiled = sys.modules[f"{OPS}.pallas_probe"]
    flash = sys.modules[f"{OPS}.flash_attention"]
    dma = sys.modules[f"{OPS}.dma_probe"]
    memtest = sys.modules[f"{OPS}.memtest"]

    # The outputs, stashed where they are produced (graph outputs are the
    # graph's own tensors: the last replay's values stay readable).
    def stash_as(name):
        def after(out, args, kwargs):
            cap.stash[name] = out[0] if isinstance(out, tuple) else out
        return after

    hbm._stream_n = cap.tap(hbm._stream_n, stash_as("stream"))
    int8._int8_chain = cap.tap(int8._int8_chain, stash_as("int8"))
    tiled.timed_run = cap.tap(tiled.timed_run, stash_as("tiled"))
    flash.timed_run = cap.tap(flash.timed_run, stash_as("flash"))
    dma.dma_stream = cap.tap(dma.dma_stream, stash_as("dma"))

    def verify_tap(orig):
        def verify(name, x):
            cap.sample("memtest", x, {"pattern": name, **cap.stash.get("memtest_args", {})})
            return orig(name, x)
        return verify

    memtest._verify = verify_tap(memtest._verify)

    def chain_runner_tap(orig):
        def chain_runner(a, iters):
            run = orig(a, iters)
            n = int(a.shape[0])

            def timed():
                checksum, seconds = run()
                cap.meta["chain"].append({
                    "n": n, "iters": int(iters), "checksum": checksum, "seconds": seconds,
                    "soak": cap.in_soak, "round": cap.soak_round,
                })
                return checksum, seconds
            return timed
        return chain_runner

    burn._chain_runner = chain_runner_tap(burn._chain_runner)

    def invariant_tap(orig):
        def invariant(a):
            tc, elementwise = orig(a)
            cap.meta["invariant"].append({
                "n": int(a.shape[0]), "trace": float(tc.item()),
                "sumsq": float(elementwise.item()), "soak": cap.in_soak,
                "round": cap.soak_round,
            })
            return tc, elementwise
        return invariant

    burn._invariant = invariant_tap(burn._invariant)

    def burn_round_tap(orig):
        def burn_round(a, run, iters, rel_tol):
            if not cap.in_soak:
                return orig(a, run, iters, rel_tol)
            cap.soak_round += 1
            soak = cap.meta["soak"]
            if cap.soak_round == 1:
                soak.update(start_s=cap.now(), start_wall=time.time(),
                            n=int(a.shape[0]), iters=int(iters), round_starts_s=[])
            soak["round_starts_s"].append(cap.now())
            spec = cap.trace.split(":")
            if spec[0] == "soak":
                first, count = int(spec[1]), int(spec[2])
                if cap.soak_round == first:
                    cap.start_profiler()
                elif cap.soak_round == first + count:
                    cap.stop_profiler()
            with cap.annotate("soak_burn_round"):
                return orig(a, run, iters, rel_tol)
        return burn_round

    burn._burn_round = burn_round_tap(burn._burn_round)

    # The probes the child calls (``ops.<name>``), and the same names in
    # their modules, where the soak finds the stream.
    sampled = {"hbm_bandwidth_probe": "stream", "int8_matmul_probe": "int8",
               "pallas_matmul_probe": "tiled", "flash_attention_probe": "flash",
               "dma_stream_probe": "dma"}

    def after_probe(name, args):
        out = cap.take(sampled[name]) if name in sampled else None
        if out is not None:
            cap.sample(sampled[name], out, args)
        cap.stash.pop("memtest_args", None)

    def probe_wrapper(name, orig):
        def probe(*args, **kwargs):
            if cap.meta["first_probe_s"] is None:
                cap.meta["first_probe_s"] = cap.now()
                if cap.trace == "rounds":
                    cap.start_profiler()
                elif cap.trace.startswith("soak:"):
                    cap.prime_profiler()
            bound = cap.bound(orig, args, kwargs)
            if name == "hbm_pattern_probe":
                cap.stash["memtest_args"] = bound
            if name == "soak_burn":
                cap.in_soak = True
                cap.meta["soak"] = {"args": bound}
            try:
                with cap.annotate("soak_stream" if cap.in_soak and name != "soak_burn" else name):
                    result = orig(*args, **kwargs)
            finally:
                if name == "soak_burn":
                    cap.in_soak = False
                    cap.stop_profiler()
                    cap.meta["soak"].update(end_s=cap.now(), rounds=cap.soak_round)
            after_probe(name, bound)
            return result
        return probe

    homes = {
        "matmul_burn": burn, "soak_burn": burn, "hbm_bandwidth_probe": hbm,
        "pallas_matmul_probe": tiled, "int8_matmul_probe": int8,
        "flash_attention_probe": flash, "dma_stream_probe": dma,
        "hbm_pattern_probe": memtest,
    }
    for name, module in homes.items():
        wrapped = probe_wrapper(name, getattr(ops, name))
        setattr(ops, name, wrapped)
        setattr(module, name, wrapped)
