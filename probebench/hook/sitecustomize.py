"""The benchmark's start-up hook in the probe child.

``probebench/run.py`` puts this directory on the probe child's ``PYTHONPATH``
(the child keeps what its parent had and prepends the package root), so
Python loads this file as ``sitecustomize`` when the child starts.  It edits
no file of the program.  Without ``PROBEBENCH_CAPTURE`` in the environment it
does nothing but hand over to the next ``sitecustomize`` on the path.

With it, once the child imports ``tpu_node_checker_torch.ops``, the hook
wraps the probes the child calls and the internal functions whose results
the probes check, and records:

* what the timed path produced: every burn-chain checksum, every
  tensor-core invariant, and a sample (indices drawn from
  ``PROBEBENCH_SEED``) of each probe's output tensor, for the reference to
  judge once the window has closed;
* host times: the child's start-up up to its first probe (from the
  process's start, read from ``/proc``), its ``import torch`` within that,
  and the soak's rounds and window;
* the card's peak memory at exit (``torch.cuda.max_memory_allocated``);
* with ``PROBEBENCH_TRACE`` a ``torch.profiler`` device trace: ``rounds``
  from the first probe to exit, or ``soak:<from>:<count>`` over that many
  soak rounds.

Everything goes to ``$PROBEBENCH_CAPTURE.json``, ``.npz`` and
``.trace.json`` at the child's exit.  The next ``sitecustomize`` on the path
runs first, so whatever it patches lies underneath the hook's wrappers.
"""

import atexit
import contextlib
import importlib.abc
import importlib.machinery
import importlib.util
import inspect
import json
import os
import sys
import time

OPS = "tpu_node_checker_torch.ops"


def _chain_next_sitecustomize() -> None:
    """Run the next ``sitecustomize`` on ``sys.path``, which this file shadows."""
    here = os.path.dirname(os.path.abspath(__file__))
    for entry in sys.path:
        path = os.path.join(entry or os.getcwd(), "sitecustomize.py")
        if os.path.dirname(os.path.abspath(path)) == here or not os.path.isfile(path):
            continue
        spec = importlib.util.spec_from_file_location("_probebench_next_sitecustomize", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return


class _Tap:
    """``fn`` with ``after(result, args, kwargs)`` called on each result.

    Attribute reads and writes go to ``fn``, so a kernel wrapper's launch
    counter (``fn.launches += 1`` inside its own body) keeps counting.
    """

    def __init__(self, fn, after):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_after", after)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        res = self._after(out, args, kwargs)
        return out if res is None else res

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class Capture:
    """What one probe child's round produced, and when."""

    def __init__(self, prefix: str, seed: int, samples: int, soak_samples: int, trace: str):
        from probebench.clock import process_age_s

        self.prefix = prefix
        self.seed = seed
        self.samples = samples
        self.soak_samples = soak_samples
        self.trace = trace
        self.t0 = time.perf_counter()
        self.meta = {
            "hook_age_s": process_age_s(),
            "first_probe_s": None,
            "torch_import_s": None,
            "outputs": [],
            "chain": [],
            "invariant": [],
            "soak": None,
            "memory_peak_bytes": None,
            "hook_s": 0.0,
        }
        self.arrays = {}
        self.indices = {}
        self.stash = {}
        self.in_soak = False
        self.soak_round = 0
        self.profiler = None
        self.torch = None

    def now(self) -> float:
        return time.perf_counter() - self.t0

    # -- profiler ------------------------------------------------------
    def start_profiler(self) -> None:
        t = time.perf_counter()
        from torch.profiler import ProfilerActivity, profile

        self.profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profiler.__enter__()
        self.meta["trace_start_cost_s"] = time.perf_counter() - t

    def prime_profiler(self) -> None:
        """Start and stop a profiler once, outside the traced slice: the first
        start in a process sets up the device tracer, which takes seconds."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            pass

    def stop_profiler(self) -> None:
        if self.profiler is None or self.meta.get("trace_stopped_s") is not None:
            return
        if self.torch.cuda.is_initialized():
            self.torch.cuda.synchronize()
        self.meta["trace_stopped_s"] = self.now()
        self.profiler.__exit__(None, None, None)

    def annotate(self, name: str):
        """A ``probebench:<name>`` range in the trace while one is recorded."""
        if self.profiler is not None and self.meta.get("trace_stopped_s") is None:
            return self.torch.profiler.record_function(f"probebench:{name}")
        return contextlib.nullcontext()

    # -- outputs -------------------------------------------------------
    def sample(self, kind: str, tensor, args: dict) -> None:
        """Record a seeded sample of ``tensor``'s elements (all if few)."""
        t = time.perf_counter()
        import numpy as np

        torch = self.torch
        flat = tensor.detach().reshape(-1)
        n = flat.numel()
        k = self.soak_samples if self.in_soak else self.samples
        key = f"o{len(self.meta['outputs'])}"
        draw = (n, k, str(flat.device))
        if draw not in self.indices:
            # One draw for each size: every soak round's stream reuses it.
            if n <= k:
                idx = np.arange(n, dtype=np.int64)
            else:
                rng = np.random.default_rng([self.seed, n, k])
                idx = rng.integers(0, n, size=k, dtype=np.int64)
            name = f"i{len(self.indices)}"
            self.arrays[name] = idx
            self.indices[draw] = (name, torch.from_numpy(idx).to(flat.device))
        idx_name, idx_t = self.indices[draw]
        vals = flat[idx_t]
        if vals.dtype in (torch.bfloat16, torch.float16):
            vals = vals.float()
        self.arrays[f"{key}_val"] = vals.cpu().numpy()
        self.meta["outputs"].append({
            "kind": kind, "key": key, "idx": idx_name, "args": args, "soak": self.in_soak,
            "round": self.soak_round,
        })
        self.meta["hook_s"] += time.perf_counter() - t

    def take(self, name: str):
        return self.stash.pop(name, None)

    # -- exit ----------------------------------------------------------
    def write(self) -> None:
        t = time.perf_counter()
        self.meta["exit_s"] = self.now()
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
            self.meta["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        if self.profiler is not None:
            self.stop_profiler()
            self.profiler.export_chrome_trace(f"{self.prefix}.trace.json")
        if self.arrays:
            import numpy as np

            np.savez(f"{self.prefix}.npz", **self.arrays)
        self.meta["write_s"] = time.perf_counter() - t
        tmp = f"{self.prefix}.json.tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, f"{self.prefix}.json")


def _bound(fn, args, kwargs) -> dict:
    """The call's arguments by name, defaults filled in, less the device."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return {k: v for k, v in bound.arguments.items()
            if k != "device" and isinstance(v, (int, float, str))}


def install(cap: Capture, ops) -> None:
    """Wrap the probes of the imported ``ops`` package."""
    import torch

    cap.torch = torch
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

    hbm._stream_n = _Tap(hbm._stream_n, stash_as("stream"))
    int8._int8_chain = _Tap(int8._int8_chain, stash_as("int8"))
    tiled.timed_run = _Tap(tiled.timed_run, stash_as("tiled"))
    flash.timed_run = _Tap(flash.timed_run, stash_as("flash"))
    dma.dma_stream = _Tap(dma.dma_stream, stash_as("dma"))

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
            bound = _bound(orig, args, kwargs)
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


class _OnImport(importlib.abc.MetaPathFinder):
    """Calls ``before()`` and ``after(module)`` around the first import of
    the module ``name``."""

    def __init__(self, name: str, before, after):
        self.name, self.before, self.after = name, before, after

    def find_spec(self, name, path, target=None):
        if name != self.name:
            return None
        sys.meta_path.remove(self)
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        if spec is None or spec.loader is None:
            return spec
        exec_module = spec.loader.exec_module

        def exec_between(module):
            self.before()
            exec_module(module)
            self.after(module)

        spec.loader.exec_module = exec_between
        return spec


def _activate() -> None:
    prefix = os.environ.pop("PROBEBENCH_CAPTURE", None)
    _chain_next_sitecustomize()
    if not prefix:
        return
    cap = Capture(
        prefix,
        seed=int(os.environ.get("PROBEBENCH_SEED") or 0) % 2**64,
        samples=int(os.environ.get("PROBEBENCH_SAMPLES") or 16384),
        soak_samples=int(os.environ.get("PROBEBENCH_SOAK_SAMPLES") or 4096),
        trace=os.environ.get("PROBEBENCH_TRACE") or "",
    )
    atexit.register(cap.write)
    if "torch" not in sys.modules:
        # From the process's start: [when ``import torch`` began, when it ended].
        span = []
        sys.meta_path.insert(0, _OnImport(
            "torch", lambda: span.append(cap.meta["hook_age_s"] + cap.now()),
            lambda _: cap.meta.update(torch_import_s=span + [cap.meta["hook_age_s"] + cap.now()])))
    if OPS in sys.modules:
        install(cap, sys.modules[OPS])
    else:
        sys.meta_path.insert(0, _OnImport(OPS, lambda: None, lambda module: install(cap, module)))


_activate()
