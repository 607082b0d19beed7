"""The benchmark's start-up hook in the probe child and the ranks it spawns.

``probebench/run.py`` puts this directory on the probe child's ``PYTHONPATH``
(the child keeps what its parent had and prepends the package root), so
Python loads this file as ``sitecustomize`` when the child starts, and
again in each rank the child spawns, which inherits its environment.  It
edits no file of the program.  Without ``PROBEBENCH_CAPTURE`` (the probe
child) or ``PROBEBENCH_RANK_CAPTURE`` (a process the child started) in the
environment it does nothing but hand over to the next ``sitecustomize`` on
the path.

With either, it loads every tap in ``taps/``: a file that names the module
it patches (``MODULE``) and gives ``install(cap, module)``, which runs once
that module is first imported (at once if it already is).  The taps wrap
the functions whose results the reference judges, and record:

* what the timed path produced: every burn-chain checksum, every
  tensor-core invariant, a sample (indices drawn from ``PROBEBENCH_SEED``)
  of each probe's output tensor, and each tap's own outputs with the inputs
  their reference starts from, for the reference to judge once the window
  has closed;
* host times: the child's start-up up to its first probe (from the
  process's start, read from ``/proc``), its ``import torch`` within that,
  the soak's rounds and window, the rank group's start and each process's
  first command;
* the card's peak memory at exit (``torch.cuda.max_memory_allocated``);
* with ``PROBEBENCH_TRACE`` a ``torch.profiler`` device trace: ``rounds``
  from the first probe (in a spawned rank, from its start) to exit, or
  ``soak:<from>:<count>`` over that many soak rounds.

Everything goes to ``$PROBEBENCH_CAPTURE.json``, ``.npz`` and
``.trace.json`` at the child's exit, and to ``<that>.rank<k>.json``,
``.npz`` and ``.trace.json`` at the exit of the spawned rank ``k`` (the
child hands its prefix on as ``PROBEBENCH_RANK_CAPTURE``; a rank takes its
number where the rank's entry is called).  The next ``sitecustomize`` on
the path runs first, so whatever it patches lies underneath the hook's
wrappers.
"""

import atexit
import contextlib
import functools
import importlib.abc
import importlib.machinery
import importlib.util
import inspect
import json
import os
import sys
import time

TAPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "taps")


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
    """What one probe child's round, or one rank it spawned, produced, and when.

    A spawned rank's capture starts without a prefix (``rank_base`` holds
    the child's): :meth:`open_rank` gives it one, and a capture that never
    gets one writes nothing.
    """

    def __init__(self, prefix, seed: int, samples: int, soak_samples: int, trace: str,
                 rank_base=None):
        from probebench.clock import process_age_s

        self.prefix = prefix
        self.rank_base = rank_base
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

    @property
    def torch(self):
        return sys.modules.get("torch")

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def open_rank(self, local_rank: int) -> None:
        """Give a spawned rank's capture its prefix, ``<child's>.rank<k>``."""
        self.prefix = f"{self.rank_base}.rank{local_rank}"
        self.meta.update(rank=local_rank, rank_main_wall=time.time())

    # -- helpers for the taps ------------------------------------------
    @staticmethod
    def tap(fn, after):
        """``fn`` with ``after(result, args, kwargs)`` called on each result
        (its return, where not None, replacing the result)."""
        return _Tap(fn, after)

    @staticmethod
    def bound(fn, args, kwargs) -> dict:
        """The call's scalar arguments by name, defaults filled in, less the device."""
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        return {k: v for k, v in bound.arguments.items()
                if k != "device" and isinstance(v, (int, float, str))}

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

    def record(self, kind: str, inputs, values, args: dict, idx=None) -> str:
        """Record an output whole (``values``) with the inputs its reference
        starts from (``inputs``, stored as the entry's ``idx``; or ``idx``,
        the name another output's inputs are stored under); returns the
        name of the inputs."""
        t = time.perf_counter()
        import numpy as np

        key = f"o{len(self.meta['outputs'])}"
        if idx is None:
            idx = f"{key}_in"
            self.arrays[idx] = np.asarray(inputs)
        self.arrays[f"{key}_val"] = np.asarray(values)
        self.meta["outputs"].append({
            "kind": kind, "key": key, "idx": idx, "args": args, "soak": self.in_soak,
            "round": self.soak_round,
        })
        self.meta["hook_s"] += time.perf_counter() - t
        return idx

    def take(self, name: str):
        return self.stash.pop(name, None)

    # -- exit ----------------------------------------------------------
    def write(self) -> None:
        if self.prefix is None:
            return
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


def _load_taps() -> list:
    """Every ``taps/<name>.py``, in name order."""
    taps = []
    for name in sorted(os.listdir(TAPS_DIR)):
        if not name.endswith(".py"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"_probebench_tap_{name[:-3].replace('.', '_')}", os.path.join(TAPS_DIR, name))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        taps.append(module)
    return taps


def _activate() -> None:
    prefix = os.environ.pop("PROBEBENCH_CAPTURE", None)
    rank_base = os.environ.pop("PROBEBENCH_RANK_CAPTURE", None)
    _chain_next_sitecustomize()
    if prefix:
        # The processes this child starts, its ranks among them, capture under it.
        os.environ["PROBEBENCH_RANK_CAPTURE"] = prefix
    elif not rank_base:
        return
    cap = Capture(
        prefix or None,
        seed=int(os.environ.get("PROBEBENCH_SEED") or 0) % 2**64,
        samples=int(os.environ.get("PROBEBENCH_SAMPLES") or 16384),
        soak_samples=int(os.environ.get("PROBEBENCH_SOAK_SAMPLES") or 4096),
        trace=os.environ.get("PROBEBENCH_TRACE") or "",
        rank_base=None if prefix else rank_base,
    )
    atexit.register(cap.write)
    if "torch" not in sys.modules:
        # From the process's start: [when ``import torch`` began, when it ended].
        span = []
        sys.meta_path.insert(0, _OnImport(
            "torch", lambda: span.append(cap.meta["hook_age_s"] + cap.now()),
            lambda _: cap.meta.update(torch_import_s=span + [cap.meta["hook_age_s"] + cap.now()])))
    for tap in _load_taps():
        if tap.MODULE in sys.modules:
            tap.install(cap, sys.modules[tap.MODULE])
        else:
            sys.meta_path.insert(0, _OnImport(
                tap.MODULE, lambda: None, functools.partial(tap.install, cap)))


_activate()
