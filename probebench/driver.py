"""The one general driver of probe rounds: what a traffic file describes.

The configuration (``configs/<name>.json``, the deployment) gives the
emitter's arguments: ``probe_level``, ``perf_floor`` and ``soak_s`` (the
soak's seconds, ``"window"`` for the run's ``--seconds``, or 0), and
``emit``, where it has one: an object of further keyword arguments of
``emit_probe_once``, under the function's own parameter names, passed on
every round, warm-up and window alike.  The configuration's ``args`` holds
the deployed flag of each ``emit`` entry.  Before the first round each
``emit`` name is held against the function's signature: a name it lacks,
or one that :func:`drive` sets itself (``ROUND_ARGS``), ends the run at once,
naming the key.  A configuration without ``emit`` calls the function with
the arguments of :func:`drive` alone.

A traffic file (``traffic/<name>.json``) gives how the rounds are sent:

* ``warmup_rounds``: rounds run before the window, counted as set-up;
* ``warmup_level``: the probe level of those rounds, where it is not the
  configuration's: a lower level that builds and loads all the window needs
  (the kernels, the bytecode) without what each round does anew;
* ``window``: ``"rounds"``, one client sending round after round until the
  window closes (a round that starts inside it runs to its end), or
  ``"soak"``, one round whose soak is the window;
* ``samples``, ``soak_stream_samples``: how many elements of each output the
  hook keeps for the reference;
* ``judged``, ``soak_judged``: the least of each output a round (a soak
  round) must yield; ``warmup_judged``, a warm-up round's, where it differs;
* ``trace``: what the hook traces in a ``--trace 1`` run's window rounds,
  ``"rounds"`` or ``"soak:<from>:<count>"``;
* ``trace_every_run``: trace the window's rounds in every run, not only with
  ``--trace 1``, for an end-to-end metric read from the device trace.

A round's capture is the probe child's, and one more for each rank the
child spawned (``<prefix>.rank<k>``), gathered in rank order.

Each round is one ``emit_probe_once`` call, the emitter's round as deployed:
the probe child, the schema check, the atomic write of the report.  After
each round the report file is read back (``read_back``), for the judge to
hold against what the round returned.
"""

from __future__ import annotations

import inspect
import json
import os
import time
from pathlib import Path
from typing import Callable, List

# The arguments of ``emit_probe_once`` that :func:`drive` gives each round.
ROUND_ARGS = ("target", "level", "soak_s", "perf_floor", "device")


def emit_kwargs(emit: Callable, config: dict) -> dict:
    """The configuration's ``emit`` arguments, each name checked against
    ``emit``'s signature; exits naming the first that it lacks or that
    :func:`drive` sets itself."""
    given = config.get("emit", {})
    where = f"probebench: configuration {config.get('name')!r}"
    if not isinstance(given, dict):
        raise SystemExit(f"{where}: emit is {type(given).__name__}, not an object of "
                         "keyword arguments")
    params = inspect.signature(emit).parameters
    for key in given:
        if key in ROUND_ARGS:
            raise SystemExit(f"{where}: emit key {key!r} is an argument each round "
                             "sets itself")
        if key not in params:
            raise SystemExit(f"{where}: emit key {key!r} is no parameter of "
                             f"{getattr(emit, '__qualname__', 'the emitter')}")
    return dict(given)


def drive(emit: Callable, config: dict, traffic: dict, seconds: float, trace: bool,
          device: str, scratch: Path) -> dict:
    """Run the warm-up rounds and the window; returns their rounds and clocks."""
    extra = emit_kwargs(emit, config)
    soak_s = seconds if config["soak_s"] == "window" else float(config["soak_s"])
    target = str(scratch / "report.json")
    counter = iter(range(10 ** 6))

    def one(traced: bool, level: str) -> dict:
        prefix = str(scratch / f"round-{next(counter):03d}")
        os.environ["PROBEBENCH_CAPTURE"] = prefix
        os.environ["PROBEBENCH_TRACE"] = traffic["trace"] if traced else ""
        before = file_id(target)
        start_wall, start = time.time(), time.perf_counter()
        try:
            rc, report = emit(target, level=level, soak_s=soak_s,
                              perf_floor=config["perf_floor"],
                              **({} if device is None else {"device": device}), **extra)
        finally:
            end = time.perf_counter()
            del os.environ["PROBEBENCH_CAPTURE"], os.environ["PROBEBENCH_TRACE"]
        return {"prefix": prefix, "end": end, "wall_s": end - start, "rc": rc, "report": report,
                "start_wall": start_wall, "written": read_back(target, before)}

    warm_level = traffic.get("warmup_level", config["probe_level"])
    warm = [dict(one(False, warm_level), warm=True) for _ in range(traffic["warmup_rounds"])]
    trace = trace or bool(traffic.get("trace_every_run"))
    t0, t0_wall = time.perf_counter(), time.time()
    window: List[dict] = []
    if traffic["window"] == "rounds":
        while not window or time.perf_counter() - t0 < seconds:
            window.append(one(trace, config["probe_level"]))
    elif traffic["window"] == "soak":
        window.append(one(trace, config["probe_level"]))
    else:
        raise ValueError(f"unknown window kind {traffic['window']!r}")
    for r in warm + window:
        r["capture"], r["arrays"] = read_capture(r["prefix"])
        r["ranks"] = []
        for k, prefix in rank_prefixes(r["prefix"]):
            meta, arrays = read_capture(prefix)
            r["ranks"].append({"rank": k, "prefix": prefix, "capture": meta, "arrays": arrays})
    return {"warm": warm, "rounds": window, "t0": t0, "t0_wall": t0_wall,
            "window_s": window[-1]["end"] - t0}


def file_id(path: str):
    """(device, inode) of ``path``, or None if there is no such file."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_dev, st.st_ino


def read_back(target: str, before) -> dict:
    """The report file as a round left it: its text parsed (None if absent or
    not JSON), whether it is a new file (an atomic replace makes one; a write
    in place keeps the old), and what else of its name lies beside it."""
    try:
        with open(target) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = None
    after = file_id(target)
    name = os.path.basename(target)
    beside = sorted(n for n in os.listdir(os.path.dirname(target))
                    if n.startswith(name) and n != name)
    return {"doc": doc, "new_file": after is not None and after != before, "beside": beside}


def rank_prefixes(prefix: str) -> list:
    """(k, prefix) of every spawned rank that wrote a capture, in rank order."""
    folder, name = os.path.split(prefix)
    found = []
    for n in os.listdir(folder or "."):
        head, dot, tail = n.partition(".rank")
        if head == name and dot and tail.endswith(".json") and tail[:-5].isdigit():
            found.append((int(tail[:-5]), os.path.join(folder, n[:-5])))
    return sorted(found)


def read_capture(prefix: str) -> tuple:
    """(the hook's JSON, its arrays) of one round; (None, {}) if it wrote none."""
    try:
        with open(f"{prefix}.json") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None, {}
    import numpy as np

    try:
        with np.load(f"{prefix}.npz") as z:
            arrays = {k: z[k] for k in z.files}
    except OSError:
        arrays = {}
    return meta, arrays
