"""One run of one cell: set-up, window, comparison, metrics, the result line.

``main`` is ``probebench/run.py``'s entry.  It finds the cell, its
configuration and its traffic by name, drives the emitter's rounds through
the real probe child (``driver.py``), judges what they produced against the
plain reference (``judge.py``), reads the cell's metrics with their readers
(``metrics/<name>.py``) and prints the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import List, Optional

from probebench import trace as tr
from probebench.clock import process_age_s

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
HOOK_DIR = HERE / "hook"
CACHE_DIR = ROOT / ".probebench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_node_checker")


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: dict, traffic: dict, trace: bool, process_start_wall: float,
                 driven: dict, device_kind: str):
        self.cell, self.traffic, self.trace = cell, traffic, trace
        self.process_start_wall = process_start_wall
        self.warm = driven["warm"]
        self.rounds = driven["rounds"]
        self.window_s = driven["window_s"]
        self.window_start_wall = driven["t0_wall"]
        self.device_kind = device_kind
        self._traces = {}

    @property
    def soak(self) -> Optional[dict]:
        """The soak of the window's round, as the hook timed it."""
        if self.traffic["window"] != "soak":
            return None
        cap = self.rounds[0]["capture"]
        soak = (cap or {}).get("soak") or {}
        return soak if soak.get("rounds") and "start_s" in soak else None

    def events(self, r: dict) -> Optional[List[dict]]:
        """The device trace of one traced round's probe child (or of one
        spawned rank, given its entry of ``r["ranks"]``), or None."""
        if r["prefix"] not in self._traces:
            path = f"{r['prefix']}.trace.json"
            self._traces[r["prefix"]] = tr.load(path) if os.path.exists(path) else None
        return self._traces[r["prefix"]]

    def processes(self, r: dict) -> List[dict]:
        """The round's probe child, then each rank it spawned, in rank order."""
        return [r] + list(r.get("ranks") or [])

    @staticmethod
    def hook_s(cap: Optional[dict]) -> float:
        """The hook's own seconds in one process: starting the profiler,
        sampling outputs, and everything it does at the process's exit."""
        cap = cap or {}
        return (cap.get("trace_start_cost_s") or 0.0) + (cap.get("hook_s") or 0.0) \
            + (cap.get("write_s") or 0.0)

    def overhead_s(self, r: dict) -> float:
        """The hook's own seconds inside a round: the probe child's, and the
        most that one spawned rank spent (the ranks run side by side)."""
        ranks = [self.hook_s(k["capture"]) for k in r.get("ranks") or []]
        return self.hook_s(r["capture"]) + max(ranks, default=0.0)

    def child_startup_s(self, r: dict) -> Optional[float]:
        """From the child's process start to its first probe, by the hook."""
        cap = r["capture"] or {}
        if cap.get("first_probe_s") is None:
            return None
        return cap["hook_age_s"] + cap["first_probe_s"]

    def torch_import_s(self, r: dict) -> Optional[float]:
        """The child's ``import torch``, by the hook."""
        span = (r["capture"] or {}).get("torch_import_s")
        return span[1] - span[0] if span else None

    def parent_s(self, r: dict) -> Optional[float]:
        """A round's wall outside the child's run from its process start to
        its exit handlers, less the hook's work there: the parent's spawn,
        the child's interpreter teardown, the pipe, the parse, the schema
        check and the atomic write.  (The report's ``elapsed_ms`` is the
        parent's own spawn-to-return time, not the child's.)"""
        cap = r["capture"]
        if cap is None or cap.get("exit_s") is None:
            return None
        return r["wall_s"] - cap["hook_age_s"] - cap["exit_s"] - (cap.get("write_s") or 0.0)

    def busy_s(self, r: dict) -> Optional[float]:
        """Device-busy seconds of one traced round's probe child (or of one
        rank, given its entry), or None untraced."""
        events = self.events(r)
        return None if events is None else tr.busy_us(events) / 1e6

    def card_busy_s(self, r: dict) -> Optional[List[float]]:
        """Each card's device-busy seconds in one round, one process a card
        (the probe child on its card, each spawned rank on its own), in
        rank order; None unless the round traced as many processes as the
        cell's cards."""
        procs = self.processes(r)
        if len(procs) != self.cell.get("chips", 1):
            return None
        busy = [self.busy_s(p) for p in procs]
        return None if None in busy else busy

    def device_window(self) -> Optional[tuple]:
        """(busy seconds, window seconds) of the traced window.

        Rounds: every traced round's device busy time, the mean over its
        cards, over the rounds' walls less the hook's own seconds.  Soak: the
        traced soak rounds, from the first round's start to the last
        stream's end.
        """
        if not self.trace:
            return None
        if self.traffic["window"] == "rounds":
            busy = wall = 0.0
            for r in self.rounds:
                cards = self.card_busy_s(r)
                if cards is None:
                    return None
                busy += sum(cards) / len(cards)
                wall += r["wall_s"] - self.overhead_s(r)
            return busy, wall
        events = self.events(self.rounds[0])
        if events is None:
            return None
        spans = tr.annotations(events, "soak_burn_round") + tr.annotations(events, "soak_stream")
        if not spans:
            return None
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        return tr.busy_us(events, lo, hi) / 1e6, (hi - lo) / 1e6

    def breakdown(self) -> Optional[dict]:
        """The top device operations, and idle seconds by what the host did."""
        if not self.trace:
            return None
        ops, idle = {}, {}
        traced = [r for r in self.rounds if self.events(r) is not None]
        for r in traced:
            for p in self.processes(r):
                for name, s in tr.op_seconds(self.events(p) or []).items():
                    ops[name] = ops.get(name, 0.0) + s
            events = self.events(r)
            probes = [(e["name"].split(":", 1)[1], (e["ts"], e["ts"] + e["dur"]))
                      for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith("probebench:")]
            if self.traffic["window"] == "soak":
                spans = [iv for name, iv in probes if name in ("soak_burn_round", "soak_stream")]
                if not spans:
                    continue
                lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
            else:
                times = [e["ts"] for e in events if "ts" in e]
                lo, hi = min(times), max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e)
            for s, e in tr.idle_gaps(events, lo, hi):
                label = tr.label_of((s + e) / 2, probes, "child, between probes")
                idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
        if self.traffic["window"] == "rounds":
            torch_s = sum(self.torch_import_s(r) or 0.0 for r in traced)
            idle["child start-up: import torch"] = torch_s
            idle["child start-up: interpreter, the port's imports, CUDA init, kernel load"] = sum(
                self.child_startup_s(r) for r in traced) - torch_s
            idle["probe parent: spawn, pipe, parse, schema check, report write"] = sum(
                self.parent_s(r) for r in traced)
            starts = [s for r in traced for s in (r["capture"] or {}).get("group_starts", [])]
            if starts:
                idle["rank group start: spawn the ranks, import torch there, join NCCL"] = sum(
                    e - s for s, e in starts)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"probebench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench: dict) -> tuple:
    """(cell, config, traffic) of a workload named in ``BENCHMARK.json``."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"probebench: no workload {name!r} in BENCHMARK.json")
    cell = load_json(HERE / "cells" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entries[0][key]:
            raise SystemExit(f"probebench: cells/{name}.json {key} {cell[key]!r} "
                             f"differs from BENCHMARK.json's {entries[0][key]!r}")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def card_state() -> str:
    """Each card's name, power limit, clock and temperature, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return " | ".join(out.stdout.strip().splitlines()) if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


def card_count() -> int:
    """NVIDIA devices by their device files (``/dev/nvidia<n>``), which
    start nothing on the card; by torch where there are none."""
    try:
        found = sum(1 for n in os.listdir("/dev") if re.fullmatch(r"nvidia\d+", n))
    except OSError:
        found = 0
    if found:
        return found
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def no_card(workload: str, chips: int) -> int:
    import torch

    print(f"probebench: {workload} needs {chips} CUDA device(s); "
          f"torch.cuda.is_available()={torch.cuda.is_available()}, "
          f"device_count={torch.cuda.device_count()}", file=sys.stderr)
    return 2


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="probebench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, process_start_wall: Optional[float] = None):
    """Set up, drive the window, read the metrics and judge the outputs.

    Returns a dict (``run``, ``metrics``, ``device``, ``breakdown``,
    ``checks``, ``card``), or an exit code when the card the cell needs is
    absent.  ``device`` None looks for that card; the CPU tests pass
    ``"cpu"`` to drive the rest of a run.
    """
    if process_start_wall is None:
        process_start_wall = time.time() - process_age_s()
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = load_cell(workload, bench)
    from tpu_node_checker_torch.emit import emit_probe_once  # the system under test

    look = device is None
    if look:
        # A look at the device files before the window, so that set-up
        # holds no import of torch and no start of the driver in this
        # process; torch's own look follows the window.
        if card_count() < cell["chips"]:
            return no_card(workload, cell["chips"])
    on_card = look or device.startswith("cuda")
    saved_env = dict(os.environ)
    scratch = Path(tempfile.mkdtemp(prefix="probebench-", dir=os.environ.get("TMPDIR")))
    try:
        from probebench import driver

        os.environ.update({
            "PYTHONPATH": os.pathsep.join(p for p in (str(HOOK_DIR), os.environ.get("PYTHONPATH")) if p),
            "PROBEBENCH_SEED": str(seed),
            "PROBEBENCH_SAMPLES": str(traffic["samples"]),
            "PROBEBENCH_SOAK_SAMPLES": str(traffic.get("soak_stream_samples", traffic["samples"])),
            "TRITON_CACHE_DIR": str(CACHE_DIR / "triton"),
            "TORCH_EXTENSIONS_DIR": str(CACHE_DIR / "torch_extensions"),
            "CUDA_CACHE_PATH": str(CACHE_DIR / "nv"),
            "PYTHONPYCACHEPREFIX": str(CACHE_DIR / "pycache"),
            "USE_FLAX": "0",
        })
        if look and "CUDA_VISIBLE_DEVICES" not in os.environ:
            # The cell's cards: the program takes every card it sees.
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, range(cell["chips"])))
        os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
        driven = driver.drive(emit_probe_once, config, traffic, seconds, trace, device, scratch)
        import torch

        from probebench import judge

        if look and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
            return no_card(workload, cell["chips"])
        # Read only now: the name query opens a context on the card, and the
        # window's probe child is the one process that uses it.
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        ref_device = "cuda:0" if on_card else device
        run = Run(cell, traffic, trace, process_start_wall, driven, kind)
        card = card_state() if on_card else "cpu"
        # The fullest card's peak: one process a card.
        peaks = [p["capture"].get("memory_peak_bytes") for r in run.warm + run.rounds
                 for p in run.processes(r) if p["capture"]]
        device_doc = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                      "count": cell["chips"],
                      "memory_peak_bytes": max((p for p in peaks if p), default=0)}
        metrics = {}
        for m in cell_metrics(bench, workload, trace):
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        if trace:
            window = run.device_window()
            if window is not None:
                device_doc["busy_s"], device_doc["window_s"] = window
            breakdown = run.breakdown()
        checks = judge.judge(run.warm + run.rounds, traffic, cell["limits"], ref_device)
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        shutil.rmtree(scratch, ignore_errors=True)
    return {"run": run, "metrics": metrics, "device": device_doc, "breakdown": breakdown,
            "checks": checks, "card": card, "device_name": ref_device}


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules the benchmark of the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@contextmanager
def bytecode_cache():
    """Compiled bytecode read from and written to the checkout's cache, in
    this process and (through the environment ``run_cell`` sets) in the
    probe children: an interpreter told to write none, with a library
    shipped without it, would otherwise compile each module it imports from
    source in every process, inside the window too."""
    saved = sys.pycache_prefix, sys.dont_write_bytecode
    sys.pycache_prefix, sys.dont_write_bytecode = str(CACHE_DIR / "pycache"), False
    try:
        yield
    finally:
        sys.pycache_prefix, sys.dont_write_bytecode = saved


def main(argv=None, device: Optional[str] = None) -> int:
    """One run: the compared numbers on stderr, then the result line on stdout."""
    process_start_wall = time.time() - process_age_s()
    args = parse_args(argv)
    with bytecode_cache():
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                       process_start_wall)
    if isinstance(out, int):
        return out
    loaded = forbidden_modules()
    if loaded:
        print(f"probebench: the run loaded {', '.join(loaded)}, which the benchmark of "
              "the port must not", file=sys.stderr)
        return 3
    run, checks = out["run"], out["checks"]
    failed = sum(1 for r in run.rounds if r["rc"] != 0 or not r["report"].get("ok"))
    result = {"correct": all(c["ok"] for c in checks), "attempted": len(run.rounds),
              "failed": failed, "metrics": out["metrics"], "device": out["device"]}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(f"probebench: card after the window: {out['card']}", file=sys.stderr)
    for c in checks:
        for fault in c.get("faults", [])[:10]:
            print(f"probebench: {c['name']}: {fault}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
