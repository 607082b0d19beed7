#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA probe's fabric levels on one host with
several NVIDIA cards.

Run from the root of a checkout on a host with three or more cards::

    python3 fabric_smoke.py

``chip_smoke.py`` drives every level on one card, where the rank group
spawns no rank and the link sweep has no link to time.  This script drives
what exists only across cards, one line per check (any failure exits
non-zero and prints no result):

1. the mesh-level probe through its entry point (one rank per card, the
   others spawned by the probe child): healthy, schema-valid, every link of
   the rank ring timed;
2. chaos drills through the entry point, each report schema-valid:
   ``TNC_CHAOS_RING_LINK=1`` must name link ``1->2`` alone,
   ``TNC_CHAOS_SLOW_LINK=d:2`` must degrade link ``d/2`` without failing
   the probe, ``TNC_CHAOS_COLLECTIVE_LEG=all_gather`` must fail that leg
   alone;
3. the workload level must fail as not yet ported on more than one card;
4. a rank group in this process: each fabric probe, a dead-link drill,
   ring attention at 1024 tokens a rank, and one more run after rank 0
   worked alone past the store's wait slice.

The last line is ``{"ok": true, "cards": n}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"fabric_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def line(name: str, **fields) -> None:
    print(f"{name}: " + json.dumps(fields, default=str), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        fail(f"torch does not import: {exc}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 3:
        fail(f"needs three or more NVIDIA cards, {n} visible")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from tpu_node_checker_torch.meshprobe import mesh_link_sweep
        from tpu_node_checker_torch.models.burnin import BurninConfig, workload_probe
        from tpu_node_checker_torch.parallel import (
            RankGroup, collective_probe, fold, ring_attention_probe, ring_probe,
        )
        from tpu_node_checker_torch.probe.schema import validate_report
    except ImportError as exc:
        fail(f"the tpu_node_checker_torch package is not beside this script: {exc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    line("environment", torch=torch.__version__, cards=smi)

    def probe(level: str, **env) -> tuple:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
             "--probe-level", level],
            capture_output=True, text=True, cwd=root, timeout=600,
            env={**os.environ, **env, "TNC_SCHEMA_STRICT": "1"},
        )
        seconds = time.perf_counter() - t0
        try:
            report = json.loads(proc.stdout)
        except json.JSONDecodeError:
            fail(f"{level} {env} printed no report (exit {proc.returncode}): {proc.stderr[-2000:]}")
        violations = validate_report(report)
        if violations:
            fail(f"{level} {env} report violates the schema: {violations}")
        return proc.returncode, report, seconds

    keys = ("ok", "error", "device_count", "elapsed_ms", "collective_ok",
            "collective_latency_us", "collective_busbw_gbps", "collective_legs_ok",
            "ring_ok", "ring_link_gbps", "ring_bad_links", "mesh_ok", "mesh_degraded",
            "mesh_n_links", "mesh_slow_links", "mesh_dead_links", "chaos_injected")

    # -- 1. the mesh level, healthy
    rc, rep, seconds = probe("mesh")
    line("mesh level", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in keys})
    if rc != 0 or not rep.get("ok") or rep.get("device_count") != n:
        fail(f"mesh-level probe not healthy on {n} cards: {rep.get('error')}")
    if rep.get("mesh_n_links") != n or rep.get("mesh_dead_links"):
        fail(f"link sweep: {rep.get('mesh_n_links')} links, dead {rep.get('mesh_dead_links')}")

    # -- 2. chaos drills, each named exactly
    drills = (
        ("mesh", {"TNC_CHAOS_RING_LINK": "1"}, 3,
         lambda r: r.get("ring_bad_links") == ["1->2"]),
        ("mesh", {"TNC_CHAOS_SLOW_LINK": "d:2"}, 0,
         lambda r: r.get("mesh_degraded") is True and "d/2" in r.get("mesh_slow_links", [])
         and not r.get("mesh_dead_links")),
        ("collective", {"TNC_CHAOS_COLLECTIVE_LEG": "all_gather"}, 3,
         lambda r: [r["collective_legs_ok"][f"{leg}_ok"] for leg in
                    ("psum", "all_gather", "reduce_scatter")] == [True, False, True]),
    )
    for level, env, want_rc, named in drills:
        rc, rep, seconds = probe(level, **env)
        line(f"drill {env}", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in keys})
        if rc != want_rc or not named(rep):
            fail(f"drill {env} not caught and named as expected")

    # -- 3. the workload level on more than one card
    rc, rep, seconds = probe("workload")
    line("workload level", exit_code=rc, seconds=seconds, error=rep.get("error"))
    if rc != 3 or "not yet ported" not in (rep.get("error") or ""):
        fail("the workload level on several cards did not fail as not yet ported")

    # -- 4. a rank group in this process
    results = {}
    t0 = time.perf_counter()
    with RankGroup(n, "cuda", timeout_s=120) as group:
        line("rank group", ranks=n, spawned_ranks=n - 1, start_s=time.perf_counter() - t0)
        for name, fn, kw, want_ok in (
            ("collective", collective_probe, {}, True),
            ("ring", ring_probe, {}, True),
            ("ring swap drill", ring_probe, {"inject_fault_link": 2, "inject_fault_swap": True},
             False),
            ("sweep dead-link drill", mesh_link_sweep, {"inject_dead_link": "d:1"}, False),
            ("ring attention", ring_attention_probe, {"seq_per_device": 16}, True),
            ("ring attention, 1024 tokens a rank", ring_attention_probe,
             {"seq_per_device": 1024, "head_dim": 64}, True),
        ):
            t1 = time.perf_counter()
            r = fold(group.run(fn, **kw))
            results[name] = r
            line(name, seconds=time.perf_counter() - t1, result=dataclasses.asdict(r))
            if r.ok != want_ok:
                fail(f"{name}: ok={r.ok}, expected {want_ok}: {r.error}")
        if results["ring swap drill"].details.get("bad_links") != ["2->3"]:
            fail("the ring swap drill was not named 2->3")
        if results["sweep dead-link drill"].dead != ["d/1"]:
            fail("the sweep's dead-link drill was not named d/1")
        # Rank 0 alone past the store's wait slice, then the group again.
        t1 = time.perf_counter()
        wl = workload_probe(dataclasses.replace(BurninConfig(), attention="flash"))
        time.sleep(max(0.0, 3.0 - (time.perf_counter() - t1)))
        again = fold(group.run(ring_attention_probe, seq_per_device=16))
        line("after rank 0 worked alone", alone_s=time.perf_counter() - t1,
             workload_ok=wl.ok, ring_attention_ok=again.ok)
        if not (wl.ok and again.ok):
            fail("the group did not survive rank 0 working alone")
    print(json.dumps({"ok": True, "cards": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
