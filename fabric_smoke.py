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
3. the workload level through its entry point: healthy, the training step
   sharded data × model over every card where the batch of 8 splits (one
   card's flash step on three cards), ``pipeline_ok`` and ``moe_ok`` true;
4. on an even card count, a two-axis label ``TNC_TOPOLOGY=2x{n/2}`` at the
   mesh level (every leg of both axes, named ``t0/h`` and ``t1/h``) and at
   the workload level (healthy over every card), then drills through the
   entry point, each named alone and schema-valid:
   ``TNC_CHAOS_AXIS=t1`` under that label, ``TNC_CHAOS_SLICES=2`` with
   ``TNC_CHAOS_AXIS=dcn`` (named the DCN slice boundary), and
   ``TNC_CHAOS_SLOW_LINK=t1:1``, which degrades the probe without failing
   it;
5. a rank group in this process: the two-axis mesh's sub-groups, created
   and then started by their first collective, each timed; the sharded
   step against the one-card step from the same weights at the full
   ``BurninConfig()``; the pipeline and MoE probes with a stage drill and
   an expert drill; each fabric probe, a dead-link drill, ring attention
   at 1024 tokens a rank, and one more run after rank 0 worked alone past
   the store's wait slice.

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
        from tpu_node_checker_torch.convert import burnin_shard
        from tpu_node_checker_torch.meshprobe import mesh_link_sweep
        from tpu_node_checker_torch.meshprobe.sweep import link_names
        from tpu_node_checker_torch.models.burnin import (
            Burnin, BurninConfig, train_steps, workload_mesh, workload_probe,
        )
        from tpu_node_checker_torch.parallel import (
            MeshSpec, RankFailure, RankGroup, build_mesh, collective_probe, fold, moe_probe,
            per_axis_probe, pipeline_probe, ring_attention_probe, ring_probe,
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

    # -- 3. the workload level on every card: the step sharded data x model
    # where the batch splits (one card's flash step on three), pipeline, MoE
    rc, rep, seconds = probe("workload")
    want_devices = n if workload_mesh(n, BurninConfig().batch) is not None else 1
    line("workload level", exit_code=rc, seconds=seconds, **{k: rep.get(k) for k in (
        "ok", "error", "elapsed_ms", "workload_ok", "workload_devices", "workload_losses",
        "workload_step_ms", "ring_attention_ok", "pipeline_ok", "moe_ok", "kernel_launches")})
    if rc != 0 or not rep.get("ok") or rep.get("workload_devices") != want_devices:
        fail(f"workload level not healthy on {n} cards over {want_devices}: {rep.get('error')}")
    if not (rep.get("pipeline_ok") is True and rep.get("moe_ok") is True):
        fail(f"pipeline_ok {rep.get('pipeline_ok')}, moe_ok {rep.get('moe_ok')}")

    # -- 4. a two-axis topology label: every leg of both axes, then the
    # per-axis, multislice and slow-link drills, each named alone
    if n % 2 == 0:
        topo = f"2x{n // 2}"
        axis_keys = ("ok", "error", "ici_axis_ok", "ici_topology", "ici_axis_busbw_gbps",
                     "fault_domain_ok", "fault_domain_topology", "fault_domain_busbw_gbps",
                     "dcn_busbw_gbps", "mesh_n_links", "mesh_slow_links", "mesh_dead_links",
                     "mesh_degraded", "chaos_injected")
        rc, rep, seconds = probe("mesh", TNC_TOPOLOGY=topo)
        links = list(((rep.get("collective_legs_ok") or {}).get("links") or {}))
        line(f"mesh level, TNC_TOPOLOGY={topo}", exit_code=rc, seconds=seconds, links=links,
             **{k: rep.get(k) for k in axis_keys})
        if rc != 0 or not rep.get("ok") or links != link_names(topo, n):
            fail(f"{topo} mesh level: links {links}, error {rep.get('error')}")
        if rep.get("ici_axis_ok") != {"t0": True, "t1": True}:
            fail(f"{topo} per-axis verdicts {rep.get('ici_axis_ok')}")
        # The workload level under the label: the data x model step's lines
        # are the label's (2x2 on four cards), so it reuses their groups.
        rc, rep, seconds = probe("workload", TNC_TOPOLOGY=topo)
        line(f"workload level, TNC_TOPOLOGY={topo}", exit_code=rc, seconds=seconds,
             **{k: rep.get(k) for k in ("ok", "error", "elapsed_ms", "ici_axis_ok",
                                        "workload_devices", "workload_losses",
                                        "workload_step_ms", "pipeline_ok", "moe_ok")})
        if (rc != 0 or not rep.get("ok") or rep.get("workload_devices") != n
                or rep.get("ici_axis_ok") != {"t0": True, "t1": True}):
            fail(f"{topo} workload level not healthy: {rep.get('error')}")
        drills = (
            ("collective", {"TNC_TOPOLOGY": topo, "TNC_CHAOS_AXIS": "t1"}, 3,
             lambda r: r.get("ici_axis_ok") == {"t0": True, "t1": False}
             and f"fault localized to mesh axis t1={n // 2}" in (r.get("error") or "")),
            ("collective", {"TNC_CHAOS_SLICES": "2", "TNC_CHAOS_AXIS": "dcn"}, 3,
             lambda r: r.get("fault_domain_ok") == {"dcn": False, "d": True}
             and "fault localized to the DCN slice boundary" in (r.get("error") or "")
             and r.get("dcn_busbw_gbps") is not None),
            ("mesh", {"TNC_TOPOLOGY": topo, "TNC_CHAOS_SLOW_LINK": "t1:1"}, 0,
             lambda r: r.get("ok") is True and r.get("mesh_degraded") is True
             and "t1/1" in (r.get("mesh_slow_links") or []) and not r.get("mesh_dead_links")),
        )
        for level, env, want_rc, named in drills:
            rc, rep, seconds = probe(level, **env)
            line(f"drill {env}", exit_code=rc, seconds=seconds,
                 **{k: rep.get(k) for k in axis_keys})
            if rc != want_rc or not named(rep):
                fail(f"drill {env} not caught and named as expected")

    # -- 5. a rank group in this process
    results = {}
    t0 = time.perf_counter()
    with RankGroup(n, "cuda", timeout_s=120) as group:
        line("rank group", ranks=n, spawned_ranks=n - 1, start_s=time.perf_counter() - t0)
        # The sub-groups of a two-axis mesh: created (every rank, every line),
        # then their communicators' start at the first collective over them.
        if n % 2 == 0:
            spec = MeshSpec((("t0", 2), ("t1", n // 2)))
            t1 = time.perf_counter()
            built = group.run(build_mesh, spec)
            created_s = time.perf_counter() - t1
            firsts = []
            for _ in range(2):
                t1 = time.perf_counter()
                axes = fold(group.run(per_axis_probe, mesh=spec))
                firsts.append(time.perf_counter() - t1)
            line("sub-groups", mesh=spec.axes, create_s=created_s, first_per_axis_s=firsts[0],
                 second_per_axis_s=firsts[1], axis_ok=(axes.details or {}).get("axis_ok"),
                 lines=[m.lines for m in built if not isinstance(m, RankFailure)])
            if not axes.ok or any(isinstance(m, RankFailure) for m in built):
                fail(f"the {spec.axes} sub-groups did not form: {axes.error} {built}")
        # The sharded step against the one-card step from the same weights
        # and tokens, at the full BurninConfig(), then the workload level's
        # other blocks and their drills.
        cfg = BurninConfig()
        wspec = workload_mesh(n, cfg.batch)
        if wspec is not None:
            state = {k: t.detach().clone() for k, t in
                     Burnin(cfg, torch.Generator().manual_seed(0)).state_dict().items()}
            tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                                   generator=torch.Generator().manual_seed(1))
            one = train_steps(cfg, None, 2, state=state, tokens=tokens, keep_grads=True)
            t1 = time.perf_counter()
            runs = group.run(train_steps, cfg, wspec, 2, state=state, tokens=tokens,
                             keep_grads=True)
            sharded_s = time.perf_counter() - t1
            if any(isinstance(r, RankFailure) for r in runs):
                fail(f"the sharded step failed: {runs}")
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0][0], one[0]))
            grad_rel = 0.0
            for rank, (_, _, grads) in enumerate(runs):
                coords = tuple(int(c) for c in divmod(rank, wspec.shape[1]))
                want = burnin_shard(one[2], cfg, wspec, coords)
                grad_rel = max([grad_rel] + [
                    float((g - want[k]).norm() / want[k].norm()) for k, g in grads.items()])
            line("sharded step against one card", mesh=wspec.axes, seconds=sharded_s,
                 sharded_losses=runs[0][0], one_card_losses=one[0],
                 sharded_step_ms=runs[0][1], one_card_step_ms=one[1],
                 loss_rel=loss_rel, worst_grad_rel_l2=grad_rel)
            if loss_rel >= 1e-3 or grad_rel >= 5e-2:
                fail(f"the sharded step disagrees with one card: {loss_rel}, {grad_rel}")
        for name, fn, kw, named in (
            ("pipeline", pipeline_probe, {}, None),
            ("pipeline stage drill", pipeline_probe, {"inject_fault_stage": n - 2},
             lambda r: r.details["first_bad_stage"] == n - 2),
            ("moe", moe_probe, {}, None),
            ("moe expert drill", moe_probe, {"inject_fault_expert": 1},
             lambda r: r.details["bad_experts"] == [1]),
        ):
            t1 = time.perf_counter()
            r = fold(group.run(fn, **kw))
            line(name, seconds=time.perf_counter() - t1, result=dataclasses.asdict(r))
            if r.ok != (named is None) or (named is not None and not named(r)):
                fail(f"{name}: ok={r.ok}: {r.error}")
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
