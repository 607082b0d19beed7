"""Subprocess-isolated card liveness probe.

Initialises CUDA (and optionally runs real compute) in a **child process**
with a hard wall-clock timeout.  CUDA initialisation can hang on a sick card
(after an Xid, or while another process holds it), and the caller must never
be taken down or stalled by the probe.  The child reports over a pipe as one
JSON line; anything else (timeout, crash, OOM, import error) degrades to a
structured failure, never an exception.

Probe levels (each includes the previous):

* ``enumerate``: CUDA init + card enumeration (platform, count, kinds,
  memory);
* ``compute``: tensor-core matmul burn (bf16) + exact int8 check, memory
  bandwidth sample + data-integrity pattern memtest, and the three kernels
  written by hand for Hopper (tiled matmul, bulk-copy stream, flash
  attention), each held against its plain version, on one card
  (:mod:`tpu_node_checker_torch.ops`);
* ``collective``: all_reduce, all_gather and reduce-scatter and a ring walk
  over one rank per local card (:mod:`tpu_node_checker_torch.parallel`;
  NCCL on the cards, gloo on the CPU); with a multi-dim ``TNC_TOPOLOGY``
  label, one all_reduce and its bandwidth per torus axis of the rank mesh
  the label describes; over a DCN × per-slice mesh instead where the probe
  has slices (each process of a distributed group with equal card counts,
  or ``TNC_CHAOS_SLICES=N`` on one host), so a fault names the slice
  boundary or a torus axis;
* ``mesh``: the link doctor (:mod:`tpu_node_checker_torch.meshprobe`), every
  link leg of every mesh axis timed on its own with an ``OK | SLOW | DEAD``
  verdict; SLOW legs degrade the node (``mesh_degraded``) without failing
  it;
* ``workload``: a training step, sharded data × model over the cards where
  the batch splits (else on one card, with the flash-attention kernel in
  its forward pass; :mod:`tpu_node_checker_torch.models`), ring attention
  over the ranks, and on more than one card a pipeline and an
  expert-parallel layer.

Distributed probing (``TNC_PROBE_DISTRIBUTED=1``, ``run_local_probe(
distributed=True)``): one probe process per host meets the others
(:func:`rendezvous_from_env`, :class:`~tpu_node_checker_torch.parallel.mesh.Meeting`)
before enumerating, and ``device_count`` counts every host's cards.  With
more than one process, an all_reduce over one rank per process, weighted by
process index, proves the rendezvous carries data (``distributed_psum``);
nothing is spawned for it, so the enumerate and compute levels start no
rank.  From the collective level up, the rank group holds every host's
cards.  Where every process has the same card count, each process is one
slice (``num_slices``, ``slice_indices``): the network between hosts is the
DCN axis of the fault-domain block.  A rendezvous that fails is a failed
probe, never a probe of one host.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Mapping, Optional

from tpu_node_checker_torch.probe import spans
from tpu_node_checker_torch.probe.levels import (  # noqa: F401 — re-exported API
    DEFAULT_TIMEOUT_S,
    LEVEL_TIMEOUTS_S,
    LEVELS,
)

# Extra kill-timer headroom for a distributed probe: the rendezvous, the
# peers' start-up and the cross-process psum (the JAX parent's figure).
DISTRIBUTED_EXTRA_TIMEOUT_S = 90.0
# How long the rendezvous waits for the coordinator and every process when
# TNC_DIST_INIT_TIMEOUT_S is unset: inside DISTRIBUTED_EXTRA_TIMEOUT_S, so a
# missing peer fails in the child with its cause named, before the kill-timer.
DEFAULT_RENDEZVOUS_TIMEOUT_S = 60.0

if TYPE_CHECKING:  # the parent imports no torch; the child reaches it lazily
    from tpu_node_checker_torch.parallel.mesh import Rendezvous

# The child is a standalone -c program (not a fork), so the caller never
# initialises CUDA and a wedged card cannot leak into it.
_CHILD_SCRIPT = r"""
import json, os, sys, time
# The first statement: the pair of clocks the child's spans are placed by.
_first = {"unix_ns": time.time_ns(), "monotonic_ns": time.monotonic_ns()}
from tpu_node_checker_torch.probe import spans as _spans
_round = _spans.child_round(_first, os.environ)
level = sys.argv[1]
device = sys.argv[2]
out = {"ok": False, "level": level}
# The levels this package runs.
PORTED_LEVELS = ("enumerate", "compute", "collective", "mesh", "workload")


def _append_error(msg):
    # Every late-folding verdict uses this: demote ok and chain the message
    # onto whatever error is already standing.
    out["ok"] = False
    out["error"] = f"{out['error']}; {msg}" if out.get("error") else msg


# The parent's kill-timer, less room to exit: the farewell after the report
# waits no longer than this.
deadline = time.monotonic() + float(sys.argv[3]) - 10.0
hbm_capacity_error = None
group = None
meeting = None
_alloc0 = None
try:
    if level not in PORTED_LEVELS:
        raise NotImplementedError(
            f"probe level {level!r} is not yet ported to the PyTorch/CUDA "
            f"probe (ported: {', '.join(PORTED_LEVELS)})"
        )
    with _spans.span("child.import_torch"):
        import torch
    with _spans.span("child.import_port"):
        from tpu_node_checker_torch.ops._harness import resolve_device
        from tpu_node_checker_torch.probe.levels import LEVEL_TIMEOUTS_S
    # cuda:0 unless the caller asked for the CPU; an absent card raises here.
    # On the card this starts the driver; each card's context is created at
    # its first memory query below.
    with _spans.span("child.cuda_init"):
        dev = resolve_device(device)
    with _spans.span("child.enumerate"):
        on_card = dev.type == "cuda"
        n_dev = torch.cuda.device_count() if on_card else 1
        n_global, process_index, process_count = n_dev, 0, 1
        if os.environ.get("TNC_PROBE_DISTRIBUTED") == "1":
            # One probe process per host: meet the others before enumerating, so
            # device_count holds every host's cards.  Failing to meet is itself
            # a health failure.  The rank group over the meeting forms at the
            # collective level, as the group of one host does.
            from tpu_node_checker_torch.parallel import Meeting
            from tpu_node_checker_torch.probe.liveness import rendezvous_from_env
            rdv = rendezvous_from_env(os.environ)
            meeting = Meeting(rdv, n_dev)
            # The meeting alone: the connection and every process's card count,
            # what the rendezvous timeout bounds.
            out["rendezvous_ms"] = round(meeting.meet_s * 1e3, 1)
            out["distributed"] = True
            n_global, process_index, process_count = (
                meeting.world_size, rdv.process_id, rdv.num_processes)
        if on_card:
            out["platform"] = "gpu"
            out["device_kinds"] = sorted({torch.cuda.get_device_name(i) for i in range(n_dev)})
        else:
            out["platform"] = "cpu"
            out["device_kinds"] = ["cpu"]
        out["local_device_count"] = n_dev
        out["device_count"] = n_global
        out["process_index"] = process_index
        out["process_count"] = process_count
        out["ok"] = n_dev > 0
        mem = []         # report surface: devices exposing at least one stat
        mem_graded = []  # grading surface: EVERY local device, so a card whose
                         # memory query raises is graded as a None-limit entry
        for i in range(n_dev if on_card else 0):
            try:
                with _spans.span("child.cuda_init"):
                    free, total = torch.cuda.mem_get_info(i)
                in_use, limit = total - free, torch.cuda.get_device_properties(i).total_memory
            except RuntimeError:
                in_use, limit = None, None
            entry = {"id": i,
                     "bytes_in_use": int(in_use) if in_use is not None else None,
                     "bytes_limit": int(limit) if limit is not None else None}
            mem_graded.append(entry)
            if in_use is not None or limit is not None:
                mem.append(entry)
        if mem:
            out["memory"] = mem
        # bytes_in_use is the card's whole use (every process on it, per
        # mem_get_info); bytes_limit grades capacity where a table exists (the
        # built-in one knows TPUs only, so on a card it is stamped skipped).
        from tpu_node_checker_torch.probe.floors import grade_hbm_capacity
        _hcf = os.environ.get("TNC_HBM_CAPACITY_FLOOR")
        try:
            _kw = {"fraction": float(_hcf)} if _hcf else {}
        except ValueError:
            raise ValueError(f"TNC_HBM_CAPACITY_FLOOR {_hcf!r} is not a number")
        cap = grade_hbm_capacity(out.get("device_kinds"), out.get("platform"), mem_graded, **_kw)
        out["hbm_capacity"] = cap
        if "skipped" not in cap and not cap["ok"]:
            bad = ", ".join(f"device {f['id']}: {f['gb']} GB" for f in cap["failed_devices"])
            hbm_capacity_error = (
                f"hbm_capacity: {bad} < "
                f"{round(cap['fraction'] * cap['expected_gb'], 1)} GB "
                f"({cap['fraction']:.0%} of {cap['generation']} nominal "
                f"{cap['expected_gb']} GB)"
            )
        if meeting is not None and meeting.slice_indices:
            # A distributed group of equal hosts: each process is one slice,
            # and the DCN axis of the fault-domain block is the host boundary.
            out["num_slices"] = len(meeting.slice_indices)
            out["slice_indices"] = meeting.slice_indices
        if out.get("distributed") and out["ok"] and out["process_count"] > 1:
            # Prove the rendezvous carries data: one all_reduce over one rank per
            # process, each passing its card count x (its index + 1), so that the
            # sum needs every process.  Half the level's budget bounds it.
            from tpu_node_checker_torch.parallel import distributed_psum
            try:
                with meeting.process_group(dev.type, timeout_s=LEVEL_TIMEOUTS_S[level] / 2):
                    _sum = distributed_psum(float(n_dev * (process_index + 1)))
            except Exception as exc:
                raise RuntimeError(f"distributed psum: {type(exc).__name__}: {exc}") from exc
            _expected = float(sum(c * (p + 1) for p, c in enumerate(meeting.counts)))
            out["distributed_psum"] = _sum
            out["distributed_psum_ok"] = abs(_sum - _expected) < 1e-6
            out["ok"] = out["ok"] and out["distributed_psum_ok"]
        # Full-stack chaos hooks, read UNCONDITIONALLY whatever the level: a
        # chaos var set with a level that never runs the injected surface fails
        # loudly, or the rehearsal "passes" while testing nothing.  Stamped
        # before validating, so a malformed injection shows in the report.
        _CHAOS_VARS = {
            "collective_leg": ("TNC_CHAOS_COLLECTIVE_LEG", ("collective", "mesh", "workload")),
            "ring_link": ("TNC_CHAOS_RING_LINK", ("collective", "mesh", "workload")),
            "axis": ("TNC_CHAOS_AXIS", ("collective", "mesh", "workload")),
            "slices": ("TNC_CHAOS_SLICES", ("collective", "mesh", "workload")),
            "slow_link": ("TNC_CHAOS_SLOW_LINK", ("mesh", "workload")),
            "throttle": ("TNC_CHAOS_THROTTLE", ("compute", "collective", "mesh", "workload")),
        }
        chaos = {}
        for key, (var, _lv) in _CHAOS_VARS.items():
            if os.environ.get(var):
                chaos[key] = os.environ[var]
        if chaos:
            # A copy: the ring link is parsed to an int below, and the report
            # keeps the variable as it was set (a string, per the schema).
            out["chaos_injected"] = dict(chaos)
            bad = sorted(_CHAOS_VARS[k][0] for k in chaos if level not in _CHAOS_VARS[k][1])
            if bad:
                raise ValueError(
                    f"{', '.join(bad)} set but probe level {level!r} never runs "
                    "the injected surface (collective legs need --probe-level "
                    "collective+, the mesh link sweep needs mesh+, the throttle "
                    "needs compute+) — the injection would silently test "
                    "nothing; raise the level or unset the chaos vars"
                )
    if level in ("compute", "collective", "mesh", "workload") and out["ok"]:
        with _spans.span("child.import_port"):
            from tpu_node_checker_torch import ops
        if on_card:
            # Build the three kernels at once, one nvcc each, before timing.
            with _spans.span("child.kernel_build"):
                from tpu_node_checker_torch.ops import _build
                _build.build_all()
        # Round-trip overhead of one trivial launch plus its scalar fetch:
        # telemetry for triage, and the gate deciding whether wall-clock
        # figures may be floor-graded.
        with _spans.span("child.dispatch_check"):
            _x = torch.zeros((), device=dev)
            float((_x + 1.0).item())
            _t0 = time.perf_counter()
            for _ in range(3):
                float((_x + 1.0).item())
            out["dispatch_overhead_ms"] = round((time.perf_counter() - _t0) / 3 * 1e3, 2)
        # The caching allocator's counts, from the first probe to the report.
        _alloc0 = _spans.allocator_counts(dev)
        # Card sizing, as the JAX child sizes for its accelerator: on-device
        # time must dominate launch overhead.
        with _spans.span("probe.matmul_burn"):
            burn = (ops.matmul_burn(iters=64, device=dev) if on_card
                    else ops.matmul_burn(device=dev))
        out["matmul_tflops"] = round(burn.tflops, 3)
        out["matmul_ok"] = burn.ok
        with _spans.span("probe.hbm_bandwidth_probe"):
            hbm = ops.hbm_bandwidth_probe(device=dev)
        out["hbm_gbps"] = round(hbm.gbps, 2)
        out["hbm_ok"] = hbm.ok
        with _spans.span("probe.pallas_matmul_probe"):
            pallas = ops.pallas_matmul_probe(device=dev)
        out["pallas_ok"] = pallas.ok
        i8_gate = True
        if os.environ.get("TNC_SKIP_INT8") == "1":
            # Operator escape hatch; skipping is visible, never silent.
            out["int8_skipped"] = True
        else:
            with _spans.span("probe.int8_matmul_probe"):
                i8 = (
                    ops.int8_matmul_probe(m=1024, k=1024, n=1024, iters=128, device=dev)
                    if on_card
                    else ops.int8_matmul_probe(device=dev)
                )
            out["int8_ok"] = i8.ok
            out["int8_tops"] = round(i8.tops, 3)
            i8_gate = i8.ok
            if not i8.ok:
                out["int8_err"] = i8.error
        fa_gate = True
        if os.environ.get("TNC_SKIP_FLASH_ATTENTION") == "1":
            # Operator escape hatch; skipping is visible, never silent.
            out["flash_attention_skipped"] = True
        else:
            with _spans.span("probe.flash_attention_probe"):
                fa = ops.flash_attention_probe(seq=256, device=dev)
            out["flash_attention_ok"] = fa.ok
            fa_gate = fa.ok
            if not fa.ok:
                out["flash_attention_err"] = fa.error
                out["flash_attention_max_abs_err"] = fa.max_abs_err
        with _spans.span("probe.dma_stream_probe"):
            dma = ops.dma_stream_probe(device=dev)
        out["dma_ok"] = dma.ok
        out["dma_gbps"] = round(dma.gbps, 2)
        with _spans.span("probe.hbm_pattern_probe"):
            mt = ops.hbm_pattern_probe(device=dev)
        out["memtest_ok"] = mt.ok
        if not mt.ok:
            out["memtest_err"] = mt.error
            out["memtest_mismatches"] = mt.mismatches
        out["ok"] = (
            out["ok"] and burn.ok and hbm.ok and pallas.ok and i8_gate
            and fa_gate and dma.ok and mt.ok
        )
        soak_s = float(os.environ.get("TNC_SOAK_S") or 0)
        if soak_s > 0 and out["ok"]:
            # Card sizing again: the JAX round of 16 products keeps an H100
            # busy for under a millisecond, and the host's work between
            # rounds leaves the card mostly idle; 1024 take about 40 ms, so
            # the card stays loaded for the soak's budget.
            with _spans.span("probe.soak_burn"):
                soak = ops.soak_burn(
                    soak_s,
                    iters=1024 if on_card else 16,
                    device=dev,
                    min_sustained_ratio=float(os.environ.get("TNC_SOAK_MIN_RATIO") or 0.5),
                    hbm_mib=int(os.environ.get("TNC_SOAK_HBM_MIB") or 128),
                )
            out["soak"] = soak.to_dict()
            out["ok"] = out["ok"] and soak.ok
    if level in ("collective", "mesh", "workload") and out["ok"]:
        from tpu_node_checker_torch.parallel import RankGroup, collective_probe, fold, ring_probe
        if "ring_link" in chaos:
            try:
                chaos["ring_link"] = int(chaos["ring_link"])
            except ValueError:
                raise ValueError(
                    f"TNC_CHAOS_RING_LINK {chaos['ring_link']!r} is not an "
                    "integer link index"
                )
        # One rank per card, rank 0 this process, over every process's
        # cards when distributed; the ranks serve the mesh and workload
        # blocks too.  Half the level's budget bounds every collective, so a
        # hung one fails inside the kill-timer.
        group = RankGroup(n_dev, dev.type, timeout_s=LEVEL_TIMEOUTS_S[level] / 2,
                          meeting=meeting)
        group.start()
        coll = fold(group.run(collective_probe, inject_fault_leg=chaos.get("collective_leg")))
        out["collective_ok"] = coll.ok
        out["collective_latency_us"] = round(coll.latency_us, 1)
        out["collective_busbw_gbps"] = (coll.details or {}).get("busbw_gbps")
        # Per-leg verdicts and timings: on any failure, and always at mesh
        # level and above, where the links sub-block rides in it.
        _legs_block = {
            k: (coll.details or {}).get(k)
            for k in ("psum_ok", "all_gather_ok", "reduce_scatter_ok")
        }
        for _lk, _lv in ((coll.details or {}).get("leg_latency_us") or {}).items():
            _legs_block[f"{_lk}_latency_us"] = _lv
        if not coll.ok or level in ("mesh", "workload"):
            out["collective_legs_ok"] = _legs_block
        if not coll.ok:
            out["collective_err"] = coll.error
        ring = fold(group.run(ring_probe, inject_fault_link=chaos.get("ring_link")))
        out["ring_ok"] = ring.ok
        out["ring_link_gbps"] = (ring.details or {}).get("link_gbps")
        if not ring.ok:
            out["ring_bad_links"] = (ring.details or {}).get("bad_links") or []
            out["ring_err"] = ring.error
        out["ok"] = out["ok"] and coll.ok and ring.ok
        topo = os.environ.get("TNC_TOPOLOGY")
        n_slices = out.get("num_slices") or 0
        if "slices" in chaos:
            # Rehearsal partition: the local cards as N DCN-joined slices,
            # so the whole fault-domain path runs on one host; it overrides
            # the slices a distributed group stamped.
            try:
                chaos["slices"] = int(chaos["slices"])
            except ValueError:
                raise ValueError(
                    f"TNC_CHAOS_SLICES {chaos['slices']!r} is not an integer "
                    "slice count"
                )
            if chaos["slices"] < 2:
                # One slice is not a multislice: the DCN block would be
                # skipped and the rehearsal would pass testing nothing.
                raise ValueError(
                    f"TNC_CHAOS_SLICES={chaos['slices']} cannot rehearse a "
                    "slice boundary — need at least 2"
                )
            n_slices = chaos["slices"]
        multislice = n_slices > 1
        from tpu_node_checker_torch.parallel import (
            axis_bandwidth_probe, hybrid_spec, per_axis_probe, topology_spec,
        )

        def _axis_bw_sweep(spec_):
            # Per-axis all_reduce bandwidth over every axis of the mesh: an
            # axis can be correct but slow, which the exact compare cannot see.
            bw_, errs_ = {}, {}
            for nm in spec_.axis_names:
                leg = fold(group.run(axis_bandwidth_probe, spec_, nm))
                bw_[nm] = (leg.details or {}).get("busbw_gbps")
                if not leg.ok:
                    errs_[nm] = leg.error
            return bw_, errs_

        if "axis" in chaos:
            # The requested axis must belong to a mesh a probe below builds,
            # never inject nothing silently.
            if chaos["axis"] == "dcn":
                if not multislice:
                    raise ValueError(
                        "TNC_CHAOS_AXIS=dcn requested but this is not a "
                        "multislice job (one slice; set TNC_CHAOS_SLICES=N "
                        "to rehearse) — the DCN fault-domain probe will "
                        "not run"
                    )
            elif not multislice and not (topo and "x" in topo):
                raise ValueError(
                    f"TNC_CHAOS_AXIS={chaos['axis']!r} requested but no "
                    f"multi-dim topology is set (TNC_TOPOLOGY={topo!r}); "
                    "the per-axis probe will not run"
                )
        if multislice:
            # The slice boundary is its own fault domain: the per-axis legs
            # over a DCN x per-slice mesh name "dcn" or a torus axis, and an
            # all_reduce along dcn alone gives the cross-slice bandwidth.
            # (The label describes ONE slice, so the flat path is skipped.)
            hspec = hybrid_spec(group.world_size, topology=topo, num_slices=n_slices)
            dom = fold(group.run(per_axis_probe, mesh=hspec, inject_fault_axis=chaos.get("axis")))
            out["fault_domain_ok"] = (dom.details or {}).get("axis_ok")
            out["fault_domain_topology"] = (dom.details or {}).get("topology")
            if not dom.ok:
                _append_error(dom.error)
            bw, bw_err = _axis_bw_sweep(hspec)
            out["fault_domain_busbw_gbps"] = bw
            out["dcn_busbw_gbps"] = bw.get("dcn")
            if bw_err:
                out["ok"] = False
                out["axis_busbw_err"] = bw_err
                if "dcn" in bw_err:
                    out["dcn_err"] = bw_err["dcn"]
        elif topo and "x" in topo:
            # A multi-dim label: one all_reduce per torus axis, whatever the
            # flat verdict, so a fault names the sick axis.
            tspec = topology_spec(topo, group.world_size)
            ax = fold(group.run(per_axis_probe, mesh=tspec, inject_fault_axis=chaos.get("axis")))
            out["ici_axis_ok"] = (ax.details or {}).get("axis_ok")
            out["ici_topology"] = (ax.details or {}).get("topology")
            if not ax.ok:
                _append_error(ax.error)
            bw, bw_err = _axis_bw_sweep(tspec)
            out["ici_axis_busbw_gbps"] = bw
            if bw_err:
                out["ok"] = False
                out["axis_busbw_err"] = bw_err
    if level in ("mesh", "workload") and out["ok"]:
        # The link doctor: a DEAD leg fails the probe; a SLOW one degrades
        # it, ok stays True and mesh_degraded carries the evidence.
        from tpu_node_checker_torch.meshprobe import mesh_link_sweep
        sweep = fold(group.run(
            mesh_link_sweep,
            topology=os.environ.get("TNC_TOPOLOGY"),
            inject_slow_link=chaos.get("slow_link"),
        ))
        out["mesh_ok"] = sweep.ok
        out["mesh_degraded"] = sweep.degraded
        out["mesh_n_links"] = sweep.n_links
        out["mesh_latency_us"] = round(sweep.latency_us, 1)
        if sweep.slow:
            out["mesh_slow_links"] = sweep.slow
        if sweep.dead:
            out["mesh_dead_links"] = sweep.dead
        out.setdefault("collective_legs_ok", {})["links"] = sweep.links
        if sweep.error:
            out["mesh_err"] = sweep.error
        if not sweep.ok:
            _append_error(sweep.error or "mesh link sweep failed")
    if level in ("compute", "collective", "mesh", "workload"):
        # Performance floors: grade the measured figures against what this
        # device kind should deliver.  Runs whatever the flat verdict; a
        # skipped grading is stamped, never silent.
        from tpu_node_checker_torch.probe.floors import (
            DEFAULT_FLOOR_FRACTION,
            FLOOR_METRICS,
            floor_failure_message,
            grade_floors,
            max_dispatch_from_env,
        )
        frac = DEFAULT_FLOOR_FRACTION
        if os.environ.get("TNC_PERF_FLOOR"):
            try:
                frac = float(os.environ["TNC_PERF_FLOOR"])
            except ValueError:
                raise ValueError(
                    f"TNC_PERF_FLOOR {os.environ['TNC_PERF_FLOOR']!r} is not a number"
                )
        expect = None
        if os.environ.get("TNC_PERF_EXPECT"):
            expect = json.loads(os.environ["TNC_PERF_EXPECT"])
        max_disp = max_dispatch_from_env(os.environ.get("TNC_PERF_FLOOR_MAX_DISPATCH_MS"))
        measured = {m: out.get(m) for m in FLOOR_METRICS}
        if isinstance(out.get("soak"), dict):
            _med = out["soak"].get("tflops_median")
            if isinstance(_med, (int, float)) and _med > 0:
                measured["sustained_tflops"] = _med
        if any(v is not None for v in measured.values()) or chaos.get("throttle"):
            kw = {}
            if max_disp is not None:
                kw["max_dispatch_ms"] = max_disp
            verdict = grade_floors(
                out.get("device_kinds"),
                out.get("platform"),
                measured,
                fraction=frac,
                expectations=expect,
                throttle=chaos.get("throttle"),
                dispatch_overhead_ms=out.get("dispatch_overhead_ms"),
                **kw,
            )
            out["perf_floor"] = verdict
            if not verdict.get("ok", True):
                _append_error(floor_failure_message(verdict))
    if level == "workload" and out["ok"]:
        import dataclasses as _dc
        from tpu_node_checker_torch.models import BurninConfig, workload_mesh, workload_probe
        from tpu_node_checker_torch.ops.flash_attention import BLOCK as _FA_BLOCK
        from tpu_node_checker_torch.parallel import (
            moe_probe, pipeline_probe, ring_attention_probe,
        )
        # The step sharded data x model over every rank, so the strongest
        # grade pushes its collectives across the cards; where the batch
        # does not split (one card, or three), one card's step with the
        # flash-attention kernel inside, forward and backward.
        n_ranks = group.world_size
        model = os.environ.get("TNC_WORKLOAD_MODEL") or "burnin"
        if model == "deepseek-v2-lite":
            # DeepSeek-V2-Lite's step, one card's share of its 8-way
            # expert-parallel layout, on this process's card alone.
            from tpu_node_checker_torch.models import deepseek_v2
            wspec = None
            wl = deepseek_v2.workload_probe(device=dev)
        elif model != "burnin":
            raise ValueError(f"TNC_WORKLOAD_MODEL {model!r} is none of the workload "
                             "models (burnin, deepseek-v2-lite)")
        else:
            cfg = BurninConfig()
            wspec = workload_mesh(n_ranks, cfg.batch)
            if wspec is None:
                if cfg.seq % _FA_BLOCK == 0 and os.environ.get("TNC_SKIP_FLASH_ATTENTION") != "1":
                    cfg = _dc.replace(cfg, attention="flash")
                wl = workload_probe(cfg, device=dev)
            else:
                wl = fold(group.run(workload_probe, cfg, mesh=wspec))
        out["workload_ok"] = wl.ok
        out["workload_devices"] = n_ranks if wspec is not None else 1
        out["workload_losses"] = [round(l, 4) for l in wl.losses]
        out["workload_step_ms"] = round(wl.step_time_ms, 1)
        if not wl.ok:
            _append_error(f"workload: {wl.error}")
        ra = fold(group.run(ring_attention_probe, seq_per_device=16))
        out["ring_attention_ok"] = ra.ok
        if not ra.ok:
            _append_error(ra.error)
        if n_ranks > 1:
            # The rest of the parallelism surface: pipeline neighbour hops
            # and expert-parallel all_to_all shuffles.
            pp = fold(group.run(pipeline_probe))
            out["pipeline_ok"] = pp.ok
            if not pp.ok:
                _append_error(pp.error)
            ep = fold(group.run(moe_probe))
            out["moe_ok"] = ep.ok
            if not ep.ok:
                _append_error(ep.error)
    if hbm_capacity_error:
        _append_error(hbm_capacity_error)
except Exception as exc:  # tnc: allow-broad-except(the whole point is to catch anything)
    # ok may already be True from a completed earlier stage; a crash anywhere
    # is a failed probe.
    out["ok"] = False
    out["error"] = f"{type(exc).__name__}: {exc}"
finally:
    if group is not None:
        group.close()
with _spans.span("child.report"):
    if level != "enumerate" and "tpu_node_checker_torch.ops" in sys.modules:
        # Which hand-written kernels ran, the training step's included (all 0
        # on the CPU, where the plain versions stand in for them).
        out["kernel_launches"] = sys.modules["tpu_node_checker_torch.ops"].launch_counts()
    if _alloc0 is not None:
        _spans.count_allocator(_alloc0, dev)
# Closes the child's own span, probe.child: serialising and printing the
# report fall in the parent's probe.child_exit.
out["spans"] = _round.child_block()
print(json.dumps(out, default=lambda o: o.item() if hasattr(o, "item") else str(o)), flush=True)
if meeting is not None:
    # After the report: process 0 keeps the store up for its peers, but
    # never past the kill-timer, which would discard the report.
    meeting.close(deadline)
"""


@dataclass
class ProbeResult:
    """Outcome of one local probe run; ``to_dict()`` feeds the JSON payload."""

    ok: bool
    level: str
    hostname: str
    elapsed_ms: float
    device_count: int = 0
    platform: Optional[str] = None
    device_kinds: List[str] = field(default_factory=list)
    error: Optional[str] = None
    details: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "ok": self.ok,
            "level": self.level,
            "hostname": self.hostname,
            "elapsed_ms": self.elapsed_ms,
            "device_count": self.device_count,
            "platform": self.platform,
            "device_kinds": self.device_kinds,
        }
        if self.error:
            d["error"] = self.error
        d.update(self.details)
        return d


def run_local_probe(
    level: str = "enumerate",
    timeout_s: Optional[float] = None,
    expected_devices: Optional[int] = None,
    device: str = "cuda:0",
    topology: Optional[str] = None,
    soak_s: float = 0.0,
    perf_floor: Optional[float] = None,
    distributed: bool = False,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    dist_init_timeout_s: Optional[float] = None,
    workload_model: Optional[str] = None,
) -> ProbeResult:
    """Probe this host's cards in a child process; never raises on a probe
    failure.

    ``device`` is ``cuda:0`` unless the caller asks for ``cpu`` (the tests
    do); a missing card fails the probe and the error names CUDA.
    ``expected_devices`` (e.g. a node's ``nvidia.com/gpu`` allocatable count)
    turns a *partial* enumeration into a failure.  ``timeout_s=None`` picks
    the per-level budget from :data:`LEVEL_TIMEOUTS_S`.  The child reads the
    JAX child's ``TNC_*`` settings (floors, chaos, skips, soak, topology)
    from the environment.

    ``topology`` (a label like ``"2x2"``) sets ``TNC_TOPOLOGY``: one
    all_reduce per torus axis at the collective level and above.
    ``soak_s > 0`` sets ``TNC_SOAK_S`` and extends the kill-timer by as
    much, since the soak spends its time inside the child by design.
    ``perf_floor`` sets ``TNC_PERF_FLOOR``, the fraction of the expected
    figures the measured ones must reach (0 disables).  ``workload_model``
    (one of :data:`~tpu_node_checker_torch.probe.levels.WORKLOAD_MODELS`)
    sets ``TNC_WORKLOAD_MODEL``, the model the workload level trains: the
    burn-in unless it names ``deepseek-v2-lite``, whose step runs on one
    card.

    With ``distributed=True`` the child joins the rendezvous of one probe
    process per host before enumerating, so the probe sees every host's
    cards and its collectives cross hosts: ``coordinator`` (``host:port``,
    where process 0 hosts the store), ``num_processes`` and ``process_id``
    set ``TNC_COORDINATOR``, ``TNC_NUM_PROCESSES`` and ``TNC_PROCESS_ID``,
    and ``dist_init_timeout_s`` (``TNC_DIST_INIT_TIMEOUT_S``) bounds the
    rendezvous, so an unreachable coordinator or a missing peer fails in the
    child with its cause named.  The kill-timer grows by
    :data:`DISTRIBUTED_EXTRA_TIMEOUT_S` and that bound.  Without
    ``distributed`` none of these variables is set.

    On a timeout the child's whole session is killed, the ranks it spawned
    with it (:func:`_run_child`).

    The child's report carries its spans and counters under ``spans``
    (:mod:`tpu_node_checker_torch.probe.spans`).  Inside a current round
    (the emitter's), the child joins the round's trace, and this side
    places ``probe.spawn``, ``probe.child`` and ``probe.child_exit`` on the
    monotonic clock the two processes share, and times ``emit.parse``.
    """
    if level not in LEVELS:
        raise ValueError(f"unknown probe level {level!r}; expected one of {LEVELS}")
    if timeout_s is None:
        timeout_s = LEVEL_TIMEOUTS_S[level]
    if soak_s > 0:
        # The soak loop spends its budget inside the child by design; the
        # kill-timer must leave room for it on top of the level's own work.
        timeout_s += soak_s
    if distributed:
        # The rendezvous, the peers' start-up and the psum happen on top of
        # the level's own work; without headroom the kill-timer would preempt
        # the child's own error naming the rendezvous.
        timeout_s += DISTRIBUTED_EXTRA_TIMEOUT_S
        if dist_init_timeout_s is not None:
            timeout_s += dist_init_timeout_s
    hostname = os.environ.get("NODE_NAME") or os.uname().nodename
    round_ = spans.current()
    t0 = time.perf_counter()
    child_env = {**os.environ, "PYTHONPATH": _pythonpath(), **spans.child_env(round_)}
    if distributed:
        child_env["TNC_PROBE_DISTRIBUTED"] = "1"
        if coordinator:
            child_env["TNC_COORDINATOR"] = coordinator
        if num_processes is not None:
            child_env["TNC_NUM_PROCESSES"] = str(num_processes)
        if process_id is not None:
            child_env["TNC_PROCESS_ID"] = str(process_id)
        if dist_init_timeout_s is not None:
            child_env["TNC_DIST_INIT_TIMEOUT_S"] = str(dist_init_timeout_s)
    if topology:
        child_env["TNC_TOPOLOGY"] = topology
    if workload_model:
        child_env["TNC_WORKLOAD_MODEL"] = workload_model
    if soak_s > 0:
        child_env["TNC_SOAK_S"] = str(soak_s)
    if perf_floor is not None:
        # Floor fraction override (0 disables); the child defaults to
        # DEFAULT_FLOOR_FRACTION when unset.
        child_env["TNC_PERF_FLOOR"] = str(perf_floor)
    spawn_ns = time.monotonic_ns()
    try:
        proc = _run_child(
            [sys.executable, "-c", _CHILD_SCRIPT, level, str(device), str(timeout_s)],
            timeout=timeout_s,
            env=child_env,
        )
    except subprocess.TimeoutExpired:
        return ProbeResult(
            ok=False,
            level=level,
            hostname=hostname,
            elapsed_ms=round((time.perf_counter() - t0) * 1e3, 1),
            error=f"probe timed out after {timeout_s}s (CUDA init or kernel hang?)",
        )
    reaped_ns = time.monotonic_ns()
    elapsed_ms = round((time.perf_counter() - t0) * 1e3, 1)
    with spans.span("emit.parse"):
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            data = json.loads(line)
        except (json.JSONDecodeError, ValueError):
            return ProbeResult(
                ok=False,
                level=level,
                hostname=hostname,
                elapsed_ms=elapsed_ms,
                error=(
                    f"probe subprocess exited {proc.returncode} without a report: "
                    f"{(proc.stderr or '').strip()[-500:]}"
                ),
            )
        if round_ is not None:
            round_.adopt_child(data.get("spans"), spawn_ns, reaped_ns)
        known = {"ok", "level", "platform", "device_count", "device_kinds", "error"}
        result = ProbeResult(
            ok=bool(data.get("ok")),
            level=level,
            hostname=hostname,
            elapsed_ms=elapsed_ms,
            device_count=int(data.get("device_count") or 0),
            platform=data.get("platform"),
            device_kinds=list(data.get("device_kinds") or []),
            error=data.get("error"),
            details={k: v for k, v in data.items() if k not in known},
        )
    if result.ok and expected_devices is not None and result.device_count < expected_devices:
        result.ok = False
        result.error = (
            f"only {result.device_count}/{expected_devices} expected devices enumerated"
        )
    return result


def _run_child(argv: List[str], *, timeout: float, env: Mapping[str, str]):
    """``subprocess.run(argv, capture_output=True, text=True, ...)`` in a
    session of its own; on a timeout the whole process group is killed.

    The child spawns one rank per extra card, and a rank inside a collective
    would outlive a kill of the child alone by the group's timeout, holding
    its card.  Raises ``subprocess.TimeoutExpired`` (with what the child had
    printed) once every process of the session is killed and the child
    reaped; any other exception kills the group too and propagates.
    """
    with subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env), start_new_session=True,
    ) as proc:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            _kill_session(proc)
            stdout, stderr = proc.communicate()
            raise subprocess.TimeoutExpired(argv, timeout, output=stdout, stderr=stderr)
        finally:
            if proc.returncode is None:  # interrupted while the child runs
                _kill_session(proc)
    return subprocess.CompletedProcess(argv, proc.returncode, stdout, stderr)


def _kill_session(proc: subprocess.Popen) -> None:
    """SIGKILL every process in ``proc``'s group (its pid: a session leader)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass  # the group is already gone


def rendezvous_from_env(env: Mapping[str, str]) -> "Rendezvous":
    """The rendezvous a distributed probe child joins, from the JAX child's
    variables: ``TNC_COORDINATOR`` (``host:port``), ``TNC_NUM_PROCESSES``,
    ``TNC_PROCESS_ID`` and ``TNC_DIST_INIT_TIMEOUT_S`` (seconds; a fraction
    rounds up to a whole second, as the JAX child rounds it, so a
    sub-second bound stays a bound; :data:`DEFAULT_RENDEZVOUS_TIMEOUT_S`
    when unset).  Nothing off a TPU pod names the peers, so the first three
    are required: a missing one raises naming it."""
    from tpu_node_checker_torch.parallel.mesh import Rendezvous

    missing = [v for v in ("TNC_COORDINATOR", "TNC_NUM_PROCESSES", "TNC_PROCESS_ID")
               if not env.get(v)]
    if missing:
        raise ValueError(
            f"TNC_PROBE_DISTRIBUTED=1 needs {', '.join(missing)}: nothing here "
            "autodetects the rendezvous (--probe-coordinator, "
            "--probe-num-processes, --probe-process-id)"
        )
    timeout_s = DEFAULT_RENDEZVOUS_TIMEOUT_S
    if env.get("TNC_DIST_INIT_TIMEOUT_S"):
        timeout_s = float(max(1, math.ceil(float(env["TNC_DIST_INIT_TIMEOUT_S"]))))
    return Rendezvous(
        coordinator=env["TNC_COORDINATOR"],
        num_processes=int(env["TNC_NUM_PROCESSES"]),
        process_id=int(env["TNC_PROCESS_ID"]),
        timeout_s=timeout_s,
    )


def _pythonpath() -> str:
    """The child must import this package for the compute level."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = os.environ.get("PYTHONPATH", "")
    return f"{pkg_root}{os.pathsep}{existing}" if existing else pkg_root
