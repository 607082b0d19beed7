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
  the label describes; with ``TNC_CHAOS_SLICES=N``, the same over a DCN ×
  per-slice mesh, so a fault names the slice boundary or a torus axis;
* ``mesh``: the link doctor (:mod:`tpu_node_checker_torch.meshprobe`), every
  link leg of every mesh axis timed on its own with an ``OK | SLOW | DEAD``
  verdict; SLOW legs degrade the node (``mesh_degraded``) without failing
  it;
* ``workload``: a training step, sharded data × model over the cards where
  the batch splits (else on one card, with the flash-attention kernel in
  its forward pass; :mod:`tpu_node_checker_torch.models`), ring attention
  over the ranks, and on more than one card a pipeline and an
  expert-parallel layer.

Distributed probing (``TNC_PROBE_DISTRIBUTED=1``) is not ported yet and
fails as such (:func:`not_yet_ported`), rather than running on one host
silently.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional

from tpu_node_checker_torch.probe.levels import (  # noqa: F401 — re-exported API
    DEFAULT_TIMEOUT_S,
    LEVEL_TIMEOUTS_S,
    LEVELS,
)

# The child is a standalone -c program (not a fork), so the caller never
# initialises CUDA and a wedged card cannot leak into it.
_CHILD_SCRIPT = r"""
import json, os, sys, time
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


t0 = time.perf_counter()
hbm_capacity_error = None
group = None
try:
    from tpu_node_checker_torch.probe.liveness import not_yet_ported
    _unported = not_yet_ported(os.environ)
    if _unported:
        raise NotImplementedError(_unported)
    if level not in PORTED_LEVELS:
        raise NotImplementedError(
            f"probe level {level!r} is not yet ported to the PyTorch/CUDA "
            f"probe (ported: {', '.join(PORTED_LEVELS)})"
        )
    import torch
    from tpu_node_checker_torch.ops._harness import resolve_device
    # cuda:0 unless the caller asked for the CPU; an absent card raises here.
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        n_dev = torch.cuda.device_count()
        out["platform"] = "gpu"
        out["device_kinds"] = sorted({torch.cuda.get_device_name(i) for i in range(n_dev)})
    else:
        n_dev = 1
        out["platform"] = "cpu"
        out["device_kinds"] = ["cpu"]
    out["local_device_count"] = n_dev
    out["device_count"] = n_dev
    out["process_index"] = 0
    out["process_count"] = 1
    out["ok"] = n_dev > 0
    mem = []         # report surface: devices exposing at least one stat
    mem_graded = []  # grading surface: EVERY local device, so a card whose
                     # memory query raises is graded as a None-limit entry
    for i in range(n_dev if on_card else 0):
        try:
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
        from tpu_node_checker_torch import ops
        if on_card:
            # Build the three kernels at once, one nvcc each, before timing.
            from tpu_node_checker_torch.ops import _build
            _build.build_all()
        # Round-trip overhead of one trivial launch plus its scalar fetch:
        # telemetry for triage, and the gate deciding whether wall-clock
        # figures may be floor-graded.
        _x = torch.zeros((), device=dev)
        float((_x + 1.0).item())
        _t0 = time.perf_counter()
        for _ in range(3):
            float((_x + 1.0).item())
        out["dispatch_overhead_ms"] = round((time.perf_counter() - _t0) / 3 * 1e3, 2)
        # Card sizing, as the JAX child sizes for its accelerator: on-device
        # time must dominate launch overhead.
        burn = ops.matmul_burn(iters=64, device=dev) if on_card else ops.matmul_burn(device=dev)
        out["matmul_tflops"] = round(burn.tflops, 3)
        out["matmul_ok"] = burn.ok
        hbm = ops.hbm_bandwidth_probe(device=dev)
        out["hbm_gbps"] = round(hbm.gbps, 2)
        out["hbm_ok"] = hbm.ok
        pallas = ops.pallas_matmul_probe(device=dev)
        out["pallas_ok"] = pallas.ok
        i8_gate = True
        if os.environ.get("TNC_SKIP_INT8") == "1":
            # Operator escape hatch; skipping is visible, never silent.
            out["int8_skipped"] = True
        else:
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
            fa = ops.flash_attention_probe(seq=256, device=dev)
            out["flash_attention_ok"] = fa.ok
            fa_gate = fa.ok
            if not fa.ok:
                out["flash_attention_err"] = fa.error
                out["flash_attention_max_abs_err"] = fa.max_abs_err
        dma = ops.dma_stream_probe(device=dev)
        out["dma_ok"] = dma.ok
        out["dma_gbps"] = round(dma.gbps, 2)
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
            soak = ops.soak_burn(
                soak_s,
                device=dev,
                min_sustained_ratio=float(os.environ.get("TNC_SOAK_MIN_RATIO") or 0.5),
                hbm_mib=int(os.environ.get("TNC_SOAK_HBM_MIB") or 128),
            )
            out["soak"] = soak.to_dict()
            out["ok"] = out["ok"] and soak.ok
    if level in ("collective", "mesh", "workload") and out["ok"]:
        from tpu_node_checker_torch.parallel import RankGroup, collective_probe, fold, ring_probe
        from tpu_node_checker_torch.probe.levels import LEVEL_TIMEOUTS_S
        if "ring_link" in chaos:
            try:
                chaos["ring_link"] = int(chaos["ring_link"])
            except ValueError:
                raise ValueError(
                    f"TNC_CHAOS_RING_LINK {chaos['ring_link']!r} is not an "
                    "integer link index"
                )
        # One rank per card, rank 0 this process; the ranks serve the mesh
        # and workload blocks too.  Half the level's budget bounds every
        # collective, so a hung one fails inside the kill-timer.
        group = RankGroup(n_dev if on_card else 1, dev.type, timeout_s=LEVEL_TIMEOUTS_S[level] / 2)
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
        n_slices = 0
        if "slices" in chaos:
            # Rehearsal partition: the local cards as N DCN-joined slices,
            # so the whole fault-domain path runs on one host.
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
except Exception as exc:  # the whole point is to catch anything
    # ok may already be True from a completed earlier stage; a crash anywhere
    # is a failed probe.
    out["ok"] = False
    out["error"] = f"{type(exc).__name__}: {exc}"
finally:
    if group is not None:
        group.close()
if level != "enumerate" and "tpu_node_checker_torch.ops" in sys.modules:
    # Which hand-written kernels ran, the training step's included (all 0 on
    # the CPU, where the plain versions stand in for them).
    out["kernel_launches"] = sys.modules["tpu_node_checker_torch.ops"].launch_counts()
out["elapsed_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
print(json.dumps(out, default=lambda o: o.item() if hasattr(o, "item") else str(o)))
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
) -> ProbeResult:
    """Probe this host's cards in a child process; never raises on a probe
    failure.

    ``device`` is ``cuda:0`` unless the caller asks for ``cpu`` (the tests
    do); a missing card fails the probe and the error names CUDA.
    ``expected_devices`` (e.g. a node's ``nvidia.com/gpu`` allocatable count)
    turns a *partial* enumeration into a failure.  ``timeout_s=None`` picks
    the per-level budget from :data:`LEVEL_TIMEOUTS_S`.  The child reads the
    JAX child's ``TNC_*`` settings (floors, chaos, skips, soak, topology)
    from the environment.  What :func:`not_yet_ported` names fails as such.
    """
    if level not in LEVELS:
        raise ValueError(f"unknown probe level {level!r}; expected one of {LEVELS}")
    if timeout_s is None:
        timeout_s = LEVEL_TIMEOUTS_S[level]
    hostname = os.environ.get("NODE_NAME") or os.uname().nodename
    t0 = time.perf_counter()
    child_env = {**os.environ, "PYTHONPATH": _pythonpath()}
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD_SCRIPT, level, str(device)],
            capture_output=True,
            text=True,
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
    elapsed_ms = round((time.perf_counter() - t0) * 1e3, 1)
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
    known = {"ok", "level", "platform", "device_count", "device_kinds", "error", "elapsed_ms"}
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


def not_yet_ported(env: Mapping[str, str]) -> Optional[str]:
    """Why this probe cannot run here, or None when it can.

    Distributed probing (``TNC_PROBE_DISTRIBUTED=1``, one global mesh over
    several hosts) is not ported yet; asked for, it fails with this message
    at any level instead of probing one host silently."""
    if env.get("TNC_PROBE_DISTRIBUTED") == "1":
        return (
            "distributed probing (TNC_PROBE_DISTRIBUTED=1) is not yet ported "
            "to the PyTorch/CUDA probe; use the JAX package's probe"
        )
    return None


def _pythonpath() -> str:
    """The child must import this package for the compute level."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = os.environ.get("PYTHONPATH", "")
    return f"{pkg_root}{os.pathsep}{existing}" if existing else pkg_root
