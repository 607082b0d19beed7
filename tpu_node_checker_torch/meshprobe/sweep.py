"""Per-link sweep: one timed single-pair P2P per link leg of the rank mesh.

The port of the JAX package's ``meshprobe/sweep.py``.  The collective probes
grade the whole fabric at once; this sweep takes the rank mesh apart into
its link legs: for every axis and every hop ``h -> (h+1) mod s`` along it,
ONE ``batch_isend_irecv`` moves a payload across that leg in every line of
the axis at once (the rank at coordinate ``h`` of each line sends to the
rank at ``h+1``), verified on the receivers against a host-side oracle, and
its wall time is sampled ``hop_iters`` times into a per-link p50/p99.

Grading is the JAX package's relative ladder: the sweep's own median p50 is
the baseline, the per-link budget is ``max(BUDGET_FLOOR_US, SLOW_FACTOR ×
baseline)``, and a leg is ``SLOW`` past its budget, ``DEAD`` when its
delivered payload is wrong or its p50 passes the hop deadline.  A DEAD leg
fails the probe; a SLOW one degrades it (``ok`` stays True, ``degraded``
set).

The mesh is the one a topology label describes
(:func:`~tpu_node_checker_torch.parallel.mesh.mesh_from_topology`: ``"2x4"``
gives axes t0 and t1, anything that does not match the rank count one flat
axis ``d``), and link names are ``axis/hop``, as the JAX package names them.

The constants and the helpers up to :func:`_parse_link_spec` are copies of
the JAX package's (which this package does not import); tests hold them
equal.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_node_checker_torch.ops._harness import sync
from tpu_node_checker_torch.parallel.collectives import _row_major_strides
from tpu_node_checker_torch.parallel.mesh import (
    local_device,
    mesh_from_topology,
    parse_topology,
    topology_spec,
)

OK = "OK"
SLOW = "SLOW"
DEAD = "DEAD"
VERDICTS = (OK, SLOW, DEAD)

DEFAULT_PAYLOAD = 4096
DEFAULT_HOP_ITERS = 5
# Relative grading ladder: budget = max(floor, factor × sweep-median p50).
# The floor absorbs scheduler noise on µs-scale CPU hops; the factor is wide
# enough that only a genuinely sick leg (not cache weather) crosses it.
BUDGET_FLOOR_US = 50.0
SLOW_FACTOR = 8.0
# Absolute per-hop deadline: a leg this slow is indistinguishable from dead
# for any workload that deadline-schedules collectives.  (A leg that HANGS
# never returns a sample at all — the probe child's kill-timer owns that.)
HOP_DEADLINE_US = 5_000_000.0
# Chaos inflation for inject_slow_link: measured samples are scaled, no real
# sleep — deterministic under test clocks and far past SLOW_FACTOR while
# staying well under the hop deadline on µs-scale healthy legs.
CHAOS_SLOW_INFLATION = 1000.0


@dataclass
class MeshLinkReport:
    """Outcome of one sweep; ``links`` preserves sweep order."""

    ok: bool
    degraded: bool
    n_devices: int
    topology: Optional[str]
    n_links: int
    links: Dict[str, dict] = field(default_factory=dict)
    slow: List[str] = field(default_factory=list)
    dead: List[str] = field(default_factory=list)
    latency_us: float = 0.0
    error: Optional[str] = None


def qualify_link(domain: Optional[str], link: str) -> str:
    """``slice/axis/hop``: the link's name inside the budget-domain
    namespace (``domain`` is ``_domain_name(slice_group_key(node))``)."""
    return f"{domain}/{link}" if domain else link


def _axis_dims(topology: Optional[str], n_devices: int,
               axis_prefix: str = "t") -> List[Tuple[str, int]]:
    """(axis name, size) pairs exactly as ``mesh_from_topology`` would build
    them — shared by the host-side expectation helpers so a bench assertion
    and the live sweep can never disagree about the link set."""
    return list(topology_spec(topology, n_devices, axis_prefix).axes)


def link_names(topology: Optional[str], n_devices: int) -> List[str]:
    """Deterministic sweep-order link names for a device set."""
    return [
        f"{nm}/{h}"
        for nm, s in _axis_dims(topology, n_devices)
        if s > 1
        for h in range(s)
    ]


def expected_link_count(topology: Optional[str], n_devices: int) -> int:
    """Topology-derived link-leg count (``2x4`` → 2 + 4 = 6; flat ring of
    n → n; a single device has no links)."""
    return len(link_names(topology, n_devices))


def _quantile(samples: List[float], q: float) -> float:
    xs = sorted(samples)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def _parse_link_spec(spec, sizes: Dict[str, int], what: str) -> Tuple[str, int]:
    """Validate an ``axis:hop`` injection spec against the live mesh — a
    typo'd axis or out-of-range hop must fail loudly, never inject nothing
    silently (the chaos-hook contract shared with the collective probes)."""
    axis, sep, hop = str(spec).partition(":")
    if not sep:
        raise ValueError(f"{what} {spec!r} must be 'axis:hop' (e.g. 't0:1')")
    if axis not in sizes:
        raise ValueError(
            f"{what} axis {axis!r} not one of mesh axes {sorted(sizes)}"
        )
    if sizes[axis] < 2:
        raise ValueError(f"{what} axis {axis!r} has no links (size 1)")
    try:
        h = int(hop)
    except ValueError:
        raise ValueError(f"{what} hop {hop!r} is not an integer")
    if not 0 <= h < sizes[axis]:
        raise ValueError(
            f"{what} hop {h} out of range for axis {axis!r} "
            f"(size {sizes[axis]})"
        )
    return axis, h


def mesh_link_sweep(
    topology: Optional[str] = None,
    payload: int = DEFAULT_PAYLOAD,
    hop_iters: int = DEFAULT_HOP_ITERS,
    inject_slow_link: Optional[str] = None,
    inject_dead_link: Optional[str] = None,
    slow_inflation: float = CHAOS_SLOW_INFLATION,
    hop_deadline_us: float = HOP_DEADLINE_US,
) -> MeshLinkReport:
    """Time every link leg of the rank mesh on its own; never raises.

    Collective: every rank of the group calls it.  The rank at linear index
    ``i`` (its rank) sends element ``j`` as ``i + j`` (exact in f32).  Each
    leg's first transfer is held against the host oracle (every receiver
    holds its sender's payload verbatim, every other rank zeros) and the
    mismatch counts are summed over the group; then ``hop_iters`` samples,
    each begun after a barrier, whose per-sample maximum over the ranks is
    the leg's time, so every rank grades the same numbers.

    ``inject_slow_link="axis:hop"`` scales that leg's samples by
    ``slow_inflation`` (nothing sleeps); ``inject_dead_link`` corrupts the
    payload the leg delivers, on the receivers.  Both validate against the
    live mesh and fail loudly on typos.
    """
    t_sweep = time.perf_counter()
    try:
        mesh = mesh_from_topology(topology)
        rank = dist.get_rank()
        axis_names, shape = mesh.axis_names, mesh.shape
        sizes = dict(zip(axis_names, shape))
        strides = _row_major_strides(shape)
        n = math.prod(shape)
        slow = dead = None
        if inject_slow_link is not None:
            slow = _parse_link_spec(inject_slow_link, sizes, "inject_slow_link")
        if inject_dead_link is not None:
            dead = _parse_link_spec(inject_dead_link, sizes, "inject_dead_link")
        legs = [
            (nm, h, pos)
            for pos, nm in enumerate(axis_names)
            if sizes[nm] > 1
            for h in range(sizes[nm])
        ]
        report = MeshLinkReport(
            ok=True,
            degraded=False,
            n_devices=n,
            topology=topology if parse_topology(topology) else None,
            n_links=len(legs),
        )
        if not legs:
            report.latency_us = (time.perf_counter() - t_sweep) * 1e6
            return report

        dev = local_device()
        col_np = np.arange(payload, dtype=np.float32)
        local = torch.from_numpy(col_np + rank).to(dev)[None, :]
        measured: Dict[str, dict] = {}
        for nm, h, pos in legs:
            h_next = (h + 1) % sizes[nm]
            coord = mesh.coords[pos]
            # The peers along this axis, in this rank's line.
            step = (h_next - h) * strides[pos]

            def hop(nm=nm, h=h, h_next=h_next, coord=coord, step=step):
                out = torch.zeros_like(local)
                if coord == h:
                    op = dist.P2POp(dist.isend, local, rank + step)
                elif coord == h_next:
                    op = dist.P2POp(dist.irecv, out, rank - step)
                else:
                    return out
                for req in dist.batch_isend_irecv([op]):
                    req.wait()
                if dead == (nm, h) and coord == h_next:
                    out = out + 1.0
                return out

            # Host-side oracle for this rank's row: a receiver holds its
            # sender's payload verbatim, every other rank zeros.
            expect = col_np + (rank - step) if coord == h_next else np.zeros_like(col_np)
            dist.barrier()
            first = hop()
            bad = (torch.abs(first - torch.from_numpy(expect).to(dev)) > 1e-3).sum()
            dist.all_reduce(bad)
            mismatches = int(bad)
            samples = torch.zeros((max(1, hop_iters),), dtype=torch.float64)
            for s in range(samples.numel()):
                dist.barrier()
                t0 = time.perf_counter()
                hop()
                sync(dev)
                samples[s] = (time.perf_counter() - t0) * 1e6
            samples = samples.to(dev)
            dist.all_reduce(samples, op=dist.ReduceOp.MAX)
            samples = samples.tolist()
            if slow == (nm, h):
                samples = [s * slow_inflation for s in samples]
            measured[f"{nm}/{h}"] = {
                "p50_us": _quantile(samples, 0.5),
                "p99_us": _quantile(samples, 0.99),
                "mismatches": mismatches,
            }

        # Grade AFTER the whole sweep: the budget derives from the sweep's
        # own median, so one sick leg cannot move its own yardstick.
        baseline = _quantile([m["p50_us"] for m in measured.values()], 0.5)
        budget_us = max(BUDGET_FLOOR_US, SLOW_FACTOR * baseline)
        for link, m in measured.items():
            if m["mismatches"] or m["p50_us"] > hop_deadline_us:
                verdict = DEAD
            elif m["p50_us"] > budget_us:
                verdict = SLOW
            else:
                verdict = OK
            report.links[link] = {
                "verdict": verdict,
                "p50_us": round(m["p50_us"], 1),
                "p99_us": round(m["p99_us"], 1),
                "budget_us": round(budget_us, 1),
            }
            if verdict == SLOW:
                report.slow.append(link)
            elif verdict == DEAD:
                report.dead.append(link)
        report.degraded = bool(report.slow)
        if report.dead:
            report.ok = False
            report.error = (
                f"mesh link sweep: {len(report.dead)} dead link leg(s): "
                f"{', '.join(report.dead)}"
            )
        report.latency_us = (time.perf_counter() - t_sweep) * 1e6
        return report
    except Exception as exc:  # probes report, never raise
        return MeshLinkReport(
            ok=False,
            degraded=False,
            n_devices=0,
            topology=topology,
            n_links=0,
            latency_us=(time.perf_counter() - t_sweep) * 1e6,
            error=f"{type(exc).__name__}: {exc}",
        )
