"""Per-link sweep: one timed single-pair P2P per link leg of the rank ring.

The port of the JAX package's ``meshprobe/sweep.py``.  The collective probes
grade the whole fabric at once; this sweep takes the rank ring apart into
its link legs: for every hop ``h -> (h+1) mod n`` ONE single-pair
``batch_isend_irecv`` moves a payload across exactly that leg, verified
against a host-side oracle, and its wall time is sampled ``hop_iters``
times into a per-link p50/p99.

Grading is the JAX package's relative ladder: the sweep's own median p50 is
the baseline, the per-link budget is ``max(BUDGET_FLOOR_US, SLOW_FACTOR ×
baseline)``, and a leg is ``SLOW`` past its budget, ``DEAD`` when its
delivered payload is wrong or its p50 passes the hop deadline.  A DEAD leg
fails the probe; a SLOW one degrades it (``ok`` stays True, ``degraded``
set).

The ranks form one flat axis.  Link names are ``axis/hop``, the axis named
as the JAX package names it for the same device count and topology label
(``d`` for a flat ring); a label with more than one dimension is not yet
ported and fails as such.

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
from tpu_node_checker_torch.parallel.mesh import local_device

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


def parse_topology(topology: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Parse a GKE topology label value like ``"2x2x1"`` or ``"16x16"``."""
    if not topology or not isinstance(topology, str):
        return None
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError:
        return None
    return dims if dims and all(d > 0 for d in dims) else None


def qualify_link(domain: Optional[str], link: str) -> str:
    """``slice/axis/hop``: the link's name inside the budget-domain
    namespace (``domain`` is ``_domain_name(slice_group_key(node))``)."""
    return f"{domain}/{link}" if domain else link


def _axis_dims(topology: Optional[str], n_devices: int,
               axis_prefix: str = "t") -> List[Tuple[str, int]]:
    """(axis name, size) pairs exactly as ``mesh_from_topology`` would build
    them — shared by the host-side expectation helpers so a bench assertion
    and the live sweep can never disagree about the link set."""
    dims = parse_topology(topology)
    if dims is not None and math.prod(dims) == n_devices:
        return [(f"{axis_prefix}{i}", d) for i, d in enumerate(dims)]
    return [("d", n_devices)]


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
    """Time every link leg of the rank ring on its own; never raises.

    Collective: every rank of the group calls it.  Rank ``i``'s payload
    element ``j`` is ``i + j`` (exact in f32).  Each leg's first transfer is
    held against the host oracle (the receiver holds the sender's payload
    verbatim, every other rank zeros) and the mismatch counts are summed
    over the group; then ``hop_iters`` samples, each begun after a barrier,
    whose per-sample maximum over the ranks is the leg's time, so every rank
    grades the same numbers.

    ``inject_slow_link="axis:hop"`` scales that leg's samples by
    ``slow_inflation`` (nothing sleeps); ``inject_dead_link`` corrupts the
    payload the leg delivers, on the receiver.  Both validate against the
    live ring and fail loudly on typos.
    """
    t_sweep = time.perf_counter()
    try:
        n, rank = dist.get_world_size(), dist.get_rank()
        dims = _axis_dims(topology, n)
        if len(dims) > 1:
            raise NotImplementedError(
                f"the link sweep over a multi-dim topology ({topology!r}) is not "
                "yet ported to the PyTorch/CUDA probe; only the flat rank ring is"
            )
        ((axis, size),) = dims
        sizes = {axis: size}
        slow = dead = None
        if inject_slow_link is not None:
            slow = _parse_link_spec(inject_slow_link, sizes, "inject_slow_link")
        if inject_dead_link is not None:
            dead = _parse_link_spec(inject_dead_link, sizes, "inject_dead_link")
        legs = [(axis, h) for h in range(size)] if size > 1 else []
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
        for nm, h in legs:
            h_next = (h + 1) % size

            def hop(nm=nm, h=h, h_next=h_next):
                out = torch.zeros_like(local)
                if rank == h:
                    op = dist.P2POp(dist.isend, local, h_next)
                elif rank == h_next:
                    op = dist.P2POp(dist.irecv, out, h)
                else:
                    return out
                for req in dist.batch_isend_irecv([op]):
                    req.wait()
                if dead == (nm, h) and rank == h_next:
                    out = out + 1.0
                return out

            # Host-side oracle for this rank's row: the receiver holds the
            # sender's payload verbatim, every other rank zeros.
            expect = col_np + h if rank == h_next else np.zeros_like(col_np)
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
