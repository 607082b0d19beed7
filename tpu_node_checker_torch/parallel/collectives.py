"""Fabric collective probes over ``torch.distributed``, one rank per card.

The port of the JAX package's ``parallel/collectives.py``.  Each function
is collective: every rank of the process group calls it (through
:meth:`tpu_node_checker_torch.parallel.mesh.RankGroup.run`), as every device
runs the JAX ``shard_map`` program.

* :func:`collective_probe`: ``all_reduce`` (psum), ``all_gather_into_tensor``
  (all_gather) and ``reduce_scatter_tensor`` (psum_scatter), each with a
  closed-form expected value;
* :func:`ring_probe`: the ring walked one hop at a time with
  ``batch_isend_irecv``, every link individually, with a single-hop
  diagnostic that names a bad link ``i->i+1``;
* :func:`per_axis_probe`: one ``all_reduce`` along each axis of a rank mesh
  (:class:`~tpu_node_checker_torch.parallel.mesh.RankMesh`), so a fault names
  the torus axis, or the DCN slice boundary, it lies on;
* :func:`axis_bandwidth_probe`: the bus bandwidth of an ``all_reduce``
  along one mesh axis.

Payloads vary by position: rank ``i``'s element ``j`` is ``i + j`` in f32, so
a link that reorders elements inside a payload fails the exact compare, and
every value and closed form stays an integer, exact in f32 below 2^24.  Each
rank checks its own outputs and the mismatch counts are summed with an
``all_reduce``, so every rank holds the same verdict.

On NCCL every leg, the one-rank ring included, goes over NCCL.  Gloo has no
pair from a rank to itself, so on a one-rank gloo group the ring hop is the
identity that JAX's ``ppermute`` over one device is.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from tpu_node_checker_torch.ops._harness import sync
from tpu_node_checker_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    local_device,
    mesh_from_topology,
)


@dataclass
class CollectiveResult:
    ok: bool
    n_devices: int
    latency_us: float
    error: Optional[str] = None
    details: Optional[dict] = None


_COLLECTIVE_LEGS = ("psum", "all_gather", "reduce_scatter")


def _row_major_strides(shape) -> list:
    """Row-major strides: device (c0, c1, …) ↔ linear index Σ cₖ·strideₖ."""
    strides = [1] * len(shape)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    return strides


def _linear_index(coords, strides) -> tuple:
    """(per-axis indices, this rank's linear index as a float)."""
    return list(coords), float(sum(c * s for c, s in zip(coords, strides)))


def _expected_axis_psum(lin, idxs, a, shape, strides, col):
    """Closed form for Σ over axis ``a`` of ``(lin + col)``:
    ``s_a·(lin − c_a·stride_a) + stride_a·s_a(s_a−1)/2 + s_a·col``, shared by
    the per-axis and axis-bandwidth probes."""
    s_a, st_a = shape[a], strides[a]
    return s_a * (lin - idxs[a] * st_a) + st_a * s_a * (s_a - 1) / 2.0 + s_a * col


def _mismatches(out: torch.Tensor, expect: torch.Tensor) -> torch.Tensor:
    return (torch.abs(out - expect) > 1e-3).sum()


def _replicated(counts) -> list:
    """Sum per-rank integer counts over the group: every rank gets the same."""
    t = torch.stack([c.to(torch.int64) for c in counts])
    dist.all_reduce(t)
    return [int(c) for c in t.tolist()]


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """One ring hop along ``group`` (default: every rank): send ``x`` to the
    next rank, return what the previous one sent."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if n == 1 and dist.get_backend(group) == "gloo":
        return x.clone()

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer((i + 1) % n), group),
        dist.P2POp(dist.irecv, out, peer((i - 1) % n), group),
    ]):
        req.wait()
    return out


def collective_probe(
    payload: int = 1024,
    timed_iters: int = 10,
    inject_fault_leg: Optional[str] = None,
) -> CollectiveResult:
    """psum + all_gather + reduce-scatter over the whole group.

    Rank ``i`` contributes ``i + j`` at element ``j``; psum and the
    reduce-scatter shard must yield ``n(n-1)/2 + n·j`` at element ``j`` and
    the gather must return every origin row verbatim.

    ``inject_fault_leg`` perturbs ONE named leg's result, so a run on healthy
    cards shows that a corrupted leg is reported as that leg and only that.
    """
    try:
        if inject_fault_leg is not None and inject_fault_leg not in _COLLECTIVE_LEGS:
            raise ValueError(
                f"inject_fault_leg {inject_fault_leg!r} not one of {_COLLECTIVE_LEGS}"
            )
        dev = local_device()
        n, i = dist.get_world_size(), dist.get_rank()
        col = torch.arange(payload, dtype=torch.float32, device=dev)
        local = (col + float(i))[None, :]  # (1, payload), element j = i + j

        def psum():
            total = local.clone()
            dist.all_reduce(total)
            return total

        def all_gather():
            gathered = torch.empty((n, payload), dtype=torch.float32, device=dev)
            dist.all_gather_into_tensor(gathered, local)
            return gathered

        def reduce_scatter():
            # Every rank contributes the full (n, payload) matrix (every row
            # its own payload) and keeps one reduced row.
            contrib = local.expand(n, payload).contiguous()
            scattered = torch.empty((1, payload), dtype=torch.float32, device=dev)
            dist.reduce_scatter_tensor(scattered, contrib)
            return scattered

        def legs():
            outs = [psum(), all_gather(), reduce_scatter()]
            if inject_fault_leg is not None:
                k = _COLLECTIVE_LEGS.index(inject_fault_leg)
                outs[k] = outs[k] + 1.0  # simulated corruption of that leg
            return outs

        # The verdict covers the first pass of exactly the program timed below.
        total, gathered, scattered = legs()
        exp_red = n * (n - 1) / 2.0 + n * col[None, :]
        exp_gather = torch.arange(n, dtype=torch.float32, device=dev)[:, None] + col[None, :]
        sum_ok, gather_ok, scatter_ok = (
            c == 0 for c in _replicated([
                _mismatches(total, exp_red),
                _mismatches(gathered, exp_gather),
                _mismatches(scattered, exp_red),
            ])
        )

        t0 = time.perf_counter()
        for _ in range(timed_iters):
            legs()
        sync(dev)
        latency_us = (time.perf_counter() - t0) / timed_iters * 1e6

        # Ring all-reduce bus bandwidth, the NCCL busbw convention: each rank
        # moves 2(n-1)/n of its shard per reduction.  The wall time of all
        # three legs is charged to the psum, so the figure is a lower bound.
        # None when there is no fabric: 0.0 would read as a dead one.
        busbw_gbps = None
        if n > 1 and latency_us > 0:
            busbw_gbps = round(
                (2 * (n - 1) / n * payload * 4) / (latency_us * 1e-6) / 1e9, 3
            )

        # Per-leg attribution: each leg timed on its own.
        leg_latency_us = {}
        for leg_name, body in zip(_COLLECTIVE_LEGS, (psum, all_gather, reduce_scatter)):
            body()
            sync(dev)
            t1 = time.perf_counter()
            for _ in range(timed_iters):
                body()
            sync(dev)
            leg_latency_us[leg_name] = round(
                (time.perf_counter() - t1) / timed_iters * 1e6, 1
            )

        ok = sum_ok and gather_ok and scatter_ok
        return CollectiveResult(
            ok=ok,
            n_devices=n,
            latency_us=latency_us,
            error=None
            if ok
            else (
                f"collective mismatch (psum ok={sum_ok}, all_gather ok={gather_ok}, "
                f"reduce_scatter ok={scatter_ok})"
            ),
            details={
                "psum_ok": sum_ok,
                "all_gather_ok": gather_ok,
                "reduce_scatter_ok": scatter_ok,
                "busbw_gbps": busbw_gbps,
                "leg_latency_us": leg_latency_us,
            },
        )
    except Exception as exc:  # probes report, never raise
        return CollectiveResult(
            ok=False, n_devices=0, latency_us=0.0, error=f"{type(exc).__name__}: {exc}"
        )


def ring_probe(
    payload: int = 1 << 20,
    inject_fault_link: Optional[int] = None,
    inject_fault_swap: bool = False,
) -> CollectiveResult:
    """Walk the rank ring one ``batch_isend_irecv`` hop at a time, n hops.

    The default payload is 2^20 f32 elements (4 MiB a hop), so a hop's time
    is the link's and not the launch's.  After n hops every payload is back
    at its origin; a dead or corrupting link breaks the round trip.  When it
    fails, one hop verified on every receiver names the exact link(s)
    ``i->i+1`` whose delivered payload is wrong.

    ``inject_fault_link`` corrupts everything delivered over that link (on
    the receiver); with ``inject_fault_swap`` the corruption swaps the
    payload's first two elements, which keeps the sum and only a
    position-varying payload can see.
    """
    try:
        n, i = dist.get_world_size(), dist.get_rank()
        if inject_fault_link is not None and not 0 <= inject_fault_link < n:
            raise ValueError(
                f"inject_fault_link {inject_fault_link} out of range for {n} links"
            )
        if inject_fault_swap and inject_fault_link is None:
            raise ValueError("inject_fault_swap requires inject_fault_link")
        if inject_fault_swap and payload < 2:
            raise ValueError("inject_fault_swap needs payload >= 2 elements")
        recv = None if inject_fault_link is None else (inject_fault_link + 1) % n
        dev = local_device()
        col = torch.arange(payload, dtype=torch.float32, device=dev)
        local = (col + float(i))[None, :]

        def deliver(carry):
            """One hop, with the chaos corruption on the receiver."""
            out = ring_shift(carry)
            if i == recv:
                if inject_fault_swap:
                    out = out.clone()
                    out[:, [0, 1]] = out[:, [1, 0]]
                else:
                    out = out + 1.0
            return out

        def walk():
            carry = local
            for _ in range(n):
                carry = deliver(carry)
            return carry

        first = walk()
        (bad,) = _replicated([_mismatches(first, local)])
        ok = bad == 0
        t0 = time.perf_counter()
        walk()
        sync(dev)
        latency_us = (time.perf_counter() - t0) * 1e6
        # Every rank pushes its payload one hop per step, n steps: per-hop
        # link bandwidth ≈ payload bytes / (wall time / hops).  None when
        # n == 1: no links exist, and 0.0 would read as a dead one.
        link_gbps = None
        if n > 1 and latency_us > 0:
            link_gbps = round((payload * 4) / (latency_us / n * 1e-6) / 1e9, 3)
        details = {"hops": n, "link_gbps": link_gbps}
        error = None
        if not ok:
            # Localisation: after ONE hop, receiver r must hold origin r-1's
            # payload verbatim; a wrong row names link (r-1)->r.
            expect = col[None, :] + float((i - 1) % n)
            onehot = torch.zeros((n,), dtype=torch.int64, device=dev)
            onehot[i] = _mismatches(deliver(local), expect)
            hop_bad = _replicated(list(onehot))
            bad_links = [f"{(r - 1) % n}->{r}" for r in range(n) if hop_bad[r]]
            details["bad_links"] = bad_links
            where = (
                f"single-hop diagnostic names link(s) {', '.join(bad_links)}"
                if bad_links
                else "single-hop diagnostic clean (multi-hop-only fault)"
            )
            error = f"ring walk did not return payloads to origin; {where}"
        return CollectiveResult(
            ok=ok, n_devices=n, latency_us=latency_us, error=error, details=details,
        )
    except Exception as exc:  # probes report, never raise
        return CollectiveResult(
            ok=False, n_devices=0, latency_us=0.0, error=f"{type(exc).__name__}: {exc}"
        )


def per_axis_probe(
    mesh: Optional[MeshSpec] = None,
    topology: Optional[str] = None,
    payload: int = 256,
    inject_fault_axis: Optional[str] = None,
) -> CollectiveResult:
    """An ``all_reduce`` along EACH axis of a rank mesh: fault localisation
    to a torus dimension, or to the DCN slice boundary of a hybrid mesh.

    The mesh is ``mesh`` (a spec, see :func:`~tpu_node_checker_torch.parallel.mesh.hybrid_spec`)
    or the one ``topology`` describes (one flat ``d`` axis when it describes
    no other).  Rank ``(c0, c1, …)`` contributes its linear index plus the
    element position, and each axis's sum has a closed form, so a wrong sum
    names its axis.  Each rank checks its own sums; the per-axis mismatch
    counts are summed over the group, so the verdict is replicated.

    ``inject_fault_axis`` perturbs the sum along that axis, so a run on
    healthy cards shows that a fault on axis X is reported as X alone.
    """
    try:
        rm = build_mesh(mesh) if mesh is not None else mesh_from_topology(topology)
        axis_names, shape = rm.axis_names, rm.shape
        n = math.prod(shape)
        if payload <= 0:
            raise ValueError(f"payload must be positive, got {payload}")
        if inject_fault_axis is not None and inject_fault_axis not in axis_names:
            # A chaos run that injects nothing would "validate" the harness
            # without testing it (e.g. after a flat-mesh fallback).
            raise ValueError(
                f"inject_fault_axis {inject_fault_axis!r} not in mesh axes {axis_names}"
            )
        strides = _row_major_strides(shape)
        dev = local_device()
        idxs, lin = _linear_index(rm.coords, strides)
        col = torch.arange(payload, dtype=torch.float32, device=dev)
        local = lin + col
        t0 = time.perf_counter()
        bad_counts = []
        for a, name in enumerate(axis_names):
            total = local.clone()
            dist.all_reduce(total, group=rm.groups[name])
            if name == inject_fault_axis:
                total = total + 1.0  # simulated link corruption
            expected = _expected_axis_psum(lin, idxs, a, shape, strides, col)
            bad_counts.append(_mismatches(total, expected))
        bad_counts = _replicated(bad_counts)
        latency_us = (time.perf_counter() - t0) * 1e6
        axis_ok = {name: bad_counts[a] == 0 for a, name in enumerate(axis_names)}
        bad = [f"{name}={shape[a]}" for a, name in enumerate(axis_names) if not axis_ok[name]]
        ok = not bad
        return CollectiveResult(
            ok=ok,
            n_devices=n,
            latency_us=latency_us,
            # "dcn" (hybrid meshes) is the slice boundary, not a torus axis.
            error=None
            if ok
            else (
                "fault localized to "
                + (
                    "the DCN slice boundary"
                    if all(b.startswith("dcn=") for b in bad)
                    else f"mesh axis {', '.join(bad)}"
                )
            ),
            details={"topology": "x".join(str(s) for s in shape), "axis_ok": axis_ok},
        )
    except Exception as exc:  # probes report, never raise
        return CollectiveResult(
            ok=False, n_devices=0, latency_us=0.0, error=f"{type(exc).__name__}: {exc}"
        )


def axis_bandwidth_probe(
    mesh: MeshSpec,
    axis: str,
    payload: int = 1 << 20,
    timed_iters: int = 4,
) -> CollectiveResult:
    """Bus bandwidth of an ``all_reduce`` along ONE named mesh axis.

    Over a hybrid mesh with ``axis="dcn"`` the reduction crosses only the
    slice boundary.  Elements carry ``linear index + (position mod 256)``,
    so every sum is an integer far below 2^24 and exact in f32 even at a
    4 MiB payload.  The first pass is checked against the closed form, with
    the mismatch count summed over the group; the timed passes follow.
    """
    try:
        rm = build_mesh(mesh)
        axis_names, shape = rm.axis_names, rm.shape
        if axis not in axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes {axis_names}")
        n = math.prod(shape)
        a = axis_names.index(axis)
        s_a = shape[a]
        if payload <= 0:
            raise ValueError(f"payload must be positive, got {payload}")
        strides = _row_major_strides(shape)
        dev = local_device()
        idxs, lin = _linear_index(rm.coords, strides)
        col = torch.arange(payload, dtype=torch.float32, device=dev) % 256.0
        local = lin + col
        group = rm.groups[axis]

        def leg():
            total = local.clone()
            dist.all_reduce(total, group=group)
            return total

        expected = _expected_axis_psum(lin, idxs, a, shape, strides, col)
        (bad,) = _replicated([_mismatches(leg(), expected)])
        ok = bad == 0
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed_iters):
            leg()
        sync(dev)
        latency_us = (time.perf_counter() - t0) / timed_iters * 1e6
        busbw_gbps = None
        if s_a > 1 and latency_us > 0:
            busbw_gbps = round(
                (2 * (s_a - 1) / s_a * payload * 4) / (latency_us * 1e-6) / 1e9, 3
            )
        return CollectiveResult(
            ok=ok,
            n_devices=n,
            latency_us=latency_us,
            error=None if ok else f"psum along axis {axis!r} returned wrong sums",
            details={"axis": axis, "axis_size": s_a, "busbw_gbps": busbw_gbps},
        )
    except Exception as exc:  # probes report, never raise
        return CollectiveResult(
            ok=False, n_devices=0, latency_us=0.0, error=f"{type(exc).__name__}: {exc}"
        )
