"""Pipeline parallelism: a GPipe-style staged forward pass as a fabric probe.

The port of the JAX package's ``parallel/pipeline.py``: the neighbour-link
stressor.  Activations flow strictly rank ``i`` → ``i+1`` every tick, so a
single degraded hop shows up as a numerics mismatch (or a hang) that an
all-reduce could average away.

* Every rank lies on one axis ``pp`` of size ``n``; rank ``s`` holds the
  weights of stage ``s`` (a tanh dense block, so stage order matters).
* The batch is cut into ``M`` microbatches and the schedule runs ``M + n - 1``
  ticks: at tick ``t`` stage 0 takes microbatch ``t`` (while any remain),
  every stage applies its block to what it holds, and the activations move
  one hop along the ``pp`` line (send to the next rank, receive from the
  previous), the GPipe fill and drain.
* The last stage writes each finished microbatch into a zeroed buffer; an
  ``all_reduce`` over ``pp`` replicates the output (every other stage holds
  zeros), to be held against the stages composed in order on the host.

f32 throughout, products at full f32 precision (TF32 must be off on the
card, as it is by default).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from tpu_node_checker_torch.ops._harness import sync
from tpu_node_checker_torch.parallel.collectives import ring_shift
from tpu_node_checker_torch.parallel.mesh import flat_mesh, local_device


# The probe's inputs are drawn from this seed on every rank.
_SEED = 0


@dataclass
class PipelineResult:
    ok: bool
    n_stages: int
    n_microbatches: int
    max_abs_err: float
    latency_ms: float
    error: Optional[str] = None
    details: Optional[dict] = None


def pipeline_forward(
    w: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    inject_fault_stage: Optional[int] = None,
    with_checksums: bool = False,
):
    """The pipelined forward over the ``pp`` line of every rank.

    Collective.  ``w`` (d, d) and ``b`` (d,) are this rank's stage; ``x``
    (M, B, d) is the microbatched input, the same on every rank.  Returns
    the output (M, B, d), equal to ``tanh(x @ w_s + b_s)`` applied for
    s = 0..n-1 in order, on every rank.

    ``with_checksums=True`` also returns the (n,) per-stage checksums
    (Σ|y| over each stage's valid ticks, fill and drain excluded), the same
    on every rank; ``inject_fault_stage`` adds 1 to that stage's output.
    """
    mesh = flat_mesh("pp")
    group = mesh.groups["pp"]
    n, i = mesh.size("pp"), mesh.index("pp")
    if inject_fault_stage is not None and not 0 <= inject_fault_stage < n:
        raise ValueError(
            f"inject_fault_stage {inject_fault_stage} out of range for {n} stages"
        )
    M, B, d = x.shape
    state = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    outbuf = torch.zeros((M, B, d), dtype=torch.float32, device=x.device)
    chk = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + n - 1):
        # Stage 0 takes microbatch t while any remain; the others what the
        # previous hop delivered.
        cur = x[t] if i == 0 and t < M else state
        y = torch.tanh(cur @ w + b)
        if i == inject_fault_stage:
            y = y + 1.0  # simulated stage corruption, carried downstream
        # Stage i works on microbatch t - i; outside [0, M) it chews fill or
        # drain garbage that never reaches the output, nor the checksum.
        if 0 <= t - i < M:
            chk = chk + y.abs().sum()
        # The last stage finishes microbatch t - (n - 1) at tick t.
        if i == n - 1 and t - (n - 1) >= 0:
            outbuf[t - (n - 1)] = y
        state = ring_shift(y, group)
    # Only the last stage wrote non-zeros: the sum replicates the output.
    dist.all_reduce(outbuf, group=group)
    if not with_checksums:
        return outbuf
    stage_chk = torch.zeros((n,), dtype=torch.float32, device=x.device)
    stage_chk[i] = chk
    dist.all_reduce(stage_chk, group=group)
    return outbuf, stage_chk


def pipeline_sharded(w, b, x, inject_fault_stage: Optional[int] = None):
    """The pipelined forward of host arrays or CPU tensors holding every
    stage, ``w`` (n, d, d) and ``b`` (n, d), with input ``x`` (M, B, d):
    this rank takes its stage, and every rank returns ``(output,
    per-stage checksums)`` on the CPU.  Collective."""
    i, dev = dist.get_rank(), local_device()
    w, b, x = (torch.as_tensor(a) for a in (w, b, x))
    out, chk = pipeline_forward(
        w[i].to(dev), b[i].to(dev), x.to(dev),
        inject_fault_stage=inject_fault_stage, with_checksums=True,
    )
    return out.cpu(), chk.cpu()


def reference_pipeline(w, b, x, with_checksums: bool = False):
    """The stages composed in order on one device: the ground truth.  With
    ``with_checksums`` also the per-stage Σ|activation| vector."""
    M, B, d = x.shape
    out = x.reshape(M * B, d)
    chks = []
    for s in range(w.shape[0]):
        out = torch.tanh(out @ w[s] + b[s])
        chks.append(out.abs().sum())
    out = out.reshape(M, B, d)
    if with_checksums:
        return out, torch.stack(chks)
    return out


def pipeline_probe(
    n_microbatches: int = 4,
    batch: int = 2,
    d_model: int = 32,
    rtol: float = 1e-3,
    inject_fault_stage: Optional[int] = None,
) -> PipelineResult:
    """Run the pipelined forward over the group and hold it against the
    sequential reference, computed on the host.

    Every rank draws the same inputs from a ``torch.Generator`` seeded with
    ``_SEED`` and takes its own stage.  The output and the checksums are
    replicated, so every rank grades the same.  On a mismatch the FIRST
    stage whose checksum disagrees with the reference's is where the
    corruption entered the pipe (everything downstream is poisoned by it),
    which names a stage, hence a card and its incoming hop.
    """
    try:
        dev = local_device()
        n = dist.get_world_size()
        gen = torch.Generator().manual_seed(_SEED)
        # Scaled so tanh stays away from saturation and each stage's signal
        # survives n compositions.
        w = torch.randn((n, d_model, d_model), generator=gen) / d_model ** 0.5
        b = torch.randn((n, d_model), generator=gen) * 0.1
        x = torch.randn((n_microbatches, batch, d_model), generator=gen)
        pipeline_sharded(w, b, x, inject_fault_stage)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        out, stage_chk = pipeline_sharded(w, b, x, inject_fault_stage)
        latency_ms = (time.perf_counter() - t0) * 1e3

        ref, ref_chk = reference_pipeline(w, b, x, with_checksums=True)
        max_abs_err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=rtol, atol=rtol))
        details = None
        error = None
        if not ok:
            # The checksum tolerance scales with magnitude: Σ|y| over M·B·d terms.
            scale = ref_chk.abs().clamp_min(1.0)
            bad = torch.nonzero((stage_chk - ref_chk).abs() > rtol * scale).flatten()
            first_bad = int(bad[0]) if bad.numel() else None
            details = {
                "stage_checksums": [round(float(c), 4) for c in stage_chk],
                "first_bad_stage": first_bad,
            }
            where = (
                f"corruption entered at stage {first_bad}"
                if first_bad is not None
                else "stage checksums clean (output-combine fault)"
            )
            error = f"pipeline mismatch: max|Δ|={max_abs_err:.3e}; {where}"
        return PipelineResult(
            ok=ok,
            n_stages=n,
            n_microbatches=n_microbatches,
            max_abs_err=max_abs_err,
            latency_ms=latency_ms,
            error=error,
            details=details,
        )
    except Exception as exc:  # probes report, never raise
        return PipelineResult(
            ok=False,
            n_stages=0,
            n_microbatches=0,
            max_abs_err=float("inf"),
            latency_ms=0.0,
            error=f"{type(exc).__name__}: {exc}",
        )
