"""Tensor-core matmul burn-in probe.

* bf16 inputs with f32 accumulation; ``n`` defaults to 2048.
* The timed chain is ``iters`` chained products, each rescaled by 1/sqrt(n)
  and cast back to bf16 so the values stay finite: f32 accumulation, then
  x 1/sqrt(n), then the cast, exactly as the JAX chain steps.  The product is
  a library call (``torch.mm``), as the JAX package leaves it to XLA.
* Correctness is checked with an invariant a second unit verifies cheaply:
  ``trace(A @ A^T) == ||A||_F^2``.  The left side runs on the tensor cores,
  the right side is an elementwise square-reduce.  Disagreement beyond bf16
  tolerance marks the card sick (the gpu-burn pattern).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tpu_node_checker_torch.ops._harness import DeviceLike, resolve_device, sync


@dataclass
class BurnResult:
    ok: bool
    tflops: float
    elapsed_ms: float
    rel_err: float
    n: int
    iters: int
    error: Optional[str] = None


def _mm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """bf16 ``x @ y`` accumulated and returned in f32.

    On the card cuBLAS writes the f32 accumulator out directly
    (``out_dtype``); the CPU build has no such product, so there the bf16
    values are widened first, which is the same f32 accumulation.
    """
    if x.device.type == "cuda":
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.mm(x.float(), y.float())


def _burn_chain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained bf16 products, rescaled each step to stay finite.

    Returns the f32 scalar checksum of the final product; fetching it is the
    completion barrier.
    """
    scale = torch.tensor(float(a.shape[0]), dtype=torch.float32, device=a.device).sqrt().reciprocal()
    x = a
    for _ in range(iters):
        x = (_mm_f32(x, a) * scale).to(a.dtype)
    return x.float().sum()


def _invariant(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(trace(A @ A^T) on the tensor cores, ||A||_F^2 elementwise): must agree."""
    prod = _mm_f32(a, a.t())
    return torch.trace(prod), a.float().square().sum()


def matmul_burn(
    n: int = 2048,
    iters: int = 16,
    device: DeviceLike = None,
    rel_tol: float = 5e-2,
) -> BurnResult:
    """Run the burn on one device (default ``cuda:0``)."""
    try:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
        # The warm-up runs once; the timed run measures steady state.  The
        # scalar fetch after the synchronise is the completion barrier.
        checksum = float(_burn_chain(a, iters).item())
        sync(dev)
        t0 = time.perf_counter()
        checksum = float(_burn_chain(a, iters).item())
        elapsed = time.perf_counter() - t0
        tflops = (2.0 * n * n * n * iters) / elapsed / 1e12
        if not math.isfinite(checksum):
            return BurnResult(
                ok=False, tflops=tflops, elapsed_ms=elapsed * 1e3,
                rel_err=float("inf"), n=n, iters=iters,
                error=f"burn checksum is not finite: {checksum}",
            )

        tc, elementwise = (float(t.item()) for t in _invariant(a))
        rel_err = abs(tc - elementwise) / max(abs(elementwise), 1e-9)
        ok = rel_err < rel_tol and math.isfinite(tc)
        return BurnResult(
            ok=bool(ok),
            tflops=tflops,
            elapsed_ms=elapsed * 1e3,
            rel_err=rel_err,
            n=n,
            iters=iters,
            error=None if ok else f"tensor-core/elementwise invariant mismatch: rel_err={rel_err:.3e}",
        )
    except Exception as exc:  # probes report, never raise
        return BurnResult(
            ok=False, tflops=0.0, elapsed_ms=0.0, rel_err=float("inf"), n=n, iters=iters,
            error=f"{type(exc).__name__}: {exc}",
        )


@dataclass
class SoakResult:
    """Sustained-load acceptance test: loop the burn for a wall-clock budget."""

    ok: bool
    rounds: int
    seconds: float
    tflops_min: float
    tflops_median: float
    tflops_max: float
    sustained_ratio: float  # min/median: collapse under heat shows here
    hbm_gbps_min: float = 0.0
    hbm_gbps_median: float = 0.0
    error: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rounds": self.rounds,
            "seconds": round(self.seconds, 1),
            "tflops_min": round(self.tflops_min, 3),
            "tflops_median": round(self.tflops_median, 3),
            "tflops_max": round(self.tflops_max, 3),
            "sustained_ratio": round(self.sustained_ratio, 3),
            "hbm_gbps_min": round(self.hbm_gbps_min, 3),
            "hbm_gbps_median": round(self.hbm_gbps_median, 3),
            **({"error": self.error} if self.error else {}),
        }


def soak_burn(
    seconds: float,
    n: int = 2048,
    iters: int = 16,
    device: DeviceLike = None,
    min_sustained_ratio: float = 0.5,
    hbm_mib: int = 128,
) -> SoakResult:
    """Node-acceptance soak: alternate the matmul burn and the memory stream
    for ``seconds``.

    One-shot probes miss thermal and power faults that appear only under
    sustained load.  Every round runs the burn (numerics re-checked) and then
    a ``hbm_mib``-MiB streaming pass, so the compute units and the memory
    channels stay loaded for the whole budget.  Verdict: every round clean
    AND the slowest burn round kept at least ``min_sustained_ratio`` of the
    median throughput.  ``hbm_mib=0`` disables the memory leg.
    """
    from tpu_node_checker_torch.ops.hbm import hbm_bandwidth_probe

    try:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        tflops: list = []
        hbm_gbps: list = []
        rounds = 0

        def _stats(ok, ratio, error):
            # Failure and success both carry everything collected so far: the
            # trend up to a failure is the triage data.
            return SoakResult(
                ok=ok,
                rounds=rounds,
                seconds=time.perf_counter() - t_start,
                tflops_min=min(tflops, default=0.0),
                tflops_median=statistics.median(tflops) if tflops else 0.0,
                tflops_max=max(tflops, default=0.0),
                sustained_ratio=ratio,
                hbm_gbps_min=min(hbm_gbps, default=0.0),
                hbm_gbps_median=statistics.median(hbm_gbps) if hbm_gbps else 0.0,
                error=error,
            )

        while time.perf_counter() < deadline or rounds == 0:
            r = matmul_burn(n=n, iters=iters, device=device)
            rounds += 1
            if not r.ok:
                return _stats(False, 0.0, f"round {rounds} burn failed: {r.error}")
            tflops.append(r.tflops)
            if hbm_mib > 0:
                h = hbm_bandwidth_probe(mib=hbm_mib, iters=2, device=device)
                if not h.ok:
                    return _stats(False, 0.0, f"round {rounds} hbm stream failed: {h.error}")
                hbm_gbps.append(h.gbps)

        median = statistics.median(tflops)
        ratio = min(tflops) / median if median > 0 else 0.0
        ok = ratio >= min_sustained_ratio
        return _stats(
            ok,
            ratio,
            None
            if ok
            else (
                f"throughput collapsed under sustained load: min "
                f"{min(tflops):.2f} TFLOP/s is {ratio:.0%} of median {median:.2f}"
            ),
        )
    except Exception as exc:  # probes report, never raise
        return SoakResult(
            ok=False, rounds=0, seconds=0.0, tflops_min=0.0, tflops_median=0.0,
            tflops_max=0.0, sustained_ratio=0.0,
            error=f"{type(exc).__name__}: {exc}",
        )
