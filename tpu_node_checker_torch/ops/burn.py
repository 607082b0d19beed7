"""Tensor-core matmul burn-in probe.

* bf16 inputs with f32 accumulation; ``n`` defaults to 2048.
* The timed chain is ``iters`` chained products, each rescaled by 1/sqrt(n)
  and cast back to bf16 so the values stay finite: f32 accumulation, then
  x 1/sqrt(n), then the cast, exactly as the JAX chain steps.  On the card
  each product is one kernel written by hand for Hopper
  (:func:`burn_product`, ``csrc/burn_chain.cu``: wgmma bf16, the rescale and
  the cast in its epilogue), the chain ping-ponging between two bf16
  buffers; the CPU runs the plain product, rescale and cast
  (:func:`burn_product_reference`), as the JAX package leaves the chain to
  XLA.
* On the card the chain is captured once as a CUDA graph and replayed: one
  launch for the whole chain, as the JAX chain is one compiled program.
  CUDA events time the replay on the device, so a host that stalls while it
  issues work does not read as a slow card (the soak grades the slowest
  round, and per-product launches from an eager loop let a busy host set
  that round's time).
* Correctness is checked with an invariant a second unit verifies cheaply:
  ``trace(A @ A^T) == ||A||_F^2``.  The left side is one library product on
  the tensor cores, the right side an elementwise square-reduce.
  Disagreement beyond bf16 tolerance marks the card sick (the gpu-burn
  pattern).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from tpu_node_checker_torch.ops import _build
from tpu_node_checker_torch.ops._harness import DeviceLike, chain_clock, resolve_device, sync
from tpu_node_checker_torch.probe import spans


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


ALIGN = 8  # the kernel takes M, N and K in multiples of 8 (16-byte rows for TMA)


def burn_product_reference(x: torch.Tensor, a: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of one chain product: ``x @ a`` in f32, x ``scale``,
    cast to ``x``'s dtype."""
    return (_mm_f32(x, a) * scale).to(x.dtype)


def burn_product(
    x: torch.Tensor, a: torch.Tensor, scale: float, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``bf16(scale * (x @ a))`` for bf16 ``x`` (M, K) and ``a`` (K, N):
    f32 sums over the whole K in one order, x ``scale`` in f32, one
    round-to-nearest-even to bf16.

    CUDA tensors launch the kernel into ``out`` (a new tensor when None):
    M, N and K positive multiples of 8, both inputs contiguous and 16-byte
    aligned, ``out`` (M, N) bf16, contiguous and apart from both; anything
    else raises.  CPU tensors take the plain version.  Nothing falls back.
    """
    if x.dim() != 2 or a.dim() != 2 or x.shape[1] != a.shape[0]:
        raise ValueError(f"burn_product needs (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(a.shape)}")
    if x.device != a.device:
        raise ValueError(f"burn_product inputs on {x.device} and {a.device}")
    if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16:
        raise TypeError(f"burn_product takes bf16, got {x.dtype} and {a.dtype}")
    if x.device.type == "cpu":
        ref = burn_product_reference(x, a, scale)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"burn_product runs on cuda (kernel) or cpu (plain), not {x.device}")
    (M, K), N = x.shape, a.shape[1]
    if min(M, K, N) <= 0 or M % ALIGN or K % ALIGN or N % ALIGN:
        raise ValueError(f"shape ({M},{K},{N}) not supported by the burn product kernel: "
                         f"M, N and K must be positive multiples of {ALIGN}")
    if not (x.is_contiguous() and a.is_contiguous()) or x.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError("burn_product kernel takes contiguous, 16-byte aligned inputs")
    if out is None:
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    elif (out.shape != (M, N) or out.dtype != torch.bfloat16 or out.device != x.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"burn_product out must be a contiguous, 16-byte aligned ({M},{N}) "
                         f"bf16 tensor on {x.device}, got {tuple(out.shape)} {out.dtype}")
    if out.untyped_storage().data_ptr() in (x.untyped_storage().data_ptr(),
                                            a.untyped_storage().data_ptr()):
        raise ValueError("burn_product out must not share memory with its inputs")
    _build.launch("burn_chain", x.device, x.data_ptr(), a.data_ptr(), out.data_ptr(), M, N, K,
                  scale)
    return out


def _burn_chain(a: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained bf16 products, rescaled each step to stay finite.

    Returns the f32 scalar checksum of the final product; fetching it is the
    completion barrier.  The scale is the f32 value JAX computes, held as a
    host scalar: no copy to the card, so the chain can be captured.  On the
    card every product is one launch of :func:`burn_product`, alternating
    between two buffers made once for the chain; the CPU chains the plain
    products.
    """
    scale = torch.tensor(float(a.shape[0]), dtype=torch.float32).sqrt().reciprocal().item()
    x = a
    if a.device.type != "cuda":
        for _ in range(iters):
            x = burn_product_reference(x, a, scale)
        return x.float().sum()
    bufs = [torch.empty(a.shape, dtype=a.dtype, device=a.device) for _ in range(2)]
    for i in range(iters):
        x = burn_product(x, a, scale, out=bufs[i % 2])
    return x.float().sum()


def _chain_runner(a: torch.Tensor, iters: int) -> Callable[[], Tuple[float, float]]:
    """A function that runs the chain once and returns (checksum, seconds).

    The chain's clock is :func:`chain_clock`: on the card the chain is
    captured here, once, as a CUDA graph (one product run first on a side
    stream, which builds and loads the kernel outside the capture), and each
    run replays the graph between two CUDA events; on the CPU it runs the
    chain eagerly on the host clock.
    """
    run = chain_clock(lambda: _burn_chain(a, iters), lambda: _burn_chain(a, 1), a.device, "burn")

    def checksum_run() -> Tuple[float, float]:
        out, seconds = run()
        return float(out.item()), seconds
    return checksum_run


def _burn_input(n: int, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    sync(dev)
    return a


def _invariant(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(trace(A @ A^T) by one library product on the tensor cores, ||A||_F^2
    elementwise): must agree."""
    prod = _mm_f32(a, a.t())
    return torch.trace(prod), a.float().square().sum()


def _raised(exc: Exception, n: int, iters: int) -> BurnResult:
    return BurnResult(
        ok=False, tflops=0.0, elapsed_ms=0.0, rel_err=float("inf"), n=n, iters=iters,
        error=f"{type(exc).__name__}: {exc}",
    )


def _burn_round(
    a: torch.Tensor, run: Callable[[], Tuple[float, float]], iters: int, rel_tol: float,
) -> BurnResult:
    """One burn: a warm-up run, the timed run, then the invariant check."""
    n = a.shape[0]
    try:
        run()
        checksum, elapsed = run()
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
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return _raised(exc, n, iters)


def matmul_burn(
    n: int = 2048,
    iters: int = 16,
    device: DeviceLike = None,
    rel_tol: float = 5e-2,
) -> BurnResult:
    """Run the burn on one device (default ``cuda:0``)."""
    try:
        a = _burn_input(n, resolve_device(device))
        run = _chain_runner(a, iters)
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return _raised(exc, n, iters)
    return _burn_round(a, run, iters, rel_tol)


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
    median throughput.  ``hbm_mib=0`` disables the memory leg.  The chain is
    captured once for the whole soak (on the card, one CUDA graph), as the
    JAX chain is compiled once and rerun.

    Each round is a ``soak.round`` span of the probe round's trace, holding
    ``soak.burn`` and ``soak.stream``, and counts one ``soak_rounds``.
    """
    from tpu_node_checker_torch.ops.hbm import hbm_bandwidth_probe

    try:
        a = _burn_input(n, resolve_device(device))
        run = _chain_runner(a, iters)
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
            with spans.span("soak.round"):
                with spans.span("soak.burn"):
                    r = _burn_round(a, run, iters, rel_tol=5e-2)
                rounds += 1
                spans.count("soak_rounds")
                if not r.ok:
                    return _stats(False, 0.0, f"round {rounds} burn failed: {r.error}")
                tflops.append(r.tflops)
                if hbm_mib > 0:
                    with spans.span("soak.stream"):
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
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return SoakResult(
            ok=False, rounds=0, seconds=0.0, tflops_min=0.0, tflops_median=0.0,
            tflops_max=0.0, sustained_ratio=0.0,
            error=f"{type(exc).__name__}: {exc}",
        )
