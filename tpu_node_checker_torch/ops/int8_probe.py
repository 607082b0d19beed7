"""Int8 tensor-core probe: the quantized matrix mode.

The bf16 burn (:mod:`tpu_node_checker_torch.ops.burn`) exercises the tensor
cores' float path; quantized serving runs the **int8** mode (int8 inputs,
int32 accumulators), a separate configuration of the same units.  A card can
pass every bf16 check and still corrupt int8 inference, so node acceptance
needs both.

Verification is **exact**: int8 x int8 -> int32 is integer arithmetic with a
closed-form host answer and zero tolerance.  With inputs in [-8, 7] the
worst per-term product is 64, so the chained accumulator is bounded by
``iters * k * 64`` (1024 x 128 -> 8.4M), far inside int32; any deviation is a
hardware or library fault, never rounding.  The product is a library call
(``torch._int_mm``), as the JAX package leaves it to XLA.

On the card the chain (each product with its roll) is captured once as a
CUDA graph and the timed run replays it between two CUDA events: the figure
is the chain's operations over its device time, as the JAX chain is one
compiled program.  Issued product by product and timed on the host clock,
the 256 launches of the probe's chain set its time, and a busy host cuts the
figure.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpu_node_checker_torch.ops._harness import DeviceLike, card_graph, resolve_device, sync


@dataclass
class Int8Result:
    ok: bool
    tops: float  # tera-ops/s of the timed int8 chain (2mkn ops per product)
    elapsed_ms: float
    error: Optional[str] = None


def _int8_chain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Sum of ``iters`` int8 products ``roll(a, i) @ b`` in int32.

    The row roll makes each product a different one, while staying exactly
    verifiable on the host (``roll(a, i) @ b == roll(a @ b, i)``).
    """
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    for i in range(iters):
        acc += torch._int_mm(torch.roll(a, i, dims=0), b)
    return acc


def int8_matmul_probe(
    m: int = 512,
    k: int = 512,
    n: int = 512,
    iters: int = 8,
    device: DeviceLike = None,
) -> Int8Result:
    """Run a chain of int8 products on the device; verify EXACT equality
    against numpy."""
    try:
        if min(m, k, n, iters) <= 0:
            return Int8Result(
                ok=False, tops=0.0, elapsed_ms=0.0,
                error=f"invalid shape ({m},{k},{n})x{iters}: dims must be positive",
            )
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        a_host = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
        b_host = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
        a = torch.from_numpy(a_host).to(dev)
        b = torch.from_numpy(b_host).to(dev)

        if dev.type == "cuda":
            replay = card_graph(lambda: _int8_chain(a, b, iters),
                                lambda: _int8_chain(a, b, 1), dev, "int8")
            replay()  # warm-up
            out, seconds = replay()
            elapsed_ms = seconds * 1e3
        else:
            out = _int8_chain(a, b, iters)
            int(out[0, 0].item())  # warm-up completion barrier
            sync(dev)
            t0 = time.perf_counter()
            out = _int8_chain(a, b, iters)
            # Scalar fetch as the in-window barrier; the full m x n fetch for
            # the check happens after the clock stops.
            int(out[0, 0].item())
            elapsed_ms = (time.perf_counter() - t0) * 1e3
        out_host = out.cpu().numpy()

        # roll(a, i) @ b == roll(a @ b, i): one product, iters cheap rolls.
        # float64 BLAS is exact here (every partial sum <= k * 64 << 2^53).
        base = (a_host.astype(np.float64) @ b_host.astype(np.float64)).astype(np.int32)
        ref = np.zeros_like(base)
        for i in range(iters):
            ref += np.roll(base, i, axis=0)
        if not np.array_equal(out_host, ref):
            bad = int(np.count_nonzero(out_host != ref))
            return Int8Result(
                ok=False, tops=0.0, elapsed_ms=elapsed_ms,
                error=(
                    f"int8 matmul WRONG in {bad}/{out_host.size} elements — "
                    "integer arithmetic admits no rounding excuse"
                ),
            )
        tops = (
            (2.0 * m * k * n * iters) / (elapsed_ms * 1e-3) / 1e12
            if elapsed_ms > 0
            else 0.0
        )
        return Int8Result(ok=True, tops=tops, elapsed_ms=elapsed_ms)
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return Int8Result(
            ok=False, tops=0.0, elapsed_ms=0.0, error=f"{type(exc).__name__}: {exc}"
        )
