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
hardware or kernel fault, never rounding.

On the card the whole chain is one kernel written for Hopper
(``csrc/int8_chain.cu``: the roll, every product and the running sum fused
on wgmma s8, the sums kept in registers); the CPU runs the plain version,
one library product (``torch._int_mm``) a step, as the JAX package leaves
the chain to XLA.  The chain is captured once as a CUDA graph and the timed
run replays it between two CUDA events: the figure is the chain's operations
over its device time, as the JAX chain is one compiled program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpu_node_checker_torch.ops import _build
from tpu_node_checker_torch.ops._harness import DeviceLike, chain_clock, resolve_device


@dataclass
class Int8Result:
    ok: bool
    tops: float  # tera-ops/s of the timed int8 chain (2mkn ops per product)
    elapsed_ms: float
    error: Optional[str] = None


K_SLICE = 128  # the kernel's K slice: 128 int8, one 128-byte swizzled row
# Output tiles the kernel is built for, largest first: (rows, cols).
KERNEL_TILES = ((128, 256), (128, 128))


def int8_chain_reference(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: ``iters`` library products ``roll(a, i) @ b``, summed in int32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    for i in range(iters):
        acc += torch._int_mm(torch.roll(a, i, dims=0), b)
    return acc


def int8_chain_plan(m: int, n: int, iters: int, sms: int) -> tuple:
    """``(bm, bn, groups)`` for the kernel on an (m, n) result over ``iters``
    products, on a card with ``sms`` SMs.

    The tile is the largest of :data:`KERNEL_TILES` that divides (m, n).  The
    iterations split into ``groups`` contiguous runs, group g taking
    ``g * iters // groups`` up to ``(g + 1) * iters // groups``: as many as
    keep tiles x groups blocks within one wave of ``sms``, at least one and
    at most ``iters``, so no group is empty.
    """
    bm, bn = next((t for t in KERNEL_TILES if m % t[0] == 0 and n % t[1] == 0),
                  KERNEL_TILES[-1])
    tiles = (m // bm) * (n // bn)
    return bm, bn, max(1, min(iters, sms // tiles))


def kernel_shape_error(m: int, k: int, n: int, iters: int) -> Optional[str]:
    """Why the kernel cannot run an (m, k) @ (k, n) chain of ``iters``
    products, or None: M, N and K must be positive multiples of
    :data:`K_SLICE`, ``iters`` at least 1."""
    if min(m, k, n) <= 0 or m % K_SLICE or n % K_SLICE or k % K_SLICE or iters < 1:
        return (
            f"shape ({m},{k},{n})x{iters} not supported by the int8 chain kernel: "
            f"M, N and K must be positive multiples of {K_SLICE}, iters at least 1"
        )
    return None


def int8_chain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``sum over i < iters of roll(a, i, dims=0) @ b`` for int8 ``a`` (M, K)
    and ``b`` (K, N), int32 out.

    CUDA tensors launch the kernel (:func:`kernel_shape_error` states its
    rule, and a shape off it raises); CPU tensors take the plain version.
    Nothing falls back.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_chain needs (M,K) @ (K,N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"int8_chain inputs on {a.device} and {b.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_chain takes int8, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return int8_chain_reference(a, b, iters)
    (M, K), N = a.shape, b.shape[1]
    error = kernel_shape_error(M, K, N, iters)
    if error:
        raise ValueError(error)
    if a.device.type != "cuda":
        raise ValueError(f"int8_chain runs on cuda (kernel) or cpu (plain), not {a.device}")
    # The roll is an address into [a; a]; wgmma reads int8 B K-major only.
    # Both are fresh contiguous copies, so any input layout is taken.
    a2 = torch.cat([a, a])
    bt = b.t().contiguous()
    acc = torch.zeros((M, N), dtype=torch.int32, device=a.device)
    bm, bn, groups = int8_chain_plan(
        M, N, iters, torch.cuda.get_device_properties(a.device).multi_processor_count)
    _build.launch("int8_chain", a.device, a2.data_ptr(), bt.data_ptr(), acc.data_ptr(), M, N, K,
                  iters, bm, bn, groups)
    return acc


def _int8_chain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Sum of ``iters`` int8 products ``roll(a, i) @ b`` in int32: the chain
    the probe times (:func:`int8_chain`: the kernel on the card, the plain
    version on the CPU).

    The row roll makes each product a different one, while staying exactly
    verifiable on the host (``roll(a, i) @ b == roll(a @ b, i)``).
    """
    return int8_chain(a, b, iters)


def int8_matmul_probe(
    m: int = 512,
    k: int = 512,
    n: int = 512,
    iters: int = 8,
    device: DeviceLike = None,
) -> Int8Result:
    """Run a chain of int8 products on the device; verify EXACT equality
    against numpy.

    On a card the chain is the kernel, which takes M, N and K multiples of
    128 only: any other shape there returns ``ok=False`` with the error
    "not supported by the int8 chain kernel", a limit of the probe and not
    a mismatch.  The CPU takes any positive shape."""
    try:
        if min(m, k, n, iters) <= 0:
            return Int8Result(
                ok=False, tops=0.0, elapsed_ms=0.0,
                error=f"invalid shape ({m},{k},{n})x{iters}: dims must be positive",
            )
        dev = resolve_device(device)
        if dev.type == "cuda":
            unsupported = kernel_shape_error(m, k, n, iters)
            if unsupported:
                return Int8Result(ok=False, tops=0.0, elapsed_ms=0.0, error=unsupported)
        rng = np.random.default_rng(0)
        a_host = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
        b_host = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
        a = torch.from_numpy(a_host).to(dev)
        b = torch.from_numpy(b_host).to(dev)

        run = chain_clock(lambda: _int8_chain(a, b, iters), lambda: _int8_chain(a, b, 1), dev,
                          "int8")
        run()  # warm-up
        out, seconds = run()
        elapsed_ms = seconds * 1e3
        # The full m x n fetch for the check happens after the clock stops.
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
