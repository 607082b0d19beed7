"""Hand-written tensor-core kernel probe (the port of the Pallas matmul probe).

Library products (cuBLAS behind ``torch.matmul``) and hand-written kernels
reach the card through different compilers and code paths.  A card can run
every library product correctly and still fault on custom kernels, which
serving stacks with fused kernels hit exactly.  This probe runs a tiled bf16
matmul written for Hopper (``csrc/tiled_matmul.cu``: wgmma tensor-core
products fed by a TMA ring, f32 accumulation, a fused x scale epilogue) and
checks it against the plain f32 product.

The module keeps the JAX package's names (``pallas_matmul_probe``,
``PallasProbeResult``) so each finds its counterpart; ``interpreted`` now
means "ran the plain version on the CPU".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from tpu_node_checker_torch.ops import _build
from tpu_node_checker_torch.ops._harness import DeviceLike, is_cpu, resolve_device, timed_run

TILE = 128
K_SLICE = 64  # the kernel's K slice: 64 bf16, one 128-byte swizzled row
# Output tiles the kernel is built for, largest first: (rows, cols).
KERNEL_TILES = ((128, 128), (64, 64))


@dataclass
class PallasProbeResult:
    ok: bool
    max_rel_err: float
    elapsed_ms: float
    interpreted: bool
    error: Optional[str] = None


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version: f32 product of the bf16 inputs, times ``scale``."""
    return torch.matmul(a.float(), b.float()) * scale


def matmul_tile(m: int, n: int, sms: int) -> tuple:
    """The kernel's output tile for an (m, n) result on a card with ``sms``
    SMs: the largest of :data:`KERNEL_TILES` that still gives every SM a
    block, else the smallest.  Each tile sums over K in the same order."""
    for bm, bn in KERNEL_TILES:
        if (m // bm) * (n // bn) >= sms:
            return bm, bn
    return KERNEL_TILES[-1]


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * (a @ b)`` for bf16 ``a`` (M, K) and ``b`` (K, N), f32 out.

    CUDA tensors launch the tensor-core kernel (M and N multiples of 128, K of
    64); CPU tensors take the plain version.  Nothing falls back.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul needs (M,K) @ (K,N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"tiled_matmul inputs on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return tiled_matmul_reference(a, b, scale)
    if a.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on cuda (kernel) or cpu (plain), not {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"tiled_matmul kernel takes bf16, got {a.dtype} and {b.dtype}")
    (M, K), N = a.shape, b.shape[1]
    if min(M, N, K) <= 0 or M % TILE or N % TILE or K % K_SLICE:
        raise ValueError(
            f"tiled_matmul kernel shape ({M},{K},{N}): M and N must be positive "
            f"multiples of {TILE}, K of {K_SLICE}"
        )
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    for t in (a, b):
        if t.data_ptr() % 16:
            raise ValueError("tiled_matmul kernel needs 16-byte aligned inputs")
    bm, bn = matmul_tile(M, N, torch.cuda.get_device_properties(a.device).multi_processor_count)
    _build.launch("tiled_matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                  bm, bn, float(scale))
    return out


def pallas_matmul_probe(
    m: int = 512,
    k: int = 512,
    n: int = 512,
    rel_tol: float = 2e-2,
    device: DeviceLike = None,
) -> PallasProbeResult:
    """Run the hand-written tiled matmul and cross-check it against the plain
    f32 product (max relative error, denominator ``max(|ref|, 1)``)."""
    interpreted = is_cpu(device)
    try:
        if min(m, k, n) <= 0 or m % TILE or k % TILE or n % TILE:
            # A usage error must not read as a kernel/card fault downstream.
            return PallasProbeResult(
                ok=False, max_rel_err=float("inf"), elapsed_ms=0.0,
                interpreted=interpreted,
                error=f"invalid shape ({m},{k},{n}): dims must be positive "
                "multiples of 128",
            )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        scale = 0.5

        out, checksum, elapsed_ms = timed_run(lambda: tiled_matmul(a, b, scale))
        ref = tiled_matmul_reference(a, b, scale)
        denom = ref.abs().clamp_min(1.0)
        max_rel_err = float(((out - ref).abs() / denom).max().item())
        ok = max_rel_err < rel_tol and math.isfinite(checksum)
        return PallasProbeResult(
            ok=bool(ok),
            max_rel_err=max_rel_err,
            elapsed_ms=elapsed_ms,
            interpreted=interpreted,
            error=None if ok else f"kernel/plain mismatch: max_rel_err={max_rel_err:.3e}",
        )
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return PallasProbeResult(
            ok=False, max_rel_err=float("inf"), elapsed_ms=0.0,
            interpreted=interpreted, error=f"{type(exc).__name__}: {exc}",
        )
