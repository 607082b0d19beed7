"""Causal flash attention written for Hopper, the probes' hot operator.

Attention dominates the workload-level probes, and on serving and training
stacks it is the operator most often replaced by a custom kernel.  This
module provides that kernel for the probe suite (``csrc/flash_attention.cu``):
a blockwise causal forward with an online softmax, a K/V loop that stops at
the diagonal block, the softmax state and accumulators in f32 and the output
in the input's dtype.  bf16 inputs run both products on the tensor cores,
with P rounded to bf16 before P.V; f32 inputs run on the CUDA cores.  The
probe cross-checks it against the plain attention.

* :func:`flash_forward` is the forward alone (CUDA tensors launch the
  kernel, CPU tensors take the plain version);
* :func:`flash_attention` is differentiable: its forward is the kernel, its
  backward runs autograd over the plain version on the saved q/k/v (nothing
  but q/k/v is kept, as in the JAX package, which has no backward kernel);
* :func:`causal_attention_reference` is the plain version, in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from tpu_node_checker_torch.ops import _build
from tpu_node_checker_torch.ops._harness import DeviceLike, is_cpu, resolve_device, timed_run

BLOCK = 128  # query block rows, as in the JAX kernel
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@dataclass
class FlashAttentionProbeResult:
    ok: bool
    max_abs_err: float
    elapsed_ms: float
    interpreted: bool
    error: Optional[str] = None


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain causal attention over (B, H, S, D) in f32, output in q's dtype."""
    S, D = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    mask = torch.where(keep, 0.0, -1e30)
    p = torch.softmax(s + mask, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The causal forward over (B, H, S, D); S a multiple of 128.

    CUDA tensors launch the kernel (bf16 or f32, D in 32/64/128); CPU tensors
    take the plain version.  Nothing falls back.
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash attention needs equal (B,H,S,D) q/k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, S, D = q.shape
    if S % BLOCK:
        raise ValueError(f"seq len {S} must be a multiple of {BLOCK}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return causal_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu (plain), not {q.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention kernel takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs 16-byte aligned q/k/v")
    out = torch.empty_like(q)
    fn = _build.kernel("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, D,
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D), stream,
    )
    _build.check("flash_attention", code)
    flash_forward.launches += 1
    return out


flash_forward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_forward(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        # Differentiate the plain version on the saved activations: forward =
        # kernel, backward = autograd of the same function.  The gradient of
        # sum(out * grad_out) is the vector-Jacobian product with grad_out;
        # handing grad_out to autograd.grad instead would have torch check
        # its shape through sympy, whose first import costs a fresh process
        # seconds on the card's machine (PERF.md).
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = causal_attention_reference(q, k, v)
            return torch.autograd.grad((out * grad_out).sum(), (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable causal flash attention over (B, H, S, D).

    Same shape and dtype as ``q``; the softmax state and accumulators are f32.
    """
    return _FlashAttention.apply(q, k, v)


def flash_attention_probe(
    batch: int = 1,
    heads: int = 2,
    seq: int = 512,
    head_dim: int = 128,
    tol: float = 2e-2,
    device: DeviceLike = None,
) -> FlashAttentionProbeResult:
    """Run the flash-attention kernel and cross-check it against the plain
    attention (max absolute difference; the tolerance allows for the bf16
    rounding of P and of the output, accumulation is f32 on both sides)."""
    interpreted = is_cpu(device)
    try:
        if seq <= 0 or seq % BLOCK:
            return FlashAttentionProbeResult(
                ok=False, max_abs_err=float("inf"), elapsed_ms=0.0,
                interpreted=interpreted,
                error=f"invalid seq {seq}: must be a positive multiple of {BLOCK}",
            )
        if batch <= 0 or heads <= 0 or head_dim <= 0:
            return FlashAttentionProbeResult(
                ok=False, max_abs_err=float("inf"), elapsed_ms=0.0,
                interpreted=interpreted,
                error=(
                    f"invalid dims batch={batch} heads={heads} "
                    f"head_dim={head_dim}: all must be positive"
                ),
            )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        shape = (batch, heads, seq, head_dim)
        q, k, v = (
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)
        )
        out, checksum, elapsed_ms = timed_run(lambda: flash_attention(q, k, v))
        ref = causal_attention_reference(q, k, v)
        max_abs_err = float((out.float() - ref.float()).abs().max().item())
        ok = max_abs_err < tol and math.isfinite(checksum)
        return FlashAttentionProbeResult(
            ok=bool(ok),
            max_abs_err=max_abs_err,
            elapsed_ms=elapsed_ms,
            interpreted=interpreted,
            error=None if ok else f"flash/plain mismatch: max|Δ|={max_abs_err:.3e}",
        )
    except Exception as exc:  # probes report, never raise
        return FlashAttentionProbeResult(
            ok=False, max_abs_err=float("inf"), elapsed_ms=0.0,
            interpreted=interpreted, error=f"{type(exc).__name__}: {exc}",
        )
