"""Plain PyTorch and NumPy reference for the compute-level probes.

Imports nothing of the program.  Each function rebuilds a probe's inputs
from the recipe the probe states (a ``torch.Generator`` on the probe's
device seeded with 0, NumPy's ``default_rng(0)``, or a closed form) and
works out the probe's answer again in float64 or float32, rounding to bf16
only where the probe itself does.  ``precision="fp8"`` is the
control: the same computation with every product's operands rounded to
float8 e4m3 (each tensor scaled by its largest magnitude first, as an fp8
GEMM is fed), the step below the bf16 the configuration states.

Matrix products run in float32 or float64 with TF32 off (:func:`exact_matmul`),
so the reference is not itself computed in a lower precision.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextmanager
def exact_matmul():
    """TF32 off for float32 products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with a per-tensor scale, back in float32."""
    amax = float(x.abs().max())
    scale = FP8_MAX / amax if amax > 0 else 1.0
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand: its own values (bf16 held in float32), or fp8."""
    return fp8_round(x) if precision == "fp8" else x.float()


def seeded_randn(shapes, device) -> list:
    """``torch.randn`` of each shape in turn from one generator seeded with 0,
    each cast to bf16: the inputs of the burn, tiled-matmul and flash probes."""
    gen = torch.Generator(device=device).manual_seed(0)
    return [torch.randn(s, generator=gen, device=device).to(torch.bfloat16) for s in shapes]


# -- burn chain ---------------------------------------------------------------

def chain_scale(n: int) -> float:
    """1/sqrt(n) as float32 computes it: the square root, then its reciprocal."""
    root = np.sqrt(np.float32(n), dtype=np.float32)
    return float(np.float32(1.0) / root)


def burn_chain(n: int, iters: int, device, precision: str = "bf16") -> Tuple[float, float]:
    """(checksum, Frobenius norm) of the chain's last product.

    ``a`` is ``randn(n, n)`` in bf16; each step multiplies by ``a``, scales
    by 1/sqrt(n) and rounds to bf16; the checksum is the sum of the last
    step's elements.  Products accumulate in float32 (the program's
    accumulator), the checksum in float64.
    """
    (a,) = seeded_randn([(n, n)], device)
    scale = chain_scale(n)
    a_op = operand(a, precision)
    x = a
    with exact_matmul():
        for _ in range(iters):
            x = (operand(x, precision) @ a_op * scale).to(torch.bfloat16)
    x64 = x.double()
    return float(x64.sum()), float(x64.square().sum().sqrt())


def burn_invariant(n: int, device, precision: str = "bf16") -> float:
    """||A||_F^2 (= trace(A A^T)) of the burn's input, in float64; for the
    control, trace(A A^T) over the fp8 operands."""
    (a,) = seeded_randn([(n, n)], device)
    if precision == "fp8":
        a8 = fp8_round(a).double()
        return float((a8 * a8).sum())
    return float(a.double().square().sum())


# -- hand-written kernels' probes ---------------------------------------------

def tiled_entries(m: int, k: int, n: int, flat_idx: np.ndarray, device,
                  precision: str = "bf16", scale: float = 0.5) -> np.ndarray:
    """``scale * (a @ b)`` at the flat indices of the (m, n) result, float64."""
    a, b = seeded_randn([(m, k), (k, n)], device)
    idx = torch.from_numpy(flat_idx).to(device)
    rows, cols = idx // n, idx % n
    a_op, b_op = operand(a, precision).double(), operand(b, precision).double()
    vals = (a_op[rows] * b_op[:, cols].t()).sum(dim=1) * scale
    return vals.cpu().numpy()


def causal_attention(batch: int, heads: int, seq: int, head_dim: int, device,
                     precision: str = "bf16") -> np.ndarray:
    """Causal softmax attention of the flash probe's q, k, v, float64, flat.

    For the control, q, k, v and the probabilities pass through fp8 (the
    operands of both products) and the output is rounded to fp8.
    """
    shape = (batch, heads, seq, head_dim)
    q, k, v = seeded_randn([shape, shape, shape], device)
    q, k, v = (operand(t, precision).double() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(head_dim)
    causal = torch.ones((seq, seq), dtype=torch.bool, device=device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", operand(p, precision).double(), v)
    if precision == "fp8":
        out = fp8_round(out).double()
    return out.reshape(-1).cpu().numpy()


def dma_expected(rows: int, cols: int, flat_idx: np.ndarray, device,
                 precision: str = "f32") -> np.ndarray:
    """``2x + 1`` in float32 at the flat indices, ``x`` the DMA probe's randn;
    for the control, ``x`` rounded to bf16 (the step below float32)."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((rows, cols), generator=gen, device=device)
    if precision == "bf16":
        x = x.to(torch.bfloat16).float()
    idx = torch.from_numpy(flat_idx).to(device)
    return (x.reshape(-1)[idx] * 2.0 + 1.0).cpu().numpy()


# -- library probes with exact answers ----------------------------------------

def int8_entries(m: int, k: int, n: int, iters: int, flat_idx: np.ndarray) -> np.ndarray:
    """The int8 chain's int32 sum at the flat indices: sum over i < iters of
    (a rolled down by i rows) @ b, from ``default_rng(0)`` integers in [-8, 8)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
    b = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
    # float64 is exact here: every partial sum is at most k * 64 << 2**53.
    base = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    rows, cols = flat_idx // n, flat_idx % n
    src = (rows[:, None] - np.arange(iters)[None, :]) % m  # row of a @ b for each term
    return base[src, cols[:, None]].sum(axis=1)


def stream_expected(iters: int) -> float:
    """The HBM stream's every element after ``iters`` passes of ``+1`` from 0."""
    return float(iters)


def memtest_expected(pattern: str, flat_idx: np.ndarray) -> np.ndarray:
    """The pattern's 32-bit word at each index, as the int32 with those bits."""
    if pattern == "0x55":
        words = np.full(len(flat_idx), 0x55555555, dtype=np.uint64)
    elif pattern == "0xAA":
        words = np.full(len(flat_idx), 0xAAAAAAAA, dtype=np.uint64)
    elif pattern == "addr":
        words = ((flat_idx.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) \
            ^ np.uint64(0x9E3779B9)
    else:
        raise ValueError(f"unknown memtest pattern {pattern!r}")
    return words.astype(np.uint32).view(np.int32)


def worst(gap: np.ndarray) -> float:
    """The largest gap; a non-finite one (NaN included) reads as infinite."""
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")
