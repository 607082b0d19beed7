"""Ring attention: causal attention with the sequence split over the ranks.

The port of the JAX package's ``parallel/ring_attention.py``, and its
heaviest combined fabric probe: each step computes one attention block and
then rotates the K/V block one hop around the rank ring with
``batch_isend_irecv``, so a full pass crosses every link under real compute.

* rank ``i`` keeps query block ``i`` and starts with K/V block ``i``;
* at step ``t`` it attends ``q_i`` against K/V block ``j = (i - t) mod n``
  with the causal rule applied between blocks (``j < i`` full, ``j == i``
  lower-triangular, ``j > i`` masked out);
* the blocks merge through the online-softmax recurrence (running max,
  denominator, numerator) in f32.

The layout is the JAX package's, (B, S, H, D).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_node_checker_torch.parallel.collectives import ring_shift
from tpu_node_checker_torch.ops._harness import sync
from tpu_node_checker_torch.parallel.mesh import local_device


@dataclass
class RingAttentionResult:
    ok: bool
    n_devices: int
    seq_len: int
    max_abs_err: float
    latency_ms: float
    error: Optional[str] = None


def reference_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-device causal attention over (B, S, H, D) in f32, output in q's
    dtype: the ground truth for the ring."""
    S, D = q.shape[1], q.shape[3]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    mask = torch.where(keep, 0.0, -1e30)
    probs = torch.softmax(scores + mask[None, None], dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal ring attention over the group; q/k/v are this rank's (B, S_l,
    H, D) blocks of the sequence, and so is the output (in q's dtype)."""
    n, i = dist.get_world_size(), dist.get_rank()
    B, S_l, H, D = q.shape
    if D <= 0 or S_l <= 0:
        raise ValueError(f"degenerate attention shape {tuple(q.shape)}")
    scale = 1.0 / math.sqrt(D)
    q32 = q.float()
    neg = -1e30
    tril = torch.tril(torch.ones((S_l, S_l), dtype=torch.bool, device=q.device))
    m = torch.full((B, H, S_l), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S_l), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S_l, H, D), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n):
        j = (i - t) % n
        scores = torch.einsum("bshd,bthd->bhst", q32, k_blk.float()) * scale
        if j == i:
            scores = scores.masked_fill(~tril, neg)
        elif j > i:
            scores = torch.full_like(scores, neg)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p, v_blk.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if t < n - 1:  # the last block needs no onward hop
            k_blk, v_blk = ring_shift(k_blk), ring_shift(v_blk)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q: np.ndarray, k: np.ndarray, v: np.ndarray) -> torch.Tensor:
    """Ring attention of host arrays (B, S, H, D) whose S splits evenly over
    the group: this rank's (B, S/n, H, D) output block, on its device."""
    n, i = dist.get_world_size(), dist.get_rank()
    per = q.shape[1] // n
    dev = local_device()
    return ring_attention(*(
        torch.from_numpy(np.ascontiguousarray(x[:, i * per:(i + 1) * per])).to(dev)
        for x in (q, k, v)
    ))


def ring_attention_probe(
    batch: int = 2,
    seq_per_device: int = 32,
    heads: int = 2,
    head_dim: int = 32,
    rtol: float = 2e-3,
) -> RingAttentionResult:
    """Run ring attention over the group and hold it against the
    single-device reference: wrong numerics localise to the K/V rotation.

    Every rank draws the same full inputs with numpy (seed 0), computes
    the full reference, and compares its own block with
    ``|Δ| > rtol + rtol·|ref|``; the verdict and the max error are reduced
    over the group."""
    try:
        n, i = dist.get_world_size(), dist.get_rank()
        dev = local_device()
        S = n * seq_per_device
        rng = np.random.default_rng(0)
        shape = (batch, S, heads, head_dim)
        q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
        out = ring_attention_sharded(q, k, v)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        out = ring_attention_sharded(q, k, v)
        sync(dev)
        latency_ms = (time.perf_counter() - t0) * 1e3
        ref = reference_causal_attention(*(torch.from_numpy(x).to(dev) for x in (q, k, v)))
        ref = ref[:, i * seq_per_device:(i + 1) * seq_per_device]
        d = (out - ref).abs()
        stats = torch.stack([d.max(), (d > rtol + rtol * ref.abs()).any().float()])
        dist.all_reduce(stats, op=dist.ReduceOp.MAX)
        max_abs_err, bad = stats.tolist()
        ok = bad == 0.0
        return RingAttentionResult(
            ok=ok,
            n_devices=n,
            seq_len=S,
            max_abs_err=max_abs_err,
            latency_ms=latency_ms,
            error=None if ok else f"ring attention mismatch: max|Δ|={max_abs_err:.3e}",
        )
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return RingAttentionResult(
            ok=False, n_devices=0, seq_len=0, max_abs_err=float("inf"),
            latency_ms=0.0, error=f"{type(exc).__name__}: {exc}",
        )
