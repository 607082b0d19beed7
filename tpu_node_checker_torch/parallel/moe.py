"""Expert parallelism: an MoE dispatch and combine round trip as a fabric probe.

The port of the JAX package's ``parallel/moe.py``, and the one probe that
drives ``all_to_all``: the token shuffle of Mixture-of-Experts layers, every
pair of cards at once.

* Every rank lies on one axis ``ep`` of size ``n``; rank ``e`` holds expert
  ``e``'s FFN weights (distinct per expert, so a mis-routed token changes
  the answer).
* Each rank holds ``T`` tokens; token ``j`` goes to expert ``j mod n``.  The
  balanced round-robin assignment gives a closed-form expectation, where
  top-k routing would let capacity overflow, not the fabric, show in the
  verdict.  The router's softmax gate stays: each token's expert output is
  scaled by its gate.
* Dispatch is ``all_to_all_single`` (tokens to their expert's rank), each
  expert runs its FFN on the tokens it received, and a second
  ``all_to_all_single`` brings the results home.
* The verdict holds the same gated computation, evaluated densely on the
  host, to the output.

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
from tpu_node_checker_torch.parallel.mesh import flat_mesh, local_device


# The probe's inputs are drawn from this seed on every rank.
_SEED = 0


@dataclass
class MoEResult:
    ok: bool
    n_experts: int
    tokens: int
    max_abs_err: float
    latency_ms: float
    error: Optional[str] = None
    details: Optional[dict] = None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row block ``s`` of ``x`` (split on dim 0) goes to rank ``s``; row
    block ``s`` of the result came from rank ``s``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def moe_forward(
    w1: torch.Tensor,
    w2: torch.Tensor,
    wr: torch.Tensor,
    x: torch.Tensor,
    inject_fault_expert: Optional[int] = None,
    with_ungated: bool = False,
):
    """The expert-parallel layer over the ``ep`` line of every rank.

    Collective.  ``w1`` (d, f) and ``w2`` (f, d) are this rank's expert,
    ``wr`` (d, n) the router (the same on every rank), ``x`` (T, d) this
    rank's tokens, ``T`` a multiple of ``n``.  Returns the gated expert
    outputs for this rank's tokens, (T, d).

    ``inject_fault_expert`` adds 1 to one received token (home rank 0,
    slot 0) in that expert's inbox after the dispatch.  ``with_ungated=True``
    also returns the outputs before the gate: a gate can scale a corrupted
    token below any tolerance, so the probe grades the ungated surface.
    """
    mesh = flat_mesh("ep")
    group = mesh.groups["ep"]
    n, i = mesh.size("ep"), mesh.index("ep")
    if inject_fault_expert is not None and not 0 <= inject_fault_expert < n:
        raise ValueError(
            f"inject_fault_expert {inject_fault_expert} out of range for {n} experts"
        )
    T, d = x.shape
    g = T // n  # tokens per (home rank, expert) group
    # Router: a data-dependent gate for the statically assigned expert.
    probs = torch.softmax(x @ wr, dim=-1)  # (T, n)
    expert_of = torch.arange(T, device=x.device) % n
    gate = probs.gather(1, expert_of[:, None])[:, 0]
    # Token j = k·n + e goes to group e, slot k.
    grouped = x.reshape(g, n, d).transpose(0, 1)  # (n, g, d)
    received = _all_to_all(grouped, group)  # row s: this expert's tokens from rank s
    if i == inject_fault_expert:
        received = received.clone()
        received[0, 0, :] += 1.0
    y = torch.tanh(received @ w1) @ w2
    back = _all_to_all(y, group)  # row e: expert e's output for this rank's group e
    ungrouped = back.transpose(0, 1).reshape(T, d)
    gated = ungrouped * gate[:, None]
    if with_ungated:
        return gated, ungrouped
    return gated


def moe_sharded(w1, w2, wr, x, inject_fault_expert: Optional[int] = None):
    """The expert-parallel layer of host arrays or CPU tensors holding every
    expert, ``w1`` (n, d, f) and ``w2`` (n, f, d), the router ``wr`` (d, n)
    and every rank's tokens ``x`` (n·T, d): this rank takes its expert and
    its T tokens and returns their ``(gated, ungated)`` outputs on the CPU.
    Collective."""
    gated, ungated = _moe_local(w1, w2, wr, x, inject_fault_expert)
    return gated.cpu(), ungated.cpu()


def _moe_local(w1, w2, wr, x, inject_fault_expert: Optional[int]):
    """:func:`moe_sharded`'s outputs, left on this rank's device."""
    n, i, dev = dist.get_world_size(), dist.get_rank(), local_device()
    w1, w2, wr, x = (torch.as_tensor(a) for a in (w1, w2, wr, x))
    T = x.shape[0] // n
    return moe_forward(
        w1[i].to(dev), w2[i].to(dev), wr.to(dev), x[i * T:(i + 1) * T].to(dev),
        inject_fault_expert=inject_fault_expert, with_ungated=True,
    )


def reference_moe(w1, w2, wr, x, n, with_ungated: bool = False):
    """The same gated MoE evaluated densely on one device: the ground truth."""
    T = x.shape[0]
    probs = torch.softmax(x @ wr, dim=-1)
    expert_of = torch.arange(T) % n
    gate = probs.gather(1, expert_of[:, None])[:, 0]
    # Every expert on every token, then select: fine at probe scale.
    h = torch.tanh(torch.einsum("td,edf->etf", x, w1))
    y = torch.einsum("etf,efd->etd", h, w2)  # (n_experts, T, d)
    sel = y[expert_of, torch.arange(T)]
    gated = sel * gate[:, None]
    if with_ungated:
        return gated, sel
    return gated


def moe_probe(
    tokens_per_device: int = 16,
    d_model: int = 32,
    d_ff: int = 64,
    rtol: float = 1e-3,
    inject_fault_expert: Optional[int] = None,
) -> MoEResult:
    """Run the expert-parallel layer over the group and hold it against the
    dense reference, computed on the host.

    Every rank draws the same inputs from a ``torch.Generator`` seeded with
    ``_SEED`` and takes its expert and its tokens.  Token ``j`` serves expert
    ``j mod n``, so each rank's wrong tokens count against their experts;
    the counts, the worst errors and the gated verdict are reduced over the
    group, so every rank grades the same and the verdict names the
    expert(s) whose tokens came back wrong.
    """
    try:
        dev = local_device()
        n, i = dist.get_world_size(), dist.get_rank()
        T = tokens_per_device
        if T % n:
            T = ((T // n) + 1) * n  # each rank's tokens must split n ways
        gen = torch.Generator().manual_seed(_SEED)
        w1 = torch.randn((n, d_model, d_ff), generator=gen) / d_model ** 0.5
        w2 = torch.randn((n, d_ff, d_model), generator=gen) / d_ff ** 0.5
        wr = torch.randn((d_model, n), generator=gen)
        x = torch.randn((n * T, d_model), generator=gen)
        _moe_local(w1, w2, wr, x, inject_fault_expert)  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        gated, ungated = _moe_local(w1, w2, wr, x, inject_fault_expert)
        sync(dev)
        latency_ms = (time.perf_counter() - t0) * 1e3

        rows = slice(i * T, (i + 1) * T)
        ref, raw_ref = (t[rows].to(dev) for t in reference_moe(w1, w2, wr, x, n, True))

        def close(a, b):
            return (a - b).abs() <= rtol + rtol * b.abs()

        errs = torch.stack([(gated - ref).abs().max(), (ungated - raw_ref).abs().max(),
                            (~close(gated, ref)).any().float()])
        dist.all_reduce(errs, op=dist.ReduceOp.MAX)
        max_abs_err, raw_max_err, gated_bad = errs.tolist()
        # The verdict on the UNGATED surface, attributed per expert.
        bad_tok = (~close(ungated, raw_ref)).any(dim=1).to(torch.int64)
        bad_per_expert = torch.zeros((n,), dtype=torch.int64, device=dev)
        bad_per_expert.index_add_(0, torch.arange(T, device=dev) % n, bad_tok)
        dist.all_reduce(bad_per_expert)
        ok = not gated_bad and int(bad_per_expert.sum()) == 0
        details = None
        error = None
        if not ok:
            bad_experts = [int(e) for e in torch.nonzero(bad_per_expert).flatten()]
            details = {"bad_experts": bad_experts, "ungated_max_abs_err": raw_max_err}
            # The UNGATED magnitude the verdict rests on: the gated one can
            # read as float noise on a low-gate token.
            where = (
                f"errors attribute to expert(s) {bad_experts}"
                if bad_experts
                else "attribution clean (gate-path or sub-threshold fault)"
            )
            error = (
                f"moe all_to_all mismatch: ungated max|Δ|={raw_max_err:.3e} "
                f"(gated {max_abs_err:.3e}); {where}"
            )
        return MoEResult(
            ok=ok,
            n_experts=n,
            tokens=n * T,
            max_abs_err=max_abs_err,
            latency_ms=latency_ms,
            error=error,
            details=details,
        )
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return MoEResult(
            ok=False,
            n_experts=0,
            tokens=0,
            max_abs_err=float("inf"),
            latency_ms=0.0,
            error=f"{type(exc).__name__}: {exc}",
        )
