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

Beside the probe, the expert layer of a model that trains on one card's
share of an expert-parallel layout (:func:`expert_layer`, DeepSeek-V2's,
``modeling_deepseek.py``'s ``DeepseekV2MoE`` and ``MoEGate``): the router
over every routed expert, f32 logits and softmax, greedy top-k, weights
unnormalised times a scaling factor, and the sequence-level balance loss
over the whole router (:class:`_Route`); the held experts' part of the
combine, dropless, the tokens grouped by expert (:class:`_HeldExperts`);
the shared experts as one SwiGLU (:class:`SwiGLU`).  The layer is told
which experts it holds; on one card it has no exchange, and what the
other cards' experts would add is left out.  Each part runs under its
span (``moe.route``, ``moe.experts``, ``moe.shared``) in the forward pass
and in its hand-written backward, which autograd runs on its own thread.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_node_checker_torch.ops._harness import sync
from tpu_node_checker_torch.parallel.mesh import flat_mesh, local_device
from tpu_node_checker_torch.probe import spans


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


# -- the expert layer of a model, told which experts it holds --------------


def swiglu(x, wg, wu, wd):
    """``down(silu(gate(x)) * up(x))`` in bf16; returns (y, gate(x), up(x))."""
    a, b = torch.matmul(x, wg), torch.matmul(x, wu)
    return torch.matmul(F.silu(a) * b, wd), a, b


def swiglu_backward(dy, x, a, b, wg, wu, wd):
    """Autograd's backward of :func:`swiglu`: (dx, dwg, dwu, dwd)."""
    s = F.silu(a)
    dwd = torch.matmul((s * b).transpose(-1, -2), dy)
    dh = torch.matmul(dy, wd.transpose(-1, -2))
    da = torch.ops.aten.silu_backward(dh * b, a)
    db = dh * s
    dx = torch.matmul(da, wg.transpose(-1, -2)) + torch.matmul(db, wu.transpose(-1, -2))
    xt = x.transpose(-1, -2)
    return dx, torch.matmul(xt, da), torch.matmul(xt, db), dwd


class SwiGLU(torch.autograd.Function):
    """One SwiGLU MLP over every token (the dense layer's, the shared
    experts'), under span ``name`` where one is given."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, name):
        ctx.round, ctx.name = spans.current(), name
        with spans.within(ctx.round, name):
            y, a, b = swiglu(x, wg, wu, wd)
        ctx.save_for_backward(x, a, b, wg, wu, wd)
        return y

    @staticmethod
    def backward(ctx, dy):
        with spans.within(ctx.round, ctx.name):
            return swiglu_backward(dy, *ctx.saved_tensors) + (None,)


def router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The router's logits, in f32 from the bf16 hidden state (T, D) and
    the f32 weight (D, E), as the published gate computes them."""
    return torch.matmul(x.float(), w.float())


def balance_coefficients(topi: torch.Tensor, batch: int, n_experts: int,
                         alpha: float) -> torch.Tensor:
    """The sequence-level balance loss as a linear form of the scores:
    (batch, E) coefficients ``c`` with ``loss = sum c[b, e] scores[b, s, e]``
    over b, s and e, that is ``alpha`` times the mean over sequences of
    ``sum_e f[b, e] P[b, e]`` (``modeling_deepseek.py``'s ``seq_aux``):
    ``f`` each expert's share of the sequence's top-k choices times E / k,
    ``P`` its mean score over the sequence."""
    k = topi.shape[-1]
    per_seq = topi.view(batch, -1)
    seq = per_seq.shape[1] // k
    ce = torch.zeros((batch, n_experts), dtype=torch.float32, device=topi.device)
    ce.scatter_add_(1, per_seq, torch.ones(per_seq.shape, dtype=torch.float32,
                                           device=topi.device))
    ce /= seq * k / n_experts
    return ce * (alpha / (batch * seq))


class _Route(torch.autograd.Function):
    """The router over every routed expert: f32 logits and softmax, greedy
    top-k, the weights times ``scaling``, and the balance loss.  Returns
    (weights (T, k) f32, experts (T, k), balance loss)."""

    @staticmethod
    def forward(ctx, x, w, batch, k, scaling, alpha):
        ctx.round = spans.current()
        with spans.within(ctx.round, "moe.route"):
            scores = torch.softmax(router_logits(x, w), dim=-1, dtype=torch.float32)
            topw, topi = torch.topk(scores, k=k, dim=-1, sorted=False)
            coef = balance_coefficients(topi, batch, scores.shape[-1], alpha)
            aux = (coef[:, None, :] * scores.view(batch, -1, scores.shape[-1])).sum()
        ctx.mark_non_differentiable(topi)
        ctx.save_for_backward(x, w, scores, topi, coef)
        ctx.batch, ctx.scaling = batch, scaling
        return topw * scaling, topi, aux

    @staticmethod
    def backward(ctx, d_topw, _d_topi, d_aux):
        x, w, scores, topi, coef = ctx.saved_tensors
        with spans.within(ctx.round, "moe.route"):
            ds = torch.zeros_like(scores).scatter_(1, topi, d_topw * ctx.scaling)
            if d_aux is not None:
                E = scores.shape[-1]
                ds.view(ctx.batch, -1, E).add_(coef[:, None, :] * d_aux)
            dl = scores * (ds - (ds * scores).sum(-1, keepdim=True))
            dx = torch.matmul(dl, w.float().transpose(0, 1)).to(x.dtype)
            dw = torch.matmul(x.float().transpose(0, 1), dl).to(w.dtype)
        return dx, dw, None, None, None, None


def group_by_expert(topi: torch.Tensor, first: int, count: int):
    """The held experts' assignments grouped by expert: (token, slot) of
    each in expert order (stable), and each held expert's count on the host."""
    held = (topi >= first) & (topi < first + count)
    tok, slot = held.nonzero(as_tuple=True)
    expert = topi[tok, slot] - first
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=count).tolist()
    return tok[order], slot[order], counts


class _HeldExperts(torch.autograd.Function):
    """The held experts' part of the combine, dropless: each assignment's
    token through its expert's SwiGLU (bf16), times its router weight,
    summed over the token's held assignments in f32, in bf16."""

    @staticmethod
    def forward(ctx, x, topw, topi, wg, wu, wd, first, counting):
        ctx.round = spans.current()
        with spans.within(ctx.round, "moe.experts"):
            tok, slot, counts = group_by_expert(topi, first, wg.shape[0])
            xs = x[tok]
            ys = torch.empty_like(xs)
            a = xs.new_empty(xs.shape[0], wg.shape[-1])
            b = torch.empty_like(a)
            lo = 0
            for e, n in enumerate(counts):
                seg = slice(lo, lo + n)
                ys[seg], a[seg], b[seg] = swiglu(xs[seg], wg[e], wu[e], wd[e])
                lo += n
            gates = topw[tok, slot]
            out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            out.index_add_(0, tok, ys.float() * gates[:, None])
        if counting:
            spans.count("moe_layer_steps")
            spans.count("moe_assignments", topi.numel())
            spans.count("moe_assignments_held", tok.numel())
            spans.count("moe_max_expert_tokens", max(counts))
            spans.count("moe_tokens_dropped", tok.numel() - lo)
        ctx.save_for_backward(xs, a, b, ys, gates, tok, slot, wg, wu, wd)
        ctx.counts, ctx.shape = counts, (x.shape, topw.shape)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, d_out):
        xs, a, b, ys, gates, tok, slot, wg, wu, wd = ctx.saved_tensors
        x_shape, w_shape = ctx.shape
        with spans.within(ctx.round, "moe.experts"):
            g = d_out.float()[tok]
            d_topw = torch.zeros(w_shape, dtype=torch.float32, device=g.device)
            d_topw[tok, slot] = (g * ys.float()).sum(-1)
            dys = (g * gates[:, None]).to(ys.dtype)
            dxs = torch.empty_like(xs)
            dwg, dwu, dwd = torch.empty_like(wg), torch.empty_like(wu), torch.empty_like(wd)
            lo = 0
            for e, n in enumerate(ctx.counts):
                seg = slice(lo, lo + n)
                dxs[seg], dwg[e], dwu[e], dwd[e] = swiglu_backward(
                    dys[seg], xs[seg], a[seg], b[seg], wg[e], wu[e], wd[e])
                lo += n
            dx = torch.zeros(x_shape, dtype=torch.float32, device=g.device)
            dx.index_add_(0, tok, dxs.float())
        return dx.to(xs.dtype), d_topw, None, dwg, dwu, dwd, None, None


def expert_layer(x: torch.Tensor, router: torch.Tensor, experts, shared, *, held_first: int,
                 batch: int, top_k: int, scaling: float, alpha: float, counting: bool):
    """The expert layer of ``x`` (T, D) bf16: (output (T, D), balance loss).

    ``router`` is the f32 (D, E) weight over every routed expert;
    ``experts`` the held experts' (gate, up, down) weights stacked on a
    leading axis, experts ``held_first`` onward; ``shared`` the shared
    experts' (gate, up, down) as one SwiGLU; ``batch`` the sequences the
    T tokens are, for the sequence-level balance loss times ``alpha``.
    ``counting`` adds this pass to the round's ``moe_*`` counters (the
    forward pass does; its recomputation does not)."""
    topw, topi, aux = _Route.apply(x, router, batch, top_k, scaling, alpha)
    out = _HeldExperts.apply(x, topw, topi, *experts, held_first, counting)
    return out + SwiGLU.apply(x, *shared, "moe.shared"), aux
