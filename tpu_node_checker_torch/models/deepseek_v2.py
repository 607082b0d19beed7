"""DeepSeek-V2-Lite's training step as the workload level's model.

One card's share of an 8-way expert-parallel deployment of the published
model (``deepseek-ai/DeepSeek-V2-Lite``, ``config.json`` and
``modeling_deepseek.py``, whose equations this module follows by name):
every layer at the published widths, 8 of each MoE layer's 64 routed
experts held here, and the card's eighth of the vocabulary.

* Attention is MLA without a query compression (``q_lora_rank`` null): q is
  one dense projection; keys and values come from a 512-wide latent with
  its own RMSNorm, plus one decoupled 64-wide rotary key shared by every
  head.  The rotary part is YaRN (:func:`yarn_inv_freq`), its pairs
  de-interleaved before ``rotate_half`` as the published code does, and the
  softmax scale carries YaRN's ``mscale_all_dim`` squared
  (:func:`softmax_scale`).  Attention runs on the plain path: the scores,
  mask, softmax and P·V of each sequence in turn (:class:`_Attention`).
* The first layer's MLP is dense; every later one is the expert layer
  (:func:`tpu_node_checker_torch.parallel.moe.expert_layer`): an f32
  softmax router over all routed experts, greedy top-k, weights
  unnormalised and scaled by ``routed_scaling_factor``; the held experts'
  part of the combine, dropless, the tokens grouped by expert; the shared
  experts as one SwiGLU; and the sequence-level balance loss,
  ``aux_loss_alpha`` times the published ``seq_aux`` term over the full
  router, added to the loss.  On one card the layer has no exchange: what
  the absent cards' experts would add is left out.
* Precision is the configuration's: f32 parameters, gradients and Adam
  state; bf16 activations; every product of bf16 operands on the tensor
  cores, accumulated in f32 (reduced-precision reductions off during a
  step); the router's product and softmax in f32; the norms in f32; the
  logits and the loss in f32.
* Each layer is recomputed in the backward pass (:class:`_Recompute`,
  ``remat``).  ``torch.utils.checkpoint`` would import ``torch._dynamo``
  and sympy, seconds of every fresh probe child; the recomputation here is
  the reentrant form in a few lines.
* Spans (:mod:`tpu_node_checker_torch.probe.spans`) cover each part's
  forward, its recomputation and its backward, which autograd runs on its
  own thread: ``workload.model_init``, ``mla.attention``, ``moe.route``,
  ``moe.experts`` and ``moe.shared``.  Counters, once a layer a step:
  ``moe_assignments`` (to any routed expert), ``moe_assignments_held``,
  ``moe_max_expert_tokens``, ``moe_layer_steps`` and
  ``moe_tokens_dropped`` (0 by design).

The weight recipe (the benchmark's reference draws the same): the
parameters in :func:`param_shapes`' order, tensor ``i`` drawn on the
step's device from its own ``torch.Generator`` seeded with
``(seed * 4096 + i) % 2**64``, as ``torch.randn(shape, generator=g,
device=device).mul_(initializer_range)``; the norms' scales are ones.
Token ids are Zipf-distributed (s = 1) over the held vocabulary, id ``j``
with weight ``1 / (j + 1)``, drawn by ``torch.multinomial`` on the CPU from
``torch.Generator().manual_seed(seed + 1)``.

The optimizer, the result and the health contract are the burn-in's
(:mod:`tpu_node_checker_torch.models.burnin`), whose step functions this
module does not call.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_node_checker_torch.models.burnin import WorkloadResult, _Adam, _verdict
from tpu_node_checker_torch.ops._harness import DeviceLike, resolve_device
from tpu_node_checker_torch.parallel import moe
from tpu_node_checker_torch.probe import spans

ACT = torch.bfloat16


@dataclass(frozen=True)
class DeepseekV2Config:
    """The published ``config.json`` of DeepSeek-V2-Lite, and the share held here.

    ``held_experts`` is (first, count) of each MoE layer's routed experts;
    ``vocab_held`` the rows of the vocabulary held (from row 0); ``batch``
    x ``seq`` the tokens of a step; ``remat`` recomputes each layer in the
    backward pass.  ``initializer_range`` is the weights' standard
    deviation (DeepSeek-V2's 0.006).
    """

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 1.0
    aux_loss_alpha: float = 0.001
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    initializer_range: float = 0.006
    held_experts: Tuple[int, int] = (0, 8)
    vocab_held: int = 12800
    batch: int = 4
    seq: int = 4096
    remat: bool = True

    def __post_init__(self):
        first, count = self.held_experts
        if not (0 <= first and count >= 1 and first + count <= self.n_routed_experts):
            raise ValueError(f"held_experts {self.held_experts} do not lie within the "
                             f"{self.n_routed_experts} routed experts")
        if not 1 <= self.vocab_held <= self.vocab_size:
            raise ValueError(f"vocab_held {self.vocab_held} is not within vocab_size "
                             f"{self.vocab_size}")
        if self.num_experts_per_tok > self.n_routed_experts:
            raise ValueError("num_experts_per_tok exceeds n_routed_experts")


def param_shapes(cfg: DeepseekV2Config) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in the model's order (its
    own, then each layer's): init ``"normal"`` or ``"ones"``.  Products are
    stored (in, out), the held experts stacked on a leading axis."""
    D, H = cfg.hidden_size, cfg.num_attention_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    n_held = cfg.held_experts[1]
    out = [("embed", (cfg.vocab_held, D), "normal"), ("norm", (D,), "ones"),
           ("lm_head", (D, cfg.vocab_held), "normal")]
    for l in range(cfg.num_hidden_layers):
        p = f"layers.{l}."
        out += [(p + "input_norm", (D,), "ones"),
                (p + "q_proj", (D, H * qk), "normal"),
                (p + "kv_a_proj", (D, cfg.kv_lora_rank + cfg.qk_rope_head_dim), "normal"),
                (p + "kv_a_norm", (cfg.kv_lora_rank,), "ones"),
                (p + "kv_b_proj", (cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                 "normal"),
                (p + "o_proj", (H * cfg.v_head_dim, D), "normal"),
                (p + "post_norm", (D,), "ones")]
        if l < cfg.first_k_dense_replace:
            Fd = cfg.intermediate_size
            out += [(p + "gate_proj", (D, Fd), "normal"), (p + "up_proj", (D, Fd), "normal"),
                    (p + "down_proj", (Fd, D), "normal")]
        else:
            Fe, Fs = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
            out += [(p + "router", (D, cfg.n_routed_experts), "normal"),
                    (p + "experts_gate", (n_held, D, Fe), "normal"),
                    (p + "experts_up", (n_held, D, Fe), "normal"),
                    (p + "experts_down", (n_held, Fe, D), "normal"),
                    (p + "shared_gate", (D, Fs), "normal"),
                    (p + "shared_up", (D, Fs), "normal"),
                    (p + "shared_down", (Fs, D), "normal")]
    return out


def draw_state(cfg: DeepseekV2Config, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each initial parameter by the module's recipe, one at a time, f32 on ``device``."""
    device = torch.device(device)
    for i, (name, shape, init) in enumerate(param_shapes(cfg)):
        if init == "ones":
            yield name, torch.ones(shape, device=device)
            continue
        g = torch.Generator(device=device).manual_seed((seed * 4096 + i) % 2 ** 64)
        yield name, torch.randn(shape, generator=g, device=device).mul_(cfg.initializer_range)


def zipf_tokens(cfg: DeepseekV2Config, seed: int) -> torch.Tensor:
    """(batch, seq) token ids, Zipf (s = 1) over the held vocabulary, on the CPU."""
    weights = 1.0 / torch.arange(1, cfg.vocab_held + 1, dtype=torch.float64)
    ids = torch.multinomial(weights, cfg.batch * cfg.seq, replacement=True,
                            generator=torch.Generator().manual_seed(seed + 1))
    return ids.view(cfg.batch, cfg.seq)


# -- YaRN --------------------------------------------------------------------


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """The rotary part's inverse frequencies (f32, ``qk_rope_head_dim / 2``):
    the extrapolated ones below YaRN's correction range, the interpolated
    (over ``rope_factor``) above it, a linear ramp between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def correction_dim(rotations: float) -> float:
        return (dim * math.log(cfg.original_max_position_embeddings
                               / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exponents = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exponents)
    freq_inter = 1.0 / (cfg.rope_factor * base ** exponents)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return freq_inter * (1 - extra_mask) + freq_extra * extra_mask


def rope_cos_sin(cfg: DeepseekV2Config, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), f32 (seq, qk_rope_head_dim), times YaRN's ``mscale``
    over its ``mscale_all_dim`` (1 at the published values)."""
    t = torch.arange(seq, dtype=torch.float32)
    freqs = torch.outer(t, yarn_inv_freq(cfg))
    emb = torch.cat((freqs, freqs), dim=-1)
    m = _yarn_mscale(cfg.rope_factor, cfg.mscale) / _yarn_mscale(cfg.rope_factor,
                                                                 cfg.mscale_all_dim)
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``q_head_dim ** -0.5`` times YaRN's ``mscale_all_dim`` correction squared."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.mscale_all_dim:
        m = _yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
        scale *= m * m
    return scale


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb`` of one tensor (B, h, S, d): its pairs
    de-interleaved, then ``x cos + rotate_half(x) sin``."""
    B, h, S, d = x.shape
    x = x.view(B, h, S, d // 2, 2).transpose(4, 3).reshape(B, h, S, d)
    rotated = torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)
    return x * cos + rotated * sin


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, the scaled result in ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (weight * y).to(x.dtype)


# -- the parts, each with its span over forward and backward ----------------


class _Attention(torch.autograd.Function):
    """Scores, causal mask, f32 softmax and P·V of bf16 q (B, H, S, dq),
    k (B, H, S, dq) and v (B, H, S, dv), one sequence at a time, as
    ``modeling_deepseek.py``'s eager attention computes them in bf16: the
    scores ``q kᵀ`` times the scale (applied to the product's f32 sums,
    before its one rounding to bf16), the mask, the softmax in f32 rounded
    to bf16, P·V.  The backward is autograd's over those operations, in
    their dtypes: the softmax's gradient one fused pass over its f32 output
    (``torch._softmax_backward_data``, the op autograd calls)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.round, ctx.scale = spans.current(), scale
        keep = any(ctx.needs_input_grad[:3])
        S = q.shape[2]
        masked = torch.ones((S, S), dtype=torch.bool, device=q.device).triu_(1)
        out, probs = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=v.dtype,
                                 device=v.device), []
        with spans.within(ctx.round, "mla.attention"):
            for b in range(q.shape[0]):
                s = _scaled_matmul(q[b], k[b].transpose(-1, -2), scale)
                p = torch.softmax(s.masked_fill_(masked, float("-inf")), dim=-1,
                                  dtype=torch.float32)
                out[b] = torch.matmul(p.to(v.dtype), v[b])
                if keep:
                    probs.append(p)
        ctx.save_for_backward(q, k, v, *probs)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, *probs = ctx.saved_tensors
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        with spans.within(ctx.round, "mla.attention"):
            for b, p in enumerate(probs):
                dv[b] = torch.matmul(p.to(v.dtype).transpose(-1, -2), d_out[b])
                dp = torch.matmul(d_out[b], v[b].transpose(-1, -2)).float()
                ds = torch._softmax_backward_data(dp, p, -1, p.dtype).to(q.dtype)
                dq[b] = _scaled_matmul(ds, k[b], ctx.scale)
                dk[b] = _scaled_matmul(ds.transpose(-1, -2), q[b], ctx.scale)
        return dq, dk, dv, None


def _scaled_matmul(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * (a @ b)`` of batched operands, the scale on the f32 sums."""
    out = torch.empty(a.shape[:-1] + b.shape[-1:], dtype=a.dtype, device=a.device)
    return torch.baddbmm(out, a, b, beta=0, alpha=scale)


class _Recompute(torch.autograd.Function):
    """A layer run without its graph and run again in the backward pass
    (reentrant recomputation): ``layer(x, counting)`` returns (hidden,
    balance loss); the recomputation counts nothing and spans under the
    forward's round."""

    @staticmethod
    def forward(ctx, layer, x):
        ctx.layer, ctx.round = layer, spans.current()
        ctx.save_for_backward(x)
        return layer(x, True)

    @staticmethod
    def backward(ctx, d_h, d_aux):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(True)
        with torch.enable_grad(), spans.within(ctx.round):
            h, aux = ctx.layer(x, False)
            total = (h.float() * d_h.float()).sum()
            if d_aux is not None and aux.requires_grad:
                total = total + aux * d_aux
            # A scalar's backward: parameters accumulate their gradients as
            # the step's own backward does, and no gradient tensor is passed
            # (which would import sympy).
            total.backward()
        return None, x.grad


@contextmanager
def _f32_accumulation():
    """bf16 products accumulated in f32 throughout (no reduced-precision
    split-K reductions), restored after."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


# -- the model ----------------------------------------------------------------


class DeepseekV2(nn.Module):
    """One card's share of DeepSeek-V2-Lite: token ids (B, S) → the loss.

    Parameters are drawn on ``device`` by the module's recipe
    (:func:`draw_state`) under the span ``workload.model_init``."""

    def __init__(self, cfg: DeepseekV2Config, seed: int = 0, device: DeviceLike = "cpu"):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(nn.ParameterDict() for _ in range(cfg.num_hidden_layers))
        with spans.span("workload.model_init"):
            for name, t in draw_state(cfg, seed, device):
                if name.startswith("layers."):
                    _, l, key = name.split(".")
                    self.layers[int(l)][key] = nn.Parameter(t)
                else:
                    self.register_parameter(name, nn.Parameter(t))
        cos, sin = rope_cos_sin(cfg, cfg.seq, device)
        self.cos, self.sin = cos.to(ACT), sin.to(ACT)
        self.scale = softmax_scale(cfg)

    def _attention(self, lp, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, nope, rope, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        q = torch.matmul(x, lp["q_proj"].to(ACT)).view(B, S, H, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        kv_a = torch.matmul(x, lp["kv_a_proj"].to(ACT))
        latent, k_pe = kv_a.split([cfg.kv_lora_rank, rope], dim=-1)
        k_pe = k_pe.reshape(B, S, 1, rope).transpose(1, 2)
        kv = torch.matmul(_rms_norm(latent, lp["kv_a_norm"], cfg.rms_norm_eps),
                          lp["kv_b_proj"].to(ACT)).view(B, S, H, nope + dv).transpose(1, 2)
        k_nope, v = kv.split([nope, dv], dim=-1)
        cos, sin = self.cos[:S], self.sin[:S]
        q_pe, k_pe = _rope(q_pe, cos, sin), _rope(k_pe, cos, sin)
        query = torch.cat((q_nope, q_pe), dim=-1)
        key = torch.cat((k_nope, k_pe.expand(B, H, S, rope)), dim=-1)
        ctx = _Attention.apply(query, key, v.contiguous(), self.scale)
        return torch.matmul(ctx.transpose(1, 2).reshape(B, S, H * dv), lp["o_proj"].to(ACT))

    def _moe(self, lp, x: torch.Tensor, batch: int, counting: bool):
        cfg = self.cfg
        return moe.expert_layer(
            x, lp["router"],
            tuple(lp[f"experts_{w}"].to(ACT) for w in ("gate", "up", "down")),
            tuple(lp[f"shared_{w}"].to(ACT) for w in ("gate", "up", "down")),
            held_first=cfg.held_experts[0], batch=batch, top_k=cfg.num_experts_per_tok,
            scaling=cfg.routed_scaling_factor, alpha=cfg.aux_loss_alpha, counting=counting)

    def _layer(self, l: int, x: torch.Tensor, counting: bool):
        """Decoder layer ``l`` of the hidden state (B, S, D): (hidden, balance loss)."""
        cfg, lp = self.cfg, self.layers[l]
        B, S, D = x.shape
        h = x + self._attention(lp, _rms_norm(x, lp["input_norm"], cfg.rms_norm_eps))
        y = _rms_norm(h, lp["post_norm"], cfg.rms_norm_eps).view(B * S, D)
        if l < cfg.first_k_dense_replace:
            out = moe.SwiGLU.apply(y, lp["gate_proj"].to(ACT), lp["up_proj"].to(ACT),
                                   lp["down_proj"].to(ACT), None)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            out, aux = self._moe(lp, y, B, counting)
        return h + out.view(B, S, D), aux

    def logits(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(f32 logits over the held vocabulary at every position but the
        last, (B, S - 1, V), the MoE layers' balance loss summed)."""
        h = self.embed[tokens].to(ACT)
        balance = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for l in range(self.cfg.num_hidden_layers):
            layer = partial(self._layer, l)
            h, aux = _Recompute.apply(layer, h) if self.cfg.remat else layer(h, True)
            balance = balance + aux
        h = _rms_norm(h[:, :-1], self.norm, self.cfg.rms_norm_eps)
        return torch.matmul(h, self.lm_head.to(ACT)).float(), balance

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """The mean next-token cross entropy over the held vocabulary, plus
        every MoE layer's balance loss: the objective the step descends."""
        logits, balance = self.logits(tokens)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        return ce + balance


def make_train_step(cfg: DeepseekV2Config, learning_rate: float = 1e-3,
                    device: DeviceLike = None):
    """Build ``(train_step, init_fn)`` on one device (``cuda:0`` unless the
    caller names another).

    ``init_fn(seed=0)`` returns ``(model, optimizer)``, the weights drawn
    by the recipe; ``train_step(model, optimizer, tokens)`` takes one Adam
    step in place on ``tokens`` and returns the loss before it."""
    dev = resolve_device(device)

    def init_fn(seed: int = 0):
        model = DeepseekV2(cfg, seed, dev)
        return model, _Adam(model.parameters(), lr=learning_rate)

    def step(model: DeepseekV2, opt: _Adam, tokens: torch.Tensor) -> torch.Tensor:
        with _f32_accumulation():
            opt.zero_grad()
            loss = model(tokens)
            loss.backward()
            opt.step()
        return loss.detach()

    return step, init_fn


def train_steps(cfg: DeepseekV2Config, steps: int = 3, seed: int = 0,
                tokens: Optional[torch.Tensor] = None,
                device: DeviceLike = None) -> Tuple[list, float]:
    """Take ``steps`` steps from the weights of ``seed`` on ``tokens``
    (Zipf, from ``seed + 1``, when None): ``(losses, step_time_ms)``, the
    time the mean of the steps after the first, each ending in a fetch of
    its loss."""
    step, init_fn = make_train_step(cfg, device=device)
    model, opt = init_fn(seed)
    if tokens is None:
        tokens = zipf_tokens(cfg, seed)
    tokens = tokens.to(model.embed.device)
    losses, t0 = [], None
    for i in range(steps):
        losses.append(float(step(model, opt, tokens)))  # host sync each step
        if i == 0:
            t0 = time.perf_counter()
    elapsed_ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3 if t0 else 0.0
    return losses, elapsed_ms


def workload_probe(cfg: Optional[DeepseekV2Config] = None, steps: int = 3, seed: int = 0,
                   device: DeviceLike = None) -> WorkloadResult:
    """Run ``steps`` training steps on one device; healthy ⇔ finite,
    strictly decreasing loss (the burn-in's contract)."""
    try:
        losses, elapsed_ms = train_steps(cfg or DeepseekV2Config(), steps, seed, device=device)
        return _verdict(losses, elapsed_ms)
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return WorkloadResult(ok=False, error=f"{type(exc).__name__}: {exc}")
