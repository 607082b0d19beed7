"""Burn-in workload: a transformer training step as a health probe.

The port of the JAX package's ``models/burnin.py`` for one card:

* the same model: token embedding, ``n_layers`` pre-norm blocks (causal
  multi-head attention, a tanh-GELU MLP), a final norm and an unembedding,
  with the layer parameters stacked on a leading axis as the JAX pytree
  stacks them, so one state dict carries across (:func:`convert.burnin_state`);
* the same mixed precision: f32 parameters and optimizer state, bf16
  activations, every product taken in f32 from the bf16 values and rounded
  back to bf16 where JAX rounds it (the layer norm computes in f32, the
  logits stay f32 for the log-softmax);
* ``attention="flash"`` puts the port's flash-attention kernel in the
  forward pass (its backward is autograd over the plain version, as the
  JAX package takes the vjp of its reference); ``"xla"`` is the plain
  einsum path;
* Adam, hand-rolled as the JAX package's ``_Adam`` is (:class:`_Adam`),
  stepping the parameters in place.

Health contract: :func:`workload_probe` runs a few steps and reports
``ok = loss finite and strictly decreasing``.  The sharded data × tensor
parallel step of the JAX package is not ported yet: a ``mesh`` argument
fails as such.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_node_checker_torch.ops._harness import DeviceLike, resolve_device
from tpu_node_checker_torch.ops.flash_attention import BLOCK, flash_attention


@dataclass(frozen=True)
class BurninConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    n_layers: int = 2
    seq: int = 128
    batch: int = 8
    dtype: str = "bfloat16"  # activation dtype; params stay float32
    # Recompute each layer's activations in the backward pass
    # (torch.utils.checkpoint): the saved activations drop from O(layers) to
    # O(1) for one extra forward.  Numerics are unchanged.
    remat: bool = False
    # "xla" (the plain einsum + softmax) or "flash" (the flash-attention
    # kernel of ops.flash_attention; seq must be a multiple of its 128-row
    # block).
    attention: str = "xla"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} is not divisible by n_heads {self.n_heads}"
            )
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 values with an f32 result, as JAX's
    ``preferred_element_type=float32``: both widen to f32 first, where the
    product of two bf16 values is exact and the sum runs in f32."""
    return torch.matmul(x.float(), w.float())


class _Adam:
    """Adam (Kingma & Ba) with bias correction, the JAX package's ``_Adam``
    term for term, updating the parameters in place.

    Not ``torch.optim.Adam``: its constructor imports ``torch._dynamo``,
    which on the card's machine costs as much as importing torch (8.7 s of
    a fresh process's first training step, PERF.md).
    """

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        mu_scale = 1.0 / (1.0 - self.b1 ** self.count)
        nu_scale = 1.0 / (1.0 - self.b2 ** self.count)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            mu.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            p.sub_(self.lr * (mu * mu_scale) / (torch.sqrt(nu * nu_scale) + self.eps))


def _layer_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


class Burnin(nn.Module):
    """The burn-in transformer: token ids (B, S) → logits (B, S, V) in f32.

    Parameters mirror the JAX package's ``init_params`` pytree: ``embed``
    (V, D), ``layers.{wq,wk,wv,wo}`` (L, D, D), ``layers.w1`` (L, D, F),
    ``layers.w2`` (L, F, D), ``layers.{ln1,ln2}`` (L, D), ``ln_f`` (D),
    ``unembed`` (D, V), all f32, drawn as the JAX package draws them (normal
    over sqrt(fan-in), the embedding at 0.02, the norms at 1) from
    ``generator``'s numbers, which are not JAX's.
    """

    def __init__(self, cfg: BurninConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
        _ = cfg.head_dim  # raises on indivisible heads

        def dense(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
            return nn.Parameter(torch.randn(shape, generator=generator) * scale)

        self.embed = dense(V, D, scale=0.02)
        self.layers = nn.ParameterDict({
            "wq": dense(L, D, D),
            "wk": dense(L, D, D),
            "wv": dense(L, D, D),
            "wo": dense(L, D, D),
            "w1": dense(L, D, Fd),
            "w2": dense(L, Fd, D),
            "ln1": nn.Parameter(torch.ones(L, D)),
            "ln2": nn.Parameter(torch.ones(L, D)),
        })
        self.ln_f = nn.Parameter(torch.ones(D))
        self.unembed = dense(D, V)

    def _attention(self, x: torch.Tensor, l: int, mask: torch.Tensor) -> torch.Tensor:
        cfg, lp = self.cfg, self.layers
        B, S, D = x.shape
        H, Hd, dt = cfg.n_heads, cfg.head_dim, cfg.act_dtype
        q, k, v = (
            _dot(x, lp[w][l].to(dt)).reshape(B, S, H, Hd).to(dt) for w in ("wq", "wk", "wv")
        )
        if cfg.attention == "flash":
            # The kernel's layout is (B, H, S, D) and its mask is built in.
            ctx = flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ).transpose(1, 2)
        else:
            scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
            scores = scores / math.sqrt(Hd) + mask
            probs = torch.softmax(scores, dim=-1).to(dt)
            ctx = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
        ctx = ctx.reshape(B, S, D).to(dt)
        return _dot(ctx, lp["wo"][l].to(dt)).to(dt)

    def _mlp(self, x: torch.Tensor, l: int) -> torch.Tensor:
        dt = self.cfg.act_dtype
        h = _dot(x, self.layers["w1"][l].to(dt))
        h = F.gelu(h, approximate="tanh").to(dt)  # jax.nn.gelu's default form
        return _dot(h, self.layers["w2"][l].to(dt)).to(dt)

    def _block(self, h: torch.Tensor, l: int, mask: torch.Tensor) -> torch.Tensor:
        h = h + self._attention(_layer_norm(h, self.layers["ln1"][l]), l, mask)
        return h + self._mlp(_layer_norm(h, self.layers["ln2"][l]), l)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.act_dtype
        S = tokens.shape[1]
        x = self.embed.to(dt)[tokens]
        keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=tokens.device))
        mask = torch.where(keep, 0.0, -1e9)[None, None]
        for l in range(self.cfg.n_layers):
            if self.cfg.remat:
                x = checkpoint(self._block, x, l, mask, use_reentrant=False)
            else:
                x = self._block(x, l, mask)
        x = _layer_norm(x, self.ln_f)
        return _dot(x, self.unembed.to(dt))


def _loss(model: Burnin, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (tokens double as inputs and shifted targets)."""
    logits = model(tokens)[:, :-1]
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def make_train_step(
    cfg: BurninConfig,
    mesh=None,
    learning_rate: float = 1e-3,
    device: DeviceLike = None,
):
    """Build ``(train_step, init_fn)`` for one device.

    ``init_fn(seed=0, state=None)`` returns ``(model, optimizer)`` on the
    device (``cuda:0`` unless the caller names another), with the
    parameters drawn from ``seed`` or loaded from ``state`` (a state dict,
    e.g. :func:`tpu_node_checker_torch.convert.burnin_state`).
    ``train_step(model, optimizer, tokens)`` takes one step in place and
    returns the loss before it.  A ``mesh`` (the sharded step) is not yet
    ported and raises as such.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded (data x model) training step is not yet ported to the "
            "PyTorch/CUDA probe; it runs on one card"
        )
    if cfg.attention not in ("xla", "flash"):
        raise ValueError(f'attention must be "xla" or "flash", got {cfg.attention!r}')
    if cfg.attention == "flash" and cfg.seq % BLOCK:
        raise ValueError(
            f'attention="flash" needs seq % {BLOCK} == 0, got seq={cfg.seq}'
        )
    dev = resolve_device(device)

    def init_fn(seed: int = 0, state: Optional[dict] = None):
        model = Burnin(cfg, generator=torch.Generator().manual_seed(seed))
        if state is not None:
            model.load_state_dict(state)
        model = model.to(dev)
        return model, _Adam(model.parameters(), lr=learning_rate)

    def step(model: Burnin, opt: _Adam, tokens: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        loss = _loss(model, tokens)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, init_fn


@dataclass
class WorkloadResult:
    ok: bool
    losses: Tuple[float, ...] = field(default_factory=tuple)
    step_time_ms: float = 0.0
    error: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"ok": self.ok, "losses": list(self.losses), "step_time_ms": self.step_time_ms}
        if self.error:
            d["error"] = self.error
        return d


def workload_probe(
    cfg: Optional[BurninConfig] = None,
    mesh=None,
    steps: int = 3,
    seed: int = 0,
    device: DeviceLike = None,
) -> WorkloadResult:
    """Run ``steps`` training steps; healthy ⇔ finite, strictly decreasing loss.

    The tokens are drawn from ``seed + 1``.  ``step_time_ms`` is the mean
    of the steps after the first, each ending in a fetch of its loss."""
    try:
        cfg = cfg or BurninConfig()
        step, init_fn = make_train_step(cfg, mesh, device=device)
        model, opt = init_fn(seed)
        tokens = torch.randint(
            0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(seed + 1)
        ).to(model.embed.device)
        losses = []
        t0 = None
        for i in range(steps):
            losses.append(float(step(model, opt, tokens)))  # host sync each step
            if i == 0:
                t0 = time.perf_counter()  # steady-state timing after the first step
        elapsed_ms = (
            (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3 if t0 else 0.0
        )
        finite = all(math.isfinite(l) for l in losses)
        decreasing = all(b < a for a, b in zip(losses, losses[1:]))
        ok = finite and decreasing
        err = None
        if not finite:
            err = f"non-finite loss: {losses}"
        elif not decreasing:
            err = f"loss not decreasing: {losses}"
        return WorkloadResult(ok=ok, losses=tuple(losses), step_time_ms=elapsed_ms, error=err)
    except Exception as exc:  # probes report, never raise
        return WorkloadResult(ok=False, error=f"{type(exc).__name__}: {exc}")
