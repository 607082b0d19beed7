"""Burn-in workload: a transformer training step as a health probe.

The port of the JAX package's ``models/burnin.py``:

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
  stepping the parameters in place;
* with a ``("data", "model")`` mesh, the data × tensor parallel step over
  the ranks of a group: each rank holds the shard of every parameter that
  :func:`param_specs` gives its ``model`` coordinate (the JAX package's
  layout: attention heads, the MLP's hidden units, the embedding's columns
  and the vocabulary split over ``model``, the norms replicated), takes its
  rows of the batch over ``data``, and averages its gradients over
  ``data``.  Explicit collectives stand where GSPMD inserts them, as
  autograd functions (:class:`_ModelParallel`): identity forward and
  all_reduce backward before a column-parallel product, all_reduce forward
  (of the f32 partial products, before the bf16 rounding) after a
  row-parallel one, all_gather forward and the rank's own slice backward
  where a replicated activation is gathered.  Flash attention stays on the
  one-card step, as in the JAX package.

Health contract: :func:`workload_probe` runs a few steps and reports
``ok = loss finite and strictly decreasing``; sharded, the loss is the
global batch's mean on every rank.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_node_checker_torch.ops._harness import DeviceLike, resolve_device
from tpu_node_checker_torch.ops.flash_attention import BLOCK, flash_attention
from tpu_node_checker_torch.parallel.mesh import MeshSpec, RankMesh, build_mesh, local_device


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


def param_specs(cfg: BurninConfig) -> dict:
    """The tensor-parallel layout, as the JAX package's ``param_specs``
    (a ``PartitionSpec`` as a tuple): attention heads and the MLP hidden dim
    shard over ``"model"``; the norms replicate; the layer axis never shards."""
    del cfg  # the layout does not depend on the sizes
    return {
        "embed": (None, "model"),
        "layers": {
            "wq": (None, None, "model"),
            "wk": (None, None, "model"),
            "wv": (None, None, "model"),
            "wo": (None, "model", None),
            "w1": (None, None, "model"),
            "w2": (None, "model", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "ln_f": (None,),
        "unembed": (None, "model"),
    }


def _state_specs(cfg: BurninConfig) -> Dict[str, tuple]:
    """:func:`param_specs` under the state dict's names (``layers.wq``)."""
    specs = param_specs(cfg)
    flat = {k: v for k, v in specs.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in specs["layers"].items()})
    return flat


def shard_state(state: dict, cfg: BurninConfig, index: int, count: int) -> dict:
    """The shard of every tensor of a one-card state dict that the rank at
    ``model`` coordinate ``index`` of ``count`` holds: the ``index``-th of
    ``count`` equal contiguous blocks along the dimension its spec shards."""
    out = {}
    for name, spec in _state_specs(cfg).items():
        t = state[name]
        if "model" in spec:
            dim = spec.index("model")
            if t.shape[dim] % count:
                raise ValueError(
                    f"{name} dim {dim} of size {t.shape[dim]} does not split "
                    f"{count} ways over the model axis"
                )
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
        out[name] = t.contiguous()
    return out


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group``, taken in f32, in x's dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all_reduce backward: a replicated activation
    entering a column-parallel product, whose gradient each rank holds only
    for its own columns."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """all_reduce forward, identity backward: the partial products of a
    row-parallel product summed into the replicated activation."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """all_gather along the last dimension forward, the rank's own slice
    backward: every rank computes the same loss from the gathered tensor,
    so each holds the whole gradient and keeps its columns."""

    @staticmethod
    def forward(ctx, x, group, index, count):
        ctx.index, ctx.width = index, x.shape[-1]
        # f32 on the wire (exact for bf16 values): gloo gathers no bf16.
        parts = torch.empty((count * x.shape[0],) + x.shape[1:], dtype=torch.float32,
                            device=x.device)
        dist.all_gather_into_tensor(parts, x.to(torch.float32).contiguous(), group=group)
        return torch.cat(parts.chunk(count), dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width], None, None, None


class _ModelParallel:
    """The tensor-parallel operators over the ``model`` line of a mesh:
    identities without a mesh, or when the line holds one rank."""

    def __init__(self, mesh: Optional[RankMesh] = None):
        self.group = mesh.groups["model"] if mesh is not None else None
        self.index = mesh.index("model") if mesh is not None else 0
        self.count = mesh.size("model") if mesh is not None else 1

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.count == 1 else _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.count == 1 else _ReduceFromModel.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.count == 1:
            return x
        return _GatherFromModel.apply(x, self.group, self.index, self.count)


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

    With a ``mesh``, this rank's shards of the same draw
    (:func:`shard_state`), and the forward pass runs its part of the
    tensor-parallel model, returning the full logits on every rank.
    """

    def __init__(self, cfg: BurninConfig, generator: Optional[torch.Generator] = None,
                 mesh: Optional[RankMesh] = None):
        super().__init__()
        self.cfg = cfg
        self.mp = _ModelParallel(mesh)
        L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
        _ = cfg.head_dim  # raises on indivisible heads

        def dense(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
            return torch.randn(shape, generator=generator) * scale

        full = {
            "embed": dense(V, D, scale=0.02),
            "layers.wq": dense(L, D, D),
            "layers.wk": dense(L, D, D),
            "layers.wv": dense(L, D, D),
            "layers.wo": dense(L, D, D),
            "layers.w1": dense(L, D, Fd),
            "layers.w2": dense(L, Fd, D),
            "layers.ln1": torch.ones(L, D),
            "layers.ln2": torch.ones(L, D),
            "ln_f": torch.ones(D),
            "unembed": dense(D, V),
        }
        own = shard_state(full, cfg, self.mp.index, self.mp.count)
        self.embed = nn.Parameter(own["embed"])
        self.layers = nn.ParameterDict({
            k.split(".", 1)[1]: nn.Parameter(t) for k, t in own.items() if k.startswith("layers.")
        })
        self.ln_f = nn.Parameter(own["ln_f"])
        self.unembed = nn.Parameter(own["unembed"])

    def _attention(self, x: torch.Tensor, l: int, mask: torch.Tensor) -> torch.Tensor:
        cfg, lp = self.cfg, self.layers
        B, S, _ = x.shape
        Hd, dt = cfg.head_dim, cfg.act_dtype
        x = self.mp.copy(x)
        # This rank's heads: its columns of wq, wk and wv are whole heads.
        q, k, v = (
            _dot(x, lp[w][l].to(dt)).reshape(B, S, -1, Hd).to(dt) for w in ("wq", "wk", "wv")
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
        ctx = ctx.reshape(B, S, -1).to(dt)
        return self.mp.reduce(_dot(ctx, lp["wo"][l].to(dt))).to(dt)

    def _mlp(self, x: torch.Tensor, l: int) -> torch.Tensor:
        dt = self.cfg.act_dtype
        h = _dot(self.mp.copy(x), self.layers["w1"][l].to(dt))
        h = F.gelu(h, approximate="tanh").to(dt)  # jax.nn.gelu's default form
        return self.mp.reduce(_dot(h, self.layers["w2"][l].to(dt))).to(dt)

    def _block(self, h: torch.Tensor, l: int, mask: torch.Tensor) -> torch.Tensor:
        h = h + self._attention(_layer_norm(h, self.layers["ln1"][l]), l, mask)
        return h + self._mlp(_layer_norm(h, self.layers["ln2"][l]), l)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.act_dtype
        S = tokens.shape[1]
        x = self.mp.gather(self.embed.to(dt)[tokens])
        keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device=tokens.device))
        mask = torch.where(keep, 0.0, -1e9)[None, None]
        for l in range(self.cfg.n_layers):
            if self.cfg.remat:
                x = checkpoint(self._block, x, l, mask, use_reentrant=False)
            else:
                x = self._block(x, l, mask)
        x = _layer_norm(x, self.ln_f)
        return self.mp.gather(_dot(self.mp.copy(x), self.unembed.to(dt)))


def _loss(model: Burnin, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (tokens double as inputs and shifted targets)."""
    logits = model(tokens)[:, :-1]
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def workload_mesh(n_devices: int, batch: int) -> Optional[MeshSpec]:
    """The data × model mesh the probe shards its step over on ``n_devices``
    cards, as the JAX child picks it: ``model`` 2 on an even count, else 1,
    ``data`` the rest, when the batch splits ``data`` ways; else None (the
    one-card step)."""
    if n_devices < 2:
        return None
    model = 2 if n_devices % 2 == 0 else 1
    data = n_devices // model
    return MeshSpec((("data", data), ("model", model))) if batch % data == 0 else None


def _check_shardable(cfg: BurninConfig, spec: MeshSpec) -> None:
    if spec.axis_names != ("data", "model"):
        raise ValueError(
            f"the sharded step needs mesh axes ('data', 'model'), got {spec.axis_names}"
        )
    data, model = spec.shape
    if cfg.batch % data:
        raise ValueError(f"batch {cfg.batch} does not split over data={data}")
    for name, size in (("n_heads", cfg.n_heads), ("d_model", cfg.d_model),
                       ("d_ff", cfg.d_ff), ("vocab", cfg.vocab)):
        if size % model:
            raise ValueError(f"{name} {size} does not split over model={model}")


def _data_parallel(model: Burnin, loss: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Average the gradients over ``data``; the global batch's mean loss,
    the same on every rank."""
    data = mesh.size("data")
    if data > 1:
        grads = [p.grad for p in model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads]) / data
        dist.all_reduce(flat, group=mesh.groups["data"])
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    # Every model rank holds the same loss: the mean over all ranks is the
    # mean over the data shards, and one all_reduce leaves it bitwise equal.
    total = loss.detach().clone()
    dist.all_reduce(total)
    return total / dist.get_world_size()


def make_train_step(
    cfg: BurninConfig,
    mesh: Optional[MeshSpec] = None,
    learning_rate: float = 1e-3,
    device: DeviceLike = None,
):
    """Build ``(train_step, init_fn)``.

    ``init_fn(seed=0, state=None)`` returns ``(model, optimizer)``, with
    the parameters drawn from ``seed`` or loaded from ``state`` (a one-card
    state dict, e.g. :func:`tpu_node_checker_torch.convert.burnin_state`).
    ``train_step(model, optimizer, tokens)`` takes one step in place on the
    batch ``tokens`` and returns the loss before it.

    Without a mesh everything stays on one device (``cuda:0`` unless the
    caller names another).  With a ``("data", "model")`` mesh spec, every
    rank of the live group builds and calls both, on its own device: the
    model holds the rank's shards (:func:`shard_state`), each step takes the
    rank's rows of the whole batch, and the loss is the whole batch's.
    """
    if cfg.attention not in ("xla", "flash"):
        raise ValueError(f'attention must be "xla" or "flash", got {cfg.attention!r}')
    if cfg.attention == "flash":
        if mesh is not None:
            raise ValueError(
                'attention="flash" is single-device only; the sharded step '
                'keeps "xla" attention'
            )
        if cfg.seq % BLOCK:
            raise ValueError(
                f'attention="flash" needs seq % {BLOCK} == 0, got seq={cfg.seq}'
            )
    rank_mesh = None
    if mesh is not None:
        _check_shardable(cfg, mesh)
        rank_mesh = build_mesh(mesh)
        dev = local_device()
        data, d = rank_mesh.size("data"), rank_mesh.index("data")
        rows = slice(d * cfg.batch // data, (d + 1) * cfg.batch // data)
    else:
        dev = resolve_device(device)

    def init_fn(seed: int = 0, state: Optional[dict] = None):
        model = Burnin(cfg, generator=torch.Generator().manual_seed(seed), mesh=rank_mesh)
        if state is not None:
            model.load_state_dict(shard_state(state, cfg, model.mp.index, model.mp.count))
        model = model.to(dev)
        return model, _Adam(model.parameters(), lr=learning_rate)

    def step(model: Burnin, opt: _Adam, tokens: torch.Tensor) -> torch.Tensor:
        opt.zero_grad()
        if rank_mesh is not None:
            tokens = tokens[rows]
        loss = _loss(model, tokens)
        loss.backward()
        if rank_mesh is not None:
            loss = _data_parallel(model, loss, rank_mesh)
        opt.step()
        return loss.detach()

    return step, init_fn


def train_steps(
    cfg: BurninConfig,
    mesh: Optional[MeshSpec] = None,
    steps: int = 3,
    seed: int = 0,
    state: Optional[dict] = None,
    tokens: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
    keep_grads: bool = False,
) -> Tuple[list, float, Optional[dict]]:
    """Take ``steps`` steps from ``seed`` (or ``state``) on ``tokens`` (drawn
    from ``seed + 1`` when None): ``(losses, step_time_ms, grads)``.

    ``step_time_ms`` is the mean of the steps after the first, each ending
    in a fetch of its loss; ``grads`` (with ``keep_grads``) are the first
    step's gradients of this rank's parameters, on the CPU."""
    step, init_fn = make_train_step(cfg, mesh, device=device)
    model, opt = init_fn(seed, state)
    if tokens is None:
        tokens = torch.randint(
            0, cfg.vocab, (cfg.batch, cfg.seq), generator=torch.Generator().manual_seed(seed + 1)
        )
    tokens = tokens.to(model.embed.device)
    losses, grads = [], None
    t0 = None
    for i in range(steps):
        losses.append(float(step(model, opt, tokens)))  # host sync each step
        if i == 0:
            if keep_grads:
                grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            t0 = time.perf_counter()  # steady-state timing after the first step
    elapsed_ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3 if t0 else 0.0
    return losses, elapsed_ms, grads


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


def _verdict(losses: list, step_time_ms: float) -> WorkloadResult:
    """The health contract of a training probe: ok ⇔ every loss finite and
    each strictly below the one before."""
    finite = all(math.isfinite(l) for l in losses)
    decreasing = all(b < a for a, b in zip(losses, losses[1:]))
    err = None
    if not finite:
        err = f"non-finite loss: {losses}"
    elif not decreasing:
        err = f"loss not decreasing: {losses}"
    return WorkloadResult(ok=finite and decreasing, losses=tuple(losses),
                          step_time_ms=step_time_ms, error=err)


def workload_probe(
    cfg: Optional[BurninConfig] = None,
    mesh: Optional[MeshSpec] = None,
    steps: int = 3,
    seed: int = 0,
    device: DeviceLike = None,
) -> WorkloadResult:
    """Run ``steps`` training steps; healthy ⇔ finite, strictly decreasing loss.

    The tokens are drawn from ``seed + 1``.  With a mesh, every rank of the
    group calls it and each returns the same result."""
    try:
        cfg = cfg or BurninConfig()
        losses, elapsed_ms, _ = train_steps(cfg, mesh, steps, seed, device=device)
        return _verdict(losses, elapsed_ms)
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return WorkloadResult(ok=False, error=f"{type(exc).__name__}: {exc}")
