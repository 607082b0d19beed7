"""The burn-in transformer's training steps in plain PyTorch, float64.

The burn-in model as its configuration publishes it: a token embedding;
``n_layers`` pre-norm blocks, each a causal multi-head attention and a
tanh-GELU MLP added to the residual; a final norm; an unembedding; the mean
next-token cross-entropy (the tokens are both the inputs and, shifted by
one, the targets); and Adam with bias correction (b1 0.9, b2 0.999, eps
1e-8, the learning rate as recorded).  The norms scale and carry no bias
(eps 1e-6).  A step's loss is the one taken before its update.

The program's inputs are data here: the hook records the whole initial
state where the program draws it, and the step's whole batch of tokens,
as one float32 vector (the state's names and shapes in ``args["state"]``,
then the ``batch x seq`` tokens).  Sharded data x model, every rank
returns the whole batch's loss and steps with the whole batch's gradient,
which are the unsharded step's: the reference is the one-card step on the
whole batch, and a rank's leaf is its block of the reference's leaf
(``args["leaves"]``: the dimension the leaf is split along, or -1, and the
rank's ``model_index`` of ``model_count``).

The reference runs in float64 with TF32 off and rounds nothing.  The
control (``precision="fp8"``) rounds to float8 e4m3, each tensor scaled by
its largest magnitude, at every point where the configuration states bf16:
the weights entering each product, the embedding, each norm's output, q, k,
v, the attention probabilities and context, the MLP's hidden activation,
each layer's outputs and the residual stream; the logits and the loss stay
unrounded, as in float64.  The rounding is straight-through for the
gradients.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np
import torch

from probebench.reference import probes as ref

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
NORM_EPS = 1e-6
# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3

_cache: dict = {}


def unpack(args: dict, inputs: np.ndarray, device) -> tuple:
    """(state: name -> float64 tensor, tokens: (batch, seq) long) from the
    recorded vector."""
    flat = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.float32)).to(device)
    state, at = {}, 0
    for name, shape in args["state"]:
        n = math.prod(shape)
        state[name] = flat[at:at + n].reshape(shape).double()
        at += n
    b, s = args["batch"], args["seq"]
    if flat.numel() != at + b * s:
        raise ValueError(f"burnin: {flat.numel()} recorded values, the layout needs "
                         f"{at + b * s}")
    return state, flat[at:].round().long().reshape(b, s)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 forward, unchanged backward."""
    with torch.no_grad():
        low = ref.fp8_round(x.detach()).to(x.dtype)
    return x + (low - x).detach()


def _norm(x, scale, rnd):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return rnd((x - mu) * torch.rsqrt(var + NORM_EPS) * scale)


def loss_of(p: dict, tokens: torch.Tensor, n_heads: int, rnd=lambda t: t) -> torch.Tensor:
    """The mean next-token cross-entropy of the model ``p`` on ``tokens``."""
    B, S = tokens.shape
    L, D = p["layers.wq"].shape[0], p["layers.wq"].shape[1]
    hd = D // n_heads
    causal = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    h = rnd(p["embed"])[tokens]
    for l in range(L):
        x = _norm(h, p["layers.ln1"][l], rnd)
        q, k, v = (rnd(x @ rnd(p[f"layers.{w}"][l])).reshape(B, S, n_heads, hd)
                   for w in ("wq", "wk", "wv"))
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        probs = rnd(torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1))
        ctx = rnd(torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, D))
        h = rnd(h + rnd(ctx @ rnd(p["layers.wo"][l])))
        x = _norm(h, p["layers.ln2"][l], rnd)
        hidden = rnd(torch.nn.functional.gelu(x @ rnd(p["layers.w1"][l]), approximate="tanh"))
        h = rnd(h + rnd(hidden @ rnd(p["layers.w2"][l])))
    logits = _norm(h, p["ln_f"], rnd) @ rnd(p["unembed"])
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).mean()


def train(args: dict, inputs: np.ndarray, steps: int, device, precision: str = "f64") -> dict:
    """``steps`` Adam steps from the recorded state: ``losses`` (before each
    step), ``grads`` (the first step's, whole leaves) and ``change`` (each
    leaf's change over the steps)."""
    state, tokens = unpack(args, inputs, device)
    rnd = _fp8 if precision == "fp8" else (lambda t: t)
    params = {k: t.clone().requires_grad_(True) for k, t in state.items()}
    mu = {k: torch.zeros_like(t) for k, t in state.items()}
    nu = {k: torch.zeros_like(t) for k, t in state.items()}
    lr, losses, first = args["learning_rate"], [], None
    with ref.exact_matmul():
        for t in range(1, steps + 1):
            loss = loss_of(params, tokens, args["n_heads"], rnd)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = dict(zip(params, grads))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mu[k].mul_(B1).add_(g, alpha=1 - B1)
                    nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                    m_hat = mu[k] / (1 - B1 ** t)
                    v_hat = nu[k] / (1 - B2 ** t)
                    p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
    return {"losses": np.array(losses, dtype=np.float64), "grads": first,
            "change": {k: (params[k].detach() - state[k]) for k in state}}


def trained(args: dict, inputs: np.ndarray, steps: int, device, precision: str = "f64") -> dict:
    """:func:`train`, once for each set of inputs."""
    key = (hashlib.sha1(np.ascontiguousarray(inputs).tobytes()).hexdigest(),
           json.dumps(args["state"]), args["learning_rate"], args["n_heads"], steps,
           str(device), precision)
    if key not in _cache:
        _cache[key] = train(args, inputs, steps, device, precision)
    return _cache[key]


def block(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """The rank's block of a whole leaf: the ``index``-th of ``count``
    equal blocks along ``dim`` (-1: the whole leaf)."""
    if dim < 0 or count == 1:
        return t
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size)


def leaf_norms(leaves: dict, args: dict) -> np.ndarray:
    """The norm of the rank's block of each recorded leaf, in its order."""
    return np.array([float(block(leaves[name], dim, args["model_index"], args["model_count"])
                           .norm()) for name, dim in args["leaves"]])


def worst_leaf_gap(got: np.ndarray, want: np.ndarray, keep=None) -> float:
    """The largest |got - want| over a leaf's reference norm or the median
    leaf's, whichever is larger, over the leaves ``keep`` allows."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    keep = np.ones(len(want), dtype=bool) if keep is None else keep
    if not keep.any():
        return 0.0
    scale = np.maximum(want, np.median(want))
    return ref.worst((np.abs(got - want) / scale)[keep])
