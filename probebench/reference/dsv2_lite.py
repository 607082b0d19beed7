"""DeepSeek-V2-Lite's training steps, one card's share, in plain PyTorch, float32.

The equations of the published ``modeling_deepseek.py`` by name: token
embedding; decoder layers of MLA attention (q one dense projection, the
512-wide latent with its own RMSNorm, the decoupled rotary key shared by
every head, YaRN's frequencies and the pairs de-interleaved before
``rotate_half``, the softmax scale times ``mscale_all_dim`` squared) and an
MLP, dense in the first ``first_k_dense_replace`` layers and the expert
layer after (softmax router, greedy top-k, weights unnormalised times
``routed_scaling_factor``, shared experts, the ``seq_aux`` balance loss
times ``aux_loss_alpha``, added to the loss); the final norm; the head;
the mean next-token cross entropy; Adam with bias correction (b1 0.9, b2
0.999, eps 1e-8).  A step's loss is the one taken before its update.

Departures from the published module, each the program's too: the
vocabulary is the card's slice (``vocab_held`` rows from 0), so the
embedding, the head, the logits and the loss are over the slice; each
expert layer computes only the held experts' part of the combine
(``held_experts``: first, count), the router still over every routed
expert, the balance loss from the whole router; routing is dropless, every
assignment computed (the published module's forward drops none either).

The weights are data made from the recorded seed by the program's written
recipe (``args["cfg"]``, ``args["seed"]``): tensor ``i`` of
:func:`param_shapes` from ``torch.Generator(device).manual_seed((seed *
4096 + i) % 2**64)`` as ``torch.randn(shape).mul_(initializer_range)``,
the norms ones, drawn on a device of the kind the program drew on
(``args["draw_device"]``).  The tokens are the recorded ones.

The reference runs in float32 with TF32 off, every layer and each
sequence's attention recomputed in the backward pass so that the model fits
the card.  The control (``precision="fp8"``) rounds to float8 e4m3, each
tensor scaled by its largest magnitude, at every point where the
configuration states bf16: the weights entering each product (the router's
stays f32), the embedding, each norm's output, q, k and v, the attention
probabilities and context, each SwiGLU's hidden activation and output,
each layer's attention and MLP outputs and the residual stream; the
router, the logits and the loss stay unrounded.  The rounding is
straight-through for the gradients.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from probebench.reference import probes as ref

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8

_cache: dict = {}


def param_shapes(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in the recipe's order."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    V, held = cfg["vocab_held"], cfg["held_experts"][1]
    out = [("embed", (V, D), "normal"), ("norm", (D,), "ones"), ("lm_head", (D, V), "normal")]
    for l in range(cfg["num_hidden_layers"]):
        p = f"layers.{l}."
        out += [(p + "input_norm", (D,), "ones"), (p + "q_proj", (D, H * (nope + rope)), "normal"),
                (p + "kv_a_proj", (D, r + rope), "normal"), (p + "kv_a_norm", (r,), "ones"),
                (p + "kv_b_proj", (r, H * (nope + dv)), "normal"),
                (p + "o_proj", (H * dv, D), "normal"), (p + "post_norm", (D,), "ones")]
        if l < cfg["first_k_dense_replace"]:
            Fd = cfg["intermediate_size"]
            out += [(p + "gate_proj", (D, Fd), "normal"), (p + "up_proj", (D, Fd), "normal"),
                    (p + "down_proj", (Fd, D), "normal")]
        else:
            Fe = cfg["moe_intermediate_size"]
            Fs = Fe * cfg["n_shared_experts"]
            out += [(p + "router", (D, cfg["n_routed_experts"]), "normal"),
                    (p + "experts_gate", (held, D, Fe), "normal"),
                    (p + "experts_up", (held, D, Fe), "normal"),
                    (p + "experts_down", (held, Fe, D), "normal"),
                    (p + "shared_gate", (D, Fs), "normal"), (p + "shared_up", (D, Fs), "normal"),
                    (p + "shared_down", (Fs, D), "normal")]
    return out


def draw(cfg: dict, seed: int, index: int, shape: tuple, init: str, device) -> torch.Tensor:
    """Tensor ``index`` of the recipe, float32 on ``device``."""
    if init == "ones":
        return torch.ones(shape, device=device)
    g = torch.Generator(device=device).manual_seed((seed * 4096 + index) % 2 ** 64)
    return torch.randn(shape, generator=g, device=device).mul_(cfg["initializer_range"])


def initial_state(cfg: dict, seed: int, device) -> dict:
    return {name: draw(cfg, seed, i, shape, init, device)
            for i, (name, shape, init) in enumerate(param_shapes(cfg))}


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rotary(cfg: dict, seq: int, device) -> tuple:
    """``DeepseekV2YarnRotaryEmbedding``'s (cos, sin) for positions 0 .. seq - 1."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    factor, original = cfg["rope_factor"], cfg["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(cfg["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inv_freq_mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low)
                           / (high - low)).clamp(0, 1)
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    mscale = yarn_mscale(factor, cfg["mscale"]) / yarn_mscale(factor, cfg["mscale_all_dim"])
    return (emb.cos() * mscale).to(device), (emb.sin() * mscale).to(device)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if cfg["mscale_all_dim"]:
        m = yarn_mscale(cfg["rope_factor"], cfg["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_half(x):
    return torch.cat((-x[..., x.shape[-1] // 2:], x[..., : x.shape[-1] // 2]), dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    b, h, s, d = q.shape
    q = q.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    b, h, s, d = k.shape
    k = k.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def rms_norm(x, weight, eps, rnd):
    return rnd(weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 forward, unchanged backward."""
    if x.numel() == 0:  # an expert that no token chose
        return x
    with torch.no_grad():
        low = ref.fp8_round(x.detach()).to(x.dtype)
    return x + (low - x).detach()


def _one_sequence(q, k, v, scale, rnd):
    """One sequence's scores, causal mask, softmax and P·V: q, k (H, S, dq), v (H, S, dv)."""
    S = q.shape[1]
    masked = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    scores = (q @ k.transpose(-1, -2) * scale).masked_fill(masked, float("-inf"))
    return rnd(torch.softmax(scores, dim=-1)) @ v


def attention(p, l, x, cfg, cos, sin, rnd):
    B, S, _ = x.shape
    H, nope, rope, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    w = lambda name: rnd(p[f"layers.{l}.{name}"])
    q = rnd(x @ w("q_proj")).view(B, S, H, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    compressed_kv, k_pe = (x @ w("kv_a_proj")).split([cfg["kv_lora_rank"], rope], dim=-1)
    k_pe = rnd(k_pe).reshape(B, S, 1, rope).transpose(1, 2)
    kv = rnd(rms_norm(compressed_kv, p[f"layers.{l}.kv_a_norm"], cfg["rms_norm_eps"], rnd)
             @ w("kv_b_proj")).view(B, S, H, nope + dv).transpose(1, 2)
    k_nope, value_states = kv.split([nope, dv], dim=-1)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    query_states = torch.cat((q_nope, rnd(q_pe)), dim=-1)
    key_states = torch.cat((k_nope, rnd(k_pe).expand(B, H, S, rope)), dim=-1)
    scale = softmax_scale(cfg)
    out = torch.stack([checkpoint(_one_sequence, query_states[b], key_states[b],
                                  value_states[b], scale, rnd, use_reentrant=False)
                       for b in range(B)])
    out = rnd(out).transpose(1, 2).reshape(B, S, H * dv)
    return rnd(out @ w("o_proj"))


def swiglu(x, gate, up, down, rnd):
    return rnd(rnd(F.silu(x @ rnd(gate)) * (x @ rnd(up))) @ rnd(down))


def moe(p, l, x, cfg, batch, rnd):
    """The expert layer's output (T, D) for this card's held experts and
    the shared ones, and its balance loss."""
    pre = f"layers.{l}."
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = torch.softmax(x @ p[pre + "router"], dim=-1)
    topk_weight, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=False)
    topk_weight = topk_weight * cfg["routed_scaling_factor"]
    seq = x.shape[0] // batch
    ce = torch.zeros((batch, E), device=x.device)
    ce.scatter_add_(1, topk_idx.view(batch, -1), torch.ones((batch, seq * k), device=x.device))
    ce = ce / (seq * k / E)
    aux = (ce * scores.view(batch, seq, E).mean(dim=1)).sum(dim=1).mean() * cfg["aux_loss_alpha"]
    first, held = cfg["held_experts"]
    y = torch.zeros_like(x)
    for e in range(held):
        tok, slot = (topk_idx == first + e).nonzero(as_tuple=True)
        out = swiglu(x[tok], p[pre + "experts_gate"][e], p[pre + "experts_up"][e],
                     p[pre + "experts_down"][e], rnd)
        y = y.index_add(0, tok, out * topk_weight[tok, slot][:, None])
    y = rnd(y) + swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"], p[pre + "shared_down"],
                        rnd)
    return y, aux


def decoder_layer(p, l, h, cfg, cos, sin, rnd):
    eps = cfg["rms_norm_eps"]
    B, S, D = h.shape
    h = rnd(h + attention(p, l, rms_norm(h, p[f"layers.{l}.input_norm"], eps, rnd), cfg, cos,
                          sin, rnd))
    x = rms_norm(h, p[f"layers.{l}.post_norm"], eps, rnd).view(B * S, D)
    if l < cfg["first_k_dense_replace"]:
        pre = f"layers.{l}."
        out = swiglu(x, p[pre + "gate_proj"], p[pre + "up_proj"], p[pre + "down_proj"], rnd)
        aux = torch.zeros((), device=h.device)
    else:
        out, aux = moe(p, l, x, cfg, B, rnd)
    return rnd(h + out.view(B, S, D)), aux


def loss_of(p: dict, tokens: torch.Tensor, cfg: dict, rnd=lambda t: t) -> torch.Tensor:
    """The mean next-token cross entropy over the held vocabulary, plus
    every expert layer's balance loss."""
    cos, sin = rotary(cfg, tokens.shape[1], tokens.device)
    h = rnd(p["embed"][tokens])
    balance = torch.zeros((), device=tokens.device)
    for l in range(cfg["num_hidden_layers"]):
        h, aux = checkpoint(decoder_layer, p, l, h, cfg, cos, sin, rnd, use_reentrant=False)
        balance = balance + aux
    logits = rms_norm(h[:, :-1], p["norm"], cfg["rms_norm_eps"], rnd) @ rnd(p["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1)) + balance


def norm64(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def train(args: dict, inputs: np.ndarray, steps: int, device, precision: str = "f32") -> dict:
    """``steps`` Adam steps from the recipe's weights on the recorded
    tokens: ``losses`` (before each step), ``grads`` (the norm of each
    leaf's first gradient) and ``change`` (the norm of each leaf's change
    over the steps), the leaves in the recipe's order."""
    cfg, seed = args["cfg"], args["seed"]
    if torch.device(device).type != args["draw_device"]:
        raise ValueError(f"dsv2_lite: the weights were drawn on {args['draw_device']!r}, "
                         f"the reference runs on {device!r}")
    tokens = torch.from_numpy(np.asarray(inputs, dtype=np.float32)).round().long()
    tokens = tokens.reshape(cfg["batch"], cfg["seq"]).to(device)
    rnd = _fp8 if precision == "fp8" else (lambda t: t)
    params = {k: t.requires_grad_(True) for k, t in initial_state(cfg, seed, device).items()}
    mu = {k: torch.zeros_like(t) for k, t in params.items()}
    nu = {k: torch.zeros_like(t) for k, t in params.items()}
    lr, losses, first = args["learning_rate"], [], None
    with ref.exact_matmul():
        for t in range(1, steps + 1):
            loss = loss_of(params, tokens, cfg, rnd)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = np.array([norm64(g) for g in grads])
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mu[k].mul_(B1).add_(g, alpha=1 - B1)
                    nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                    p.sub_(lr * (mu[k] / (1 - B1 ** t)) / (torch.sqrt(nu[k] / (1 - B2 ** t))
                                                          + ADAM_EPS))
            del grads
    change = np.array([norm64(params[name].detach() - draw(cfg, seed, i, shape, init, device))
                       for i, (name, shape, init) in enumerate(param_shapes(cfg))])
    return {"losses": np.array(losses, dtype=np.float64), "grads": first, "change": change}


def trained(args: dict, inputs: np.ndarray, steps: int, device, precision: str = "f32") -> dict:
    """:func:`train`, once for each set of inputs."""
    key = (hashlib.sha1(np.ascontiguousarray(inputs).tobytes()).hexdigest(),
           json.dumps(args["cfg"], sort_keys=True), args["seed"], args["learning_rate"], steps,
           str(device), precision)
    if key not in _cache:
        _cache[key] = train(args, inputs, steps, device, precision)
        if torch.device(device).type == "cuda":
            # The model's 50 GB back to the card: a later run in this
            # process (control.py's next seed) starts a probe child that
            # trains the model again.
            torch.cuda.empty_cache()
    return _cache[key]


def worst_leaf_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| over a leaf's reference norm or the median
    leaf's, whichever is larger."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(want, np.median(want))
    return ref.worst(np.abs(got - want) / scale)
