"""DeepSeek-V2-Lite's training step, one card's share, in plain PyTorch, float32.

The test suite's copy of the plain reference (the benchmark's is
``probebench/reference/dsv2_lite.py``; tests/test_torch_deepseek_v2.py holds
the two to the same outputs).  It imports nothing of the port and no JAX,
and follows the published ``modeling_deepseek.py`` by name: MLA attention
(q one dense projection, the latent's RMSNorm, the decoupled rotary key
shared by every head, YaRN's frequencies with the pairs de-interleaved
before ``rotate_half``, the softmax scale times ``mscale_all_dim`` squared),
the dense MLP of the first ``first_k_dense_replace`` layers and the expert
layer after it (softmax router, greedy top-k, weights unnormalised times
``routed_scaling_factor``, shared experts, the ``seq_aux`` balance loss
times ``aux_loss_alpha``, added to the loss), the final norm, the head, the
mean next-token cross entropy, and Adam with bias correction.

Departures from the published module: the vocabulary is the card's slice
(``vocab_held`` rows from 0); each expert layer computes the part of the
combine that the ``held_experts`` (first, count) give, the router over
every routed expert and the balance loss from the whole router; routing is
dropless.  :func:`moe_whole` is the uncut layer, every routed expert
computed, for the test that the shares add up to it.

Everything runs in float32 with TF32 off.  The weights follow the
program's written recipe (:func:`initial_state`).  torch is reached through
``importlib`` (tests/test_dependency_surface.py).
"""

import importlib
import math

torch = importlib.import_module("torch")
F = importlib.import_module("torch.nn.functional")

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


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


def initial_state(cfg: dict, seed: int, device="cpu") -> dict:
    """Tensor ``i`` from ``torch.Generator(device).manual_seed((seed * 4096
    + i) % 2**64)`` as ``torch.randn(shape).mul_(initializer_range)``, the
    norms ones."""
    out = {}
    for i, (name, shape, init) in enumerate(param_shapes(cfg)):
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        g = torch.Generator(device=device).manual_seed((seed * 4096 + i) % 2 ** 64)
        out[name] = torch.randn(shape, generator=g, device=device).mul_(cfg["initializer_range"])
    return out


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: dict):
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    original = cfg["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(cfg["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (cfg["rope_factor"] * base
                        ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    inv_freq_mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low)
                           / (high - low)).clamp(0, 1)
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def rotary(cfg: dict, seq: int):
    """``DeepseekV2YarnRotaryEmbedding``'s (cos, sin) for positions 0 .. seq - 1."""
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32), yarn_inv_freq(cfg))
    emb = torch.cat((freqs, freqs), dim=-1)
    factor = cfg["rope_factor"]
    mscale = yarn_mscale(factor, cfg["mscale"]) / yarn_mscale(factor, cfg["mscale_all_dim"])
    return emb.cos() * mscale, emb.sin() * mscale


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


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def attention(p, l, x, cfg):
    B, S, _ = x.shape
    H, nope, rope, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    w = lambda name: p[f"layers.{l}.{name}"]
    q = (x @ w("q_proj")).view(B, S, H, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    compressed_kv, k_pe = (x @ w("kv_a_proj")).split([cfg["kv_lora_rank"], rope], dim=-1)
    k_pe = k_pe.reshape(B, S, 1, rope).transpose(1, 2)
    kv = (rms_norm(compressed_kv, w("kv_a_norm"), cfg["rms_norm_eps"])
          @ w("kv_b_proj")).view(B, S, H, nope + dv).transpose(1, 2)
    k_nope, value_states = kv.split([nope, dv], dim=-1)
    cos, sin = rotary(cfg, S)
    q_pe, k_pe = apply_rotary_pos_emb(q_pe, k_pe, cos, sin)
    query_states = torch.cat((q_nope, q_pe), dim=-1)
    key_states = torch.cat((k_nope, k_pe.expand(B, H, S, rope)), dim=-1)
    masked = torch.ones((S, S), dtype=torch.bool).triu(1)
    scores = (query_states @ key_states.transpose(-1, -2) * softmax_scale(cfg))
    probs = torch.softmax(scores.masked_fill(masked, float("-inf")), dim=-1)
    out = (probs @ value_states).transpose(1, 2).reshape(B, S, H * dv)
    return out @ w("o_proj")


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(p, l, x, cfg, batch):
    """(top-k weights, top-k experts, balance loss) of the router over every routed expert."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    scores = torch.softmax(x @ p[f"layers.{l}.router"], dim=-1)
    topk_weight, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=False)
    seq = x.shape[0] // batch
    ce = torch.zeros((batch, E))
    ce.scatter_add_(1, topk_idx.view(batch, -1), torch.ones((batch, seq * k)))
    ce = ce / (seq * k / E)
    aux = (ce * scores.view(batch, seq, E).mean(dim=1)).sum(dim=1).mean() * cfg["aux_loss_alpha"]
    return topk_weight * cfg["routed_scaling_factor"], topk_idx, aux


def routed(x, topk_weight, topk_idx, experts, first):
    """The part of the combine that the experts ``first`` .. give, each
    expert's weights ``(gate, up, down)`` in ``experts``."""
    y = torch.zeros_like(x)
    for e, (gate, up, down) in enumerate(experts):
        tok, slot = (topk_idx == first + e).nonzero(as_tuple=True)
        y = y.index_add(0, tok, swiglu(x[tok], gate, up, down) * topk_weight[tok, slot][:, None])
    return y


def moe(p, l, x, cfg, batch):
    """The expert layer's output (T, D), the held experts' part and the
    shared experts', and its balance loss."""
    pre = f"layers.{l}."
    topk_weight, topk_idx, aux = route(p, l, x, cfg, batch)
    experts = [(p[pre + "experts_gate"][e], p[pre + "experts_up"][e], p[pre + "experts_down"][e])
               for e in range(cfg["held_experts"][1])]
    y = routed(x, topk_weight, topk_idx, experts, cfg["held_experts"][0])
    return y + swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"], p[pre + "shared_down"]), aux


def moe_whole(p, l, x, cfg, batch, experts):
    """The uncut expert layer: every routed expert's weights in ``experts``
    (E triples), and the shared experts."""
    pre = f"layers.{l}."
    topk_weight, topk_idx, _ = route(p, l, x, cfg, batch)
    y = routed(x, topk_weight, topk_idx, experts, 0)
    return y + swiglu(x, p[pre + "shared_gate"], p[pre + "shared_up"], p[pre + "shared_down"])


def decoder_layer(p, l, h, cfg):
    eps = cfg["rms_norm_eps"]
    B, S, D = h.shape
    h = h + attention(p, l, rms_norm(h, p[f"layers.{l}.input_norm"], eps), cfg)
    x = rms_norm(h, p[f"layers.{l}.post_norm"], eps).view(B * S, D)
    if l < cfg["first_k_dense_replace"]:
        pre = f"layers.{l}."
        return h + swiglu(x, p[pre + "gate_proj"], p[pre + "up_proj"],
                          p[pre + "down_proj"]).view(B, S, D), torch.zeros(())
    out, aux = moe(p, l, x, cfg, B)
    return h + out.view(B, S, D), aux


def logits_of(p: dict, tokens, cfg: dict):
    """(logits (B, S - 1, V) over the held vocabulary, the balance loss summed)."""
    h = p["embed"][tokens]
    balance = torch.zeros(())
    for l in range(cfg["num_hidden_layers"]):
        h, aux = decoder_layer(p, l, h, cfg)
        balance = balance + aux
    return rms_norm(h[:, :-1], p["norm"], cfg["rms_norm_eps"]) @ p["lm_head"], balance


def loss_of(p: dict, tokens, cfg: dict):
    logits, balance = logits_of(p, tokens, cfg)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1)) + balance


def train(cfg: dict, seed: int, tokens, steps: int, lr: float) -> dict:
    """``steps`` Adam steps from the recipe's weights: ``losses`` (before
    each step), ``grads`` (the first step's) and ``params`` (after the
    last), on the CPU with TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: t.requires_grad_(True) for k, t in initial_state(cfg, seed).items()}
        mu = {k: torch.zeros_like(t) for k, t in params.items()}
        nu = {k: torch.zeros_like(t) for k, t in params.items()}
        losses, first = [], None
        for t in range(1, steps + 1):
            loss = loss_of(params, tokens, cfg)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(params, grads)}
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mu[k].mul_(B1).add_(g, alpha=1 - B1)
                    nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                    p.sub_(lr * (mu[k] / (1 - B1 ** t)) / (torch.sqrt(nu[k] / (1 - B2 ** t))
                                                          + ADAM_EPS))
        return {"losses": losses, "grads": first,
                "params": {k: t.detach() for k, t in params.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
