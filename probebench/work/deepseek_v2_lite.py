"""DeepSeek-V2-Lite's model FLOPs a training step, one card's share.

Counted by ``work/burnin.py``'s convention (products at 2 m n k, the
backward twice the forward, attention over the whole S x S, recomputation
and elementwise work left out).  ``cfg`` is the configuration the training
tap records (``tpu_node_checker_torch.models.deepseek_v2.DeepseekV2Config``
as a dict).  A step of T = batch x seq tokens:

* each layer's attention: q (D to H (nope + rope)), the latent and rotary
  key (D to r + rope), keys and values (r to H (nope + dv)), the output
  (H dv to D), and the scores and probabilities times values of each
  sequence (B H S S (nope + rope) and B H S S dv);
* the dense layers' SwiGLU (3 products of T x D x intermediate_size);
* each MoE layer's router (T x D x E, in f32 but a product all the same),
  its shared experts' SwiGLU (3 products at moe_intermediate_size x
  n_shared_experts) and the held experts' SwiGLU over the assignments
  they take: ``held_per_token`` a token, by default the deployment's share
  k x held / E (0.75 at 6 of 64 experts and 8 held), what a card of the
  deployment averages;
* the head over the held vocabulary at every position that has a target
  (B (S - 1)).
"""


def forward_flops(cfg: dict, held_per_token=None) -> float:
    """The forward pass's products over one batch."""
    B, S = cfg["batch"], cfg["seq"]
    T = B * S
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    E, k, held = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["held_experts"][1]
    if held_per_token is None:
        held_per_token = k * held / E
    projections = 2 * T * (D * H * (nope + rope) + D * (r + rope) + r * H * (nope + dv)
                           + H * dv * D)
    attention = 2 * B * H * S * S * (nope + rope + dv)
    dense = 3 * 2 * T * D * cfg["intermediate_size"]
    Fe = cfg["moe_intermediate_size"]
    moe = 2 * T * D * E + 3 * 2 * T * D * Fe * cfg["n_shared_experts"] \
        + 3 * 2 * T * held_per_token * D * Fe
    layers, n_dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    head = 2 * B * (S - 1) * D * cfg["vocab_held"]
    return float(layers * (projections + attention) + n_dense * dense
                 + (layers - n_dense) * moe + head)


def step_flops(cfg: dict, held_per_token=None) -> float:
    """Forward and backward, the backward twice the forward."""
    return 3.0 * forward_flops(cfg, held_per_token)
