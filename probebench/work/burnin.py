"""The burn-in transformer's model FLOPs a training step.

The counting convention, for every model under ``work/``:

* a step's model FLOPs are its matrix products: a product of an (m, k) by
  a (k, n) operand counts 2 m n k, a batched product that for each batch;
* the backward pass counts twice the forward: the gradient of each operand
  of each product is one product of the same size;
* attention counts the whole S x S of scores and of probabilities times
  values, as the plain path runs it: the causal mask saves nothing;
* what the program runs again is not counted: recomputation under
  activation checkpointing, or a kernel's backward that runs the plain
  forward again;
* elementwise work (norms, softmax, activations, the loss, the optimizer's
  update) is left out, as ``torch.utils.flop_counter`` leaves it out.
  ``ELEMENTWISE_ALLOWANCE`` bounds it as a share of the products at the
  burn-in's sizes, where it is about 2 %: some 12 operations an element of
  the scores and 24 of the MLP's hidden units (softmax and GELU, forward
  and backward), 23 of each norm's, 14 of the logits', and Adam's 12 a
  parameter, some 63 MFLOP against 3,020 MFLOP of products.

A step of the burn-in model (``cfg``: ``batch``, ``seq``, ``d_model``,
``n_heads``, ``d_ff``, ``n_layers``, ``vocab``): each layer's q, k, v and
output projections (4 products of (B S, D) by (D, D)), its scores and
probabilities times values (2 products of (S, D/H) by (D/H, S) or (S, S)
by (S, D/H) for each of B H), its MLP (2 products of (B S, D) by (D, F)
and back), and the unembedding ((B S, D) by (D, V), over every position).
"""

ELEMENTWISE_ALLOWANCE = 0.05


def forward_flops(cfg: dict) -> float:
    """The forward pass's products over one batch."""
    tokens = cfg["batch"] * cfg["seq"]
    d, f, s = cfg["d_model"], cfg["d_ff"], cfg["seq"]
    projections = 4 * 2 * tokens * d * d
    attention = 2 * 2 * tokens * s * d  # B H S S (D/H), twice
    mlp = 2 * 2 * tokens * d * f
    unembed = 2 * tokens * d * cfg["vocab"]
    return float(cfg["n_layers"] * (projections + attention + mlp) + unembed)


def step_flops(cfg: dict) -> float:
    """Forward and backward, the backward twice the forward."""
    return 3.0 * forward_flops(cfg)
