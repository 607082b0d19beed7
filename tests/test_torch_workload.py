"""The port's burn-in training step, held against the JAX package's.

Both sides take the same weights (the JAX package's ``init_params``, carried
across by ``tpu_node_checker_torch.convert.burnin_state``) and the same
tokens, at the JAX tests' ``TINY`` configuration on the CPU.  The port's
``"flash"`` path runs the kernel's plain version here (the kernel itself is
held against it on the card by tests/test_torch_cuda.py and
``chip_smoke.py``); JAX's own flash step is slow in interpret mode and is
not run, so the port's flash path is held to JAX's ``"xla"`` path, the
relation tests/test_models.py asserts between JAX's two paths.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import dataclasses
import importlib
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_node_checker.models import burnin as jax_burnin
from tpu_node_checker.ops.flash_attention import _xla_causal_attention

torch = importlib.import_module("torch")
convert = importlib.import_module("tpu_node_checker_torch.convert")
port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
port_flash = importlib.import_module("tpu_node_checker_torch.ops.flash_attention")

REPO = Path(__file__).resolve().parent.parent
TINY_FIELDS = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2, seq=16, batch=4)
JAX_TINY = jax_burnin.BurninConfig(**TINY_FIELDS)
PORT_TINY = port_burnin.BurninConfig(**TINY_FIELDS)


def _jax_inputs(cfg, seed=7):
    """The JAX package's weights and tokens for ``cfg``, as numpy arrays."""
    params = jax.tree.map(np.asarray, jax_burnin.init_params(jax.random.PRNGKey(seed), cfg))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed + 1), (cfg.batch, cfg.seq), 0, cfg.vocab))
    return params, tokens


def _jax_losses(cfg, params, tokens, steps):
    step, init_fn = jax_burnin.make_train_step(cfg)
    _, opt_state = init_fn(jax.random.PRNGKey(0))
    p = jax.tree.map(jnp.asarray, params)
    losses = []
    for _ in range(steps):
        p, opt_state, loss = step(p, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


def _port_losses(cfg, params, tokens, steps):
    step, init_fn = port_burnin.make_train_step(cfg, device="cpu")
    model, opt = init_fn(state=convert.burnin_state(params))
    t = torch.from_numpy(np.array(tokens, dtype=np.int64))
    return [float(step(model, opt, t)) for _ in range(steps)]


class TestConvert:
    def test_state_dict_carries_every_parameter_exactly(self):
        params, _ = _jax_inputs(JAX_TINY)
        state = convert.burnin_state(params)
        model = port_burnin.Burnin(PORT_TINY)
        assert set(state) == set(model.state_dict())
        model.load_state_dict(state)
        np.testing.assert_array_equal(model.layers["w1"].detach().numpy(), params["layers"]["w1"])
        np.testing.assert_array_equal(model.embed.detach().numpy(), params["embed"])

    def test_fresh_model_has_jax_shapes_and_scales(self):
        params, _ = _jax_inputs(port_burnin.BurninConfig())
        model = port_burnin.Burnin(port_burnin.BurninConfig(), torch.Generator().manual_seed(0))
        for name, t in model.state_dict().items():
            ref = convert.burnin_state(params)[name]
            assert t.shape == ref.shape and t.dtype == ref.dtype, name
            # Same draw: normal over sqrt(fan-in) (0.02 for the embedding).
            assert float(t.std()) == pytest.approx(float(ref.std()), rel=0.1, abs=1e-6), name


class TestForward:
    def test_logits_match_jax(self):
        params, tokens = _jax_inputs(JAX_TINY)
        # XLA may skip a bf16 rounding the program asks for ("excess
        # precision", on by default), which moves single logits by up to
        # 3.4e-2 here; compiled without it, JAX rounds where the port does.
        forward = jax.jit(jax_burnin.forward, static_argnums=2,
                          compiler_options={"xla_allow_excess_precision": False})
        ref = np.asarray(forward(jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), JAX_TINY))
        model = port_burnin.Burnin(PORT_TINY)
        model.load_state_dict(convert.burnin_state(params))
        with torch.no_grad():
            out = model(torch.from_numpy(np.array(tokens, dtype=np.int64))).numpy()
        assert out.shape == ref.shape == (JAX_TINY.batch, JAX_TINY.seq, JAX_TINY.vocab)
        # The same bf16 rounding points; the f32 sums run in another order,
        # which could tip a value onto a neighbouring bf16 step.
        np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)

    def test_causality(self):
        model = port_burnin.Burnin(PORT_TINY, torch.Generator().manual_seed(0))
        tokens = torch.randint(0, PORT_TINY.vocab, (1, 16), generator=torch.Generator().manual_seed(1))
        changed = tokens.clone()
        changed[0, -1] = (changed[0, -1] + 1) % PORT_TINY.vocab
        with torch.no_grad():
            a, b = model(tokens), model(changed)
        torch.testing.assert_close(a[0, :-1], b[0, :-1], rtol=1e-5, atol=0)


class TestTrainStep:
    def test_two_step_losses_match_jax_xla(self):
        params, tokens = _jax_inputs(JAX_TINY)
        ref = _jax_losses(JAX_TINY, params, tokens, 2)
        port = _port_losses(PORT_TINY, params, tokens, 2)
        np.testing.assert_allclose(port, ref, rtol=1e-3)

    def test_flash_path_matches_jax_xla(self):
        # seq 128: the flash path needs whole 128-row blocks.
        jcfg = dataclasses.replace(JAX_TINY, seq=128)
        params, tokens = _jax_inputs(jcfg, seed=5)
        ref = _jax_losses(jcfg, params, tokens, 2)
        pcfg = dataclasses.replace(PORT_TINY, seq=128, attention="flash")
        before = port_flash.flash_forward.launches
        port = _port_losses(pcfg, params, tokens, 2)
        np.testing.assert_allclose(port, ref, rtol=1e-3)
        assert port_flash.flash_forward.launches == before  # CPU: the plain version ran

    def test_remat_matches_no_remat(self):
        params, tokens = _jax_inputs(JAX_TINY, seed=3)
        plain = _port_losses(PORT_TINY, params, tokens, 2)
        remat = _port_losses(dataclasses.replace(PORT_TINY, remat=True), params, tokens, 2)
        np.testing.assert_allclose(remat, plain, rtol=1e-6)

    def test_flash_rejects_unaligned_seq(self):
        r = port_burnin.workload_probe(
            dataclasses.replace(PORT_TINY, attention="flash"), steps=1, device="cpu")
        assert not r.ok and "seq % 128" in r.error

    def test_unknown_attention_rejected(self):
        r = port_burnin.workload_probe(
            dataclasses.replace(PORT_TINY, attention="sdpa"), steps=1, device="cpu")
        assert not r.ok and "attention must be" in r.error


class TestFlashBackward:
    def test_gradients_are_bf16_and_match_jax_vjp(self):
        rng = np.random.default_rng(0)
        q, k, v, g = (jnp.asarray(rng.standard_normal((1, 2, 128, 16)), jnp.bfloat16)
                      for _ in range(4))
        _, vjp = jax.vjp(_xla_causal_attention, q, k, v)
        ref = vjp(g)
        leaves = [convert.to_torch(np.asarray(x)).requires_grad_(True) for x in (q, k, v)]
        out = port_flash.flash_attention(*leaves)
        grads = torch.autograd.grad(out, leaves, convert.to_torch(np.asarray(g)))
        assert [t.dtype for t in grads] == [torch.bfloat16] * 3
        assert [r.dtype for r in ref] == [jnp.bfloat16] * 3
        for t, r in zip(grads, ref):
            # The same f32 arithmetic, rounded to bf16 once on each side.
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(r.astype(jnp.float32)), atol=2e-2, rtol=1e-2)


class TestWorkloadProbe:
    def test_healthy_on_cpu(self):
        r = port_burnin.workload_probe(PORT_TINY, steps=3, device="cpu")
        assert r.ok, r.error
        assert len(r.losses) == 3 and all(math.isfinite(x) for x in r.losses)
        assert r.losses[-1] < r.losses[0] and r.step_time_ms > 0

    def test_probe_never_raises(self):
        r = port_burnin.workload_probe(port_burnin.BurninConfig(d_model=33, n_heads=2),
                                       steps=1, device="cpu")
        assert not r.ok and "not divisible" in r.error

    def test_default_device_without_cuda_fails_naming_cuda(self):
        r = port_burnin.workload_probe(PORT_TINY, steps=1)
        assert not r.ok and "CUDA" in r.error


def test_the_step_never_imports_dynamo_or_sympy():
    # torch.optim's constructors import torch._dynamo, and autograd.grad
    # with explicit output gradients imports sympy; on the card's machine
    # either costs a fresh process seconds (PERF.md).  The step, its
    # optimizer and the flash backward included, keeps clear of both.
    code = (
        "import sys, torch\n"
        "from tpu_node_checker_torch.models.burnin import BurninConfig, make_train_step\n"
        "cfg = BurninConfig(vocab=64, d_model=32, n_heads=2, d_ff=64, seq=128, batch=2,\n"
        "                   attention='flash')\n"
        "step, init_fn = make_train_step(cfg, device='cpu')\n"
        "model, opt = init_fn()\n"
        "step(model, opt, torch.zeros((2, 128), dtype=torch.int64))\n"
        "print(sorted({'sympy', 'torch._dynamo'} & set(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


class TestAdam:
    """The step's Adam against the numpy reference tests/test_models.py
    holds the JAX package's hand-rolled Adam to."""

    def _numpy_adam(self, grads_seq, p0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        p = np.array(p0, np.float32)
        mu = np.zeros_like(p)
        nu = np.zeros_like(p)
        for t, g in enumerate(grads_seq, start=1):
            g = np.asarray(g, np.float32)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mu_hat = mu / (1 - b1**t)
            nu_hat = nu / (1 - b2**t)
            p = p - lr * mu_hat / (np.sqrt(nu_hat) + eps)
        return p

    def test_matches_reference_update(self):
        rng = np.random.default_rng(0)
        p0 = rng.normal(size=(5, 3)).astype(np.float32)
        grads_seq = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(7)]
        _, init_fn = port_burnin.make_train_step(PORT_TINY, device="cpu")
        model, opt = init_fn()
        w = model.layers["w1"]
        with torch.no_grad():
            w.zero_()
            w[0, :5, :3] = torch.from_numpy(p0)
        for g in grads_seq:
            opt.zero_grad()
            for p in model.parameters():
                p.grad = torch.zeros_like(p)
            w.grad[0, :5, :3] = torch.from_numpy(g)
            opt.step()
        expected = self._numpy_adam(grads_seq, p0)
        np.testing.assert_allclose(w.detach()[0, :5, :3].numpy(), expected, rtol=1e-5, atol=1e-7)
        assert opt.count == len(grads_seq)
        # Zero gradients leave the other parameters where they were.
        np.testing.assert_array_equal(w.detach()[1].numpy(), 0.0)

    def test_matches_the_jax_adam_on_the_same_gradients(self):
        rng = np.random.default_rng(1)
        p0 = rng.normal(size=(4, 6)).astype(np.float32)
        grads_seq = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(5)]
        tx = jax_burnin._Adam(lr=1e-3)
        params = {"w": jnp.asarray(p0)}
        state = tx.init(params)
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = port_burnin._Adam([p], lr=1e-3)
        for g in grads_seq:
            updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
            params = jax_burnin._Adam.apply_updates(params, updates)
            p.grad = torch.from_numpy(g)
            opt.step()
        # JAX rounds the bias corrections to f32, the port keeps them in
        # f64: the tolerance tests/test_models.py gives the numpy reference.
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]), rtol=1e-5, atol=1e-7)
