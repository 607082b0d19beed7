"""The port's data × model sharded training step on 8 gloo ranks, held
against JAX's sharded step on its 8-device CPU mesh and against the port's
own one-card step.

Every side starts from the same weights (the JAX package's ``init_params``,
carried across by ``convert.burnin_state`` and cut per rank by
``convert.burnin_shard``) and takes the same tokens, at a small size.  JAX's
step is compiled without excess precision, so it rounds to bf16 where its
program says (tests/test_torch_workload.py).  At data 4 × model 2 and at
data 8 × model 1:

* the first two losses are within 1e-3 relative of JAX's sharded step and
  of the port's one-card step;
* every gradient shard of every rank is within 5e-2 relative L2 of the
  one-card gradient's slice (a replicated activation's gradient counted
  once per model rank would be off by a whole factor).

Each test prints the gap it measured (``pytest -s`` shows them).  torch and
the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_node_checker.models import burnin as jax_burnin
from tpu_node_checker.parallel import MeshSpec as JaxMeshSpec
from tpu_node_checker.parallel import build_mesh

torch = importlib.import_module("torch")
convert = importlib.import_module("tpu_node_checker_torch.convert")
port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")

REPO = Path(__file__).resolve().parent.parent
N = 8  # gloo ranks, as conftest's 8 virtual CPU devices
WALL_CLOCK_BUDGET_S = 60.0
FIELDS = dict(vocab=64, d_model=32, n_heads=2, d_ff=64, n_layers=2, seq=16, batch=8)
JAX_CFG = jax_burnin.BurninConfig(**FIELDS)
PORT_CFG = port_burnin.BurninConfig(**FIELDS)
LAYOUTS = [((("data", 4), ("model", 2))), ((("data", 8), ("model", 1)))]
LAYOUT_IDS = ["data4-model2", "data8-model1"]
STEPS = 2


@pytest.fixture(scope="module")
def group():
    with pytest.MonkeyPatch.context() as mp:
        # Eight ranks share the host's cores: one thread each.
        mp.setenv("OMP_NUM_THREADS", "1")
        with port_mesh.RankGroup(N, "cpu", timeout_s=120) as g:
            yield g


@pytest.fixture(autouse=True)
def _wall_clock_guard():
    t0 = time.perf_counter()
    yield
    elapsed = time.perf_counter() - t0
    assert elapsed < WALL_CLOCK_BUDGET_S, f"test burned {elapsed:.1f}s of wall-clock"


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's weights and tokens, as numpy arrays."""
    params = jax.tree.map(np.asarray, jax_burnin.init_params(jax.random.PRNGKey(11), JAX_CFG))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(12), (JAX_CFG.batch, JAX_CFG.seq), 0, JAX_CFG.vocab))
    return params, tokens


@pytest.fixture(scope="module")
def one_card(inputs):
    """The port's one-card step from the same weights: (losses, gradients)."""
    params, tokens = inputs
    losses, _, grads = port_burnin.train_steps(
        PORT_CFG, None, STEPS, state=convert.burnin_state(params),
        tokens=torch.from_numpy(tokens.astype(np.int64)), device="cpu", keep_grads=True)
    return losses, grads


_SHARDED = {}


def _sharded(group, inputs, axes):
    """Every rank's ``(losses, step ms, gradient shards)`` of the port's
    sharded step, run once per layout for the module."""
    if axes not in _SHARDED:
        params, tokens = inputs
        _SHARDED[axes] = group.run(
            port_burnin.train_steps, PORT_CFG, port_mesh.MeshSpec(axes), STEPS,
            state=convert.burnin_state(params), tokens=torch.from_numpy(tokens.astype(np.int64)),
            keep_grads=True)
    return _SHARDED[axes]


def _jax_sharded_losses(params, tokens, axes):
    mesh = build_mesh(JaxMeshSpec(axes))
    step, init_fn = jax_burnin.make_train_step(JAX_CFG, mesh)
    specs = jax_burnin.param_specs(JAX_CFG)
    p = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
                     params, specs)
    _, opt_state = init_fn(jax.random.PRNGKey(0))
    t = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
    losses = []
    for _ in range(STEPS):
        compiled = step.lower(p, opt_state, t).compile(
            compiler_options={"xla_allow_excess_precision": False})
        p, opt_state, loss = compiled(p, opt_state, t)
        losses.append(float(loss))
    return losses


def _coords(axes, rank):
    return tuple(int(c) for c in np.unravel_index(rank, [s for _, s in axes]))


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


class TestShardedStep:
    @pytest.mark.parametrize("axes", LAYOUTS, ids=LAYOUT_IDS)
    def test_losses_match_jax_sharded_step(self, group, inputs, axes):
        results = _sharded(group, inputs, axes)
        assert not any(isinstance(r, port_mesh.RankFailure) for r in results), results
        ref = _jax_sharded_losses(*inputs, axes)
        port = results[0][0]
        print(f"\n{axes}: losses {port} vs JAX sharded {ref}: {_rel(port, ref):.3e} relative")
        np.testing.assert_allclose(port, ref, rtol=1e-3)
        # The global batch's mean, the same on every rank.
        assert all(r[0] == port for r in results)

    @pytest.mark.parametrize("axes", LAYOUTS, ids=LAYOUT_IDS)
    def test_losses_match_the_one_card_step(self, group, inputs, one_card, axes):
        port = _sharded(group, inputs, axes)[0][0]
        print(f"\n{axes}: losses {port} vs one card {one_card[0]}: "
              f"{_rel(port, one_card[0]):.3e} relative")
        np.testing.assert_allclose(port, one_card[0], rtol=1e-3)

    @pytest.mark.parametrize("axes", LAYOUTS, ids=LAYOUT_IDS)
    def test_every_gradient_shard_matches_the_one_card_slice(self, group, inputs, one_card, axes):
        spec = port_mesh.MeshSpec(axes)
        worst = (0.0, "")
        for rank, (_, _, grads) in enumerate(_sharded(group, inputs, axes)):
            want = convert.burnin_shard(one_card[1], PORT_CFG, spec, _coords(axes, rank))
            assert set(grads) == set(want)
            for name, g in grads.items():
                assert g.shape == want[name].shape, (rank, name)
                rel = float((g - want[name]).norm() / want[name].norm())
                assert rel < 5e-2, (rank, name, rel)
                worst = max(worst, (rel, name))
        print(f"\n{axes}: worst gradient shard {worst[0]:.3e} relative L2 ({worst[1]})")

    def test_probe_healthy_and_replicated(self, group):
        spec = port_mesh.MeshSpec(LAYOUTS[0])
        results = group.run(port_burnin.workload_probe, PORT_CFG, mesh=spec, steps=3)
        folded = port_mesh.fold(results)
        assert folded.ok, folded.error
        assert all(r.losses == folded.losses for r in results)

    def test_flash_refuses_a_mesh_as_jax(self, group):
        cfg = port_burnin.BurninConfig(**{**FIELDS, "seq": 128, "attention": "flash"})
        port = port_mesh.fold(group.run(port_burnin.workload_probe, cfg,
                                        mesh=port_mesh.MeshSpec(LAYOUTS[0]), steps=1))
        ref = jax_burnin.workload_probe(
            jax_burnin.BurninConfig(**{**FIELDS, "seq": 128, "attention": "flash"}),
            mesh=build_mesh(JaxMeshSpec(LAYOUTS[0])), steps=1)
        assert not port.ok and not ref.ok
        assert 'attention="flash" is single-device only' in port.error
        assert 'attention="flash" is single-device only' in ref.error

    def test_unsplittable_heads_fail_by_name(self, group):
        cfg = port_burnin.BurninConfig(**{**FIELDS, "n_heads": 1})
        port = port_mesh.fold(group.run(port_burnin.workload_probe, cfg,
                                        mesh=port_mesh.MeshSpec(LAYOUTS[0]), steps=1))
        assert not port.ok and "n_heads 1 does not split over model=2" in port.error


class TestShardCut:
    @pytest.mark.parametrize("axes", LAYOUTS, ids=LAYOUT_IDS)
    def test_each_rank_holds_the_block_jax_places_on_its_device(self, inputs, axes):
        params, _ = inputs
        mesh = build_mesh(JaxMeshSpec(axes))
        specs = jax_burnin.param_specs(JAX_CFG)
        placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs)
        flat = {k: v for k, v in placed.items() if k != "layers"}
        flat.update({f"layers.{k}": v for k, v in placed["layers"].items()})
        state = convert.burnin_state(params)
        for rank in range(N):
            cut = convert.burnin_shard(state, PORT_CFG, port_mesh.MeshSpec(axes), _coords(axes, rank))
            for name, arr in flat.items():
                (shard,) = [s for s in arr.addressable_shards if s.device.id == rank]
                np.testing.assert_array_equal(cut[name].numpy(), np.asarray(shard.data))

    def test_specs_equal_jax(self):
        def plain(spec):
            return tuple(spec) if isinstance(spec, P) else {k: plain(v) for k, v in spec.items()}

        assert port_burnin.param_specs(PORT_CFG) == plain(jax_burnin.param_specs(JAX_CFG))


def test_the_sharded_step_never_imports_dynamo_or_sympy():
    # As tests/test_torch_workload.py holds the one-card step: the sharded
    # step (its collectives' autograd functions included) keeps clear of
    # both, on every rank, in a fresh process.
    code = (
        "import sys\n"
        "from tpu_node_checker_torch.models.burnin import BurninConfig, train_steps\n"
        "from tpu_node_checker_torch.parallel.mesh import MeshSpec, RankGroup\n"
        "cfg = BurninConfig(vocab=64, d_model=32, n_heads=2, d_ff=64, seq=16, batch=2)\n"
        "probe = \"sorted({'sympy', 'torch._dynamo'} & set(__import__('sys').modules))\"\n"
        "with RankGroup(2, 'cpu', timeout_s=60) as g:\n"
        "    runs = g.run(train_steps, cfg, MeshSpec((('data', 1), ('model', 2))), 1)\n"
        "    assert all(isinstance(r, tuple) for r in runs), runs\n"
        "    print(g.run(eval, probe))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[[], []]"
