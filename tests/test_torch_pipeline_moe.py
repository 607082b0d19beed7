"""The port's pipeline and expert-parallel probes on 8 gloo ranks, held
against the JAX package's on its 8-device CPU mesh.

* The same numpy inputs go through JAX's ``make_pipeline`` and
  ``make_moe_layer`` and the port's ``pipeline_sharded`` and
  ``moe_sharded``: the outputs agree within 1e-5 absolute in f32.
* The two probes draw their inputs from different generators (JAX's
  ``PRNGKey(0)``, a seeded ``torch.Generator``), so their chaos drills are
  compared by what they name: every ``inject_fault_stage`` as the stage
  where the corruption entered, every ``inject_fault_expert`` as the one
  expert whose tokens came back wrong.

The port side runs on one group of 8 gloo ranks for the module.  torch and
the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import time

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_node_checker.parallel import MeshSpec, build_mesh
from tpu_node_checker.parallel import moe as jax_moe
from tpu_node_checker.parallel import pipeline as jax_pipeline

torch = importlib.import_module("torch")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")
port_pipeline = importlib.import_module("tpu_node_checker_torch.parallel.pipeline")
port_moe = importlib.import_module("tpu_node_checker_torch.parallel.moe")

N = 8  # gloo ranks, as conftest's 8 virtual CPU devices
WALL_CLOCK_BUDGET_S = 60.0
ATOL = 1e-5


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


def _on_ranks(group, fn, **kw):
    """``fn(**kw)`` on every rank, folded into rank 0's result."""
    return port_mesh.fold(group.run(fn, **kw))


def _pipeline_inputs(seed, d=32, M=4, B=2):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, d, d)) / np.sqrt(d)).astype(np.float32)
    b = (rng.standard_normal((N, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, B, d)).astype(np.float32)
    return w, b, x


def _moe_inputs(seed, d=32, f=64, T=16):
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((N, d, f)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((N, f, d)) / np.sqrt(f)).astype(np.float32)
    wr = rng.standard_normal((d, N)).astype(np.float32)
    x = rng.standard_normal((N * T, d)).astype(np.float32)
    return w1, w2, wr, x


class TestPipeline:
    @pytest.mark.parametrize("fault", [None, 0, 5], ids=["healthy", "stage0", "stage5"])
    def test_output_and_checksums_match_jax_pipeline(self, group, fault):
        w, b, x = _pipeline_inputs(1)
        results = group.run(port_pipeline.pipeline_sharded, w, b, x, inject_fault_stage=fault)
        mesh = build_mesh(MeshSpec((("pp", N),)))
        fn = jax_pipeline.make_pipeline(mesh, inject_fault_stage=fault, with_checksums=True)
        ref_out, ref_chk = fn(
            jax.device_put(w, NamedSharding(mesh, P("pp", None, None))),
            jax.device_put(b, NamedSharding(mesh, P("pp", None))),
            jax.device_put(x, NamedSharding(mesh, P())),
        )
        for out, chk in results:  # replicated on every rank
            np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL, rtol=0)
            np.testing.assert_allclose(chk.numpy(), np.asarray(ref_chk), rtol=1e-5)

    def test_references_agree(self):
        w, b, x = _pipeline_inputs(2)
        port, port_chk = port_pipeline.reference_pipeline(
            *(torch.from_numpy(a) for a in (w, b, x)), with_checksums=True)
        ref, ref_chk = jax_pipeline.reference_pipeline(w, b, x, with_checksums=True)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        np.testing.assert_allclose(port_chk.numpy(), np.asarray(ref_chk), rtol=1e-5)

    def test_healthy_probe_as_jax(self, group):
        port = _on_ranks(group, port_pipeline.pipeline_probe)
        ref = jax_pipeline.pipeline_probe()
        assert port.ok and ref.ok, (port.error, ref.error)
        assert (port.n_stages, port.n_microbatches) == (ref.n_stages, ref.n_microbatches) == (N, 4)
        assert port.max_abs_err < ATOL and port.details is None

    @pytest.mark.parametrize("stage", range(N))
    def test_every_stage_drill_named_as_jax(self, group, stage):
        port = _on_ranks(group, port_pipeline.pipeline_probe, inject_fault_stage=stage)
        ref = jax_pipeline.pipeline_probe(inject_fault_stage=stage)
        assert not port.ok and not ref.ok
        assert port.details["first_bad_stage"] == ref.details["first_bad_stage"] == stage
        where = f"corruption entered at stage {stage}"
        assert port.error.endswith(where) and ref.error.endswith(where)
        assert port.error.startswith("pipeline mismatch: max|Δ|=")

    def test_out_of_range_stage_fails_as_jax(self, group):
        port = _on_ranks(group, port_pipeline.pipeline_probe, inject_fault_stage=N)
        ref = jax_pipeline.pipeline_probe(inject_fault_stage=N)
        assert not port.ok and port.error == ref.error
        assert port.error == f"ValueError: inject_fault_stage {N} out of range for {N} stages"


class TestMoE:
    @pytest.mark.parametrize("fault", [None, 3], ids=["healthy", "expert3"])
    def test_outputs_match_jax_moe_layer(self, group, fault):
        w1, w2, wr, x = _moe_inputs(3)
        results = group.run(port_moe.moe_sharded, w1, w2, wr, x, inject_fault_expert=fault)
        gated = np.concatenate([g.numpy() for g, _ in results])
        ungated = np.concatenate([u.numpy() for _, u in results])
        mesh = build_mesh(MeshSpec((("ep", N),)))
        fn = jax_moe.make_moe_layer(mesh, inject_fault_expert=fault, with_ungated=True)
        ref_g, ref_u = fn(
            jax.device_put(w1, NamedSharding(mesh, P("ep", None, None))),
            jax.device_put(w2, NamedSharding(mesh, P("ep", None, None))),
            jax.device_put(wr, NamedSharding(mesh, P())),
            jax.device_put(x, NamedSharding(mesh, P("ep", None))),
        )
        np.testing.assert_allclose(gated, np.asarray(ref_g), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ungated, np.asarray(ref_u), atol=ATOL, rtol=0)

    def test_references_agree(self):
        w1, w2, wr, x = _moe_inputs(4)
        port_g, port_u = port_moe.reference_moe(
            *(torch.from_numpy(a) for a in (w1, w2, wr, x)), N, with_ungated=True)
        ref_g, ref_u = jax_moe.reference_moe(w1, w2, wr, x, N, with_ungated=True)
        np.testing.assert_allclose(port_g.numpy(), np.asarray(ref_g), atol=ATOL, rtol=0)
        np.testing.assert_allclose(port_u.numpy(), np.asarray(ref_u), atol=ATOL, rtol=0)

    def test_healthy_probe_as_jax(self, group):
        port = _on_ranks(group, port_moe.moe_probe)
        ref = jax_moe.moe_probe()
        assert port.ok and ref.ok, (port.error, ref.error)
        assert (port.n_experts, port.tokens) == (ref.n_experts, ref.tokens) == (N, N * 16)
        assert port.max_abs_err < ATOL and port.details is None

    @pytest.mark.parametrize("expert", range(N))
    def test_every_expert_drill_named_as_jax(self, group, expert):
        port = _on_ranks(group, port_moe.moe_probe, inject_fault_expert=expert)
        ref = jax_moe.moe_probe(inject_fault_expert=expert)
        assert not port.ok and not ref.ok
        assert port.details["bad_experts"] == ref.details["bad_experts"] == [expert]
        where = f"errors attribute to expert(s) [{expert}]"
        assert port.error.endswith(where) and ref.error.endswith(where)
        assert port.error.startswith("moe all_to_all mismatch: ungated max|Δ|=")

    def test_tokens_round_up_to_split_as_jax(self, group):
        port = _on_ranks(group, port_moe.moe_probe, tokens_per_device=12)
        ref = jax_moe.moe_probe(tokens_per_device=12)
        assert port.ok and ref.ok and port.tokens == ref.tokens == N * 16

    def test_out_of_range_expert_fails_as_jax(self, group):
        port = _on_ranks(group, port_moe.moe_probe, inject_fault_expert=-1)
        ref = jax_moe.moe_probe(inject_fault_expert=-1)
        assert not port.ok and port.error == ref.error
