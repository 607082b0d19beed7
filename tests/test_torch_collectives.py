"""The port's fabric probes on 8 gloo ranks, held against the JAX package's.

The JAX side runs on the suite's 8-device CPU mesh (tests/conftest.py); the
port side on one group of 8 gloo ranks, spawned once for this module and
shared by its tests (each rank pays an interpreter start).  Both sides take
the same payloads by construction (rank or device ``i``'s element ``j`` is
``i + j``) and the same inputs where there are any (numpy arrays handed to
both).  Verdicts, chaos localisation, link counts and link names must be
equal.

The sweep's timing ladder is not compared: on a loaded CPU any leg can read
SLOW, so the tests assert only DEAD verdicts and the injected SLOW leg by
name, never that a run has no other SLOW leg.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import time

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_node_checker.meshprobe import sweep as jax_sweep
from tpu_node_checker.parallel import collectives as jax_collectives
from tpu_node_checker.parallel import (
    MeshSpec,
    build_mesh,
    make_ring_attention,
)
from tpu_node_checker.parallel import ring_attention as jax_ring_attention

torch = importlib.import_module("torch")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")
port_collectives = importlib.import_module("tpu_node_checker_torch.parallel.collectives")
port_ring_attention = importlib.import_module("tpu_node_checker_torch.parallel.ring_attention")
port_sweep = importlib.import_module("tpu_node_checker_torch.meshprobe.sweep")

N = 8  # gloo ranks, as conftest's 8 virtual CPU devices
WALL_CLOCK_BUDGET_S = 60.0


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


LEG_FLAGS = ("psum_ok", "all_gather_ok", "reduce_scatter_ok")


class TestRankGroup:
    def test_group_size_and_backend(self, group):
        sizes = group.run(torch.distributed.get_world_size)
        ranks = group.run(torch.distributed.get_rank)
        assert sizes == [N] * N and ranks == list(range(N))
        assert group.run(torch.distributed.get_backend) == ["gloo"] * N

    def test_a_raising_call_is_reported_per_rank_and_the_group_survives(self, group):
        results = group.run(int, "x")
        assert all(isinstance(r, port_mesh.RankFailure) for r in results)
        assert all(r.error.startswith("ValueError") for r in results)
        assert _on_ranks(group, port_collectives.collective_probe, payload=16, timed_iters=1).ok

    def test_fold_demotes_rank_zero_on_another_rank_failure(self):
        ok = port_collectives.CollectiveResult(ok=True, n_devices=N, latency_us=1.0)
        bad = port_mesh.RankFailure(ok=False, error="RuntimeError: lost")
        folded = port_mesh.fold([ok, ok, bad])
        assert not folded.ok and folded.error == "rank 2: RuntimeError: lost"
        assert port_mesh.fold([ok, ok]) is ok

    def test_a_waiting_rank_polls_through_store_timeouts(self, tmp_path):
        # A rank waits in the store in slices (a spawned rank for its next
        # command, rank 0 for the others' results): a slice that times out
        # is a poll, not an error, and a wait on a process that is gone
        # stops.
        store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
        assert port_mesh._wait(store, "never", lambda: False, timeout_s=30) is False
        store.set("cmd/1", b"x")
        assert port_mesh._wait(store, "cmd/1", lambda: True, timeout_s=30) is True
        with pytest.raises(RuntimeError, match="timeout"):
            port_mesh._wait(store, "never", lambda: True, timeout_s=0)

    def test_bad_sizes_fail_before_spawning(self):
        with pytest.raises(ValueError, match="world_size"):
            port_mesh.RankGroup(0, "cpu")
        with pytest.raises(ValueError, match="cuda or cpu"):
            port_mesh.RankGroup(2, "tpu")


class TestCollectiveProbe:
    def test_healthy_matches_jax(self, group):
        port = _on_ranks(group, port_collectives.collective_probe, payload=64, timed_iters=2)
        ref = jax_collectives.collective_probe(payload=64, timed_iters=2)
        assert port.ok and ref.ok, (port.error, ref.error)
        assert port.n_devices == ref.n_devices == N
        assert {k: port.details[k] for k in LEG_FLAGS} == {k: ref.details[k] for k in LEG_FLAGS}
        assert port.details["busbw_gbps"] is not None and ref.details["busbw_gbps"] is not None
        assert set(port.details["leg_latency_us"]) == set(ref.details["leg_latency_us"])

    @pytest.mark.parametrize("leg", ["psum", "all_gather", "reduce_scatter"])
    def test_injected_leg_named_as_jax_names_it(self, group, leg):
        port = _on_ranks(group, port_collectives.collective_probe,
                         payload=16, timed_iters=1, inject_fault_leg=leg)
        ref = jax_collectives.collective_probe(payload=16, timed_iters=1, inject_fault_leg=leg)
        assert not port.ok and not ref.ok
        assert {k: port.details[k] for k in LEG_FLAGS} == {k: ref.details[k] for k in LEG_FLAGS}
        assert port.error == ref.error
        assert f"{leg} ok=False" in port.error

    def test_unknown_leg_fails_loudly(self, group):
        port = _on_ranks(group, port_collectives.collective_probe,
                         payload=16, inject_fault_leg="all_to_all")
        ref = jax_collectives.collective_probe(payload=16, inject_fault_leg="all_to_all")
        assert not port.ok and port.error == ref.error
        assert "not one of" in port.error

    @pytest.mark.parametrize("shape", [(8,), (2, 4), (2, 2, 2), (4, 1, 3)])
    def test_row_major_strides_equal_jax(self, shape):
        assert port_collectives._row_major_strides(shape) == jax_collectives._row_major_strides(shape)


class TestRingProbe:
    def test_healthy_matches_jax(self, group):
        port = _on_ranks(group, port_collectives.ring_probe, payload=32)
        ref = jax_collectives.ring_probe(payload=32)
        assert port.ok and ref.ok, (port.error, ref.error)
        assert port.details["hops"] == ref.details["hops"] == N
        assert port.details["link_gbps"] is not None and "bad_links" not in port.details

    @pytest.mark.parametrize("link", [0, 3, N - 1])
    def test_corrupted_link_named_as_jax_names_it(self, group, link):
        port = _on_ranks(group, port_collectives.ring_probe, payload=16, inject_fault_link=link)
        ref = jax_collectives.ring_probe(payload=16, inject_fault_link=link)
        assert not port.ok and not ref.ok
        assert port.details["bad_links"] == ref.details["bad_links"] == [f"{link}->{(link + 1) % N}"]
        assert f"{link}->{(link + 1) % N}" in port.error

    def test_sum_preserving_swap_localised_as_jax(self, group):
        port = _on_ranks(group, port_collectives.ring_probe, payload=16,
                         inject_fault_link=2, inject_fault_swap=True)
        ref = jax_collectives.ring_probe(payload=16, inject_fault_link=2, inject_fault_swap=True)
        assert not port.ok
        assert port.details["bad_links"] == ref.details["bad_links"] == ["2->3"]

    @pytest.mark.parametrize("kw,needle", [
        ({"inject_fault_swap": True}, "requires inject_fault_link"),
        ({"payload": 1, "inject_fault_link": 0, "inject_fault_swap": True}, "payload >= 2"),
        ({"inject_fault_link": N}, "out of range"),
    ])
    def test_bad_injection_fails_loudly_as_jax(self, group, kw, needle):
        kw = {"payload": 16, **kw}
        port = _on_ranks(group, port_collectives.ring_probe, **kw)
        ref = jax_collectives.ring_probe(**kw)
        assert not port.ok and not ref.ok
        assert needle in port.error and port.error == ref.error


class TestMeshLinkSweep:
    def test_healthy_sweep_names_jax_links(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, payload=16, hop_iters=3)
        ref = jax_sweep.mesh_link_sweep(payload=16, hop_iters=3)
        assert port.ok and ref.ok, (port.error, ref.error)
        assert port.n_links == ref.n_links == jax_sweep.expected_link_count(None, N)
        assert list(port.links) == list(ref.links) == jax_sweep.link_names(None, N)
        assert port.dead == [] and port.n_devices == N
        assert all(v["p50_us"] <= v["p99_us"] and v["budget_us"] > 0
                   for v in port.links.values())

    def test_dead_link_named_as_jax_names_it(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, payload=16, hop_iters=3,
                         inject_dead_link="d:3")
        ref = jax_sweep.mesh_link_sweep(payload=16, hop_iters=3, inject_dead_link="d:3")
        assert not port.ok and not ref.ok
        assert port.dead == ref.dead == ["d/3"]
        assert port.links["d/3"]["verdict"] == port_sweep.DEAD
        assert port.error == ref.error

    def test_slow_link_degrades_and_is_named_as_jax(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, payload=16, hop_iters=3,
                         inject_slow_link="d:3")
        ref = jax_sweep.mesh_link_sweep(payload=16, hop_iters=3, inject_slow_link="d:3")
        assert port.ok and port.degraded and ref.ok and ref.degraded
        assert "d/3" in port.slow and "d/3" in ref.slow
        assert port.links["d/3"]["verdict"] == port_sweep.SLOW
        assert port.dead == ref.dead == []

    @pytest.mark.parametrize("spec,needle", [
        ("zz:0", "axis 'zz'"),
        ("d:9", "out of range"),
        ("d", "must be 'axis:hop'"),
        ("d:x", "not an integer"),
    ])
    def test_typo_injection_fails_loudly_as_jax(self, group, spec, needle):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, payload=16, hop_iters=1,
                         inject_slow_link=spec)
        ref = jax_sweep.mesh_link_sweep(payload=16, hop_iters=1, inject_slow_link=spec)
        assert not port.ok and not ref.ok
        assert needle in port.error and port.error == ref.error

    def test_one_dim_topology_label_names_its_axis_as_jax(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="8", payload=16,
                         hop_iters=1, inject_dead_link="t0:5")
        ref = jax_sweep.mesh_link_sweep(topology="8", payload=16, hop_iters=1,
                                        inject_dead_link="t0:5")
        assert list(port.links) == list(ref.links) == jax_sweep.link_names("8", N)
        assert port.dead == ref.dead == ["t0/5"]

    def test_multi_dim_topology_not_yet_ported(self, group):
        # Ported: every leg of both axes, named as JAX names them.
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x4", payload=16,
                         hop_iters=1)
        assert port.ok and port.dead == [], port.error
        assert list(port.links) == jax_sweep.link_names("2x4", N)
        assert port.n_links == jax_sweep.expected_link_count("2x4", N) == 6


class TestSweepHelpersEqualJax:
    @pytest.mark.parametrize("topology", [None, "2x4", "4x4", "8", "2x2x2", "bogus", "0x8", ""])
    @pytest.mark.parametrize("n", [1, 3, 8])
    def test_link_names_and_counts(self, topology, n):
        assert port_sweep.link_names(topology, n) == jax_sweep.link_names(topology, n)
        assert port_sweep.expected_link_count(topology, n) == jax_sweep.expected_link_count(topology, n)
        assert port_sweep._axis_dims(topology, n) == jax_sweep._axis_dims(topology, n)

    def test_constants_and_quantiles(self):
        for name in ("OK", "SLOW", "DEAD", "VERDICTS", "DEFAULT_PAYLOAD", "DEFAULT_HOP_ITERS",
                     "BUDGET_FLOOR_US", "SLOW_FACTOR", "HOP_DEADLINE_US", "CHAOS_SLOW_INFLATION"):
            assert getattr(port_sweep, name) == getattr(jax_sweep, name), name
        xs = [5.0, 1.0, 9.0, 3.0, 7.0]
        for q in (0.0, 0.5, 0.99, 1.0):
            assert port_sweep._quantile(xs, q) == jax_sweep._quantile(xs, q)
        assert port_sweep.qualify_link("pool-a", "d/2") == jax_sweep.qualify_link("pool-a", "d/2")

    def test_link_spec_parsing(self):
        sizes = {"d": 8}
        assert port_sweep._parse_link_spec("d:3", sizes, "x") == jax_sweep._parse_link_spec(
            "d:3", sizes, "x")
        with pytest.raises(ValueError, match="has no links"):
            port_sweep._parse_link_spec("d:0", {"d": 1}, "x")


class TestRingAttention:
    def test_probe_holds_on_eight_ranks_as_jax(self, group):
        port = _on_ranks(group, port_ring_attention.ring_attention_probe, seq_per_device=16)
        ref = jax_ring_attention.ring_attention_probe(seq_per_device=16)
        assert port.ok and ref.ok, (port.error, ref.error)
        assert port.n_devices == ref.n_devices == N
        assert port.seq_len == ref.seq_len == N * 16
        # f32 on both sides, against an f32 reference: both far inside rtol.
        assert port.max_abs_err < 1e-4 and ref.max_abs_err < 1e-3

    def test_ring_output_matches_jax_ring(self, group):
        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal((2, N * 8, 2, 16)).astype(np.float32) for _ in range(3))
        blocks = group.run(port_ring_attention.ring_attention_sharded, q, k, v)
        port = np.concatenate([b.numpy() for b in blocks], axis=1)
        mesh = build_mesh(MeshSpec((("sp", N),)))
        spec = NamedSharding(mesh, P(None, "sp", None, None))
        ref = np.asarray(make_ring_attention(mesh)(*(jax.device_put(x, spec) for x in (q, k, v))))
        # f32 online softmax on both sides, blocks merged in the same order.
        np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)

    def test_references_agree(self):
        rng = np.random.default_rng(4)
        q, k, v = (rng.standard_normal((1, 24, 2, 8)).astype(np.float32) for _ in range(3))
        port = port_ring_attention.reference_causal_attention(
            *(torch.from_numpy(x) for x in (q, k, v))).numpy()
        ref = np.asarray(jax_ring_attention.reference_causal_attention(q, k, v))
        np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)

    def test_degenerate_shape_fails_as_jax(self, group):
        port = _on_ranks(group, port_ring_attention.ring_attention_probe, head_dim=0)
        ref = jax_ring_attention.ring_attention_probe(head_dim=0)
        assert not port.ok and not ref.ok
        assert "degenerate attention shape" in port.error
