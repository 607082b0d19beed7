"""The rank mesh and the per-axis probes on 8 gloo ranks, held against the
JAX package's 8-device CPU mesh.

* Mesh layout: the port lays axes over the ranks row-major, as JAX lays
  them over CPU devices (no coordinates, no slice index): each rank's
  coordinates and lines must be where JAX puts the device with its id.
* ``per_axis_probe`` on ``2x4``, ``2x2x2`` and a 2-slice hybrid mesh, with
  and without a fault on each axis: the same verdicts, the same error.
* ``axis_bandwidth_probe`` on each axis: healthy, with a bus bandwidth.
* The link sweep over ``2x4``: every leg of both axes, named as JAX names
  them, a dead leg named alike on both sides, a slow leg named.

The port side runs on one group of 8 gloo ranks for the module.  torch and
the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib
import time

import numpy as np
import pytest

from tpu_node_checker.meshprobe import sweep as jax_sweep
from tpu_node_checker.parallel import collectives as jax_collectives
from tpu_node_checker.parallel import mesh as jax_mesh

torch = importlib.import_module("torch")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")
port_collectives = importlib.import_module("tpu_node_checker_torch.parallel.collectives")
port_sweep = importlib.import_module("tpu_node_checker_torch.meshprobe.sweep")

N = 8  # gloo ranks, as conftest's 8 virtual CPU devices
WALL_CLOCK_BUDGET_S = 60.0
TOPOLOGIES = ["2x4", "2x2x2", "8", None, "bogus"]


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


def _on_ranks(group, fn, *args, **kw):
    """``fn(*args, **kw)`` on every rank, folded into rank 0's result."""
    return port_mesh.fold(group.run(fn, *args, **kw))


def _device_ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _jax_mesh(topology, slices):
    if slices:
        return jax_mesh.hybrid_mesh(topology=topology, num_slices=slices)
    return jax_mesh.mesh_from_topology(topology)


def _port_spec(topology, slices):
    if slices:
        return port_mesh.hybrid_spec(N, topology=topology, num_slices=slices)
    return port_mesh.topology_spec(topology, N)


MESHES = [(t, None) for t in TOPOLOGIES] + [(None, 2), ("2x2", 2)]
MESH_IDS = [f"topology-{t}" for t in TOPOLOGIES] + ["hybrid-2", "hybrid-2-2x2"]


class TestMeshLayout:
    @pytest.mark.parametrize("topology,slices", MESHES, ids=MESH_IDS)
    def test_spec_and_layout_equal_jax(self, topology, slices):
        ref = _jax_mesh(topology, slices)
        spec = _port_spec(topology, slices)
        assert spec.axis_names == tuple(ref.axis_names)
        assert spec.shape == tuple(ref.devices.shape)
        np.testing.assert_array_equal(port_mesh.mesh_layout(spec), _device_ids(ref))

    @pytest.mark.parametrize("topology,slices", MESHES, ids=MESH_IDS)
    def test_each_rank_sits_where_jax_puts_its_device(self, group, topology, slices):
        if slices:
            meshes = group.run(port_mesh.hybrid_mesh, topology, slices)
        else:
            meshes = group.run(port_mesh.mesh_from_topology, topology)
        ids = _device_ids(_jax_mesh(topology, slices))
        for rank, m in enumerate(meshes):
            assert isinstance(m, port_mesh.RankMesh), m
            assert ids[m.coords] == rank
            for a, name in enumerate(m.axis_names):
                # The line through this rank along the axis: JAX's devices
                # at every coordinate of that axis, the others held.
                at = list(m.coords)
                at[a] = slice(None)
                assert list(m.lines[name]) == ids[tuple(at)].tolist(), (rank, name)

    @pytest.mark.parametrize("slices,topology", [(None, None), (1, None), (3, None)])
    def test_hybrid_refusals_equal_jax(self, slices, topology):
        with pytest.raises(ValueError) as ref:
            jax_mesh.hybrid_mesh(num_slices=slices, topology=topology)
        with pytest.raises(ValueError) as port:
            port_mesh.hybrid_spec(N, topology=topology, num_slices=slices)
        assert str(port.value) == str(ref.value)

    def test_a_mesh_of_the_wrong_size_fails_as_jax(self, group):
        spec = port_mesh.MeshSpec((("data", 4), ("model", 4)))
        results = group.run(port_mesh.build_mesh, spec)
        with pytest.raises(ValueError) as ref:
            jax_mesh.build_mesh(jax_mesh.MeshSpec(spec.axes))
        assert all(isinstance(r, port_mesh.RankFailure) for r in results)
        assert results[0].error == f"ValueError: {ref.value}"

    def test_a_sub_group_that_fails_to_form_fails_by_name(self, monkeypatch):
        # Never a flatter mesh in its place: the probe fails, naming the
        # axis and the ranks of the line whose group did not form.
        def refuse(ranks):
            raise RuntimeError("no communicator")

        monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda group=None: 4)
        monkeypatch.setattr(port_mesh.dist, "get_rank", lambda group=None: 0)
        monkeypatch.setattr(port_mesh.dist, "new_group", refuse)
        # A world of its own: no line group of the module's 8 ranks is reused.
        monkeypatch.setattr(port_mesh, "_LINE_GROUPS", {})
        r = port_collectives.per_axis_probe(topology="2x2")
        assert not r.ok
        assert r.error == ("RuntimeError: the process group of mesh axis 't0' over ranks "
                           "[0, 2] failed to form: RuntimeError: no communicator")
        assert (("t0", 2), ("t1", 2)) not in port_mesh._MESHES

    def test_meshes_with_a_line_over_the_same_ranks_share_its_group(self, group):
        # 2x2x2 and the 2-slice hybrid over 2x2 have the same lines, axis by
        # axis: one communicator each, not one per mesh.  Rank 0 runs here.
        for results in (group.run(port_mesh.mesh_from_topology, "2x2x2"),
                        group.run(port_mesh.hybrid_mesh, "2x2", 2)):
            assert all(isinstance(m, port_mesh.RankMesh) for m in results), results
        torus = port_mesh._MESHES[(("t0", 2), ("t1", 2), ("t2", 2))]
        hybrid = port_mesh._MESHES[(("dcn", 2), ("t0", 2), ("t1", 2))]
        for a, b in (("t0", "dcn"), ("t1", "t0"), ("t2", "t1")):
            assert torus.lines[a] == hybrid.lines[b]
            assert torus.groups[a] is hybrid.groups[b], (a, b)

    @pytest.mark.parametrize("topology", ["2x4", "4x4", "16x16", "2x2x1", "0x8", "x", "", None])
    def test_topology_helpers_equal_jax(self, topology):
        detect = importlib.import_module("tpu_node_checker.detect")
        assert port_mesh.parse_topology(topology) == detect.parse_topology(topology)
        assert port_mesh.topology_chip_count(topology) == detect.topology_chip_count(topology)


def _per_axis_cases():
    cases = []
    for topology, slices, axes in (("2x4", None, ("t0", "t1")),
                                   ("2x2x2", None, ("t0", "t1", "t2")),
                                   ("2x2", 2, ("dcn", "t0", "t1"))):
        for fault in (None,) + axes:
            cases.append(pytest.param(topology, slices, fault,
                                      id=f"{'hybrid-' if slices else ''}{topology}-{fault}"))
    return cases


class TestPerAxisProbe:
    @pytest.mark.parametrize("topology,slices,fault", _per_axis_cases())
    def test_verdict_and_error_equal_jax(self, group, topology, slices, fault):
        if slices:
            port = _on_ranks(group, port_collectives.per_axis_probe,
                             mesh=_port_spec(topology, slices), inject_fault_axis=fault)
            ref = jax_collectives.per_axis_probe(
                mesh=_jax_mesh(topology, slices), inject_fault_axis=fault)
        else:
            port = _on_ranks(group, port_collectives.per_axis_probe,
                             topology=topology, inject_fault_axis=fault)
            ref = jax_collectives.per_axis_probe(topology=topology, inject_fault_axis=fault)
        assert port.ok == ref.ok == (fault is None), (port.error, ref.error)
        assert port.details == ref.details
        assert port.error == ref.error
        assert port.n_devices == ref.n_devices == N
        if fault == "dcn":
            assert port.error == "fault localized to the DCN slice boundary"

    def test_unknown_axis_fails_loudly_as_jax(self, group):
        port = _on_ranks(group, port_collectives.per_axis_probe, topology="2x4",
                         inject_fault_axis="t2")
        ref = jax_collectives.per_axis_probe(topology="2x4", inject_fault_axis="t2")
        assert not port.ok and port.error == ref.error
        assert "not in mesh axes" in port.error

    def test_closed_form_equals_jax(self):
        shape, coords = (2, 2, 2), (1, 0, 1)
        strides = port_collectives._row_major_strides(shape)
        idxs, lin = port_collectives._linear_index(coords, strides)
        col = np.arange(16, dtype=np.float32)
        for a in range(3):
            port = port_collectives._expected_axis_psum(
                lin, idxs, a, shape, strides, torch.from_numpy(col)).numpy()
            ref = jax_collectives._expected_axis_psum(
                np.float32(lin), [np.int32(c) for c in idxs], a, shape, strides, col)
            np.testing.assert_array_equal(port, ref)
        assert lin == 5.0


class TestAxisBandwidthProbe:
    @pytest.mark.parametrize("axis", ["dcn", "t0", "t1"])
    def test_each_hybrid_axis_healthy_with_busbw(self, group, axis):
        spec = _port_spec("2x2", 2)
        port = _on_ranks(group, port_collectives.axis_bandwidth_probe, spec, axis,
                         payload=1 << 12)
        ref = jax_collectives.axis_bandwidth_probe(_jax_mesh("2x2", 2), axis, payload=1 << 12)
        assert port.ok and ref.ok, (port.error, ref.error)
        assert port.details["axis"] == axis and port.details["axis_size"] == 2
        assert {k: port.details[k] for k in ("axis", "axis_size")} == {
            k: ref.details[k] for k in ("axis", "axis_size")}
        assert port.details["busbw_gbps"] > 0 and ref.details["busbw_gbps"] > 0

    @pytest.mark.parametrize("axis", ["t0", "t1"])
    def test_each_torus_axis_healthy_with_busbw(self, group, axis):
        port = _on_ranks(group, port_collectives.axis_bandwidth_probe,
                         _port_spec("2x4", None), axis, payload=1 << 12)
        assert port.ok, port.error
        assert port.details["axis_size"] == {"t0": 2, "t1": 4}[axis]
        assert port.details["busbw_gbps"] > 0

    def test_exact_at_a_four_mib_payload(self, group):
        # Position mod 256 keeps every sum an exact f32 integer at 2^20
        # elements, where a plain position index would round.
        port = _on_ranks(group, port_collectives.axis_bandwidth_probe,
                         _port_spec("2x2", 2), "dcn", payload=1 << 20, timed_iters=1)
        assert port.ok, port.error

    def test_unknown_axis_fails_as_jax(self, group):
        port = _on_ranks(group, port_collectives.axis_bandwidth_probe,
                         _port_spec(None, 2), "nope")
        ref = jax_collectives.axis_bandwidth_probe(_jax_mesh(None, 2), "nope")
        assert not port.ok and port.error == ref.error


class TestMultiAxisSweep:
    def test_every_leg_of_both_axes_named_as_jax(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x4", payload=16,
                         hop_iters=2)
        assert port.ok and port.dead == [], port.error
        assert list(port.links) == jax_sweep.link_names("2x4", N)
        assert port.n_links == 6 and port.topology == "2x4"

    def test_dead_leg_named_alike_on_both_sides(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x4", payload=16,
                         hop_iters=1, inject_dead_link="t1:3")
        ref = jax_sweep.mesh_link_sweep(topology="2x4", payload=16, hop_iters=1,
                                        inject_dead_link="t1:3")
        assert not port.ok and not ref.ok
        assert port.dead == ref.dead == ["t1/3"]
        assert port.error == ref.error
        assert list(port.links) == list(ref.links)

    def test_slow_leg_degrades_and_is_named(self, group):
        # 100x, not the default 1000x: still 12x past the SLOW factor, and a
        # hop slowed by a loaded CPU stays clear of the DEAD deadline.
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x4", payload=16,
                         hop_iters=3, inject_slow_link="t0:1", slow_inflation=100.0)
        assert port.ok and port.degraded, port.error
        assert "t0/1" in port.slow and port.links["t0/1"]["verdict"] == port_sweep.SLOW
        assert port.dead == []

    def test_three_axes_named_as_jax(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x2x2", payload=16,
                         hop_iters=1, inject_dead_link="t2:0")
        assert list(port.links) == jax_sweep.link_names("2x2x2", N)
        assert port.dead == ["t2/0"]

    def test_typo_axis_fails_loudly_as_jax(self, group):
        port = _on_ranks(group, port_sweep.mesh_link_sweep, topology="2x4", payload=16,
                         hop_iters=1, inject_dead_link="d:0")
        ref = jax_sweep.mesh_link_sweep(topology="2x4", payload=16, hop_iters=1,
                                        inject_dead_link="d:0")
        assert not port.ok and port.error == ref.error
