"""The PyTorch/CUDA port's probe child, held against the JAX probe child.

The slices as a whole: the port's probe child at ``--probe-level compute``
and ``workload`` runs on the CPU (``device="cpu"``: every kernel wrapper
takes its plain version there, the rank group is one gloo rank) beside the
JAX child on the CPU (the 8-device mesh at compute level, one device at
workload level, as a one-card host runs it).  Both must be healthy, emit the
same report keys, and satisfy the JAX package's report schema.  The port's
copies of the JAX package's jax-free modules must stay equal to them; the
per-axis and multislice blocks must read as the JAX package's on one device,
and what is not ported yet (distributed probing) must fail as such.

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/, and
a missing torch must fail loudly, not skip.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from tpu_node_checker import generations as jax_generations
from tpu_node_checker.parallel import collectives as jax_collectives
from tpu_node_checker.parallel import mesh as jax_mesh
from tpu_node_checker.probe import floors as jax_floors
from tpu_node_checker.probe import levels as jax_levels
from tpu_node_checker.probe import liveness as jax_liveness
from tpu_node_checker.probe import schema as jax_schema

torch = importlib.import_module("torch")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
port_mesh = importlib.import_module("tpu_node_checker_torch.parallel.mesh")
port_schema = importlib.import_module("tpu_node_checker_torch.probe.schema")
port_floors = importlib.import_module("tpu_node_checker_torch.probe.floors")
port_levels = importlib.import_module("tpu_node_checker_torch.probe.levels")
port_generations = importlib.import_module("tpu_node_checker_torch.generations")

REPO = Path(__file__).resolve().parent.parent

# Keys only the port's report carries: the launch count of each hand-written
# kernel (all 0 on the CPU, where the plain versions run).
PORT_ONLY_KEYS = {"kernel_launches"}
# Keys that exist by design only where the runtime reports them: per-device
# memory (neither JAX's CPU backend nor torch's CPU device has it).
PLATFORM_KEYS = {"memory"}


@pytest.fixture(scope="module")
def port_compute_report():
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        # Two threads: the suite runs files in parallel, and timing-graded
        # tests elsewhere (the mesh link sweep) read CPU contention as a
        # slow link.
        mp.setenv("OMP_NUM_THREADS", "2")
        return port_liveness.run_local_probe(level="compute", timeout_s=300, device="cpu")


@pytest.fixture(scope="module")
def workload_reports():
    """(port, JAX) workload-level children on the CPU, one device each."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        # One thread each, one child at a time: the suite runs files in
        # parallel, and timing-graded tests elsewhere (the JAX mesh link
        # sweep) read CPU contention as a slow link.
        mp.setenv("OMP_NUM_THREADS", "1")
        port = port_liveness.run_local_probe(level="workload", timeout_s=300, device="cpu")
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1 "
                  "--xla_cpu_multi_thread_eigen=false")
        ref = jax_liveness.run_local_probe(level="workload", timeout_s=300)
    return port, ref


class TestWorkloadSlice:
    def test_both_healthy(self, workload_reports):
        port, ref = workload_reports
        assert ref.ok, ref.error
        assert port.ok, port.error
        d = port.to_dict()
        for key in ("collective_ok", "ring_ok", "mesh_ok", "workload_ok", "ring_attention_ok"):
            assert d[key] is True, key
        losses = d["workload_losses"]
        assert len(losses) == 3 and all(b < a for a, b in zip(losses, losses[1:]))
        assert d["workload_devices"] == 1 and d["mesh_n_links"] == 0
        assert d["collective_legs_ok"]["links"] == {}

    def test_same_keys_as_jax_child(self, workload_reports):
        port, ref = workload_reports
        port_keys = set(port.to_dict()) - PORT_ONLY_KEYS - PLATFORM_KEYS
        assert port_keys == set(ref.to_dict()) - PLATFORM_KEYS
        assert set(port.details["collective_legs_ok"]) == set(ref.details["collective_legs_ok"])

    def test_report_passes_jax_schema(self, workload_reports):
        doc = {**workload_reports[0].to_dict(), "schema": 1, "written_at": 0.0}
        assert jax_schema.validate_report(doc) == []
        assert port_schema.validate_report(doc) == []

    def test_one_rank_fabric_reads_as_jax(self, workload_reports):
        # One device: no bus or link bandwidth to measure (None, never 0.0).
        port, ref = (r.to_dict() for r in workload_reports)
        for key in ("collective_busbw_gbps", "ring_link_gbps"):
            assert port[key] is None and ref[key] is None, key
        assert port["kernel_launches"] == {
            "tiled_matmul": 0, "dma_stream": 0, "flash_attention": 0,
        }


class TestComputeSlice:
    def test_both_healthy(self, port_compute_report, shared_compute_probe):
        assert shared_compute_probe.ok, shared_compute_probe.error
        assert port_compute_report.ok, port_compute_report.error
        d = port_compute_report.to_dict()
        for key in ("matmul_ok", "hbm_ok", "pallas_ok", "int8_ok",
                    "flash_attention_ok", "dma_ok", "memtest_ok"):
            assert d[key] is True, key

    def test_same_keys_as_jax_child(self, port_compute_report, shared_compute_probe):
        port_keys = set(port_compute_report.to_dict())
        jax_keys = set(shared_compute_probe.to_dict())
        assert port_keys - PORT_ONLY_KEYS - PLATFORM_KEYS == jax_keys - PLATFORM_KEYS

    def test_report_passes_jax_schema(self, port_compute_report):
        doc = {**port_compute_report.to_dict(), "schema": 1, "written_at": 0.0}
        assert jax_schema.validate_report(doc) == []
        assert port_schema.validate_report(doc) == []

    def test_cpu_report_stamps_skips_and_no_launches(self, port_compute_report):
        d = port_compute_report.to_dict()
        assert d["platform"] == "cpu" and d["device_kinds"] == ["cpu"]
        assert "skipped" in d["hbm_capacity"] and "skipped" in d["perf_floor"]
        assert d["kernel_launches"] == {
            "tiled_matmul": 0, "dma_stream": 0, "flash_attention": 0,
        }


class TestCopiesOfJaxModules:
    def test_report_spec_equals_jax(self):
        assert port_schema.REPORT_SPEC == jax_schema.REPORT_SPEC
        assert port_schema.REQUIRED_KEYS == jax_schema.REQUIRED_KEYS
        assert port_schema.as_json_schema() == jax_schema.as_json_schema()

    def test_levels_equal_jax(self):
        assert port_levels.LEVELS == jax_levels.LEVELS
        assert port_levels.LEVEL_TIMEOUTS_S == jax_levels.LEVEL_TIMEOUTS_S

    def test_floor_tables_equal_jax(self):
        for name in ("CHIP_SPECS", "HBM_CAPACITY_GB", "HBM_CAPACITY_FRACTION",
                     "FLOOR_METRICS", "DEFAULT_FLOOR_FRACTION", "MAX_DISPATCH_OVERHEAD_MS"):
            assert getattr(port_floors, name) == getattr(jax_floors, name), name
        assert port_generations.GENERATION_ALIASES == jax_generations.GENERATION_ALIASES
        assert port_generations.LABEL_GENERATION == jax_generations.LABEL_GENERATION

    @pytest.mark.parametrize("measured,expect", [
        ({"matmul_tflops": 300.0}, None),
        ({"matmul_tflops": 300.0, "hbm_gbps": 2000.0}, {"matmul_tflops": 1000.0}),
        ({"hbm_gbps": 10.0}, {"hbm_gbps": 20.0, "bogus": 1}),
    ])
    @pytest.mark.parametrize("platform,kinds", [
        ("gpu", ["NVIDIA H100 80GB HBM3"]), ("tpu", ["TPU v5 lite"]),
    ])
    def test_floor_grading_equals_jax(self, measured, expect, platform, kinds):
        # On the card the built-in (TPU) table skips, TNC_PERF_EXPECT grades.
        args = (kinds, platform, measured)
        kw = {"expectations": expect, "dispatch_overhead_ms": 0.07}
        assert port_floors.grade_floors(*args, **kw) == jax_floors.grade_floors(*args, **kw)

    def test_capacity_grading_skips_off_tpu(self):
        mem = [{"id": 0, "bytes_in_use": 1, "bytes_limit": 85017493504}]
        verdict = port_floors.grade_hbm_capacity(["NVIDIA H100 80GB HBM3"], "gpu", mem)
        assert verdict == {"skipped": "platform 'gpu' has no HBM capacity table"}
        assert verdict == jax_floors.grade_hbm_capacity(["NVIDIA H100 80GB HBM3"], "gpu", mem)


class TestProbeFailures:
    def test_default_device_without_cuda_fails_naming_cuda(self):
        # This box has no card: the default cuda:0 must fail loudly, never
        # fall back to the CPU.
        r = port_liveness.run_local_probe(level="enumerate")
        assert not r.ok
        assert "CUDA" in r.error

    @pytest.mark.parametrize("level,env", [
        ("collective", {"TNC_TOPOLOGY": "2x4"}),
        ("mesh", {"TNC_TOPOLOGY": "1x1"}),
        ("collective", {"TNC_CHAOS_SLICES": "2"}),
        ("collective", {"TNC_CHAOS_AXIS": "t0"}),
    ], ids=["topology-2x4", "topology-1x1", "chaos-slices", "chaos-axis"])
    def test_still_not_ported_child(self, monkeypatch, level, env):
        # Once "not yet ported"; now the per-axis and multislice block runs,
        # on one CPU rank as the JAX child runs it on one device.
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        r = port_liveness.run_local_probe(level=level, device="cpu")
        d = r.to_dict()
        assert port_schema.validate_report({**d, "schema": 1, "written_at": 0.0}) == []
        one_device = jax.devices()[:1]
        if "TNC_TOPOLOGY" in env:
            # A label that does not match the rank count falls back to the
            # flat axis; 1x1 matches one card.
            ref = jax_collectives.per_axis_probe(
                mesh=jax_mesh.mesh_from_topology(env["TNC_TOPOLOGY"], devices=one_device))
            assert r.ok, r.error
            assert d["ici_axis_ok"] == ref.details["axis_ok"]
            assert d["ici_topology"] == ref.details["topology"]
            assert set(d["ici_axis_busbw_gbps"]) == set(ref.details["axis_ok"])
            assert "matmul_ok" in d  # the levels below ran too
        elif "TNC_CHAOS_SLICES" in env:
            # One card does not split into two slices: JAX's own error.
            with pytest.raises(ValueError) as ref:
                jax_mesh.hybrid_mesh(devices=one_device, num_slices=2)
            assert not r.ok and r.error == f"ValueError: {ref.value}"
            assert d["chaos_injected"] == {"slices": "2"}
        else:
            # An axis with no multi-dim mesh to inject into fails loudly,
            # with the JAX child's words.
            assert not r.ok
            assert r.error.startswith("ValueError: TNC_CHAOS_AXIS='t0' requested but no "
                                      "multi-dim topology is set (TNC_TOPOLOGY=None)")
            for words in ('{chaos[\'axis\']!r} requested but no "',
                          '"multi-dim topology is set (TNC_TOPOLOGY={topo!r}); "'):
                assert words in jax_liveness._CHILD_SCRIPT
        if level == "mesh":
            assert d["mesh_ok"] is True and d["mesh_n_links"] == 0

    def test_multi_card_workload_not_yet_ported(self):
        # The rule the child applies on a host with more than one card,
        # as the JAX child applies it: model 2 on an even count, data the
        # rest, when the batch of 8 splits data ways; else one card's step.
        rule = port_burnin.workload_mesh
        assert rule(4, 8) == port_mesh.MeshSpec((("data", 2), ("model", 2)))
        assert rule(8, 8) == port_mesh.MeshSpec((("data", 4), ("model", 2)))
        assert rule(2, 8) == port_mesh.MeshSpec((("data", 1), ("model", 2)))
        assert rule(3, 8) is None and rule(1, 8) is None
        assert rule(6, 8) is None  # data 3 does not split a batch of 8
        # Nothing but distributed probing is left unported.
        assert port_liveness.not_yet_ported({"TNC_TOPOLOGY": "2x4", "TNC_CHAOS_AXIS": "t0",
                                             "TNC_CHAOS_SLICES": "2"}) is None

    def test_sharded_workload_not_yet_ported(self):
        # The sharded step at data 1 x model 1 in a one-rank gloo group is
        # the one-card step: the same losses from the same seed.
        spec = port_mesh.MeshSpec((("data", 1), ("model", 1)))
        one_card = port_burnin.workload_probe(steps=2, device="cpu")
        with port_mesh.RankGroup(1, "cpu", timeout_s=60) as group:
            (sharded,) = group.run(port_burnin.workload_probe, mesh=spec, steps=2)
            (too_big,) = group.run(port_burnin.workload_probe, steps=1,
                                   mesh=port_mesh.MeshSpec((("data", 2), ("model", 2))))
        assert one_card.ok and sharded.ok, (one_card.error, sharded.error)
        assert sharded.losses == one_card.losses
        assert not too_big.ok and "needs 4 devices, got 1" in too_big.error

    def test_distributed_not_yet_ported(self, monkeypatch):
        monkeypatch.setenv("TNC_PROBE_DISTRIBUTED", "1")
        r = port_liveness.run_local_probe(level="compute", device="cpu")
        assert not r.ok
        assert "not yet ported" in r.error and "TNC_PROBE_DISTRIBUTED" in r.error

    def test_unknown_level_is_usage_error(self):
        with pytest.raises(ValueError, match="unknown probe level"):
            port_liveness.run_local_probe(level="bogus", device="cpu")

    def test_chaos_var_at_wrong_level_fails_and_is_stamped(self, monkeypatch):
        monkeypatch.setenv("TNC_CHAOS_RING_LINK", "0")
        r = port_liveness.run_local_probe(level="enumerate", device="cpu")
        assert not r.ok
        assert "TNC_CHAOS_RING_LINK" in r.error
        assert r.details["chaos_injected"] == {"ring_link": "0"}

    def test_chaos_ring_link_named_and_stamped_as_set(self, monkeypatch):
        monkeypatch.setenv("TNC_CHAOS_RING_LINK", "0")
        r = port_liveness.run_local_probe(level="collective", device="cpu")
        assert not r.ok and r.details["ring_ok"] is False
        assert r.details["ring_bad_links"] == ["0->0"]  # one rank: its link to itself
        # Stamped as the variable was set; the report stays schema-valid.
        assert r.details["chaos_injected"] == {"ring_link": "0"}
        doc = {**r.to_dict(), "schema": 1, "written_at": 0.0}
        assert port_schema.validate_report(doc) == []
        assert jax_schema.validate_report(doc) == []

    def test_partial_enumeration_fails(self):
        r = port_liveness.run_local_probe(level="enumerate", device="cpu", expected_devices=2)
        assert not r.ok
        assert r.error == "only 1/2 expected devices enumerated"

    def test_kill_timer(self):
        r = port_liveness.run_local_probe(level="enumerate", device="cpu", timeout_s=0.001)
        assert not r.ok and "timed out" in r.error


class TestRankGroupLifecycle:
    """The rank group the fabric levels run on, where a rank dies.  Here and
    not in tests/test_torch_collectives.py, whose module-wide group holds
    this process's default process group."""

    def test_a_dead_rank_is_reported_not_waited_for(self):
        with port_mesh.RankGroup(2, "cpu", timeout_s=60) as group:
            (spawned,) = group._procs
            spawned.kill()
            spawned.join(timeout=10)
            results = group.run(torch.distributed.get_rank)
        assert results[0] == 0
        assert isinstance(results[1], port_mesh.RankFailure)
        assert results[1].error == f"rank 1 exited with code {spawned.exitcode}"


class TestEmitCli:
    def _run(self, *args, env=None):
        return subprocess.run(
            [sys.executable, "-m", "tpu_node_checker_torch", *args],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env={**os.environ, **(env or {})},
        )

    def test_emit_file_atomically_with_envelope(self, tmp_path):
        target = tmp_path / "report.json"
        proc = self._run("--emit-probe", str(target), "--probe-level", "enumerate",
                         "--device", "cpu")
        assert proc.returncode == 0, proc.stderr
        doc = json.loads(target.read_text())
        assert doc["ok"] is True and doc["schema"] == 1
        assert isinstance(doc["written_at"], float)
        assert jax_schema.validate_report(doc) == []
        assert not (tmp_path / "report.json.tmp").exists()

    def test_unhealthy_exit_3(self):
        # Default device on a box without a card: a report, exit 3.
        proc = self._run("--emit-probe", "-", "--probe-level", "enumerate")
        assert proc.returncode == 3, proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["ok"] is False and "CUDA" in doc["error"]
