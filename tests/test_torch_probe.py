"""The PyTorch/CUDA port's compute-level probe, held against the JAX probe.

The slice as a whole: the port's probe child at ``--probe-level compute``
runs on the CPU (``device="cpu"``: every kernel wrapper takes its plain
version there) beside the JAX child on the CPU mesh.  Both must be healthy,
emit the same report keys, and satisfy the JAX package's report schema.  The
port's copies of the JAX package's jax-free modules must stay equal to them.

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

import pytest

from tpu_node_checker import generations as jax_generations
from tpu_node_checker.probe import floors as jax_floors
from tpu_node_checker.probe import levels as jax_levels
from tpu_node_checker.probe import schema as jax_schema

port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
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

    @pytest.mark.parametrize("level", ["collective", "mesh", "workload"])
    def test_levels_above_compute_not_yet_ported(self, level):
        r = port_liveness.run_local_probe(level=level, device="cpu")
        assert not r.ok
        assert "not yet ported" in r.error and level in r.error
        assert "matmul_ok" not in r.details  # never ran silently at compute level

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

    def test_partial_enumeration_fails(self):
        r = port_liveness.run_local_probe(level="enumerate", device="cpu", expected_devices=2)
        assert not r.ok
        assert r.error == "only 1/2 expected devices enumerated"

    def test_kill_timer(self):
        r = port_liveness.run_local_probe(level="enumerate", device="cpu", timeout_s=0.001)
        assert not r.ok and "timed out" in r.error


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
