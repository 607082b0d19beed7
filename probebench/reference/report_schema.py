"""The probe report's declared schema, as the benchmark holds the program to it.

A copy of the key table and type check of the program's ``probe/schema.py``
(``REPORT_SPEC``, ``REQUIRED_KEYS``, ``validate_report``), kept here so that
a change to the program cannot loosen the yardstick it is judged by.  The
spec language: ``"bool" | "int" | "number" | "str" | "any"``; a tuple is any
of its entries (``"null"`` is JSON null); a one-entry list is a list of that
spec; a dict holds ``__keys__`` (known keys by name) and ``__values__`` (the
spec of every other key).  Unknown keys are allowed, as in the program.
"""

from __future__ import annotations

from typing import List, Mapping

_NUM_OR_NULL = ("number", "null")

_SOAK = {"__keys__": {
    "ok": "bool", "rounds": "int", "seconds": "number", "tflops_min": "number",
    "tflops_median": "number", "tflops_max": "number", "sustained_ratio": "number",
    "hbm_gbps_min": "number", "hbm_gbps_median": "number", "error": "str",
}}

_PERF_FLOOR = {"__keys__": {
    "skipped": "str", "generation": "str", "fraction": "number",
    "expected": {"__values__": "number"}, "measured": {"__values__": "number"},
    "ratios": {"__values__": "number"}, "failed": ["str"], "throttled": ["str"],
    "ok": "bool",
}}

_HBM_CAPACITY = {"__keys__": {
    "skipped": "str", "generation": "str", "expected_gb": "number", "fraction": "number",
    "min_gb": "number", "failed_devices": [{"__keys__": {"id": "any", "gb": "number"}}],
    "ok": "bool",
}}

REPORT_SPEC = {
    # envelope
    "ok": "bool", "level": "str", "hostname": "str", "elapsed_ms": "number",
    "error": ("str", "null"), "schema": "int", "written_at": "number",
    # enumerate
    "platform": ("str", "null"), "device_count": "int", "local_device_count": "int",
    "device_kinds": ["str"], "process_index": "int", "process_count": "int",
    "distributed": "bool", "distributed_psum": "number", "distributed_psum_ok": "bool",
    "num_slices": "int", "slice_indices": ["int"],
    "memory": [{"__keys__": {"id": "any", "bytes_in_use": ("int", "null"),
                             "bytes_limit": ("int", "null")}}],
    "hbm_capacity": _HBM_CAPACITY,
    # compute
    "matmul_ok": "bool", "matmul_tflops": "number", "hbm_ok": "bool", "hbm_gbps": "number",
    "pallas_ok": "bool", "int8_ok": "bool", "int8_tops": "number", "int8_err": "str",
    "int8_skipped": "bool", "flash_attention_ok": "bool", "flash_attention_skipped": "bool",
    "flash_attention_err": "str", "flash_attention_max_abs_err": "number",
    "dma_ok": "bool", "dma_gbps": "number", "memtest_ok": "bool", "memtest_err": "str",
    "memtest_mismatches": {"__values__": "int"}, "dispatch_overhead_ms": "number",
    "soak": _SOAK, "perf_floor": _PERF_FLOOR,
    # collective
    "collective_ok": "bool", "collective_latency_us": "number",
    "collective_busbw_gbps": _NUM_OR_NULL, "ring_ok": "bool", "ring_link_gbps": _NUM_OR_NULL,
    "ring_bad_links": ["str"], "ring_err": "str",
    "collective_legs_ok": {
        "__keys__": {
            "psum_ok": ("bool", "null"), "all_gather_ok": ("bool", "null"),
            "reduce_scatter_ok": ("bool", "null"), "psum_latency_us": _NUM_OR_NULL,
            "all_gather_latency_us": _NUM_OR_NULL, "reduce_scatter_latency_us": _NUM_OR_NULL,
            "links": {"__values__": {"__keys__": {
                "verdict": "str", "p50_us": "number", "p99_us": "number", "budget_us": "number",
            }}},
        },
        "__values__": ("bool", "null"),
    },
    "collective_err": "str",
    # mesh
    "mesh_ok": "bool", "mesh_degraded": "bool", "mesh_n_links": "int",
    "mesh_latency_us": "number", "mesh_slow_links": ["str"], "mesh_dead_links": ["str"],
    "mesh_err": "str", "chaos_injected": {"__values__": "str"},
    "ici_topology": ("str", "null"), "ici_axis_ok": ({"__values__": "bool"}, "null"),
    "ici_axis_busbw_gbps": {"__values__": _NUM_OR_NULL}, "axis_busbw_err": {"__values__": "str"},
    "fault_domain_ok": ({"__values__": "bool"}, "null"), "fault_domain_topology": ("str", "null"),
    "fault_domain_busbw_gbps": {"__values__": _NUM_OR_NULL}, "dcn_busbw_gbps": _NUM_OR_NULL,
    "dcn_err": "str",
    # workload
    "workload_ok": "bool", "workload_devices": "int", "workload_losses": ["number"],
    "workload_step_ms": "number", "ring_attention_ok": "bool", "pipeline_ok": "bool",
    "moe_ok": "bool",
    # attached by the aggregator
    "kind_mismatch": {"__keys__": {
        "label": ("str", "null"), "expected_generation": "str", "enumerated": ["str"],
        "enumerated_generations": ["str"],
    }},
}

REQUIRED_KEYS = ("ok", "level")


def _type_ok(value, name: str) -> bool:
    if name == "any":
        return True
    if name == "null":
        return value is None
    if name == "bool":
        return isinstance(value, bool)
    if name == "int":
        return isinstance(value, int) and not isinstance(value, bool)
    if name == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    return isinstance(value, str)


def _check(value, spec, path: str, out: List[str]) -> None:
    if isinstance(spec, str):
        spec = (spec,)
    if isinstance(spec, tuple):
        if any(isinstance(t, str) and _type_ok(value, t) for t in spec):
            return
        for t in spec:
            if isinstance(t, (dict, list)) and isinstance(value, Mapping if isinstance(t, dict) else list):
                _check(value, t, path, out)
                return
        out.append(f"{path}: expected {spec}, got {type(value).__name__}")
        return
    if isinstance(spec, list):
        if not isinstance(value, list):
            out.append(f"{path}: expected a list, got {type(value).__name__}")
            return
        for i, item in enumerate(value):
            _check(item, spec[0], f"{path}[{i}]", out)
        return
    if not isinstance(value, Mapping):
        out.append(f"{path}: expected an object, got {type(value).__name__}")
        return
    known, rest = spec.get("__keys__", {}), spec.get("__values__")
    for k, v in value.items():
        if not isinstance(k, str):
            out.append(f"{path}: non-string key {k!r}")
        elif k in known:
            _check(v, known[k], f"{path}.{k}", out)
        elif rest is not None:
            _check(v, rest, f"{path}.{k}", out)


def violations(doc) -> List[str]:
    """Each way ``doc`` departs from the schema, naming the field; [] if none."""
    if not isinstance(doc, Mapping):
        return [f"report: expected an object, got {type(doc).__name__}"]
    out = [f"{key}: required key missing" for key in REQUIRED_KEYS if key not in doc]
    for key, value in doc.items():
        if key in REPORT_SPEC:
            _check(value, REPORT_SPEC[key], key, out)
    return out
