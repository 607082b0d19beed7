"""The probe report's formal schema — docs/PROBE.md's key tables as code.

This package's copy of the JAX package's module of the same name: the port
imports nothing of the JAX package, so it keeps its own.  Keep the two in
step; tests/test_torch_probe.py holds them equal.

Round-4 verdict missing #4: emitter/aggregator skew was guarded by an int
(``schema: 1``) but nothing checked *types*, so a field-type drift inside
the same major version (a ``ring_bad_links`` that became a string, a
``matmul_tflops`` serialized as text) passed silently into grading and
metrics.  This module is the machine-checkable contract:

* :data:`REPORT_SPEC` — per-key type specs for every key the probe child
  can emit (plus the aggregator's synthesized ``missing`` reports);
* :func:`validate_report` — dependency-free validation returning violation
  strings that NAME the offending field (never raising on garbage input);
* :func:`as_json_schema` — the same contract rendered as a standard JSON
  Schema (draft 2020-12) document for external consumers (CI pipelines
  reading ``--emit-probe`` output, report tooling in other languages).

Unknown keys are always allowed: minor additions must flow through an
aggregator one version behind (same forward-compatibility stance as the
``schema`` int — majors gate, minors ride).

The emitter validates its own report before writing (a warning on stderr;
``TNC_SCHEMA_STRICT=1`` — set by the test suite — upgrades it to an error)
and the aggregator validates behind the version gate, refusing drifted
reports under the existing ``schema`` skip counter.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple, Union

# ---- compact type-spec DSL -------------------------------------------------
# "bool" | "int" | "number" | "str"          scalar JSON types (number ⊇ int)
# ("number", "null")                         any of (null = JSON null)
# ["str"]                                    list with items of the given spec
# {"__keys__": {...}, "__values__": spec}    object: known keys typed, unknown
#                                            keys allowed (checked against
#                                            __values__ when given)
# "any"                                      explicitly unchecked

Spec = Union[str, Tuple[str, ...], list, dict]

_NUM = ("number",)
_NUM_OR_NULL = ("number", "null")

_MEMORY_ENTRY: dict = {
    "__keys__": {
        "id": "any",  # PJRT device id — int today, but vendor-shaped
        "bytes_in_use": ("int", "null"),
        "bytes_limit": ("int", "null"),
    }
}

_HBM_CAPACITY: dict = {
    "__keys__": {
        "skipped": "str",
        "generation": "str",
        "expected_gb": "number",
        "fraction": "number",
        "min_gb": "number",
        "failed_devices": [{"__keys__": {"id": "any", "gb": "number"}}],
        "ok": "bool",
    }
}

_PERF_FLOOR: dict = {
    "__keys__": {
        "skipped": "str",
        "generation": "str",
        "fraction": "number",
        "expected": {"__values__": "number"},
        "measured": {"__values__": "number"},
        "ratios": {"__values__": "number"},
        "failed": ["str"],
        "throttled": ["str"],
        "ok": "bool",
    }
}

_SOAK: dict = {
    "__keys__": {
        "ok": "bool",
        "rounds": "int",
        "seconds": "number",
        "tflops_min": "number",
        "tflops_median": "number",
        "tflops_max": "number",
        "sustained_ratio": "number",
        "hbm_gbps_min": "number",
        "hbm_gbps_median": "number",
        "error": "str",
    }
}

# Every key the probe child can emit (probe/liveness.py in either package),
# by contract area.  docs/PROBE.md is the prose twin of this table.
REPORT_SPEC: dict = {
    # -- envelope (emitted reports add schema/written_at; the aggregator's
    #    synthesized reports for unreported hosts use level="missing")
    "ok": "bool",
    "level": "str",
    "hostname": "str",
    "elapsed_ms": "number",
    # The probe child omits error when clean, but an explicit null is the
    # natural JSON spelling of "no error" — both are accepted.
    "error": ("str", "null"),
    "schema": "int",
    "written_at": "number",
    # -- enumerate
    "platform": ("str", "null"),
    "device_count": "int",
    "local_device_count": "int",
    "device_kinds": ["str"],
    "process_index": "int",
    "process_count": "int",
    "distributed": "bool",
    "distributed_psum": "number",
    "distributed_psum_ok": "bool",
    "num_slices": "int",
    "slice_indices": ["int"],
    "memory": [_MEMORY_ENTRY],
    "hbm_capacity": _HBM_CAPACITY,
    # -- compute
    "matmul_ok": "bool",
    "matmul_tflops": "number",
    "hbm_ok": "bool",
    "hbm_gbps": "number",
    "pallas_ok": "bool",
    "int8_ok": "bool",
    "int8_tops": "number",
    "int8_err": "str",
    "int8_skipped": "bool",
    "flash_attention_ok": "bool",
    "flash_attention_skipped": "bool",
    "flash_attention_err": "str",
    "flash_attention_max_abs_err": "number",
    "dma_ok": "bool",
    "dma_gbps": "number",
    "memtest_ok": "bool",
    "memtest_err": "str",
    "memtest_mismatches": {"__values__": "int"},
    "dispatch_overhead_ms": "number",
    "soak": _SOAK,
    "perf_floor": _PERF_FLOOR,
    # -- collective
    "collective_ok": "bool",
    "collective_latency_us": "number",
    "collective_busbw_gbps": _NUM_OR_NULL,
    "ring_ok": "bool",
    "ring_link_gbps": _NUM_OR_NULL,
    "ring_bad_links": ["str"],
    "ring_err": "str",
    # Verdict values are bool OR null: a collective probe that CRASHED
    # before producing per-leg verdicts emits {psum_ok: None, ...}
    # ((coll.details or {}).get(k) in liveness.py) — that failed-probe
    # report must still attach and degrade the host, not be refused as a
    # schema violation (which would silently grade the host HEALTHY).
    # The block additionally carries per-leg timings (the collective-level
    # backfill) and, at mesh level, the per-link "links" sub-block from the
    # mesh link doctor; unknown keys stay on the old bool|null contract.
    "collective_legs_ok": {
        "__keys__": {
            "psum_ok": ("bool", "null"),
            "all_gather_ok": ("bool", "null"),
            "reduce_scatter_ok": ("bool", "null"),
            "psum_latency_us": _NUM_OR_NULL,
            "all_gather_latency_us": _NUM_OR_NULL,
            "reduce_scatter_latency_us": _NUM_OR_NULL,
            "links": {
                "__values__": {
                    "__keys__": {
                        "verdict": "str",
                        "p50_us": "number",
                        "p99_us": "number",
                        "budget_us": "number",
                    }
                }
            },
        },
        "__values__": ("bool", "null"),
    },
    "collective_err": "str",
    # -- mesh (link doctor): SLOW legs degrade without failing; only a
    # DEAD leg (or a sweep crash) turns mesh_ok False.
    "mesh_ok": "bool",
    "mesh_degraded": "bool",
    "mesh_n_links": "int",
    "mesh_latency_us": "number",
    "mesh_slow_links": ["str"],
    "mesh_dead_links": ["str"],
    "mesh_err": "str",
    "chaos_injected": {"__values__": "str"},
    # The per-axis legs emit null for verdict/topology when the leg itself
    # crashed before producing one ((ax.details or {}).get(...) in
    # liveness.py) — such failed-probe reports must still attach and
    # degrade the host, not be refused as drifted.
    "ici_topology": ("str", "null"),
    "ici_axis_ok": ({"__values__": "bool"}, "null"),
    "ici_axis_busbw_gbps": {"__values__": _NUM_OR_NULL},
    "axis_busbw_err": {"__values__": "str"},
    "fault_domain_ok": ({"__values__": "bool"}, "null"),
    "fault_domain_topology": ("str", "null"),
    "fault_domain_busbw_gbps": {"__values__": _NUM_OR_NULL},
    "dcn_busbw_gbps": _NUM_OR_NULL,
    "dcn_err": "str",
    # -- workload
    "workload_ok": "bool",
    "workload_devices": "int",
    "workload_losses": ["number"],
    "workload_step_ms": "number",
    "ring_attention_ok": "bool",
    "pipeline_ok": "bool",
    "moe_ok": "bool",
    # -- attached by the aggregator (label vs enumerated-kind cross-check)
    "kind_mismatch": {
        "__keys__": {
            "label": ("str", "null"),
            "expected_generation": "str",
            "enumerated": ["str"],
            "enumerated_generations": ["str"],
        }
    },
}

# The envelope every report must carry; everything else accumulates by level.
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
    if name == "str":
        return isinstance(value, str)
    raise AssertionError(f"unknown spec type {name!r}")  # pragma: no cover


def _describe(spec: Spec) -> str:
    if isinstance(spec, str):
        return spec
    if isinstance(spec, tuple):
        return " or ".join(_describe(t) for t in spec)
    if isinstance(spec, list):
        return f"list of {_describe(spec[0])}"
    return "object"


def _check(value, spec: Spec, path: str, out: List[str]) -> None:
    if isinstance(spec, str):
        spec = (spec,)
    if isinstance(spec, tuple):
        # anyOf: scalar names check directly.  A value whose container KIND
        # matches a nested alternative delegates into it, so violations
        # keep naming the inner field (ici_axis_ok.t0, not ici_axis_ok).
        for t in spec:
            if isinstance(t, str) and _type_ok(value, t):
                return
        for t in spec:
            if isinstance(t, dict) and isinstance(value, Mapping):
                _check(value, t, path, out)
                return
            if isinstance(t, list) and isinstance(value, list):
                _check(value, t, path, out)
                return
        out.append(
            f"{path}: expected {_describe(spec)}, got {type(value).__name__}"
        )
        return
    if isinstance(spec, list):
        if not isinstance(value, list):
            out.append(f"{path}: expected {_describe(spec)}, got {type(value).__name__}")
            return
        for i, item in enumerate(value):
            _check(item, spec[0], f"{path}[{i}]", out)
        return
    # dict spec: known keys by name, unknown keys optionally by __values__
    if not isinstance(value, Mapping):
        out.append(f"{path}: expected object, got {type(value).__name__}")
        return
    known = spec.get("__keys__", {})
    values_spec = spec.get("__values__")
    for k, v in value.items():
        if not isinstance(k, str):
            out.append(f"{path}: non-string key {k!r}")
            continue
        if k in known:
            _check(v, known[k], f"{path}.{k}", out)
        elif values_spec is not None:
            _check(v, values_spec, f"{path}.{k}", out)
        # unknown keys with no __values__ spec: allowed, unchecked


def validate_report(doc) -> List[str]:
    """Violations (each naming its field) for one probe-report dict.

    Empty list = conforming.  Never raises: the caller decides whether a
    drifted report is a warning (emitter debug) or a refusal (aggregator).
    Unknown top-level keys are allowed — minor, forward-compatible
    additions must not fail an older aggregator.
    """
    if not isinstance(doc, Mapping):
        return [f"report: expected object, got {type(doc).__name__}"]
    out: List[str] = []
    for key in REQUIRED_KEYS:
        if key not in doc:
            out.append(f"{key}: required key missing")
    for key, value in doc.items():
        if not isinstance(key, str):
            out.append(f"report: non-string key {key!r}")
            continue
        spec = REPORT_SPEC.get(key)
        if spec is not None:
            _check(value, spec, key, out)
    return out


def _spec_to_json_schema(spec: Spec) -> dict:
    if isinstance(spec, str):
        spec = (spec,)
    if isinstance(spec, tuple):
        types = [
            {"any": {}, "null": {"type": "null"}, "bool": {"type": "boolean"},
             "int": {"type": "integer"}, "number": {"type": "number"},
             "str": {"type": "string"}}[t]
            if isinstance(t, str)
            else _spec_to_json_schema(t)
            for t in spec
        ]
        return types[0] if len(types) == 1 else {"anyOf": types}
    if isinstance(spec, list):
        return {"type": "array", "items": _spec_to_json_schema(spec[0])}
    schema: dict = {"type": "object"}
    if spec.get("__keys__"):
        schema["properties"] = {
            k: _spec_to_json_schema(v) for k, v in spec["__keys__"].items()
        }
    if spec.get("__values__") is not None:
        schema["additionalProperties"] = _spec_to_json_schema(spec["__values__"])
    return schema


def as_json_schema() -> dict:
    """The contract as a standard JSON Schema (draft 2020-12) document."""
    return {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "$id": "https://tpu-node-checker.io/probe-report.schema.json",
        "title": "tpu-node-checker probe report",
        "description": (
            "One JSON object per probed host (docs/PROBE.md). Keys "
            "accumulate by probe level; unknown keys are forward-compatible "
            "minor additions."
        ),
        "type": "object",
        "required": list(REQUIRED_KEYS),
        "properties": {
            k: _spec_to_json_schema(v) for k, v in REPORT_SPEC.items()
        },
        "additionalProperties": True,
    }


def strict_mode() -> bool:
    """``TNC_SCHEMA_STRICT=1`` upgrades emitter-side warnings to errors —
    the test suite sets it so any report our own code emits is hard-checked.
    ``0``/``false``/empty explicitly select the warn-only production
    behavior (an exported =0 must not flip a DaemonSet into crash-on-lag)."""
    import os

    return os.environ.get("TNC_SCHEMA_STRICT", "").strip().lower() not in (
        "", "0", "false", "no",
    )
