"""``--selftest``: prove this host's fault detection before it emits.

The emitter DaemonSet runs it as an initContainer
(``deploy/daemonset-emitter.yaml``): a host whose monitoring cannot prove
itself never starts emitting.  A copy of the JAX checker's ``selftest``
(``checker.py``), with the port's probe on the caller's ``--device``: one
clean baseline probe, then one injected fault per detector class, each
verified to be caught and correctly named:

* ``throttle``: a 20x slowdown fails the perf floor naming
  ``matmul_tflops``, graded against this host's own baseline figure, so it
  works on any card;
* ``collective_leg``: a corrupted all_gather fails that leg only (2+ cards);
* ``ring_link``: a corrupted link is named ``0->1`` (2+ cards);
* ``dcn``: a fault on a rehearsed slice boundary localizes to the ``dcn``
  axis alone (an even count of 4+ cards).

Exit 0 when every leg behaved; 3 when a detector missed or misnamed its
fault, or the baseline itself is unhealthy.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import List, Optional

from tpu_node_checker_torch.probe.floors import calibrate_expectations
from tpu_node_checker_torch.probe.liveness import run_local_probe

EXIT_OK = 0
EXIT_NONE_READY = 3


@contextmanager
def _env(**overrides):
    """Each leg runs with a clean probe environment: every ``TNC_*`` knob
    (a stale chaos variable from a manual rehearsal, a forced topology, a
    soak, a regrading floor) is cleared, and the leg's own overrides set.
    ``TNC_SKIP_*`` survives: it routes around a known toolchain fault on a
    healthy host, and clearing it would fail the baseline for a reason that
    is not a detector's."""
    cleared = [k for k in os.environ if k.startswith("TNC_") and not k.startswith("TNC_SKIP_")]
    old = {k: os.environ[k] for k in cleared}
    old.update({k: os.environ.get(k) for k in overrides})
    for k in cleared:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in overrides.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def selftest(timeout_s: Optional[float] = None, device: str = "cuda:0",
             json_mode: bool = False) -> int:
    """Run the drill and print its verdicts (a JSON document with
    ``json_mode``); returns the exit code.  ``timeout_s`` is each leg's
    probe timeout (None: the level's budget)."""
    results: List[dict] = []

    def _leg(name, expectation, check, level, **env):
        with _env(**env):
            r = run_local_probe(level=level, timeout_s=timeout_s, device=device)
        d = r.to_dict()
        try:
            behaved, detail = check(r, d)
        except Exception as exc:  # tnc: allow-broad-except(a broken check is a failure)
            behaved, detail = False, f"verification crashed: {exc}"
        results.append(
            {"leg": name, "expectation": expectation, "behaved": bool(behaved), "detail": detail}
        )
        return r

    # Baseline: the drill is meaningless on a host that is actually sick.
    base = _leg(
        "baseline",
        "clean compute probe passes",
        lambda r, d: (r.ok, d.get("error") or f"{r.device_count} device(s) ok"),
        level="compute",
    )
    n_dev = base.device_count
    # Graded against this host's own healthy figure through the path
    # --calibrate uses (one sample); its filter (numeric, finite, positive)
    # is also the leg's gate, so a garbage baseline figure skips the leg.
    expect = calibrate_expectations([base.to_dict()]) if base.ok else {}
    measured = expect.get("matmul_tflops")

    if base.ok and measured:
        # Only the injected metric is expected, so another metric's jitter
        # cannot fail this leg.
        _leg(
            "throttle",
            "20x slowdown fails the perf floor naming matmul_tflops",
            lambda r, d: (
                not r.ok
                and d.get("perf_floor", {}).get("failed") == ["matmul_tflops"]
                and d.get("chaos_injected", {}).get("throttle") == "matmul_tflops",
                d.get("error") or "not caught",
            ),
            level="compute",
            TNC_CHAOS_THROTTLE="matmul_tflops",
            TNC_PERF_EXPECT=json.dumps({"matmul_tflops": measured}),
        )
    if base.ok and n_dev >= 2:
        _leg(
            "collective_leg",
            "corrupted all_gather fails that leg, and only that leg",
            lambda r, d: (
                not r.ok
                # A projection: the block also carries per-leg timings.
                and {
                    k: (d.get("collective_legs_ok") or {}).get(k)
                    for k in ("psum_ok", "all_gather_ok", "reduce_scatter_ok")
                }
                == {"psum_ok": True, "all_gather_ok": False, "reduce_scatter_ok": True},
                d.get("collective_err") or d.get("error") or "not caught",
            ),
            level="collective",
            TNC_CHAOS_COLLECTIVE_LEG="all_gather",
        )
        _leg(
            "ring_link",
            "corrupted ICI link is named 0->1",
            lambda r, d: (
                not r.ok and d.get("ring_bad_links") == ["0->1"],
                f"named {d.get('ring_bad_links')}" if d.get("ring_bad_links")
                else (d.get("error") or "not caught"),
            ),
            level="collective",
            TNC_CHAOS_RING_LINK="0",
        )
    if base.ok and n_dev >= 4 and n_dev % 2 == 0:
        _leg(
            "dcn",
            "slice-boundary fault localizes to the dcn axis only",
            lambda r, d: (
                not r.ok
                and d.get("fault_domain_ok", {}).get("dcn") is False
                and all(v for k, v in d.get("fault_domain_ok", {}).items() if k != "dcn"),
                f"domains {d.get('fault_domain_ok')}",
            ),
            level="collective",
            TNC_CHAOS_SLICES="2",
            TNC_CHAOS_AXIS="dcn",
        )

    all_behaved = bool(results) and all(x["behaved"] for x in results)
    skipped = []
    if not (isinstance(measured, (int, float)) and measured > 0):
        skipped.append("throttle (no baseline matmul figure)")
    if n_dev < 2:
        skipped.append("collective_leg, ring_link (single device)")
    if not (n_dev >= 4 and n_dev % 2 == 0):
        skipped.append("dcn (needs >=4 devices, even count)")
    if json_mode:
        print(json.dumps(
            {
                "selftest": results,
                "skipped_legs": skipped,
                "all_behaved": all_behaved,
                "exit_code": EXIT_OK if all_behaved else EXIT_NONE_READY,
            },
            ensure_ascii=False, indent=2,
        ))
    else:
        for x in results:
            mark = "✅" if x["behaved"] else "❌"
            print(f"{mark} {x['leg']}: {x['expectation']} — {x['detail']}")
        for s in skipped:
            print(f"⏭️  skipped: {s}")
        verdict = (
            "every injected fault was caught and correctly named"
            if all_behaved
            else "FAULT-DETECTION DRILL FAILED — verdicts from this host "
            "cannot be trusted until investigated"
        )
        print(f"\nSelf-test: {verdict}.")
    return EXIT_OK if all_behaved else EXIT_NONE_READY
