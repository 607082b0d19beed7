#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA probe on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):

1. environment: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: every kernel under ``tpu_node_checker_torch/ops/csrc/`` with nvcc,
   one process per source, all at once;
3. kernels: each kernel at the shapes the compute probe gives it, held against
   its plain PyTorch version on the card, and timed beside its plain version,
   one PyTorch library call computing the same function, and the card's bound,
   with the device time of the kernel and of the library call side by side
   (the int8 chain at the probe's 1024^3 x 128 products, bit-equal to its
   plain chain of rolls, ``torch._int_mm`` products and adds; its library
   form is that chain with the right operand column-major, the layout
   cuBLAS runs fastest, with its share of the bound; the burn chain's
   product at n = 2048, each of the kernel, its plain three-kernel version
   and one ``torch.addmm`` into bf16 timed as a graph of 1,024 products,
   with its share of the bound and the card's SM clock and power);
   then the tiled matmul at 4096^3 (each tile it is built for) and flash
   attention at (1, 16, 4096, 128) (each query row held to its own size,
   the limit shown to catch a dropped K/V tile), each held against its plain
   version, with its share of the bound;
4. main path: the compute-level probe through its entry point
   (``python -m tpu_node_checker_torch --emit-probe - --probe-level compute``),
   which must report healthy, validate against the report schema and show
   every kernel launched; then the compute probes in this process, with
   every kernel's launch count;
5. workload path: in this process, at the full ``BurninConfig()``, the flash
   kernel against its plain version at the training step's shape
   (8, 4, 128, 32) bf16, one training step with ``attention="flash"``
   against the same step with ``attention="xla"`` from the same weights
   (the loss and every gradient), the step's time, and the flash forward's
   device time beside the plain backward's; then the level's blocks over a
   rank group (one rank per card), each timed, in this process and in a
   fresh one; then the workload-level probe through its entry point
   (``--probe-level workload``), which must report healthy with every
   fabric and workload verdict true, a strictly falling loss, and the flash
   kernel launched ``n_layers × steps`` more times than at the compute
   level;
6. multi-axis paths on one card: TF32 off for f32 products by default (the
   flags, and a 1024^2 f32 product against f64, both read at the script's
   start before it sets anything); ``TNC_TOPOLOGY=1x1 --probe-level
   workload`` through the entry point, healthy with ``ici_axis_ok`` true on
   both torus axes and every kernel launched; ``TNC_TOPOLOGY=1x1
   TNC_CHAOS_AXIS=t1 --probe-level collective``, which must exit 3 naming
   t1 alone; then in a one-rank NCCL group the sharded step at data 1 ×
   model 1 against the one-card step from the same weights, the pipeline
   and MoE probes and their stage-0 and expert-0 drills, each timed;
7. emitter: the node side as it is deployed, each line a subprocess.  The
   DaemonSet's ``--emit-probe DIR/$NODE_NAME.json --probe-level compute
   --watch 5 --metrics-port 0 --log-jsonl L``, sent SIGTERM 2 s after its
   second report, in its third round (every round healthy, logged and
   launching every kernel; each round's time, the gap between round
   starts and the seconds from SIGTERM to exit printed), its ``/metrics``
   scraped on the port its stderr line names after the first and the
   second report (the probe gauges equal to that round's report, the exit
   code 0, the timestamp inside the round's window and moving forward, a
   304 for the first scrape's ETag, gzip decoding to the same body, HEAD
   with no body, 404 off the route; each check and each scrape's time
   printed); its livenessProbe
   ``--report-fresh`` (0, and 1 with
   ``--probe-results-max-age 0.001``); the aggregator, the JAX checker's
   CLI ``--nodes-json N --probe-results DIR --json`` over a one-node
   NodeList written here, which must grade that report healthy (exit 0)
   and a ``--probe-topology 1x1`` drill report under ``TNC_CHAOS_AXIS=t1``
   failed (exit 3, the node named); and the acceptance Job's
   ``--emit-probe - --probe-level compute --probe-soak 20 --perf-floor
   0.4`` (healthy, its soak and floor verdicts printed, with the card's
   clock and power sampled meanwhile), after the soak's rounds in-process
   on an idle host and on one kept busy by a spinning process per core;
8. operator modes, each line a subprocess of the port's CLI that also
   records each probe child's seconds and report: the initContainer's
   ``--selftest --json --probe-timeout 600`` (exit 0, ``baseline`` and
   ``throttle`` behaved, the single-card legs skipped, every kernel
   launched in each leg); ``--calibrate 3 --probe-level compute`` (exit 0,
   each expectation 0.9 × the median of the reps it printed); with that
   JSON as ``TNC_PERF_EXPECT``, ``--emit-probe - --probe-level compute
   --perf-floor 0.4`` on an idle host and on a busy one (healthy, graded
   ``custom``, every ratio printed); and the same line under
   ``TNC_CHAOS_THROTTLE=int8_tops`` (exit 3 naming ``int8_tops`` alone);
9. distributed probing on one card, each line the port's CLI as a host's
   emitter runs it: ``--emit-probe - --probe-level workload
   --probe-distributed`` with a rendezvous of one process on a free local
   port (exit 0, schema-valid, ``distributed`` true, ``process_count`` 1,
   no psum key, every kernel launched, the rendezvous seconds printed);
   process 0 of 2 alone and process 1 of 2 with nothing listening, each with
   ``--probe-rendezvous-timeout 5`` (exit 3 naming the coordinator, inside
   the kill-timer, no process of theirs left); then two distributed rounds
   in a row on one port, both healthy;
10. the one-shot fleet round, each line a subprocess of the port's CLI
   over a NodeList written here (this host as a Ready ``nvidia.com/gpu``
   node under a fixed ``NODE_NAME``, a CPU node, a NotReady GPU node):
   ``--nodes-json N --probe --probe-level workload --json`` (exit 0, the
   probe healthy and attached to this host's node, every kernel launched as
   often as on the workload path), the same round in text mode (its table
   and "Local chip probe" line printed); this host's allocatable one card
   more than it has (exit 3, "only n/n+1 expected devices enumerated");
   ``--probe-results`` over the port emitter's reports (this host healthy, a
   ``TNC_CHAOS_AXIS=t1`` drill of the NotReady node, a stale report, a
   schema-broken one), with and without ``--probe-results-required``, beside
   the unchanged JAX checker's CLI on the same inputs (equal exit codes and
   payloads less ``trace_id`` and ``timings_ms``); ``--history
   --cordon-after 2`` over three rounds (healthy, drill, drill: HEALTHY →
   SUSPECT → FAILED on both sides, equal payloads) and one ``--emit-probe
   --history --log-jsonl`` round whose line carries its ``state``; and
   ``--slack-only-on-error`` to a loopback webhook, which must get one post
   from each CLI, on the failing round, with equal bodies;
11. the live round, each line a subprocess of a CLI against a fake API
   server this script serves from a thread (``/api/v1/nodes`` paged by
   ``limit``/``continue`` and filtered by ``labelSelector``,
   ``/api/v1/events`` by ``fieldSelector``) with a NodeList of 2,500 nodes
   (this host Ready with its cards, 999 other ``nvidia.com/gpu`` nodes of
   which 10 are NotReady with Warning events, 1,500 CPU nodes: three pages
   at the client's limit of 1,000): ``--kubeconfig K --probe --probe-level
   workload --node-events --strict-slices --json`` through the port (exit 0,
   the probe healthy, schema-valid and attached to this host's node, its
   launches equal to the workload path's, events on the 8 sick nodes the cap
   allows and the 2 omitted named on stderr, 3 list pages and 8 events walks
   sent, the round's ``timings_ms`` printed); the CronJob's own argv
   (``--strict-slices --slack-only-on-error --json``) with ``--kubeconfig``,
   in JSON and in text and with ``--label-selector``, through the port and
   through the JAX checker's CLI (equal exit codes, equal payloads less
   ``trace_id`` and ``timings_ms``, equal text); a 429 with ``Retry-After:
   1`` on the first list request (equal exit codes and
   ``retries_by_reason``); a closed port under ``--retry-budget 2`` (both
   exit 1 with equal ``{"error": ...}``, the seconds printed); and the
   CronJob's round over TLS with ``certificate-authority-data`` where
   ``openssl`` can make a certificate;
12. the aggregator Deployment's ``--watch`` loop, each run a subprocess
   of a CLI (through ``WATCH_CLI_SCRIPT``, which records each round's check
   and wait) against a fake API server serving 1,000 GPU nodes, whose
   scripted answers change between rounds: ``--kubeconfig K --watch 1
   --probe --probe-level workload --strict-slices --probe-results DIR
   --probe-results-required --slack-on-change --metrics-port 0 --log-jsonl
   L --history H --cordon-after 2 --uncordon-after 3 --event-log E
   --retry-budget 0`` with Slack to a loopback webhook, over a history in
   which one node already FAILED: a healthy round, the same, a same-code
   node swap, four rounds answered 500 (the breaker opens at the third),
   the healed rounds, SIGTERM as the ninth round starts (exit 143 after
   it); each probed round launching every kernel as the workload path does,
   with the kernels' compares true; the waits 0 after a probed round and 1,
   1, 2, 4 s after the failures; seven posts; the breaker and
   state-machine events with their rounds' ``trace_id``; the stderr lines;
   ``/metrics`` after the second round and with the breaker open; then the
   same script without the probe through the port and through the JAX
   checker's CLI (equal exit codes, posts, log keys and events, each
   loading no package but its own);
13. the aggregator's quarantine on this card's reports: the port's emitter
   writes, four at once, this host's healthy report (compute level), its
   ``TNC_CHAOS_AXIS=t1`` drill (``--probe-topology 1x1 --probe-level
   collective``) and the drills of three other GPU nodes (each exit 0 or 3,
   schema-valid, every kernel launched and equal to its plain version);
   then the Deployment's loop (``--watch 1 --strict-slices --probe-results
   DIR --probe-results-required --slack-on-change --metrics-port 0
   --log-jsonl L --history H --cordon-after 2 --uncordon-after 3
   --disruption-budget 2/10m --slice-floor-pct 90 --disruption-lease URL
   --cordon-failed --uncordon-recovered --event-log E``) against the fake
   API server of 1,000 GPU nodes, which applies each PATCH to the next
   LIST, and a lease server here over the port's ``FleetLeaseBudget`` (one
   actuation per 10 minutes): round 1 healthy, rounds 2-3 the drills (one
   cordon PATCH of this host at round 3, the storm denied by
   ``--cordon-max`` in one Slack post, one lease granted), rounds 4-6
   healthy (one uncordon PATCH after round 6), rounds 7-8 the storm alone
   with the lease server stopped before round 8 (the fallback grants
   nothing: the last lease left 0), SIGTERM as round 9 starts; the same
   rounds through the JAX checker's CLI (equal exit codes, PATCH bodies,
   ``cordon``/``uncordon``/``remediation`` blocks, posts, event lines,
   lease requests and ``tpu_node_checker_remediation_*`` scrape lines, each
   CLI loading no package but its own); and ``--trend`` and
   ``--trend-nodes``, text and ``--json``, through both CLIs on the port's
   log and store (equal output);
14. the aggregator Deployment as written, on phase 13's healthy and drill
   reports of this host: ``--watch 1 --strict-slices --probe-results DIR
   --probe-results-required --slack-on-change --metrics-port 0 --log-jsonl
   L --history H --cordon-after 2 --uncordon-after 3 --disruption-budget
   2/10m --slice-floor-pct 90 --disruption-lease URL --cordon-failed
   --uncordon-recovered --serve 0 --serve-workers 2 --write-rps 5
   --event-log E --analytics A`` with ``TNC_SERVE_TOKEN`` set, against the
   fake API server of 1,000 GPU nodes and a lease server, through the port
   and through the JAX checker's CLI, each held before every round (the
   wall clock it reads pinned: one second a round): this host healthy,
   drill, healthy, drill, healthy, healthy, SIGTERM as round 7 starts (exit
   143, the fleet API closed); ``/readyz`` 503 before round 1 and 200
   after, ``/healthz`` 200; after each round every route of the fleet API
   (summary, nodes, this node, slices, trend, remediation, the three
   analytics documents, debug rounds, the watch feed, ``/metrics``, a 404),
   ``X-TNC-Round`` moving forward, the node carrying its round's report
   and state, a 304, gzip and HEAD; after round 1 the writes (401 without
   the token or with a wrong one, then 5 dry-run answers and 429s with
   ``Retry-After``); the one ``analytics-prediction`` at round 4; the
   PATCHes with their rounds; 200 GETs of the nodes collection and 200 of
   its 304, the publish span of each round and the ``analytics-query``
   phase, timed; equal to the JAX checker's (exit codes, PATCH bodies,
   posts, events, lease requests, writes and every GET body, with the
   masks named at ``SERVE_MASKED_KEYS``), each CLI loading no package but
   its own; then ``--serve 0 --history H --log-jsonl L`` standalone through
   both CLIs over the port's store (equal bodies, ``/readyz`` 200, a write
   503 with the token and 401 without, SIGTERM exit 143);
15. the federation tier above two clusters, one of them graded on this
   card's reports: the port's emitter writes, at once, this host's healthy
   report (compute level) and its ``TNC_CHAOS_AXIS=t1`` drill
   (``--probe-topology 1x1 --probe-level collective``; exit 0 and 3, each
   schema-valid, every kernel launched and equal to its plain version);
   then three processes of a CLI, each held before every round with its
   wall clock pinned: cluster east, the Deployment's loop of phase 14 with
   ``--cluster-name east``, without ``--serve-token`` and ``--write-rps``
   and with its ``--disruption-lease`` on the aggregator, against the fake
   API server of 1,000 GPU nodes; cluster west, ``--watch 1
   --watch-stream --serve P --cluster-name west --history H --analytics
   A`` against a second fake API server (1,000 GPU nodes, a LIST with its
   ``resourceVersion`` and the node watch, ``WatchApi``); and the
   federation Deployment's aggregator, ``--federate E --serve P
   --federate-interval 1 --federate-workers 2 --serve-workers 2
   --fleet-disruption-budget 1/10m --event-log EV --trace T`` (the ports
   chosen ahead, since east's lease URL and the endpoints file name them,
   and west comes back on its own).  Six steps, after each of which every
   global route is read (summary, clusters, each cluster, nodes,
   analytics, an unknown cluster's 404, ``/readyz``, ``/healthz``, the
   federation families of ``/metrics``, the debug rounds, a 304 on the
   last ETag, gzip and HEAD) with the trace's upstream tracks: all
   healthy; east grades the drill while west's stream carries a flip,
   100 heartbeats, a deletion, an addition and a bookmark; east's second
   drill (FAILED, its cordon leased from the aggregator, a second lease
   in the window denied); west's stream ended (one relist, stream_end),
   then an in-band 410 (one relist, gone); west stopped (its shard alone
   stale, ``/readyz`` 200); west back (recovered, logged once).  Then the
   aggregator with ``--federate-feed`` over the same upstreams, its steady
   rounds counted at the upstreams (none) and its nodes blocks the poll
   aggregator's bytes; then SIGTERM to each (143).  The same through the
   JAX checker's CLI: equal exit codes, global bodies (with the masks
   named at ``FEDERATION_MASKED_KEYS``), lease answers, PATCH bodies,
   posts, event lines, west's tick payloads and watch stats, and the
   feed's bodies, each CLI loading no package but its own;
16. the ``simulate`` subcommand (the seeded chaos simulator, which
   writes its own probe reports and launches no kernel) through the port's
   CLI and the JAX checker's, cold processes four at a time, each with its
   own scratch directory and ephemeral ports: ``--list-scenarios``, every
   scenario at its defaults with ``--seed 7 --report json``,
   ``mass-cordon-storm`` and ``watch-loss-relist`` at 1,000 nodes a
   cluster, ``federated-world`` at 3 x 64, ``flap-storm`` at 64 (red, exit
   3), ``--fuzz --seeds 10 --seed 7``, ``--replay`` of each file in
   ``tests/sim_reproducers/``, ``python -m <package>.sim.analytics_smoke
   --seed 7``, and ``flap-storm`` (json and human) and ``federated-world``
   through ``python -m <package>`` itself (where a SIGPIPE death of either
   side, the entry point's SIG_DFL, is counted, not failed); equal stdout
   and exit code for each, each CLI loading no package but its own, with
   each CLI's seconds and the runs in which the port imported torch;
17. tnc-lint, the port's ``python -m tpu_node_checker_torch.analysis``
   (stdlib code that launches no kernel), in cold processes two at a
   time, each with its own scratch directory: the port's lint over the
   checkout (exit 0, no finding, JSON) and the JAX lint over it (exit 0);
   the port's lint over a copy of ``tests/analysis_fixtures/repo`` with its
   package renamed, against the JAX lint over the original, in human, JSON
   and SARIF form (exit 1 each, equal output once the package name is
   mapped back, timings masked); ``--changed-only --cache FILE`` on the
   port's copy, cold and then warm with one file touched, each equal to
   the full run; every port process loading no ``torch``, ``jax`` or JAX
   package; with each run's seconds and exit code beside the card's name
   and power limit;
18. the ``kernels`` line (each kernel at the compute probe's shapes, its
   launches counted on the workload path, in each emitter round, in each
   selftest leg, in each calibration rep, on the distributed workload path,
   in the one-shot round's probe, in the live round's, in each probed
   round of the loop, in each report the quarantine grades, in each
   report the Deployment grades and in each report east grades, flash
   also at the training step's shape), then the ``nvidia-smi`` line, then
   the result line.

Bounds use the H100 SXM data sheet: 3.35 TB/s of device memory, 989 TFLOP/s
bf16 and 1,979 TOPS int8 (dense) on the tensor cores.  Times are steady-state CUDA-event times over many
back-to-back launches, inputs warm in L2.
"""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import gzip
import http.client
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
REPS = 200
STARTUP_SCRIPT = """
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda").add_(1).item()
t2 = time.perf_counter()
a = torch.zeros((64, 64), dtype=torch.bfloat16, device="cuda")
torch.mm(a, a, out_dtype=torch.float32).sum().item()
t3 = time.perf_counter()
import tpu_node_checker_torch.ops
t4 = time.perf_counter()
import tpu_node_checker_torch.models, tpu_node_checker_torch.meshprobe
t5 = time.perf_counter()
print(json.dumps({"import_torch_s": t1 - t0, "cuda_context_s": t2 - t1,
                  "first_mm_s": t3 - t2, "import_port_s": t4 - t3,
                  "import_fabric_and_model_s": t5 - t4}))
"""

# The workload level's blocks in a fresh interpreter, each on the host clock:
# what they cost the probe child, which meets each of them cold.
FRESH_BLOCKS_SCRIPT = """
import dataclasses, json, time
t = [time.perf_counter()]
import torch
from tpu_node_checker_torch.meshprobe import mesh_link_sweep
from tpu_node_checker_torch.models.burnin import (
    BurninConfig, _loss, make_train_step, workload_probe)
from tpu_node_checker_torch.parallel import (
    RankGroup, collective_probe, fold, ring_attention_probe, ring_probe)
t.append(time.perf_counter())
torch.zeros(1, device="cuda").add_(1).item()
t.append(time.perf_counter())
group = RankGroup(1, "cuda", timeout_s=120)
group.start()
t.append(time.perf_counter())
ok = [fold(group.run(collective_probe)).ok]
t.append(time.perf_counter())
ok.append(fold(group.run(ring_probe)).ok)
t.append(time.perf_counter())
ok.append(fold(group.run(mesh_link_sweep)).ok)
t.append(time.perf_counter())
# The first training step of the process, in parts, then the probe itself.
cfg = dataclasses.replace(BurninConfig(), attention="flash")
_, init_fn = make_train_step(cfg)
model, opt = init_fn(0)
tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq)).cuda()
torch.cuda.synchronize()
t.append(time.perf_counter())
loss = _loss(model, tokens)
loss.item()
t.append(time.perf_counter())
loss.backward()
torch.cuda.synchronize()
t.append(time.perf_counter())
opt.step()
torch.cuda.synchronize()
t.append(time.perf_counter())
wl = workload_probe(cfg)
ok.append(wl.ok)
t.append(time.perf_counter())
ok.append(fold(group.run(ring_attention_probe, seq_per_device=16)).ok)
t.append(time.perf_counter())
group.close()
t.append(time.perf_counter())
names = ["imports", "cuda_context", "rank_group_start", "collective", "ring", "mesh",
         "model_init", "first_forward", "first_backward", "first_adam_step",
         "workload_probe_after", "ring_attention", "rank_group_close"]
print(json.dumps({"ok": all(ok), "workload_step_ms": wl.step_time_ms,
                  "seconds": {n: b - a for n, a, b in zip(names, t, t[1:])}}))
"""


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, default=str), flush=True)


def check_launches(path: str, launches: Optional[dict], expected: Optional[dict] = None) -> None:
    """Fail, naming ``path`` and the kernels, unless a report's
    ``kernel_launches`` shows every kernel launched and, for each kernel in
    ``expected``, launched that many times."""
    from tpu_node_checker_torch.ops import launch_counts

    launches = launches or {}
    missed = [name for name in launch_counts() if not launches.get(name)]
    unlike = {name: (launches.get(name), n) for name, n in (expected or {}).items()
              if launches.get(name) != n}
    if missed or unlike:
        fail(f"{path}: kernels never launched {missed}, launches (reported, expected) "
             f"unlike {unlike}")


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_turns(torch, kernel, plain, library) -> tuple:
    """(kernel_ms, plain_ms, library_ms), each the better of two turns taken
    in the order plain, kernel, library, library, kernel, plain."""
    order = [plain, kernel, library, library, kernel, plain]
    times = [cuda_ms(torch, f) for f in order]
    return min(times[1], times[4]), min(times[0], times[5]), min(times[2], times[3])


def device_ms(torch, fn, kernel_symbol=None, reps: int = 20, sessions: int = 3):
    """Device time per call of ``fn``, from torch.profiler's CUDA trace.

    With ``kernel_symbol``: the mean time of the kernels whose name holds it.
    Without: the sum of every kernel (and copy or fill) the call launches,
    per call, as for a library call that launches several.  Only the trace's
    device events count: the profiler also books each kernel's time on the
    CPU op that launched it, so summing those too would count it twice.
    A trace can come back without the kernel's events, so up to
    ``sessions`` traces are taken.  None when none holds such a kernel
    (the timed loops above then stand alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        picked = [
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and (kernel_symbol is None or kernel_symbol in e.key)
        ]
        total_us = sum(e.self_device_time_total for e in picked)
        calls = reps if kernel_symbol is None else sum(e.count for e in picked)
        if total_us and calls:
            return total_us / calls / 1e3
    return None


def bound(bytes_moved: float, flops: float, peak_flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_bound(m: int, k: int, n: int) -> tuple:
    """bf16 A and B read once, f32 C written once; 2mnk tensor-core operations."""
    return bound(2 * (m * k + k * n) + 4 * m * n, 2 * m * n * k, BF16_FLOPS)


def flash_bound(shape) -> tuple:
    """q, k, v read once and out written once in bf16; QK^T and PV over the
    causal lower triangle, diagonal included."""
    B, H, S, D = shape
    return bound(4 * B * H * S * D * 2, 4 * B * H * (S * (S + 1) // 2) * D, BF16_FLOPS)


def matmul_rel_err(out, ref) -> float:
    return float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item())


def row_rel_err(out, ref) -> float:
    """Max over query rows of max|out - ref| / rms(ref) along the row.

    Under a causal mask with random inputs, row n's output shrinks as
    1/sqrt(n), so an absolute limit that suits the first rows is blind to
    a fault in the late ones; each row is held to its own size here."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)).max().item())


def attention_dropping_keys(torch, q, k, v, k0: int, k1: int):
    """Causal attention in f32, output in q's dtype, with keys k0..k1-1
    dropped for every query row past them: a flash kernel that skips one
    K/V tile, as a planted fault for the check above to catch."""
    S, D = q.shape[-2:]
    s = (q.float() @ k.float().transpose(-1, -2)) * D ** -0.5
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] > i[:, None]) | (((i >= k0) & (i < k1))[None, :] & (i[:, None] >= k1))
    return (s.masked_fill_(mask, -1e30).softmax(-1) @ v.float()).to(q.dtype)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def entry_point(root: str, level: str, timeout: int = 900, **env) -> tuple:
    """``--emit-probe - --probe-level level`` under ``env`` (schema strict):
    (exit code, report, seconds).  Fails when no report comes back."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", level],
        capture_output=True, text=True, cwd=root, timeout=timeout,
        env={**os.environ, **env, "TNC_SCHEMA_STRICT": "1"},
    )
    seconds = time.perf_counter() - t0
    try:
        return proc.returncode, json.loads(proc.stdout), seconds
    except json.JSONDecodeError:
        fail(f"{level} {env} printed no report (exit {proc.returncode}): {proc.stderr[-2000:]}")


def phase6_paths(torch, root, dev, cfg, rows, tf32_default, validate_report) -> None:
    """Phase 6: a two-axis topology label, its per-axis drill, and the
    workload level's multi-card blocks in a one-rank NCCL group."""
    from tpu_node_checker_torch.models.burnin import train_steps
    from tpu_node_checker_torch.parallel import (
        MeshSpec, RankGroup, fold, moe_probe, pipeline_probe,
    )

    # TF32 off for f32 products by default, as the probe child runs them:
    # the flags and the product error main() read before it set anything.
    tf32_off = (not tf32_default["cuda.matmul.allow_tf32"]
                and tf32_default["float32_matmul_precision"] == "highest"
                and tf32_default["f32_product_rel_err"] < 1e-5)
    phase(6, "tf32", off=tf32_off, default=tf32_default)
    if not tf32_off:
        fail(f"TF32 is on for f32 products by default: {tf32_default}")

    # A 1x1 label on one card: both torus axes, one all_reduce each, through
    # the entry point at the workload level; the counts start at 0 in the
    # fresh child and are read from its report.
    rc, rep, seconds = entry_point(root, "workload", TNC_TOPOLOGY="1x1")
    launches = rep.get("kernel_launches") or {}
    fields = {k: rep.get(k) for k in (
        "ok", "error", "ici_axis_ok", "ici_topology", "ici_axis_busbw_gbps", "collective_ok",
        "ring_ok", "mesh_ok", "mesh_n_links", "workload_ok", "workload_devices",
        "workload_losses", "ring_attention_ok", "pipeline_ok", "moe_ok")}
    violations = validate_report(rep)
    phase(6, "workload path, TNC_TOPOLOGY=1x1", exit_code=rc, seconds=round(seconds, 2),
          **fields, kernel_launches=launches, schema_violations=violations)
    if rc != 0 or not rep.get("ok") or violations:
        fail(f"the 1x1 workload level is not healthy: {rep.get('error')} {violations}")
    if rep.get("ici_axis_ok") != {"t0": True, "t1": True} or rep.get("ici_topology") != "1x1":
        fail(f"the 1x1 per-axis block read {rep.get('ici_axis_ok')} on {rep.get('ici_topology')}")
    check_launches("the 1x1 workload path", launches)

    rc, rep, seconds = entry_point(root, "collective", TNC_TOPOLOGY="1x1", TNC_CHAOS_AXIS="t1")
    violations = validate_report(rep)
    phase(6, "drill TNC_CHAOS_AXIS=t1 on 1x1", exit_code=rc, seconds=round(seconds, 2),
          ok=rep.get("ok"), error=rep.get("error"), ici_axis_ok=rep.get("ici_axis_ok"),
          chaos_injected=rep.get("chaos_injected"), schema_violations=violations)
    if (rc != 3 or violations or rep.get("ici_axis_ok") != {"t0": True, "t1": False}
            or "fault localized to mesh axis t1=1" not in (rep.get("error") or "")):
        fail(f"the t1 drill was not caught and named t1 alone: {rep.get('error')}")

    # The sharded step at data 1 x model 1 against the one-card step from
    # the same weights and tokens (plain attention on both), then the
    # pipeline and MoE probes with their first stage's and expert's drills.
    from tpu_node_checker_torch.models.burnin import Burnin
    state = {n: t.detach().clone() for n, t in
             Burnin(cfg, torch.Generator().manual_seed(0)).state_dict().items()}
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1))
    seconds, results = {}, {}
    t0 = time.perf_counter()
    one_losses, _, one_grads = train_steps(cfg, None, 2, state=state, tokens=tokens,
                                           device=dev, keep_grads=True)
    seconds["one_card_step_x2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with RankGroup(1, "cuda", timeout_s=120) as group:
        seconds["rank_group_start"] = time.perf_counter() - t0
        for name, fn, args, kw in (
            ("sharded_step_x2", train_steps, (cfg, MeshSpec((("data", 1), ("model", 1))), 2),
             {"state": state, "tokens": tokens, "keep_grads": True}),
            ("pipeline", pipeline_probe, (), {}),
            ("pipeline_stage0_drill", pipeline_probe, (), {"inject_fault_stage": 0}),
            ("moe", moe_probe, (), {}),
            ("moe_expert0_drill", moe_probe, (), {"inject_fault_expert": 0}),
        ):
            t1 = time.perf_counter()
            (results[name],) = group.run(fn, *args, **kw)
            seconds[name] = time.perf_counter() - t1
        t1 = time.perf_counter()
    seconds["rank_group_close"] = time.perf_counter() - t1
    sharded = results.pop("sharded_step_x2")
    if not isinstance(sharded, tuple):
        fail(f"the sharded step failed: {sharded}")
    loss_rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(sharded[0], one_losses))
    grad_rel = max(rel_l2(g, one_grads[n]) for n, g in sharded[2].items())
    pp, pp0, ep, ep0 = (results[k] for k in (
        "pipeline", "pipeline_stage0_drill", "moe", "moe_expert0_drill"))
    checks = {
        "sharded_step": loss_rel < 1e-3 and grad_rel < 5e-2,
        "pipeline": pp.ok and pp.max_abs_err < 1e-3,
        "pipeline_stage0_drill": not pp0.ok and (pp0.details or {}).get("first_bad_stage") == 0,
        "moe": ep.ok and ep.max_abs_err < 1e-3,
        "moe_expert0_drill": not ep0.ok and (ep0.details or {}).get("bad_experts") == [0],
    }
    phase(6, "one-rank NCCL group: sharded step, pipeline, MoE", ok=checks,
          sharded_losses=sharded[0], one_card_losses=one_losses,
          check=(f"max |loss_sharded - loss_one_card|/loss_one_card = {loss_rel:.3e} < 1e-3; "
                 f"max over parameters of ||g_sharded - g_one_card||/||g_one_card|| = "
                 f"{grad_rel:.3e} < 5e-2"),
          pipeline_max_abs_err=pp.max_abs_err, pipeline_latency_ms=pp.latency_ms,
          pipeline_drill_error=pp0.error, moe_max_abs_err=ep.max_abs_err,
          moe_latency_ms=ep.latency_ms, moe_drill_error=ep0.error,
          seconds={k: round(v, 4) for k, v in seconds.items()})
    bad = [k for k, ok_ in checks.items() if not ok_]
    if bad:
        fail(f"one-rank NCCL group checks failed: {bad}")


def port_cli(root: str, *args, env: dict, timeout: int = 900) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "tpu_node_checker_torch", *args],
                          capture_output=True, text=True, cwd=root, timeout=timeout, env=env)


def aggregate(root: str, nodes: str, reports: str, env: dict) -> tuple:
    """The aggregator's line: the JAX checker's CLI as a subprocess (it runs
    on the control plane and imports no accelerator library on this path):
    (exit code, payload)."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker", "--nodes-json", nodes,
         "--probe-results", reports, "--json"],
        capture_output=True, text=True, cwd=root, timeout=300, env=env,
    )
    try:
        return proc.returncode, json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"the fleet checker printed no payload (exit {proc.returncode}): "
             f"{proc.stderr[-2000:]}")


@contextlib.contextmanager
def busy_host():
    """One spinning process per core for the ``with`` body; yields their count."""
    procs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
             for _ in range(os.cpu_count() or 1)]
    try:
        yield len(procs)
    finally:
        for p in procs:
            p.kill()
            p.wait()


def eager_chain_rounds(torch, seconds: float, iters: int, n: int = 2048) -> dict:
    """The burn chain issued product by product, each round timed on the host
    clock after a warm-up: TFLOP/s min, median, max and min/median."""
    from tpu_node_checker_torch.ops.burn import _burn_chain, _burn_input
    a = _burn_input(n, torch.device("cuda:0"))
    rates = []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        _burn_chain(a, iters).item()
        t0 = time.perf_counter()
        _burn_chain(a, iters).item()
        rates.append(2.0 * n ** 3 * iters / (time.perf_counter() - t0) / 1e12)
    med = statistics.median(rates)
    return {"rounds": len(rates), "tflops_min": min(rates), "tflops_median": med,
            "tflops_max": max(rates), "min_over_median": min(rates) / med}


def bf16_ulps_apart(torch, x, y):
    """|x - y| in bf16 steps, elementwise: their bit patterns on one ordered
    integer line."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)
    return (ordered(x) - ordered(y)).abs()


def burn_product_row(torch, ops, dev, gen) -> dict:
    """The burn chain's product at the chain's n = 2048
    (``ops/csrc/burn_chain.cu``), held against its plain version (the
    library's f32 product, x scale, the cast: three kernels), then the
    kernel, the plain version and one library call computing the same
    function (``torch.addmm`` with beta 0 and alpha the scale into bf16, a
    yardstick the port never calls) each captured as a CUDA graph of 1,024
    products alternating between two buffers, as the chain runs, and
    replayed in turns (plain, kernel, library, library, kernel, plain) by
    CUDA events; device times by torch.profiler over replays; the card's SM
    clock and power sampled over both."""
    from tpu_node_checker_torch.ops._harness import card_graph
    from tpu_node_checker_torch.ops.burn import burn_product_reference

    n, count = 2048, 1024
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    scale = torch.tensor(float(n)).sqrt().reciprocal().item()
    out = ops.burn_product(a, a, scale)
    torch.cuda.synchronize()
    ref = burn_product_reference(a, a, scale)
    rel = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
    close = float((bf16_ulps_apart(torch, out, ref) <= 1).float().mean())
    zero = torch.zeros_like(a)
    steps = {
        "kernel": lambda x, o: ops.burn_product(x, a, scale, out=o),
        "plain": lambda x, o: burn_product_reference(x, a, scale),
        "library": lambda x, o: torch.addmm(zero, x, a, beta=0, alpha=scale, out=o),
    }
    replays = {}
    for name, step in steps.items():
        bufs = [torch.empty_like(a) for _ in range(2)]

        def chain(step=step, bufs=bufs):
            x = a
            for i in range(count):
                x = step(x, bufs[i % 2])
            return x
        replays[name] = card_graph(chain, lambda step=step, bufs=bufs: step(a, bufs[0]), dev,
                                   f"smoke.{name}")
        replays[name]()
    order = ["plain", "kernel", "library", "library", "kernel", "plain"]
    with card_samples() as card:
        times = [replays[name]()[1] for name in order]
        dev_ms = device_ms(torch, lambda: replays["kernel"](), "burn_product_kernel", reps=2)
        lib_dev_ms = device_ms(torch, lambda: replays["library"](), reps=2)
    ms = {name: 1e3 * min(t for o, t in zip(order, times) if o == name) / count
          for name in steps}
    bms, by = bound(2 * 2 * n * n + 2 * n * n, 2.0 * n ** 3, BF16_FLOPS)
    tol = 2.0 ** -8
    return dict(
        name="burn_chain", route="cuda",
        source="tpu_node_checker_torch/ops/csrc/burn_chain.cu",
        replaces="tpu_node_checker/ops/burn.py:52",
        max_abs_err=float((out.float() - ref.float()).abs().max().item()),
        check=(f"max|d|/max|ref| = {rel:.3e} <= {tol:.3e}; "
               f"{close:.6f} of entries within one bf16 step >= 0.99"),
        ok=rel <= tol and close >= 0.99,
        ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
        device_ms=dev_ms, library_device_ms=lib_dev_ms / count if lib_dev_ms else None,
        bound_ms=bms, bound_by=by, share_of_bound=bms / dev_ms if dev_ms else None,
        shape=[n, n, n, count], card=card,
    )


@contextlib.contextmanager
def card_samples():
    """The card's SM clock (MHz), power draw (W) and active clock-event
    reasons, read by ``nvidia-smi`` every 250 ms for the ``with`` body; the
    yielded dict is filled when the body ends."""
    out = {}
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield out
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    rows = [r.split(", ") for r in text.splitlines() if r.count(",") == 2]
    for key, col in (("sm_clock_mhz", 0), ("power_w", 1)):
        vals = [float(r[col]) for r in rows if r[col].replace(".", "").isdigit()]
        if vals:
            out[key] = {"min": min(vals), "median": statistics.median(vals), "max": max(vals)}
    out["samples"] = len(rows)
    out["clock_event_reasons"] = sorted({r[2] for r in rows})


def http_get(port: int, path: str = "/metrics", method: str = "GET",
             headers: Optional[dict] = None, body: Optional[bytes] = None) -> tuple:
    """(status, headers, body, ms) of one request to a local HTTP server."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        out = resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()
    return (*out, (time.perf_counter() - t0) * 1e3)


def samples(body: bytes) -> dict:
    """A Prometheus text body's samples: ``name{labels}`` → value."""
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def scrape_round(port: Optional[int], doc: dict) -> dict:
    """The emitter's scrape after the round that wrote ``doc``.  The loop
    updates its scrape just after it writes the report, so the scrape is
    read until its timestamp reaches the report's ``written_at``; then each
    check, and each request's time."""
    if port is None:
        fail("the emitter printed no 'Serving emitter metrics on port' line before its report")
    polls, deadline = 0, time.perf_counter() + 10
    while True:
        polls += 1
        status, headers, body, get_ms = http_get(port)
        got = samples(body)
        stamp = got.get("tpu_node_checker_last_run_timestamp_seconds", 0.0)
        if stamp >= doc["written_at"] or time.perf_counter() > deadline:
            break
        time.sleep(0.005)
    now = time.time()
    s304, h304, b304, ms304 = http_get(port, headers={"If-None-Match": headers.get("ETag", "")})
    sgz, hgz, bgz, msgz = http_get(port, headers={"Accept-Encoding": "gzip"})
    shead, hhead, bhead, mshead = http_get(port, method="HEAD")
    s404, _, _, ms404 = http_get(port, path="/nope")
    checks = {
        "GET 200": status == 200,
        'probe_ok{level="compute"} 1.0': got.get('tpu_node_checker_probe_ok{level="compute"}') == 1.0,
        "exit_code 0": got.get("tpu_node_checker_exit_code") == 0.0,
        "check_duration_ms == elapsed_ms":
            got.get("tpu_node_checker_check_duration_ms") == doc.get("elapsed_ms"),
        "timestamp inside the round's window": doc["written_at"] <= stamp <= now,
        "304 for the ETag, empty": s304 == 304 and b304 == b"" and h304.get("ETag") == headers.get("ETag"),
        "gzip decodes to the body": sgz == 200 and hgz.get("Content-Encoding") == "gzip"
            and gzip.decompress(bgz) == body,
        "HEAD has no body": shead == 200 and bhead == b""
            and hhead.get("Content-Length") == str(len(body)),
        "/nope 404": s404 == 404,
    }
    for key in ("matmul_tflops", "int8_tops", "hbm_gbps"):
        checks[f"{key} == report"] = got.get(f"tpu_node_checker_probe_{key}") == doc.get(key)
    return {"checks": checks, "timestamp": stamp, "polls": polls,
            "ms": {"GET": get_ms, "304": ms304, "gzip": msgz, "HEAD": mshead, "404": ms404}}


def phase7_emitter(torch, root, rows, validate_report) -> None:
    """Phase 7: the emitter's deployed command lines, and the fleet checker
    grading what they write."""
    node = os.environ.get("NODE_NAME") or "gke-h100-node-0"
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    env.update(NODE_NAME=node, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-emitter-")
    reports = os.path.join(work, "reports")
    os.mkdir(reports)
    report, log = os.path.join(reports, f"{node}.json"), os.path.join(work, "rounds.jsonl")

    # The DaemonSet's line.  A compute round takes longer than 5 s, so each
    # round starts when the last one ends; SIGTERM, sent 2 s after the
    # second report, lands in the third round, which still writes its report
    # and its line before the loop stops.  Its scrape is read after the first
    # and the second report.
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", report,
         "--probe-level", "compute", "--watch", "5", "--metrics-port", "0", "--log-jsonl", log],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, cwd=root, env=env,
    )
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    docs, scrapes, port = [], [], None
    try:
        for line in proc.stderr:
            served = re.search(r"Serving emitter metrics on port (\d+) \(/metrics\)\.", line)
            if served:
                port = int(served.group(1))
            if "Probe report written" in line:
                with open(report) as f:
                    docs.append(json.load(f))
                scrapes.append(scrape_round(port, docs[-1]))
                if len(docs) == 2:
                    break
        time.sleep(2.0)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=600)
        term_s = time.perf_counter() - t_term
        rest = proc.stderr.read()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    if "Probe report written" in rest:
        with open(report) as f:
            docs.append(json.load(f))
    with open(log) as f:
        entries = [json.loads(x) for x in f.read().splitlines()]
    # Each round's start: its log line's time less the probe's wall time.
    starts = [e["ts"] - e["duration_ms"] / 1e3 for e in entries]
    per_round = [{"ok": d.get("ok"), "elapsed_ms": d.get("elapsed_ms"),
                  "kernel_launches": d.get("kernel_launches"),
                  "schema_violations": validate_report(d)} for d in docs]
    phase(7, "emitter --watch 5, the DaemonSet's line", exit_code=rc, rounds=per_round,
          log_exit_codes=[e["exit_code"] for e in entries],
          gap_between_round_starts_s=[b - a for a, b in zip(starts, starts[1:])],
          sigterm_to_exit_s=term_s, stderr_tail=rest.strip().splitlines()[-1:])
    if rc != 143 or len(docs) < 3 or len(entries) != len(docs):
        fail(f"the emitter loop: exit {rc}, {len(docs)} reports, {len(entries)} log lines")
    stamps = [sc["timestamp"] for sc in scrapes]
    phase(7, "emitter --metrics-port, scraped after reports 1 and 2", port=port,
          scrapes=[{k: sc[k] for k in ("checks", "ms", "polls")} for sc in scrapes],
          timestamps=stamps, timestamp_moved_forward=len(stamps) == 2 and stamps[1] > stamps[0])
    bad = [f"scrape {i + 1}: {name}" for i, sc in enumerate(scrapes)
           for name, ok_ in sc["checks"].items() if not ok_]
    if port is None or len(scrapes) != 2 or bad or not stamps[1] > stamps[0]:
        fail(f"the emitter's scrape: port {port}, {len(scrapes)} scrapes, failed {bad}, "
             f"timestamps {stamps}")
    if any(e["exit_code"] != 0 or e["probe_level"] != "compute" for e in entries):
        fail(f"an emitter round was not healthy at the compute level: {entries}")
    for i, d in enumerate(per_round):
        if not d["ok"] or d["schema_violations"]:
            fail(f"an emitter round is not healthy: {d}")
        check_launches(f"emitter round {i + 1}", d["kernel_launches"])
    for r in rows:
        r["emitter_launches"] = [d["kernel_launches"][r["name"]] for d in per_round]

    # The livenessProbe's line, on the report the loop left.
    fresh = port_cli(root, "--report-fresh", report, env=env, timeout=120).returncode
    aged = port_cli(root, "--report-fresh", report, "--probe-results-max-age", "0.001",
                    env=env, timeout=120).returncode
    phase(7, "livenessProbe --report-fresh", exit_code=fresh, exit_code_max_age_0_001=aged)
    if (fresh, aged) != (0, 1):
        fail(f"--report-fresh exited {fresh}, and {aged} at max age 0.001")

    # The aggregator over a one-node NodeList: this host as a GKE GPU node.
    gpus = str(torch.cuda.device_count())
    resources = {"cpu": "8", "memory": "32Gi", "pods": "110", "nvidia.com/gpu": gpus}
    nodes = os.path.join(work, "nodes.json")
    with open(nodes, "w") as f:
        json.dump({"kind": "NodeList", "apiVersion": "v1", "items": [{
            "metadata": {"name": node, "labels": {}}, "spec": {},
            "status": {"allocatable": resources, "capacity": dict(resources),
                       "conditions": [{"type": "Ready", "status": "True"}]},
        }]}, f)
    rc, payload = aggregate(root, nodes, reports, env)
    probe = (payload.get("nodes") or [{}])[0].get("probe") or {}
    phase(7, "aggregator on the loop's report", exit_code=rc,
          probe_summary=payload.get("probe_summary"), probe_ok=probe.get("ok"),
          probe_level=probe.get("level"))
    if rc != 0 or probe.get("ok") is not True or probe.get("hostname") != node:
        fail(f"the fleet checker did not grade the report healthy: exit {rc}, {probe}")

    drills = os.path.join(work, "drills")
    os.mkdir(drills)
    t0 = time.perf_counter()
    drill = port_cli(root, "--emit-probe", os.path.join(drills, f"{node}.json"),
                     "--probe-topology", "1x1", "--probe-level", "collective",
                     env={**env, "TNC_CHAOS_AXIS": "t1"})
    drill_s = time.perf_counter() - t0
    rc, payload = aggregate(root, nodes, drills, env)
    summary = payload.get("probe_summary") or {}
    probe = (payload.get("nodes") or [{}])[0].get("probe") or {}
    phase(7, "aggregator on the t1 drill's report", emit_exit_code=drill.returncode,
          emit_seconds=drill_s, exit_code=rc, probe_summary=summary,
          error=probe.get("error"), ici_axis_ok=probe.get("ici_axis_ok"))
    if drill.returncode != 3 or rc != 3 or summary.get("hosts_failed") != [node]:
        fail(f"the drill's report was not graded failed: emit {drill.returncode}, "
             f"exit {rc}, {summary}")

    # The soak's rounds in this process at the card's size (1024 products),
    # on an idle host and on a host kept busy by one spinning process per
    # core.  The soak times its chain on the card (one CUDA graph between two
    # events), so the slowest round against the median, which its verdict
    # holds to 0.5, must not move with the host.  Beside them, the same chain
    # issued product by product on the host clock, as the soak timed it
    # before, on the busy host: what a loaded node did to that reading.
    from tpu_node_checker_torch.ops import soak_burn
    idle = soak_burn(8, iters=1024, device="cuda:0").to_dict()
    with busy_host() as spinning:
        busy = soak_burn(8, iters=1024, device="cuda:0").to_dict()
        eager = eager_chain_rounds(torch, 8, iters=1024)
    phase(7, "soak rounds in-process, 8 s each", idle_host=idle, busy_host=busy,
          spinning_processes=spinning, busy_host_eager_chain_host_clock=eager)
    if idle["ok"] is not True or busy["ok"] is not True:
        fail(f"the in-process soak failed: idle host {idle}, busy host {busy}")

    # The acceptance Job's line, with a 20 s soak.
    t0 = time.perf_counter()
    with card_samples() as samples:
        job = port_cli(root, "--emit-probe", "-", "--probe-level", "compute", "--probe-soak",
                       "20", "--perf-floor", "0.4", env=env)
    job_s = time.perf_counter() - t0
    try:
        doc = json.loads(job.stdout)
    except json.JSONDecodeError:
        fail(f"the acceptance line printed no report (exit {job.returncode}): "
             f"{job.stderr[-2000:]}")
    soak = doc.get("soak") or {}
    phase(7, "acceptance --probe-soak 20 --perf-floor 0.4", exit_code=job.returncode,
          seconds=job_s, ok=doc.get("ok"), elapsed_ms=doc.get("elapsed_ms"), soak=soak,
          tflops_median=soak.get("tflops_median"), perf_floor=doc.get("perf_floor"),
          kernel_launches=doc.get("kernel_launches"), schema_violations=validate_report(doc),
          card=samples)
    if (job.returncode != 0 or not doc.get("ok") or soak.get("ok") is not True
            or not soak.get("tflops_median") or (doc.get("elapsed_ms") or 0) < 20000):
        fail(f"the acceptance line: exit {job.returncode}, {doc.get('error')}, soak {soak}")
    if "skipped" not in (doc.get("perf_floor") or {}):
        fail(f"perf_floor graded on a card with no floor table: {doc.get('perf_floor')}")


# The port's CLI with the argv after the log path, as a node runs it, in a
# process that also appends one JSON line per probe child to that log: the
# child's seconds, its arguments, its TNC_* environment and its report.
OBSERVED_CLI_SCRIPT = """
import json, os, sys, time
from tpu_node_checker_torch import calibrate, cli, selftest

log = open(sys.argv[1], "a")


def observed(run):
    def probe(**kw):
        t0 = time.perf_counter()
        r = run(**kw)
        log.write(json.dumps({
            "seconds": time.perf_counter() - t0, "args": kw,
            "env": {k: v for k, v in os.environ.items() if k.startswith("TNC_")},
            "report": r.to_dict()}) + "\\n")
        log.flush()
        return r
    return probe


selftest.run_local_probe = observed(selftest.run_local_probe)
calibrate.run_local_probe = observed(calibrate.run_local_probe)
sys.exit(cli.main(sys.argv[2:]))
"""

# The JAX checker's skip reasons on a host with one card.
SINGLE_CARD_SKIPS = ["collective_leg, ring_link (single device)",
                     "dcn (needs >=4 devices, even count)"]


def observed_cli(root: str, work: str, name: str, *args, env: dict) -> tuple:
    """(completed process, one record per probe child, seconds) of the CLI
    line ``args``, through OBSERVED_CLI_SCRIPT."""
    log = os.path.join(work, f"{name}.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", OBSERVED_CLI_SCRIPT, log, *args],
                          capture_output=True, text=True, cwd=root, timeout=900, env=env)
    seconds = time.perf_counter() - t0
    if not os.path.exists(log):  # the CLI never started
        return proc, [], seconds
    with open(log) as f:
        return proc, [json.loads(x) for x in f.read().splitlines()], seconds


def phase8_operator_modes(torch, root, rows) -> None:
    """Phase 8: the initContainer's selftest, calibration, and the floors it
    lets grade on an idle host, on a busy one and under a throttle."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    work = tempfile.mkdtemp(prefix="chip-smoke-modes-")

    # The initContainer's line (deploy/daemonset-emitter.yaml).
    proc, legs, seconds = observed_cli(root, work, "selftest", "--selftest", "--json",
                                       "--probe-timeout", "600", env=env)
    try:
        doc = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"--selftest printed no document (exit {proc.returncode}): {proc.stderr[-2000:]}")
    behaved = {x["leg"]: x["behaved"] for x in doc.get("selftest", [])}
    launches = [leg["report"].get("kernel_launches") or {} for leg in legs]
    phase(8, "initContainer --selftest --json --probe-timeout 600", exit_code=proc.returncode,
          seconds=seconds, behaved=behaved, details={x["leg"]: x["detail"] for x in
                                                     doc.get("selftest", [])},
          skipped_legs=doc.get("skipped_legs"),
          legs=[{"seconds": leg["seconds"], "level": leg["args"].get("level"),
                 "device": leg["args"].get("device"), "timeout_s": leg["args"].get("timeout_s"),
                 "env": leg["env"], "elapsed_ms": leg["report"].get("elapsed_ms"),
                 "matmul_tflops": leg["report"].get("matmul_tflops"),
                 "perf_floor": leg["report"].get("perf_floor"), "kernel_launches": kl}
                for leg, kl in zip(legs, launches)])
    if (proc.returncode != 0 or behaved != {"baseline": True, "throttle": True}
            or doc.get("skipped_legs") != SINGLE_CARD_SKIPS or len(legs) != 2):
        fail(f"the selftest: exit {proc.returncode}, behaved {behaved}, "
             f"skipped {doc.get('skipped_legs')}, {len(legs)} legs")
    for i, kl in enumerate(launches):
        check_launches(f"selftest leg {i}", kl)
    if any(leg["args"].get("device") != "cuda:0" or leg["args"].get("timeout_s") != 600.0
           for leg in legs):
        fail(f"a selftest leg did not run on cuda:0 with the 600 s timeout: "
             f"{[leg['args'] for leg in legs]}")
    for r in rows:
        r["selftest_launches"] = [kl[r["name"]] for kl in launches]

    # Calibration: three reps, each projection on stderr, the JSON on stdout.
    proc, reps, seconds = observed_cli(root, work, "calibrate", "--calibrate", "3",
                                       "--probe-level", "compute", env=env)
    shown = [ast.literal_eval(line.split(": ", 1)[1]) for line in proc.stderr.splitlines()
             if re.match(r"rep \d+/3: ", line)]
    try:
        expect = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"--calibrate printed no JSON (exit {proc.returncode}): {proc.stderr[-2000:]}")
    metrics = ("matmul_tflops", "int8_tops", "hbm_gbps")
    spread = {m: {"min": min(x[m] for x in shown), "median": statistics.median(x[m] for x in shown),
                  "max": max(x[m] for x in shown),
                  "max_over_min": max(x[m] for x in shown) / min(x[m] for x in shown)}
              for m in metrics if len(shown) == 3 and all(m in x for x in shown)}
    cal_launches = [rep["report"].get("kernel_launches") or {} for rep in reps]
    phase(8, "--calibrate 3 --probe-level compute", exit_code=proc.returncode, seconds=seconds,
          expectations=expect, reps=shown, spread=spread,
          rep_seconds=[rep["seconds"] for rep in reps],
          rep_perf_floor=[rep["args"].get("perf_floor") for rep in reps],
          kernel_launches=cal_launches)
    wrong = [m for m in metrics
             if m not in spread or expect.get(m) != round(0.9 * spread[m]["median"], 3)]
    if proc.returncode != 0 or len(reps) != 3 or wrong:
        fail(f"the calibration: exit {proc.returncode}, {len(reps)} reps, expectations "
             f"not 0.9 x the median: {wrong}")
    for i, kl in enumerate(cal_launches):
        check_launches(f"calibration rep {i}", kl)
    for r in rows:
        r["calibrate_launches"] = [kl[r["name"]] for kl in cal_launches]

    # The floors that calibration lets grade: idle host, busy host, throttled.
    graded_env = {**env, "TNC_SCHEMA_STRICT": "1", "TNC_PERF_EXPECT": proc.stdout.strip()}
    line = ("--emit-probe", "-", "--probe-level", "compute", "--perf-floor", "0.4")
    graded = {}
    for name in ("idle host", "busy host", "TNC_CHAOS_THROTTLE=int8_tops"):
        t0 = time.perf_counter()
        extra = {"TNC_CHAOS_THROTTLE": "int8_tops"} if name.startswith("TNC_") else {}
        with busy_host() if name == "busy host" else contextlib.nullcontext():
            job = port_cli(root, *line, env={**graded_env, **extra}, timeout=600)
        try:
            rep = json.loads(job.stdout)
        except json.JSONDecodeError:
            fail(f"the graded line ({name}) printed no report (exit {job.returncode}): "
                 f"{job.stderr[-2000:]}")
        floor = rep.get("perf_floor") or {}
        graded[name] = {"exit_code": job.returncode, "seconds": time.perf_counter() - t0,
                        "ok": rep.get("ok"), "error": rep.get("error"),
                        "generation": floor.get("generation"), "floor_ok": floor.get("ok"),
                        "failed": floor.get("failed"), "ratios": floor.get("ratios"),
                        "measured": floor.get("measured"),
                        "min_ratio": min((floor.get("ratios") or {"-": None}).values())}
    phase(8, "--emit-probe - --probe-level compute --perf-floor 0.4, TNC_PERF_EXPECT calibrated",
          **graded)
    for name in ("idle host", "busy host"):
        g = graded[name]
        if (g["exit_code"] != 0 or g["ok"] is not True or g["generation"] != "custom"
                or g["floor_ok"] is not True or set(g["ratios"] or ()) != set(expect)):
            fail(f"the calibrated floor on the {name}: {g}")
    g = graded["TNC_CHAOS_THROTTLE=int8_tops"]
    if g["exit_code"] != 3 or g["failed"] != ["int8_tops"] or g["generation"] != "custom":
        fail(f"the int8_tops throttle was not caught alone: {g}")
    phase(8, "operator modes", seconds=time.perf_counter() - t_phase)


def free_port() -> int:
    """A local port nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tagged(tag: str) -> list:
    """Every living process whose environment carries ``CHIP_SMOKE_TAG=tag``:
    what a command started, wherever it was reparented."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                if f"CHIP_SMOKE_TAG={tag}".encode() not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{entry}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    found.append(int(entry))
        except OSError:
            continue  # gone while scanned, or not ours to read
    return found


def distributed_line(root: str, level: str, coord: str, n: int, pid: int, rdv_s: float,
                     env: dict) -> dict:
    """One host's emitter in a distributed probe, on its own tag: its exit
    code, report, seconds, and the processes of its left after it exits."""
    tag = uuid.uuid4().hex
    t0 = time.perf_counter()
    proc = port_cli(root, "--emit-probe", "-", "--probe-level", level, "--probe-distributed",
                    "--probe-coordinator", coord, "--probe-num-processes", str(n),
                    "--probe-process-id", str(pid), "--probe-rendezvous-timeout", str(rdv_s),
                    env={**env, "CHIP_SMOKE_TAG": tag}, timeout=900)
    seconds = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"the distributed {level} line (process {pid} of {n}) printed no report "
             f"(exit {proc.returncode}): {proc.stderr[-2000:]}")
    return {"exit_code": proc.returncode, "doc": doc, "seconds": seconds,
            "left": tagged(tag)}


def phase9_distributed(root, rows, validate_report) -> None:
    """Phase 9: the distributed probe on one card, its failure modes, and a
    coordinator port used by two rounds in a row."""
    from tpu_node_checker_torch.probe.levels import LEVEL_TIMEOUTS_S
    from tpu_node_checker_torch.probe.liveness import DISTRIBUTED_EXTRA_TIMEOUT_S

    env = {k: v for k, v in os.environ.items() if not k.startswith("TNC_")}
    env["TNC_SCHEMA_STRICT"] = "1"
    coord = f"127.0.0.1:{free_port()}"

    # The main path of the slice: a rendezvous of one process at the
    # workload level (the counts start at 0 in the fresh child).
    run = distributed_line(root, "workload", coord, 1, 0, 60, env)
    doc = run["doc"]
    launches = doc.get("kernel_launches") or {}
    verdicts = {k: doc.get(k) for k in ("collective_ok", "ring_ok", "mesh_ok", "workload_ok",
                                        "ring_attention_ok")}
    phase(9, "--probe-distributed, one process, workload level", exit_code=run["exit_code"],
          seconds=run["seconds"], rendezvous_ms=doc.get("rendezvous_ms"),
          elapsed_ms=doc.get("elapsed_ms"), ok=doc.get("ok"), error=doc.get("error"),
          distributed=doc.get("distributed"), process_index=doc.get("process_index"),
          process_count=doc.get("process_count"), device_count=doc.get("device_count"),
          **verdicts, workload_losses=doc.get("workload_losses"), kernel_launches=launches,
          schema_violations=validate_report(doc), left=run["left"])
    if (run["exit_code"] != 0 or doc.get("ok") is not True or validate_report(doc)
            or doc.get("distributed") is not True or doc.get("process_count") != 1
            or doc.get("process_index") != 0 or "distributed_psum" in doc
            or any(v is not True for v in verdicts.values()) or run["left"]):
        fail(f"the one-process distributed probe: exit {run['exit_code']}, {doc.get('error')}, "
             f"verdicts {verdicts}, left {run['left']}")
    check_launches("the one-process distributed probe", launches)
    for r in rows:
        r["distributed_launches"] = launches[r["name"]]

    # The failure modes, both at once: process 0 of 2 alone, and process 1
    # of 2 with nothing listening at its coordinator.
    kill_timer = LEVEL_TIMEOUTS_S["enumerate"] + DISTRIBUTED_EXTRA_TIMEOUT_S + 5
    cases = {"process 0 of 2 alone": (f"127.0.0.1:{free_port()}", 0),
             "process 1 of 2, nothing listening": (f"127.0.0.1:{free_port()}", 1)}
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        runs = dict(zip(cases, pool.map(
            lambda c: distributed_line(root, "enumerate", c[0], 2, c[1], 5, env),
            cases.values())))
    phase(9, "rendezvous failures, --probe-rendezvous-timeout 5",
          kill_timer_s=kill_timer,
          **{name: {"exit_code": r["exit_code"], "seconds": r["seconds"],
                    "error": r["doc"].get("error"), "ok": r["doc"].get("ok"),
                    "left": r["left"]} for name, r in runs.items()})
    for name, r in runs.items():
        coord_ = cases[name][0]
        if (r["exit_code"] != 3 or r["doc"].get("ok") is not False
                or f"rendezvous at coordinator {coord_} failed" not in (r["doc"].get("error") or "")
                or r["seconds"] >= kill_timer or r["left"]):
            fail(f"{name}: exit {r['exit_code']} in {r['seconds']:.1f} s "
                 f"(kill-timer {kill_timer} s), {r['doc'].get('error')}, left {r['left']}")

    # Two rounds in a row on the port the first line used, as the --watch
    # loop's fresh children bind it.
    rounds = [distributed_line(root, "enumerate", coord, 1, 0, 60, env) for _ in range(2)]
    phase(9, "two rounds in a row on one coordinator port",
          rounds=[{"exit_code": r["exit_code"], "seconds": r["seconds"], "ok": r["doc"].get("ok"),
                   "rendezvous_ms": r["doc"].get("rendezvous_ms"),
                   "error": r["doc"].get("error")} for r in rounds])
    if any(r["exit_code"] != 0 or r["doc"].get("ok") is not True for r in rounds):
        fail("a second distributed round on one coordinator port was not healthy")


# Keys of a round's payload that are a random id and wall times.
VOLATILE = ("trace_id", "timings_ms")


def k8s_node(name: str, extra: dict, ready: bool) -> dict:
    """One node as ``GET /api/v1/nodes`` returns it."""
    resources = {"cpu": "8", "memory": "32Gi", "pods": "110", **extra}
    return {"metadata": {"name": name, "labels": {}}, "spec": {},
            "status": {"allocatable": resources, "capacity": dict(resources),
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


def round_line(root: str, side: str, *args, env: dict) -> tuple:
    """(exit code, payload or None, stdout, stderr, seconds) of one round of
    the port's CLI (``side="port"``) or the JAX checker's (``"jax"``)."""
    cmd = [sys.executable, "-m", "tpu_node_checker_torch" if side == "port" else "tpu_node_checker"]
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, *args], capture_output=True, text=True, cwd=root,
                          timeout=900, env=env)
    seconds = time.perf_counter() - t0
    payload = None
    if "--json" in args:
        try:
            payload = json.loads(proc.stdout)
        except json.JSONDecodeError:
            fail(f"the {side} round {args} printed no payload (exit {proc.returncode}): "
                 f"{proc.stderr[-2000:]}")
    return proc.returncode, payload, proc.stdout, proc.stderr, seconds


def stable(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in VOLATILE}


@contextlib.contextmanager
def webhook():
    """A loopback Slack webhook for the ``with`` body: yields (url, posts),
    each post (path, Content-Type, JSON body)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    posts = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 — the handler protocol's name
            body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            posts.append((self.path, self.headers.get("Content-Type"), json.loads(body)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    thread = threading.Thread(target=server.serve_forever, name="chip-smoke-webhook",
                              daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/slack", posts
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def phase10_oneshot(torch, root, rows, validate_report) -> None:
    """Phase 10: the one-shot fleet round over a NodeList of this host (a GPU
    node), a CPU node and a NotReady GPU node: ``--probe`` on this host's
    card, a partial enumeration, ``--probe-results`` and ``--history`` beside
    the JAX checker's, and Slack."""
    t_phase = time.perf_counter()
    host, down = "gke-h100-oneshot-0", "gke-h100-down-0"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TNC_") and k != "SLACK_WEBHOOK_URL"}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-oneshot-")
    n = torch.cuda.device_count()

    def nodes_file(name: str, gpus: int) -> str:
        path = os.path.join(work, name)
        with open(path, "w") as f:
            json.dump({"kind": "NodeList", "apiVersion": "v1", "items": [
                k8s_node(host, {"nvidia.com/gpu": str(gpus)}, True),
                k8s_node("cpu-worker-0", {}, True),
                k8s_node(down, {"nvidia.com/gpu": "8"}, False)]}, f)
        return path

    nodes = nodes_file("nodes.json", n)

    # The main path of the slice: the round with this host's probe at the
    # workload level (the counts start at 0 in the fresh probe child).
    rc, payload, _, err, seconds = round_line(root, "port", "--nodes-json", nodes, "--probe",
                                              "--probe-level", "workload", "--json", env=env)
    local = payload.get("local_probe") or {}
    entry = next((x for x in payload.get("nodes", []) if x.get("name") == host), {})
    launches = local.get("kernel_launches") or {}
    phase(10, "--nodes-json N --probe --probe-level workload --json", exit_code=rc,
          seconds=seconds, ok=local.get("ok"), error=local.get("error"),
          elapsed_ms=local.get("elapsed_ms"), device_count=local.get("device_count"),
          attached_to_this_node=entry.get("probe") == local, ready_nodes=payload.get("ready_nodes"),
          total_nodes=payload.get("total_nodes"), kernel_launches=launches,
          schema_violations=validate_report(local), timings_ms=payload.get("timings_ms"))
    if (rc != 0 or local.get("ok") is not True or entry.get("probe") != local
            or validate_report(local) or payload.get("ready_nodes") != 1):
        fail(f"the one-shot round with --probe: exit {rc}, {local.get('error')}: {err[-2000:]}")
    check_launches("the one-shot round with --probe", launches,
                   {r["name"]: r["launches"] for r in rows})
    for r in rows:
        r["oneshot_launches"] = launches[r["name"]]

    rc, _, out, err, seconds = round_line(root, "port", "--nodes-json", nodes, "--probe",
                                          "--probe-level", "workload", env=env)
    print("\n".join(f"  | {line}" for line in out.rstrip().splitlines()), flush=True)
    probe_line = [x for x in out.splitlines() if x.startswith("Local chip probe")]
    phase(10, "the same round in text mode", exit_code=rc, seconds=seconds,
          summary=out.splitlines()[0] if out else None, probe_line=probe_line)
    if rc != 0 or probe_line != [f"Local chip probe [workload] ok: {n} device(s), "
                                 "platform=gpu"]:
        fail(f"the text round: exit {rc}, probe line {probe_line}: {err[-2000:]}")

    # A partial enumeration: the node promises one card more than the host has.
    short = nodes_file("nodes-short.json", n + 1)
    rc, payload, _, _, seconds = round_line(root, "port", "--nodes-json", short, "--probe",
                                            "--json", env=env)
    error = (payload.get("local_probe") or {}).get("error") or ""
    phase(10, f"allocatable {n + 1} on a host of {n}", exit_code=rc, seconds=seconds,
          error=error, payload_exit_code=payload.get("exit_code"))
    if rc != 3 or f"only {n}/{n + 1} expected devices enumerated" not in error:
        fail(f"the partial enumeration was not failed: exit {rc}, {error}")

    # The fleet's reports: this host healthy, and a t1 drill, each written by
    # the port's emitter; a drill report for the NotReady node.
    healthy, drills, fleet = (os.path.join(work, d) for d in ("healthy", "drills", "fleet"))
    for d in (healthy, drills, fleet):
        os.mkdir(d)
    drill_args = ("--probe-topology", "1x1", "--probe-level", "collective")
    emits = {
        "healthy": (os.path.join(healthy, f"{host}.json"), (), env),
        "drill": (os.path.join(drills, f"{host}.json"), drill_args,
                  {**env, "TNC_CHAOS_AXIS": "t1"}),
        "drill of the NotReady node": (os.path.join(fleet, f"{down}.json"), drill_args,
                                       {**env, "TNC_CHAOS_AXIS": "t1", "NODE_NAME": down}),
    }
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(emits)) as pool:
        done = dict(zip(emits, pool.map(
            lambda e: port_cli(root, "--emit-probe", e[0], *e[1], env=e[2]).returncode,
            emits.values())))
    phase(10, "the reports, written by the port's emitter at once", exit_codes=done,
          seconds=time.perf_counter() - t0)
    if done != {"healthy": 0, "drill": 3, "drill of the NotReady node": 3}:
        fail(f"the reports' emitters: {done}")
    with open(emits["healthy"][0]) as f:
        doc = json.load(f)
    with open(os.path.join(fleet, f"{host}.json"), "w") as f:
        json.dump(doc, f)
    with open(os.path.join(fleet, "gke-h100-stale-0.json"), "w") as f:
        json.dump({**doc, "hostname": "gke-h100-stale-0", "written_at": time.time() - 3600}, f)
    with open(os.path.join(fleet, "broken.json"), "w") as f:
        json.dump({"schema": 1, "ok": "yes", "level": "compute", "hostname": "cpu-worker-0",
                   "written_at": time.time()}, f)

    compared = {}
    for name, extra in (("--probe-results", ()),
                        ("--probe-results --probe-results-required",
                         ("--probe-results-required",))):
        line = ("--nodes-json", nodes, "--probe-results", fleet, "--json", *extra)
        port = round_line(root, "port", *line, env=env)
        ref = round_line(root, "jax", *line, env=env)
        compared[name] = {"exit_codes": [port[0], ref[0]], "seconds": [port[4], ref[4]],
                          "equal": stable(port[1]) == stable(ref[1]),
                          "probe_summary": port[1].get("probe_summary")}
    phase(10, "--probe-results, the port's round beside the JAX checker's", **compared)
    for name, c in compared.items():
        summary = c["probe_summary"] or {}
        if (c["exit_codes"] != [0, 0] or not c["equal"] or summary.get("hosts_failed") != [down]
                or summary.get("reports_skipped") != {"stale": 1, "schema": 1}):
            fail(f"{name}: {c}")

    # --history: three rounds (healthy, drill, drill), each side its own store.
    states, rounds = {"port": [], "jax": []}, []
    for i, reports in enumerate((healthy, drills, drills)):
        line = ("--nodes-json", nodes, "--probe-results", reports, "--cordon-after", "2",
                "--json")
        got = {side: round_line(root, side, *line, "--history",
                                os.path.join(work, f"history-{side}.jsonl"), env=env)
               for side in ("port", "jax")}
        for side, g in got.items():
            states[side].append(next(x for x in g[1]["nodes"] if x["name"] == host)
                                .get("health", {}).get("state"))
        rounds.append({"exit_codes": [got["port"][0], got["jax"][0]],
                       "equal": stable(got["port"][1]) == stable(got["jax"][1]),
                       "transitions": got["port"][1]["history"]["transitions"]})
    log, store = os.path.join(work, "emitter.jsonl"), os.path.join(work, "emitter-history.jsonl")
    emitted = port_cli(root, "--emit-probe", "-", "--history", store, "--log-jsonl", log, env=env)
    with open(log) as f:
        (emitter_line,) = [json.loads(x) for x in f.read().splitlines()]
    phase(10, "--history --cordon-after 2, three rounds", states=states, rounds=rounds,
          emitter_exit_code=emitted.returncode, emitter_line=emitter_line)
    if (states["port"] != ["HEALTHY", "SUSPECT", "FAILED"] or states["jax"] != states["port"]
            or [r["exit_codes"] for r in rounds] != [[0, 0], [3, 3], [3, 3]]
            or not all(r["equal"] for r in rounds)):
        fail(f"the --history rounds: states {states}, rounds {rounds}")
    if emitted.returncode != 0 or emitter_line.get("state") != "HEALTHY":
        fail(f"the emitter's --history line: exit {emitted.returncode}, {emitter_line}")

    # Slack, only on error: the healthy round posts nothing, the failing one
    # posts once, and the port's body is the JAX checker's.
    bodies, slack = {}, {}
    with webhook() as (url, posts):
        for side in ("port", "jax"):
            start = len(posts)
            codes = [round_line(root, side, "--nodes-json", nodes, "--probe-results", reports,
                                "--slack-webhook", url, "--slack-only-on-error", env=env)
                     for reports in (healthy, drills)]
            mine = posts[start:]
            slack[side] = {"exit_codes": [c[0] for c in codes], "posts": len(mine),
                           "stdout_lines": [c[2].count("Slack notification sent.") for c in codes]}
            if len(mine) == 1:
                body = dict(mine[0][2])
                body["text"] = body["text"].rsplit("\n`trace: ", 1)[0]
                bodies[side] = body
    phase(10, "Slack --slack-only-on-error to a loopback webhook", **slack,
          bodies_equal=bodies.get("port") == bodies.get("jax") and "port" in bodies,
          body=bodies.get("port"))
    if (any(s["exit_codes"] != [0, 3] or s["posts"] != 1 or s["stdout_lines"] != [0, 1]
            for s in slack.values()) or bodies.get("port") != bodies.get("jax")
            or "port" not in bodies):
        fail(f"Slack: {slack}, bodies {bodies}")
    phase(10, "the one-shot round", seconds=time.perf_counter() - t_phase)


class LiveApi:
    """A fake Kubernetes API server on an ephemeral local port, served from a
    thread: ``/api/v1/nodes`` in ``limit``/``continue`` pages (the token is
    the offset) filtered by ``labelSelector`` terms ``key`` and
    ``key=value``, and ``/api/v1/events`` for the node its ``fieldSelector``
    names.  ``throttle`` answers that many node requests with 429 and
    ``Retry-After: 1`` first; ``rounds``, where set, is a script: the n-th
    LIST (its first page) serves ``rounds[n]``, the last entry from then on,
    and None answers 500; ``requests`` counts what was asked."""

    def __init__(self, nodes: list, events: dict, tls_cert: Optional[tuple] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self.nodes, self.events, self.throttle = nodes, events, 0
        self.rounds, self.round = None, 0
        self.requests = {"nodes": 0, "events": 0, "throttled": 0}
        self.patches = []
        self.lock = threading.Lock()
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def send(self, status: int, doc: dict, extra: Optional[dict] = None) -> None:
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — the handler protocol's name
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path == "/api/v1/events":
                    with api.lock:
                        api.requests["events"] += 1
                    name = q.get("fieldSelector", "").split("involvedObject.name=")[-1]
                    self.send(200, {"kind": "EventList", "metadata": {},
                                    "items": api.events.get(name.split(",")[0], [])})
                    return
                if url.path != "/api/v1/nodes":
                    self.send(404, {"kind": "Status", "message": "not found"})
                    return
                with api.lock:
                    api.requests["nodes"] += 1
                    throttled = api.throttle > 0
                    api.throttle -= throttled
                    api.requests["throttled"] += throttled
                    down = False
                    if api.rounds is not None and not q.get("continue"):
                        served = api.rounds[min(api.round, len(api.rounds) - 1)]
                        api.round += 1
                        down = served is None
                        api.nodes = api.nodes if down else served
                if throttled:
                    self.send(429, {"kind": "Status", "message": "throttled"},
                              {"Retry-After": "1"})
                    return
                if down:
                    self.send(500, {"kind": "Status", "message": "etcdserver: leader changed"})
                    return
                terms = [t.partition("=") for t in q.get("labelSelector", "").split(",") if t]
                items = [n for n in api.nodes if all(
                    (k in n["metadata"]["labels"]) if not eq
                    else n["metadata"]["labels"].get(k) == v for k, eq, v in terms)]
                start = int(q.get("continue") or 0)
                limit = int(q.get("limit") or len(items) or 1)
                meta = {"resourceVersion": "1"}
                if start + limit < len(items):
                    meta["continue"] = str(start + limit)
                self.send(200, {"kind": "NodeList", "apiVersion": "v1", "metadata": meta,
                                "items": items[start:start + limit]})

            def do_PATCH(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                name = urlparse(self.path).path.rpartition("/")[2]
                with api.lock:
                    api.patches.append({"node": name, "body": body, "at": time.time()})
                    for node in api.nodes:
                        if node["metadata"]["name"] == name:
                            apply_patch(node, body)
                self.send(200, {})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        scheme = "http"
        if tls_cert is not None:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*tls_cert)
            self.server.socket = ctx.wrap_socket(self.server.socket, server_side=True)
            scheme = "https"
        self.url = f"{scheme}://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="chip-smoke-apiserver", daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def apply_patch(node: dict, body: dict) -> None:
    """A strategic-merge PATCH of ``spec.unschedulable`` and annotations, as
    the apiserver applies it (``null`` deletes a key)."""
    spec = body.get("spec") or {}
    if "unschedulable" in spec:
        if spec["unschedulable"]:
            node.setdefault("spec", {})["unschedulable"] = True
        else:
            node.setdefault("spec", {}).pop("unschedulable", None)
    for key, value in ((body.get("metadata") or {}).get("annotations") or {}).items():
        notes = node["metadata"].setdefault("annotations", {})
        if value is None:
            notes.pop(key, None)
        else:
            notes[key] = value


def kubeconfig(path: str, server: str, cluster_extra: str = "") -> str:
    """A kubeconfig with one context, ``smoke``, at ``server``."""
    with open(path, "w") as f:
        f.write("apiVersion: v1\nkind: Config\ncurrent-context: smoke\n"
                "contexts:\n- name: smoke\n  context:\n    cluster: smoke\n    user: smoke\n"
                f"clusters:\n- name: smoke\n  cluster:\n    server: {server}\n{cluster_extra}"
                "users:\n- name: smoke\n  user:\n    token: smoke-token\n")
    return path


def self_signed_cert(work: str) -> Optional[tuple]:
    """(cert, key) for 127.0.0.1 from the openssl CLI, or None without it."""
    cert, key = os.path.join(work, "cert.pem"), os.path.join(work, "key.pem")
    try:
        proc = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key, "-out", cert,
             "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
             "-addext", "subjectAltName=IP:127.0.0.1"], capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return (cert, key) if proc.returncode == 0 else None


def phase11_live_round(torch, root, rows, validate_report) -> None:
    """Phase 11: the CronJob's live round against a fake API server: the
    port's round with ``--probe`` and ``--node-events`` over 2,500 nodes,
    then the deployed argv, a throttled LIST, a dead server and TLS beside
    the JAX checker's CLI."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    host = "gke-h100-live-0"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG")}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-live-")
    gpu_labels = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                  "cloud.google.com/gke-nodepool": "h100-pool"}
    sick = {f"gke-h100-pool-{i}" for i in range(1, 1000, 100)}
    nodes = []
    for i, name in enumerate([host] + [f"gke-h100-pool-{i}" for i in range(1, 1000)]):
        node = k8s_node(name, {"nvidia.com/gpu": str(n if i == 0 else 8)}, name not in sick)
        node["metadata"]["labels"] = dict(gpu_labels)
        nodes.append(node)
    for i in range(1500):
        node = k8s_node(f"gke-cpu-pool-{i}", {}, True)
        node["metadata"]["labels"] = {"cloud.google.com/gke-nodepool": "cpu-pool"}
        nodes.append(node)
    events = {name: [
        {"type": "Warning", "reason": "NodeNotReady", "count": 3,
         "message": f"Node {name} status is now: NodeNotReady",
         "lastTimestamp": "2026-10-17T10:04:00Z"},
        {"type": "Warning", "reason": "SystemOOM", "count": 1,
         "message": "System OOM encountered, victim process: python",
         "lastTimestamp": "2026-10-17T10:03:00Z"},
        {"type": "Normal", "reason": "Starting", "count": 1, "message": "Starting kubelet.",
         "lastTimestamp": "2026-10-17T09:00:00Z"}] for name in sick}
    api = LiveApi(nodes, events)
    try:
        kc = kubeconfig(os.path.join(work, "kubeconfig"), api.url)

        # The slice's main path: the live round with this host's probe at the
        # workload level (the counts start at 0 in the fresh probe child).
        rc, payload, _, err, seconds = round_line(
            root, "port", "--kubeconfig", kc, "--probe", "--probe-level", "workload",
            "--node-events", "--strict-slices", "--json", env=env)
        local = payload.get("local_probe") or {}
        entry = next((x for x in payload.get("nodes", []) if x.get("name") == host), {})
        launches = local.get("kernel_launches") or {}
        with_events = sorted(x["name"] for x in payload.get("nodes", []) if x.get("events"))
        note = "--node-events: 2 more sick node(s) beyond the 8-node fetch cap"
        transport = payload.get("api_transport") or {}
        phase(11, "--kubeconfig K --probe --probe-level workload --node-events --strict-slices"
              " --json", exit_code=rc, seconds=seconds, ok=local.get("ok"),
              error=local.get("error"), elapsed_ms=local.get("elapsed_ms"),
              attached_to_this_node=entry.get("probe") == local,
              total_nodes=payload.get("total_nodes"), ready_nodes=payload.get("ready_nodes"),
              kernel_launches=launches, schema_violations=validate_report(local),
              nodes_with_events=len(with_events), stderr_note=note in err,
              api_transport=transport, server_requests=dict(api.requests),
              timings_ms=payload.get("timings_ms"))
        if (rc != 0 or local.get("ok") is not True or entry.get("probe") != local
                or validate_report(local)
                or payload.get("total_nodes") != 1000 or payload.get("ready_nodes") != 990):
            fail(f"the live round with --probe: exit {rc}, {local.get('error')}: {err[-2000:]}")
        check_launches("the live round with --probe", launches,
                       {r["name"]: r["launches"] for r in rows})
        if (len(with_events) != 8 or not set(with_events) <= sick or note not in err
                or transport.get("requests_sent") != 3 + 8):
            fail(f"--node-events: events on {with_events}, note {note in err}, "
                 f"transport {transport}: {err[-2000:]}")
        for r in rows:
            r["live_round_launches"] = launches[r["name"]]

        # The CronJob's own argv (deploy/cronjob.yaml), with a kubeconfig in
        # place of the pod's service account, through both CLIs.
        cron = ("--strict-slices", "--slack-only-on-error")
        lines = {
            "json": ("--kubeconfig", kc, *cron, "--json"),
            "text": ("--kubeconfig", kc, *cron),
            "--label-selector": ("--kubeconfig", kc, *cron, "--json", "--label-selector",
                                 "cloud.google.com/gke-accelerator=nvidia-h100-80gb"),
        }
        compared = {}
        for name, line in lines.items():
            port, ref = round_line(root, "port", *line, env=env), round_line(root, "jax", *line,
                                                                              env=env)
            same = (stable(port[1]) == stable(ref[1]) if port[1] is not None
                    else port[2] == ref[2])
            compared[name] = {"exit_codes": [port[0], ref[0]], "seconds": [port[4], ref[4]],
                              "equal": same,
                              "requests_sent": (port[1] or {}).get("api_transport", {})
                              .get("requests_sent")}
        phase(11, "the CronJob's argv, the port's round beside the JAX checker's", **compared)
        if (any(c["exit_codes"] != [0, 0] or not c["equal"] for c in compared.values())
                or compared["json"]["requests_sent"] != 3
                or compared["--label-selector"]["requests_sent"] != 1):
            fail(f"the CronJob's argv: {compared}")

        # A throttled apiserver: the first list request of each CLI is a 429
        # with Retry-After: 1.
        drill = {}
        for side in ("port", "jax"):
            api.throttle = 1
            got = round_line(root, side, *lines["json"], env=env)
            drill[side] = {"exit_code": got[0], "seconds": got[4], "payload": got[1]}
        by_reason = {s: (d["payload"].get("api_transport") or {}).get("retries_by_reason")
                     for s, d in drill.items()}
        phase(11, "a 429 with Retry-After: 1 on the first list request",
              exit_codes=[drill["port"]["exit_code"], drill["jax"]["exit_code"]],
              seconds=[drill["port"]["seconds"], drill["jax"]["seconds"]],
              retries_by_reason=by_reason, throttled=api.requests["throttled"],
              equal=stable(drill["port"]["payload"]) == stable(drill["jax"]["payload"]))
        if (drill["port"]["exit_code"] != 0 or drill["jax"]["exit_code"] != 0
                or by_reason["port"] != by_reason["jax"] or by_reason["port"] != {"http_429": 1}
                or stable(drill["port"]["payload"]) != stable(drill["jax"]["payload"])):
            fail(f"the throttled round: {drill}")
    finally:
        api.close()

    # A server that is not there: a closed port, under --retry-budget 2.
    dead = kubeconfig(os.path.join(work, "dead"), f"http://127.0.0.1:{free_port()}")
    got = {side: round_line(root, side, "--kubeconfig", dead, *cron, "--json",
                            "--retry-budget", "2", env=env) for side in ("port", "jax")}
    phase(11, "a closed port under --retry-budget 2",
          exit_codes=[got["port"][0], got["jax"][0]], seconds=[got["port"][4], got["jax"][4]],
          error=got["port"][1].get("error"), equal=got["port"][1] == got["jax"][1])
    if got["port"][0] != 1 or got["jax"][0] != 1 or got["port"][1] != got["jax"][1] \
            or set(got["port"][1]) != {"error"}:
        fail(f"the dead server: {got}")

    # TLS: the CronJob's round over HTTPS, the CA inline in the kubeconfig.
    cert = self_signed_cert(work)
    if cert is None:
        phase(11, "TLS", skipped="no openssl on this machine: the transport over TLS is "
              "not checked here")
    else:
        import base64
        with open(cert[0], "rb") as f:
            ca = base64.b64encode(f.read()).decode()
        api = LiveApi(nodes, events, tls_cert=cert)
        try:
            tls = kubeconfig(os.path.join(work, "tls"), api.url,
                             f"    certificate-authority-data: {ca}\n")
            port, ref = (round_line(root, side, "--kubeconfig", tls, *cron, "--json", env=env)
                         for side in ("port", "jax"))
        finally:
            api.close()
        phase(11, "the CronJob's argv over TLS with certificate-authority-data",
              exit_codes=[port[0], ref[0]], seconds=[port[4], ref[4]],
              equal=stable(port[1]) == stable(ref[1]), server=api.url)
        if port[0] != 0 or ref[0] != 0 or stable(port[1]) != stable(ref[1]):
            fail(f"the TLS round: exit {port[0]}/{ref[0]}: {port[3][-2000:]}")
    phase(11, "the live round", seconds=time.perf_counter() - t_phase)


# The CLI of the package named after the record path (the port's or the JAX
# checker's) with the argv after it, in a process that also appends to that
# record one line when each round starts and one when it ends (its seconds,
# exit code and timings; a check's probe report and its payload's cordon,
# uncordon and remediation blocks; with --watch-stream a tick's payload and
# changed nodes; with --federate a merge round's fetch counts per cluster,
# feeds and stitched upstream traces), one for each inter-round wait the
# loop asks for (the seconds, and when), and at exit the packages loaded.
# SMOKE_ROUND_PLAN may name the reports link each round first points at its
# round's directory; the round before which the lease server is stopped,
# until it refuses; "hold", with which each round first records "hold" and
# waits for the file <record>.go<n> (the script reads the APIs between
# rounds) and every wait lasts 0 s, since the holds pace the rounds; the
# stream ticks that first wait for a resourceVersion or for the stream to
# end; and a merge round's wait for its feeds to verify.  Such a wait that
# outlasts 60 s is recorded as "stalled".  With SMOKE_CLOCK set, the wall
# clock the CLI reads is pinned: that time at the first round, one second
# more each round.
WATCH_CLI_SCRIPT = """
import http.client, importlib, json, os, socket, sys, time

real_time = time.time
clock = os.environ.get("SMOKE_CLOCK")
virtual = [float(clock)] if clock else None
if virtual is not None:
    time.time = lambda: virtual[0]
record_path, package, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
checker = importlib.import_module(package + ".checker")
cli = importlib.import_module(package + ".cli")
record = open(record_path, "a")
plan = json.loads(os.environ.get("SMOKE_ROUND_PLAN") or "{}")
started = [0]


def write(**entry):
    record.write(json.dumps(dict(entry, at=real_time())) + "\\n")
    record.flush()


def next_round():
    # The round plan: the reports link, the lease server's stop, the hold.
    started[0] += 1
    n = started[0]
    if plan.get("dirs"):
        tmp = plan["link"] + ".next"
        os.symlink(plan["dirs"][min(n, len(plan["dirs"])) - 1], tmp)
        os.replace(tmp, plan["link"])
    if n == plan.get("stop_round"):
        host, port = plan["stop_url"].rsplit("/", 1)[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        conn.request("POST", "/smoke/stop", body=b"{}")
        conn.getresponse().read()
        conn.close()
        for _ in range(1000):
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
            except OSError:
                break
            time.sleep(0.01)
        write(event="lease-stopped", round=n)
    if plan.get("hold"):
        write(event="hold", round=n)
        go, deadline = f"{record_path}.go{n}", time.monotonic() + 600
        while not os.path.exists(go) and time.monotonic() < deadline:
            time.sleep(0.005)
    if virtual is not None:
        virtual[0] = float(clock) + n - 1
    return n


def until(ready, n, what):
    deadline = time.monotonic() + 60
    while not ready():
        if time.monotonic() > deadline:
            write(event="stalled", round=n, waiting_for=what)
            return
        time.sleep(0.005)


def recorded(n, trace_id, call, fields):
    write(event="start", round=n, trace_id=trace_id)
    t0 = time.perf_counter()
    try:
        out = call()
    except Exception as exc:
        write(event="end", round=n, trace_id=trace_id, seconds=time.perf_counter() - t0,
              error=str(exc))
        raise
    write(**{"event": "end", "round": n, "trace_id": trace_id,
             "seconds": time.perf_counter() - t0, **fields(out)})
    return out


check, wait_for = checker.run_check, checker._wait_for_next_round


def run_check(args, **kw):
    return recorded(next_round(), kw["tracer"].trace_id, lambda: check(args, **kw),
                    lambda result: dict(
                        exit_code=result.exit_code, timings_ms=result.payload.get("timings_ms"),
                        probe=result.local_probe, blocks={k: result.payload[k] for k in (
                            "cordon", "uncordon", "remediation") if k in result.payload}))


def wait(stop, seconds):
    write(event="wait", seconds=seconds)
    return wait_for(stop, 0.0 if plan.get("hold") else seconds)


checker.run_check, checker._wait_for_next_round = run_check, wait
if "--watch-stream" in argv:
    watchstream = importlib.import_module(package + ".watchstream")
    tick = watchstream.StreamRoundEngine.tick

    def stream_tick(self, tracer=None):
        n = next_round()
        want = plan.get("ticks", {}).get(str(n), {})
        if "rv" in want:
            until(lambda: self.cache.resource_version == want["rv"], n, want)
        if want.get("ended"):
            until(lambda: not self.stream_alive(), n, want)
        return recorded(n, tracer.trace_id if tracer is not None else None,
                        lambda: tick(self, tracer=tracer), lambda out: dict(
                            exit_code=out[0].exit_code,
                            timings_ms=out[0].payload.get("timings_ms"),
                            changed=None if out[1] is None else sorted(out[1]),
                            payload=out[0].payload))

    watchstream.StreamRoundEngine.tick = stream_tick
if "--federate" in argv:
    aggregator = importlib.import_module(package + ".federation.aggregator")
    merge_round = aggregator.FederationEngine.round

    def federation_round(self, server=None):
        n = next_round()
        if plan.get("await_feeds") and n > 1:
            until(lambda: len(self._feeds) == len(self.views) and all(
                c._state is not None for c in self._feeds.values()), n, "feeds")
        return recorded(n, None, lambda: merge_round(self, server), lambda snap: dict(
            trace_id=self.last_tracer.trace_id, round_ms=self.last_round_ms,
            timings_ms=self.last_tracer.as_dict(),
            fetch={k: [v.fetch_fresh, v.fetch_not_modified, v.fetch_errors]
                   for k, v in sorted(self.views.items())},
            feeds={k: c._state is not None for k, c in sorted(self._feeds.items())},
            upstream_traces={k: v.upstream_trace for k, v in sorted(self.views.items())}))

    aggregator.FederationEngine.round = federation_round
rc = cli.main(argv)
write(event="exit", exit_code=rc, packages=sorted({m.split(".")[0] for m in sys.modules} & {
    "jax", "jaxlib", "tpu_node_checker", "tpu_node_checker_torch"}))
sys.exit(rc)
"""


def watch_fleet(host: str, n: int, sick: set) -> list:
    """The aggregator's fleet: this host with its cards, 999 more H100 nodes
    of 8 cards, the ``sick`` ones NotReady (one LIST page of 1,000)."""
    labels = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
              "cloud.google.com/gke-nodepool": "h100-pool"}
    nodes = []
    for i, name in enumerate([host] + [f"gke-h100-pool-{i}" for i in range(1, 1000)]):
        node = k8s_node(name, {"nvidia.com/gpu": str(n if i == 0 else 8)}, name not in sick)
        node["metadata"]["labels"] = dict(labels)
        nodes.append(node)
    return nodes


def read_jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines() if x.strip()]


PHASE12_SCRAPES = ((2, "after round 2"), (6, "breaker open, after round 6"))


def watch_run(root: str, side: str, api, script: Optional[list], argv: list, env: dict,
              work: str, sigterm_at: int = 9, scrape_at: tuple = PHASE12_SCRAPES) -> dict:
    """One run of a loop (``side`` "port" or "jax") over ``script``, through
    WATCH_CLI_SCRIPT: the server answers the n-th node LIST with
    ``script[n]`` (None is a 500; no script serves the server's nodes).
    ``/metrics`` is read after each round ``scrape_at`` names (phase 12:
    after the second round's line and after the breaker opens); SIGTERM goes
    as check ``sigterm_at`` starts.  The history starts from ``seed.jsonl``
    beside ``work`` where there is one.  Returns what the run printed, logged
    and served."""
    os.makedirs(work)
    paths = {k: os.path.join(work, f) for k, f in (
        ("log", "rounds.jsonl"), ("events", "events.jsonl"), ("record", "record.jsonl"),
        ("out", "stdout.txt"), ("err", "stderr.txt"), ("history", "history.jsonl"))}
    seed = os.path.join(os.path.dirname(work), "seed.jsonl")
    if os.path.exists(seed):
        with open(seed, "rb") as f, open(paths["history"], "wb") as g:
            g.write(f.read())
    package = "tpu_node_checker_torch" if side == "port" else "tpu_node_checker"
    cmd = [sys.executable, "-c", WATCH_CLI_SCRIPT, paths["record"], package,
           *(a.replace("{dir}", work) for a in argv)]
    with api.lock:
        api.rounds, api.round = script, 0
    scrapes, out = [], {}
    t0 = time.perf_counter()
    with open(paths["out"], "w") as fo, open(paths["err"], "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, cwd=root, env=env)
        try:
            deadline, port = time.perf_counter() + 600, None
            while time.perf_counter() < deadline and proc.poll() is None:
                if port is None:
                    with open(paths["err"]) as f:
                        m = re.search(r"Serving /metrics on port (\d+)", f.read())
                    port = int(m.group(1)) if m else None
                lines = read_jsonl(paths["log"])
                if port is not None and len(scrapes) < len(scrape_at):
                    after, label = scrape_at[len(scrapes)]
                    if len(lines) >= after:
                        scrapes.append((label, http_get(port)))
                starts = [r for r in read_jsonl(paths["record"]) if r["event"] == "start"]
                if len(starts) >= sigterm_at:
                    break
                time.sleep(0.01)
            else:
                fail(f"the {side} loop ended or stalled before its last round "
                     f"(exit {proc.poll()}): {open(paths['err']).read()[-2000:]}")
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out["exit_code"] = proc.wait(timeout=120)
            out["sigterm_to_exit_s"] = time.perf_counter() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    with api.lock:
        api.rounds = None
    out["log"] = read_jsonl(paths["log"])
    out["events"] = read_jsonl(paths["events"])
    out["record"] = read_jsonl(paths["record"])
    out["scrapes"] = scrapes
    with open(paths["err"]) as f:
        out["stderr"] = f.read().splitlines()
    return out


def phase12_watch_loop(torch, root, rows, validate_report) -> None:
    """Phase 12: the aggregator Deployment's loop, with this host's probe
    every round, against a fake API server whose fleet the script changes
    between rounds; then the same script without the probe through the port
    and through the JAX checker's CLI."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    host, a, b = "gke-h100-watch-0", "gke-h100-pool-100", "gke-h100-pool-200"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG")}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-watch-")
    fleets = {k: watch_fleet(host, n, s) for k, s in (("a", {a}), ("b", {b}))}
    # Round 1 healthy (a was FAILED before the loop started), round 2 the
    # same, round 3 a swapped for b under the same exit code, rounds 4-7 a
    # 500 each (the breaker opens at the third), then healed.
    script = [fleets["a"], fleets["a"], fleets["b"], None, None, None, None, fleets["b"]]
    api = LiveApi(fleets["a"], {})
    try:
        kc = kubeconfig(os.path.join(work, "kubeconfig"), api.url)
        # The history the loop starts from: a failed two rounds in a row.
        seed = os.path.join(work, "seed.jsonl")
        for _ in range(2):
            rc, *_ = round_line(root, "port", "--kubeconfig", kc, "--history", seed,
                                "--cordon-after", "2", "--uncordon-after", "3", env=env)
            if rc != 0:
                fail(f"seeding the loop's history: exit {rc}")
        results = os.path.join(work, "reports")
        os.mkdir(results)
        argv = ["--kubeconfig", kc, "--watch", "1", "--strict-slices", "--probe-results",
                results, "--probe-results-required", "--slack-on-change", "--metrics-port", "0",
                "--log-jsonl", "{dir}/rounds.jsonl", "--history", "{dir}/history.jsonl",
                "--cordon-after", "2", "--uncordon-after", "3", "--event-log",
                "{dir}/events.jsonl", "--retry-budget", "0"]
        probe = ["--probe", "--probe-level", "workload"]
        runs, posts_of = {}, {}
        with webhook() as (url, posts):
            for name, side, extra in (("probed", "port", probe), ("port", "port", []),
                                      ("jax", "jax", [])):
                start = len(posts)
                runs[name] = watch_run(root, side, api, script, argv + extra,
                                       dict(env, SLACK_WEBHOOK_URL=url),
                                       os.path.join(work, name))
                posts_of[name] = [p[2]["text"].rsplit("\n`trace: ", 1)[0]
                                  for p in posts[start:]]
    finally:
        api.close()

    # The probed run: each round's check, the waits and the gaps.
    run = runs["probed"]
    ends = [r for r in run["record"] if r["event"] == "end"]
    starts = [r for r in run["record"] if r["event"] == "start"]
    waits = [r for r in run["record"] if r["event"] == "wait"]
    probed = [r for r in ends if r.get("probe")]
    per_round = []
    for r in ends:
        entry = {"seconds": r["seconds"], "exit_code": r.get("exit_code"),
                 "error": r.get("error")}
        if r.get("probe"):
            p = r["probe"]
            entry.update(probe_ok=p.get("ok"), probe_error=p.get("error"),
                         kernel_launches=p.get("kernel_launches"),
                         kernels_match_plain={k: p.get(k) for k in (
                             "pallas_ok", "dma_ok", "flash_attention_ok", "int8_ok")},
                         schema_violations=validate_report(p),
                         timings_ms=r.get("timings_ms"))
        per_round.append(entry)
    gaps = [s2["at"] - s1["at"] for s1, s2 in zip(starts, starts[1:])]
    # After each check: render, Slack, the trace's completion, the scrape's
    # update and the log line, up to the loop's wait.
    after_check_ms = [(w["at"] - e["at"]) * 1e3 for e, w in zip(ends, waits)]
    phase(12, "the aggregator's --watch 1 loop with --probe --probe-level workload",
          exit_code=run["exit_code"], rounds=per_round, waits_asked_s=[w["seconds"] for w in waits],
          gap_between_round_starts_s=gaps, after_check_ms=after_check_ms,
          sigterm_to_exit_s=run["sigterm_to_exit_s"], seconds=run["seconds"])
    bad = [i + 1 for i, r in enumerate(ends) if r.get("probe") and (
        r["probe"].get("ok") is not True or validate_report(r["probe"])
        or not all(r["probe"].get(k) is True for k in ("pallas_ok", "dma_ok",
                                                         "flash_attention_ok", "int8_ok")))]
    if len(probed) != 5 or bad:
        fail(f"the probed loop: {len(probed)} rounds probed, rounds {bad} not healthy: "
             f"{run['stderr'][-20:]}")
    for i, e in enumerate(probed):
        check_launches(f"the probed loop's round {i + 1}", e["probe"].get("kernel_launches"),
                       {r["name"]: r["launches"] for r in rows})
    for r in rows:
        r["watch_launches"] = [e["probe"]["kernel_launches"][r["name"]] for e in probed]
    if any(w["seconds"] != 0.0 for w, e in zip(waits, ends) if e.get("probe")):
        fail(f"a probed round outlasts the 1 s interval, yet the loop waited: {waits}")

    # What every run must show, and the three runs side by side: the rounds
    # of the script and the one SIGTERM lands in, the waits of 1, 1, 2 and
    # 4 s after the four failures, and no package but its own loaded.
    seen = {}
    own = {"probed": "tpu_node_checker_torch", "port": "tpu_node_checker_torch",
           "jax": "tpu_node_checker"}
    for name, run in runs.items():
        rounds = len(run["log"])
        events = [(e["event"], e.get("node")) for e in run["events"]]
        record = run["record"]
        ends = [r for r in record if r["event"] == "end"]
        starts = [r["at"] for r in record if r["event"] == "start"]
        exit_line = next((r for r in record if r["event"] == "exit"), {})
        stderr = run["stderr"]
        got = {
            "exit_code": run["exit_code"], "rounds": rounds,
            "log_exit_codes": [x["exit_code"] for x in run["log"]],
            "log_keys": sorted({k for x in run["log"] for k in x}),
            "posts": posts_of[name], "events": events,
            "events_with_their_rounds_trace_id": all(
                e.get("trace_id") in {r["trace_id"] for r in ends} for e in run["events"]),
            "stderr_checks": {
                "sick-node set": sum("State change: sick-node set [('gke-h100-pool-100', "
                                     "'FAILED')] → [] (exit 0 unchanged)" in x for x in stderr),
                "check round failed": sum(x.startswith("Check round failed: ") for x in stderr),
                "breaker open": sum(x.startswith("Watch breaker OPEN") for x in stderr),
                "recovered": sum(x.startswith("Monitor recovered") for x in stderr),
                "sigterm": sum(x.startswith("SIGTERM: watch loop stopped cleanly") for x in stderr),
            },
            "round_seconds": [r["seconds"] for r in ends],
            "gap_between_round_starts_s": [b - a for a, b in zip(starts, starts[1:])],
            "sigterm_to_exit_s": run["sigterm_to_exit_s"],
            "packages_loaded": exit_line.get("packages"),
        }
        scraped = {}
        for label, (status, _, body, ms) in run["scrapes"]:
            s = samples(body)
            scraped[label] = {
                "status": status, "ms": ms,
                "fleet": s.get('tpu_node_checker_nodes{state="total"}'),
                "breaker_open": s.get("tpu_node_checker_watch_breaker_open"),
                "phases": sorted({k.split('phase="')[1].split('"')[0] for k in s
                                  if k.startswith("tpu_node_checker_round_phase_duration_ms_count")}),
                "probe_ok": next((v for k, v in s.items()
                                  if k.startswith("tpu_node_checker_probe_ok{")), None),
                "probe_matmul_tflops": s.get("tpu_node_checker_probe_matmul_tflops"),
            }
        got["scrapes"] = scraped
        seen[name] = got
        phase(12, f"the loop's script, {name} run",
              **dict(got, posts=[p.splitlines()[0] for p in got["posts"]]))
        failure_gaps = got["gap_between_round_starts_s"][3:7]
        if (got["exit_code"] != 143 or rounds != 9 or len(ends) != 9
                or got["log_exit_codes"] != [0, 0, 0, 1, 1, 1, 1, 0, 0]
                or len(got["posts"]) != 7
                or "FAILED to run" not in got["posts"][2] or "DEGRADED" not in got["posts"][3]
                or "RECOVERED" not in got["posts"][4]
                or events != [("breaker-opened", None), ("breaker-closed", None),
                              ("fsm-transition", b), ("fsm-transition", a)]
                or not got["events_with_their_rounds_trace_id"]
                or got["stderr_checks"] != {"sick-node set": 1, "check round failed": 4,
                                            "breaker open": 2, "recovered": 1, "sigterm": 1}
                or len(failure_gaps) != 4
                or any(abs(g - x) > 0.5 for g, x in zip(failure_gaps, (1, 1, 2, 4)))
                or got["sigterm_to_exit_s"] > 30 or got["packages_loaded"] != [own[name]]
                or len(scraped) != 2 or scraped["after round 2"]["fleet"] != 1000
                or scraped["after round 2"]["breaker_open"] != 0.0
                or scraped["breaker open, after round 6"]["breaker_open"] != 1.0
                or "list" not in scraped["after round 2"]["phases"]
                or (name == "probed") != (scraped["after round 2"]["probe_ok"] == 1.0)):
            fail(f"the {name} loop: {got}")
    same = {k: seen["port"][k] == seen["jax"][k] for k in (
        "exit_code", "rounds", "log_exit_codes", "log_keys", "posts", "events")}
    phase(12, "the port's loop without --probe beside the JAX checker's", **same,
          jax_installed=importlib.util.find_spec("jax") is not None,
          packages_loaded={k: seen[k]["packages_loaded"] for k in ("port", "jax")})
    if not all(same.values()):
        fail(f"the port's loop unlike the JAX checker's: {same}")
    phase(12, "the aggregator's loop", seconds=time.perf_counter() - t_phase)


class LeaseServer:
    """The federation aggregator's lease endpoint, served from a thread:
    ``POST /api/v1/global/disruption-lease`` answered as the JAX fleet API
    answers it (``server/app.py`` ``_post_lease``) over the port's own
    ``FleetLeaseBudget``; ``POST /smoke/stop`` stops it (the aggregator
    dies): the port refuses connections and the kept-alive ones are cut."""

    def __init__(self, port: int, budget: int, window_s: Optional[float]):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from tpu_node_checker_torch.remediation.budget import FleetLeaseBudget

        self.fleet = FleetLeaseBudget(budget, window_s)
        self.requests, self.stopped, self.conns = [], threading.Event(), []
        lease = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                lease.conns.append(self.connection)

            def send(self, status: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — the handler protocol's name
                raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if self.path == "/smoke/stop":
                    self.send(200, {})
                    threading.Thread(target=lease.close, daemon=True).start()
                    return
                if self.path != "/api/v1/global/disruption-lease":
                    self.send(404, {"error": "not found"})
                    return
                try:
                    body = json.loads(raw) if raw else {}
                    if not isinstance(body, dict):
                        raise ValueError("lease request must be a JSON object")
                except ValueError as exc:
                    self.send(400, {"error": f"bad lease request: {exc}"})
                    return
                status, resp = lease.fleet.grant(body)
                lease.requests.append({"body": {k: v for k, v in body.items()
                                                if k != "trace_id"},
                                       "status": status, "response": resp})
                self.send(status, resp)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="chip-smoke-lease", daemon=True)
        self.thread.start()

    def close(self) -> None:
        if not self.stopped.is_set():
            self.stopped.set()
            self.server.shutdown()
            self.server.server_close()
            for conn in self.conns:
                with contextlib.suppress(OSError):
                    conn.shutdown(socket.SHUT_RDWR)


QUARANTINE_ANNOTATION = "tpu-node-checker.io/quarantined"


def masked_patches(patches: list) -> list:
    """PATCH bodies as sent, the quarantine annotation's timestamp masked."""
    out = []
    for p in patches:
        body = json.loads(json.dumps(p["body"]))
        notes = (body.get("metadata") or {}).get("annotations") or {}
        if notes.get(QUARANTINE_ANNOTATION) is not None:
            notes[QUARANTINE_ANNOTATION] = "<ts>"
        out.append({"node": p["node"], "body": body})
    return out


def phase13_quarantine(torch, root, rows, validate_report) -> dict:
    """Phase 13: the aggregator's quarantine, graded on reports that the
    port's emitter writes on this card: the Deployment's --watch loop with
    --cordon-failed --uncordon-recovered and the budget engine, against the
    fake API server (which applies each PATCH) and a lease server, through
    the port and through the JAX checker's CLI; then the trend readers."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    host = "gke-h100-host-0"
    # The storm: three nodes failing with this host.  The candidates follow
    # the LIST's order, where this host comes first, so it takes the one
    # cordon --cordon-max (default 1) grants.
    storm = ["gke-h100-pool-101", "gke-h100-pool-102", "gke-h100-pool-103"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "SMOKE_ROUND_PLAN")}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-quarantine-")

    # 1. The reports, each written by the port's emitter on this card: this
    # host healthy (compute) and its t1 drill (collective), and the storm
    # nodes' drills; at most four at once.
    drill = ("--probe-topology", "1x1", "--probe-level", "collective")
    emits = {"healthy": (host, ("--probe-level", "compute"), "0")}
    emits.update({f"drill {name}": (name, drill, "t1") for name in [host] + storm})
    paths = {}
    for key, (name, _, _) in emits.items():
        os.makedirs(os.path.join(work, "emits", key.replace(" ", "-")))
        paths[key] = os.path.join(work, "emits", key.replace(" ", "-"), f"{name}.json")

    def emit(key):
        name, args, axis = emits[key]
        e = dict(env, NODE_NAME=name)
        if axis != "0":
            e["TNC_CHAOS_AXIS"] = axis
        t0 = time.perf_counter()
        proc = port_cli(root, "--emit-probe", paths[key], *args, env=e)
        return proc.returncode, time.perf_counter() - t0, proc.stderr

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        done = dict(zip(emits, pool.map(emit, emits)))
    reports, per_emit = {}, {}
    for key, (rc, seconds, err) in done.items():
        try:
            with open(paths[key]) as f:
                reports[key] = json.load(f)
        except (OSError, json.JSONDecodeError):
            fail(f"the emit {key} wrote no report (exit {rc}): {err[-2000:]}")
        doc = reports[key]
        per_emit[key] = dict(
            exit_code=rc, seconds=seconds, ok=doc.get("ok"), level=doc.get("level"),
            hostname=doc.get("hostname"), error=doc.get("error"),
            kernel_launches=doc.get("kernel_launches"),
            kernels_match_plain={k: doc.get(k) for k in ("pallas_ok", "dma_ok",
                                                         "flash_attention_ok", "int8_ok")},
            schema_violations=validate_report(doc))
    phase(13, "the reports, written by the port's emitter, four at once", reports=per_emit,
          seconds=time.perf_counter() - t0)
    for key, e in per_emit.items():
        if (e["exit_code"] != (0 if key == "healthy" else 3) or e["schema_violations"]
                or e["hostname"] != emits[key][0]
                or not all(v is True for v in e["kernels_match_plain"].values())):
            fail(f"the emit {key}: {e}")
        check_launches(f"the emit {key}", e["kernel_launches"],
                       {r["name"]: r["compute_launches"] for r in rows} if key == "healthy"
                       else None)
    for r in rows:
        r["quarantine_launches"] = {k: e["kernel_launches"][r["name"]]
                                    for k, e in per_emit.items()}

    # The rounds' report directories: healthy (this host's healthy report),
    # the drill (this host's and the storm's drills), and the storm alone
    # (this host healthy).
    rounds_dirs = {}
    for name, keys in (("healthy", ["healthy"]),
                       ("drill", [f"drill {x}" for x in [host] + storm]),
                       ("storm", ["healthy"] + [f"drill {x}" for x in storm])):
        d = rounds_dirs[name] = os.path.join(work, "rounds", name)
        os.makedirs(d)
        for key in keys:
            with open(os.path.join(d, os.path.basename(paths[key])), "w") as f:
                json.dump(reports[key], f)
    # 1 healthy; 2-3 the drills (FAILED at 3 under --cordon-after 2); 4-6
    # healthy (HEALTHY again at 6 under --uncordon-after 3); 7-8 the storm
    # alone, FAILED again at 8 with the lease server stopped; 9 as 8, the
    # round SIGTERM lands in.
    plan_rounds = ["healthy", "drill", "drill", "healthy", "healthy", "healthy",
                   "storm", "storm"]
    link = os.path.join(work, "reports")
    os.symlink(rounds_dirs["healthy"], link)
    fleet = watch_fleet(host, n, set())
    lease_port = free_port()
    argv = ["--kubeconfig", None, "--watch", "1", "--strict-slices", "--probe-results", link,
            "--probe-results-required", "--slack-on-change", "--metrics-port", "0",
            "--log-jsonl", "{dir}/rounds.jsonl", "--history", "{dir}/history.jsonl",
            "--cordon-after", "2", "--uncordon-after", "3", "--disruption-budget", "2/10m",
            "--slice-floor-pct", "90", "--disruption-lease", f"http://127.0.0.1:{lease_port}",
            "--cordon-failed", "--uncordon-recovered", "--event-log", "{dir}/events.jsonl"]
    scrape_at = ((3, "after round 3"), (6, "after round 6"), (8, "after round 8"))
    runs, posts_of, patches_of, leases_of = {}, {}, {}, {}
    with webhook() as (url, posts):
        for side in ("port", "jax"):
            api = LiveApi(json.loads(json.dumps(fleet)), {})
            # The fleet budget: one actuation per 10 minutes, so the
            # allowance left after round 3's lease is 0.
            lease = LeaseServer(lease_port, 1, 600.0)
            try:
                argv[1] = kubeconfig(os.path.join(work, f"kubeconfig-{side}"), api.url)
                plan = {"link": link, "dirs": [rounds_dirs[k] for k in plan_rounds],
                        "stop_round": 8, "stop_url": lease.url}
                start = len(posts)
                runs[side] = watch_run(root, side, api, None, argv,
                                       dict(env, SLACK_WEBHOOK_URL=url,
                                            SMOKE_ROUND_PLAN=json.dumps(plan)),
                                       os.path.join(work, side), sigterm_at=9,
                                       scrape_at=scrape_at)
                posts_of[side] = [p[2]["text"].rsplit("\n`trace: ", 1)[0]
                                  for p in posts[start:]]
                with api.lock:
                    patches_of[side] = list(api.patches)
                leases_of[side] = list(lease.requests)
            finally:
                lease.close()
                api.close()

    # 2-4. What each run did, round by round.
    seen = {}
    for side, run in runs.items():
        record = run["record"]
        ends = [r for r in record if r["event"] == "end"]
        starts = [r for r in record if r["event"] == "start"]
        exit_line = next((r for r in record if r["event"] == "exit"), {})
        stopped = next((r for r in record if r["event"] == "lease-stopped"), {})
        blocks = [r.get("blocks") or {} for r in ends]
        # The round each PATCH landed in: the last check that started before it.
        patch_rounds = [sum(1 for s_ in starts if s_["at"] <= p["at"]) for p in patches_of[side]]
        scraped = {}
        for label, (status, _, body, ms) in run["scrapes"]:
            scraped[label] = {"status": status, "ms": ms, "remediation": [
                line for line in body.decode().splitlines()
                if line.startswith("tpu_node_checker_remediation")]}
        got = {
            "exit_code": run["exit_code"], "rounds": len(ends),
            "round_exit_codes": [r.get("exit_code") for r in ends],
            "round_seconds": [r["seconds"] for r in ends],
            "timings_ms": [r.get("timings_ms") for r in ends],
            "patches": masked_patches(patches_of[side]), "patch_rounds": patch_rounds,
            "cordon": [b.get("cordon") for b in blocks],
            "uncordon": [b.get("uncordon") for b in blocks],
            "remediation": [b.get("remediation") for b in blocks],
            "posts": posts_of[side],
            "events": [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
                       for e in run["events"]],
            "lease_requests": leases_of[side], "lease_stopped_before_round": stopped.get("round"),
            "scrapes": scraped, "sigterm_to_exit_s": run["sigterm_to_exit_s"],
            "seconds": run["seconds"], "packages_loaded": exit_line.get("packages"),
        }
        seen[side] = got
        phase(13, f"the Deployment's loop with the quarantine, {side} run", **{
            k: v for k, v in got.items()
            if k not in ("cordon", "uncordon", "remediation", "posts", "events", "timings_ms")},
            cordon_by_round=[(b or {}).get("cordoned") for b in got["cordon"]],
            uncordon_by_round=[(b or {}).get("uncordoned") for b in got["uncordon"]],
            denied_total_by_round=[(b or {}).get("denied_total") for b in got["remediation"]],
            posts=[p.splitlines() for p in got["posts"]], events=got["events"])
        phase(13, f"each round's timings_ms, {side} run", rounds=got["timings_ms"])

    port = seen["port"]
    rem = port["remediation"]
    storm_denials = [d for d in (rem[2] or {}).get("denials", [])]
    cordon_posts = [p for p in port["posts"] if "[cordon-max]" in p]
    lease_after = (rem[7] or {}).get("lease") or {}
    checks = {
        "exit 143 after nine rounds": port["exit_code"] == 143 and port["rounds"] == 9,
        "rounds exit 0": port["round_exit_codes"] == [0] * 9,
        "cordon phase timed": all("cordon" in (t or {}) for t in port["timings_ms"]),
        "one cordon of this host at round 3, one uncordon after round 6": (
            [(p["node"], p["body"].get("spec")) for p in port["patches"]]
            == [(host, {"unschedulable": True}), (host, {"unschedulable": False})]
            and port["patch_rounds"] == [3, 6]
            and port["patches"][0]["body"]["metadata"]["annotations"]
            == {QUARANTINE_ANNOTATION: "<ts>"}
            and port["patches"][1]["body"]["metadata"]["annotations"]
            == {QUARANTINE_ANNOTATION: None}),
        "cordon block at round 3": (port["cordon"][2] or {}).get("cordoned") == [host],
        "uncordon block at round 6": (port["uncordon"][5] or {}).get("uncordoned") == [host],
        "the storm denied by --cordon-max": (
            sorted(d["node"] for d in storm_denials) == storm
            and {d["reason"] for d in storm_denials} == {"cordon-max"}),
        "the storm's denials in one post": len(cordon_posts) == 1 and all(
            f"`{name}`" in cordon_posts[0] for name in storm),
        "one lease granted, at round 3": (
            [(r["status"], r["body"].get("node")) for r in port["lease_requests"]]
            == [(200, host)] and (rem[2] or {}).get("lease", {}).get("granted") == 1),
        "lease stopped before round 8": port["lease_stopped_before_round"] == 8,
        "the fallback grants no more than the last lease left (0)": (
            (rem[7] or {}).get("denied_total", {}).get("lease-unreachable") == 3
            and lease_after.get("fleet_remaining") == 0 and "unreachable" in lease_after
            and ((rem[7] or {}).get("budget") or {}).get("remaining") == 1
            and port["patch_rounds"] == [3, 6]),
        "scrapes": len(port["scrapes"]) == 3 and all(
            s["status"] == 200 for s in port["scrapes"].values()),
        "only its own package": port["packages_loaded"] == ["tpu_node_checker_torch"],
    }
    phase(13, "the port's quarantine", **checks)
    if not all(checks.values()):
        fail(f"the port's quarantine: {[k for k, v in checks.items() if not v]}")

    # 5. The JAX checker's CLI on the same rounds, reports and servers.
    same = {k: seen["port"][k] == seen["jax"][k] for k in (
        "exit_code", "round_exit_codes", "patches", "patch_rounds", "cordon", "uncordon",
        "remediation", "posts", "events", "lease_requests")}
    same["scrapes"] = ({k: v["remediation"] for k, v in seen["port"]["scrapes"].items()}
                       == {k: v["remediation"] for k, v in seen["jax"]["scrapes"].items()})
    phase(13, "the port's quarantine beside the JAX checker's", **same,
          packages_loaded={k: seen[k]["packages_loaded"] for k in seen})
    if not all(same.values()) or seen["jax"]["packages_loaded"] != ["tpu_node_checker"]:
        fail(f"the port's quarantine unlike the JAX checker's: {same}")

    # 6. The post-incident readers on the port's log and store.
    log = os.path.join(work, "port", "rounds.jsonl")
    store = os.path.join(work, "port", "history.jsonl")
    readers = {}
    for args in (("--trend", log), ("--trend", log, "--json"), ("--trend-nodes", store),
                 ("--trend-nodes", store, "--json")):
        out = {}
        for side in ("port", "jax"):
            rc, _, stdout, err, seconds = round_line(root, side, *args, env=env)
            out[side] = (rc, stdout, seconds)
        readers[" ".join(args).replace(work, "W")] = dict(
            exit_codes=[out["port"][0], out["jax"][0]], equal=out["port"][:2] == out["jax"][:2],
            seconds=[out["port"][2], out["jax"][2]], lines=len(out["port"][1].splitlines()))
    nodes_doc = json.loads(round_line(root, "port", "--trend-nodes", store, "--json",
                                      env=env)[2])
    phase(13, "--trend and --trend-nodes through both CLIs", **readers,
          worst_offenders=nodes_doc.get("worst_offenders"),
          this_host=(nodes_doc.get("nodes") or {}).get(host))
    if not all(r["equal"] and r["exit_codes"] == [0, 0] for r in readers.values()):
        fail(f"the readers: {readers}")
    phase(13, "the quarantine", seconds=time.perf_counter() - t_phase,
          patches=len(seen["port"]["patches"]),
          metrics_get_ms=[s["ms"] for s in seen["port"]["scrapes"].values()])
    return {"host": host, "reports": {"healthy": reports["healthy"],
                                      "drill": reports[f"drill {host}"]}}


# Phase 14's masks between the port's fleet API and the JAX checker's, each
# a random id or a wall time of the round: the trace id (in bodies, and the
# X-TNC-Trace header, which is not compared), the round's timings_ms, a
# debug round's total_ms, the round_ms sketch (its samples are round
# durations), and on /metrics the duration, latency and timestamp samples.
# The wall clock the two CLIs read is pinned (SMOKE_CLOCK), so every other
# timestamp is compared.
SERVE_MASKED_KEYS = ("trace_id", "timings_ms", "total_ms")
SERVE_MASKED_SKETCHES = ("round_ms",)
SERVE_WALL_SAMPLES = re.compile(r"^tpu_node_checker_\w*(duration_ms|latency\w*|_seconds)"
                                r"(_bucket|_sum|_count)?[{ ]")
SERVE_TOKEN = "chip-smoke-serve-token"


def serve_masked(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in SERVE_MASKED_KEYS or (
            k in SERVE_MASKED_SKETCHES and isinstance(v, dict)) else serve_masked(v)
            for k, v in obj.items()}
    if isinstance(obj, list):
        return [serve_masked(v) for v in obj]
    return obj


def served(path: str, status: int, headers: dict, body: bytes) -> tuple:
    """What of one fleet-API exchange must equal the JAX checker's."""
    if path == "/metrics":
        text = [x for x in body.decode().splitlines() if not SERVE_WALL_SAMPLES.match(x)]
    else:
        text = serve_masked(json.loads(body)) if body else None
    kept = {k: v for k, v in headers.items()
            if k in ("Content-Type", "X-TNC-Round", "Retry-After", "WWW-Authenticate")}
    return status, kept, text


def percentiles(ms: list) -> dict:
    ms = sorted(ms)
    return {"p50": ms[len(ms) // 2], "p99": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
            "max": ms[-1], "n": len(ms)}


def read_fleet_api(port: int, host: str) -> dict:
    """Every route once after a round, then a 304 for the summary's ETag,
    gzip and HEAD of the nodes collection; each exchange's time."""
    paths = ["/healthz", "/readyz", "/api/v1/summary", "/api/v1/nodes",
             f"/api/v1/nodes/{host}", "/api/v1/slices", "/api/v1/trend",
             "/api/v1/remediation", "/api/v1/analytics/slo", "/api/v1/analytics/offenders",
             "/api/v1/analytics/flaps", "/api/v1/debug/rounds",
             "/api/v1/watch?since=&timeout=0", "/metrics", "/api/v1/nope"]
    got = {p: http_get(port, p) for p in paths}
    headers = got["/api/v1/summary"][1]
    s304, h304, b304, _ = http_get(port, "/api/v1/summary",
                                   headers={"If-None-Match": headers.get("ETag", "")})
    sgz, hgz, bgz, _ = http_get(port, "/api/v1/nodes", headers={"Accept-Encoding": "gzip"})
    shead, hhead, bhead, _ = http_get(port, "/api/v1/nodes", method="HEAD")
    nodes_body = got["/api/v1/nodes"][2]
    return {
        "exchanges": {p: served(p, s, h, b) for p, (s, h, b, _) in got.items()},
        "ms": {p: r[3] for p, r in got.items()},
        "round": headers.get("X-TNC-Round"),
        "304": s304 == 304 and b304 == b"" and h304.get("ETag") == headers.get("ETag"),
        "gzip": sgz == 200 and hgz.get("Content-Encoding") == "gzip"
        and gzip.decompress(bgz) == nodes_body,
        "head": shead == 200 and bhead == b"" and hhead.get("Content-Length") == str(
            len(nodes_body)),
    }


def write_burst(port: int, host: str) -> list:
    """Dry-run cordons: no bearer, a wrong one, then 8 with the token."""
    path = f"/api/v1/nodes/{host}/cordon?dry_run=1"
    out = [served(path, *http_get(port, path, "POST")[:3]),
           served(path, *http_get(port, path, "POST",
                                  {"Authorization": "Bearer wrong"})[:3])]
    for _ in range(8):
        out.append(served(path, *http_get(port, path, "POST",
                                          {"Authorization": f"Bearer {SERVE_TOKEN}"})[:3]))
    return out


def fleet_api_timings(port: int) -> dict:
    """200 GETs of the nodes collection, each on a new connection (the
    kernel spreads them over the accept loops), then 200 for its ETag; and
    the publish span of every round in the debug ring."""
    _, headers, body, _ = http_get(port, "/api/v1/nodes")
    full, cached, same = [], [], True
    for _ in range(200):
        s, _, b, ms = http_get(port, "/api/v1/nodes")
        full.append(ms)
        same &= s == 200 and b == body
    for _ in range(200):
        s, _, b, ms = http_get(port, "/api/v1/nodes", headers={"If-None-Match": headers["ETag"]})
        cached.append(ms)
        same &= s == 304 and b == b""
    publish = []
    rounds = json.loads(http_get(port, "/api/v1/debug/rounds")[2])["rounds"]
    for r in rounds:
        doc = json.loads(http_get(port, f"/api/v1/debug/rounds/{r['trace_id']}")[2])
        publish += [e["dur"] / 1e3 for e in doc["traceEvents"]
                    if e.get("ph") == "X" and e.get("name") == "publish"]
    return {"nodes_bytes": len(body), "get_ms": percentiles(full),
            "not_modified_ms": percentiles(cached), "all_200_then_304": same,
            "publish_ms": publish}


class HeldCli:
    """One CLI process (``side`` "port" or "jax") through WATCH_CLI_SCRIPT
    with the "hold" plan in ``env``: its rounds released one at a time, its
    record read as it grows.  Its files are ``work/<name>.*``."""

    def __init__(self, root: str, side: str, name: str, argv: list, env: dict, work: str):
        self.name, self.side = name, side
        self.record = os.path.join(work, f"{name}.record.jsonl")
        self.err = os.path.join(work, f"{name}.stderr.txt")
        self.lines, self._offset = [], 0
        package = "tpu_node_checker_torch" if side == "port" else "tpu_node_checker"
        with open(os.path.join(work, f"{name}.stdout.txt"), "w") as fo, \
                open(self.err, "w") as fe:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", WATCH_CLI_SCRIPT, self.record, package, *argv],
                stdout=fo, stderr=fe, cwd=root, env=env)

    def records(self) -> list:
        if os.path.exists(self.record):
            with open(self.record) as f:
                f.seek(self._offset)
                text = f.read()
            done = text.rfind("\n") + 1
            self._offset += len(text[:done].encode())
            self.lines += [json.loads(x) for x in text[:done].splitlines() if x.strip()]
        return self.lines

    def of(self, event: str) -> list:
        return [r for r in self.records() if r["event"] == event]

    def wait_hold(self, n: int, timeout: float = 300.0) -> None:
        deadline = time.perf_counter() + timeout
        while not any(r["round"] == n for r in self.of("hold")):
            if self.proc.poll() is not None or time.perf_counter() > deadline:
                with open(self.err) as f:
                    fail(f"the {self.side} {self.name} ended or stalled before round {n} "
                         f"(exit {self.proc.poll()}): {f.read()[-3000:]}")
            time.sleep(0.01)

    def go(self, n: int) -> None:
        open(f"{self.record}.go{n}", "w").close()

    def round(self, n: int) -> dict:
        """Release round n; return its end line once the loop holds again."""
        self.wait_hold(n)
        self.go(n)
        self.wait_hold(n + 1)
        return next(r for r in self.of("end") if r["round"] == n)

    def stop(self, n: int) -> tuple:
        """SIGTERM while held before round n, then release it: (exit code,
        seconds from the signal to the exit)."""
        self.wait_hold(n)
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        self.go(n)
        rc = self.proc.wait(timeout=120)
        return rc, time.perf_counter() - t0

    def stderr(self) -> list:
        with open(self.err) as f:
            return f.read().splitlines()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def deployment_run(root: str, side: str, argv: list, env: dict, work: str, host: str,
                   rounds: int) -> dict:
    """One run of the Deployment's loop, held before each round
    (:class:`HeldCli`): before round 1 the script reads /healthz and
    /readyz, after each round every route of the fleet API (after round 1
    also the write burst, after the last the timings), then lets the next
    round go; SIGTERM as round ``rounds + 1`` starts."""
    os.makedirs(work)
    out = {"rounds": [], "writes": None, "timings": None, "serving_line": None}
    t0 = time.perf_counter()
    loop = HeldCli(root, side, "loop", [a.replace("{dir}", work) for a in argv], env, work)
    try:
        port = None
        for k in range(1, rounds + 2):
            loop.wait_hold(k)
            if port is None:
                m = re.search(r"Serving fleet state API on port (\d+) .*", "\n".join(loop.stderr()))
                if m is None:
                    fail(f"the {side} loop named no fleet API port before round 1")
                port, out["serving_line"] = int(m.group(1)), m.group(0)
            if k == 1:
                out["pre"] = {p: served(p, *http_get(port, p)[:3])
                              for p in ("/healthz", "/readyz")}
            else:
                out["rounds"].append(read_fleet_api(port, host))
            if k == 2:
                out["writes"] = write_burst(port, host)
            if k <= rounds:
                loop.go(k)
        out["timings"] = fleet_api_timings(port)
        out["exit_code"], out["sigterm_to_exit_s"] = loop.stop(rounds + 1)
        out["port_closed"] = not port_open(port)
    finally:
        loop.kill()
    out["seconds"] = time.perf_counter() - t0
    out["record"] = loop.records()
    out["events"] = read_jsonl(os.path.join(work, "events.jsonl"))
    out["stderr"] = loop.stderr()
    return out


def port_open(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
        return True
    except OSError:
        return False


def standalone_run(root: str, side: str, argv: list, env: dict, work: str,
                   host: str) -> dict:
    """``--serve 0`` with no ``--watch`` over a recorded store: the reads
    and writes once it serves, then SIGTERM."""
    os.makedirs(work)
    record, err = os.path.join(work, "record.jsonl"), os.path.join(work, "stderr.txt")
    package = "tpu_node_checker_torch" if side == "port" else "tpu_node_checker"
    out = {}
    with open(os.path.join(work, "stdout.txt"), "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen([sys.executable, "-c", WATCH_CLI_SCRIPT, record, package,
                                 *argv], stdout=fo, stderr=fe, cwd=root, env=env)
        try:
            deadline, port = time.perf_counter() + 120, None
            while port is None:
                with open(err) as f:
                    m = re.search(r"Serving fleet state API on port (\d+)", f.read())
                port = int(m.group(1)) if m else None
                if port is None and (proc.poll() is not None or time.perf_counter() > deadline):
                    fail(f"the {side} standalone API never served (exit {proc.poll()}): "
                         f"{open(err).read()[-2000:]}")
                time.sleep(0.005)
            out["gets"] = {p: served(p, *http_get(port, p)[:3]) for p in (
                "/readyz", "/healthz", "/api/v1/summary", "/api/v1/nodes",
                f"/api/v1/nodes/{host}", "/api/v1/trend")}
            post = f"/api/v1/nodes/{host}/cordon"
            out["writes"] = [served(post, *http_get(port, post, "POST", h)[:3]) for h in (
                {"Authorization": f"Bearer {SERVE_TOKEN}"}, {})]
            proc.send_signal(signal.SIGTERM)
            out["exit_code"] = proc.wait(timeout=60)
            out["port_closed"] = not port_open(port)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    exit_line = next((r for r in read_jsonl(record) if r["event"] == "exit"), {})
    out["packages_loaded"] = exit_line.get("packages")
    with open(err) as f:
        out["stderr"] = [re.sub(r"port \d+", "port N", x.replace(work, "W"))
                         for x in f.read().splitlines()]
    return out


def phase14_deployment(torch, root, rows, validate_report, quarantine: dict) -> None:
    """Phase 14: the aggregator Deployment as written, with --analytics,
    over this card's reports (phase 13's): the loop with the fleet API,
    read between rounds, through the port and through the JAX checker's
    CLI; then the standalone fleet API over the recorded store."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    host = quarantine["host"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "SMOKE_ROUND_PLAN", "SMOKE_CLOCK")}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1", TNC_SERVE_TOKEN=SERVE_TOKEN)
    work = tempfile.mkdtemp(prefix="chip-smoke-deployment-")
    reports = quarantine["reports"]
    for key, doc in reports.items():
        if validate_report(doc) or doc.get("hostname") != host:
            fail(f"phase 13's {key} report cannot be graded here: {validate_report(doc)}")
    for r in rows:
        r["deployment_launches"] = {k: doc["kernel_launches"][r["name"]]
                                    for k, doc in reports.items()}
    dirs = {}
    for key, doc in reports.items():
        d = dirs[key] = os.path.join(work, "rounds", key)
        os.makedirs(d)
        with open(os.path.join(d, f"{host}.json"), "w") as f:
            json.dump(doc, f)
    # Healthy, drill, healthy, drill, healthy, healthy; SIGTERM as round 7
    # starts.  The flips at rounds 2, 3 and 4 bring the flap detector's
    # score to its threshold at round 4.
    plan_rounds = ["healthy", "drill", "healthy", "drill", "healthy", "healthy"]
    link = os.path.join(work, "reports")
    os.symlink(dirs["healthy"], link)
    # The clock the CLIs read: one second past the next minute boundary, so
    # every round falls in one bucket of each roll-up resolution on both
    # sides; phase 13's reports are then 1-2 minutes old (max age 900 s).
    clock = math.ceil(time.time() / 60.0) * 60.0 + 1.0
    lease_port = free_port()
    argv = ["--kubeconfig", None, "--watch", "1", "--strict-slices", "--probe-results", link,
            "--probe-results-required", "--slack-on-change", "--metrics-port", "0",
            "--log-jsonl", "{dir}/rounds.jsonl", "--history", "{dir}/history.jsonl",
            "--cordon-after", "2", "--uncordon-after", "3", "--disruption-budget", "2/10m",
            "--slice-floor-pct", "90", "--disruption-lease", f"http://127.0.0.1:{lease_port}",
            "--cordon-failed", "--uncordon-recovered", "--serve", "0", "--serve-workers", "2",
            "--write-rps", "5", "--event-log", "{dir}/events.jsonl",
            "--analytics", "{dir}/analytics"]
    runs, posts_of, patches_of, leases_of = {}, {}, {}, {}
    with webhook() as (url, posts):
        for side in ("port", "jax"):
            api = LiveApi(watch_fleet(host, n, set()), {})
            lease = LeaseServer(lease_port, 2, 600.0)
            try:
                argv[1] = kubeconfig(os.path.join(work, f"kubeconfig-{side}"), api.url)
                plan = {"link": link, "dirs": [dirs[k] for k in plan_rounds], "hold": True}
                start = len(posts)
                runs[side] = deployment_run(
                    root, side, argv, dict(env, SLACK_WEBHOOK_URL=url,
                                           SMOKE_ROUND_PLAN=json.dumps(plan),
                                           SMOKE_CLOCK=repr(clock)),
                    os.path.join(work, side), host, len(plan_rounds))
                posts_of[side] = [re.sub(r"port \d+", "port N",
                                         p[2]["text"].rsplit("\n`trace: ", 1)[0])
                                  for p in posts[start:]]
                with api.lock:
                    patches_of[side] = list(api.patches)
                leases_of[side] = list(lease.requests)
            finally:
                lease.close()
                api.close()

    seen = {}
    for side, run in runs.items():
        record = run["record"]
        starts = [r for r in record if r["event"] == "start"]
        ends = [r for r in record if r["event"] == "end"]
        exit_line = next((r for r in record if r["event"] == "exit"), {})
        patch_rounds = [sum(1 for s_ in starts if s_["at"] <= p["at"]) for p in patches_of[side]]
        predictions = [e for e in run["events"] if e["event"] == "analytics-prediction"]
        node_rounds = [r["exchanges"][f"/api/v1/nodes/{host}"] for r in run["rounds"]]
        got = {
            "exit_code": run["exit_code"], "rounds": len(ends),
            "round_exit_codes": [r.get("exit_code") for r in ends],
            "round_seconds": [r["seconds"] for r in ends],
            "analytics_query_ms": [(r.get("timings_ms") or {}).get("analytics-query")
                                   for r in ends],
            "patches": [{"node": p["node"], "body": p["body"]} for p in patches_of[side]],
            "patch_rounds": patch_rounds, "posts": posts_of[side],
            "events": [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
                       for e in run["events"]],
            "prediction_rounds": [next((i + 1 for i, s_ in enumerate(starts)
                                        if s_["trace_id"] == e.get("trace_id")), None)
                                  for e in predictions],
            "lease_requests": leases_of[side], "pre": run["pre"],
            "exchanges": [r["exchanges"] for r in run["rounds"]],
            "served_rounds": [r["round"] for r in run["rounds"]],
            "node_states": [(doc or {}).get("node", {}).get("health") for _, _, doc in node_rounds],
            "node_probe_ok": [(doc or {}).get("node", {}).get("probe", {}).get("ok")
                              for _, _, doc in node_rounds],
            "304_gzip_head": [(r["304"], r["gzip"], r["head"]) for r in run["rounds"]],
            "writes": run["writes"], "serving_line": run["serving_line"],
            "timings": run["timings"], "sigterm_to_exit_s": run["sigterm_to_exit_s"],
            "port_closed": run["port_closed"], "seconds": run["seconds"],
            "get_ms_after_each_round": [r["ms"] for r in run["rounds"]],
            "packages_loaded": exit_line.get("packages"),
        }
        seen[side] = got
        phase(14, f"the Deployment's loop with the fleet API, {side} run", **{
            k: v for k, v in got.items() if k in (
                "exit_code", "rounds", "round_exit_codes", "round_seconds",
                "analytics_query_ms", "patches", "patch_rounds", "prediction_rounds",
                "lease_requests", "served_rounds", "node_states", "node_probe_ok",
                "304_gzip_head", "serving_line", "timings", "sigterm_to_exit_s",
                "port_closed", "seconds", "packages_loaded")},
            pre={p: s for p, (s, _, _) in got["pre"].items()},
            writes=[(s, h.get("Retry-After")) for s, h, _ in got["writes"]],
            posts=[p.splitlines()[0] for p in got["posts"]],
            events=[e["event"] for e in got["events"]])
        phase(14, f"the fleet API's GET ms after each round, {side} run",
              rounds=got["get_ms_after_each_round"])

    port = seen["port"]
    ok_plan = [k == "healthy" for k in plan_rounds]
    statuses = [s for s, _, _ in port["writes"]]
    last = port["exchanges"][-1]
    checks = {
        "exit 143 after seven rounds, the fleet API closed": (
            port["exit_code"] == 143 and port["rounds"] == 7 and port["port_closed"]),
        "readyz 503 before round 1, 200 after; healthz 200": (
            port["pre"]["/readyz"][0] == 503 and port["pre"]["/healthz"][0] == 200
            and all(x["/readyz"][0] == 200 and x["/healthz"][0] == 200
                    for x in port["exchanges"])),
        "two accept loops, or SO_REUSEPORT named unavailable": (
            "(2 workers" in (port["serving_line"] or "")
            or any("SO_REUSEPORT unavailable" in p for p in port["posts"])),
        "X-TNC-Round moves forward": port["served_rounds"] == ["1", "2", "3", "4", "5", "6"],
        "the node carries the round's report and FSM state": (
            port["node_probe_ok"] == ok_plan
            and all(h and h.get("state") for h in port["node_states"])),
        "every route answers": all(
            x[p][0] == 200 for x in port["exchanges"] for p in x
            if p not in ("/api/v1/nope", "/readyz")) and all(
            x["/api/v1/nope"][0] == 404 for x in port["exchanges"]),
        "304, gzip and HEAD each round": all(all(t) for t in port["304_gzip_head"]),
        "one analytics-prediction, at round 4": port["prediction_rounds"] == [4],
        "writes: 401 without the token, then 5 answers and 429s with Retry-After": (
            statuses[:2] == [401, 401] and 429 not in statuses[2:7]
            and statuses[7:] == [429, 429, 429]
            and all(h.get("Retry-After") for _, h, _ in port["writes"][7:])),
        "the analytics documents served": all(
            last[f"/api/v1/analytics/{k}"][0] == 200 for k in ("slo", "offenders", "flaps")),
        "200 GETs then 200 304s": bool(port["timings"]["all_200_then_304"]),
        "only its own package": port["packages_loaded"] == ["tpu_node_checker_torch"],
    }
    phase(14, "the port's Deployment", **checks)
    if not all(checks.values()):
        fail(f"the port's Deployment: {[k for k, v in checks.items() if not v]}")

    # The JAX checker's CLI on the same rounds, reports and servers.
    same = {k: seen["port"][k] == seen["jax"][k] for k in (
        "exit_code", "round_exit_codes", "patches", "patch_rounds", "events",
        "prediction_rounds", "lease_requests", "pre", "writes", "served_rounds")}
    # The auth-failure post comes from a thread of the server's: the
    # round's posts are compared in order, that one by its text.
    same["posts"] = sorted(seen["port"]["posts"]) == sorted(seen["jax"]["posts"]) and [
        p for p in seen["port"]["posts"] if "Fleet state API" not in p] == [
        p for p in seen["jax"]["posts"] if "Fleet state API" not in p]
    same["bodies"] = seen["port"]["exchanges"] == seen["jax"]["exchanges"]
    differing = sorted({p for a, b in zip(seen["port"]["exchanges"], seen["jax"]["exchanges"])
                        for p in a if a[p] != b.get(p)})
    phase(14, "the port's Deployment beside the JAX checker's", **same,
          differing_routes=differing,
          packages_loaded={k: seen[k]["packages_loaded"] for k in seen})
    if not all(same.values()) or seen["jax"]["packages_loaded"] != ["tpu_node_checker"]:
        fail(f"the port's Deployment unlike the JAX checker's: {same}, routes {differing}")

    # The standalone fleet API over the port's recorded store and log.
    store = os.path.join(work, "port", "history.jsonl")
    log = os.path.join(work, "port", "rounds.jsonl")
    alone = {}
    for side in ("port", "jax"):
        alone[side] = standalone_run(
            root, side, ["--serve", "0", "--history", store, "--log-jsonl", log],
            dict(env, SMOKE_CLOCK=repr(clock + 10.0)), os.path.join(work, f"alone-{side}"),
            host)
    a = alone["port"]
    checks = {
        "readyz 200": a["gets"]["/readyz"][0] == 200,
        "writes 503 with the token, 401 without": [s for s, _, _ in a["writes"]] == [503, 401],
        "SIGTERM exits 143, the API closed": a["exit_code"] == 143 and a["port_closed"],
        "summary, nodes and trend equal the JAX checker's": all(
            a["gets"][p] == alone["jax"]["gets"][p]
            for p in ("/api/v1/summary", "/api/v1/nodes", "/api/v1/trend")),
        "every exchange equal": a["gets"] == alone["jax"]["gets"]
        and a["writes"] == alone["jax"]["writes"] and a["exit_code"] == alone["jax"]["exit_code"],
        "only its own package": (a["packages_loaded"] == ["tpu_node_checker_torch"]
                                 and alone["jax"]["packages_loaded"] == ["tpu_node_checker"]),
    }
    phase(14, "the standalone fleet API over the recorded store", **checks,
          summary=a["gets"]["/api/v1/summary"][2], stderr=a["stderr"])
    if not all(checks.values()):
        fail(f"the standalone fleet API: {[k for k, v in checks.items() if not v]}")
    phase(14, "the aggregator Deployment as written", seconds=time.perf_counter() - t_phase,
          get_ms=port["timings"]["get_ms"], not_modified_ms=port["timings"]["not_modified_ms"],
          publish_ms=port["timings"]["publish_ms"],
          analytics_query_ms=port["analytics_query_ms"])


class WatchApi:
    """The fake Kubernetes API server of cluster "west", served from a
    thread: ``GET /api/v1/nodes`` is one page with
    ``metadata.resourceVersion``; with ``watch=1`` it is the node watch,
    newline-delimited JSON frames in a chunked body that stays open until
    the script ends it.  :meth:`emit` applies an event to the server's own
    nodes (so a relist sees it) and sends it down the newest watch
    connection; ``requests`` counts LISTs and watch connections."""

    def __init__(self, nodes: list):
        import queue
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        self.nodes = {n["metadata"]["name"]: n for n in nodes}
        self.rv, self.lock, self.streams = 1000, threading.Lock(), []
        self.requests = {"list": 0, "watch": 0}
        self.closed = threading.Event()
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def chunk(self, data: bytes) -> None:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            def do_GET(self):  # noqa: N802 — the handler protocol's name
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path != "/api/v1/nodes":
                    body = json.dumps({"kind": "Status", "code": 404}).encode()
                    self.send_response(404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if not q.get("watch"):
                    with api.lock:
                        api.requests["list"] += 1
                        body = json.dumps({"kind": "NodeList", "apiVersion": "v1",
                                           "metadata": {"resourceVersion": str(api.rv)},
                                           "items": list(api.nodes.values())}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                frames = queue.Queue()
                with api.lock:
                    api.requests["watch"] += 1
                    api.streams.append(frames)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    while not api.closed.is_set():
                        try:
                            frame = frames.get(timeout=0.5)
                        except queue.Empty:
                            continue
                        if frame is None:
                            break
                        self.chunk(json.dumps(frame).encode() + b"\n")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="chip-smoke-watch-apiserver", daemon=True)
        self.thread.start()

    def _send(self, frame) -> None:
        with self.lock:
            if not self.streams:
                fail("west's watch has no connection to send a frame down")
            self.streams[-1].put(frame)

    def emit(self, etype: str, node: dict) -> str:
        node = json.loads(json.dumps(node))
        with self.lock:
            self.rv += 1
            node["metadata"]["resourceVersion"] = str(self.rv)
            if etype == "DELETED":
                self.nodes.pop(node["metadata"]["name"], None)
            else:
                self.nodes[node["metadata"]["name"]] = node
            rv = str(self.rv)
        self._send({"type": etype, "object": node})
        return rv

    def bookmark(self) -> str:
        with self.lock:
            self.rv += 1
            rv = str(self.rv)
        self._send({"type": "BOOKMARK", "object": {"kind": "Node",
                                                   "metadata": {"resourceVersion": rv}}})
        return rv

    def end_stream(self) -> None:
        self._send(None)

    def gone(self) -> None:
        """The in-band 410: the ERROR frame an apiserver sends when the
        resourceVersion expired under an open watch, then the stream's end."""
        self._send({"type": "ERROR", "object": {"kind": "Status", "code": 410,
                                                 "reason": "Expired",
                                                 "message": "too old resource version"}})
        self._send(None)

    def close(self) -> None:
        self.closed.set()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


# Phase 15's masks between the port's tier and the JAX checker's: a round's
# trace id (the X-TNC-Trace header is not compared) and every ms value and
# age, which are wall times.  The wall clock each CLI reads is pinned
# (SMOKE_CLOCK), so every timestamp is compared.  Of /metrics the
# federation families are compared, less their durations and the feed's
# lag.
FEDERATION_MASKED_KEYS = ("trace_id", "stream_age_seconds")
FEDERATION_MASKED_SUFFIXES = ("_ms",)
FEDERATION_METRICS = re.compile(
    r"^tpu_node_checker_federation_(?!round_duration|fetch_duration|feed_lag)")
GLOBAL_ROUTES = ["/api/v1/global/summary", "/api/v1/global/clusters",
                 "/api/v1/global/clusters/east", "/api/v1/global/clusters/west",
                 "/api/v1/global/nodes", "/api/v1/global/analytics",
                 "/api/v1/global/clusters/nope", "/readyz", "/healthz", "/metrics",
                 "/api/v1/debug/rounds"]


def federation_masked(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in FEDERATION_MASKED_KEYS
                or k.endswith(FEDERATION_MASKED_SUFFIXES) else federation_masked(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [federation_masked(v) for v in obj]
    return obj


def read_global(port: int, etags: dict) -> dict:
    """Every route of the aggregator once after a round; then a 304 for
    each ETag the previous read saw, gzip and HEAD of the nodes body."""
    got, raw = {}, {}
    for path in GLOBAL_ROUTES:
        status, headers, body, ms = http_get(port, path)
        if path == "/metrics":
            doc = sorted(x for x in body.decode().splitlines() if FEDERATION_METRICS.match(x))
        else:
            doc = federation_masked(json.loads(body)) if body else None
        got[path] = {"status": status, "round": headers.get("X-TNC-Round"), "body": doc,
                     "ms": ms}
        raw[path] = (headers, body)
    not_modified = {}
    for path, etag in etags.items():
        not_modified[path] = http_get(port, path, headers={"If-None-Match": etag})[0]
    for path, (headers, _) in raw.items():
        if headers.get("ETag"):
            etags[path] = headers["ETag"]
    nodes = raw["/api/v1/global/nodes"][1]
    sgz, hgz, bgz, _ = http_get(port, "/api/v1/global/nodes",
                                headers={"Accept-Encoding": "gzip"})
    shead, hhead, bhead, _ = http_get(port, "/api/v1/global/nodes", method="HEAD")
    return {"routes": got, "304": not_modified, "nodes_raw": nodes,
            "gzip": sgz == 200 and hgz.get("Content-Encoding") == "gzip"
            and gzip.decompress(bgz) == nodes,
            "head": shead == 200 and bhead == b""
            and hhead.get("Content-Length") == str(len(nodes))}


def upstream_requests(port: int) -> dict:
    """The fleet API's own request counters by route, less the script's
    scrapes and the feed's long-polls."""
    out = {}
    for key, value in samples(http_get(port, "/metrics")[2]).items():
        if key.startswith("tpu_node_checker_api_server_requests_total{"):
            route = key.split('route="')[1].split('"')[0]
            if route not in ("/metrics", "/api/v1/watch"):
                out[route] = out.get(route, 0) + value
    return out


def west_fleet() -> list:
    """Cluster west: 1,000 H100 nodes of 8 cards (one LIST page)."""
    nodes = []
    for i in range(1000):
        node = k8s_node(f"gke-h100-west-{i}", {"nvidia.com/gpu": "8"}, True)
        node["metadata"]["labels"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                                      "cloud.google.com/gke-nodepool": "h100-west"}
        nodes.append(node)
    return nodes


def federation_run(root: str, side: str, host: str, n: int, dirs: dict, ports: dict,
                   env: dict, work: str, clock: float) -> dict:
    """One life of the federation tier through one package's CLI: east,
    west and the aggregator, the six steps, then the feed aggregator."""
    os.makedirs(work)
    api_e = LiveApi(watch_fleet(host, n, set()), {})
    api_w = WatchApi(west_fleet())
    endpoints = os.path.join(work, "endpoints.json")
    with open(endpoints, "w") as f:
        json.dump({"clusters": [{"name": "east", "url": f"http://127.0.0.1:{ports['east']}"},
                                {"name": "west", "url": f"http://127.0.0.1:{ports['west']}"}]},
                  f)
    link = os.path.join(work, "reports")
    os.symlink(dirs["healthy"], link)
    east_argv = ["--kubeconfig", kubeconfig(os.path.join(work, "kubeconfig-east"), api_e.url),
                 "--watch", "1", "--strict-slices", "--probe-results", link,
                 "--probe-results-required", "--slack-on-change", "--metrics-port", "0",
                 "--log-jsonl", f"{work}/east-rounds.jsonl",
                 "--history", f"{work}/east-history.jsonl", "--cordon-after", "2",
                 "--uncordon-after", "3", "--disruption-budget", "2/10m",
                 "--slice-floor-pct", "90",
                 "--disruption-lease", f"http://127.0.0.1:{ports['aggregator']}",
                 "--cordon-failed", "--uncordon-recovered", "--serve", str(ports["east"]),
                 "--serve-workers", "2", "--event-log", f"{work}/east-events.jsonl",
                 "--analytics", f"{work}/east-analytics", "--cluster-name", "east"]
    west_argv = ["--kubeconfig", kubeconfig(os.path.join(work, "kubeconfig-west"), api_w.url),
                 "--watch", "1", "--watch-stream", "--serve", str(ports["west"]),
                 "--cluster-name", "west", "--history", f"{work}/west-history.jsonl",
                 "--analytics", f"{work}/west-analytics"]
    agg_argv = ["--federate", endpoints, "--serve", str(ports["aggregator"]),
                "--federate-interval", "1", "--federate-workers", "2", "--serve-workers", "2",
                "--fleet-disruption-budget", "1/10m", "--event-log", f"{work}/agg-events.jsonl",
                "--trace", f"{work}/agg-trace.json"]
    feed_argv = ["--federate", endpoints, "--serve", str(ports["feed"]),
                 "--federate-interval", "1", "--federate-workers", "2", "--serve-workers", "2",
                 "--federate-feed", "--event-log", f"{work}/feed-events.jsonl"]
    # West's events at step 2: a flip to NotReady, 100 heartbeats that
    # change no grading input, a node deleted, one added, a bookmark.
    west = api_w.nodes
    rv_step2 = str(api_w.rv + 104)
    plans = {
        "east": {"link": link, "dirs": [dirs["healthy"], dirs["drill"], dirs["drill"]]},
        "west": {"ticks": {"2": {"rv": rv_step2}, "4": {"ended": True},
                           "5": {"ended": True}}},
    }
    out = {"steps": [], "reads": [], "exit_codes": {}, "sigterm_to_exit_s": {}}
    tiers = {}
    with webhook() as (url, posts):
        try:
            def start(name, argv, plan, at):
                tiers[name] = HeldCli(root, side, name, argv,
                                      dict(env, SLACK_WEBHOOK_URL=url,
                                           SMOKE_ROUND_PLAN=json.dumps(dict(plan, hold=True)),
                                           SMOKE_CLOCK=repr(at)), work)
                return tiers[name]

            east = start("east", east_argv, plans["east"], clock)
            west_tier = start("west", west_argv, plans["west"], clock)
            agg = start("aggregator", agg_argv, {}, clock + 0.5)
            etags = {}

            def step(k, label, *parts):
                t0 = time.perf_counter()
                ends = {}
                for name, fn in parts:
                    ends.setdefault(name, []).append(fn())
                ends["aggregator"] = [agg.round(k)]
                read = read_global(ports["aggregator"], etags)
                with open(f"{work}/agg-trace.json") as f:
                    trace = json.load(f)
                read["trace_tracks"] = {
                    e["args"]["name"]: next(
                        (m["args"]["trace_id"] for m in trace["traceEvents"]
                         if m.get("name") == "trace_id" and m["pid"] == e["pid"]), None)
                    for e in trace["traceEvents"] if e.get("name") == "process_name"}
                out["reads"].append(read)
                out["steps"].append({"step": k, "label": label, "ends": ends,
                                     "seconds": time.perf_counter() - t0})

            # 1. Everything healthy.
            step(1, "healthy", ("east", lambda: east.round(1)),
                 ("west", lambda: west_tier.round(1)))
            # 2. East grades the drill; west's stream carries the events.
            west_tier.wait_hold(2)
            names = list(west)
            sick = json.loads(json.dumps(west[names[1]]))
            sick["status"]["conditions"][0]["status"] = "False"
            api_w.emit("MODIFIED", sick)
            for i in range(100):
                beat = json.loads(json.dumps(west[names[2 + i]]))
                beat["status"]["conditions"][0]["lastHeartbeatTime"] = (
                    f"2026-10-17T00:{i // 60:02d}:{i % 60:02d}Z")
                api_w.emit("MODIFIED", beat)
            api_w.emit("DELETED", west[names[-1]])
            api_w.emit("ADDED", k8s_node("gke-h100-west-new", {"nvidia.com/gpu": "8"}, True))
            if api_w.bookmark() != rv_step2:
                fail("west's script and its plan disagree on the resourceVersion")
            step(2, "east drill; west events", ("east", lambda: east.round(2)),
                 ("west", lambda: west_tier.round(2)))
            # 3. East's second drill: FAILED, the cordon leased from the
            # aggregator; a second lease in the window is denied.
            step(3, "east drill again; the lease", ("east", lambda: east.round(3)),
                 ("west", lambda: west_tier.round(3)))
            status, _, body, _ = http_get(
                ports["aggregator"], "/api/v1/global/disruption-lease", "POST",
                {"Content-Type": "application/json"}, json.dumps(
                    {"count": 1, "action": "cordon", "node": "gke-h100-west-1",
                     "cluster": "west"}).encode())
            out["second_lease"] = (status, json.loads(body))

            # 4. West's server ends the stream (one relist, stream_end), then
            # an in-band 410 (one relist, gone).
            def west_relists():
                west_tier.wait_hold(4)
                api_w.end_stream()
                first = west_tier.round(4)
                api_w.gone()
                return [first, west_tier.round(5)]

            step(4, "west's stream ends, then a 410", ("west", west_relists))

            # 5. West stops: its shard alone goes stale.
            def west_stops():
                rc, seconds = west_tier.stop(6)
                out["exit_codes"]["west"], out["sigterm_to_exit_s"]["west"] = rc, seconds
                return {"exit_code": rc}

            step(5, "west stopped", ("west", west_stops))
            # 6. West again, on its port: its shard recovers.
            west2 = start("west2", west_argv, {}, clock + 10.0)
            step(6, "west restarted", ("west2", lambda: west2.round(1)))

            # (e) The feed aggregator over the same upstreams: its first
            # round polls and opens the feeds, its second waits for them to
            # verify, then three steady rounds; the upstreams count each.
            feed = start("feed", feed_argv, {"await_feeds": True}, clock + 20.5)
            counts = []
            for k in (1, 2, 3, 4, 5):
                before = {c: upstream_requests(ports[c]) for c in ("east", "west")}
                feed.round(k)
                after = {c: upstream_requests(ports[c]) for c in ("east", "west")}
                counts.append({c: {r: after[c][r] - before[c].get(r, 0) for r in after[c]
                                   if after[c][r] != before[c].get(r, 0)}
                               for c in after})
            out["feed_counts"] = counts
            out["feed_read"] = read_global(ports["feed"], {})
            for name, k in (("feed", 6), ("aggregator", 7), ("east", 4), ("west2", 2)):
                rc, seconds = tiers[name].stop(k)
                out["exit_codes"][name], out["sigterm_to_exit_s"][name] = rc, seconds
        finally:
            for tier in tiers.values():
                tier.kill()
            api_e.close()
            api_w.close()
    with api_e.lock:
        out["patches"] = masked_patches(api_e.patches)
    out["posts"] = [re.sub(r"port \d+", "port N", p[2]["text"].rsplit("\n`trace: ", 1)[0])
                    for p in posts]
    out["west_requests"] = dict(api_w.requests)
    out["records"] = {name: tier.records() for name, tier in tiers.items()}
    out["stderr"] = {name: tier.stderr() for name, tier in tiers.items()}
    out["events"] = {name: read_jsonl(f"{work}/{name}-events.jsonl")
                     for name in ("agg", "east", "feed")}
    return out


def phase15_federation(torch, root, rows, validate_report) -> None:
    """Phase 15: the federation tier above two clusters, one of them graded
    on this card's reports: two emits on the card, then east (the
    Deployment's loop), west (the loop over the node watch) and the
    federation aggregator, through the port and through the JAX checker's
    CLI; then the aggregator over the upstreams' watch feeds."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    host = "gke-h100-east-0"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "SMOKE_ROUND_PLAN", "SMOKE_CLOCK")}
    env.update(NODE_NAME=host, TNC_SCHEMA_STRICT="1")
    work = tempfile.mkdtemp(prefix="chip-smoke-federation-")

    # (a) This host's two reports, written at once on the card: healthy at
    # the compute level, and the t1 drill at the collective level.
    emits = {"healthy": (("--probe-level", "compute"), None),
             "drill": (("--probe-topology", "1x1", "--probe-level", "collective"), "t1")}
    dirs, reports, per_emit = {}, {}, {}
    for key in emits:
        dirs[key] = os.path.join(work, "emits", key)
        os.makedirs(dirs[key])

    def emit(key):
        args, axis = emits[key]
        e = dict(env, TNC_CHAOS_AXIS=axis) if axis else env
        t0 = time.perf_counter()
        proc = port_cli(root, "--emit-probe", os.path.join(dirs[key], f"{host}.json"), *args,
                        env=e)
        return proc.returncode, time.perf_counter() - t0, proc.stderr

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        done = dict(zip(emits, pool.map(emit, emits)))
    emit_seconds = time.perf_counter() - t0
    for key, (rc, seconds, err) in done.items():
        try:
            with open(os.path.join(dirs[key], f"{host}.json")) as f:
                doc = reports[key] = json.load(f)
        except (OSError, json.JSONDecodeError):
            fail(f"the emit {key} wrote no report (exit {rc}): {err[-2000:]}")
        per_emit[key] = dict(
            exit_code=rc, seconds=seconds, ok=doc.get("ok"), level=doc.get("level"),
            hostname=doc.get("hostname"), error=doc.get("error"),
            kernel_launches=doc.get("kernel_launches"),
            kernels_match_plain={k: doc.get(k) for k in ("pallas_ok", "dma_ok",
                                                         "flash_attention_ok", "int8_ok")},
            schema_violations=validate_report(doc))
    phase(15, "this host's reports, written by the port's emitter at once", reports=per_emit,
          seconds=emit_seconds)
    for key, e in per_emit.items():
        if (e["exit_code"] != (0 if key == "healthy" else 3) or e["schema_violations"]
                or e["hostname"] != host
                or (key == "drill" and "t1" not in (e["error"] or ""))
                or not all(v is True for v in e["kernels_match_plain"].values())):
            fail(f"the emit {key}: {e}")
        check_launches(f"the emit {key}", e["kernel_launches"])
    for r in rows:
        r["federation_launches"] = {k: e["kernel_launches"][r["name"]]
                                    for k, e in per_emit.items()}

    federation_tier(root, host, n, dirs, env, work)
    phase(15, "the federation tier over this card's reports",
          seconds=time.perf_counter() - t_phase, emit_seconds=emit_seconds)


def federation_tier(root: str, host: str, n: int, dirs: dict, env: dict, work: str) -> None:
    """Phase 15 (b)-(e): east, west and the aggregator through each CLI,
    against the same servers and the same pinned clock (one second past
    the next minute boundary), then the aggregator over the feeds; what
    the port's run must show, and the JAX checker's run beside it."""
    clock = math.ceil(time.time() / 60.0) * 60.0 + 1.0
    ports = {name: free_port() for name in ("east", "west", "aggregator", "feed")}
    runs = {side: federation_run(root, side, host, n, dirs, ports, env,
                                 os.path.join(work, side), clock)
            for side in ("port", "jax")}

    seen = {}
    for side, run in runs.items():
        recs = run["records"]
        stalled = {name: [r["waiting_for"] for r in rs if r["event"] == "stalled"]
                   for name, rs in recs.items()}
        if any(stalled.values()):
            fail(f"the {side} tier ran a round after a wait of 60 s for: {stalled}")
        agg_ends = [r for r in recs["aggregator"] if r["event"] == "end"]
        west_ends = [r for r in recs["west"] + recs["west2"] if r["event"] == "end"]
        east_ends = [r for r in recs["east"] if r["event"] == "end"]
        host_entries = []
        for read in run["reads"]:
            doc = read["routes"]["/api/v1/global/nodes"]["body"]
            block = next(c for c in doc["clusters"] if c["cluster"] == "east")
            entry = next(x for x in block["nodes"] if x["name"] == host)
            host_entries.append({"probe_ok": (entry.get("probe") or {}).get("ok"),
                                 "state": (entry.get("health") or {}).get("state"),
                                 "cordoned": entry.get("cordoned")})
        got = {
            "exit_codes": run["exit_codes"],
            "sigterm_to_exit_s": run["sigterm_to_exit_s"],
            "step_seconds": [s["seconds"] for s in run["steps"]],
            "east_round_exit_codes": [r.get("exit_code") for r in east_ends],
            "east_round_seconds": [r["seconds"] for r in east_ends],
            "east_blocks": [r.get("blocks") for r in east_ends],
            "west_ticks": [{"exit_code": r.get("exit_code"), "changed": r.get("changed"),
                            "payload": federation_masked(r.get("payload"))}
                           for r in west_ends],
            "west_timings_ms": [r.get("timings_ms") for r in west_ends],
            "west_watch": [federation_masked((r.get("payload") or {}).get("watch_stream"))
                           for r in west_ends],
            "west_requests": run["west_requests"],
            "aggregator_timings_ms": [r.get("timings_ms") for r in agg_ends],
            "aggregator_round_ms": [r.get("round_ms") for r in agg_ends],
            "fetch_counts": [r.get("fetch") for r in agg_ends],
            "bodies": [{p: {k: v for k, v in x.items() if k != "ms"}
                        for p, x in read["routes"].items()} for read in run["reads"]],
            "get_ms": [{p: x["ms"] for p, x in read["routes"].items()}
                       for read in run["reads"]],
            "304": [read["304"] for read in run["reads"]],
            "gzip_head": [(read["gzip"], read["head"]) for read in run["reads"]],
            "trace_tracks": [read["trace_tracks"] for read in run["reads"]],
            "host_in_global_nodes": host_entries,
            "second_lease": run["second_lease"],
            "lease_events": [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
                             for e in run["events"]["agg"] if e["event"] == "disruption-lease"],
            "agg_events": [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
                           for e in run["events"]["agg"]],
            "east_events": [{k: v for k, v in e.items() if k not in ("ts", "trace_id")}
                            for e in run["events"]["east"]],
            "patches": run["patches"], "posts": run["posts"],
            "feed_counts": run["feed_counts"],
            "feed_fetch_counts": [r.get("fetch") for r in run["records"]["feed"]
                                  if r["event"] == "end"],
            "feed_bodies": {p: {k: v for k, v in x.items() if k != "ms"}
                            for p, x in run["feed_read"]["routes"].items()},
            "feed_nodes_blocks_equal_poll": (
                run["feed_read"]["nodes_raw"].partition(b'"clusters": [')[2]
                == run["reads"][-1]["nodes_raw"].partition(b'"clusters": [')[2]),
            "packages_loaded": {name: next((r.get("packages") for r in recs[name]
                                            if r["event"] == "exit"), None) for name in recs},
            "upstream_traces": [r.get("upstream_traces") for r in agg_ends],
            "east_trace_ids": [r.get("trace_id") for r in east_ends],
            "west_trace_ids": [r.get("trace_id") for r in west_ends],
        }
        seen[side] = got
        phase(15, f"the federation tier, {side} run", **{k: v for k, v in got.items() if k in (
            "exit_codes", "sigterm_to_exit_s", "step_seconds", "east_round_exit_codes",
            "east_round_seconds", "west_watch", "west_requests", "fetch_counts",
            "host_in_global_nodes", "second_lease", "lease_events", "feed_counts",
            "feed_fetch_counts", "feed_nodes_blocks_equal_poll", "packages_loaded")},
            west_changed=[t["changed"] if t["changed"] is None or len(t["changed"]) < 8
                          else len(t["changed"]) for t in got["west_ticks"]],
            patches=[(p["node"], p["body"].get("spec")) for p in got["patches"]],
            agg_events=[e["event"] for e in got["agg_events"]])
        phase(15, f"each round's timings_ms, {side} run", east=[r.get("timings_ms")
                                                                 for r in east_ends],
              west=got["west_timings_ms"], aggregator=got["aggregator_timings_ms"],
              aggregator_round_ms=got["aggregator_round_ms"], get_ms=got["get_ms"])

    port = seen["port"]
    summaries = [b["/api/v1/global/summary"]["body"] for b in port["bodies"]]
    ready = [b["/readyz"]["status"] for b in port["bodies"]]
    watch = port["west_watch"]
    relists = [(w or {}).get("relists_total") for w in watch]
    events = [(w or {}).get("events_total") for w in watch]
    shard_events = [(e["event"], e.get("shard")) for e in port["agg_events"]
                    if e["event"].startswith("shard-")]
    lease = port["lease_events"]
    feed_polls = [sum(c.values()) for c in port["feed_counts"][0].values()]
    feed_steady = [sum(c.values()) for counts in port["feed_counts"][2:]
                   for c in counts.values()]
    checks = {
        "every process exits 143 on SIGTERM": set(port["exit_codes"].values()) == {143}
        and len(port["exit_codes"]) == 5,
        "east: healthy, drill, drill (exit 0 each: the fleet stays Ready)": (
            port["east_round_exit_codes"][:3] == [0, 0, 0]),
        "east's cordon of this host, leased from the aggregator and granted": (
            [(p["node"], p["body"].get("spec")) for p in port["patches"]]
            == [(host, {"unschedulable": True})]
            and [(e["granted"], e["remaining"], e["cluster_requesting"]) for e in lease]
            == [(True, 0, "east"), (False, 0, "west")]),
        "the second lease in the window is denied": (
            port["second_lease"][0] == 409 and port["second_lease"][1]["granted"] is False
            and port["second_lease"][1]["remaining"] == 0),
        "east/this host carries its round's report and state": (
            [h["probe_ok"] for h in port["host_in_global_nodes"][:3]] == [True, False, False]
            and [h["state"] for h in port["host_in_global_nodes"][:3]]
            == ["HEALTHY", "SUSPECT", "FAILED"]),
        "west's step-2 tick changed the flip, the deletion and the addition": (
            port["west_ticks"][1]["changed"] == sorted(
                ["gke-h100-west-1", "gke-h100-west-999", "gke-h100-west-new"])),
        "west's events: 101 MODIFIED, 1 DELETED, 1 ADDED, 1 BOOKMARK, one ERROR": (
            events[1] == {"MODIFIED": 101, "DELETED": 1, "ADDED": 1, "BOOKMARK": 1}
            and events[4] == {"MODIFIED": 101, "DELETED": 1, "ADDED": 1, "BOOKMARK": 1,
                              "ERROR": 1}),
        "west relists once at stream end, once on the 410": (
            relists[:5] == [{"seed": 1}, {"seed": 1}, {"seed": 1},
                            {"seed": 1, "stream_end": 1},
                            {"seed": 1, "stream_end": 1, "gone": 1}]
            and port["west_ticks"][2]["changed"] == []),
        "west's server saw 4 LISTs and 4 watches (two processes)": (
            port["west_requests"] == {"list": 4, "watch": 4}),
        "west stopped: its shard alone stale, the summary says so, /readyz 200": (
            summaries[4]["degraded_clusters"] == ["west"]
            and summaries[4]["clusters"]["fresh"] == 1 and ready == [200] * 6
            and summaries[5]["degraded_clusters"] == []),
        "west's shard degraded and recovered, each logged once": (
            shard_events == [("shard-degraded", "west"), ("shard-recovered", "west")]),
        "every global route answers; an unknown cluster 404": all(
            b[p]["status"] == 200 for b in port["bodies"] for p in GLOBAL_ROUTES
            if p != "/api/v1/global/clusters/nope") and all(
            b["/api/v1/global/clusters/nope"]["status"] == 404 for b in port["bodies"]),
        "304 on the previous ETag, gzip and HEAD after each step": all(
            g and h for g, h in port["gzip_head"]) and all(
            set(x.values()) <= {200, 304} for x in port["304"]) and any(
            304 in x.values() for x in port["304"]),
        "the trace stitches both upstreams' rounds": all(
            t.get("cluster:east") in port["east_trace_ids"]
            and t.get("cluster:west") in port["west_trace_ids"]
            for t in port["trace_tracks"]),
        "the feed's first round polls each upstream; its steady rounds cost none": (
            min(feed_polls) > 0 and feed_steady == [0] * 6),
        "the feed's global nodes blocks are the poll aggregator's bytes": (
            port["feed_nodes_blocks_equal_poll"]),
        "only its own package": all(v == ["tpu_node_checker_torch"]
                                    for v in port["packages_loaded"].values()),
    }
    phase(15, "the port's federation tier", **checks)
    if not all(checks.values()):
        fail(f"the port's federation tier: {[k for k, v in checks.items() if not v]}")

    same = {k: seen["port"][k] == seen["jax"][k] for k in (
        "exit_codes", "east_round_exit_codes", "east_blocks", "west_ticks", "west_watch",
        "west_requests", "fetch_counts", "bodies", "304", "gzip_head",
        "host_in_global_nodes", "second_lease", "lease_events", "agg_events", "east_events",
        "patches", "posts", "feed_counts", "feed_fetch_counts", "feed_bodies",
        "feed_nodes_blocks_equal_poll")}
    differing = sorted({p for a, b in zip(seen["port"]["bodies"], seen["jax"]["bodies"])
                        for p in a if a[p] != b.get(p)})
    phase(15, "the port's federation tier beside the JAX checker's", **same,
          differing_routes=differing,
          packages_loaded={k: seen[k]["packages_loaded"] for k in seen})
    if not all(same.values()) or any(v != ["tpu_node_checker"]
                                     for v in seen["jax"]["packages_loaded"].values()):
        fail(f"the port's federation tier unlike the JAX checker's: {same}, routes {differing}")


SIM_CLI_SCRIPT = """
import importlib, json, runpy, sys, time

t0 = time.perf_counter()
record_path, entry, module, argv = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
if entry == "main":
    rc = importlib.import_module(module).main(argv)
else:
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as exc:
        rc = exc.code
        if rc is None:
            rc = 0
        elif not isinstance(rc, int):
            print(rc, file=sys.stderr)
            rc = 1
sys.stdout.flush()
with open(record_path, "w") as f:
    json.dump({"exit_code": rc, "seconds": time.perf_counter() - t0,
               "packages": sorted({m.split(".")[0] for m in sys.modules} & {
                   "jax", "jaxlib", "tpu_node_checker", "tpu_node_checker_torch", "torch"})}, f)
sys.exit(rc)
"""
SIM_PACKAGES = {"port": "tpu_node_checker_torch", "jax": "tpu_node_checker"}
SIM_FOREIGN = {"port": {"jax", "jaxlib", "tpu_node_checker"},
               "jax": {"jax", "jaxlib", "tpu_node_checker_torch", "torch"}}
SIGPIPE_DEATH = (-signal.SIGPIPE, 128 + signal.SIGPIPE)


def sim_run(root: str, side: str, label: str, argv: list, env: dict, work: str) -> dict:
    """One cold process of a CLI (``side`` "port" or "jax") through
    SIM_CLI_SCRIPT, in a scratch directory of its own (its ``TMPDIR``): its
    stdout, stderr, exit code, seconds and the packages it loaded.  ``argv``
    starts with the entry: ``simulate`` calls the CLI's ``main``;
    ``analytics_smoke`` runs ``python -m <package>.sim.analytics_smoke``;
    ``-m`` runs ``python -m <package>`` (its ``entrypoint``, which sets
    SIGPIPE to SIG_DFL); ``analysis`` runs ``python -m <package>.analysis``,
    the lint."""
    package = SIM_PACKAGES[side]
    entry, module, args = {
        "simulate": ("main", package + ".cli", argv),
        "analytics_smoke": ("-m", package + ".sim.analytics_smoke", argv[1:]),
        "-m": ("-m", package, argv[1:]),
        "analysis": ("-m", package + ".analysis", argv[1:]),
    }[argv[0]]
    scratch = os.path.join(work, side, re.sub(r"[^\w.+-]", "_", label))
    os.makedirs(scratch)
    record = os.path.join(scratch, "record.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SIM_CLI_SCRIPT, record, entry, module, *args],
                          capture_output=True, cwd=root, timeout=600,
                          env=dict(env, TMPDIR=scratch))
    out = dict(exit_code=proc.returncode, seconds=time.perf_counter() - t0,
               stdout=proc.stdout, stderr=proc.stderr.decode(errors="replace"))
    try:
        with open(record) as f:
            out.update(packages=json.load(f)["packages"])
    except (OSError, json.JSONDecodeError):
        out.update(packages=None)
    return out


def sim_jobs(root: str, scenarios: list) -> list:
    """Phase 16's runs, (label, argv, expected exit code), longest first."""
    repro = os.path.join(root, "tests", "sim_reproducers")
    jobs = [("fuzz --seeds 10 --seed 7",
             ["simulate", "--fuzz", "--seeds", "10", "--seed", "7", "--report", "json"], 0),
            ("federated-world 3 x 64", ["simulate", "--scenario", "federated-world",
                                        "--clusters", "3", "--nodes-per-cluster", "64",
                                        "--seed", "7", "--report", "json"], 0),
            ("mass-cordon-storm 1000", ["simulate", "--scenario", "mass-cordon-storm",
                                        "--nodes-per-cluster", "1000", "--seed", "7",
                                        "--report", "json"], 0),
            ("watch-loss-relist 1000", ["simulate", "--scenario", "watch-loss-relist",
                                        "--nodes-per-cluster", "1000", "--seed", "7",
                                        "--report", "json"], 0),
            ("flap-storm 64 (red)", ["simulate", "--scenario", "flap-storm",
                                     "--nodes-per-cluster", "64", "--seed", "7",
                                     "--report", "json"], 3)]
    jobs += [(name, ["simulate", "--scenario", name, "--seed", "7", "--report", "json"], 0)
             for name in scenarios]
    for path in sorted(os.listdir(repro)):
        if path.endswith(".json"):
            with open(os.path.join(repro, path)) as f:
                expect = json.load(f)["expect"]
            jobs.append((f"replay {path}", ["simulate", "--replay", os.path.join(repro, path),
                                            "--report", "json"],
                         0 if expect == "green" else 3))
    jobs.append(("analytics_smoke --seed 7", ["analytics_smoke", "--seed", "7"], 0))
    # Through ``python -m <package>`` itself; the federated world's shard
    # death can write to a closed socket there, which SIG_DFL turns into a
    # SIGPIPE death on either side (None: that death is counted, not failed).
    jobs += [("python -m: flap-storm", ["-m", "simulate", "--scenario", "flap-storm",
                                        "--seed", "7", "--report", "json"], 0),
             ("python -m: flap-storm human", ["-m", "simulate", "--scenario", "flap-storm",
                                              "--seed", "7"], 0),
             ("python -m: federated-world", ["-m", "simulate", "--scenario", "federated-world",
                                             "--seed", "7", "--report", "json"], None)]
    return jobs


def phase16_simulator(root: str) -> None:
    """Phase 16: the ``simulate`` subcommand through both CLIs, cold
    processes four at a time: the scenario list, the grid at its defaults,
    three larger worlds and the red flap storm, the fuzz campaign, each
    reproducer's replay, the analytics smoke, and three runs through
    ``python -m``.  Every stdout and exit code must be equal, and each CLI
    must load no package but its own."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "NODE_NAME")}
    work = tempfile.mkdtemp(prefix="chip-smoke-simulate-")
    listed = {side: sim_run(root, side, "--list-scenarios", ["simulate", "--list-scenarios"],
                            env, work) for side in SIM_PACKAGES}
    if (listed["port"]["exit_code"] != 0 or listed["jax"]["exit_code"] != 0
            or listed["port"]["stdout"] != listed["jax"]["stdout"]):
        fail(f"simulate --list-scenarios differs: port {listed['port']}, jax {listed['jax']}")
    scenarios = [line.split()[0] for line in listed["port"]["stdout"].decode().splitlines()
                 if line and not line[0].isspace()]
    jobs = sim_jobs(root, scenarios)
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        futures = {(label, side): pool.submit(sim_run, root, side, label, argv, env, work)
                   for label, argv, _ in jobs for side in SIM_PACKAGES}
        runs = {key: f.result() for key, f in futures.items()}
    runs.update({("--list-scenarios", side): listed[side] for side in SIM_PACKAGES})
    bad, torch_labels, sigpipe = [], [], {side: 0 for side in SIM_PACKAGES}
    for label, _, expect in [("--list-scenarios", None, 0)] + jobs:
        port, ref = runs[(label, "port")], runs[(label, "jax")]
        # Where a SIGPIPE death is allowed (expect None) it is counted, and
        # the sides that lived must exit 0 and agree.
        died = {side: expect is None and runs[(label, side)]["exit_code"] in SIGPIPE_DEATH
                for side in SIM_PACKAGES}
        lived = [side for side in SIM_PACKAGES if not died[side]]
        if expect is None:
            for side in SIM_PACKAGES:
                sigpipe[side] += died[side]
            equal = len(lived) < 2 or port["stdout"] == ref["stdout"]
            ok = equal and all(runs[(label, side)]["exit_code"] == 0 for side in lived)
        else:
            equal = port["stdout"] == ref["stdout"] and port["exit_code"] == ref["exit_code"]
            ok = equal and port["exit_code"] == expect
        own = {side: set(runs[(label, side)]["packages"] or ())
               & (SIM_FOREIGN[side] | {SIM_PACKAGES[side]}) == {SIM_PACKAGES[side]}
               for side in lived}
        imported_torch = "torch" in (port["packages"] or [])
        if imported_torch:
            torch_labels.append(label)
        phase(16, f"simulate {label}", exit_code=[port["exit_code"], ref["exit_code"]],
              equal=equal, stdout_bytes=len(port["stdout"]),
              seconds={"port": round(port["seconds"], 2), "jax": round(ref["seconds"], 2)},
              port_imported_torch=imported_torch, own_package_only=own)
        if not ok or not all(own.values()):
            bad.append({"label": label, "expect": expect, "exit_code": port["exit_code"],
                        "jax_exit_code": ref["exit_code"], "equal": equal, "own": own,
                        "port_stderr": port["stderr"][-1500:],
                        "jax_stderr": ref["stderr"][-1500:]})
    if bad:
        fail(f"the simulator differs between the CLIs: {bad}")
    phase(16, "the simulator through both CLIs", runs=len(runs), all_equal=True,
          port_imported_torch=torch_labels, sigpipe_deaths=sigpipe,
          process_seconds={side: round(sum(r["seconds"] for (_, s), r in runs.items()
                                           if s == side), 2) for side in SIM_PACKAGES},
          seconds=round(time.perf_counter() - t_phase, 2))


LINT_TIMINGS = re.compile(r"^tnc-lint timings: .*$", re.MULTILINE)
LINT_FORMATS = ("human", "json", "sarif")


def lint_run(root: str, side: str, label: str, args: list, env: dict, work: str) -> dict:
    """One cold process of a lint (``side`` "port" or "jax"), ``python -m
    <package>.analysis`` through SIM_CLI_SCRIPT at the checkout's root, in a
    scratch directory of its own (its ``TMPDIR``)."""
    out = sim_run(root, side, label, args, env, work)
    out["stdout"] = out["stdout"].decode()
    return out


def lint_output(side: str, fmt: str, text: str) -> str:
    """A lint's output with the port's package name mapped back to the JAX
    one and the timings masked."""
    if side == "port":
        text = re.sub(r"\btpu_node_checker_torch\b", "tpu_node_checker", text)
    if fmt == "json":
        doc = json.loads(text)
        doc.pop("timings_ms")
        return json.dumps(doc, indent=2, sort_keys=True)
    return LINT_TIMINGS.sub("tnc-lint timings: <masked>", text)


def renamed_corpus(root: str, dst: str) -> str:
    """A copy of the seeded corpus with its package renamed for the port
    (the directory, and the package name in every file; the metric prefix
    ``tpu_node_checker_`` stays)."""
    shutil.copytree(os.path.join(root, "tests", "analysis_fixtures", "repo"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.rename(os.path.join(dst, "tpu_node_checker"), os.path.join(dst, "tpu_node_checker_torch"))
    for dirpath, _, names in os.walk(dst):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path) as f:
                text = f.read()
            with open(path, "w") as f:
                f.write(re.sub(r"\btpu_node_checker\b", "tpu_node_checker_torch", text))
    return dst


def phase17_lint(root: str, smi: str) -> None:
    """Phase 17: the port's tnc-lint and the JAX one, cold processes two at
    a time: both over the checkout (clean), both over the seeded corpus (the
    port's on its renamed copy) in each format, and the port's incremental
    cache, cold and warm, against its full run.  Every port process must
    load no package but its own."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TNC_", "KUBERNETES_SERVICE_"))
           and k not in ("SLACK_WEBHOOK_URL", "KUBECONFIG", "NODE_NAME")}
    work = tempfile.mkdtemp(prefix="chip-smoke-lint-")
    corpus = {"jax": os.path.join(root, "tests", "analysis_fixtures", "repo"),
              "port": renamed_corpus(root, os.path.join(work, "corpus", "repo"))}
    jobs = [("repo", "port", ["analysis", "--format", "json"]),
            ("repo", "jax", ["analysis"])]
    jobs += [(f"corpus {fmt}", side, ["analysis", "--root", corpus[side], "--format", fmt])
             for fmt in LINT_FORMATS for side in SIM_PACKAGES]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        futures = {(label, side): pool.submit(lint_run, root, side, label, args, env, work)
                   for label, side, args in jobs}
        runs = {key: f.result() for key, f in futures.items()}

    repo = runs[("repo", "port")]
    findings = (len(json.loads(repo["stdout"])["findings"]) if repo["exit_code"] == 0
                else None)
    phase(17, "lint the checkout", exit_code={s: runs[("repo", s)]["exit_code"]
                                              for s in SIM_PACKAGES},
          port_findings=findings)
    if repo["exit_code"] != 0 or findings != 0 or runs[("repo", "jax")]["exit_code"] != 0:
        fail(f"the checkout does not lint clean: port {repo['stdout'][-3000:]} "
             f"{repo['stderr'][-1500:]}, jax {runs[('repo', 'jax')]['stdout'][-3000:]}")
    for fmt in LINT_FORMATS:
        port, ref = runs[(f"corpus {fmt}", "port")], runs[(f"corpus {fmt}", "jax")]
        equal = (port["exit_code"] == ref["exit_code"] == 1
                 and lint_output("port", fmt, port["stdout"])
                 == lint_output("jax", fmt, ref["stdout"]))
        phase(17, f"corpus {fmt}", exit_code=[port["exit_code"], ref["exit_code"]],
              equal=equal, stdout_bytes=len(port["stdout"]))
        if not equal:
            fail(f"the lints differ on the corpus in {fmt}: port {port['stderr'][-1500:]}, "
                 f"jax {ref['stderr'][-1500:]}")
    full = json.loads(runs[("corpus json", "port")]["stdout"])

    def verdict(doc: dict) -> dict:
        return {k: v for k, v in doc.items() if k not in ("timings_ms", "cached_files")}

    cache = os.path.join(work, "lint-cache.json")
    incremental = ["analysis", "--root", corpus["port"], "--changed-only", "--cache", cache,
                   "--format", "json"]
    runs[("cache cold", "port")] = lint_run(root, "port", "cache cold", incremental, env, work)
    touched = os.path.join(corpus["port"], "tpu_node_checker_torch", "sample_broad.py")
    with open(touched, "a") as f:
        f.write("# touched\n")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        warm = pool.submit(lint_run, root, "port", "cache warm", incremental, env, work)
        again = pool.submit(lint_run, root, "port", "full after touch",
                            ["analysis", "--root", corpus["port"], "--format", "json"], env,
                            work)
        runs[("cache warm", "port")], runs[("full after touch", "port")] = (
            warm.result(), again.result())
    docs = {label: json.loads(runs[(label, "port")]["stdout"])
            for label in ("cache cold", "cache warm", "full after touch")}
    cached = {label: doc["cached_files"] for label, doc in docs.items()}
    ok = (all(runs[(label, "port")]["exit_code"] == 1 for label in docs)
          and cached["cache cold"] == 0 and cached["cache warm"] > 0
          and verdict(docs["cache cold"]) == verdict(full)
          and verdict(docs["cache warm"]) == verdict(docs["full after touch"]))
    phase(17, "--changed-only --cache", cached_files=cached, equal_to_full_run=ok)
    if not ok:
        fail(f"the incremental lint differs from the full run: {cached}")

    foreign = {label: run["packages"] for (label, side), run in runs.items()
               if run["packages"] != [SIM_PACKAGES[side]]}
    phase(17, "tnc-lint runs", card=smi, own_package_only=not foreign,
          runs={f"{side} {label}": {"exit_code": run["exit_code"],
                                    "seconds": round(run["seconds"], 3)}
                for (label, side), run in runs.items()},
          seconds=round(time.perf_counter() - t_phase, 2))
    if foreign:
        fail(f"a lint process loaded another package: {foreign}")


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        fail(f"torch does not import: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from tpu_node_checker_torch import ops
        from tpu_node_checker_torch.ops import _build, pallas_probe
        from tpu_node_checker_torch.ops.dma_probe import dma_stream_reference
        from tpu_node_checker_torch.ops.flash_attention import causal_attention_reference
        from tpu_node_checker_torch.ops.int8_probe import int8_chain_reference
        from tpu_node_checker_torch.ops.pallas_probe import tiled_matmul_reference
        from tpu_node_checker_torch.probe.schema import validate_report
    except ImportError as exc:
        fail(f"the tpu_node_checker_torch package is not beside this script: {exc}")
    if not os.path.abspath(ops.__file__).startswith(root + os.sep):
        fail(f"imported {ops.__file__}, not the package beside this script in {root}")
    import torch.nn.functional as F

    # The probes' f32 products (the pipeline's and the MoE layer's, the
    # plain versions) need full f32; TF32 is off unless a caller turns it on,
    # and the default is what the probe child runs with (held in phase 6).
    # Read here, before this script sets anything: the flags, and a 1024^2
    # f32 product against f64 (TF32 keeps 10 mantissa bits, about 1e-3).
    dev = torch.device("cuda:0")
    a, b = (torch.randn((1024, 1024), device=dev) for _ in range(2))
    exact = a.double() @ b.double()
    tf32_default = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "float32_matmul_precision": torch.get_float32_matmul_precision(),
                    "f32_product_rel_err": float(((a @ b).double() - exact).abs().max()
                                                 / exact.abs().max())}
    del a, b, exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    phase(1, "environment", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
          card=smi, device_count=torch.cuda.device_count())

    # -- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    phase(2, "build", seconds=round(time.perf_counter() - t0, 2),
          libraries=[os.path.relpath(p, root) for p in libs])

    # -- 3. each kernel at the compute probe's shapes, against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def mm_library(a, b):
        return torch.mm(a, b, out_dtype=torch.float32) * 0.5

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    m = k = n = 512
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    out = ops.tiled_matmul(a, b, 0.5)
    torch.cuda.synchronize()
    ref = tiled_matmul_reference(a, b, 0.5)
    err = float((out - ref).abs().max().item())
    rel = matmul_rel_err(out, ref)
    # f32 accumulation in another order (bf16 products are exact in f32).
    mm_tol = 1e-3
    ms, plain_ms, lib_ms = timed_turns(
        torch,
        lambda: ops.tiled_matmul(a, b, 0.5),
        lambda: tiled_matmul_reference(a, b, 0.5),
        lambda: mm_library(a, b),
    )
    dev_ms = device_ms(torch, lambda: ops.tiled_matmul(a, b, 0.5), "tiled_matmul_kernel")
    lib_dev_ms = device_ms(torch, lambda: mm_library(a, b))
    bms, by = matmul_bound(m, k, n)
    rows.append(dict(
        name="tiled_matmul", route="cuda",
        source="tpu_node_checker_torch/ops/csrc/tiled_matmul.cu",
        replaces="tpu_node_checker/ops/pallas_probe.py:54",
        max_abs_err=err, check=f"max|d|/max(|ref|,1) = {rel:.3e} < {mm_tol}", ok=rel < mm_tol,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms, shape=[m, k, n],
    ))

    r_, c_, chunk = 4096, 512, 256
    x = torch.randn((r_, c_), generator=gen, device=dev)
    out = ops.dma_stream(x, chunk)
    torch.cuda.synchronize()
    ref = dma_stream_reference(x)
    exact = bool(torch.equal(out, ref))
    ms, plain_ms, lib_ms = timed_turns(
        torch,
        lambda: ops.dma_stream(x, chunk),
        lambda: dma_stream_reference(x),
        lambda: x.mul(2).add_(1),
    )
    dev_ms = device_ms(torch, lambda: ops.dma_stream(x, chunk), "dma_stream_kernel")
    lib_dev_ms = device_ms(torch, lambda: x.mul(2).add_(1))
    bms, by = bound(8 * r_ * c_, 2 * r_ * c_, F32_FLOPS)
    rows.append(dict(
        name="dma_stream", route="cuda",
        source="tpu_node_checker_torch/ops/csrc/dma_stream.cu",
        replaces="tpu_node_checker/ops/dma_probe.py:105",
        max_abs_err=float((out - ref).abs().max().item()), check="torch.equal (exact)",
        ok=exact, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms, shape=[r_, c_, chunk],
    ))

    shape = (1, 2, 256, 128)
    q, kk, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    out = ops.flash_forward(q, kk, v)
    torch.cuda.synchronize()
    ref = causal_attention_reference(q, kk, v)
    err = float((out.float() - ref.float()).abs().max().item())
    # The probe's own tolerance.  The kernel rounds P to bf16 before P.V and
    # the output to bf16 once: one bf16 step at |x| < 4 is <= 1.6e-2.
    flash_tol = 2e-2
    ms, plain_ms, lib_ms = timed_turns(
        torch,
        lambda: ops.flash_forward(q, kk, v),
        lambda: causal_attention_reference(q, kk, v),
        lambda: sdpa(q, kk, v),
    )
    dev_ms = device_ms(torch, lambda: ops.flash_forward(q, kk, v), "flash_forward_kernel")
    lib_dev_ms = device_ms(torch, lambda: sdpa(q, kk, v))
    bms, by = flash_bound(shape)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="tpu_node_checker_torch/ops/csrc/flash_attention.cu",
        replaces="tpu_node_checker/ops/flash_attention.py:108",
        max_abs_err=err, check=f"max|d| = {err:.3e} < {flash_tol}", ok=err < flash_tol,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms, shape=list(shape),
    ))

    # The int8 chain at the probe's chain: 128 products of 1024^3.  Its
    # library form is the plain chain with the right operand column-major.
    m = k = n = 1024
    iters = 128
    a8, b8 = (torch.randint(-8, 8, (1024, 1024), generator=gen, device=dev).to(torch.int8)
              for _ in range(2))
    b8_cols = b8.t().contiguous().t()
    out = ops.int8_chain(a8, b8, iters)
    torch.cuda.synchronize()
    ref = int8_chain_reference(a8, b8, iters)
    exact = bool(torch.equal(out, ref)) and bool(
        torch.equal(int8_chain_reference(a8, b8_cols, iters), ref))
    ms, plain_ms, lib_ms = timed_turns(
        torch,
        lambda: ops.int8_chain(a8, b8, iters),
        lambda: int8_chain_reference(a8, b8, iters),
        lambda: int8_chain_reference(a8, b8_cols, iters),
    )
    dev_ms = device_ms(torch, lambda: ops.int8_chain(a8, b8, iters), "int8_chain_kernel")
    lib_dev_ms = device_ms(torch, lambda: int8_chain_reference(a8, b8_cols, iters))
    # int8 a and b read once, the int32 sums written once; 2mkn operations a
    # product at the card's int8 rate.
    bms, by = bound(m * k + k * n + 4 * m * n, 2.0 * m * k * n * iters, INT8_OPS)
    rows.append(dict(
        name="int8_chain", route="cuda",
        source="tpu_node_checker_torch/ops/csrc/int8_chain.cu",
        replaces="tpu_node_checker/ops/int8_probe.py:38",
        max_abs_err=float((out - ref).abs().max().item()), check="torch.equal (exact)",
        ok=exact, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        device_ms=dev_ms, library_device_ms=lib_dev_ms, shape=[m, k, n, iters],
        share_of_bound=bms / dev_ms if dev_ms else None,
    ))
    del a8, b8, b8_cols, out, ref
    rows.append(burn_product_row(torch, ops, dev, gen))
    torch.cuda.empty_cache()
    for r in rows:
        phase(3, f"kernel {r['name']}", **{k2: r[k2] for k2 in (
            "ok", "check", "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "share_of_bound", "card") if k2 in r})
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # One large shape per tensor-core kernel, where the card and not the
    # launch sets the time: each held against its plain version first, then
    # its device time beside the library's and the share of its bound.
    large = {}
    m = k = n = 4096
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    out = ops.tiled_matmul(a, b, 0.5)
    torch.cuda.synchronize()
    ref = tiled_matmul_reference(a, b, 0.5)
    rel = matmul_rel_err(out, ref)
    dev_ms = device_ms(torch, lambda: ops.tiled_matmul(a, b, 0.5), "tiled_matmul_kernel")
    bms, by = matmul_bound(m, k, n)
    large["tiled_matmul"] = dict(
        shape=[m, k, n], ok=rel < mm_tol, check=f"max|d|/max(|ref|,1) = {rel:.3e} < {mm_tol}",
        device_ms=dev_ms, library_device_ms=device_ms(torch, lambda: mm_library(a, b)),
        bound_ms=bms, bound_by=by, share_of_bound=bms / dev_ms if dev_ms else None,
    )
    # Every tile the kernel is built for, at this shape, through its C entry
    # (the wrapper picks one): the device time that the wrapper's choice
    # rests on, each tile held against the plain version.  A tree from
    # before the tile dispatch has no tiles to compare.
    tiles = {}
    for bm, bn in getattr(pallas_probe, "KERNEL_TILES", ()):
        def run_tile(bm=bm, bn=bn):
            _build.launch("tiled_matmul", dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                          k, bm, bn, 0.5)

        out.zero_()
        run_tile()
        torch.cuda.synchronize()
        tiles[f"{bm}x{bn}"] = dict(
            ok=matmul_rel_err(out, ref) < mm_tol,
            device_ms=device_ms(torch, run_tile, "tiled_matmul_kernel"),
        )
    large["tiled_matmul"]["tiles"] = tiles
    large["tiled_matmul"]["ok"] &= all(t["ok"] for t in tiles.values())
    del a, b, out, ref

    shape = (1, 16, 4096, 128)
    q, kk, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    out = ops.flash_forward(q, kk, v)
    torch.cuda.synchronize()
    ref = causal_attention_reference(q, kk, v)
    err = float((out.float() - ref.float()).abs().max().item())
    row = row_rel_err(out, ref)
    # The same check on a planted fault: the last 64-key tile before the
    # diagonal (keys 3968..4031) dropped from the rows past it, where the
    # outputs are smallest.  The limit must sit between the two readings.
    row_tol = 0.1
    faulty = attention_dropping_keys(torch, q, kk, v, 3968, 4032)
    fault = row_rel_err(faulty, ref)
    fault_abs = float((faulty.float() - ref.float()).abs().max().item())
    del faulty
    dev_ms = device_ms(torch, lambda: ops.flash_forward(q, kk, v), "flash_forward_kernel")
    bms, by = flash_bound(shape)
    large["flash_attention"] = dict(
        shape=list(shape), ok=row < row_tol < fault and err < flash_tol,
        check=(f"max over rows of max|d|/rms(ref row) = {row:.3e} < {row_tol} < {fault:.3e} "
               f"(one K/V tile dropped, max|d| {fault_abs:.3e}); max|d| = {err:.3e} < {flash_tol}"),
        device_ms=dev_ms, library_device_ms=device_ms(torch, lambda: sdpa(q, kk, v)),
        bound_ms=bms, bound_by=by, share_of_bound=bms / dev_ms if dev_ms else None,
    )
    del q, kk, v, out, ref
    torch.cuda.empty_cache()
    phase(3, "large shapes", **large)
    bad = [name for name, r in large.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions at the large shapes: {bad}")

    # -- 4. the main path through its entry point, then the probes in-process
    ops.reset_launches()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "compute"],
        capture_output=True, text=True, cwd=root, timeout=600,
        env={**os.environ, "TNC_SCHEMA_STRICT": "1"},
    )
    main_s = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"the entry point printed no report (exit {proc.returncode}): {proc.stderr[-2000:]}")
    launches = report.get("kernel_launches") or {}
    violations = validate_report(report)
    phase(4, "main path", exit_code=proc.returncode, seconds=round(main_s, 2),
          ok=report.get("ok"), error=report.get("error"),
          child_elapsed_ms=report.get("elapsed_ms"),
          dispatch_overhead_ms=report.get("dispatch_overhead_ms"),
          pallas_ok=report.get("pallas_ok"), dma_ok=report.get("dma_ok"),
          flash_attention_ok=report.get("flash_attention_ok"), int8_ok=report.get("int8_ok"),
          matmul_tflops=report.get("matmul_tflops"), int8_tops=report.get("int8_tops"),
          hbm_gbps=report.get("hbm_gbps"), dma_gbps=report.get("dma_gbps"),
          kernel_launches=launches, schema_violations=violations,
          perf_floor=report.get("perf_floor"))
    if proc.returncode != 0 or not report.get("ok"):
        fail(f"compute-level probe not healthy: {report.get('error')}")
    for key in ("pallas_ok", "dma_ok", "flash_attention_ok", "int8_ok"):
        if report.get(key) is not True:
            fail(f"{key} is {report.get(key)!r}")
    if violations:
        fail(f"report violates the schema: {violations}")
    check_launches("the main path", launches)
    for r in rows:
        r["launches"] = launches[r["name"]]

    # The probe child's start-up, in parts: a fresh interpreter importing torch,
    # then the CUDA context, then the first library product on the card.
    startup = subprocess.run(
        [sys.executable, "-c", STARTUP_SCRIPT], capture_output=True, text=True,
        cwd=root, timeout=300, check=True,
    )
    phase(4, "child start-up", **json.loads(startup.stdout.strip().splitlines()[-1]))

    # The compute probes in this process, at the child's card sizes, each timed
    # on the host clock: where the main path's wall time goes.
    ops.reset_launches()
    probes = {}
    seconds = {}
    for name, run in (
        ("burn", lambda: ops.matmul_burn(iters=64, device=dev)),
        ("hbm", lambda: ops.hbm_bandwidth_probe(device=dev)),
        ("tiled_matmul", lambda: ops.pallas_matmul_probe(device=dev)),
        ("int8", lambda: ops.int8_matmul_probe(m=1024, k=1024, n=1024, iters=128, device=dev)),
        ("flash_attention", lambda: ops.flash_attention_probe(seq=256, device=dev)),
        ("dma_stream", lambda: ops.dma_stream_probe(device=dev)),
        ("memtest", lambda: ops.hbm_pattern_probe(device=dev)),
    ):
        t0 = time.perf_counter()
        probes[name] = run()
        seconds[name] = round(time.perf_counter() - t0, 4)
    in_process = ops.launch_counts()
    phase(4, "in-process probes", launches=in_process, seconds=seconds,
          ok={name: p.ok for name, p in probes.items()},
          errors={name: p.error for name, p in probes.items() if p.error})
    bad = [name for name, p in probes.items() if not p.ok]
    if bad:
        fail(f"in-process probes failed: {bad}")
    check_launches("the in-process probes", in_process)

    # A second capture of one label keeps its memory (ops/_harness.py
    # card_graph): the soak's stream leg twice after the probes above, each
    # capture into the label's kept pool; the second maps no memory and
    # synchronises no stream.
    from tpu_node_checker_torch.probe import spans as probe_spans

    kept_round = probe_spans.Round()
    with probe_spans.active(kept_round):
        first = ops.hbm_bandwidth_probe(mib=128, iters=2, device=dev)
        before = probe_spans.allocator_counts(dev)
        second = ops.hbm_bandwidth_probe(mib=128, iters=2, device=dev)
        after = probe_spans.allocator_counts(dev)
    moved = {k: after[k] - before[k] for k in before}
    phase(4, "a second capture of one label", ok=[first.ok, second.ok],
          gbps=[first.gbps, second.gbps], allocator=moved, counters=kept_round.counters)
    if not (first.ok and second.ok):
        fail(f"the stream leg failed: {first.error or second.error}")
    if moved["num_device_alloc"] or moved["num_sync_all_streams"]:
        fail(f"a second capture of one label mapped memory or synchronised: {moved}")
    if kept_round.counters.get("graph_pool_reuses") != 2:
        fail(f"the captures did not reuse the label's kept pool: {kept_round.counters}")

    # -- 5. the workload path: the training step in this process, then the
    # workload-level probe through its entry point.
    import dataclasses

    from tpu_node_checker_torch.meshprobe import mesh_link_sweep
    from tpu_node_checker_torch.models.burnin import (
        BurninConfig, _loss, make_train_step, workload_probe,
    )
    from tpu_node_checker_torch.parallel import (
        RankGroup, collective_probe, fold, ring_attention_probe, ring_probe,
    )

    cfg = BurninConfig()
    steps = 3  # the workload probe's default
    shape = (cfg.batch, cfg.n_heads, cfg.seq, cfg.head_dim)
    q, kk, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    out = ops.flash_forward(q, kk, v)
    torch.cuda.synchronize()
    ref = causal_attention_reference(q, kk, v)
    err = float((out.float() - ref.float()).abs().max().item())
    row = row_rel_err(out, ref)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, kk, v))
    gout = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def plain_backward():
        # What the step's backward runs: autograd over the plain version on
        # the saved q/k/v, its forward recomputed.
        return torch.autograd.grad(causal_attention_reference(qg, kg, vg), (qg, kg, vg), gout)

    grads = plain_backward()
    ms, plain_ms, lib_ms = timed_turns(
        torch,
        lambda: ops.flash_forward(q, kk, v),
        lambda: causal_attention_reference(q, kk, v),
        lambda: sdpa(q, kk, v),
    )
    kernel_d32 = dict(
        shape=list(shape), ok=err < flash_tol, max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        check=f"max|d| = {err:.3e} < {flash_tol}; max over rows of max|d|/rms(ref row) = {row:.3e}",
        device_ms=device_ms(torch, lambda: ops.flash_forward(q, kk, v), "flash_forward_kernel"),
        plain_forward_device_ms=device_ms(torch, lambda: causal_attention_reference(q, kk, v)),
        plain_backward_device_ms=device_ms(torch, plain_backward),
        library_device_ms=device_ms(torch, lambda: sdpa(q, kk, v)),
        grad_dtypes=sorted({str(g.dtype) for g in grads}),
    )
    kernel_d32["bound_ms"], kernel_d32["bound_by"] = flash_bound(shape)
    phase(5, "flash kernel at the training step's shape", **kernel_d32)
    if not kernel_d32["ok"]:
        fail(f"flash kernel disagrees with its plain version at {shape}: {kernel_d32['check']}")
    del q, kk, v, out, ref, qg, kg, vg, gout, grads

    # One step from the same weights, flash kernel against plain attention.
    # The two paths round to bf16 at different points (the kernel rounds P
    # before P.V, the plain path the normalised probabilities; the flash
    # backward runs the plain version in f32), so the loss is held to 1e-3
    # relative and each gradient to 5e-2 in relative L2 norm (the plain
    # version of both paths on the CPU agree within 1.1e-2).
    loss_rtol, grad_rtol = 1e-3, 5e-2
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    state = None
    step_out = {}
    for att in ("xla", "flash"):
        c = dataclasses.replace(cfg, attention=att)
        train_step, init_fn = make_train_step(c, device=dev)
        model, opt = init_fn(seed=0, state=state)
        state = state or {n: t.detach().clone() for n, t in model.state_dict().items()}
        before = ops.launch_counts()["flash_attention"]
        loss = _loss(model, tokens)
        loss.backward()
        torch.cuda.synchronize()
        step_out[att] = dict(
            loss=float(loss.detach()), launches=ops.launch_counts()["flash_attention"] - before,
            grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
        )
        # The whole step (forward, backward, Adam) on the host clock, each
        # step ending in a fetch of its loss, as the probe times it.
        float(train_step(model, opt, tokens))
        t0 = time.perf_counter()
        for _ in range(10):
            float(train_step(model, opt, tokens))
        step_out[att]["step_ms"] = (time.perf_counter() - t0) / 10 * 1e3
        step_out[att]["step_device_ms"] = device_ms(
            torch, lambda: train_step(model, opt, tokens), reps=5)
        del model, opt
    fl, xl = step_out["flash"], step_out["xla"]
    loss_rel = abs(fl["loss"] - xl["loss"]) / abs(xl["loss"])
    grad_rel = {n: rel_l2(fl["grads"][n], g) for n, g in xl["grads"].items()}
    step_ok = (loss_rel < loss_rtol and max(grad_rel.values()) < grad_rtol
               and fl["launches"] == cfg.n_layers and xl["launches"] == 0)
    phase(5, "training step, flash against plain attention", ok=step_ok,
          check=(f"|loss_flash - loss_xla|/loss_xla = {loss_rel:.3e} < {loss_rtol}; "
                 f"max over parameters of ||g_flash - g_xla||/||g_xla|| = "
                 f"{max(grad_rel.values()):.3e} < {grad_rtol}"),
          loss_flash=fl["loss"], loss_xla=xl["loss"], grad_rel_l2=grad_rel,
          flash_launches_per_step=fl["launches"],
          step_ms_flash=fl["step_ms"], step_ms_xla=xl["step_ms"],
          step_device_ms_flash=fl["step_device_ms"], step_device_ms_xla=xl["step_device_ms"])
    if not step_ok:
        fail("the flash training step disagrees with the plain-attention step")
    del step_out, fl, xl

    # The workload level's blocks in this (warm) process, each on the host
    # clock: where the level's time goes after the child's start-up.  The
    # group holds one rank per card; on one card none is spawned (rank 0 is
    # the caller), and a spawned rank would pay phase 4's child start-up.
    seconds, block_ok = {}, {}
    t0 = time.perf_counter()
    with RankGroup(torch.cuda.device_count(), "cuda", timeout_s=120) as group:
        seconds["rank_group_start"] = time.perf_counter() - t0
        for name, fn, kw in (
            ("collective", collective_probe, {}),
            ("ring", ring_probe, {}),
            ("mesh", mesh_link_sweep, {}),
            ("ring_attention", ring_attention_probe, {"seq_per_device": 16}),
        ):
            t1 = time.perf_counter()
            block_ok[name] = fold(group.run(fn, **kw)).ok
            seconds[name] = time.perf_counter() - t1
        t1 = time.perf_counter()
        wl_in = workload_probe(dataclasses.replace(cfg, attention="flash"), device=dev)
        seconds["workload"] = time.perf_counter() - t1
        block_ok["workload"] = wl_in.ok
        t1 = time.perf_counter()
    seconds["rank_group_close"] = time.perf_counter() - t1
    phase(5, "in-process workload blocks", ranks=group.world_size,
          spawned_ranks=group.world_size - 1, ok=block_ok,
          seconds={k: round(v, 4) for k, v in seconds.items()},
          workload_step_ms=wl_in.step_time_ms, workload_losses=list(wl_in.losses))
    bad = [name for name, ok_ in block_ok.items() if not ok_]
    if bad:
        fail(f"workload blocks failed in-process: {bad}")
    fresh = subprocess.run(
        [sys.executable, "-c", FRESH_BLOCKS_SCRIPT], capture_output=True, text=True,
        cwd=root, timeout=300,
    )
    try:
        fresh_blocks = json.loads(fresh.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"the fresh-process workload blocks printed nothing (exit {fresh.returncode}): "
             f"{fresh.stderr[-2000:]}")
    phase(5, "fresh-process workload blocks", **fresh_blocks)
    if not fresh_blocks["ok"]:
        fail("workload blocks failed in a fresh process")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_node_checker_torch", "--emit-probe", "-",
         "--probe-level", "workload"],
        capture_output=True, text=True, cwd=root, timeout=900,
        env={**os.environ, "TNC_SCHEMA_STRICT": "1"},
    )
    wl_s = time.perf_counter() - t0
    try:
        wl = json.loads(proc.stdout)
    except json.JSONDecodeError:
        fail(f"the workload entry point printed no report (exit {proc.returncode}): "
             f"{proc.stderr[-2000:]}")
    wl_launches = wl.get("kernel_launches") or {}
    violations = validate_report(wl)
    losses = wl.get("workload_losses") or []
    verdicts = {key: wl.get(key) for key in (
        "collective_ok", "ring_ok", "mesh_ok", "workload_ok", "ring_attention_ok")}
    extra_flash = wl_launches.get("flash_attention", 0) - launches.get("flash_attention", 0)
    phase(5, "workload path", exit_code=proc.returncode, seconds=round(wl_s, 2),
          ok=wl.get("ok"), error=wl.get("error"), child_elapsed_ms=wl.get("elapsed_ms"),
          **verdicts, workload_losses=losses, workload_step_ms=wl.get("workload_step_ms"),
          workload_devices=wl.get("workload_devices"),
          collective_latency_us=wl.get("collective_latency_us"),
          collective_legs_ok=wl.get("collective_legs_ok"),
          ring_link_gbps=wl.get("ring_link_gbps"), mesh_n_links=wl.get("mesh_n_links"),
          kernel_launches=wl_launches, flash_launches_over_compute=extra_flash,
          schema_violations=violations)
    if proc.returncode != 0 or not wl.get("ok"):
        fail(f"workload-level probe not healthy: {wl.get('error')}")
    if violations:
        fail(f"workload report violates the schema: {violations}")
    bad = [key for key, val in verdicts.items() if val is not True]
    if bad:
        fail(f"workload report verdicts not true: {bad}")
    if len(losses) != steps or not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"workload losses do not strictly fall: {losses}")
    if extra_flash < cfg.n_layers * steps:
        fail(f"the training step launched the flash kernel {extra_flash} times, "
             f"fewer than n_layers x steps = {cfg.n_layers * steps}")
    check_launches("the workload path", wl_launches)
    for r in rows:
        r["compute_launches"] = r["launches"]
        r["launches"] = wl_launches[r["name"]]
    # The flash kernel's second shape on the main path: the training step's.
    next(r for r in rows if r["name"] == "flash_attention")["training_step"] = kernel_d32

    # -- 6. the multi-axis paths, on one card: the per-axis block through the
    # entry point, then the sharded step, pipeline and MoE in a one-rank
    # NCCL group (NCCL takes a send to and a receive from its own rank).
    phase6_paths(torch, root, dev, cfg, rows, tf32_default, validate_report)

    # -- 7. the emitter's deployed command lines and the fleet checker
    phase7_emitter(torch, root, rows, validate_report)

    # -- 8. the emitter pod's operator modes
    phase8_operator_modes(torch, root, rows)

    # -- 9. distributed probing on one card
    phase9_distributed(root, rows, validate_report)

    # -- 10. the one-shot fleet round over a NodeList
    phase10_oneshot(torch, root, rows, validate_report)

    # -- 11. the CronJob's live round against a fake API server
    phase11_live_round(torch, root, rows, validate_report)

    # -- 12. the aggregator's --watch loop against a fake API server
    phase12_watch_loop(torch, root, rows, validate_report)

    # -- 13. the aggregator's quarantine on this card's reports
    quarantine = phase13_quarantine(torch, root, rows, validate_report)

    # -- 14. the aggregator Deployment as written, on the same reports
    phase14_deployment(torch, root, rows, validate_report, quarantine)

    # -- 15. the federation tier over two clusters, one graded on this card
    phase15_federation(torch, root, rows, validate_report)

    # -- 16. the simulate subcommand through both CLIs
    phase16_simulator(root)

    # -- 17. tnc-lint over the checkout and the seeded corpus
    phase17_lint(root, smi)

    # -- 18. the kernels line, the card line, the result line
    keys = ("name", "route", "source", "replaces", "launches", "compute_launches",
            "emitter_launches", "selftest_launches", "calibrate_launches",
            "distributed_launches", "oneshot_launches", "live_round_launches", "watch_launches",
            "quarantine_launches", "deployment_launches", "federation_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "share_of_bound", "ok", "check", "training_step", "card")
    print(json.dumps({"kernels": [{k2: r[k2] for k2 in keys if k2 in r} for r in rows]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
