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
   with the device time of the kernel and of the library call side by side;
   then the tiled matmul at 4096^3 (each tile it is built for) and flash
   attention at (1, 16, 4096, 128) (each query row held to its own size,
   the limit shown to catch a dropped K/V tile), each held against its plain
   version, with its share of the bound;
4. main path: the compute-level probe through its entry point
   (``python -m tpu_node_checker_torch --emit-probe - --probe-level compute``),
   which must report healthy, validate against the report schema and show
   every kernel launched; then the three kernel probes in this process, with
   their launch counts;
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
7. the ``kernels`` line (each kernel at the compute probe's shapes, its
   launches counted on the workload path, flash also at the training
   step's shape), then the ``nvidia-smi`` line, then the result line.

Bounds use the H100 SXM data sheet: 3.35 TB/s of device memory, 989 TFLOP/s
bf16 on the tensor cores.  Times are steady-state CUDA-event times over many
back-to-back launches, inputs warm in L2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
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
    missed = [r["name"] for r in rows if not launches.get(r["name"])]
    if missed:
        fail(f"the 1x1 workload path never launched: {missed}")

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
    for r in rows:
        phase(3, f"kernel {r['name']}", **{k2: r[k2] for k2 in (
            "ok", "check", "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by")})
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
    entry = _build.kernel("tiled_matmul")
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = {}
    for bm, bn in getattr(pallas_probe, "KERNEL_TILES", ()):
        def run_tile(bm=bm, bn=bn):
            code = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm, bn, 0.5, stream)
            _build.check("tiled_matmul", code)

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
          flash_attention_ok=report.get("flash_attention_ok"),
          matmul_tflops=report.get("matmul_tflops"), int8_tops=report.get("int8_tops"),
          hbm_gbps=report.get("hbm_gbps"), dma_gbps=report.get("dma_gbps"),
          kernel_launches=launches, schema_violations=violations,
          perf_floor=report.get("perf_floor"))
    if proc.returncode != 0 or not report.get("ok"):
        fail(f"compute-level probe not healthy: {report.get('error')}")
    for key in ("pallas_ok", "dma_ok", "flash_attention_ok"):
        if report.get(key) is not True:
            fail(f"{key} is {report.get(key)!r}")
    if violations:
        fail(f"report violates the schema: {violations}")
    missed = [r["name"] for r in rows if not launches.get(r["name"])]
    if missed:
        fail(f"the main path never launched: {missed}")
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
    bad += [name for name in ops.KERNEL_WRAPPERS if not in_process.get(name)]
    if bad:
        fail(f"in-process probes failed or never launched their kernel: {bad}")

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
        before = ops.flash_forward.launches
        loss = _loss(model, tokens)
        loss.backward()
        torch.cuda.synchronize()
        step_out[att] = dict(
            loss=float(loss.detach()), launches=ops.flash_forward.launches - before,
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
    missed = [r["name"] for r in rows if not wl_launches.get(r["name"])]
    if missed:
        fail(f"the workload path never launched: {missed}")
    for r in rows:
        r["compute_launches"] = r["launches"]
        r["launches"] = wl_launches[r["name"]]
    # The flash kernel's second shape on the main path: the training step's.
    next(r for r in rows if r["name"] == "flash_attention")["training_step"] = kernel_d32

    # -- 6. the multi-axis paths, on one card: the per-axis block through the
    # entry point, then the sharded step, pipeline and MoE in a one-rank
    # NCCL group (NCCL takes a send to and a receive from its own rank).
    phase6_paths(torch, root, dev, cfg, rows, tf32_default, validate_report)

    # -- 7. the kernels line, the card line, the result line
    keys = ("name", "route", "source", "replaces", "launches", "compute_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "ok", "check", "training_step")
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
