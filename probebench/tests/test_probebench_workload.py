"""The four-card workload cell on the CPU: its training step's reference held
against the port's, the readers of its metrics over synthetic traces, the
captures of the ranks the probe child spawns, and whole runs on four gloo
ranks, sound and with one rank's loss altered where it is produced."""

import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import core, control, driver, judge  # noqa: E402
from probebench.core import Run, load_reader  # noqa: E402
from probebench.reference import burnin, burnin_grad, burnin_step, burnin_update  # noqa: E402

CELL = "acceptance-workload-4card"
LIMITS = json.loads((ROOT / "probebench" / "cells" / f"{CELL}.json").read_text())["limits"]

# The probe child sees one CPU "card"; on the CPU this makes its rank group
# four gloo ranks, as the port's sharded-step tests run it, so the workload
# level shards its step data 2 x model 2 and runs the fabric probes on four.
FOUR_GLOO_RANKS = """
    import sys
    if sys.argv[:2] == ["-c", "workload"]:
        from tpu_node_checker_torch.parallel import mesh as _mesh
        _init = _mesh.RankGroup.__init__
        def _four(self, world_size, device_type="cuda", *args, **kwargs):
            _init(self, 4 if device_type == "cpu" else world_size, device_type, *args, **kwargs)
        _mesh.RankGroup.__init__ = _four
"""
# The training step's faults, planted in every process of the group (the
# probe child is rank 0; "--multiprocessing-fork" marks a spawned rank).
IN_EVERY_RANK = """
    if sys.argv[:2] == ["-c", "workload"] or "--multiprocessing-fork" in sys.argv:
        import torch.distributed as _dist
        from tpu_node_checker_torch.models import burnin as _burnin
"""
FAULTS = {
    # A step that returns its state unchanged: Adam's update skipped.
    "state_unchanged": """
        _burnin._Adam.step = lambda self: None
    """,
    # Half of the batch left out, the mean taken over the rest.
    "half_batch": """
        _loss = _burnin._loss
        _burnin._loss = lambda model, tokens: _loss(model, tokens[: max(1, tokens.shape[0] // 2)])
    """,
    # The exchange between cards left out: no gradient or loss averaged over data.
    "exchange_left_out": """
        _burnin._data_parallel = lambda model, loss, mesh: loss
    """,
    # An answer altered where it is produced: rank 2's loss off by 2**-7,
    # inside the probe's own verdict (the loss still falls).
    "rank2_loss_altered": """
        _dp = _burnin._data_parallel
        def _altered(model, loss, mesh):
            out = _dp(model, loss, mesh)
            return out * (1 + 2 ** -7) if _dist.get_rank() == 2 else out
        _burnin._data_parallel = _altered
    """,
}


# -- the reference against the port ------------------------------------------

def burnin_inputs(cfg):
    """The state and tokens the port's ``train_steps`` starts from (seed 0),
    as the hook records them: the state's layout and one float32 vector."""
    from tpu_node_checker_torch.models.burnin import Burnin

    state = Burnin(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1))
    args = {"vocab": cfg.vocab, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "d_ff": cfg.d_ff, "n_layers": cfg.n_layers, "seq": cfg.seq, "batch": cfg.batch,
            "learning_rate": 1e-3, "state": [[k, list(t.shape)] for k, t in state.items()]}
    flat = np.concatenate([t.numpy().reshape(-1) for t in state.values()]
                          + [tokens.numpy().astype(np.float32).reshape(-1)])
    return args, flat.astype(np.float32)


def _sharded_losses(cfg):
    from tpu_node_checker_torch.models.burnin import train_steps
    from tpu_node_checker_torch.parallel.mesh import MeshSpec, RankGroup

    spec = MeshSpec((("data", 2), ("model", 2)))
    with RankGroup(4, "cpu", timeout_s=120) as group:
        results = group.run(train_steps, cfg, spec, 3)
    losses = [r[0] for r in results]
    assert all(l == losses[0] for l in losses)
    return losses[0]


def _program_steps(cfg, mesh):
    """The port's three steps from seed 0, as the hook reads them on each
    rank: the losses, the first gradient's leaf norms (from Adam's first
    moment), the change's leaf norms, and where the rank's leaves split."""
    from tpu_node_checker_torch.models.burnin import make_train_step

    step, init_fn = make_train_step(cfg, mesh, device="cpu")
    model, opt = init_fn(0)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1))
    start = [p.detach().clone() for p in opt.params]
    losses = []
    for i in range(3):
        losses.append(float(step(model, opt, tokens)))
        if i == 0:
            grads = [float((m / (1 - opt.b1)).double().norm()) for m in opt.mu]
    change = [float((p.detach() - p0).double().norm()) for p, p0 in zip(opt.params, start)]
    full = dict(model.named_parameters())
    return losses, grads, change, model.mp.index, model.mp.count, {
        n: list(p.shape) for n, p in full.items()}


def _rank_leaves(args, shapes):
    return [[n, next((d for d, (a, b) in enumerate(zip(shape, shapes[n])) if a != b), -1)]
            for n, shape in args["state"]]


def _sharded_steps(cfg):
    from tpu_node_checker_torch.parallel.mesh import MeshSpec, RankGroup

    spec = MeshSpec((("data", 2), ("model", 2)))
    with RankGroup(4, "cpu", timeout_s=120) as group:
        return group.run(_program_steps, cfg, spec)


@pytest.mark.parametrize("mesh", ["unsharded", "data2_model2"])
def test_the_reference_follows_the_ports_steps_within_the_limits(mesh):
    from tpu_node_checker_torch.models.burnin import BurninConfig

    cfg = BurninConfig()
    args, inputs = burnin_inputs(cfg)
    ranks = [_program_steps(cfg, None)] if mesh == "unsharded" else _sharded_steps(cfg)
    for losses, grads, change, index, count, shapes in ranks:
        per_leaf = dict(args, steps=3, leaves=_rank_leaves(args, shapes), model_index=index,
                        model_count=count)
        for module, got in ((burnin_step, losses), (burnin_grad, grads),
                            (burnin_update, change)):
            name, gap = module.compare(per_leaf, inputs, np.array(got), "cpu")
            assert name == module.CHECK
            assert 0 < gap <= LIMITS[name], (name, gap)


def test_the_control_one_precision_down_fails_a_limit():
    from tpu_node_checker_torch.models.burnin import BurninConfig

    args, inputs = burnin_inputs(BurninConfig())
    per_leaf = dict(args, steps=3, leaves=[[n, -1] for n, _ in args["state"]], model_index=0,
                    model_count=1)
    f64 = burnin.trained(args, inputs, 3, "cpu")["losses"]
    failed = [m.CHECK for m in (burnin_step, burnin_grad, burnin_update)
              if m.compare(per_leaf, inputs, m.control(per_leaf, inputs, f64, "cpu"), "cpu")[1]
              > LIMITS[m.CHECK]]
    assert failed
    # The loss falls in the reference too, and starts near ln(vocab).
    assert f64[0] > f64[1] > f64[2] and abs(f64[0] - np.log(256)) < 1.0


def test_the_recorded_vector_must_fit_the_layout():
    from tpu_node_checker_torch.models.burnin import BurninConfig

    args, inputs = burnin_inputs(BurninConfig())
    with pytest.raises(ValueError, match="the layout needs"):
        burnin.unpack(args, inputs[:-1], "cpu")
    state, tokens = burnin.unpack(args, inputs, "cpu")
    assert tokens.shape == (8, 128) and tokens.dtype == torch.long
    assert state["layers.w1"].shape == (2, 128, 512) and state["embed"].dtype == torch.float64


def test_a_leaf_block_and_the_worst_leaf():
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(burnin.block(t, 2, 1, 2), t[:, :, 2:])
    assert torch.equal(burnin.block(t, -1, 1, 2), t)
    # Against the leaf's norm or the median leaf's, whichever is larger.
    assert burnin.worst_leaf_gap([1.1, 0.0, 5.0], [1.0, 0.01, 5.0]) == pytest.approx(0.1)
    assert burnin.worst_leaf_gap([1.0, 1.0], [1.0, 1.0, 1.0]) == float("inf")
    keep = np.array([True, False])
    assert burnin.worst_leaf_gap([1.0, 9.0], [1.0, 1.0], keep) == 0.0


# -- the ranks' captures -------------------------------------------------------

def test_rank_prefixes_are_found_in_rank_order(tmp_path):
    for name in ("round-001.json", "round-001.rank3.json", "round-001.rank1.json",
                 "round-001.rank1.trace.json", "round-001.rank2.json.tmp",
                 "round-0010.rank1.json", "round-002.rank1.json"):
        (tmp_path / name).write_text("{}")
    got = driver.rank_prefixes(str(tmp_path / "round-001"))
    assert got == [(1, str(tmp_path / "round-001.rank1")), (3, str(tmp_path / "round-001.rank3"))]


def _capture(outputs=()):
    return {"chain": [], "invariant": [], "soak": None,
            "outputs": [{"kind": k, "soak": False, "round": 0} for k in outputs]}


def test_outputs_of_every_rank_count_toward_the_round():
    traffic = {"judged": {"burnin_step": 4}}
    ranks = [{"rank": k, "capture": _capture(["burnin_step"]), "arrays": {}} for k in (1, 2, 3)]
    whole = {"capture": _capture(["burnin_step"]), "ranks": ranks}
    assert judge.missing_outputs([whole], traffic) == 0
    lost = {"capture": _capture(["burnin_step"]), "ranks": ranks[:2] + [
        {"rank": 3, "capture": None, "arrays": {}}]}
    assert judge.missing_outputs([lost], traffic) == 1
    assert judge.missing_outputs([{"capture": None, "ranks": ranks}], traffic) == 4


def test_a_warm_up_round_is_held_to_the_warm_up_counts():
    traffic = {"judged": {"tiled": 1, "burnin_step": 4}, "warmup_judged": {"tiled": 1}}
    compute = {"capture": _capture(["tiled"]), "ranks": []}
    assert judge.missing_outputs([dict(compute, warm=True)], traffic) == 0
    # The same round in the window misses its four ranks' steps.
    assert judge.missing_outputs([compute], traffic) == 4
    assert judge.missing_outputs([dict(compute, warm=True)], {"judged": traffic["judged"]}) == 4


def test_the_warm_up_runs_at_its_own_level_and_the_window_at_the_configurations(tmp_path):
    levels = []

    def emit(target, level, soak_s, perf_floor):
        levels.append(level)
        return 0, {"ok": True}

    config = {"probe_level": "workload", "perf_floor": 0.4, "soak_s": 0}
    traffic = {"warmup_rounds": 1, "warmup_level": "compute", "window": "rounds",
               "trace": "rounds"}
    driven = driver.drive(emit, config, traffic, 0.0, False, None, tmp_path)
    assert levels == ["compute", "workload"]
    assert driven["warm"][0]["warm"] and not driven["rounds"][0].get("warm")
    levels.clear()
    driver.drive(emit, config, dict(traffic, warmup_level="workload"), 0.0, False, None, tmp_path)
    del traffic["warmup_level"]
    driver.drive(emit, config, traffic, 0.0, False, None, tmp_path)
    assert levels == ["workload"] * 4


def test_checks_follow_the_traffic_through_the_reference_files():
    traffic = json.loads((ROOT / "probebench/traffic/workload-rounds.json").read_text())
    assert judge.checks_of(traffic)[-3:] == ["workload_loss_gap", "workload_grad_gap",
                                             "workload_update_gap"]
    assert set(judge.checks_of(traffic)) == set(LIMITS)
    with pytest.raises(ValueError, match="no reference for output kind 'nothing'"):
        judge.checks_of({"judged": {"nothing": 1}})
    with pytest.raises(ValueError, match="limits"):
        judge.judge([], traffic, {k: v for k, v in LIMITS.items() if k != "tiled_gap"}, "cpu")


def test_the_control_replaces_every_ranks_losses():
    from tpu_node_checker_torch.models.burnin import BurninConfig

    args, inputs = burnin_inputs(BurninConfig())
    f64 = burnin.trained(args, inputs, 3, "cpu")["losses"]

    def capture():
        meta = _capture()
        meta["outputs"] = [{"kind": "burnin_step", "key": "o0", "idx": "o0_in", "args": args,
                            "soak": False, "round": 0}]
        return meta, {"o0_in": inputs, "o0_val": f64.copy()}

    meta, arrays = capture()
    r = {"rc": 0, "report": {"ok": True}, "capture": meta, "arrays": arrays,
         "ranks": [dict(zip(("capture", "arrays"), capture()), rank=k) for k in (1, 2, 3)]}
    traffic = {"judged": {"burnin_step": 4}}
    limits = {"rounds_failed": 0, "outputs_missing": 0, "report_mismatches": 0,
              "workload_loss_gap": LIMITS["workload_loss_gap"]}
    assert all(c["ok"] for c in judge.judge([r], traffic, limits, "cpu"))
    lowered = control.control_rounds([r], "cpu")[0]
    for k in lowered["ranks"]:
        assert not np.array_equal(k["arrays"]["o0_val"], f64)
    assert not all(c["ok"] for c in judge.judge([lowered], traffic, limits, "cpu"))


# -- the readers, over synthetic traces ---------------------------------------

def kernel(ts, dur, name="k", corr=None):
    return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
            "args": {"correlation": corr}}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": 5, "name": "cudaLaunchKernel",
            "args": {"correlation": corr}}


def step(ts, dur):
    return {"ph": "X", "cat": "user_annotation", "ts": ts, "dur": dur,
            "name": "probebench:workload_step"}


def four_card_round(tmp_path, i, busy_ms, hook=None, first=None):
    """A round of four processes: card c busy ``busy_ms[c]`` ms, two steps
    on each, each launching one 1 ms kernel."""
    procs = []
    for c, ms in enumerate(busy_ms):
        prefix = str(tmp_path / f"r{i}") + ("" if c == 0 else f".rank{c}")
        events = [kernel(0, ms * 1000 - 2000)]
        for j, t in enumerate((10_000_000, 20_000_000)):
            events += [step(t, 50_000), launch(t + 10, 100 * c + j),
                       kernel(t + 100, 1000, "gemm", 100 * c + j)]
        Path(f"{prefix}.trace.json").write_text(json.dumps({"traceEvents": events}))
        cap = dict(hook or {})
        if first is not None:
            cap["first_command_wall"] = first[c]
        procs.append({"prefix": prefix, "capture": cap, "arrays": {}, "rank": c})
    r = dict(procs[0], wall_s=30.0, rc=0, report={"ok": True}, ranks=procs[1:])
    if first is not None:
        r["capture"]["group_starts"] = [[100.0, 105.0]]
    return r


def make_run(rounds, window_s=60.0, trace=True):
    driven = {"warm": [], "rounds": rounds, "window_s": window_s, "t0_wall": 0.0}
    return Run({"chips": 4}, {"window": "rounds"}, trace, 0.0, driven, "cpu")


def test_workload_card_ms_is_the_busiest_spawned_ranks_card_each_round(tmp_path):
    rounds = [four_card_round(tmp_path, 0, [40, 70, 50, 60]),
              four_card_round(tmp_path, 1, [90, 30, 30, 35])]
    run = make_run(rounds)
    # Card 0's 90 ms (its compute probes) is not the cross-card work's.
    assert load_reader("workload_card_ms")(run) == pytest.approx((70 + 35) / 2)
    # The mean over the cards, over the rounds' wall: the device's busy share.
    busy, wall = run.device_window()
    assert busy == pytest.approx((220 + 185) / 4 / 1000) and wall == pytest.approx(60.0)
    assert load_reader("device_idle_share.workload")(run) == pytest.approx(
        100 * (1 - busy / 60.0))
    # A round that lacks a card's trace reads nothing, never 0.
    del rounds[1]["ranks"][2]
    assert load_reader("workload_card_ms")(make_run(rounds)) is None
    assert load_reader("device_idle_share.workload")(make_run(rounds)) is None


def test_nccl_kernels_are_card_time_of_their_own(tmp_path):
    r = four_card_round(tmp_path, 0, [40, 30, 30, 30])
    path = f"{r['ranks'][0]['prefix']}.trace.json"
    doc = json.loads(Path(path).read_text())
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    doc["traceEvents"] += [kernel(30_000_000, 400_000, nccl, 7), launch(10_000_020, 7),
                           kernel(40_000_000, 200_000, nccl)]
    Path(path).write_text(json.dumps(doc))
    run = make_run([r])
    # NCCL holds card 1 for 600 ms; less NCCL each rank's card reads 30 ms.
    assert load_reader("workload_card_ms")(run) == pytest.approx(30.0)
    assert load_reader("nccl_card_ms.workload")(run) == pytest.approx(600.0)
    # A step's NCCL kernel is left out of the step's card time too.
    assert load_reader("step_card_ms.workload")(run) == pytest.approx(1.0)
    busy, _ = run.device_window()
    assert busy == pytest.approx((40 + 630 + 30 + 30) / 4 / 1000)


def test_step_card_ms_is_what_the_steps_launched_over_their_count(tmp_path):
    run = make_run([four_card_round(tmp_path, 0, [40, 70, 50, 60])])
    assert load_reader("step_card_ms.workload")(run) == pytest.approx(1.0)
    assert load_reader("step_card_ms.workload")(
        make_run([four_card_round(tmp_path, 1, [1, 1, 1, 1]) | {"ranks": []}])) == \
        pytest.approx(1.0)


def test_rank_start_and_round_take_out_the_hooks_own_seconds(tmp_path):
    hook = {"trace_start_cost_s": 2.0, "hook_s": 0.5, "write_s": 1.0}
    r = four_card_round(tmp_path, 0, [1, 1, 1, 1], hook=hook,
                        first=[105.1, 112.0, 113.5, 111.0])
    run = make_run([r], window_s=40.0)
    # Rank 2 came last, at 113.5 less its profiler's 2 s start.
    assert load_reader("rank_start_s.workload")(run) == pytest.approx(11.5)
    # The child's 3.5 s and the most one rank spent, 3.5 s.
    assert load_reader("round_s.workload")(run) == pytest.approx(40.0 - 7.0)
    r["ranks"][0]["capture"].pop("first_command_wall")
    assert load_reader("rank_start_s.workload")(run) is None


def test_on_one_card_the_workload_readers_read_nothing(tmp_path):
    r = four_card_round(tmp_path, 0, [5, 5, 5, 5])
    one = Run({"chips": 1}, {"window": "rounds"}, True, 0.0,
              {"warm": [], "rounds": [dict(r, ranks=[])], "window_s": 30.0, "t0_wall": 0.0}, "cpu")
    assert load_reader("probe_card_ms")(one) == 5.0
    assert load_reader("workload_card_ms")(one) is None
    assert load_reader("rank_start_s.workload")(one) is None
    # Four cards' worth of processes where the cell holds one: no card reading.
    assert load_reader("workload_card_ms")(
        Run({"chips": 1}, {"window": "rounds"}, True, 0.0,
            {"warm": [], "rounds": [r], "window_s": 30.0, "t0_wall": 0.0}, "cpu")) is None


TWINS = ("round_s", "device_idle_share", "parent_s", "child_import_s", "torch_import_s",
         "cuda_init_s", "kernel_build_s", "spawn_s", "child_exit_s")


@pytest.mark.parametrize("name", TWINS)
def test_a_workload_reader_is_its_emitter_twins_formula(tmp_path, name):
    hook = {"trace_start_cost_s": 2.0, "hook_s": 0.5, "write_s": 1.0, "hook_age_s": 0.3,
            "first_probe_s": 9.0, "exit_s": 25.0, "torch_import_s": [1.0, 6.5]}
    r = four_card_round(tmp_path, 0, [40, 7, 6, 6], hook=hook)
    ms = {"child.import_torch": [1, 5500.0, 5500.0], "child.cuda_init": [2, 900.0, 800.0],
          "child.kernel_build": [1, 40.0, 40.0], "probe.spawn": [1, 300.0, 300.0],
          "probe.child_exit": [1, 1500.0, 1500.0]}
    r["report"] = {"ok": True, "spans": {"ms": ms, "counters": {}}}
    run = make_run([r], window_s=40.0)
    twin = load_reader(f"{name}.workload")(run)
    assert twin is not None and twin == load_reader(f"{name}.emitter")(run)


# -- whole runs on four gloo ranks --------------------------------------------

@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_workload_cell_on_four_gloo_ranks(capsys, tmp_path, monkeypatch, fault):
    planted = tmp_path / "planted"
    planted.mkdir()
    code = textwrap.dedent(FOUR_GLOO_RANKS)
    if fault:
        code += textwrap.dedent(IN_EVERY_RANK) + textwrap.indent(textwrap.dedent(FAULTS[fault]),
                                                                 "    ")
    (planted / "sitecustomize.py").write_text(code)
    monkeypatch.setenv("PYTHONPATH", str(planted))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    # Five processes a round: one thread each keeps the host's cores for the rest.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = core.main(["--workload", CELL, "--seed", str(2 ** 31 + 41), "--seconds", "0.1",
                    "--trace", "0"], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    checks = line["checks"]
    assert list(checks) == list(LIMITS)
    assert line["device"]["count"] == 4
    # Every round judged four ranks' steps: none missing.
    assert checks["outputs_missing"]["value"] == 0
    failed = [name for name, c in checks.items() if c["value"] > c["limit"]]
    if fault is None:
        assert line["correct"] is True and not failed
        assert all(0 < checks[k]["value"] for k in ("workload_loss_gap", "workload_grad_gap",
                                                    "workload_update_gap"))
    else:
        assert line["correct"] is False
        assert set(failed) & {"workload_loss_gap", "workload_grad_gap", "workload_update_gap"}
        assert "FAILED" in err
