"""The DeepSeek-V2-Lite cell on the CPU: its configuration file against the
published config and the program's defaults, the step's model FLOPs
(``work/deepseek_v2_lite.py``) against what PyTorch's flop counter counts,
the readers of its three metrics over synthetic traces and counters, and
whole one-process runs at a small size, sound, with the step's faults
planted, and with the fp8 control in the program's place."""

import dataclasses
import json
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from probebench import control, core  # noqa: E402
from probebench.core import Run, load_reader  # noqa: E402
from probebench.work import deepseek_v2_lite as work  # noqa: E402

CELL = "dsv2-lite-train-1card"
BENCH = ROOT / "probebench"
LIMITS = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())["limits"]
CONFIG = json.loads((BENCH / "configs" / "acceptance-job-dsv2-lite.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"
STEPS = ("dsv2_loss_gap", "dsv2_grad_gap", "dsv2_update_gap", "dsv2_router_gap")
# The tests' small size (tests/test_torch_deepseek_v2.py's), 4 of 16 experts held.
SMALL = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=2,
             num_hidden_layers=3, vocab_size=256, vocab_held=256, held_experts=(0, 4),
             seq=32, batch=2)


def published():
    from tpu_node_checker_torch.models.deepseek_v2 import DeepseekV2Config

    return DeepseekV2Config()


# -- the configuration ---------------------------------------------------------

def test_the_configuration_file_is_the_programs_and_the_published_widths():
    cfg = dataclasses.asdict(published())
    rope = CONFIG["rope_scaling"]
    assert CONFIG["emit"] == {"workload_model": "deepseek-v2-lite"}
    assert "--probe-workload-model=deepseek-v2-lite" in CONFIG["args"]
    same = {"hidden_size": "hidden_size", "num_hidden_layers": "num_hidden_layers",
            "first_k_dense_replace": "first_k_dense_replace",
            "intermediate_size": "intermediate_size",
            "moe_intermediate_size": "moe_intermediate_size",
            "n_routed_experts": "n_routed_experts", "num_experts_per_tok": "num_experts_per_tok",
            "n_shared_experts": "n_shared_experts", "num_attention_heads": "num_attention_heads",
            "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
            "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
            "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
            "routed_scaling_factor": "routed_scaling_factor"}
    for key, field in same.items():
        assert CONFIG[key] == cfg[field], key
    assert (rope["factor"], rope["original_max_position_embeddings"], rope["beta_fast"],
            rope["beta_slow"], rope["mscale"], rope["mscale_all_dim"]) == (
        cfg["rope_factor"], cfg["original_max_position_embeddings"], cfg["beta_fast"],
        cfg["beta_slow"], cfg["mscale"], cfg["mscale_all_dim"])
    # The cut: the card's 8 experts and eighth of the vocabulary, nothing else.
    assert CONFIG["held_experts"] == cfg["held_experts"][1] == 8
    assert CONFIG["vocab_size"] == cfg["vocab_held"] == 12800 == cfg["vocab_size"] // 8
    assert set(CONFIG["reduced"]) == {"held_experts", "vocab_size", "soak_s", "report_path"}
    assert CONFIG["q_lora_rank"] is None and CONFIG["topk_method"] == "greedy"
    assert CONFIG["scoring_func"] == "softmax" and CONFIG["norm_topk_prob"] is False


# -- the step's model FLOPs ----------------------------------------------------

def test_step_flops_is_what_the_flop_counter_counts_over_a_step():
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_node_checker_torch.models import deepseek_v2 as m
    from tpu_node_checker_torch.probe import spans

    cfg = m.DeepseekV2Config(**dict(SMALL, held_experts=(4, 4)), remat=False)
    step, init_fn = m.make_train_step(cfg, device="cpu")
    model, opt = init_fn(0)
    tokens = m.zipf_tokens(cfg, 0)
    round_ = spans.Round()
    with spans.active(round_), FlopCounterMode(display=False) as counter:
        step(model, opt, tokens)  # forward, backward and the update
    held = round_.counters["moe_assignments_held"]
    moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    per_token = held / (moe_layers * cfg.batch * cfg.seq)
    # The counter counts the products the step ran, with the held experts'
    # assignments as they fell; the convention, given that count, agrees to
    # the product.
    assert work.step_flops(dataclasses.asdict(cfg), per_token) == pytest.approx(
        counter.get_total_flops(), rel=1e-12)


def test_the_published_step_is_162_tflop():
    cfg = dataclasses.asdict(published())
    assert work.step_flops(cfg) == pytest.approx(162.5e12, rel=2e-3)
    # Attention over the whole S x S: 1.13 GFLOP a token of the forward.
    attention = 2 * 4 * 16 * 4096 * 4096 * (192 + 128) * 27
    assert attention / (4 * 4096) == pytest.approx(1.13e9, rel=1e-2)


# -- the readers, over synthetic traces ----------------------------------------

def ev(cat, ts, dur, name, corr=None):
    e = {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def dsv2_round(tmp_path, i, counters=None):
    """A round of one step: attention launched on the main thread (200 us),
    its backward on another thread (300 us), the router (50 us), the
    experts (150 us) and the rest (300 us); 1,000 us of step card time."""
    prefix = str(tmp_path / f"r{i}")
    t = 1_000_000
    events = [ev("user_annotation", t, 900_000, "probebench:workload_step")]
    parts = [("tnc:mla.attention", 200), ("tnc:moe.route", 50), ("tnc:moe.experts", 150),
             (None, 300), ("tnc:mla.attention", 300)]
    at = t + 1000
    for k, (name, us) in enumerate(parts):
        if name:
            events.append(ev("user_annotation", at, 100, name))
        events.append(ev("cuda_runtime", at + 10, 5, "cudaLaunchKernel", corr=k))
        events.append(ev("kernel", at + 1000, us, "k", corr=k))
        at += 10_000
    events.append(ev("kernel", 5_000_000, 777, "outside"))
    Path(f"{prefix}.trace.json").write_text(json.dumps({"traceEvents": events}))
    report = {"ok": True, "spans": {"ms": {}, "counters": counters or {}}}
    return {"prefix": prefix, "capture": {}, "arrays": {}, "wall_s": 30.0, "rc": 0,
            "report": report, "ranks": []}


def make_run(rounds):
    driven = {"warm": [], "rounds": rounds, "window_s": 50.0, "t0_wall": 0.0}
    return Run({"chips": 1, "config": "acceptance-job-dsv2-lite"}, {"window": "rounds"}, True,
               0.0, driven, H100)


def test_the_shares_are_the_ranges_card_time_over_the_steps(tmp_path):
    run = make_run([dsv2_round(tmp_path, 0), dsv2_round(tmp_path, 1)])
    assert load_reader("attention_share.dsv2")(run) == pytest.approx(50.0)
    assert load_reader("expert_share.dsv2")(run) == pytest.approx(20.0)
    assert load_reader("train_step_card_ms")(run) == pytest.approx(1.0)


def test_expert_imbalance_is_the_busiest_over_the_mean(tmp_path):
    counters = {"moe_max_expert_tokens": 300, "moe_assignments_held": 960}
    run = make_run([dsv2_round(tmp_path, 0, counters), dsv2_round(tmp_path, 1, counters)])
    assert load_reader("expert_imbalance.dsv2")(run) == pytest.approx(300 / (960 / 8))


@pytest.mark.parametrize("metric", ["attention_share.dsv2", "expert_share.dsv2",
                                    "expert_imbalance.dsv2"])
def test_without_the_programs_ranges_or_counters_a_reader_reads_nothing(tmp_path, metric):
    r = dsv2_round(tmp_path, 0)
    events = json.loads(Path(f"{r['prefix']}.trace.json").read_text())["traceEvents"]
    kept = [e for e in events if not str(e.get("name", "")).startswith("tnc:")]
    Path(f"{r['prefix']}.trace.json").write_text(json.dumps({"traceEvents": kept}))
    assert load_reader(metric)(make_run([r])) is None


# -- whole one-process runs on the CPU ----------------------------------------

IN_THE_WORKLOAD_CHILD = """
    import sys
    if sys.argv[:2] == ["-c", "workload"]:
        import functools
        import torch
        from tpu_node_checker_torch.models import deepseek_v2 as _dsv2
        from tpu_node_checker_torch.parallel import moe as _moe
        _dsv2.DeepseekV2Config = functools.partial(_dsv2.DeepseekV2Config, **%r)
""" % (SMALL,)
FAULTS = {
    # One held expert left out of the combine.
    "held_expert_left_out": """
        _group = _moe.group_by_expert
        def _left_out(topi, first, count):
            tok, slot, counts = _group(topi, first, count)
            keep = tok.numel() - counts[-1]
            return tok[:keep], slot[:keep], counts[:-1] + [0]
        _moe.group_by_expert = _left_out
    """,
    # The router's product taken in bf16: the steps' outputs cannot tell it
    # from the bf16 activations' own rounding, the router's logits can.
    "router_in_bf16": """
        _moe.router_logits = lambda x, w: torch.matmul(x.bfloat16(), w.bfloat16()).float()
    """,
    # The balance loss dropped, its gradient with it.
    "balance_loss_dropped": """
        _moe.balance_coefficients = (
            lambda topi, batch, n, alpha: torch.zeros((batch, n), device=topi.device))
    """,
}


def plant(tmp_path, monkeypatch, fault=None):
    planted = tmp_path / "planted"
    planted.mkdir()
    text = textwrap.dedent(IN_THE_WORKLOAD_CHILD)
    if fault:
        text += textwrap.indent(textwrap.dedent(FAULTS[fault]), "    ")
    (planted / "sitecustomize.py").write_text(text)
    monkeypatch.setenv("PYTHONPATH", str(planted))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_dsv2_cell_in_one_process(capsys, tmp_path, monkeypatch, fault):
    plant(tmp_path, monkeypatch, fault)
    # The sound run traced, so that its line carries the per-layer metrics.
    rc = core.main(["--workload", CELL, "--seed", str(2 ** 31 + 61), "--seconds", "0.1",
                    "--trace", "0" if fault else "1"], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    checks = line["checks"]
    assert list(checks) == list(LIMITS)
    assert checks["outputs_missing"]["value"] == 0
    failed = [name for name, c in checks.items() if c["value"] > c["limit"]]
    if fault is None:
        assert line["correct"] is True and not failed
        assert all(0 < checks[k]["value"] for k in STEPS)
        assert line["metrics"]["expert_imbalance.dsv2"]["value"] >= 1.0
    else:
        assert line["correct"] is False
        assert set(failed) <= set(STEPS) and failed
        assert "FAILED" in err


def test_the_control_fails_the_dsv2_cells_step_limits(capsys, tmp_path, monkeypatch):
    plant(tmp_path, monkeypatch)
    assert control.main(["--workload", CELL, "--seconds", "0.1", "--seed", str(2 ** 31 + 67)],
                        device="cpu") == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["program_correct"] is True and got["control_correct"] is False
    assert any(got["control"][k] > LIMITS[k] for k in STEPS)
