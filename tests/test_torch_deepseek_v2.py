"""DeepSeek-V2-Lite's step (``tpu_node_checker_torch.models.deepseek_v2``) on the CPU.

The port is held to the plain float32 reference (tests/dsv2_reference.py)
at a small size with seeded random weights: the weights the recipe draws,
the logits, the loss, every gradient and the parameters after three Adam
steps; in float32 activations the two agree to float32's rounding, which
pins the hand-written backward passes.  Besides: YaRN at the published
values against the closed forms, the expert shares adding up to the uncut
layer, no token dropped, the two copies of the reference agreeing, and the
workload level's selection of its model, the flag included.

torch, the port and the benchmark's reference are reached through
``importlib.import_module`` (tests/test_dependency_surface.py).
"""

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from tests import dsv2_reference as R

torch = importlib.import_module("torch")
dsv2 = importlib.import_module("tpu_node_checker_torch.models.deepseek_v2")
moe = importlib.import_module("tpu_node_checker_torch.parallel.moe")
spans = importlib.import_module("tpu_node_checker_torch.probe.spans")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_cli = importlib.import_module("tpu_node_checker_torch.cli")
port_emit = importlib.import_module("tpu_node_checker_torch.emit")

REPO = Path(__file__).resolve().parent.parent
MODULE = "tpu_node_checker_torch.models.deepseek_v2"
# The issue's small size: hidden 64, 4 heads, nope 16, rope 8, v 16,
# kv_lora 32, dense width 96, expert width 32, 16 experts top-4 with 2
# shared, 1 dense + 2 MoE layers, vocab 256, seq 32; this card holds 4 of
# the 16 experts from the fifth, so the share is a share.
SMALL = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=2,
             num_hidden_layers=3, vocab_size=256, vocab_held=256, held_experts=(4, 4),
             seq=32, batch=2)
CFG = dsv2.DeepseekV2Config(**SMALL)
SEED = 5


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def port_run(cfg, steps=3, act=None, monkeypatch=None):
    """The port's (logits, balance, losses, first grads, params after) on the CPU."""
    if act is not None:
        monkeypatch.setattr(dsv2, "ACT", act)
    step, init_fn = dsv2.make_train_step(cfg, device="cpu")
    model, opt = init_fn(SEED)
    tokens = dsv2.zipf_tokens(cfg, SEED)
    with torch.no_grad():
        logits, balance = model.logits(tokens)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(model, opt, tokens)))
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"logits": logits, "balance": float(balance), "losses": losses, "grads": grads,
            "params": params, "tokens": tokens}


@pytest.fixture(scope="module")
def reference():
    cfg = as_dict(CFG)
    tokens = dsv2.zipf_tokens(CFG, SEED)
    p0 = R.initial_state(cfg, SEED)
    with torch.no_grad():
        logits, balance = R.logits_of(p0, tokens, cfg)
    return {"logits": logits, "balance": float(balance), "p0": p0,
            **R.train(cfg, SEED, tokens, 3, 1e-3)}


@pytest.fixture(scope="module")
def port():
    return port_run(CFG)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class TestAgainstTheReference:
    def test_the_recipe_draws_the_references_weights_exactly(self, reference):
        model, _ = dsv2.make_train_step(CFG, device="cpu")[1](SEED)
        names = [n for n, _ in model.named_parameters()]
        assert names == [n for n, *_ in dsv2.param_shapes(CFG)] == list(reference["p0"])
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), reference["p0"][n]), n

    def test_logits_and_loss(self, port, reference):
        # bf16 activations: each rounding is 2**-9 relative; three layers
        # of them leave the logits (|logit| up to 0.21) within 2e-3 of the
        # reference's (1.1e-3 measured), and the loss, a mean over 62
        # positions of a log-sum-exp near ln 256, within 1e-5 relative
        # (5e-6 measured).  The balance term is f32 from f32 router
        # logits of bf16 inputs: 1e-4 relative (2e-6 measured).
        assert float((port["logits"] - reference["logits"]).abs().max()) < 2e-3
        assert port["losses"][0] == pytest.approx(reference["losses"][0], rel=1e-5)
        assert port["balance"] == pytest.approx(reference["balance"], rel=1e-4)

    def test_every_gradient(self, port, reference):
        # bf16 products and activations, 2**-9 a rounding, compound through
        # three layers' forward and backward passes.  A token whose top-k
        # choice sits at a near tie can fall to another expert under that
        # rounding, which moves an expert's, the router's or the shared
        # experts' gradient by one token's share: at 64 tokens, over 10 %
        # of a leaf.  So every leaf is held by its norm, as the benchmark
        # holds it (its gap over its reference norm or the median leaf's,
        # whichever is larger): under 1e-2 (4.8e-3 the worst on seeds 5-7);
        # and every leaf outside the expert layer by its whole value: under
        # 2.5 % relative Frobenius error (1.2 % the worst on seeds 5-7).
        # The fp8 control reads 2.5e-2 on the norms (CPU, this size).
        names = list(port["grads"])
        got = np.array([float(port["grads"][n].norm()) for n in names])
        want = np.array([float(reference["grads"][n].norm()) for n in names])
        gap = np.abs(got - want) / np.maximum(want, np.median(want))
        assert gap.max() < 1e-2, names[int(gap.argmax())]
        for n in names:
            if not any(k in n for k in ("experts_", "router", "shared_")):
                assert rel(port["grads"][n], reference["grads"][n]) < 0.025, n

    def test_the_parameters_after_three_steps(self, port, reference):
        # Each leaf's change over the three steps, by norm as above: under
        # 1e-2 (3.9e-3 the worst on seeds 5-7; the fp8 control 1.6e-2);
        # and the three losses within 1e-4 relative (3.5e-5 measured).
        p0 = reference["p0"]
        names = list(port["params"])
        got = np.array([float((port["params"][n] - p0[n]).norm()) for n in names])
        want = np.array([float((reference["params"][n] - p0[n]).norm()) for n in names])
        gap = np.abs(got - want) / np.maximum(want, np.median(want))
        assert gap.max() < 1e-2, names[int(gap.argmax())]
        assert port["losses"] == pytest.approx(reference["losses"], rel=1e-4)

    def test_in_float32_activations_the_port_is_the_reference(self, monkeypatch, reference):
        # With the activation dtype float32 every operation of the port is
        # the reference's in the reference's precision: the hand-written
        # backward passes (attention, router, experts, SwiGLU) and the
        # recomputation agree with autograd to float32's rounding.
        got = port_run(CFG, act=torch.float32, monkeypatch=monkeypatch)
        assert float((got["logits"] - reference["logits"]).abs().max()) < 1e-6
        assert got["losses"] == pytest.approx(reference["losses"], rel=1e-6)
        for n, g in got["grads"].items():
            assert rel(g, reference["grads"][n]) < 2e-6, n
        for n, p in got["params"].items():
            assert rel(p, reference["params"][n]) < 1e-6, n

    def test_recomputation_changes_nothing(self, port):
        got = port_run(dataclasses.replace(CFG, remat=False))
        assert got["losses"] == port["losses"]
        for n, g in got["grads"].items():
            assert torch.equal(g, port["grads"][n]), n


class TestYarn:
    PUBLISHED = dsv2.DeepseekV2Config()

    def test_inverse_frequencies_are_the_closed_forms(self):
        cfg = self.PUBLISHED
        dim, base, L = 64, 10000.0, 4096
        # YaRN's correction range for beta_fast 32 and beta_slow 1 over 64 dims.
        low = math.floor(dim * math.log(L / (32 * 2 * math.pi)) / (2 * math.log(base)))
        high = math.ceil(dim * math.log(L / (1 * 2 * math.pi)) / (2 * math.log(base)))
        assert (low, high) == (10, 23)
        got = dsv2.yarn_inv_freq(cfg).double()
        for i in range(dim // 2):
            extra = base ** (-2 * i / dim)
            ramp = min(max((i - low) / (high - low), 0.0), 1.0)
            want = extra / 40 * ramp + extra * (1 - ramp)
            assert float(got[i]) == pytest.approx(want, rel=1e-6), i
        assert torch.equal(got.float(), R.yarn_inv_freq(as_dict(cfg)))

    def test_softmax_scale_and_cos_sin_factor(self):
        cfg = self.PUBLISHED
        want = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
        assert dsv2.softmax_scale(cfg) == pytest.approx(want, rel=1e-12)
        assert round(dsv2.softmax_scale(cfg), 5) == 0.11472
        cos, sin = dsv2.rope_cos_sin(cfg, 8, "cpu")
        # mscale over mscale_all_dim: 1 at the published 0.707 and 0.707.
        assert float(cos[0].min()) == 1.0 and float(sin[0].abs().max()) == 0.0
        rc, rs = R.rotary(as_dict(cfg), 8)
        assert torch.equal(cos, rc) and torch.equal(sin, rs)


class TestExpertShare:
    def test_the_shares_add_up_to_the_uncut_layer(self, monkeypatch):
        # In float32, so that the sums compare to rounding.  Each card of
        # a 4-way layout holds 4 of the 16 experts; the port's expert
        # layer, told which it holds, gives its part; the parts and the
        # shared experts counted once are the uncut reference layer.
        monkeypatch.setattr(dsv2, "ACT", torch.float32)
        cfg = as_dict(CFG)
        p = R.initial_state(cfg, SEED)
        gen = torch.Generator().manual_seed(11)
        D, Fe, E = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
        experts = [tuple(torch.randn(shape, generator=gen) * 0.1
                         for shape in ((D, Fe), (D, Fe), (Fe, D))) for _ in range(E)]
        x = torch.randn((2 * 32, D), generator=gen)
        whole = R.moe_whole(p, 1, x, cfg, 2, experts)
        topw, topi, _ = moe._Route.apply(x, p["layers.1.router"], 2, 4, 1.0, 0.001)
        total = moe.SwiGLU.apply(x, p["layers.1.shared_gate"], p["layers.1.shared_up"],
                                   p["layers.1.shared_down"], None)
        for first in range(0, E, 4):
            held = [torch.stack([experts[first + e][j] for e in range(4)]) for j in range(3)]
            total = total + moe._HeldExperts.apply(x, topw, topi, *held, first, False)
        assert float((total - whole).abs().max()) < 1e-5 * float(whole.abs().max())

    def test_no_token_is_dropped_under_zipf_tokens(self):
        step, init_fn = dsv2.make_train_step(CFG, device="cpu")
        tokens = dsv2.zipf_tokens(CFG, SEED)
        round_ = spans.Round()
        with spans.active(round_):
            model, opt = init_fn(SEED)
            for _ in range(2):
                step(model, opt, tokens)
        c = round_.counters
        moe_layers = CFG.num_hidden_layers - CFG.first_k_dense_replace
        assert c["moe_layer_steps"] == 2 * moe_layers
        assert c["moe_assignments"] == 2 * moe_layers * CFG.batch * CFG.seq * 4
        assert 0 < c["moe_assignments_held"] < c["moe_assignments"]
        assert c["moe_tokens_dropped"] == 0
        # The recomputation in the backward pass counts nothing twice.
        assert c["moe_max_expert_tokens"] <= c["moe_assignments_held"]
        summary = spans.summary(round_.tracer.spans)
        for name in ("workload.model_init", "mla.attention", "moe.route", "moe.experts",
                     "moe.shared"):
            assert name in summary, name
        # Forward, recomputation and backward: three spans a layer a step.
        assert summary["mla.attention"][0] == 2 * 3 * CFG.num_hidden_layers
        assert summary["moe.experts"][0] == 2 * 3 * moe_layers

    def test_zipf_tokens_lie_in_the_held_vocabulary(self):
        tokens = dsv2.zipf_tokens(dsv2.DeepseekV2Config(), 0)
        assert tokens.shape == (4, 4096)
        assert 0 <= int(tokens.min()) and int(tokens.max()) < 12800
        # Zipf (s = 1) over 12,800 ids: id 0 takes 1/H(12800) of them, about 10 %.
        share = float((tokens == 0).float().mean())
        assert 0.08 < share < 0.12

    def test_the_published_share_holds_two_point_seven_billion_parameters(self):
        shapes = dsv2.param_shapes(dsv2.DeepseekV2Config())
        total = sum(math.prod(s) for _, s, _ in shapes)
        assert total == pytest.approx(2.744e9, rel=1e-3)
        assert len(shapes) == 3 + 27 * 7 + 3 + 26 * 7


def test_the_two_reference_copies_agree(reference):
    sys.path.insert(0, str(REPO))
    bench = importlib.import_module("probebench.reference.dsv2_lite")
    args = {"cfg": as_dict(CFG), "seed": SEED, "learning_rate": 1e-3, "draw_device": "cpu"}
    tokens = dsv2.zipf_tokens(CFG, SEED).numpy().astype(np.float32).reshape(-1)
    got = bench.train(args, tokens, 3, "cpu")
    names = list(reference["p0"])
    assert [n for n, *_ in bench.param_shapes(args["cfg"])] == names
    np.testing.assert_allclose(got["losses"], reference["losses"], rtol=1e-6)
    want_grads = [float(reference["grads"][n].double().norm()) for n in names]
    want_change = [float((reference["params"][n] - reference["p0"][n]).double().norm())
                   for n in names]
    # The benchmark's copy recomputes each layer and sequence: float32
    # sums in another order.
    np.testing.assert_allclose(got["grads"], want_grads, rtol=1e-5)
    np.testing.assert_allclose(got["change"], want_change, rtol=1e-4)


# -- selecting the model -------------------------------------------------------

def test_the_flag_reaches_the_emitter(monkeypatch):
    seen = []

    def fake_probe(**kwargs):
        seen.append(kwargs)
        return port_liveness.ProbeResult(ok=True, level="workload", hostname="h",
                                         elapsed_ms=1.0)

    monkeypatch.setattr(port_emit, "run_local_probe", fake_probe)
    for argv, want in ((["--emit-probe", os.devnull, "--probe-level", "workload",
                         "--probe-workload-model", "deepseek-v2-lite"], "deepseek-v2-lite"),
                       (["--emit-probe", os.devnull, "--probe-level", "workload"], None)):
        assert port_cli.main(argv) == 0
        assert seen[-1]["workload_model"] == want


@pytest.mark.parametrize("named", [False, True])
def test_the_one_shot_probe_carries_the_model_only_when_named(monkeypatch, named):
    # Unnamed, the parsed arguments and the probe's call are the JAX
    # checker's (tests/test_torch_fleet.py holds them equal).
    seen = []

    def fake_probe(**kwargs):
        seen.append(kwargs)
        return port_liveness.ProbeResult(ok=True, level="workload", hostname="h",
                                         elapsed_ms=1.0)

    monkeypatch.setattr(port_liveness, "run_local_probe", fake_probe)
    checker = importlib.import_module("tpu_node_checker_torch.checker")
    extra = ["--probe-workload-model", "deepseek-v2-lite"] if named else []
    args = port_cli.parse_args(["--probe", "--probe-level", "workload", *extra])
    assert ("probe_workload_model" in vars(args)) is named
    checker._run_probe(args, [], checker.CheckResult(exit_code=0))
    assert seen[0].get("workload_model") == ("deepseek-v2-lite" if named else None)
    assert ("workload_model" in seen[0]) is named


@pytest.mark.parametrize("argv,words", [
    (["--probe-workload-model", "deepseek-v2-lite"], "requires --probe or --emit-probe"),
    (["--emit-probe", "-", "--probe-workload-model", "deepseek-v2-lite"],
     "requires --probe-level workload"),
    (["--selftest", "--probe-workload-model", "deepseek-v2-lite"],
     "requires --probe or --emit-probe"),
    (["--emit-probe", "-", "--probe-level", "workload", "--probe-workload-model", "gpt"],
     "invalid choice"),
])
def test_the_flags_usage_errors(capsys, argv, words):
    with pytest.raises(SystemExit) as exc:
        port_cli.parse_args(argv)
    assert exc.value.code == 2 and words in capsys.readouterr().err


@pytest.mark.parametrize("model", [None, "burnin", "deepseek-v2-lite"])
def test_run_local_probe_hands_the_model_to_the_child(monkeypatch, model):
    for k in [k for k in os.environ if k.startswith("TNC_")]:
        monkeypatch.delenv(k)
    calls = []

    def fake_child(argv, *, timeout, env):
        calls.append(env)
        return subprocess.CompletedProcess(argv, 0, stdout=json.dumps({"ok": True}), stderr="")

    monkeypatch.setattr(port_liveness, "_run_child", fake_child)
    assert port_liveness.run_local_probe(level="workload", device="cpu",
                                         workload_model=model).ok
    assert calls[0].get("TNC_WORKLOAD_MODEL") == model


IMPORT_WATCH = """
import atexit, os, sys
def _record():
    with open(os.environ["DSV2_IMPORT_RECORD"], "a") as f:
        f.write(f"{sys.argv[1] if len(sys.argv) > 1 else ''} {%r in sys.modules}\\n")
if sys.argv[:1] == ["-c"]:
    atexit.register(_record)
    if sys.argv[1:2] == ["workload"] and os.environ.get("TNC_WORKLOAD_MODEL"):
        import functools
        from tpu_node_checker_torch.models import deepseek_v2 as _dsv2
        _dsv2.DeepseekV2Config = functools.partial(_dsv2.DeepseekV2Config, **%r)
""" % (MODULE, SMALL)


@pytest.fixture(scope="module")
def workload_children(tmp_path_factory):
    """The workload level on the CPU, by default and with the new model
    (at the small size), each child recording at its exit whether it
    imported the model's module."""
    folder = tmp_path_factory.mktemp("watch")
    (folder / "sitecustomize.py").write_text(textwrap.dedent(IMPORT_WATCH))
    record = folder / "record.txt"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("TNC_")]:
            mp.delenv(k)
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("PYTHONPATH", str(folder))
        mp.setenv("DSV2_IMPORT_RECORD", str(record))
        for model in (None, "deepseek-v2-lite"):
            out[model] = port_liveness.run_local_probe(level="workload", timeout_s=300,
                                                       device="cpu", workload_model=model)
    return out, [l for l in record.read_text().splitlines() if l.startswith("workload ")]


def test_the_default_workload_level_trains_the_burnin_and_imports_nothing_new(
        workload_children):
    reports, record = workload_children
    d = reports[None].to_dict()
    assert reports[None].ok, reports[None].error
    assert d["workload_ok"] is True and d["workload_devices"] == 1
    port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
    losses, _, _ = port_burnin.train_steps(
        dataclasses.replace(port_burnin.BurninConfig(), attention="flash"), device="cpu")
    # The burn-in's own losses, to the bf16 rounding that another thread
    # count's sums in another order leave (3e-4 of 5 seen).
    assert d["workload_losses"] == pytest.approx(losses, rel=1e-3)
    assert "spans" in d and "moe_layer_steps" not in d["spans"]["counters"]
    assert record[0] == "workload False"


def test_the_named_model_trains_in_its_place_with_no_new_report_key(workload_children):
    reports, record = workload_children
    default, named = (reports[m].to_dict() for m in (None, "deepseek-v2-lite"))
    assert reports["deepseek-v2-lite"].ok, reports["deepseek-v2-lite"].error
    assert named["workload_devices"] == 1 and named["workload_ok"] is True
    losses = named["workload_losses"]
    assert len(losses) == 3 and all(b < a for a, b in zip(losses, losses[1:]))
    # ln 256 at the start: the small model over a 256-id vocabulary.
    assert losses[0] == pytest.approx(math.log(256), rel=0.02)
    assert set(named) == set(default)
    counters = named["spans"]["counters"]
    assert counters["moe_tokens_dropped"] == 0 and counters["moe_layer_steps"] == 6
    assert record[1] == "workload True"


def test_the_parent_and_the_childs_start_up_import_nothing_of_the_model():
    code = ("import sys\n"
            "import tpu_node_checker_torch.cli, tpu_node_checker_torch.emit\n"
            "import tpu_node_checker_torch.probe.liveness, tpu_node_checker_torch.models\n"
            f"print({MODULE!r} in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_the_step_never_imports_dynamo_or_sympy():
    # As the burn-in's step (tests/test_torch_workload.py): the layer's
    # recomputation is the module's own, not torch.utils.checkpoint.
    code = (
        "import sys, torch\n"
        "from tpu_node_checker_torch.models import deepseek_v2 as m\n"
        f"cfg = m.DeepseekV2Config(**{SMALL!r})\n"
        "step, init_fn = m.make_train_step(cfg, device='cpu')\n"
        "model, opt = init_fn()\n"
        "step(model, opt, m.zipf_tokens(cfg, 0))\n"
        "print(sorted({'sympy', 'torch._dynamo'} & set(sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
