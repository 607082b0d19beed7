"""The CUDA kernels against their plain versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips where no card is visible: a
CUDA kernel has no CPU mode.  The file imports no JAX (the machine with the
card has none), so it runs there without the suite's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

torch and the port are reached through ``importlib.import_module``:
tests/test_dependency_surface.py rejects any other ``import`` in tests/.
"""

import importlib

import pytest

torch = importlib.import_module("torch")
port_dma = importlib.import_module("tpu_node_checker_torch.ops.dma_probe")
port_flash = importlib.import_module("tpu_node_checker_torch.ops.flash_attention")
port_matmul = importlib.import_module("tpu_node_checker_torch.ops.pallas_probe")
port_liveness = importlib.import_module("tpu_node_checker_torch.probe.liveness")
port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
port_parallel = importlib.import_module("tpu_node_checker_torch.parallel")
port_sweep = importlib.import_module("tpu_node_checker_torch.meshprobe.sweep")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    # The plain versions' f32 products run in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each kernel against its plain version on the card (run on the chip)."""

    @pytest.mark.parametrize("m,k,n", [
        (512, 512, 512), (256, 1024, 384), (384, 1024, 640), (4096, 4096, 4096),
    ])
    def test_tiled_matmul(self, cuda_device, m, k, n):
        _check_tiled_matmul(cuda_device, m, k, n)

    @pytest.mark.parametrize("tile", port_matmul.KERNEL_TILES)
    def test_tiled_matmul_every_tile(self, cuda_device, tile):
        # An (m, n) that makes the wrapper pick `tile` on this card.
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        m, n = {
            (128, 128): (128 * sms, 128),
            (64, 64): (128, 128),
        }[tile]
        assert port_matmul.matmul_tile(m, n, sms) == tile
        _check_tiled_matmul(cuda_device, m, 256, n)

    def test_tiled_matmul_rejects_k_off_the_slice(self, cuda_device):
        a = torch.zeros((128, 96), dtype=torch.bfloat16, device=cuda_device)
        b = torch.zeros((96, 128), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError, match="K of 64"):
            port_matmul.tiled_matmul(a, b, 0.5)

    @pytest.mark.parametrize("rows,cols,chunk", [(4096, 512, 256), (12, 7, 3), (130, 33, 13)])
    def test_dma_stream_exact(self, cuda_device, rows, cols, chunk):
        x = torch.randn((rows, cols), device=cuda_device)
        out = port_dma.dma_stream(x, chunk)
        torch.cuda.synchronize()
        assert torch.equal(out, port_dma.dma_stream_reference(x))

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("head_dim", [32, 64, 128])
    def test_flash_forward(self, cuda_device, dtype, tol, head_dim):
        q, k, v = (torch.randn((1, 2, 256, head_dim), device=cuda_device).to(dtype)
                   for _ in range(3))
        out = port_flash.flash_forward(q, k, v)
        torch.cuda.synchronize()
        ref = port_flash.causal_attention_reference(q, k, v)
        # f32: f32 arithmetic on both sides.  bf16: P rounds to bf16 before
        # P.V, and the output to bf16 once.
        assert float((out.float() - ref.float()).abs().max()) < tol

    @pytest.mark.parametrize("shape", [(2, 3, 384, 64), (1, 16, 4096, 128), (8, 4, 128, 32)])
    def test_flash_forward_bf16_shapes(self, cuda_device, shape):
        g = torch.Generator(device=cuda_device).manual_seed(1)
        q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
                   for _ in range(3))
        out = port_flash.flash_forward(q, k, v)
        torch.cuda.synchronize()
        ref = port_flash.causal_attention_reference(q, k, v).float()
        # P rounds to bf16 before P.V, and the output to bf16 once.
        d = (out.float() - ref).abs()
        assert float(d.max()) < 2e-2
        # Row n's output shrinks as 1/sqrt(n), so hold each row to its own
        # size too: 0.1 sits between a sound kernel and one that drops a K/V
        # tile (tests/test_torch_ops.py, chip_smoke.py).
        assert float((d.amax(-1) / ref.pow(2).mean(-1).sqrt()).max()) < 0.1

    def test_flash_rejects_other_dtypes(self, cuda_device):
        q = torch.zeros((1, 1, 128, 64), dtype=torch.float16, device=cuda_device)
        with pytest.raises(TypeError, match="bf16 or f32"):
            port_flash.flash_forward(q, q, q)

    def test_flash_gradients_match_plain(self, cuda_device):
        leaves = [torch.randn((1, 2, 256, 64), device=cuda_device).requires_grad_(True)
                  for _ in range(3)]
        before = port_flash.flash_forward.launches
        torch.tanh(port_flash.flash_attention(*leaves)).sum().backward()
        assert port_flash.flash_forward.launches == before + 1
        plain = [t.detach().clone().requires_grad_(True) for t in leaves]
        torch.tanh(port_flash.causal_attention_reference(*plain)).sum().backward()
        for a, b in zip(leaves, plain):
            # Same backward; the forwards differ only in f32 summation order.
            torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4)


def _check_tiled_matmul(device, m, k, n):
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g, device=device).to(torch.bfloat16)
    before = port_matmul.tiled_matmul.launches
    out = port_matmul.tiled_matmul(a, b, 0.5)
    torch.cuda.synchronize()
    assert port_matmul.tiled_matmul.launches == before + 1
    ref = port_matmul.tiled_matmul_reference(a, b, 0.5)
    # f32 accumulation in another order.
    assert float(((out - ref).abs() / ref.abs().clamp_min(1.0)).max()) < 1e-3


@pytest.mark.cuda
def test_compute_probe_on_card(cuda_device):
    r = port_liveness.run_local_probe(level="compute")
    assert r.ok, r.error
    assert r.platform == "gpu"
    d = r.to_dict()
    assert d["pallas_ok"] and d["dma_ok"] and d["flash_attention_ok"]
    assert all(n > 0 for n in d["kernel_launches"].values()), d["kernel_launches"]


@pytest.fixture()
def nccl_group(cuda_device):
    # One rank on this card: the group the probe child opens on a one-card host.
    with port_parallel.RankGroup(1, "cuda", timeout_s=120) as group:
        yield group


@pytest.mark.cuda
class TestOneRankNccl:
    """The fabric probes over a world-size-1 NCCL group (run on the chip)."""

    def test_collective_probe(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.collective_probe)
        assert r.ok, r.error
        assert r.n_devices == 1 and r.details["busbw_gbps"] is None

    def test_collective_leg_injection_named(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.collective_probe, inject_fault_leg="reduce_scatter")
        assert not r.ok
        assert [r.details[k] for k in ("psum_ok", "all_gather_ok", "reduce_scatter_ok")] == [
            True, True, False]

    def test_ring_probe(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.ring_probe)
        assert r.ok, r.error
        assert r.details == {"hops": 1, "link_gbps": None}

    def test_ring_link_injection_named(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.ring_probe, inject_fault_link=0)
        assert not r.ok and r.details["bad_links"] == ["0->0"]

    def test_sweep_has_no_links(self, nccl_group):
        (r,) = nccl_group.run(port_sweep.mesh_link_sweep)
        assert r.ok and r.n_links == 0 and r.links == {}

    def test_ring_attention_probe(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.ring_attention_probe, seq_per_device=16)
        assert r.ok, r.error

    def test_per_axis_probe_on_1x1_and_its_drill(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.per_axis_probe, topology="1x1")
        assert r.ok and r.details == {"topology": "1x1", "axis_ok": {"t0": True, "t1": True}}
        (r,) = nccl_group.run(port_parallel.per_axis_probe, topology="1x1", inject_fault_axis="t1")
        assert not r.ok and r.error == "fault localized to mesh axis t1=1"

    def test_pipeline_probe_and_stage_drill(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.pipeline_probe)
        assert r.ok and r.n_stages == 1 and r.max_abs_err < 1e-5, r.error
        (r,) = nccl_group.run(port_parallel.pipeline_probe, inject_fault_stage=0)
        assert not r.ok and r.details["first_bad_stage"] == 0

    def test_moe_probe_and_expert_drill(self, nccl_group):
        (r,) = nccl_group.run(port_parallel.moe_probe)
        assert r.ok and r.n_experts == 1 and r.max_abs_err < 1e-5, r.error
        (r,) = nccl_group.run(port_parallel.moe_probe, inject_fault_expert=0)
        assert not r.ok and r.details["bad_experts"] == [0]

    def test_sharded_step_at_one_by_one_is_the_one_card_step(self, nccl_group, cuda_device):
        cfg = port_burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, d_ff=64, seq=16)
        spec = port_parallel.MeshSpec((("data", 1), ("model", 1)))
        (sharded,) = nccl_group.run(port_burnin.train_steps, cfg, spec, 2)
        one = port_burnin.train_steps(cfg, None, 2, device=cuda_device)
        assert sharded[0] == pytest.approx(one[0], rel=1e-6)


@pytest.mark.cuda
def test_full_width_step_flash_matches_plain_attention(cuda_device):
    """One step at the full BurninConfig(), flash kernel against plain
    attention from the same weights.  The two paths round to bf16 at
    different points, so the loss is held to 1e-3 relative and each gradient
    to 5e-2 in relative L2 norm (chip_smoke.py phase 5 holds the same)."""
    import dataclasses

    cfg = port_burnin.BurninConfig()
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1)).to(cuda_device)
    out, state = {}, None
    for att in ("xla", "flash"):
        _, init_fn = port_burnin.make_train_step(
            dataclasses.replace(cfg, attention=att), device=cuda_device)
        model, _ = init_fn(seed=0, state=state)
        state = state or model.state_dict()
        before = port_flash.flash_forward.launches
        loss = port_burnin._loss(model, tokens)
        loss.backward()
        out[att] = (float(loss.detach()), port_flash.flash_forward.launches - before,
                    {n: p.grad.float() for n, p in model.named_parameters()})
    (lx, nx, gx), (lf, nf, gf) = out["xla"], out["flash"]
    assert (nx, nf) == (0, cfg.n_layers)
    assert abs(lf - lx) / lx < 1e-3
    for name, g in gx.items():
        assert float((gf[name] - g).norm() / g.norm()) < 5e-2, name


@pytest.mark.cuda
def test_workload_probe_on_card(cuda_device):
    import dataclasses

    before = port_flash.flash_forward.launches
    r = port_burnin.workload_probe(
        dataclasses.replace(port_burnin.BurninConfig(), attention="flash"), device=cuda_device)
    assert r.ok, r.error
    assert port_flash.flash_forward.launches - before == 2 * 3  # n_layers x steps
