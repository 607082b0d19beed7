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
port_burn = importlib.import_module("tpu_node_checker_torch.ops.burn")
port_harness = importlib.import_module("tpu_node_checker_torch.ops._harness")
port_hbm = importlib.import_module("tpu_node_checker_torch.ops.hbm")
port_int8 = importlib.import_module("tpu_node_checker_torch.ops.int8_probe")
port_burnin = importlib.import_module("tpu_node_checker_torch.models.burnin")
port_parallel = importlib.import_module("tpu_node_checker_torch.parallel")
port_sweep = importlib.import_module("tpu_node_checker_torch.meshprobe.sweep")
port_ops = importlib.import_module("tpu_node_checker_torch.ops")


def _launched(kernel):
    """Launches of ``kernel`` in this process since the last reset."""
    return port_ops.launch_counts()[kernel]


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
        before = _launched("flash_attention")
        torch.tanh(port_flash.flash_attention(*leaves)).sum().backward()
        assert _launched("flash_attention") == before + 1
        plain = [t.detach().clone().requires_grad_(True) for t in leaves]
        torch.tanh(port_flash.causal_attention_reference(*plain)).sum().backward()
        for a, b in zip(leaves, plain):
            # Same backward; the forwards differ only in f32 summation order.
            torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4)


def _check_tiled_matmul(device, m, k, n):
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g, device=device).to(torch.bfloat16)
    before = _launched("tiled_matmul")
    out = port_matmul.tiled_matmul(a, b, 0.5)
    torch.cuda.synchronize()
    assert _launched("tiled_matmul") == before + 1
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


@pytest.mark.cuda
def test_burn_graph_replays_the_eager_chain(cuda_device):
    n, iters = 512, 8
    a = port_burn._burn_input(n, cuda_device)
    before = _launched("burn_chain")
    run = port_burn._chain_runner(a, iters)
    # The warm-up product and the captured chain, one launch a product.
    assert _launched("burn_chain") == before + 1 + iters
    first, seconds = run()
    again = [run()[0] for _ in range(2)]
    eager = float(port_burn._burn_chain(a, iters).item())
    assert _launched("burn_chain") == before + 1 + 2 * iters
    assert seconds > 0
    # The same kernel in the same order: bit for bit.
    assert again == [first] * 2 and eager == first


def _bf16_ulps_apart(x, y):
    """|x - y| in bf16 steps, elementwise (both finite bf16): the distance of
    their bit patterns mapped onto one ordered integer line."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)
    return (ordered(x) - ordered(y)).abs()


@pytest.mark.cuda
class TestBurnProductOnCard:
    """The burn chain's product kernel against its plain version (the
    library's f32 product, x scale, the cast) on the card: the two differ
    only in the order of the f32 sums."""

    @pytest.mark.parametrize("n", [2048, 512, 1000])  # the chain; a partial tile; ragged
    def test_equals_plain_product(self, cuda_device, n):
        x = port_burn._burn_input(n, cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(n)
        a = torch.randn((n, n), generator=gen, device=cuda_device).to(torch.bfloat16)
        scale = torch.tensor(float(n)).sqrt().reciprocal().item()
        before = _launched("burn_chain")
        out = port_burn.burn_product(x, a, scale)
        torch.cuda.synchronize()
        assert _launched("burn_chain") == before + 1
        assert out.dtype == torch.bfloat16 and out.shape == (n, n)
        ref = port_burn.burn_product_reference(x, a, scale)
        # A different f32 summation order moves a sum by far less than one
        # bf16 step, so the two round alike or one step apart.
        err = float((out.float() - ref.float()).abs().max() / ref.float().abs().max())
        assert err <= 2.0 ** -8, err
        close = float((_bf16_ulps_apart(out, ref) <= 1).float().mean())
        assert close >= 0.99, close

    def test_chain_gap_to_float64_within_twice_the_plain_chain(self, cuda_device):
        n, iters = 2048, 64
        a = port_burn._burn_input(n, cuda_device)
        scale = torch.tensor(float(n)).sqrt().reciprocal().item()
        a64, x64, plain = a.double(), a.double(), a
        for _ in range(iters):
            x64 = x64 @ a64 * scale
            plain = port_burn.burn_product_reference(plain, a, scale)
        exact, norm = float(x64.sum()), float(x64.norm())
        kernel = float(port_burn._burn_chain(a, iters).item())
        gap_kernel = abs(kernel - exact) / norm
        gap_plain = abs(float(plain.double().sum()) - exact) / norm
        assert gap_kernel <= 2 * gap_plain, (gap_kernel, gap_plain)

    def test_chain_counts_its_products(self, cuda_device):
        a = port_burn._burn_input(256, cuda_device)
        before = _launched("burn_chain")
        port_burn._burn_chain(a, 5)
        assert _launched("burn_chain") == before + 5

    @pytest.mark.parametrize("make,error,match", [
        (lambda d: (torch.zeros((100, 96), dtype=torch.bfloat16, device=d),
                    torch.zeros((96, 100), dtype=torch.bfloat16, device=d)),
         ValueError, "multiples of 8"),
        (lambda d: (torch.zeros((128, 128), device=d), torch.zeros((128, 128), device=d)),
         TypeError, "bf16"),
        (lambda d: (torch.zeros((128, 128), dtype=torch.bfloat16, device=d).t()[:, :64],
                    torch.zeros((64, 128), dtype=torch.bfloat16, device=d)),
         ValueError, "contiguous"),
    ])
    def test_refuses_what_the_kernel_does_not_take(self, cuda_device, make, error, match):
        x, a = make(cuda_device)
        before = _launched("burn_chain")
        with pytest.raises(error, match=match):
            port_burn.burn_product(x, a, 0.5)
        assert _launched("burn_chain") == before


@pytest.mark.cuda
def test_int8_graph_replays_the_eager_chain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a, b = (torch.randint(-8, 8, shape, generator=gen, device=cuda_device).to(torch.int8)
            for shape in ((256, 512), (512, 384)))
    port_ops.reset_launches()
    replay = port_harness.card_graph(lambda: port_int8._int8_chain(a, b, 8),
                                     lambda: port_int8._int8_chain(a, b, 1), cuda_device)
    first, seconds = replay()
    first = first.clone()
    replays = [replay()[0].clone() for _ in range(3)]
    eager = port_int8._int8_chain(a, b, 8)
    # The warm-up, the capture and the eager chain each went through the kernel.
    assert _launched("int8_chain") == 3
    assert seconds > 0
    # Integer arithmetic: every replay equals the first and the eager chain,
    # and both equal the plain chain of library products, exactly.
    assert all(torch.equal(again, first) for again in replays)
    assert torch.equal(first, eager)
    assert torch.equal(eager, port_int8.int8_chain_reference(a, b, 8))


@pytest.mark.cuda
class TestInt8ChainOnCard:
    """The int8 chain kernel against the plain chain (rolls, ``torch._int_mm``,
    adds) on the card: integer sums, so bit-equal."""

    @pytest.mark.parametrize("m,k,n,iters", [
        (1024, 1024, 1024, 128),  # the probe's chain: the 128 x 256 tile, 4 groups
        (256, 512, 384, 8),  # the 128 x 128 tile, a group an iteration
        (128, 128, 256, 130),  # iterations past a whole turn of the roll
        (384, 256, 512, 1),  # one product
    ])
    def test_equals_plain_chain(self, cuda_device, m, k, n, iters):
        gen = torch.Generator(device=cuda_device).manual_seed(m + n + iters)
        a = torch.randint(-8, 8, (m, k), generator=gen, device=cuda_device).to(torch.int8)
        b = torch.randint(-8, 8, (k, n), generator=gen, device=cuda_device).to(torch.int8)
        before = _launched("int8_chain")
        out = port_int8.int8_chain(a, b, iters)
        torch.cuda.synchronize()
        assert _launched("int8_chain") == before + 1
        assert out.dtype == torch.int32 and out.shape == (m, n)
        assert torch.equal(out, port_int8.int8_chain_reference(a, b, iters))

    @pytest.mark.parametrize("tile", port_int8.KERNEL_TILES)
    @pytest.mark.parametrize("groups", [1, 3])
    def test_every_tile_and_split(self, cuda_device, tile, groups):
        # Each tile the kernel is built for, through its C entry, at the
        # probe's width with an uneven split of the iterations.
        build = importlib.import_module("tpu_node_checker_torch.ops._build")
        m = k = n = 512
        iters = 10
        gen = torch.Generator(device=cuda_device).manual_seed(groups)
        a = torch.randint(-8, 8, (m, k), generator=gen, device=cuda_device).to(torch.int8)
        b = torch.randint(-8, 8, (k, n), generator=gen, device=cuda_device).to(torch.int8)
        a2, bt = torch.cat([a, a]), b.t().contiguous()
        acc = torch.zeros((m, n), dtype=torch.int32, device=cuda_device)
        build.launch("int8_chain", cuda_device, a2.data_ptr(), bt.data_ptr(), acc.data_ptr(),
                     m, n, k, iters, *tile, groups)
        torch.cuda.synchronize()
        assert torch.equal(acc, port_int8.int8_chain_reference(a, b, iters))

    def test_refuses_shape_off_the_rule(self, cuda_device):
        a = torch.zeros((128, 96), dtype=torch.int8, device=cuda_device)
        b = torch.zeros((96, 128), dtype=torch.int8, device=cuda_device)
        with pytest.raises(ValueError, match="multiples of 128"):
            port_int8.int8_chain(a, b, 2)

    def test_takes_any_input_layout(self, cuda_device):
        # The wrapper hands the kernel fresh copies ([a; a] and b^T), so a
        # transposed a and a b at an odd address give the plain chain's sums.
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        a = torch.randint(-8, 8, (256, 384), generator=gen, device=cuda_device).to(torch.int8).t()
        flat = torch.randint(-8, 8, (256 * 128 + 1,), generator=gen,
                             device=cuda_device).to(torch.int8)
        b = flat[1:].view(256, 128)
        assert not a.is_contiguous() and b.data_ptr() % 16
        out = port_int8.int8_chain(a, b, 5)
        # The library's products want aligned operands: fresh copies for them.
        assert torch.equal(out, port_int8.int8_chain_reference(a.contiguous(), b.clone(), 5))

    def test_probe_refuses_shape_off_the_rule(self, cuda_device):
        # A limit of the kernel, reported as such, not as a mismatch; the
        # kernel never runs.
        before = _launched("int8_chain")
        res = port_int8.int8_matmul_probe(m=100, k=128, n=128, iters=4, device=cuda_device)
        assert not res.ok and res.tops == 0.0
        assert "not supported by the int8 chain kernel" in res.error
        assert "WRONG" not in res.error
        assert _launched("int8_chain") == before


@pytest.mark.cuda
def test_hbm_graph_replays_the_eager_passes(cuda_device):
    x = torch.randn((1 << 20,), device=cuda_device)
    replay = port_harness.card_graph(lambda: port_hbm._stream_n(x, 4),
                                     lambda: port_hbm._stream_n(x, 1), cuda_device)
    first, seconds = replay()
    first = first.clone()
    again, _ = replay()
    eager = port_hbm._stream_n(x, 4)
    assert seconds > 0
    assert torch.equal(first, eager) and torch.equal(again, eager)


def _allocator(device):
    stats = torch.cuda.memory_stats(device)
    return {k: stats[k] for k in ("num_device_alloc", "num_device_free", "num_sync_all_streams")}


@pytest.mark.cuda
def test_second_stream_capture_keeps_its_memory(cuda_device):
    # The soak's stream leg twice: the second capture of the label allocates
    # from the first one's blocks, frees nothing and synchronises no stream.
    first = port_hbm.hbm_bandwidth_probe(mib=128, iters=2, device=cuda_device)
    before = _allocator(cuda_device)
    second = port_hbm.hbm_bandwidth_probe(mib=128, iters=2, device=cuda_device)
    assert first.ok and second.ok, (first.error, second.error)  # ok: y[0] == 2
    assert _allocator(cuda_device) == before


def _burn_operand(n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.cuda
def test_stream_captures_between_replays_of_a_live_burn_graph(cuda_device):
    # The soak's pattern: the burn graph stays alive while the stream is
    # captured anew each round; neither disturbs the other's memory.
    n, iters = 1024, 16
    a = _burn_operand(n, 3, cuda_device)
    run = port_burn._chain_runner(a, iters)
    first, _ = run()
    x = torch.zeros(((128 << 20) // 4,), device=cuda_device)
    sums = []
    for _ in range(3):
        replay = port_harness.card_graph(lambda: port_hbm._stream_n(x, 2),
                                         lambda: port_hbm._stream_n(x, 1), cuda_device, "hbm")
        y, _ = replay()
        assert torch.equal(y, torch.full_like(x, 2.0))
        del replay, y
        sums.append(run()[0])
    assert sums == [first] * 3
    assert first == float(port_burn._burn_chain(a, iters).item())


@pytest.mark.cuda
def test_two_live_burn_graphs_keep_apart(cuda_device):
    # The second capture of the label while the first graph lives gets a
    # pool of its own: replayed in turns, each gives its own eager checksum.
    n, iters = 1024, 16
    operands = [_burn_operand(n, seed, cuda_device) for seed in (4, 5)]
    runs = [port_burn._chain_runner(a, iters) for a in operands]
    eager = [float(port_burn._burn_chain(a, iters).item()) for a in operands]
    assert eager[0] != eager[1]
    got = [[run()[0] for run in runs] for _ in range(3)]
    assert got == [eager] * 3


class _NoHostClock:
    """Stands in for ``time``: a figure read from the host clock fails."""

    @staticmethod
    def perf_counter():
        raise AssertionError("the host clock was read on the card's path")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "hbm"])
def test_graded_figure_is_timed_by_cuda_events(cuda_device, monkeypatch, name):
    # Both probes time their chain through _harness.chain_clock, whose CPU
    # branch is the one host clock: on the card it must not be read.
    run = {
        "int8": lambda: port_int8.int8_matmul_probe(
            m=1024, k=1024, n=1024, iters=128, device=cuda_device),
        "hbm": lambda: port_hbm.hbm_bandwidth_probe(device=cuda_device),
    }[name]
    graphs = []
    real = port_harness.card_graph

    def counted(*args):
        graphs.append(args)
        return real(*args)

    monkeypatch.setattr(port_harness, "time", _NoHostClock)
    monkeypatch.setattr(port_harness, "card_graph", counted)
    r = run()
    assert r.ok, r.error
    assert len(graphs) == 1 and r.elapsed_ms > 0


@pytest.mark.cuda
def test_soak_on_card(cuda_device):
    r = port_burn.soak_burn(2.0, iters=64, device=cuda_device)
    assert r.ok, r.error
    assert r.rounds > 1 and r.sustained_ratio >= 0.5


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
        before = _launched("flash_attention")
        loss = port_burnin._loss(model, tokens)
        loss.backward()
        out[att] = (float(loss.detach()), _launched("flash_attention") - before,
                    {n: p.grad.float() for n, p in model.named_parameters()})
    (lx, nx, gx), (lf, nf, gf) = out["xla"], out["flash"]
    assert (nx, nf) == (0, cfg.n_layers)
    assert abs(lf - lx) / lx < 1e-3
    for name, g in gx.items():
        assert float((gf[name] - g).norm() / g.norm()) < 5e-2, name


@pytest.mark.cuda
def test_workload_probe_on_card(cuda_device):
    import dataclasses

    before = _launched("flash_attention")
    r = port_burnin.workload_probe(
        dataclasses.replace(port_burnin.BurninConfig(), attention="flash"), device=cuda_device)
    assert r.ok, r.error
    assert _launched("flash_attention") - before == 2 * 3  # n_layers x steps
