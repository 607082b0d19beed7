"""Parity of the PyTorch/CUDA port's compute probes with the JAX package.

The same seeded numpy inputs go through ``tpu_node_checker_torch.convert`` to
both sides.  The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode on the CPU mesh, the XLA programs on the CPU.  The port side
runs on the CPU, where every kernel wrapper takes its plain version (the
CUDA kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``).  Each test states
its tolerance and why.

torch and the port are reached through ``importlib.import_module`` rather
than ``import`` statements or ``pytest.importorskip``:
tests/test_dependency_surface.py rejects any ``import`` in tests/ outside its
declared set, and a missing torch must fail loudly here, not skip.
"""

import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_node_checker.ops.burn import _burn_chain, _invariant
from tpu_node_checker.ops.dma_probe import _dma_stream
from tpu_node_checker.ops.flash_attention import _flash_forward, _xla_causal_attention
from tpu_node_checker.ops.hbm import _stream_n
from tpu_node_checker.ops.int8_probe import _int8_chain
from tpu_node_checker.ops.memtest import PATTERNS, _pattern
from tpu_node_checker.ops.pallas_probe import _tiled_matmul

torch = importlib.import_module("torch")
convert = importlib.import_module("tpu_node_checker_torch.convert")
port_ops = importlib.import_module("tpu_node_checker_torch.ops")
port_build = importlib.import_module("tpu_node_checker_torch.ops._build")
port_burn = importlib.import_module("tpu_node_checker_torch.ops.burn")
port_dma = importlib.import_module("tpu_node_checker_torch.ops.dma_probe")
port_flash = importlib.import_module("tpu_node_checker_torch.ops.flash_attention")
port_hbm = importlib.import_module("tpu_node_checker_torch.ops.hbm")
port_int8 = importlib.import_module("tpu_node_checker_torch.ops.int8_probe")
port_memtest = importlib.import_module("tpu_node_checker_torch.ops.memtest")
port_matmul = importlib.import_module("tpu_node_checker_torch.ops.pallas_probe")
port_spans = importlib.import_module("tpu_node_checker_torch.probe.spans")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flash_bf16_emulation(q, k, v, tile=64, skip=None):
    """The bf16 flash kernel's arithmetic on the CPU: 64-row query and K/V
    tiles, scores from the bf16 inputs in f32 scaled by log2(e)/sqrt(D), an
    online softmax in base 2 masked on the diagonal tile only, the row sum of
    the f32 P, and P rounded to bf16 before P.V (f32 accumulation).

    ``skip``: the first key of one K/V tile that every later query tile
    leaves out, as a kernel that drops a stage of its ring would."""
    B, H, S, D = q.shape
    c = math.log2(math.e) / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    above = torch.ones((tile, tile), dtype=torch.bool).triu(1)
    out = torch.empty_like(qf)
    for q0 in range(0, S, tile):
        m = torch.full((B, H, tile, 1), -1e30)
        l = torch.zeros((B, H, tile, 1))
        o = torch.zeros((B, H, tile, D))
        for k0 in range(0, q0 + tile, tile):
            if k0 == skip and k0 != q0:
                continue
            s = qf[:, :, q0:q0 + tile] @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * c
            if k0 == q0:
                s = s.masked_fill(above, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
            m = m_new
        out[:, :, q0:q0 + tile] = o / l
    return out.to(torch.bfloat16)


def _row_rel_err(out, ref):
    """Max over query rows of max|out - ref| / rms(ref) along the row: each
    row held to its own size, which shrinks as 1/sqrt(row) under the mask."""
    ref = torch.from_numpy(np.array(ref, dtype=np.float32))
    d = (out.float() - ref).abs().amax(-1)
    return float((d / ref.pow(2).mean(-1).sqrt()).max())


def _both(x_np, dtype=jnp.float32):
    """(JAX array, port CPU tensor) holding the same values."""
    xj = jnp.asarray(x_np, dtype)
    return xj, convert.to_torch(np.asarray(xj))


class TestConvert:
    def test_bf16_bits_survive(self):
        xj = jnp.asarray(_normal(0, (5, 7)), jnp.bfloat16)
        t = convert.to_torch(np.asarray(xj))
        assert t.dtype == torch.bfloat16
        # Exact: bf16 widens to f32 without rounding on both sides.
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(xj.astype(jnp.float32)))

    def test_uint32_becomes_same_bits_int32(self):
        words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xAAAAAAAA, 0xFFFFFFFF], np.uint32)
        t = convert.to_torch(words)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), words)

    def test_read_only_jax_arrays_are_copied(self):
        host = np.asarray(jnp.arange(6, dtype=jnp.int32))
        assert not host.flags.writeable
        t = convert.to_torch(host)
        t += 1  # writable, and the JAX buffer is untouched
        np.testing.assert_array_equal(host, np.arange(6))


class TestTiledMatmul:
    @pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384)])
    def test_matches_pallas_kernel(self, m, k, n):
        aj, at = _both(_normal(1, (m, k)), jnp.bfloat16)
        bj, bt = _both(_normal(2, (k, n)), jnp.bfloat16)
        ref = np.asarray(_tiled_matmul(aj, bj, 0.5, True))
        out = port_matmul.tiled_matmul(at, bt, 0.5)
        assert out.dtype == torch.float32
        # Both accumulate exact bf16 products in f32; only the summation
        # order differs: relative 1e-5 of the largest |value| (~ sqrt(k)).
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())

    def test_probe_on_cpu(self):
        r = port_matmul.pallas_matmul_probe(m=128, k=128, n=128, device="cpu")
        assert r.ok, r.error
        assert r.interpreted is True
        assert r.max_rel_err == 0.0  # the plain version against itself

    @pytest.mark.parametrize("m,n,sms,tile", [
        (4096, 4096, 132, (128, 128)),   # 1024 blocks of 128 x 128
        (2048, 1024, 132, (64, 64)),     # 128 x 128 gives 128 blocks, 64 x 64 gives 512
        (512, 512, 132, (64, 64)),       # the probe: 64 blocks, the most any tile gives
        (384, 640, 132, (64, 64)),
        (256, 256, 1, (128, 128)),
    ])
    def test_kernel_tile_follows_the_grid(self, m, n, sms, tile):
        assert port_matmul.matmul_tile(m, n, sms) == tile

    @pytest.mark.parametrize("shape", [(100, 128, 128), (0, 128, 128), (128, 128, 64)])
    def test_invalid_shape_is_usage_error(self, shape):
        r = port_matmul.pallas_matmul_probe(*shape, device="cpu")
        assert not r.ok
        assert "multiples of 128" in r.error


class TestDmaStream:
    @pytest.mark.parametrize("rows,cols,chunk", [(64, 48, 16), (24, 40, 8), (16, 8, 16)])
    def test_matches_pallas_kernel_exactly(self, rows, cols, chunk):
        xj, xt = _both(_normal(3, (rows, cols)))
        ref = np.asarray(_dma_stream(xj, chunk, True))
        out = port_dma.dma_stream(xt, chunk)
        # Exact: 2x is exact in f32, so 2x+1 rounds once on both sides.
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_rejects_ragged_chunks(self):
        with pytest.raises(ValueError, match="multiple of chunk_rows"):
            port_dma.dma_stream(torch.zeros(10, 4), 3)

    def test_probe_on_cpu(self):
        r = port_dma.dma_stream_probe(rows=256, cols=64, chunk_rows=32, device="cpu")
        assert r.ok, r.error
        assert r.interpreted is True and r.gbps > 0

    def test_invalid_shape_is_usage_error(self):
        r = port_dma.dma_stream_probe(rows=100, chunk_rows=64, device="cpu")
        assert not r.ok and "multiple of chunk_rows" in r.error


class TestFlashAttention:
    SHAPE = (1, 2, 256, 64)

    def _qkv(self, seed, dtype):
        return [_both(_normal(seed + i, self.SHAPE), dtype) for i in range(3)]

    def test_f32_tight_match(self):
        (qj, qt), (kj, kt), (vj, vt) = self._qkv(10, jnp.float32)
        ref = np.asarray(_flash_forward(qj, kj, vj, True))
        out = port_flash.flash_attention(qt, kt, vt)
        # The JAX package's own tight f32 tolerance (test_flash_attention.py).
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    def test_bf16_match_and_dtype(self):
        (qj, qt), (kj, kt), (vj, vt) = self._qkv(20, jnp.bfloat16)
        ref = np.asarray(_flash_forward(qj, kj, vj, True).astype(jnp.float32))
        out = port_flash.flash_attention(qt, kt, vt)
        assert out.dtype == torch.bfloat16
        # f32 arithmetic on both sides, then one rounding to bf16: at most one
        # bf16 step apart (2^-8 relative), within the probe's 2e-2.
        np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2 ** -8)

    def test_reference_matches_xla_reference(self):
        (qj, qt), (kj, kt), (vj, vt) = self._qkv(30, jnp.float32)
        ref = np.asarray(_xla_causal_attention(qj, kj, vj))
        out = port_flash.causal_attention_reference(qt, kt, vt)
        # Both are the plain f32 attention at full precision.
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)

    def test_gradients_match_xla(self):
        (qj, qt), (kj, kt), (vj, vt) = self._qkv(40, jnp.float32)

        def loss_ref(q, k, v):
            return jnp.sum(jnp.tanh(_xla_causal_attention(q, k, v)))

        gj = jax.grad(loss_ref, argnums=(0, 1, 2))(qj, kj, vj)
        leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
        torch.tanh(port_flash.flash_attention(*leaves)).sum().backward()
        for leaf, g in zip(leaves, gj):
            # The JAX package's gradient tolerance (test_flash_attention.py).
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=1e-5)

    def test_causality(self):
        (_, qt), (_, kt), (_, vt) = self._qkv(50, jnp.float32)
        block = port_flash.BLOCK
        out_a = port_flash.flash_attention(qt, kt, vt)
        k2, v2 = kt.clone(), vt.clone()
        k2[:, :, block:] = 0.0
        v2[:, :, block:] = 0.0
        out_b = port_flash.flash_attention(qt, k2, v2)
        torch.testing.assert_close(out_a[:, :, :block], out_b[:, :, :block], rtol=1e-5, atol=0)
        assert not torch.allclose(out_a[:, :, block:], out_b[:, :, block:])

    @pytest.mark.parametrize("head_dim", [32, 64, 128])
    def test_bf16_kernel_rounding_point_within_probe_tolerance(self, head_dim):
        shape = (1, 2, 256, head_dim)
        pairs = [_both(_normal(90 + i, shape), jnp.bfloat16) for i in range(3)]
        ref = np.asarray(_xla_causal_attention(*(j.astype(jnp.float32) for j, _ in pairs)))
        out = _flash_bf16_emulation(*(t for _, t in pairs))
        # Rounding P to bf16 before P.V moves the output by 2e-3 to 3e-3
        # against the f32 reference, and 5e-3 to 8e-3 after the output's own
        # rounding to bf16 (measured at D = 32, 64, 128 and S = 256, 1024):
        # within the probe's 2e-2.
        assert float(np.abs(out.float().numpy() - ref).max()) < 2e-2

    @pytest.mark.parametrize("head_dim", [32, 64, 128])
    def test_bf16_row_relative_limit_catches_a_dropped_tile(self, head_dim):
        # The limit chip_smoke.py and tests/test_torch_cuda.py hold the
        # kernel to at long sequences, where an absolute limit that suits
        # the first rows is blind to the late ones.  At (1, 1, 1024, D) the
        # emulation reads 0.012 to 0.015 sound and 2.1 to 2.3 with one K/V
        # tile left out of the later rows: 0.1 sits well between the two.
        shape = (1, 1, 1024, head_dim)
        pairs = [_both(_normal(100 + i, shape), jnp.bfloat16) for i in range(3)]
        ref = _xla_causal_attention(*(j.astype(jnp.float32) for j, _ in pairs))
        tensors = [t for _, t in pairs]
        sound = _row_rel_err(_flash_bf16_emulation(*tensors), ref)
        fault = _row_rel_err(_flash_bf16_emulation(*tensors, skip=512), ref)
        assert sound < 0.1 < fault, (sound, fault)

    def test_probe_on_cpu(self):
        r = port_flash.flash_attention_probe(seq=256, head_dim=32, device="cpu")
        assert r.ok, r.error
        assert r.max_abs_err == 0.0  # the plain version against itself

    @pytest.mark.parametrize("kwargs", [
        {"seq": 100}, {"seq": 0}, {"head_dim": 0}, {"batch": 0}, {"heads": -1},
    ])
    def test_invalid_dims_degrade(self, kwargs):
        r = port_flash.flash_attention_probe(**{"seq": 256, **kwargs}, device="cpu")
        assert not r.ok and "invalid" in r.error


class TestBurn:
    def test_chain_checksum_matches_jax(self):
        n, iters = 256, 6
        aj, at = _both(_normal(60, (n, n)), jnp.bfloat16)
        cj = float(_burn_chain(aj, iters))
        ct = float(port_burn._burn_chain(at, iters).item())
        # Each step rounds an f32 accumulator to bf16; the two libraries sum
        # in different orders, so single bf16 roundings fall differently.  The
        # checksum sums n^2 values of unit scale (standard deviation ~ n):
        # agree within 1% of that.
        assert abs(cj - ct) <= 0.01 * n, (cj, ct)

    def test_invariant_matches_jax(self):
        aj, at = _both(_normal(61, (256, 256)), jnp.bfloat16)
        for j, t in zip(_invariant(aj), port_burn._invariant(at)):
            # f32 sums of 65k terms in different orders.
            assert math.isclose(float(j), float(t.item()), rel_tol=1e-5)

    def test_burn_on_cpu(self):
        r = port_burn.matmul_burn(n=128, iters=2, device="cpu")
        assert r.ok, r.error
        assert r.tflops > 0 and r.rel_err < 5e-2

    def test_soak_on_cpu(self):
        r = port_burn.soak_burn(0.0, n=128, iters=2, device="cpu", hbm_mib=1,
                                min_sustained_ratio=0.0)
        assert r.ok, r.error
        assert r.rounds == 1 and r.to_dict()["rounds"] == 1

    def test_soak_builds_the_chain_once(self, monkeypatch):
        built = []
        runner = port_burn._chain_runner

        def counting_runner(a, iters):
            built.append(iters)
            return runner(a, iters)

        monkeypatch.setattr(port_burn, "_chain_runner", counting_runner)
        r = port_burn.soak_burn(0.2, n=64, iters=2, device="cpu", hbm_mib=0,
                                min_sustained_ratio=0.0)
        assert r.ok, r.error
        assert r.rounds > 1 and built == [2]

    def test_cpu_chain_is_the_plain_three_step_chain(self):
        # The CPU chain is the plain product, x scale and cast, step by step:
        # the same bits as the chain written out.
        a = port_burn._burn_input(64, torch.device("cpu"))
        scale = torch.tensor(64.0).sqrt().reciprocal().item()
        x = a
        for _ in range(5):
            x = (torch.mm(x.float(), a.float()) * scale).to(torch.bfloat16)
        assert port_burn._burn_chain(a, 5).item() == x.float().sum().item()

    def test_cpu_chain_counts_no_kernel_products(self):
        round_ = port_spans.Round()
        before = port_ops.launch_counts()["burn_chain"]
        with port_spans.active(round_):
            port_burn._burn_chain(port_burn._burn_input(32, torch.device("cpu")), 3)
        assert round_.counters == {}
        assert port_ops.launch_counts()["burn_chain"] == before

    def test_kernel_is_built_with_the_others(self):
        assert "burn_chain" in port_build.KERNELS
        symbol, argtypes = port_build.SIGNATURES["burn_chain"]
        # x, a, out, M, N, K, scale, the stream: no tile argument.
        assert symbol == "tnc_burn_product" and len(argtypes) == 8
        assert "burn_chain" in port_ops.launch_counts()

    def test_cpu_product_is_the_plain_product(self):
        x, a = (torch.from_numpy(_normal(seed, (48, 48))).to(torch.bfloat16) for seed in (62, 63))
        ref = port_burn.burn_product_reference(x, a, 0.125)
        assert ref.dtype == torch.bfloat16
        assert torch.equal(ref, (torch.mm(x.float(), a.float()) * 0.125).to(torch.bfloat16))
        assert torch.equal(port_burn.burn_product(x, a, 0.125), ref)
        out = torch.empty_like(ref)
        assert port_burn.burn_product(x, a, 0.125, out=out) is out
        assert torch.equal(out, ref)

    @pytest.mark.parametrize("x,a,error", [
        (torch.zeros(16, 16), torch.zeros(16, 16), TypeError),
        (torch.zeros(16, 16, dtype=torch.bfloat16), torch.zeros(8, 16, dtype=torch.bfloat16),
         ValueError),
        (torch.zeros(2, 16, 16, dtype=torch.bfloat16), torch.zeros(16, 16, dtype=torch.bfloat16),
         ValueError),
    ])
    def test_product_refuses_what_no_path_takes(self, x, a, error):
        with pytest.raises(error):
            port_burn.burn_product(x, a, 0.5)

    def test_soak_names_the_round_whose_check_failed(self, monkeypatch):
        monkeypatch.setattr(port_burn, "_invariant",
                            lambda a: (torch.tensor(2.0), torch.tensor(1.0)))
        r = port_burn.soak_burn(0.0, n=64, iters=2, device="cpu", hbm_mib=0)
        assert not r.ok and r.rounds == 1
        assert r.error.startswith("round 1 burn failed: tensor-core/elementwise invariant mismatch")


class TestHbmStream:
    def test_stream_matches_jax_exactly(self):
        xj, xt = _both(_normal(70, (4096,)))
        ref = np.asarray(_stream_n(xj, 3))
        # Exact: three f32 additions of 1 in the same order on both sides.
        np.testing.assert_array_equal(port_hbm._stream_n(xt, 3).numpy(), ref)

    def test_probe_on_cpu(self):
        r = port_hbm.hbm_bandwidth_probe(mib=1, iters=3, device="cpu")
        assert r.ok, r.error
        assert r.bytes_moved == 2 * 4 * (1 << 18) * 3

    def test_invalid_args(self):
        r = port_hbm.hbm_bandwidth_probe(mib=0, device="cpu")
        assert not r.ok and "invalid" in r.error


class TestInt8:
    def test_chain_matches_jax_exactly(self):
        rng = np.random.default_rng(80)
        a = rng.integers(-8, 8, size=(32, 64), dtype=np.int8)
        b = rng.integers(-8, 8, size=(64, 48), dtype=np.int8)
        ref = np.asarray(_int8_chain(jnp.asarray(a), jnp.asarray(b), 5))
        out = port_int8._int8_chain(convert.to_torch(a), convert.to_torch(b), 5)
        # Integer arithmetic: exact.
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_probe_on_cpu(self):
        r = port_int8.int8_matmul_probe(m=64, k=64, n=64, iters=3, device="cpu")
        assert r.ok, r.error


class TestMemtest:
    @pytest.mark.parametrize("name", PATTERNS)
    def test_pattern_bit_for_bit(self, name):
        n = 1 << 16
        ref = convert.to_torch(np.asarray(_pattern(name, n)))
        out = port_memtest._pattern(name, n, torch.device("cpu"))
        assert out.dtype == torch.int32
        # Bit for bit: the same 32-bit words, uint32 on one side, int32 here.
        assert torch.equal(out, ref)

    def test_unknown_pattern(self):
        with pytest.raises(ValueError, match="unknown memtest pattern"):
            port_memtest._pattern("0x00", 4, torch.device("cpu"))

    def test_probe_on_cpu(self):
        r = port_memtest.hbm_pattern_probe(mib=1, dwell_s=0.0, device="cpu")
        assert r.ok, r.error
        assert r.mismatches == {name: 0 for name in PATTERNS}

    def test_corruption_is_counted(self):
        buf = port_memtest._pattern("addr", 1024, torch.device("cpu"))
        buf[[3, 700]] ^= 1
        assert port_memtest._verify("addr", buf) == 2


class TestKernelWrappersOnCpu:
    def test_default_device_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default device resolves")
        harness = importlib.import_module("tpu_node_checker_torch.ops._harness")
        with pytest.raises(RuntimeError, match="CUDA device cuda:0 requested"):
            harness.resolve_device()
        assert harness.resolve_device("cpu") == torch.device("cpu")

    def test_cpu_tensors_take_plain_versions_without_launching(self):
        port_ops.reset_launches()
        port_matmul.tiled_matmul(torch.zeros(128, 128, dtype=torch.bfloat16),
                                 torch.zeros(128, 128, dtype=torch.bfloat16), 0.5)
        port_dma.dma_stream(torch.zeros(8, 8), 4)
        port_flash.flash_forward(*(torch.zeros(1, 1, 128, 32) for _ in range(3)))
        port_int8.int8_chain(torch.zeros(128, 128, dtype=torch.int8),
                             torch.zeros(128, 128, dtype=torch.int8), 2)
        port_burn.burn_product(torch.zeros(128, 128, dtype=torch.bfloat16),
                               torch.zeros(128, 128, dtype=torch.bfloat16), 0.5)
        assert port_ops.launch_counts() == dict.fromkeys(port_build.KERNELS, 0)

    @pytest.mark.parametrize("call", [
        lambda m: port_matmul.tiled_matmul(
            torch.zeros(128, 128, dtype=torch.bfloat16, device=m),
            torch.zeros(128, 128, dtype=torch.bfloat16, device=m), 0.5),
        lambda m: port_dma.dma_stream(torch.zeros(8, 8, device=m), 4),
        lambda m: port_flash.flash_forward(*(torch.zeros(1, 1, 128, 32, device=m) for _ in range(3))),
        lambda m: port_int8.int8_chain(torch.zeros(128, 128, dtype=torch.int8, device=m),
                                       torch.zeros(128, 128, dtype=torch.int8, device=m), 2),
        lambda m: port_burn.burn_product(torch.zeros(128, 128, dtype=torch.bfloat16, device=m),
                                         torch.zeros(128, 128, dtype=torch.bfloat16, device=m),
                                         0.5),
    ])
    def test_non_cpu_tensors_never_take_the_plain_version(self, call):
        # Only a CPU tensor selects the plain version; any other device either
        # launches the kernel (cuda) or raises.
        with pytest.raises(ValueError, match="runs on cuda"):
            call("meta")

    def test_library_path_follows_shared_headers(self, monkeypatch, tmp_path):
        # A source that includes a csrc/*.cuh header must rebuild when only
        # the header changes: its library path hashes every header too.
        monkeypatch.setattr(port_build, "CSRC", tmp_path)
        (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
        (tmp_path / "shared.cuh").write_text("#define TILE 64\n")
        first = port_build.library_path("k")
        assert port_build.library_path("k") == first
        (tmp_path / "shared.cuh").write_text("#define TILE 128\n")
        assert port_build.library_path("k") != first

    def test_kernel_build_without_nvcc_fails_loudly(self, monkeypatch, tmp_path):
        monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(port_build.KernelBuildError, match="nvcc not found"):
            port_build.build_all(["tiled_matmul"])


class TestLaunchSeam:
    """``_build.launch``, the one path every wrapper launches through, and the
    counts it keeps (a fake C entry stands in for the built library)."""

    @pytest.fixture()
    def fake_entry(self, monkeypatch):
        calls, codes = [], [0]

        def entry(*args):
            calls.append(args)
            return codes[0]

        stream = type("Stream", (), {"cuda_stream": 4242})()
        for name in port_build.KERNELS:
            monkeypatch.setitem(port_build._loaded, name, entry)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
        port_ops.reset_launches()
        yield calls, codes
        port_ops.reset_launches()

    @pytest.mark.parametrize("name", port_build.KERNELS)
    def test_launch_passes_the_stream_last_and_counts(self, fake_entry, name):
        calls, _ = fake_entry
        for _ in range(2):
            port_build.launch(name, torch.device("cpu"), 1, 2, 3)
        assert calls == [(1, 2, 3, 4242)] * 2
        assert port_ops.launch_counts() == {**dict.fromkeys(port_build.KERNELS, 0), name: 2}

    def test_failed_launch_raises_naming_the_kernel_and_counts_nothing(self, fake_entry,
                                                                         monkeypatch):
        _, codes = fake_entry
        codes[0] = 1  # cudaErrorInvalidValue
        # The CPU build cannot name CUDA's codes; the card's can.
        monkeypatch.setattr(torch.cuda, "CudaError", lambda code: f"CUDA error {code}")
        with pytest.raises(RuntimeError, match="CUDA kernel dma_stream failed to launch"):
            port_build.launch("dma_stream", torch.device("cpu"), 1)
        assert port_ops.launch_counts()["dma_stream"] == 0

    def test_counts_follow_the_table_and_reset_to_zero(self, fake_entry):
        port_build.launch("dma_stream", torch.device("cpu"))
        counts = port_ops.launch_counts()
        assert list(counts) == list(port_build.SIGNATURES) == list(port_build.KERNELS)
        assert sum(counts.values()) == 1
        port_ops.reset_launches()
        assert port_ops.launch_counts() == dict.fromkeys(port_build.KERNELS, 0)


def test_cpu_chain_clock_times_each_run_apart(monkeypatch):
    # The CPU clock runs the chain eagerly, one window a run: the first run
    # (the caller's warm-up) stays out of the second's time.
    harness = importlib.import_module("tpu_node_checker_torch.ops._harness")
    now = [100.0]
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    runs = []

    def chain():
        runs.append(len(runs))
        now[0] += 5.0 if len(runs) == 1 else 0.25
        return torch.full((3, 3), float(len(runs)))

    clock = harness.chain_clock(chain, lambda: pytest.fail("no warm-up on the CPU"),
                                torch.device("cpu"), "test")
    out1, warm_s = clock()
    out2, timed_s = clock()
    assert runs == [0, 1]
    assert torch.equal(out1, torch.full((3, 3), 1.0))
    assert torch.equal(out2, torch.full((3, 3), 2.0))
    assert (warm_s, timed_s) == (5.0, 0.25)


class _FakeCuda:
    """Small fakes of what ``_harness.card_graph`` calls in ``torch.cuda``,
    logging each call in order: streams, the stream context, CUDA graphs,
    graph pool handles and events.  ``empty_cache`` and ``synchronize``
    fail: a capture must not flush the allocator or wait on every stream.
    A pool counts its users as torch does: a graph from its capture's end
    until the graph is gone, and a capture into a pool whose users have all
    gone raises, as torch's allocators assert."""

    def __init__(self):
        self.log = []
        self.on = None  # the stream work is issued on
        self.made = {"streams": 0, "pools": 0}
        self.users = {}  # pool -> graphs captured into it and not yet gone
        self.currents = {}
        fake = self

        class Stream:
            def __init__(self, device, name=None):
                if name is None:
                    fake.made["streams"] += 1
                    name = f"side{fake.made['streams']}"
                self.device, self.name = device, name

            def wait_stream(self, other):
                fake.log.append(("wait", self.name, other.name))

        class CUDAGraph:
            pool = None

            def capture_begin(self, pool=None):
                fake.log.append(("capture_begin", fake.on.name, pool))
                if fake.users.get(pool, 1) == 0:
                    raise RuntimeError("it->second->use_count > 0 INTERNAL ASSERT FAILED")
                fake.users[pool] = fake.users.get(pool, 0) + 1
                self.pool = pool

            def capture_end(self):
                fake.log.append(("capture_end", fake.on.name))

            def __del__(self):
                if self.pool is not None:
                    fake.users[self.pool] -= 1

            def replay(self):
                fake.log.append(("replay",))

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return 2.0

        self.Stream, self.CUDAGraph, self.Event = Stream, CUDAGraph, Event

    def graph_pool_handle(self):
        self.made["pools"] += 1
        return (0, self.made["pools"])

    def current_stream(self, device):
        if device not in self.currents:
            self.currents[device] = self.Stream(device, f"current:{device}")
        return self.currents[device]

    def stream(self, side):
        fake = self

        class _On:
            def __enter__(self):
                self.was, fake.on = fake.on, side

            def __exit__(self, *exc):
                fake.on = self.was
        return _On()

    def install(self, monkeypatch, harness):
        def never(*args, **kwargs):
            raise AssertionError("the capture emptied the cache or synchronised every stream")
        for name, value in (("Stream", self.Stream), ("CUDAGraph", self.CUDAGraph),
                            ("Event", self.Event), ("graph_pool_handle", self.graph_pool_handle),
                            ("current_stream", self.current_stream), ("stream", self.stream),
                            ("empty_cache", never), ("synchronize", never)):
            monkeypatch.setattr(torch.cuda, name, value, raising=False)
        monkeypatch.setattr(harness, "_KEPT", harness._KeptMemory())


@pytest.fixture()
def fake_cuda(monkeypatch):
    harness = importlib.import_module("tpu_node_checker_torch.ops._harness")
    fake = _FakeCuda()
    fake.install(monkeypatch, harness)
    round_ = port_spans.Round()
    with port_spans.active(round_):
        yield harness, fake, round_


def _fake_capture(harness, fake, device, label, ran=None):
    """One card_graph capture of a chain that notes the stream it ran on."""
    def chain():
        fake.log.append(("chain", fake.on.name))
        return torch.zeros(1)

    def warm():
        fake.log.append(("warm", fake.on.name))
    return harness.card_graph(chain, warm, torch.device(device), label)


@pytest.mark.parametrize("second,same_stream,same_pool", [
    (("cuda:0", "hbm"), True, True),  # the label again: the kept stream and pool
    (("cuda:0", "burn"), True, False),  # another label: the device's stream, its own pool
    (("cuda:1", "hbm"), False, False),  # another device: its own stream and pool
])
def test_card_graph_keeps_one_stream_a_device_and_one_pool_a_label(fake_cuda, second,
                                                                   same_stream, same_pool):
    harness, fake, round_ = fake_cuda
    replay = _fake_capture(harness, fake, "cuda:0", "hbm")
    replay()
    del replay  # the probe returns: its graph is gone
    replay = _fake_capture(harness, fake, *second)
    out, seconds = replay()
    assert seconds == 2e-3 and torch.equal(out, torch.zeros(1))
    begins = [e for e in fake.log if e[0] == "capture_begin"]
    assert len(begins) == 2
    assert (begins[0][1] == begins[1][1]) is same_stream
    assert (begins[0][2] == begins[1][2]) is same_pool
    assert fake.made == {"streams": 1 if same_stream else 2, "pools": 1 if same_pool else 2}
    # One pool kept a key, each with the last graph captured into it.
    keys = [(torch.device("cuda:0"), "hbm")] + ([] if same_pool else [
        (torch.device(second[0]), second[1])])
    assert list(harness._KEPT.pools) == keys
    assert [len(kept) for kept in harness._KEPT.pools.values()] == [1] * len(keys)
    assert set(fake.users.values()) == {1}
    assert round_.counters == {"graph_captures": 2, "graph_replays": 2,
                               **({"graph_pool_reuses": 1} if same_pool else {})}


@pytest.mark.parametrize("case", ["live", "alternating", "raises", "order"])
def test_card_graph_capture_rules(fake_cuda, case):
    harness, fake, round_ = fake_cuda

    def pools():
        return [e[2] for e in fake.log if e[0] == "capture_begin"]

    if case == "live":
        # A graph still alive keeps its pool: the next capture of its label
        # gets a fresh one, and the one after that, with the first gone,
        # takes the first pool back.
        first = _fake_capture(harness, fake, "cuda:0", "burn")
        second = _fake_capture(harness, fake, "cuda:0", "burn")
        assert pools() == [(0, 1), (0, 2)]
        del first
        third = _fake_capture(harness, fake, "cuda:0", "burn")
        assert pools()[2] == (0, 1) and second is not third
        assert round_.counters["graph_pool_reuses"] == 1
    elif case == "alternating":
        # Two live graphs and a third capture: a third pool; the pools of
        # a label are kept, never dropped.
        runners = [_fake_capture(harness, fake, "cuda:0", "burn") for _ in range(3)]
        assert pools() == [(0, 1), (0, 2), (0, 3)] and len(runners) == 3
        del runners
        _fake_capture(harness, fake, "cuda:0", "burn")
        assert pools()[3] == (0, 1) and len(harness._KEPT.pools[(torch.device("cuda:0"),
                                                                  "burn")]) == 3
        assert round_.counters["graph_pool_reuses"] == 1
    elif case == "raises":
        # A body that raises still ends the capture and the error
        # propagates; the failed capture is not counted and leaves the
        # label's kept pool, and the graph that keeps it, as they were.
        def broken():
            raise ValueError("launch failed inside the capture")
        _fake_capture(harness, fake, "cuda:0", "int8")
        with pytest.raises(ValueError, match="launch failed inside the capture"):
            harness.card_graph(broken, lambda: None, torch.device("cuda:0"), "int8")
        assert [e[0] for e in fake.log if e[0].startswith("capture")] == \
            ["capture_begin", "capture_end"] * 2
        assert round_.counters == {"graph_captures": 1}
        _fake_capture(harness, fake, "cuda:0", "int8")
        assert pools() == [(0, 1)] * 3 and fake.users == {(0, 1): 1}
        assert round_.counters == {"graph_captures": 2, "graph_pool_reuses": 1}
    else:
        # The context manager's ordering, without its synchronise and its
        # cache flush (either would fail here).
        _fake_capture(harness, fake, "cuda:0", "hbm")()
        assert fake.log == [
            ("wait", "side1", "current:cuda:0"),  # the side stream after the caller's work
            ("warm", "side1"),
            ("wait", "current:cuda:0", "side1"),  # the caller after the warm-up
            ("capture_begin", "side1", (0, 1)),
            ("chain", "side1"),
            ("capture_end", "side1"),
            ("wait", "current:cuda:0", "side1"),  # the caller after the capture
            ("replay",),
        ]
