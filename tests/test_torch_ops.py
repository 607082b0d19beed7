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
        assert port_ops.launch_counts() == {
            "tiled_matmul": 0, "dma_stream": 0, "flash_attention": 0,
        }

    @pytest.mark.parametrize("call", [
        lambda m: port_matmul.tiled_matmul(
            torch.zeros(128, 128, dtype=torch.bfloat16, device=m),
            torch.zeros(128, 128, dtype=torch.bfloat16, device=m), 0.5),
        lambda m: port_dma.dma_stream(torch.zeros(8, 8, device=m), 4),
        lambda m: port_flash.flash_forward(*(torch.zeros(1, 1, 128, 32, device=m) for _ in range(3))),
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
