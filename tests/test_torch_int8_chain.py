"""The int8 chain kernel's arithmetic, on the CPU.

``ops/csrc/int8_chain.cu`` runs only on the card (tests/test_torch_cuda.py
holds it there against the plain chain).  Here a plain NumPy model of its
decomposition is held bit-equal to the plain chain: the roll as the row
coordinate ``m + r0 - (i mod m)`` into ``a2 = [a; a]``, the right operand as
``bt = b^T`` (N, K), and the output tiles times the groups of iterations
that ``int8_chain_plan`` picks, each group's partial tile added into the
sums.  Then the plan's choices, the wrapper's refusals and the kernel's
shape rule.

torch and the port are reached through ``importlib.import_module``
(tests/test_dependency_surface.py).
"""

import importlib

import numpy as np
import pytest

torch = importlib.import_module("torch")
port_ops = importlib.import_module("tpu_node_checker_torch.ops")
port_int8 = importlib.import_module("tpu_node_checker_torch.ops.int8_probe")

H100_SMS = 132


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, size=(m, k), dtype=np.int8),
            rng.integers(-8, 8, size=(k, n), dtype=np.int8))


def _groups(iters, groups):
    """The kernel's split: group g takes iterations g*iters//groups .. (g+1)*iters//groups - 1."""
    return [range(g * iters // groups, (g + 1) * iters // groups) for g in range(groups)]


def _kernel_model(a, b, iters, sms):
    """The kernel's sums, computed block by block as the kernel computes them.

    Every A box is rows ``m + r0 - (i mod m)`` .. ``+ bm`` of ``a2`` and
    every B box rows ``c0`` .. ``+ bn`` of ``bt``; each block's product of
    the two is read from one float64 product of ``a2`` with ``bt``, which is
    exact (every partial sum <= k * 64 << 2**53).
    """
    m, n = a.shape[0], b.shape[1]
    bm, bn, groups = port_int8.int8_chain_plan(m, n, iters, sms)
    a2 = np.concatenate([a, a])
    bt = np.ascontiguousarray(b.T)
    boxes = (a2.astype(np.float64) @ bt.T.astype(np.float64)).astype(np.int64)
    acc = np.zeros((m, n), dtype=np.int64)
    for r0 in range(0, m, bm):
        for c0 in range(0, n, bn):
            for its in _groups(iters, groups):
                part = np.zeros((bm, bn), dtype=np.int64)
                for i in its:
                    row = m + r0 - i % m
                    assert 1 <= row and row + bm <= 2 * m  # inside a2
                    part += boxes[row:row + bm, c0:c0 + bn]
                acc[r0:r0 + bm, c0:c0 + bn] += part
    assert np.abs(acc).max() <= iters * a.shape[1] * 64  # the int32 bound holds
    return acc.astype(np.int32)


def _plain_chain(a, b, iters):
    """The probe's own exact reference: roll(a, i) @ b == roll(a @ b, i)."""
    base = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int32)
    ref = np.zeros_like(base)
    for i in range(iters):
        ref += np.roll(base, i, axis=0)
    return ref


# (m, k, n, iters): one product; more iterations than row tiles; iterations
# past a whole turn of the roll; the probe's own chain.
SHAPES = [
    (128, 128, 128, 1),
    (256, 256, 384, 5),
    (384, 256, 512, 7),
    (128, 128, 256, 130),
    (1024, 1024, 1024, 128),
]


class TestKernelDecomposition:
    @pytest.mark.parametrize("sms", [H100_SMS, 16])
    @pytest.mark.parametrize("m,k,n,iters", SHAPES)
    def test_model_equals_plain_chain(self, m, k, n, iters, sms):
        a, b = _inputs(m, k, n, seed=m + n + iters)
        np.testing.assert_array_equal(_kernel_model(a, b, iters, sms), _plain_chain(a, b, iters))

    @pytest.mark.parametrize("m,k,n,iters", [s for s in SHAPES if s[3] <= 7])
    def test_plain_chain_is_the_library_loop(self, m, k, n, iters):
        # The plain version on the CPU: torch.roll, torch._int_mm and the adds.
        a, b = _inputs(m, k, n, seed=1)
        out = port_int8.int8_chain(torch.from_numpy(a), torch.from_numpy(b), iters)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), _plain_chain(a, b, iters))


class TestPlan:
    @pytest.mark.parametrize("sms", [1, 16, 78, 114, H100_SMS])
    @pytest.mark.parametrize("m,n,iters", [
        (128, 128, 1), (128, 128, 200), (256, 384, 8), (1024, 1024, 128),
        (1024, 1024, 3), (2048, 4096, 64), (4096, 4096, 128),
    ])
    def test_plan(self, m, n, iters, sms):
        bm, bn, groups = port_int8.int8_chain_plan(m, n, iters, sms)
        assert (bm, bn) in port_int8.KERNEL_TILES and m % bm == 0 and n % bn == 0
        # The largest tile that divides the result.
        assert (bm, bn) == next(t for t in port_int8.KERNEL_TILES
                                if m % t[0] == 0 and n % t[1] == 0)
        tiles = (m // bm) * (n // bn)
        # Every group non-empty, and the groups cover each iteration once.
        assert 1 <= groups <= iters
        runs = _groups(iters, groups)
        assert all(len(r) for r in runs)
        assert [i for r in runs for i in r] == list(range(iters))
        # One wave, as full as the shape allows: one more group would spill
        # past the SMs, unless every iteration already has a group.
        if tiles <= sms:
            assert tiles * groups <= sms
            assert groups == iters or tiles * (groups + 1) > sms
        else:
            assert groups == 1

    def test_probe_shape_fills_an_h100(self):
        bm, bn, groups = port_int8.int8_chain_plan(1024, 1024, 128, H100_SMS)
        assert (bm, bn, groups) == (128, 256, 4)
        assert (1024 // bm) * (1024 // bn) * groups == 128


class TestWrapperRefusals:
    def test_non_int8_dtype(self):
        with pytest.raises(TypeError, match="takes int8"):
            port_int8.int8_chain(torch.zeros(128, 128), torch.zeros(128, 128), 2)

    def test_mismatched_inner_dims(self):
        with pytest.raises(ValueError, match=r"\(M,K\) @ \(K,N\)"):
            port_int8.int8_chain(torch.zeros(128, 128, dtype=torch.int8),
                                 torch.zeros(256, 128, dtype=torch.int8), 2)

    @pytest.mark.parametrize("m,k,n,iters", [
        (100, 128, 128, 2), (128, 96, 128, 2), (128, 128, 200, 2), (128, 128, 128, 0),
    ])
    def test_shape_off_the_rule(self, m, k, n, iters):
        # The kernel's rule holds for every tensor off the CPU; only a CUDA
        # tensor in the rule launches (tests/test_torch_cuda.py).
        a = torch.zeros(m, k, dtype=torch.int8, device="meta")
        b = torch.zeros(k, n, dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="multiples of 128"):
            port_int8.int8_chain(a, b, iters)

    def test_cpu_takes_the_plain_version_and_launches_nothing(self):
        port_ops.reset_launches()
        a, b = _inputs(96, 40, 24)  # any shape: the plain version has no rule
        out = port_int8.int8_chain(torch.from_numpy(a), torch.from_numpy(b), 3)
        np.testing.assert_array_equal(out.numpy(), _plain_chain(a, b, 3))
        assert port_ops.launch_counts()["int8_chain"] == 0


class TestShapeRule:
    """The kernel's shape rule, one function for the wrapper and the probe."""

    @pytest.mark.parametrize("m,k,n,iters", [
        (128, 128, 128, 1), (256, 512, 384, 8), (1024, 1024, 1024, 128), (128, 4096, 128, 300),
    ])
    def test_in_the_rule(self, m, k, n, iters):
        assert port_int8.kernel_shape_error(m, k, n, iters) is None

    @pytest.mark.parametrize("m,k,n,iters", [
        (100, 128, 128, 2), (128, 96, 128, 2), (128, 128, 200, 2), (128, 128, 128, 0),
        (0, 128, 128, 2), (-128, 128, 128, 2), (512, 512, 512, -1),
    ])
    def test_off_the_rule(self, m, k, n, iters):
        error = port_int8.kernel_shape_error(m, k, n, iters)
        assert "not supported by the int8 chain kernel" in error
        assert f"({m},{k},{n})x{iters}" in error

    @pytest.mark.parametrize("m,k,n,iters", [(100, 40, 24, 3), (512, 512, 512, 8)])
    def test_cpu_probe_takes_any_shape(self, m, k, n, iters):
        # The rule binds the kernel only: the CPU probe runs the plain chain.
        res = port_int8.int8_matmul_probe(m=m, k=k, n=n, iters=iters, device="cpu")
        assert res.ok and res.error is None, res.error
