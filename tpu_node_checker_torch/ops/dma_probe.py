"""Copy-engine probe: a double-buffered bulk-copy stream in a hand-written kernel.

The matmul and memory-stream probes exercise the compute units and the
memory path that library kernels schedule; this probe drives **Hopper's
asynchronous copy engine and its mbarriers directly**, the machinery serving
stacks lean on for KV-cache streaming and weight prefetch.  A card can pass
every library kernel and still have a copy path that corrupts or wedges
under manually scheduled copies.

The kernel (``csrc/dma_stream.cu``) streams an f32 (rows, cols) array in
``chunk_rows``-row chunks through a 2-slot shared-memory ring with bulk
copies, writes ``2x + 1`` into a second 2-slot ring and bulk-stores it back.
Verification is exact: ``out == 2x + 1`` elementwise, against the plain
version.

On an H100 the probe's 8 MiB input fits in the 50 MB L2 cache, so
``dma_gbps`` there reads the copy path through L2, not device memory.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import torch

from tpu_node_checker_torch.ops import _build
from tpu_node_checker_torch.ops._harness import DeviceLike, is_cpu, resolve_device, sync


@dataclass
class DmaProbeResult:
    ok: bool
    gbps: float
    elapsed_ms: float
    interpreted: bool
    error: Optional[str] = None


def dma_stream_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``2x + 1`` in f32."""
    return x * 2.0 + 1.0


def dma_stream(x: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """``2x + 1`` for an f32 (rows, cols) ``x``, streamed in ``chunk_rows`` chunks.

    CUDA tensors launch the bulk-copy kernel; CPU tensors take the plain
    version.  Nothing falls back.
    """
    if x.dim() != 2:
        raise ValueError(f"dma_stream needs a (rows, cols) array, got {tuple(x.shape)}")
    rows, cols = x.shape
    if min(rows, cols, chunk_rows) <= 0 or rows % chunk_rows:
        raise ValueError(
            f"dma_stream shape rows={rows} cols={cols} chunk_rows={chunk_rows}: "
            "dims must be positive and rows a multiple of chunk_rows"
        )
    if x.device.type == "cpu":
        return dma_stream_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"dma_stream runs on cuda (kernel) or cpu (plain), not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"dma_stream kernel takes float32, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # a fresh allocation is aligned; bulk copies need 16 bytes
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    fn = _build.kernel("dma_stream")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), out.data_ptr(), rows, cols, chunk_rows, sms, stream)
    _build.check("dma_stream", code)
    dma_stream.launches += 1
    return out


dma_stream.launches = 0


def dma_stream_probe(
    rows: int = 4096,
    cols: int = 512,
    chunk_rows: int = 256,
    device: DeviceLike = None,
) -> DmaProbeResult:
    """Stream a (rows, cols) f32 array through the double-buffered kernel and
    verify ``2x + 1`` exactly."""
    interpreted = is_cpu(device)
    try:
        if min(rows, cols, chunk_rows) <= 0 or rows % chunk_rows:
            return DmaProbeResult(
                ok=False, gbps=0.0, elapsed_ms=0.0, interpreted=interpreted,
                error=f"invalid shape rows={rows} cols={cols} "
                f"chunk_rows={chunk_rows}: dims must be positive and rows a "
                "multiple of chunk_rows",
            )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((rows, cols), generator=gen, device=dev)
        out = dma_stream(x, chunk_rows)
        sync(dev)
        checksum = float(out.sum().item())  # completion barrier
        t0 = time.perf_counter()
        out = dma_stream(x, chunk_rows)
        sync(dev)
        checksum = float(out.sum().item())
        elapsed = time.perf_counter() - t0

        exact = bool(torch.equal(out, dma_stream_reference(x)))
        ok = exact and math.isfinite(checksum)
        bytes_moved = 2 * 4 * rows * cols  # one read + one write per element
        return DmaProbeResult(
            ok=ok,
            gbps=bytes_moved / elapsed / 1e9,
            elapsed_ms=elapsed * 1e3,
            interpreted=interpreted,
            error=None if ok else "bulk-copy-streamed result differs from the plain 2x+1",
        )
    except Exception as exc:  # probes report, never raise
        return DmaProbeResult(
            ok=False, gbps=0.0, elapsed_ms=0.0, interpreted=interpreted,
            error=f"{type(exc).__name__}: {exc}",
        )
