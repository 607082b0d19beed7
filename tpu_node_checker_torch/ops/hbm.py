"""Device-memory bandwidth probe.

A streaming ``x + 1`` over a buffer large enough (default 256 MiB, five
times the H100's 50 MB L2) that every pass is memory-bound: one read and one
write per element.  Achieved GB/s is the health signal: a card whose memory
channels are degraded shows up here long before it fails a matmul.

On the card the passes are captured once as a CUDA graph and the timed run
replays it between two CUDA events: the figure is the bytes moved over the
passes' device time, so a busy host does not read as slow memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_node_checker_torch.ops._harness import DeviceLike, chain_clock, resolve_device
from tpu_node_checker_torch.probe import spans


@dataclass
class HbmResult:
    ok: bool
    gbps: float
    elapsed_ms: float
    bytes_moved: int
    error: Optional[str] = None


def _stream_n(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` passes of ``y + 1`` over a copy of ``x``.

    The passes update one buffer in place (the JAX loop carries a fresh
    array per pass), which keeps the probe at twice the buffer's size.
    """
    y = x + 1.0
    for _ in range(iters - 1):
        y.add_(1.0)
    return y


def hbm_bandwidth_probe(
    mib: int = 256, iters: int = 4, device: DeviceLike = None
) -> HbmResult:
    """Time ``iters`` streaming passes over a ``mib``-MiB float32 buffer."""
    try:
        if mib <= 0 or iters <= 0:
            return HbmResult(
                ok=False, gbps=0.0, elapsed_ms=0.0, bytes_moved=0,
                error=f"invalid args mib={mib} iters={iters}: must be positive",
            )
        dev = resolve_device(device)
        n = (mib * 1024 * 1024) // 4
        with spans.span("hbm.alloc"):
            x = torch.zeros((n,), dtype=torch.float32, device=dev)
        run = chain_clock(lambda: _stream_n(x, iters), lambda: _stream_n(x, 1), dev, "hbm")
        run()  # warm
        y, elapsed = run()
        final = float(y[0].item())
        # A correctness check: iters additions of 1.
        if final != float(iters):
            return HbmResult(
                ok=False, gbps=0.0, elapsed_ms=elapsed * 1e3, bytes_moved=0,
                error=f"stream result wrong: expected {float(iters)}, got {final}",
            )
        bytes_moved = 2 * 4 * n * iters  # read + write per element per pass
        return HbmResult(
            ok=True,
            gbps=bytes_moved / elapsed / 1e9,
            elapsed_ms=elapsed * 1e3,
            bytes_moved=bytes_moved,
        )
    except Exception as exc:  # tnc: allow-broad-except(probes report, never raise)
        return HbmResult(
            ok=False, gbps=0.0, elapsed_ms=0.0, bytes_moved=0,
            error=f"{type(exc).__name__}: {exc}",
        )
