"""Single-card compute probes: real work as a health signal.

* :func:`matmul_burn` and :func:`int8_matmul_probe`: bf16 and int8 products
  on the tensor cores, checked by an invariant and exactly;
* :func:`hbm_bandwidth_probe` and :func:`hbm_pattern_probe`: device-memory
  bandwidth and data integrity;
* :func:`pallas_matmul_probe`, :func:`dma_stream_probe` and
  :func:`flash_attention_probe`: the three kernels written by hand for
  Hopper (``ops/csrc/``), each held against its plain PyTorch version.

Each kernel's wrapper counts its launches (``<wrapper>.launches``), so a run
can show that its path went through the kernels: :func:`launch_counts` reads
the counts and :func:`reset_launches` sets them to 0.
"""

from tpu_node_checker_torch.ops.burn import BurnResult, SoakResult, matmul_burn, soak_burn
from tpu_node_checker_torch.ops.dma_probe import DmaProbeResult, dma_stream, dma_stream_probe
from tpu_node_checker_torch.ops.flash_attention import (
    FlashAttentionProbeResult,
    flash_attention,
    flash_attention_probe,
    flash_forward,
)
from tpu_node_checker_torch.ops.hbm import HbmResult, hbm_bandwidth_probe
from tpu_node_checker_torch.ops.int8_probe import Int8Result, int8_matmul_probe
from tpu_node_checker_torch.ops.memtest import MemtestResult, hbm_pattern_probe
from tpu_node_checker_torch.ops.pallas_probe import (
    PallasProbeResult,
    pallas_matmul_probe,
    tiled_matmul,
)

# Kernel name (its csrc/<name>.cu) -> the wrapper that launches it.
KERNEL_WRAPPERS = {
    "tiled_matmul": tiled_matmul,
    "dma_stream": dma_stream,
    "flash_attention": flash_forward,
}


def launch_counts() -> dict:
    """Launches of each kernel in this process since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "BurnResult",
    "SoakResult",
    "matmul_burn",
    "soak_burn",
    "DmaProbeResult",
    "dma_stream",
    "dma_stream_probe",
    "FlashAttentionProbeResult",
    "flash_attention",
    "flash_attention_probe",
    "flash_forward",
    "HbmResult",
    "hbm_bandwidth_probe",
    "Int8Result",
    "int8_matmul_probe",
    "MemtestResult",
    "hbm_pattern_probe",
    "PallasProbeResult",
    "pallas_matmul_probe",
    "tiled_matmul",
    "KERNEL_WRAPPERS",
    "launch_counts",
    "reset_launches",
]
