"""Peaks of the card and the work of the kernels the benchmark grades.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit); a card set below it runs slower under load, so the
harness prints the card's power limit beside every run.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The card's peaks; a card not in the table has no roofline here."""
    return PEAKS.get(kind)


def chain_product_work(n: int) -> tuple:
    """(operations, bytes) of one burn-chain product: bf16 (n, n) @ (n, n)
    with float32 out, each input read once and the output written once."""
    return 2.0 * n ** 3, 2.0 * 2 * n * n + 4.0 * n * n


def least_seconds(flops: float, bytes_moved: float, peak: dict) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak["bf16_flops"], bytes_moved / peak["hbm_bytes_per_s"])
