"""Device-memory data-integrity pattern probe: the memtest analog.

The bandwidth probe (:mod:`tpu_node_checker_torch.ops.hbm`) answers "how
fast"; this one answers "does the memory HOLD data".  Known bit patterns are
written across a large device buffer, left to dwell, then read back and
compared exactly.  Stuck bits, address-decoder aliasing and retention faults
corrupt specific words: invisible inside a bandwidth figure, averaged away
inside a matmul reduction, but fatal to an exact compare.

Patterns (32-bit words):

* ``0x55555555`` and ``0xAAAAAAAA``: complementary checkerboards; between the
  two rounds every bit of every word is exercised in both polarities;
* ``addr``: word ``i`` holds ``(i * 2654435761) ^ 0x9E3779B9`` mod 2^32, so a
  read served from the WRONG location is caught even when every cell is
  healthy.

Unsigned 32-bit arithmetic is sparse in torch (above all on CUDA), so the
words are stored as int32 holding the same bits, and the ``addr`` hash is
computed in int64, masked to 32 bits, then reinterpreted.  Patterns are
generated and verified on the device; the host fetches only counts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from tpu_node_checker_torch.ops._harness import DeviceLike, resolve_device, sync

PATTERNS = ("0x55", "0xAA", "addr")
_MASK32 = 0xFFFFFFFF


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pattern(name: str, n: int, device: torch.device) -> torch.Tensor:
    """The pattern as ``n`` int32 words holding its uint32 bits."""
    if name == "0x55":
        return torch.full((n,), 0x55555555, dtype=torch.int32, device=device)
    if name == "0xAA":
        return torch.full((n,), 0xAAAAAAAA - 2**32, dtype=torch.int32, device=device)
    if name == "addr":
        i = torch.arange(n, dtype=torch.int64, device=device)
        # Odd-multiplier mix (Knuth 2654435761, golden-ratio xor): distinct
        # per address, cheap, and bijective in the low bits.
        return _as_int32_bits(((i * 2654435761) & _MASK32) ^ 0x9E3779B9)
    raise ValueError(f"unknown memtest pattern {name!r}; expected one of {PATTERNS}")


def _verify(name: str, x: torch.Tensor) -> int:
    """Regenerate the expectation on the device and count mismatching words."""
    return int((x != _pattern(name, x.shape[0], x.device)).sum().item())


@dataclass
class MemtestResult:
    ok: bool
    mib: int
    dwell_s: float
    mismatches: Dict[str, int] = field(default_factory=dict)
    elapsed_ms: float = 0.0
    error: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "ok": self.ok,
            "mib": self.mib,
            "dwell_s": self.dwell_s,
            "mismatches": dict(self.mismatches),
            "elapsed_ms": round(self.elapsed_ms, 1),
        }
        if self.error:
            d["error"] = self.error
        return d


def hbm_pattern_probe(
    mib: int = 64,
    dwell_s: float = 0.2,
    device: DeviceLike = None,
) -> MemtestResult:
    """Write/dwell/verify each pattern over a ``mib``-MiB buffer of words.

    ``ok`` iff zero mismatching words across all patterns.  ``dwell_s`` is the
    hold time between write and read-back (the retention window).
    """
    try:
        if mib <= 0 or dwell_s < 0:
            return MemtestResult(
                ok=False, mib=mib, dwell_s=dwell_s,
                error=f"invalid args mib={mib} dwell_s={dwell_s}",
            )
        dev = resolve_device(device)
        n = (mib * 1024 * 1024) // 4
        t0 = time.perf_counter()
        mismatches: Dict[str, int] = {}
        for name in PATTERNS:
            buf = _pattern(name, n, dev)
            sync(dev)  # the pattern is resident before the dwell
            if dwell_s:
                time.sleep(dwell_s)
            mismatches[name] = _verify(name, buf)
            del buf
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        bad = {k: v for k, v in mismatches.items() if v}
        return MemtestResult(
            ok=not bad,
            mib=mib,
            dwell_s=dwell_s,
            mismatches=mismatches,
            elapsed_ms=elapsed_ms,
            error=None
            if not bad
            else (
                "device memory pattern mismatch (stuck bits / aliasing / retention?): "
                + ", ".join(f"{k}={v} words" for k, v in bad.items())
            ),
        )
    except Exception as exc:  # probes report, never raise
        return MemtestResult(
            ok=False, mib=mib, dwell_s=dwell_s, error=f"{type(exc).__name__}: {exc}"
        )
