"""Mergeable percentile sketches for duration-shaped metrics.

A copy of the JAX package's ``analytics/sketch.py``, held equal to it by
``tests/test_torch_copies.py``.  Fixed geometric buckets (the DDSketch
construction): a value lands in bucket ``ceil(log_gamma(x))`` with
``gamma = (1 + alpha) / (1 - alpha)``, so a quantile read back from a
bucket is within relative error ``alpha``, and a merge is a bucket-wise
integer add, exactly associative and commutative.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

# Declared relative error bound: quantile estimates are within 1% of the
# exact order statistic for trackable values.  One default everywhere —
# sketches only merge when their alphas agree, and a fleet that can't
# merge its sketches has no global analytics.
DEFAULT_ALPHA = 0.01

# The trackable value range (unit-agnostic: callers feed seconds,
# milliseconds or microseconds as they please; the range spans 21 decades
# so every duration family fits with margin).
MIN_TRACKABLE = 1e-9
MAX_TRACKABLE = 1e12


class Sketch:
    """One fixed-size, associatively-mergeable percentile sketch."""

    __slots__ = ("alpha", "_gamma", "_log_gamma", "_idx_min", "_idx_max",
                 "counts", "zeros", "total", "sum", "min", "max")

    # alpha → (gamma, log_gamma, idx_min, idx_max).  The 100-cluster
    # fan-in deserializes thousands of sketches per round, all at the one
    # fleet alpha — recomputing three logs per construction was the
    # second-hottest line in the global merge profile.
    _ALPHA_CONSTANTS: Dict[float, tuple] = {}

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        constants = self._ALPHA_CONSTANTS.get(alpha)
        if constants is None:
            if not (0.0 < alpha < 1.0):
                raise ValueError(
                    f"sketch alpha must be in (0, 1), got {alpha}"
                )
            gamma = (1.0 + alpha) / (1.0 - alpha)
            log_gamma = math.log(gamma)
            # Fixed index universe: the size bound is structural, not a
            # runtime cap that could silently drop tail samples.
            constants = self._ALPHA_CONSTANTS[alpha] = (
                gamma, log_gamma,
                math.ceil(math.log(MIN_TRACKABLE) / log_gamma),
                math.ceil(math.log(MAX_TRACKABLE) / log_gamma),
            )
        self.alpha = alpha
        self._gamma, self._log_gamma, self._idx_min, self._idx_max = constants
        self.counts: Dict[int, int] = {}
        self.zeros = 0
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- ingest ---------------------------------------------------------------

    def _index(self, value: float) -> int:
        idx = math.ceil(math.log(value) / self._log_gamma)
        return max(self._idx_min, min(self._idx_max, idx))

    def add(self, value: float, count: int = 1) -> None:
        """Fold ``count`` observations of ``value`` in.  Non-positive and
        sub-resolution values land in the zero bucket (durations have no
        meaningful negatives; a clamp beats a raise on the round path)."""
        if count <= 0:
            return
        value = float(value)
        self.total += count
        if value > MIN_TRACKABLE:
            self.sum += value * count
            idx = self._index(value)
            self.counts[idx] = self.counts.get(idx, 0) + count
        else:
            value = 0.0
            self.zeros += count
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    # -- merge (exactly associative and commutative) --------------------------

    def merge(self, other: "Sketch") -> "Sketch":
        """Fold ``other`` into this sketch in place (and return self).

        Counts add bucket-wise as INTEGERS, so any merge order over any
        set of sketches yields identical counts — and therefore identical
        quantiles (min/max merge by comparison, equally order-free).
        Only ``sum`` is float arithmetic, and quantiles never read it.
        """
        if other.alpha != self.alpha:
            raise ValueError(
                f"cannot merge sketches with different error bounds "
                f"(α={self.alpha} vs α={other.alpha})"
            )
        for idx, count in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + count
        self.zeros += other.zeros
        self.total += other.total
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    def copy(self) -> "Sketch":
        sk = Sketch(self.alpha)
        sk.counts = dict(self.counts)
        sk.zeros = self.zeros
        sk.total = self.total
        sk.sum = self.sum
        sk.min = self.min
        sk.max = self.max
        return sk

    # -- query ----------------------------------------------------------------

    def quantile(self, q: float) -> Optional[float]:
        """The rank-``max(1, ceil(q·n))`` order statistic, within ``α``
        relative error for trackable values (the oracle in
        ``tests/test_sketch.py`` uses the same rank definition)."""
        if self.total == 0:
            return None
        q = max(0.0, min(1.0, q))
        rank = max(1, math.ceil(q * self.total))
        if rank <= self.zeros:
            return 0.0
        remaining = rank - self.zeros
        for idx in sorted(self.counts):
            remaining -= self.counts[idx]
            if remaining <= 0:
                # Log-space bucket midpoint: the DDSketch estimator whose
                # relative error is ≤ α for any value in the bucket.
                est = 2.0 * self._gamma ** idx / (self._gamma + 1.0)
                # Clamping to the observed range only ever moves the
                # estimate TOWARD the true order statistic (which lies
                # inside [min, max] by definition), and min/max merge
                # exactly — associativity survives.
                if self.min is not None:
                    est = max(est, self.min)
                if self.max is not None:
                    est = min(est, self.max)
                return est
        return self.max

    def percentiles(self, pctls=(50, 90, 99), ndigits: int = 2) -> Optional[dict]:
        """The query documents' ``{"p50": …, "p90": …, "p99": …}`` shape.

        One sorted pass over the buckets answers every requested rank
        (``quantile`` would re-sort per call — measurable across the 500
        group entries a 100-cluster global merge re-derives)."""
        if self.total == 0:
            return None
        ranks = [max(1, math.ceil(p / 100.0 * self.total)) for p in pctls]
        out: Dict[str, float] = {}
        pending = sorted(zip(ranks, pctls))
        pos = self.zeros
        if pos:
            while pending and pending[0][0] <= pos:
                rank, p = pending.pop(0)
                out[f"p{p}"] = 0.0
        if pending:
            gamma, lo, hi = self._gamma, self.min, self.max
            for idx in sorted(self.counts):
                pos += self.counts[idx]
                while pending and pending[0][0] <= pos:
                    rank, p = pending.pop(0)
                    est = 2.0 * gamma ** idx / (gamma + 1.0)
                    if lo is not None and est < lo:
                        est = lo
                    if hi is not None and est > hi:
                        est = hi
                    out[f"p{p}"] = est
                if not pending:
                    break
            for rank, p in pending:  # counts exhausted (clamp artifacts)
                out[f"p{p}"] = self.max
        return {f"p{p}": round(out[f"p{p}"], ndigits) for p in pctls}

    # -- wire shape (read/merge surface — free to call anywhere) ---------------

    def to_doc(self) -> dict:
        """The sparse wire document.  Bucket keys serialize as strings
        (JSON object keys); counts are exact integers, so a doc-level
        merge is as associative as an object-level one."""
        return {
            "alpha": self.alpha,
            "n": self.total,
            "zeros": self.zeros,
            "min": self.min,
            "max": self.max,
            "sum": round(self.sum, 6),
            "b": {str(idx): c for idx, c in sorted(self.counts.items())},
        }

    @classmethod
    def from_doc(cls, doc: dict) -> Optional["Sketch"]:
        """Rebuild from a wire document; None for anything malformed (a
        foreign tier's bad block must degrade that block, not the round)."""
        if not isinstance(doc, dict):
            return None
        alpha = doc.get("alpha")
        if not isinstance(alpha, (int, float)) or not (0.0 < alpha < 1.0):
            return None
        sk = cls(float(alpha))
        buckets = doc.get("b")
        if isinstance(buckets, dict) and buckets:
            # Bulk path first: the aggregator deserializes thousands of
            # these per global round, and a well-formed doc (every key an
            # int string, every count a positive int — what to_doc emits)
            # parses in one comprehension.  Anything else falls to the
            # tolerant per-bucket loop.
            idx_min, idx_max = sk._idx_min, sk._idx_max
            counts: Optional[Dict[int, int]] = None
            try:
                parsed = {int(k): c for k, c in buckets.items()}
            except (TypeError, ValueError):
                parsed = None
            if (
                parsed is not None
                and len(parsed) == len(buckets)
                and all(type(c) is int and c > 0 for c in parsed.values())
            ):
                if min(parsed) < idx_min or max(parsed) > idx_max:
                    counts = {}
                    for idx, c in parsed.items():
                        if idx < idx_min:
                            idx = idx_min
                        elif idx > idx_max:
                            idx = idx_max
                        counts[idx] = counts.get(idx, 0) + c
                else:
                    counts = parsed
            if counts is None:
                counts = {}
                for key, count in buckets.items():
                    try:
                        idx = int(key)
                    except (TypeError, ValueError):
                        continue
                    if count > 0 and type(count) is int:
                        if idx < idx_min:
                            idx = idx_min
                        elif idx > idx_max:
                            idx = idx_max
                        counts[idx] = counts.get(idx, 0) + count
            sk.counts = counts
        zeros = doc.get("zeros")
        sk.zeros = zeros if isinstance(zeros, int) and zeros > 0 else 0
        n = doc.get("n")
        counted = sum(sk.counts.values()) + sk.zeros
        sk.total = n if isinstance(n, int) and n >= counted else counted
        for attr in ("min", "max"):
            v = doc.get(attr)
            if isinstance(v, (int, float)):
                setattr(sk, attr, float(v))
        v = doc.get("sum")
        if isinstance(v, (int, float)):
            sk.sum = float(v)
        return sk


def merge_docs(docs: Iterable[Optional[dict]]) -> Optional[Sketch]:
    """Merge wire documents into one Sketch (None/malformed docs are
    skipped; None when nothing merged).  The aggregator's fan-in: exactly
    associative because every doc deserializes to integer bucket counts."""
    merged: Optional[Sketch] = None
    for doc in docs:
        if isinstance(doc, Sketch):
            sk, owned = doc, False
        else:
            # from_doc built a private Sketch — safe to keep without the
            # defensive copy a caller-owned object needs.
            sk, owned = Sketch.from_doc(doc), True
        if sk is None:
            continue
        if merged is None:
            merged = sk if owned else sk.copy()
        elif sk.alpha == merged.alpha:
            merged.merge(sk)
    return merged


def merge_state_docs(docs: Iterable[Optional[dict]]) -> Optional[dict]:
    """Doc-level fan-in: merge wire documents straight back into a wire
    document (what a mid-tier aggregator re-exports so the tier above can
    merge again — sketch blocks stay mergeable across arbitrary stacking)."""
    merged = merge_docs(docs)
    return merged.to_doc() if merged is not None else None


# -- persistence surface (TNC021: segments.py only) ---------------------------


def sketch_state(sk: Sketch) -> dict:
    """Serialize a sketch into a segment-record field.  THE persistence
    entry point: tnc-lint TNC021 pins every call site outside
    ``analytics/segments.py`` as a finding — sketch bytes reach disk only
    inside schema-stamped roll-up records."""
    return sk.to_doc()


def sketch_from_state(doc: dict) -> Optional[Sketch]:
    """Deserialize a segment-record sketch field (TNC021-gated like
    :func:`sketch_state`: segment records are parsed only by the store)."""
    return Sketch.from_doc(doc)


def sketch_of(values: Iterable[float], alpha: float = DEFAULT_ALPHA) -> Sketch:
    """Build a sketch over ``values`` in one call (the query builders'
    per-round scalar distributions: availability, MTBF)."""
    sk = Sketch(alpha)
    sk.extend(values)
    return sk
