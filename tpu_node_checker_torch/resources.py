"""Accelerator resource-key registry.

The reference hard-codes an exact-match list of four GPU resource keys
(``GPU_RESOURCE_KEYS``, check-gpu-node.py:39-44) and scans ``status.capacity``
for them with an exact-key loop (check-gpu-node.py:186-189).  TPU resource keys
need pattern matching (``cloud-tpus.google.com/v4``, ``.../v5e``, ...), so this
module replaces the flat list with a small registry of matchers that still
reports per-key attribution (the reference's ``gpu_breakdown`` shape,
check-gpu-node.py:191-195) and additionally tags every match with an
accelerator *family* (``gpu`` / ``tpu``) so downstream layers can apply
TPU-only semantics (topology labels, slice grouping, chip probes).

A copy of the JAX package's ``resources.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional


@dataclass(frozen=True)
class KeyMatcher:
    """One accelerator resource-key pattern.

    ``pattern`` is an ``fnmatch``-style glob; an exact key is the degenerate
    glob with no wildcards.  ``family`` groups keys into accelerator classes
    the rest of the framework branches on.
    """

    pattern: str
    family: str  # "gpu" | "tpu"
    vendor: str

    def matches(self, key: str) -> bool:
        if "*" not in self.pattern and "?" not in self.pattern:
            return key == self.pattern
        return fnmatch.fnmatchcase(key, self.pattern)


@dataclass(frozen=True)
class AcceleratorMatch:
    """A resource key that matched the registry, with its parsed count."""

    key: str
    count: int
    family: str
    vendor: str


# The reference's exact GPU key set (check-gpu-node.py:39-44), kept verbatim as
# the regression path, plus the TPU keys the north star adds.
DEFAULT_MATCHERS: tuple[KeyMatcher, ...] = (
    KeyMatcher("nvidia.com/gpu", "gpu", "nvidia"),
    KeyMatcher("amd.com/gpu", "gpu", "amd"),
    KeyMatcher("gpu.intel.com/i915", "gpu", "intel"),
    KeyMatcher("intel.com/gpu", "gpu", "intel"),
    KeyMatcher("google.com/tpu", "tpu", "google"),
    KeyMatcher("cloud-tpus.google.com/v*", "tpu", "google"),
)


class ResourceRegistry:
    """Ordered collection of :class:`KeyMatcher` with first-match-wins lookup."""

    def __init__(self, matchers: Iterable[KeyMatcher] = DEFAULT_MATCHERS):
        self._matchers: tuple[KeyMatcher, ...] = tuple(matchers)

    def __iter__(self) -> Iterator[KeyMatcher]:
        return iter(self._matchers)

    def match(self, key: str) -> Optional[KeyMatcher]:
        for m in self._matchers:
            if m.matches(key):
                return m
        return None

    def with_extra_keys(self, keys: Iterable[str], family: str = "gpu") -> "ResourceRegistry":
        """Registry extended with user-supplied keys (``--resource-key`` flag)."""
        extra = tuple(KeyMatcher(k, family, "custom") for k in keys)
        return ResourceRegistry(self._matchers + extra)

    def scan(self, quantities: Optional[dict]) -> list[AcceleratorMatch]:
        """Scan a k8s quantity map (``status.allocatable`` / ``capacity``).

        Mirrors the reference's capacity scan (check-gpu-node.py:181-196):
        truthy values only, integer counts, non-integer quantities silently
        dropped — but over glob matchers and with family tagging.
        """
        from tpu_node_checker_torch.utils.quantity import parse_quantity

        if not quantities:
            return []
        out: list[AcceleratorMatch] = []
        for key, raw in quantities.items():
            m = self.match(key)
            if m is None:
                continue
            count = parse_quantity(raw)
            if count is None or count <= 0:
                continue
            out.append(AcceleratorMatch(key=key, count=count, family=m.family, vendor=m.vendor))
        return out


def default_registry() -> ResourceRegistry:
    return ResourceRegistry(DEFAULT_MATCHERS)
