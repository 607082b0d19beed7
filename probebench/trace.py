"""Reduction of a ``torch.profiler`` chrome trace to device intervals.

Times in a trace are microseconds on one timeline for the host's events and
the card's.  Device work is every complete event (``ph == "X"``) of the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories; busy time is the
length of their union, so overlapping streams count once.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaGraphLaunch", "cudaGraphLaunch_v10000")

Interval = Tuple[float, float]


def load(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def device_events(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def is_nccl(e: dict) -> bool:
    """An NCCL kernel: a collective, a send or a receive, which holds its
    card from its launch until every peer has joined."""
    return e.get("cat") == "kernel" and "nccl" in str(e.get("name", "")).lower()


def busy_of(events: Iterable[dict]) -> float:
    """Microseconds covered by the union of ``events``' intervals."""
    return sum(e - s for s, e in union((e["ts"], e["ts"] + e["dur"]) for e in events))


def annotations(events: Iterable[dict], name: str) -> List[Interval]:
    """Host intervals of the benchmark's ``probebench:<name>`` annotations."""
    want = f"probebench:{name}"
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") == want)


def union(intervals: Iterable[Interval], lo: Optional[float] = None,
          hi: Optional[float] = None) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], sorted and disjoint."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: Iterable[dict], lo: Optional[float] = None,
            hi: Optional[float] = None) -> float:
    """Microseconds in [lo, hi] in which the card ran any operation."""
    spans = ((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    return sum(e - s for s, e in union(spans, lo, hi))


def idle_gaps(events: Iterable[dict], lo: float, hi: float) -> List[Interval]:
    """Intervals of [lo, hi] in which the card ran nothing."""
    gaps, t = [], lo
    spans = ((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    for s, e in union(spans, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def op_seconds(events: Iterable[dict]) -> dict:
    """Device seconds by operation name."""
    totals: dict = {}
    for e in device_events(events):
        totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] / 1e6
    return totals


def launched_by_graphs(events: List[dict], within: List[Interval]) -> Tuple[int, List[dict]]:
    """(graph launches, their device events) for the CUDA graph launch calls
    that lie in one of the host intervals ``within``, matched by correlation
    id; a launch whose device events the trace lacks is not counted."""
    ids = set()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and e.get("name") in LAUNCHES:
            if any(s <= e["ts"] <= t for s, t in within):
                ids.add((e.get("args") or {}).get("correlation"))
    ids.discard(None)
    launched = [e for e in device_events(events) if (e.get("args") or {}).get("correlation") in ids]
    return len({e["args"]["correlation"] for e in launched}), launched


def launched_within(events: List[dict], within: List[Interval]) -> List[dict]:
    """The device events of every launch (a CUDA runtime or driver call:
    kernels, copies, fills, graphs) made in one of the host intervals
    ``within``, matched by correlation id."""
    ids = set()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            if any(s <= e["ts"] <= t for s, t in within):
                ids.add((e.get("args") or {}).get("correlation"))
    ids.discard(None)
    return [e for e in device_events(events) if (e.get("args") or {}).get("correlation") in ids]


def label_of(t: float, labelled: List[Tuple[str, Interval]], default: str) -> str:
    """The innermost labelled interval holding ``t``."""
    best, width = default, float("inf")
    for name, (s, e) in labelled:
        if s <= t <= e and e - s < width:
            best, width = name, e - s
    return best
