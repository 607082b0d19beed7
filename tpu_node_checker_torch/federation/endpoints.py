"""The federation cluster registry: ``endpoints.json`` and worker sharding.

A copy of the JAX package's ``federation/endpoints.py``, held equal to it by
``tests/test_torch_copies.py``.  :func:`load_endpoints` reads and validates
``{"clusters": [{"name", "url", "token"?}, ...]}``; :class:`HashRing` is a
consistent-hash ring with virtual nodes, so a key's owner moves only when
its own arc changes (the analytics tier shards segment files with it).
"""

from __future__ import annotations

import bisect
import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional

# Virtual ring points per worker slot: enough that a handful of clusters
# spreads evenly over a handful of workers.
_RING_POINTS_PER_SLOT = 64


class EndpointsError(ValueError):
    """endpoints.json is malformed (message says how)."""


@dataclass(frozen=True)
class ClusterEndpoint:
    """One per-cluster checker's fleet API, as registered."""

    name: str
    url: str
    token: Optional[str] = None


def load_endpoints(path: str) -> List[ClusterEndpoint]:
    """Parse + validate ``endpoints.json`` → the registered cluster list.

    Raises :class:`EndpointsError` on malformed content (the aggregator
    fails FAST at startup; between rounds the caller keeps the last good
    set) and ``OSError`` when unreadable.
    """
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as exc:
            raise EndpointsError(f"{path}: not valid JSON: {exc}") from exc
    if not isinstance(doc, dict) or not isinstance(doc.get("clusters"), list):
        raise EndpointsError(
            f"{path}: expected an object with a 'clusters' list"
        )
    out: List[ClusterEndpoint] = []
    seen: set = set()
    for i, entry in enumerate(doc["clusters"]):
        if not isinstance(entry, dict):
            raise EndpointsError(f"{path}: clusters[{i}] is not an object")
        name = entry.get("name")
        url = entry.get("url")
        token = entry.get("token")
        if not isinstance(name, str) or not name:
            raise EndpointsError(f"{path}: clusters[{i}] has no 'name'")
        if "/" in name:
            # The global view keys nodes "cluster/node"; a slash inside the
            # cluster half would make the key ambiguous.
            raise EndpointsError(
                f"{path}: cluster name {name!r} must not contain '/'"
            )
        if name in seen:
            raise EndpointsError(f"{path}: duplicate cluster name {name!r}")
        seen.add(name)
        if not isinstance(url, str) or not url.lower().startswith(
            ("http://", "https://")
        ):
            raise EndpointsError(
                f"{path}: clusters[{i}] ({name!r}) needs an http(s) 'url'"
            )
        if token is not None and not isinstance(token, str):
            raise EndpointsError(
                f"{path}: clusters[{i}] ({name!r}) token must be a string"
            )
        out.append(ClusterEndpoint(name=name, url=url.rstrip("/"), token=token))
    if not out:
        raise EndpointsError(f"{path}: 'clusters' is empty")
    return out


def _hash_point(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """The ONE consistent-hash ring: virtual points per slot, keys mapped
    to the next point clockwise.

    Shared by :func:`shard_clusters` (cluster → fetcher-thread assignment)
    and the analytics tier's segment store (node → shard-file assignment,
    :mod:`~tpu_node_checker_torch.analytics.segments`), so shard keys federate:
    the same key lands on the same slot whichever tier asks, assignments
    are stable under key churn, and resizing the slot set moves only the
    keys nearest the new/removed slots' ring points (~1/W of them).
    """

    def __init__(self, slots, points_per_slot: int = _RING_POINTS_PER_SLOT):
        self._ring: List[tuple] = sorted(
            (_hash_point(f"slot-{slot}#{point}"), slot)
            for slot in slots
            for point in range(points_per_slot)
        )
        if not self._ring:
            raise ValueError("HashRing needs at least one slot")
        self._points = [p for p, _ in self._ring]

    def assign(self, key: str):
        """The slot ``key`` lives on (deterministic across processes)."""
        idx = bisect.bisect_right(self._points, _hash_point(key)) % len(
            self._ring
        )
        return self._ring[idx][1]


def shard_clusters(names: List[str], workers: int) -> Dict[int, List[str]]:
    """Consistent-hash assignment: cluster name → worker slot.

    Returns ``{slot: [names...]}`` covering every name (slots with no
    clusters are omitted).  Deterministic across processes and stable
    under cluster add/remove; resizing the worker pool remaps only the
    clusters nearest the new/removed slots' ring points.
    """
    workers = max(1, int(workers))
    if workers == 1:
        return {0: list(names)}
    ring = HashRing(range(workers))
    shards: Dict[int, List[str]] = {}
    for name in names:
        shards.setdefault(ring.assign(name), []).append(name)
    return shards
