"""Federated disruption budgets: the checker's lease client.

A copy of the JAX package's ``remediation/lease.py``, held equal to it by
``tests/test_torch_copies.py``.  ``POST {url}/api/v1/global/disruption-lease``
with ``{"count", "action", "node", "cluster"}``; 200 grants, 409 denies (a
local refusal).  An unreachable aggregator (or a 404) falls back to the
local budget, bounded by the fleet allowance the last response left; a
checker that never reached it runs on the local budget alone.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Tuple

LEASE_PATH = "/api/v1/global/disruption-lease"
LEASE_TIMEOUT_S = 5.0


class LeaseClient:
    """Borrow actuation permits from the aggregator's fleet budget."""

    def __init__(self, url: str, cluster: Optional[str] = None, session=None):
        self.url = url.rstrip("/")
        self.cluster = cluster
        if session is None:
            from tpu_node_checker_torch.cluster import _StdlibSession

            session = _StdlibSession()
        self._session = session
        # The fleet allowance as of the last response the aggregator gave
        # us — the fallback bound.  None = never heard from it.
        self.fleet_remaining: Optional[int] = None
        self.leases_granted = 0
        self.leases_denied = 0
        self.fallback_grants = 0
        self.last_error: Optional[str] = None

    def acquire(self, count: int, action: str = "", node: str = "",
                trace_id: Optional[str] = None) -> Tuple[bool, str]:
        """→ ``(granted, reason)``; never raises."""
        body = {"count": count, "action": action, "node": node}
        if self.cluster:
            body["cluster"] = self.cluster
        if trace_id:
            body["trace_id"] = trace_id
        try:
            resp = self._session.post(
                self.url + LEASE_PATH,
                data=json.dumps(body),
                headers={"Content-Type": "application/json"},
                timeout=LEASE_TIMEOUT_S,
            )
            if resp.status_code == 404:
                # Endpoint absent (older aggregator / no fleet budget
                # configured): same fallback as unreachable.
                raise OSError("lease endpoint absent (HTTP 404)")
            doc = resp.json()
            if not isinstance(doc, dict):
                raise ValueError("lease response is not a JSON object")
        except Exception as exc:  # tnc: allow-broad-except(any lease-path failure — refused dial, timeout, bad body — is the ONE unreachable outcome; the fallback below degrades toward less actuation, never raises into the sweep)
            self.last_error = f"{type(exc).__name__}: {exc}"
            return self._fallback(count)
        self.last_error = None
        remaining = doc.get("remaining")
        if isinstance(remaining, int) and not isinstance(remaining, bool):
            self.fleet_remaining = remaining
        if doc.get("granted"):
            self.leases_granted += count
            return True, "lease-granted"
        self.leases_denied += 1
        return False, "lease-denied"

    def _fallback(self, count: int) -> Tuple[bool, str]:
        if self.fleet_remaining is None:
            # Never reached the aggregator: the local budget alone governs
            # (the documented fallback) — note it once per outage.
            self.fallback_grants += count
            return True, "lease-unreachable-local-budget"
        if self.fleet_remaining < count:
            print(
                f"disruption lease: aggregator unreachable "
                f"({self.last_error}) and the last-leased fleet allowance "
                "is exhausted — refusing actuation.",
                file=sys.stderr,
            )
            return False, "lease-unreachable"
        # Spend down the allowance the aggregator last confirmed: never
        # actuate past the fleet budget we last saw.
        self.fleet_remaining -= count
        self.fallback_grants += count
        return True, "lease-unreachable-local-budget"

    def as_dict(self) -> dict:
        d = {
            "url": self.url,
            "granted": self.leases_granted,
            "denied": self.leases_denied,
            "fallback_grants": self.fallback_grants,
        }
        if self.fleet_remaining is not None:
            d["fleet_remaining"] = self.fleet_remaining
        if self.last_error:
            d["unreachable"] = self.last_error
        return d

    def close(self) -> None:
        close = getattr(self._session, "close", None)
        if callable(close):
            close()
