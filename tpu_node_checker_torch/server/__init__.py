"""The fleet state API (``--serve``) and the HTTP contract both embedded
servers speak.

A copy of the JAX package's ``server/__init__.py``: :mod:`.router` (routing,
ETag and gzip negotiation, shared with ``--metrics-port``), :mod:`.snapshot`
(immutable pre-serialized round snapshots), :mod:`.auth` (the bearer gate of
the write path) and :mod:`.app` (the server, imported lazily).
"""

from tpu_node_checker_torch.server.auth import resolve_serve_token  # noqa: F401
from tpu_node_checker_torch.server.router import Router, negotiate  # noqa: F401
from tpu_node_checker_torch.server.snapshot import (  # noqa: F401
    Entity,
    FleetSnapshot,
    TrendCache,
    build_snapshot,
    build_store_snapshot,
)


def __getattr__(name):
    # FleetStateServer lazily: app → metrics → server.router must not run
    # during this package's own import.
    if name in ("FleetStateServer", "ServerStats"):
        from tpu_node_checker_torch.server import app

        return getattr(app, name)
    raise AttributeError(name)
