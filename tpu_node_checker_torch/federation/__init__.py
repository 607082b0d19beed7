"""Multi-cluster federation: a stateless aggregator tier over N checkers.

A copy of the JAX package's ``federation/__init__.py``: :mod:`.endpoints`
(the ``endpoints.json`` registry and the consistent-hash sharding of
clusters over fetcher workers), :mod:`.aggregator` (the fetch tier and the
``--federate`` mode loop) and :mod:`.merge` (the per-cluster bodies joined
by bytes into ``/api/v1/global/*``).  An unreachable or stale cluster
degrades only its own shard, never the fleet.
"""
