"""Multi-cluster federation: a stateless aggregator tier over N checkers.

A copy of the JAX package's ``federation/__init__.py``.  The port has
:mod:`.endpoints` (the ``endpoints.json`` registry and :class:`HashRing`,
which the analytics store shards its segment files by); the aggregator and
merge tiers (``--federate``) are not ported yet.
"""
