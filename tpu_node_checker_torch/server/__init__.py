"""The HTTP contract the emitter's ``--metrics-port`` scrape rides on.

:mod:`.router` is a copy of the parts of the JAX package's
``server/router.py`` and ``server/snapshot.py`` that its ``MetricsServer``
uses: routing with 404/405, ``HEAD`` from ``GET``, and one pre-serialized
entity per body with a strong ETag and a gzip variant.
"""
