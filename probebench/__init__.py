"""The benchmark of ``tpu_node_checker_torch``: ``python3 probebench/run.py``.

Data, found by name: ``configs/<config>.json`` (a deployment), ``traffic/<traffic>.json``
(the round mix one general driver runs), ``cells/<cell>.json`` (a configuration under a
traffic mix, with the limits of its comparison) and ``metrics/<metric>.py`` (one reader
a metric).  ``BENCHMARK.json`` at the checkout's root lists them.
"""
