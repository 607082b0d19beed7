"""Bounded parallel fan-out for per-node Kubernetes API calls.

A copy of the JAX package's ``utils/fanout.py``, held equal to it by
``tests/test_torch_copies.py``.  ``bounded_map`` runs the round's per-node
calls (the ``--node-events`` walks) on at most ``--api-concurrency``
threads: results come back in input order, a worker's exception is
captured as its ``(False, exc)`` outcome, and one worker (or one item) is a
plain loop.  Each worker rides the shared
:class:`~tpu_node_checker_torch.cluster._StdlibSession`, whose pool hands it
its own keep-alive connection.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

DEFAULT_API_CONCURRENCY = 4


def bounded_map(
    fn: Callable, items: Iterable, max_workers: int
) -> List[Tuple[bool, object]]:
    """Apply ``fn`` to every item with at most ``max_workers`` in flight.

    Returns ``[(ok, value_or_exception), ...]`` aligned with the input
    order: ``(True, result)`` for a call that returned, ``(False, exc)``
    for one that raised.
    """
    items = list(items)
    if not items:
        return []
    if max_workers <= 1 or len(items) == 1:
        out: List[Tuple[bool, object]] = []
        for item in items:
            try:
                out.append((True, fn(item)))
            except Exception as exc:  # tnc: allow-broad-except(per-item, never fatal)
                out.append((False, exc))
        return out
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(
        max_workers=min(max_workers, len(items)),
        thread_name_prefix="tnc-fanout",
    ) as pool:
        futures = [pool.submit(fn, item) for item in items]
        out = []
        for future in futures:
            try:
                out.append((True, future.result()))
            except Exception as exc:  # tnc: allow-broad-except(per-item, never fatal)
                out.append((False, exc))
        return out
