"""Relist fast path: projection decoding and content-addressed node reuse.

A copy of the JAX package's ``fastpath/__init__.py``: the public surface of
:mod:`tpu_node_checker_torch.fastpath.projection`, whose docstring gives the
fallback contract.
"""

from tpu_node_checker_torch.fastpath.projection import (
    GRADING_PROJECTION,
    ListProjector,
    NodeReuseCache,
    ProjectedFleet,
    ProjectedNode,
    ProjectionError,
    grading_digest,
    oracle_decode_page,
    peek_continue,
    project_node_doc,
    projection_enabled,
    reuse_allowed,
)

__all__ = [
    "GRADING_PROJECTION",
    "ListProjector",
    "NodeReuseCache",
    "ProjectedFleet",
    "ProjectedNode",
    "ProjectionError",
    "grading_digest",
    "oracle_decode_page",
    "peek_continue",
    "project_node_doc",
    "projection_enabled",
    "reuse_allowed",
]
