"""Fleet analytics tier (``--analytics DIR``): a downsampling time-series
store over the health-history stream, an SLO query engine, and online
flap prediction.

A copy of the JAX package's ``analytics/__init__.py``:
:mod:`.segments` folds the per-node verdict stream into 1m/15m/6h roll-up
buckets sharded across segment files; :mod:`.queries` answers the SLO,
offender and flap documents the fleet API serves; :mod:`.changepoint`
promotes flappers (and drifting mesh links) to SUSPECT before the
hysteresis machine sees a hard failure; :mod:`.sketch` keeps mergeable
percentile sketches of duration-shaped samples.
"""

from tpu_node_checker_torch.analytics.changepoint import (
    CusumFlapDetector,
    LinkDriftDetector,
)
from tpu_node_checker_torch.analytics.segments import SegmentStore, append_bucket
from tpu_node_checker_torch.analytics.queries import build_analytics_docs

__all__ = [
    "CusumFlapDetector",
    "LinkDriftDetector",
    "SegmentStore",
    "append_bucket",
    "build_analytics_docs",
]
