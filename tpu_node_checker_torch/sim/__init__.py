"""The chaos simulator (``simulate``), a copy of the JAX package's ``sim/``.

Seeded fleet scenarios drive the port's checker and aggregator machinery
against simulated API servers and are graded by an invariant matrix.
Entry points: the ``simulate`` subcommand (:mod:`tpu_node_checker_torch.sim.cli`),
:func:`tpu_node_checker_torch.sim.engine.run_scenario`, and the scripts and
fake API server handlers of :mod:`tpu_node_checker_torch.sim.fixtures`.  Each
module is held equal to its JAX original by ``tests/test_torch_copies.py``;
all randomness comes from one seeded ``random.Random`` and all time from
:mod:`tpu_node_checker_torch.sim.clock`, so one seed gives one report, byte
for byte, on either package.
"""

from tpu_node_checker_torch.sim.clock import SimClock, WallClock
from tpu_node_checker_torch.sim.fixtures import (
    FaultSchedule,
    StormSchedule,
    WatchScript,
    fault_scheduled_handler,
    make_node,
    node_list,
    paged_nodelist_handler,
    serve_http,
    storm_apiserver,
    storm_available_by_slice,
    watch_bookmark,
    watch_error_gone,
    watch_event,
    watch_nodelist_handler,
)

__all__ = [
    "SimClock",
    "WallClock",
    "FaultSchedule",
    "StormSchedule",
    "WatchScript",
    "fault_scheduled_handler",
    "make_node",
    "node_list",
    "paged_nodelist_handler",
    "serve_http",
    "storm_apiserver",
    "storm_available_by_slice",
    "watch_bookmark",
    "watch_error_gone",
    "watch_event",
    "watch_nodelist_handler",
]
