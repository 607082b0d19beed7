"""Whole-program flow analysis for tnc-lint.

The per-file rule families (DESIGN §11) reason one AST at a time, which is
exactly the blind spot the multi-threaded system keeps growing into: a
``time.sleep`` one call deep under a snapshot read root, or a shared
attribute mutated from a helper in another module, is invisible to a
single-file walk.  This package builds the project-wide view those checks
need:

* :mod:`graph` — module-qualified symbol table + call graph over the
  stdlib ``ast``: direct calls, ``self.``-method dispatch, imported-name
  resolution, single/low-fanout dynamic-dispatch fallback, decorator
  unwrapping, ``functools.partial``/lambda targets — with an explicit
  ``unresolved`` bucket so every soundness gap is *counted*, never silent;
* :mod:`entries` — thread-entry inference (``Thread(target=…)``,
  ``Thread`` subclasses, executor ``submit``/``map`` incl. parameter
  spawners like ``utils.fanout.bounded_map``, ``router.add``-registered
  HTTP handlers, ``signal.signal`` handlers), each rooting a reachability
  domain;
* :mod:`rules` — the graph-powered rules TNC111 (transitive blocking on
  read paths), TNC112 (cross-file lock-set races), TNC113 (snapshot
  escape), registered beside the per-file tripwires they upgrade.

The graph covers ``tpu_node_checker_torch/`` package files only: tests and
bench poke internals deliberately, and embedded ``*_SCRIPT`` virtual
files run in separate processes, so neither may merge thread domains
with the package's own.
"""

from tpu_node_checker_torch.analysis.flow.graph import (  # noqa: F401
    CallGraph,
    build_graph,
)
from tpu_node_checker_torch.analysis.flow.entries import (  # noqa: F401
    ThreadEntry,
    infer_entries,
)

__all__ = ["CallGraph", "ThreadEntry", "build_graph", "infer_entries"]
