"""Phase timing of the one-shot round.

The round times its phases (node list, detection, probe, history, render)
and surfaces them under ``--debug``, in the ``--json`` payload's
``timings_ms`` and, with ``--trace FILE``, as a Chrome-trace timeline.
``PhaseTimer`` is the name the round uses for
:class:`tpu_node_checker_torch.obs.trace.Tracer`, as in the JAX package's
``utils/timing.py``.
"""

from __future__ import annotations

from tpu_node_checker_torch.obs.trace import Tracer


class PhaseTimer(Tracer):
    """Collects named phase durations; cheap enough to always be on."""


__all__ = ["PhaseTimer", "Tracer"]
