"""Data-plane liveness probes for NVIDIA cards.

* :mod:`tpu_node_checker_torch.probe.liveness`: a subprocess-isolated child
  that initialises CUDA, enumerates the cards and, at the compute level, runs
  the compute probes of :mod:`tpu_node_checker_torch.ops`, under a hard
  timeout (CUDA initialisation can hang on a sick card, so it never runs in
  the caller's process);
* :mod:`.schema`, :mod:`.floors`, :mod:`.levels`: the report contract, the
  floor grading and the level budgets, copied from the JAX package.
"""

from tpu_node_checker_torch.probe.levels import LEVELS

__all__ = ["LEVELS", "ProbeResult", "run_local_probe"]


def __getattr__(name):
    # Lazy, as in the JAX package: the CLI needs LEVELS at argparse time only.
    if name in ("ProbeResult", "run_local_probe"):
        from tpu_node_checker_torch.probe import liveness

        return getattr(liveness, name)
    raise AttributeError(name)
