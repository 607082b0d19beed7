"""tpu-node-checker on PyTorch and CUDA, for NVIDIA Hopper cards.

A second package beside the JAX one (which stays the reference): the same
probe at every level, its report and its schema, with the three kernels the
JAX package writes in Pallas for the TPU written by hand in CUDA C++ for
``sm_90a`` (``ops/csrc/``); the node-side emitter and its pod's modes; and
the fleet round over the cluster's live node LIST or a NodeList file, once
or in the aggregator's ``--watch`` loop, with its quarantine, and the
federation tier above many clusters' checkers.  It imports
torch and nothing of JAX.

Entry point: ``python -m tpu_node_checker_torch`` (the round over the live
LIST, with ``--kubeconfig``, ``--label-selector``, ``--node-events``,
``--probe``, ``--probe-results``, ``--history``, Slack, ``--watch`` and the
quarantine's ``--cordon-failed``, ``--uncordon-recovered`` and budgets; or
over ``--nodes-json FILE``), ``--trend FILE``, ``--trend-nodes FILE``,
``--emit-probe FILE|-`` (once, or every ``--watch`` seconds as the emitter
DaemonSet runs it), ``--selftest``, ``--calibrate``, ``--report-fresh
FILE`` or ``--probe-report-schema``; the fleet state API (``--serve``), the
node watch stream (``--watch-stream``) and the federation aggregator over
many checkers (``--federate``).
"""

__all__ = ["__version__"]
__version__ = "0.1.0"
