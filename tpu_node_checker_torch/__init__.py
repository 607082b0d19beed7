"""tpu-node-checker's chip probe on PyTorch and CUDA, for NVIDIA Hopper cards.

A second package beside the JAX one (which stays the reference): the same
compute-level probe, its report and its schema, with the three kernels the
JAX package writes in Pallas for the TPU written by hand in CUDA C++ for
``sm_90a`` (``ops/csrc/``).  It imports torch and nothing of JAX.

Entry point: ``python -m tpu_node_checker_torch --emit-probe FILE|-``.
"""

__all__ = ["__version__"]
__version__ = "0.1.0"
