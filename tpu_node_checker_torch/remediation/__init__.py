"""Remediation: what the watch loop needs of the JAX package's
``remediation/`` so far (:mod:`~tpu_node_checker_torch.remediation.budget`).
The budget engine, the actuators, drain, repair hooks and leases are not
ported yet."""
