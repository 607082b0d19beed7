"""Shared utilities of the fleet round: quantity parsing, timing, ``.env``."""

from tpu_node_checker_torch.utils.quantity import parse_quantity
from tpu_node_checker_torch.utils.timing import PhaseTimer, Tracer

__all__ = ["parse_quantity", "PhaseTimer", "Tracer"]
