"""Round tracing of the fleet round (``obs/trace.py``)."""
