"""The host clock of a process's own start."""

from __future__ import annotations

import os


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms resolution)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0
