"""The unified structured event log: one JSONL line per operational event.

A copy of the JAX package's ``obs/events.py``.  The watch loop's breaker
open/close and FSM actionable transitions are each one JSON line::

    {"event": "breaker-opened", "ts": 1754206000.123,
     "cluster": "us-central2-a", "trace_id": "9f2c01ab00000007", ...}

``cluster`` rides on every line when the checker has an explicit identity
(``--cluster-name`` or ``$TNC_CLUSTER_NAME``); ``trace_id`` joins the event
to the round that produced it.  Lines always go to stderr and, under
``--event-log FILE``, are appended to that file, which reads back through
the ``--trend`` log's torn-line-tolerant loader.  A failed write degrades
the log to stderr and never takes the round down.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import List, Optional, Tuple


class EventLog:
    """Thread-safe JSONL event writer; see the module docstring.

    ``stream=None`` resolves ``sys.stderr`` per emit so pytest's capture
    (and stream redirection generally) is honored.
    """

    def __init__(self, path: Optional[str] = None,
                 cluster: Optional[str] = None, stream=None):
        self.path = path
        self.cluster = cluster
        self._stream = stream
        self._lock = threading.Lock()
        self._write_failed = False

    def emit(self, event: str, trace_id: Optional[str] = None,
             **fields) -> dict:
        """One event → one JSON line (returned for callers that embed it).

        ``None``-valued fields are dropped so absent context (no trace on
        a standalone server, say) never serializes as ``null`` noise.
        """
        entry = {"event": event, "ts": round(time.time(), 3)}
        if self.cluster:
            entry["cluster"] = self.cluster
        if trace_id:
            entry["trace_id"] = trace_id
        for key, value in fields.items():
            if value is not None:
                entry[key] = value
        line = json.dumps(entry, ensure_ascii=False)
        print(line, file=self._stream or sys.stderr)
        if self.path:
            try:
                # Append-per-emit (events are rare): survives rotation,
                # keeps lines whole under the OS's O_APPEND atomicity for
                # small writes; the lock serializes emitting threads.
                with self._lock:
                    with open(self.path, "a", encoding="utf-8") as f:
                        f.write(line + "\n")
                self._write_failed = False
            except OSError as exc:
                if not self._write_failed:  # one note per outage, not per event
                    print(
                        f"event log {self.path} unwritable ({exc}) — "
                        "events continue on stderr only.",
                        file=sys.stderr,
                    )
                self._write_failed = True
        return entry

    @staticmethod
    def load(path: str) -> Tuple[List[dict], int]:
        """Read an event-log file back: ``(events, skipped_lines)`` via the
        SAME torn-line-tolerant loader the ``--trend`` log uses — one
        parser for every JSONL surface in the tree."""
        from tpu_node_checker_torch.history.store import read_jsonl_tolerant

        return read_jsonl_tolerant(path)
