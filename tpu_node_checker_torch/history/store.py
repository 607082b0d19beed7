"""Durable per-node health history: schema-versioned, append-only JSONL.

One line per node per round::

    {"schema": 1, "node": "gke-tpu-0", "ts": 1700000000.0, "ok": false,
     "causes": ["probe-failed"], "state": "SUSPECT", "streak": 1,
     "flaps": 0, "flaps_total": 0}

Design rules, shared with the trend log and the emitter report path:

* **append-only** in steady state — each round costs one ``write()`` per
  node, no rewrite, so a crash mid-append can tear at most the final line;
* **torn-line tolerant on load** — a malformed trailing (or any) line is
  skipped and counted, never fatal (:func:`read_jsonl_tolerant` is the one
  loader; ``--trend`` reuses it so both surfaces degrade identically);
* **schema-versioned** — every line carries the major it was written
  under; lines from a future major are refused rather than misread
  (``schema`` absent = pre-versioning, accepted), mirroring the probe
  report contract (checker.REPORT_SCHEMA_VERSION);
* **bounded** — per-node history keeps the last ``--history-max-rounds``
  entries; when the file's total line count outgrows what the bound
  implies, it is compacted in place atomically (tmp + rename, like the
  emitter report write) so a reader never sees a half-rewritten store;
* **never fatal** — a full disk loses persistence for the round (with a
  stderr note), not the round itself; the in-memory state keeps driving
  this run's decisions.

A copy of the JAX package's ``history/store.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# Major version of the store's line contract.  Bump when a field changes
# meaning or type; readers refuse lines from majors they do not speak.
HISTORY_SCHEMA_VERSION = 1

# Per-node history bound (--history-max-rounds).  64 rounds at a 60 s watch
# interval is ~an hour of memory — enough for hysteresis thresholds and the
# flap window, small enough that load stays O(fleet) per round.
DEFAULT_MAX_ROUNDS = 64


def file_signature(path: str):
    """``(mtime_ns, size)`` change-detection signature; ``None`` when the
    file cannot be stat'ed.

    The cache key the fleet API's store/trend snapshots re-read on: a
    server process that does not own the file (the standalone ``--serve``
    mode, ``/api/v1/trend`` over a log another process appends) pays one
    ``stat`` per request and re-parses only when the signature moves —
    never per poll.
    """
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def read_jsonl_tolerant(path: str) -> Tuple[List[dict], int]:
    """Load a JSONL file, skipping blank and malformed lines.

    Returns ``(entries, skipped)``.  A torn final line (crash mid-append), a
    whitespace-only file, or garbage in the middle each cost exactly the
    lines they occupy — the rest of the file still loads.  Non-dict roots
    (a bare ``3`` is valid JSON) count as malformed: every consumer indexes
    by key.  Raises ``OSError`` when the file itself is unreadable; a
    *missing* file is the caller's empty-vs-error policy call.
    """
    entries: List[dict] = []
    skipped = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(entry, dict):
                skipped += 1
                continue
            entries.append(entry)
    return entries, skipped


# Tail bound the --trend CLI (and the fleet API's trend cache) read with:
# far past any test or bench log, so output stays byte-identical there,
# while a multi-GB runaway log costs O(bound) memory instead of O(file).
DEFAULT_TREND_TAIL_LINES = 500_000

# Backward block size for the tail scan: big enough that even long lines
# need few reads, small enough that a tiny tail never pays a large read.
_TAIL_BLOCK = 1 << 16


def read_jsonl_tail(
    path: str,
    max_lines: Optional[int] = None,
    start_offset: int = 0,
    consume_partial_tail: bool = True,
):
    """Bounded/resumable variant of :func:`read_jsonl_tolerant`.

    Returns ``(entries, skipped, end_offset)`` with the same tolerance
    rules, reading only what the caller asked for:

    * ``max_lines`` (with ``start_offset == 0``) — parse only the LAST
      ``max_lines`` lines, found by scanning backward from EOF in blocks:
      a multi-GB log costs O(tail), not O(file), in both I/O and RAM;
    * ``start_offset`` — resume a previous read: parse only bytes appended
      since ``end_offset`` was last returned.  A file that SHRANK below
      the offset was rewritten (compaction): the whole file is re-read;
    * ``consume_partial_tail=False`` — an unterminated final chunk (a
      writer mid-append) is left UNCONSUMED: ``end_offset`` stops after
      the last complete line, so the resumed read sees the finished line
      once, whole.  The default matches :func:`read_jsonl_tolerant`: the
      final chunk is parsed (and a torn one counted skipped).

    ``end_offset`` is the byte position the next resume should start from.
    Raises ``OSError`` exactly like the unbounded loader.
    """
    entries: List[dict] = []
    skipped = 0
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if start_offset > size:
            start_offset = 0  # rewritten underneath us: re-read from scratch
        offset = start_offset
        if max_lines is not None and max_lines >= 0 and start_offset == 0:
            # Backward block scan: stop once the window holds > max_lines
            # newlines (the extra one marks the boundary line's start).
            pos, newlines = size, 0
            while pos > 0 and newlines <= max_lines:
                step = min(_TAIL_BLOCK, pos)
                pos -= step
                f.seek(pos)
                newlines += f.read(step).count(b"\n")
            if newlines > max_lines:
                f.seek(pos)
                # Skip forward past (newlines - max_lines) line ends; the
                # remainder is exactly the last max_lines lines (plus any
                # unterminated tail chunk).
                for _ in range(newlines - max_lines):
                    buf = f.readline()
                    pos += len(buf)
            offset = pos
        f.seek(offset)
        while True:
            raw = f.readline()
            if not raw:
                break
            if not raw.endswith(b"\n") and not consume_partial_tail:
                break  # mid-append: leave it for the resumed read
            offset += len(raw)
            line = raw.decode("utf-8", errors="replace")
            if not line.strip():
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(entry, dict):
                skipped += 1
                continue
            entries.append(entry)
    return entries, skipped, offset


class HistoryStore:
    """Append-only JSONL health history keyed by node name.

    Life cycle per check round: :meth:`load` (tail-bounded per node) →
    caller runs the FSM and calls :meth:`record` once per node →
    :meth:`flush` appends the round's lines and compacts when the file has
    outgrown its bound.
    """

    def __init__(self, path: str, max_rounds: int = DEFAULT_MAX_ROUNDS):
        self.path = path
        self.max_rounds = max(1, int(max_rounds))
        self.by_node: Dict[str, List[dict]] = {}
        self.skipped_lines = 0
        self.refused_lines = 0  # future-major schema lines
        self._total_lines = 0  # lines physically in the file (incl. dead ones)
        self._pending: List[dict] = []

    def load(self) -> Dict[str, List[dict]]:
        """Read the store into per-node chronological tails.

        Unreadable file (beyond simply missing) degrades to an EMPTY store
        with a stderr note — history is an enhancement; losing it must not
        sink a monitoring round.  The FSM then reseeds from this round
        forward, the conservative direction (a node needs fresh evidence
        before any state-gated action).
        """
        self.by_node = {}
        self.skipped_lines = 0
        self.refused_lines = 0
        self._total_lines = 0
        try:
            entries, self.skipped_lines = read_jsonl_tolerant(self.path)
        except FileNotFoundError:
            return self.by_node  # first run: an empty store is the contract
        except OSError as exc:
            print(f"Cannot read history store {self.path}: {exc}", file=sys.stderr)
            return self.by_node
        self._total_lines = len(entries) + self.skipped_lines
        for entry in entries:
            schema = entry.get("schema")
            if schema is not None and schema != HISTORY_SCHEMA_VERSION:
                # Version skew (an old binary reading a future store during a
                # rollback): refuse what we cannot be sure to read correctly.
                self.refused_lines += 1
                continue
            node = entry.get("node")
            if not isinstance(node, str) or not node:
                self.skipped_lines += 1
                continue
            self.by_node.setdefault(node, []).append(entry)
        for node, tail in self.by_node.items():
            if len(tail) > self.max_rounds:
                self.by_node[node] = tail[-self.max_rounds:]
        if self.refused_lines:
            print(
                f"History store {self.path}: refused {self.refused_lines} "
                f"line(s) from a different schema major "
                f"(!= {HISTORY_SCHEMA_VERSION}) — version skew?",
                file=sys.stderr,
            )
        return self.by_node

    def record(self, entry: dict) -> None:
        """Queue one node-round line (stamped with the schema major) and
        fold it into the in-memory tail immediately, so this round's own
        decisions and the persisted record can never disagree."""
        entry = {"schema": HISTORY_SCHEMA_VERSION, **entry}
        self._pending.append(entry)
        tail = self.by_node.setdefault(entry["node"], [])
        tail.append(entry)
        if len(tail) > self.max_rounds:
            del tail[: len(tail) - self.max_rounds]

    def _compaction_due(self) -> bool:
        # The live tails imply at most nodes × max_rounds useful lines; past
        # 2× that (plus slack so tiny fleets don't compact every round) the
        # file is mostly dead weight from rounds the bound already dropped.
        bound = max(256, 2 * self.max_rounds * max(1, len(self.by_node)))
        return self._total_lines > bound

    def flush(self) -> None:
        """Append the round's queued lines; compact when the file has
        outgrown its bound.  Never raises — a full disk costs persistence,
        not the monitoring round (same policy as the trend log)."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        try:
            if self._compaction_due():
                self.compact()
                return  # compact() wrote the tails, pending included
            with open(self.path, "a", encoding="utf-8") as f:
                for entry in pending:
                    f.write(json.dumps(entry, ensure_ascii=False) + "\n")
            self._total_lines += len(pending)
        except OSError as exc:
            print(f"Cannot append history store {self.path}: {exc}", file=sys.stderr)

    def compact(self) -> None:
        """Rewrite the store as exactly the bounded per-node tails,
        atomically (tmp + rename): a concurrent reader — ``--trend-nodes``
        mid-watch — sees the old file or the new one, never a torn mix."""
        tmp = f"{self.path}.tmp"
        lines = 0
        with open(tmp, "w", encoding="utf-8") as f:
            for node in sorted(self.by_node):
                for entry in self.by_node[node]:
                    f.write(json.dumps(entry, ensure_ascii=False) + "\n")
                    lines += 1
        os.replace(tmp, self.path)
        self._total_lines = lines
