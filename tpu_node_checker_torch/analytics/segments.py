"""The analytics storage layer: sharded segment files of time-bucketed
roll-ups over the per-node health stream.

A copy of the JAX package's ``analytics/segments.py``, held equal to it by
``tests/test_torch_copies.py``.  One JSONL line per closed bucket per node
per resolution (1m, 15m, 6h), with verdict counters, FSM dwell, repair
times and sketches; nodes are sharded across segment files by a
:class:`~tpu_node_checker_torch.federation.endpoints.HashRing`, appended
through one gated entry (:func:`append_bucket`) and compacted in place.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from tpu_node_checker_torch.analytics.sketch import (
    Sketch,
    sketch_from_state,
    sketch_state,
)
from tpu_node_checker_torch.federation.endpoints import HashRing
from tpu_node_checker_torch.history.store import read_jsonl_tolerant

# Major version of the roll-up line contract (the history store's rule:
# readers refuse lines from majors they do not speak).
ROLLUP_SCHEMA_VERSION = 1

# Reserved stream prefix: node names never start with "_" (Kubernetes
# object names are DNS labels), so "_"-prefixed streams carry fleet-wide
# sample distributions through the same bucket machinery without ever
# appearing in node-level SLO views.
RESERVED_STREAM_PREFIX = "_"

# The fleet-wide duration stream (round wall-clock, mesh link p50s).
FLEET_STREAM = "_fleet"

# Downsampling ladder: 1m buckets answer "is it flapping NOW", 15m the
# operational dashboards, 6h the week-scale SLO reports.
RESOLUTIONS = (60, 900, 21600)

# Closed buckets kept per (node, resolution): ~2h of 1m, ~1d of 15m, ~2wk
# of 6h — enough for every query surface, bounded so a year-old fleet's
# segment files stay O(fleet), not O(history).
RETENTION_BUCKETS = {60: 120, 900: 96, 21600: 56}

DEFAULT_SHARDS = 8


def bucket_start(ts: float, res: int) -> int:
    return int(ts // res) * res


def stamp_bucket(record: dict) -> dict:
    """Stamp the roll-up schema major onto one bucket record — the proof
    (checked by TNC021) that a write went through the gate."""
    return {"schema": ROLLUP_SCHEMA_VERSION, **record}


# -- the raw segment I/O primitives (TNC021: only this module calls them) --


def rollup_append_lines(path: str, lines: List[str]) -> None:
    """Append pre-serialized roll-up lines to a segment file.  Never
    raises: a full disk costs this flush's persistence, not the round
    (the history store's contract)."""
    try:
        with open(path, "a", encoding="utf-8") as f:
            for line in lines:
                f.write(line + "\n")
    except OSError as exc:
        print(f"Cannot append analytics segment {path}: {exc}",
              file=sys.stderr)


def rollup_replace_file(path: str, lines: List[str]) -> None:
    """Atomically rewrite a segment file (tmp + rename).  Raises OSError:
    compaction callers decide whether a failed rewrite is fatal (it is
    not — the un-compacted file is still a correct, merely fat, store)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")
    os.replace(tmp, path)


def append_bucket(path: str, records: List[dict]) -> int:
    """THE write gate: schema-stamp and append closed-bucket records.

    Returns the number of lines written.  Every roll-up byte on disk went
    through here (or through compaction's schema-checked rewrite) —
    tnc-lint TNC021 holds every other call site to it.
    """
    lines = [
        json.dumps(stamp_bucket(r), ensure_ascii=False) for r in records
    ]
    rollup_append_lines(path, lines)
    return len(lines)


class _OpenBucket:
    """One still-filling (node, res, bucket) accumulator."""

    __slots__ = ("n", "ok", "flips", "onsets", "repairs", "repair_s",
                 "dwell", "first_ts", "last_ts", "last_ok", "sketches")

    def __init__(self):
        self.n = 0
        self.ok = 0
        self.flips = 0
        self.onsets = 0
        self.repairs = 0
        self.repair_s = 0.0
        self.dwell: Dict[str, int] = {}
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None
        self.last_ok: Optional[bool] = None
        # metric name -> mergeable percentile Sketch (DESIGN.md §23).
        self.sketches: Dict[str, Sketch] = {}


class SegmentStore:
    """The partitioned roll-up store; see the module docstring.

    Life cycle per round: :meth:`observe` once per evidence verdict →
    :meth:`flush` (closes buckets whose window has passed, appends them
    to their shard segments, compacts shards that outgrew their live
    set).  :meth:`load` rebuilds the closed-bucket view and the running
    per-node aggregates from the segment files on restart.
    """

    def __init__(self, dirpath: str, shards: int = DEFAULT_SHARDS):
        self.dirpath = dirpath
        self.shards = max(1, int(shards))
        self._ring = HashRing(range(self.shards))
        # Closed buckets: (node, res, bucket_ts) -> record dict.
        self.buckets: Dict[Tuple[str, int, int], dict] = {}
        # Open buckets: same key -> accumulator (memory only).
        self._open: Dict[Tuple[str, int, int], _OpenBucket] = {}
        # Running per-node fold over EVERYTHING observed or loaded — the
        # O(nodes) aggregate the SLO queries read instead of replaying
        # buckets (let alone raw history).
        self.node_stats: Dict[str, dict] = {}
        # Per-node labels (cluster/slice/topology), stamped into buckets.
        self.node_groups: Dict[str, dict] = {}
        # Failure-in-progress tracker for MTTR math (onset ts per node).
        self._failing_since: Dict[str, float] = {}
        self.skipped_lines = 0
        self.refused_lines = 0
        self.rollup_lines_total = 0  # lifetime appended lines (counter)
        self.compactions_total = 0
        self._shard_lines: Dict[int, int] = {}  # physical lines per shard
        # Lifetime samples folded into percentile sketches, by metric —
        # the tpu_node_checker_analytics_sketch_samples_total family.
        self.sketch_samples_total: Dict[str, int] = {}

    # -- paths ---------------------------------------------------------------

    def shard_of(self, node: str) -> int:
        return self._ring.assign(node)

    def segment_path(self, shard: int) -> str:
        return os.path.join(self.dirpath, f"shard-{shard:02d}.seg.jsonl")

    # -- load ----------------------------------------------------------------

    def load(self) -> None:
        """Read every shard's segment file back into the closed-bucket
        view and refold the per-node aggregates.  Duplicate (node, res,
        bucket) lines — a crash between append and compaction replayed —
        resolve LAST-LINE-WINS; unreadable shards degrade to empty with a
        stderr note (analytics is an enhancement, never a round-sinker)."""
        os.makedirs(self.dirpath, exist_ok=True)
        self.buckets = {}
        self.node_stats = {}
        self.node_groups = {}
        self.skipped_lines = 0
        self.refused_lines = 0
        self._shard_lines = {}
        for shard in range(self.shards):
            path = self.segment_path(shard)
            try:
                entries, skipped = read_jsonl_tolerant(path)
            except FileNotFoundError:
                continue
            except OSError as exc:
                print(f"Cannot read analytics segment {path}: {exc}",
                      file=sys.stderr)
                continue
            self.skipped_lines += skipped
            self._shard_lines[shard] = len(entries) + skipped
            for e in entries:
                schema = e.get("schema")
                if schema is not None and schema != ROLLUP_SCHEMA_VERSION:
                    self.refused_lines += 1
                    continue
                node, res, bucket = e.get("node"), e.get("res"), e.get("bucket")
                if (not isinstance(node, str) or not node
                        or res not in RESOLUTIONS
                        or not isinstance(bucket, int)):
                    self.skipped_lines += 1
                    continue
                self.buckets[(node, res, bucket)] = e
                group = {
                    k: e[k] for k in ("cluster", "slice", "topology")
                    if isinstance(e.get(k), str)
                }
                if group:
                    self.node_groups.setdefault(node, group)
        self._apply_retention()
        self._reconstruct_coarse_windows()
        self._refold_node_stats()

    def _apply_retention(self) -> None:
        by_node_res: Dict[Tuple[str, int], List[int]] = {}
        for (node, res, bucket) in self.buckets:
            by_node_res.setdefault((node, res), []).append(bucket)
        for (node, res), starts in by_node_res.items():
            keep = RETENTION_BUCKETS[res]
            if len(starts) <= keep:
                continue
            for bucket in sorted(starts)[:-keep]:
                del self.buckets[(node, res, bucket)]

    def _merge_records(self, recs: List[dict]) -> _OpenBucket:
        """Fold several finer-bucket records into one accumulator (all
        counters are additive; first/last ride min/max; last_ok follows
        the newest last_ts; sketches merge bucket-wise — exactly
        associative, so the reconstruction order cannot matter)."""
        b = _OpenBucket()
        for e in sorted(recs, key=lambda r: r.get("first_ts") or 0):
            sk = e.get("sk")
            if isinstance(sk, dict):
                for metric, doc in sk.items():
                    loaded = sketch_from_state(doc)
                    if loaded is None:
                        continue
                    existing = b.sketches.get(metric)
                    if existing is None:
                        b.sketches[metric] = loaded
                    elif existing.alpha == loaded.alpha:
                        existing.merge(loaded)
            b.n += int(e.get("n") or 0)
            b.ok += int(e.get("ok") or 0)
            b.flips += int(e.get("flips") or 0)
            b.onsets += int(e.get("onsets") or 0)
            b.repairs += int(e.get("repairs") or 0)
            b.repair_s += float(e.get("repair_s") or 0.0)
            for state, count in (e.get("dwell") or {}).items():
                if isinstance(count, int):
                    b.dwell[state] = b.dwell.get(state, 0) + count
            ts = e.get("first_ts")
            if isinstance(ts, (int, float)) and (
                b.first_ts is None or ts < b.first_ts
            ):
                b.first_ts = float(ts)
            ts = e.get("last_ts")
            if isinstance(ts, (int, float)) and (
                b.last_ts is None or ts >= b.last_ts
            ):
                b.last_ts = float(ts)
                if isinstance(e.get("last_ok"), bool):
                    b.last_ok = e["last_ok"]
        return b

    def _reconstruct_coarse_windows(self) -> None:
        """Heal coarse windows on load, level by level (fine → coarse).

        A restart kills every OPEN accumulator, so a coarse bucket whose
        window straddled the restart would otherwise close later holding
        only post-restart counts — and the coarse-first refold stitch
        would then mask the pre-restart data still sitting in finer
        closed buckets (they close fast, so they made it to disk).  For
        every coarse window the next-finer level has data for:

        * no coarse record on disk → rebuild the OPEN accumulator from
          the finer records, so the window closes complete when its time
          comes (or immediately at the next flush if it already passed);
        * a coarse record EXISTS but counts fewer rounds than the finer
          data in its window → it closed partial after an earlier
          restart: replace it in memory (the next compaction rewrites
          the healed line to disk).
        """
        for level, coarse in enumerate(RESOLUTIONS[1:], start=1):
            finer = RESOLUTIONS[level - 1]
            grouped: Dict[Tuple[str, int], List[dict]] = {}
            for (node, res, bucket), e in self.buckets.items():
                if res == finer:
                    grouped.setdefault(
                        (node, bucket_start(bucket, coarse)), []
                    ).append(e)
            for key, b in self._open.items():
                if key[1] == finer:
                    grouped.setdefault(
                        (key[0], bucket_start(key[2], coarse)), []
                    ).append(self._bucket_record(key, b))
            healed_shards: set = set()
            for (node, window), recs in sorted(grouped.items()):
                merged = self._merge_records(recs)
                existing = self.buckets.get((node, coarse, window))
                if existing is None:
                    self._open[(node, coarse, window)] = merged
                elif int(existing.get("n") or 0) < merged.n:
                    self.buckets[(node, coarse, window)] = (
                        self._bucket_record((node, coarse, window), merged)
                    )
                    healed_shards.add(self.shard_of(node))
            for shard in sorted(healed_shards):
                # Make the heal durable NOW: the finer evidence it was
                # rebuilt from ages out of retention before the partial
                # line would otherwise be compacted away.
                self.compact_shard(shard)

    def _refold_node_stats(self) -> None:
        """Rebuild the per-node running aggregates by STITCHING the
        resolutions, coarse to fine — over the post-reconstruction view,
        so every coarse bucket taken is complete-as-known.

        Every verdict folds into all three resolutions, but each
        resolution closes (and is retained) on its own cadence: the 6h
        buckets reach ~2 weeks back while the 1m retention covers ~2
        hours.  A refold from the finest alone would collapse a restart
        to the 2-hour window; a naive union would triple-count.  Bucket
        boundaries NEST (60 | 900 | 21600), so the exact stitch is: take
        each coarser resolution's buckets (closed + reconstructed-open),
        then the next-finer resolution's buckets from where the coarser
        coverage ENDS.  A node still failing at the stitched tail
        reseeds the repair clock at its last observed ts: an in-flight
        repair is measured from the restart boundary (a slight
        undercount), never double-counted as a fresh onset."""
        self.node_stats = {}
        by_node_res: Dict[Tuple[str, int], List[Tuple[int, dict]]] = {}
        for (node, res, bucket), e in self.buckets.items():
            by_node_res.setdefault((node, res), []).append((bucket, e))
        for key, b in self._open.items():
            # Reconstructed coarse accumulators carry data whose coarse
            # record never closed; the stitch treats them like closed
            # buckets (they WERE rebuilt from closed finer records).
            node, res, bucket = key
            by_node_res.setdefault((node, res), []).append(
                (bucket, self._bucket_record(key, b))
            )
        for node in sorted({node for node, _res in by_node_res}):
            covered_until = None  # exclusive end of coverage taken so far
            stitched: List[Tuple[int, dict]] = []
            for res in sorted(RESOLUTIONS, reverse=True):
                for bucket, e in sorted(by_node_res.get((node, res), ())):
                    if covered_until is not None and bucket < covered_until:
                        continue  # a coarser bucket already counted it
                    stitched.append((bucket, e))
                    covered_until = max(covered_until or 0, bucket + res)
            for _bucket, e in sorted(stitched):
                self._fold_into_stats(node, e)
            s = self.node_stats.get(node)
            if s and s["last_ok"] is False and s["last_ts"] is not None:
                self._failing_since.setdefault(node, s["last_ts"])

    @staticmethod
    def _fresh_stats() -> dict:
        return {
            "n": 0, "ok": 0, "flips": 0, "onsets": 0, "repairs": 0,
            "repair_s": 0.0, "first_ts": None, "last_ts": None,
            "last_ok": None, "sketches": {},
        }

    def _fold_into_stats(self, node: str, rec: dict) -> None:
        s = self.node_stats.setdefault(node, self._fresh_stats())
        sk = rec.get("sk")
        if isinstance(sk, dict):
            for metric, doc in sk.items():
                loaded = sketch_from_state(doc)
                if loaded is None:
                    continue
                existing = s["sketches"].get(metric)
                if existing is None:
                    s["sketches"][metric] = loaded
                elif existing.alpha == loaded.alpha:
                    existing.merge(loaded)
        s["n"] += int(rec.get("n") or 0)
        s["ok"] += int(rec.get("ok") or 0)
        s["flips"] += int(rec.get("flips") or 0)
        s["onsets"] += int(rec.get("onsets") or 0)
        s["repairs"] += int(rec.get("repairs") or 0)
        s["repair_s"] += float(rec.get("repair_s") or 0.0)
        ts = rec.get("first_ts")
        if isinstance(ts, (int, float)):
            if s["first_ts"] is None or ts < s["first_ts"]:
                s["first_ts"] = float(ts)
        ts = rec.get("last_ts")
        if isinstance(ts, (int, float)):
            if s["last_ts"] is None or ts >= s["last_ts"]:
                s["last_ts"] = float(ts)
                if isinstance(rec.get("last_ok"), bool):
                    s["last_ok"] = rec["last_ok"]

    # -- ingest --------------------------------------------------------------

    def observe(self, node: str, ts: float, ok: bool, state: str,
                flipped: bool, group: Optional[dict] = None) -> None:
        """Fold one evidence verdict into every resolution's open bucket
        and the running per-node aggregate."""
        if group:
            self.node_groups[node] = {
                k: v for k, v in group.items() if isinstance(v, str) and v
            }
        onset = repair_s = None
        if not ok and node not in self._failing_since:
            self._failing_since[node] = ts
            onset = ts
        elif ok and node in self._failing_since:
            repair_s = max(0.0, ts - self._failing_since.pop(node))
        # Latency-shaped samples this verdict yields: a completed repair's
        # duration, and — while a failure is in flight — its current age
        # (the repair-age distribution a pager duty dashboard percentiles).
        samples: Dict[str, List[float]] = {}
        if repair_s is not None:
            samples["mttr_s"] = [repair_s]
        if not ok:
            samples["repair_age_s"] = [max(0.0, ts - self._failing_since[node])]
        for res in RESOLUTIONS:
            key = (node, res, bucket_start(ts, res))
            b = self._open.get(key)
            if b is None:
                b = self._open[key] = _OpenBucket()
            b.n += 1
            b.ok += 1 if ok else 0
            b.flips += 1 if flipped else 0
            b.onsets += 1 if onset is not None else 0
            if repair_s is not None:
                b.repairs += 1
                b.repair_s += repair_s
            b.dwell[state] = b.dwell.get(state, 0) + 1
            if b.first_ts is None:
                b.first_ts = ts
            b.last_ts = ts
            b.last_ok = ok
            self._sketch_into(b.sketches, samples)
        # The running fold sees the verdict once, at the finest grain.
        self._fold_into_stats(node, {
            "n": 1, "ok": 1 if ok else 0, "flips": 1 if flipped else 0,
            "onsets": 1 if onset is not None else 0,
            "repairs": 1 if repair_s is not None else 0,
            "repair_s": repair_s or 0.0,
            "first_ts": ts, "last_ts": ts, "last_ok": ok,
        })
        stats = self.node_stats[node]
        self._sketch_into(stats["sketches"], samples)
        for metric, values in samples.items():
            self.sketch_samples_total[metric] = (
                self.sketch_samples_total.get(metric, 0) + len(values)
            )

    def observe_samples(self, node: str, ts: float,
                        samples: Dict[str, List[float]]) -> None:
        """Fold latency samples (no verdict) into ``node``'s open-bucket
        and running sketches — the fleet streams' entry point
        (``observe_samples(FLEET_STREAM, now, {"round_ms": [ms]})``).
        Buckets created here carry ``n=0``: they hold distribution data,
        not rounds, and the SLO counters ignore them."""
        samples = {
            metric: [float(v) for v in values]
            for metric, values in samples.items() if values
        }
        if not samples:
            return
        for res in RESOLUTIONS:
            key = (node, res, bucket_start(ts, res))
            b = self._open.get(key)
            if b is None:
                b = self._open[key] = _OpenBucket()
            if b.first_ts is None:
                b.first_ts = ts
            b.last_ts = ts
            self._sketch_into(b.sketches, samples)
        s = self.node_stats.setdefault(node, self._fresh_stats())
        if s["first_ts"] is None or ts < s["first_ts"]:
            s["first_ts"] = ts
        if s["last_ts"] is None or ts >= s["last_ts"]:
            s["last_ts"] = ts
        self._sketch_into(s["sketches"], samples)
        for metric, values in samples.items():
            self.sketch_samples_total[metric] = (
                self.sketch_samples_total.get(metric, 0) + len(values)
            )

    @staticmethod
    def _sketch_into(sketches: Dict[str, Sketch],
                     samples: Dict[str, List[float]]) -> None:
        for metric, values in samples.items():
            sk = sketches.get(metric)
            if sk is None:
                sk = sketches[metric] = Sketch()
            sk.extend(values)

    # -- flush / compaction --------------------------------------------------

    def _bucket_record(self, key: Tuple[str, int, int],
                       b: _OpenBucket) -> dict:
        node, res, bucket = key
        rec = {
            "node": node, "res": res, "bucket": bucket,
            "n": b.n, "ok": b.ok, "flips": b.flips, "onsets": b.onsets,
            "repairs": b.repairs, "repair_s": round(b.repair_s, 3),
            "dwell": dict(sorted(b.dwell.items())),
            "first_ts": round(b.first_ts, 3) if b.first_ts is not None else None,
            "last_ts": round(b.last_ts, 3) if b.last_ts is not None else None,
            "last_ok": b.last_ok,
        }
        if b.sketches:
            # Sketch persistence rides the same schema-stamped line as
            # the counters; absent when empty so sketch-less deployments
            # keep their exact pre-sketch bytes.
            rec["sk"] = {
                metric: sketch_state(sk)
                for metric, sk in sorted(b.sketches.items())
            }
        rec.update(self.node_groups.get(node, {}))
        return rec

    def flush(self, now: float) -> None:
        """Close every open bucket whose window has fully passed, append
        the closed records to their shard segments, then compact shards
        whose files have outgrown their live bucket set."""
        closed: Dict[int, List[dict]] = {}
        for key in sorted(self._open):
            node, res, bucket = key
            if bucket + res > now:
                continue  # still filling
            rec = self._bucket_record(key, self._open.pop(key))
            self.buckets[key] = dict(rec)
            closed.setdefault(self.shard_of(node), []).append(rec)
        for shard, records in sorted(closed.items()):
            written = append_bucket(self.segment_path(shard), records)
            self.rollup_lines_total += written
            self._shard_lines[shard] = (
                self._shard_lines.get(shard, 0) + written
            )
        if closed:
            self._apply_retention()
            self._maybe_compact()

    def _maybe_compact(self) -> None:
        live: Dict[int, int] = {}
        for (node, _res, _bucket) in self.buckets:
            shard = self.shard_of(node)
            live[shard] = live.get(shard, 0) + 1
        for shard, lines in sorted(self._shard_lines.items()):
            # Past 2× the live set (plus slack for tiny fleets) the file
            # is mostly dead weight: superseded duplicates and buckets
            # retention already dropped — the history store's rule.
            bound = max(256, 2 * live.get(shard, 0))
            if lines > bound:
                self.compact_shard(shard)

    def compact_shard(self, shard: int) -> None:
        """Rewrite one shard as exactly its live, current-major bucket
        lines, atomically.  A failed rewrite costs nothing but the
        compaction (the fat file is still correct)."""
        records = [
            stamp_bucket(self._bucket_record_from_closed(key))
            for key in sorted(self.buckets)
            if self.shard_of(key[0]) == shard
        ]
        lines = [json.dumps(r, ensure_ascii=False) for r in records]
        try:
            rollup_replace_file(self.segment_path(shard), lines)
        except OSError as exc:
            print(
                f"Analytics segment compaction failed for shard {shard}: "
                f"{exc} (store remains valid, merely uncompacted)",
                file=sys.stderr,
            )
            return
        self.compactions_total += 1
        self._shard_lines[shard] = len(lines)

    def _bucket_record_from_closed(self, key: Tuple[str, int, int]) -> dict:
        rec = dict(self.buckets[key])
        rec.pop("schema", None)
        return rec

    # -- views ---------------------------------------------------------------

    def bucket_counts(self) -> Dict[str, int]:
        counts = {res: 0 for res in RESOLUTIONS}
        for (_node, res, _bucket) in self.buckets:
            counts[res] += 1
        return {str(res): n for res, n in sorted(counts.items())}
