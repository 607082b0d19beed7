"""Rank groups: the counterpart of the JAX package's ``Mesh``.

The JAX package runs its fabric probes as one SPMD program over a
``jax.sharding.Mesh`` of the local chips.  Here the same probes run as one
process per card over ``torch.distributed``: a :class:`RankGroup` holds one
rank per local card, rank 0 in the calling process (the probe child) and
the others spawned with the ``spawn`` start method.  All ranks lie on one
flat axis, named ``d`` as the JAX package names its flat mesh axis.

* Rendezvous goes through a ``FileStore`` in a private temporary directory,
  never a fixed port, so groups on one host cannot collide.
* The backend is NCCL on the cards (each rank binds its card through
  ``device_id``) and gloo on the CPU.  Nothing falls back from one to the
  other.
* The group's timeout bounds every collective, so a hung collective fails
  with an error instead of holding the probe until its kill-timer.
* :meth:`RankGroup.run` runs one function on every rank and returns every
  rank's result; the probes replicate their verdicts with an
  ``all_reduce`` of mismatch counts, and :func:`fold` turns the per-rank
  results into rank 0's, demoted to a failure when another rank failed or
  disagreed.

The spawned ranks wait for commands in the store, so one group serves the
probe child's collective, mesh and workload blocks in turn and each rank
pays its interpreter start once.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

# How often a rank that waits in the store checks that its peer is alive: a
# spawned rank its parent, rank 0 each spawned rank.
_POLL_S = 1.0


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes and their sizes, e.g. (("data", 4), ("model", 2))."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(size for _, size in self.axes)

    @property
    def device_count(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n


@dataclass
class RankFailure:
    """What a rank returns in place of its result when its call raised."""

    ok: bool
    error: str


def local_device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fold(results: List[Any]):
    """Rank 0's result, demoted to a failure naming each other rank that
    failed or whose verdict differs from rank 0's.

    Every result carries ``ok`` and ``error``; the probes replicate their
    verdicts, so on a sound group all ranks agree."""
    first = results[0]
    bad = [
        f"rank {r}: {res.error or 'verdict differs from rank 0'}"
        for r, res in enumerate(results[1:], start=1)
        if isinstance(res, RankFailure) or res.ok != first.ok
    ]
    if not bad:
        return first
    return dataclasses.replace(
        first, ok=False, error="; ".join(([first.error] if first.error else []) + bad)
    )


def _init(path: str, rank: int, world_size: int, device_type: str, timeout_s: float):
    store = dist.FileStore(path, world_size)
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=store,
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        **kw,
    )
    return store


def _call(fn: Callable, args: tuple, kwargs: dict):
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # a rank reports its failure to rank 0, never dies silent
        traceback.print_exc()
        return RankFailure(ok=False, error=f"{type(exc).__name__}: {exc}")


def _wait(store, key: str, alive: Callable[[], bool], timeout_s: float) -> bool:
    """Wait for ``key``; False as soon as ``alive()`` says the process that
    would write it is gone.  Raises after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            store.wait([key], datetime.timedelta(seconds=_POLL_S))
            return True
        except RuntimeError as exc:  # a FileStore's timeout is a bare RuntimeError
            if "timeout" not in str(exc).lower():
                raise
            if not alive():
                return False
            if time.monotonic() > deadline:
                raise


def _rank_main(path: str, rank: int, world_size: int, device_type: str,
               timeout_s: float, parent_pid: int) -> None:
    """A spawned rank: run each command rank 0 posts, until told to stop."""
    store = _init(path, rank, world_size, device_type, timeout_s)
    try:
        seq = 0
        while True:
            seq += 1
            if not _wait(store, f"cmd/{seq}", lambda: os.getppid() == parent_pid, timeout_s):
                return
            cmd = pickle.loads(store.get(f"cmd/{seq}"))
            if cmd is None:
                return
            fn, args, kwargs = cmd
            store.set(f"res/{seq}/{rank}", pickle.dumps(_call(fn, args, kwargs)))
    finally:
        dist.destroy_process_group()


class RankGroup:
    """One rank per device on the flat axis: rank 0 here, the rest spawned.

    ``device_type`` is ``cuda`` (NCCL, rank r on card r) or ``cpu`` (gloo).
    Use as a context manager; :meth:`close` stops the spawned ranks and
    destroys the process group.
    """

    def __init__(self, world_size: int, device_type: str = "cuda", timeout_s: float = 300.0):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if device_type not in ("cuda", "cpu"):
            raise ValueError(f"device_type must be cuda or cpu, got {device_type!r}")
        if device_type == "cuda" and world_size > torch.cuda.device_count():
            raise ValueError(
                f"{world_size} ranks need {world_size} cards, "
                f"{torch.cuda.device_count()} visible"
            )
        self.world_size = world_size
        self.device_type = device_type
        self.timeout_s = timeout_s
        self._dir: Optional[str] = None
        self._store = None
        self._procs: list = []
        self._seq = 0

    def __enter__(self) -> "RankGroup":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> None:
        self._dir = tempfile.mkdtemp(prefix="tnc-ranks-")
        path = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        for rank in range(1, self.world_size):
            p = ctx.Process(
                target=_rank_main,
                args=(path, rank, self.world_size, self.device_type, self.timeout_s, os.getpid()),
                name=f"tnc-rank-{rank}",
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        self._store = _init(path, 0, self.world_size, self.device_type, self.timeout_s)

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; every rank's result, in
        rank order (a :class:`RankFailure` where the call raised).  ``fn``
        and its arguments must pickle: a module-level function."""
        self._seq += 1
        self._store.set(f"cmd/{self._seq}", pickle.dumps((fn, args, kwargs)))
        results = [_call(fn, args, kwargs)]
        for rank, proc in enumerate(self._procs, start=1):
            key = f"res/{self._seq}/{rank}"
            if _wait(self._store, key, proc.is_alive, self.timeout_s):
                results.append(pickle.loads(self._store.get(key)))
            else:
                results.append(RankFailure(
                    ok=False, error=f"rank {rank} exited with code {proc.exitcode}"))
        return results

    def close(self) -> None:
        try:
            if self._store is not None:
                self._store.set(f"cmd/{self._seq + 1}", pickle.dumps(None))
                dist.destroy_process_group()
                self._store = None
        finally:
            for p in self._procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            self._procs = []
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
                self._dir = None
