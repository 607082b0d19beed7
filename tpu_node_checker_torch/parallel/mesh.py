"""Rank groups and rank meshes: the counterpart of the JAX package's ``Mesh``.

The JAX package runs its fabric probes as one SPMD program over a
``jax.sharding.Mesh`` of the local chips.  Here the same probes run as one
process per card over ``torch.distributed``: a :class:`RankGroup` holds one
rank per local card, rank 0 in the calling process (the probe child) and
the others spawned with the ``spawn`` start method.

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

A :class:`RankMesh` lays named axes over the group's ranks, row-major over
rank order (card order): cards carry no torus coordinates and no slice
index, which is where the JAX package falls back to the same reshape.  Each
rank holds its coordinates and, for every axis, the process group of the
line through it along that axis.  :func:`build_mesh` is collective (every
rank creates every line's group, in one order) and caches the mesh, and
each line's group by its ranks, in the rank's process until the group
closes.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
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


def parse_topology(topology: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Parse a GKE topology label value like ``"2x2x1"`` or ``"16x16"``."""
    if not topology or not isinstance(topology, str):
        return None
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError:
        return None
    return dims if dims and all(d > 0 for d in dims) else None


def topology_chip_count(topology: Optional[str]) -> Optional[int]:
    """Total chips a topology describes: the product of its dimensions."""
    dims = parse_topology(topology)
    return None if dims is None else math.prod(dims)


def mesh_layout(spec: MeshSpec) -> np.ndarray:
    """The rank at each mesh position: row-major over rank order."""
    return np.arange(spec.device_count).reshape(spec.shape)


def topology_spec(topology: Optional[str], n_devices: int, axis_prefix: str = "t") -> MeshSpec:
    """The axes :func:`mesh_from_topology` lays over ``n_devices`` ranks:
    ``"2x4"`` gives t0=2, t1=4 when its product is the rank count, else one
    flat axis ``d`` (enumeration health is graded separately)."""
    dims = parse_topology(topology)
    if dims is not None and math.prod(dims) == n_devices:
        return MeshSpec(tuple((f"{axis_prefix}{i}", d) for i, d in enumerate(dims)))
    return MeshSpec((("d", n_devices),))


def hybrid_spec(
    n_devices: int,
    topology: Optional[str] = None,
    num_slices: Optional[int] = None,
    dcn_axis: str = "dcn",
    axis_prefix: str = "t",
) -> MeshSpec:
    """The axes :func:`hybrid_mesh` lays over ``n_devices`` ranks: a leading
    DCN axis over ``num_slices`` contiguous slices, then one slice's torus
    axes when ``topology`` describes one slice, else one flat ``d`` axis.

    Cards carry no slice index, so only the rehearsal partition
    (``TNC_CHAOS_SLICES``) forms slices; it raises, with the JAX package's
    messages, on fewer than 2 slices or an uneven split."""
    if num_slices is None:
        raise ValueError("devices carry no slice_index — not a multislice job")
    if num_slices < 2:
        raise ValueError(f"num_slices must be >= 2, got {num_slices}")
    if n_devices % num_slices:
        raise ValueError(
            f"{n_devices} devices do not partition into {num_slices} equal slices"
        )
    per_slice = n_devices // num_slices
    dims = parse_topology(topology)
    if dims is not None and topology_chip_count(topology) == per_slice:
        inner = tuple((f"{axis_prefix}{i}", d) for i, d in enumerate(dims))
    else:
        inner = (("d", per_slice),)
    return MeshSpec(((dcn_axis, num_slices),) + inner)


@dataclass(frozen=True, eq=False)
class RankMesh:
    """This rank's place in a mesh over the live process group.

    ``coords`` are its coordinates; ``groups[axis]`` is the process group of
    the line through it along ``axis`` and ``lines[axis]`` that line's
    global ranks, by coordinate along the axis."""

    spec: MeshSpec
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    lines: Dict[str, Tuple[int, ...]]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.spec.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.spec.shape

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __reduce__(self):
        # Process groups belong to their rank's process: a mesh sent to
        # another process (a rank's result) carries no groups.
        return (RankMesh, (self.spec, self.coords, {}, self.lines))


# Each rank's meshes, by axes, and its lines' process groups, by ranks: built
# once per process group, forgotten when it is destroyed, so a set of ranks
# costs one communicator however many meshes have a line over it.
_MESHES: Dict[tuple, RankMesh] = {}
_LINE_GROUPS: Dict[tuple, Any] = {}


def build_mesh(spec: MeshSpec) -> RankMesh:
    """This rank's :class:`RankMesh` for ``spec`` over the live group.

    Collective on first use: every rank creates the process group of every
    line of every axis, in one order, as NCCL requires.  A line that covers
    every rank uses the whole group, and a line over the same ranks as one
    of an earlier mesh reuses that line's group.  Raises when the rank
    count does not match the spec, and when a line's group fails to form
    (never falls back to a flatter mesh)."""
    cached = _MESHES.get(spec.axes)
    if cached is not None:
        return cached
    n, rank = dist.get_world_size(), dist.get_rank()
    if n != spec.device_count:
        raise ValueError(
            f"mesh spec {spec.axes} needs {spec.device_count} devices, got {n}"
        )
    layout = mesh_layout(spec)
    coords = tuple(int(c) for c in np.unravel_index(rank, spec.shape))
    groups, lines = {}, {}
    for a, name in enumerate(spec.axis_names):
        for line in np.moveaxis(layout, a, -1).reshape(-1, spec.shape[a]).tolist():
            if len(line) == n:
                group = dist.group.WORLD
            elif tuple(line) in _LINE_GROUPS:
                group = _LINE_GROUPS[tuple(line)]
            else:
                try:
                    group = dist.new_group(line)
                except Exception as exc:  # named, never a silent flat fallback
                    raise RuntimeError(
                        f"the process group of mesh axis {name!r} over ranks {line} "
                        f"failed to form: {type(exc).__name__}: {exc}"
                    ) from exc
                _LINE_GROUPS[tuple(line)] = group
            if rank in line:
                groups[name], lines[name] = group, tuple(line)
    mesh = RankMesh(spec=spec, coords=coords, groups=groups, lines=lines)
    _MESHES[spec.axes] = mesh
    return mesh


def flat_mesh(axis: str = "d") -> RankMesh:
    """Every rank on one axis named ``axis`` (the single-axis probes' ring)."""
    return build_mesh(MeshSpec(((axis, dist.get_world_size()),)))


def mesh_from_topology(topology: Optional[str], axis_prefix: str = "t") -> RankMesh:
    """The mesh shaped like a topology label over the live group
    (:func:`topology_spec`)."""
    return build_mesh(topology_spec(topology, dist.get_world_size(), axis_prefix))


def hybrid_mesh(
    topology: Optional[str] = None,
    num_slices: Optional[int] = None,
    dcn_axis: str = "dcn",
    axis_prefix: str = "t",
) -> RankMesh:
    """The DCN × per-slice mesh over the live group (:func:`hybrid_spec`)."""
    return build_mesh(
        hybrid_spec(dist.get_world_size(), topology, num_slices, dcn_axis, axis_prefix)
    )


def _forget_meshes() -> None:
    """Drop this process's meshes; their groups die with the default group."""
    _MESHES.clear()
    _LINE_GROUPS.clear()


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
        _forget_meshes()


class RankGroup:
    """One rank per device: rank 0 here, the rest spawned.

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
                _forget_meshes()
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
