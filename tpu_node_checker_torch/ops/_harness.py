"""Shared scaffold for the probes.

Every kernel cross-check probe follows one shape: resolve the target device,
then warm up once (the first launch also builds the kernel), then time a
second run with a synchronise plus a scalar fetch as the completion barrier.
The probes whose figure is graded (the burn, int8, the HBM stream) time
their chain with :func:`chain_clock`: on the card one CUDA graph, replayed
between two CUDA events (:func:`card_graph`), on the CPU the chain run
eagerly on the host clock.  Kept here so the probes cannot drift apart on
the device or timing rules.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Optional, Tuple, Union

import torch

from tpu_node_checker_torch.probe import spans

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The probe device: ``cuda:0`` unless the caller names another.

    ``cpu`` runs only when asked for.  A CUDA device that is asked for (or
    defaulted to) and absent raises: a probe must never grade a host healthy
    on the CPU because its card is gone.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA device {dev} requested but torch.cuda.is_available() is "
                "False (no NVIDIA card visible to this process)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported probe device {dev}: expected cuda or cpu")
    return dev


def is_cpu(device: DeviceLike) -> bool:
    """Whether the caller asked for the CPU (the plain versions run there)."""
    return device is not None and str(device).split(":")[0] == "cpu"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(fn, *args) -> Tuple[torch.Tensor, float, float]:
    """(output, checksum, steady-state ms) for ``fn(*args)``.

    The first call warms up (and builds the kernel); the timed second call
    ends in ``torch.cuda.synchronize()`` plus a scalar ``.item()``, so the
    clock stops only when the work is done.
    """
    out = fn(*args)
    sync(out.device)
    checksum = float(out.float().sum().item())
    t0 = time.perf_counter()
    out = fn(*args)
    sync(out.device)
    checksum = float(out.float().sum().item())
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    return out, checksum, elapsed_ms


class _KeptMemory:
    """What :func:`card_graph` keeps for the life of the process: one
    capture side stream per device, and the graph memory pools of each
    device and label.

    torch refuses a capture into a pool once every graph captured into it
    is gone (its count of users has fallen to 0, in the device's caching
    allocator and the host's).  So each pool is kept beside the last graph
    captured into it, and a weak reference to that graph's replay
    function.  The pool is free once the caller has dropped the replay: the
    kept graph is then never replayed again, and its blocks may go to the
    next capture.
    """

    def __init__(self):
        self.streams: dict = {}
        self.pools: dict = {}

    def stream(self, device: torch.device):
        side = self.streams.get(device)
        if side is None:
            side = self.streams[device] = torch.cuda.Stream(device)
        return side

    def free_pool(self, device: torch.device, label: str) -> Optional[list]:
        """The first ``[pool, graph, replay ref]`` of ``(device, label)``
        whose replay is gone, or None."""
        for entry in self.pools.get((device, label), ()):
            if entry[2]() is None:
                return entry
        return None

    def keep(self, device: torch.device, label: str, entry: Optional[list], pool, graph,
             replay) -> None:
        """Keep ``pool`` with the graph just captured into it (in place of
        the one before, in ``entry``)."""
        if entry is None:
            self.pools.setdefault((device, label), []).append([pool, graph, weakref.ref(replay)])
        else:
            entry[1:] = [graph, weakref.ref(replay)]


_KEPT = _KeptMemory()


def card_graph(
    fn: Callable[[], torch.Tensor], warm: Callable[[], object], device: torch.device,
    label: str = "graph",
) -> Callable[[], Tuple[torch.Tensor, float]]:
    """``fn`` captured once as a CUDA graph on ``device``; returns a function
    that replays it between two CUDA events and gives (the graph's output,
    device seconds).

    ``warm`` runs first on the side stream, as capture requires: the
    libraries' handles and workspaces are created outside the capture.  The
    output tensor is the graph's own, rewritten by every replay.  Timed on
    the card, the figure is the chain's, not the host's: a host that stalls
    while it issues work does not read as a slow card.

    The capture keeps its memory (:class:`_KeptMemory`): the warm-up and the
    capture run on one side stream kept for the device, and the capture
    allocates into a graph memory pool kept for the device and ``label``,
    so a second capture of a label reuses the blocks the first one mapped.
    Unlike ``torch.cuda.graph``, nothing here synchronises every stream or
    empties the allocator's caches.  A pool is reused only when the replay
    of every graph captured into it has been dropped; otherwise the capture
    gets a fresh pool, kept too.  A graph that can still be replayed would
    overwrite whatever a later capture had placed in its blocks.  Each
    replay ends in a synchronise, so a dropped graph has no work left on
    the card.

    The round's spans (:mod:`tpu_node_checker_torch.probe.spans`):
    ``graph.capture.<label>`` (the warm-up and the capture) and
    ``graph.launch.<label>`` (the host's time in ``graph.replay()``), with
    the counters ``graph_captures``, ``graph_pool_reuses`` (the captures
    into a kept pool) and ``graph_replays``.
    """
    launch = f"graph.launch.{label}"
    with spans.span(f"graph.capture.{label}"):
        current = torch.cuda.current_stream(device)
        side = _KEPT.stream(device)
        entry = _KEPT.free_pool(device, label)
        pool = torch.cuda.graph_pool_handle() if entry is None else entry[0]
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        current.wait_stream(side)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay() -> Tuple[torch.Tensor, float]:
        start.record()
        with spans.span(launch):
            graph.replay()
        end.record()
        spans.count("graph_replays")
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    _KEPT.keep(device, label, entry, pool, graph, replay)
    spans.count("graph_captures")
    if entry is not None:
        spans.count("graph_pool_reuses")
    return replay


def chain_clock(
    fn: Callable[[], torch.Tensor], warm: Callable[[], object], device: torch.device, label: str,
) -> Callable[[], Tuple[torch.Tensor, float]]:
    """A function that runs the chain ``fn`` once and gives (its output,
    seconds); the caller's first run is its warm-up.

    On a CUDA device it is :func:`card_graph` (``warm`` runs before the
    capture).  On the CPU nothing is captured and ``warm`` is not needed:
    each run calls ``fn()`` on the host clock, the window closed by a
    synchronise and one scalar fetch of the output.
    """
    if device.type == "cuda":
        return card_graph(fn, warm, device, label)

    def run_eager() -> Tuple[torch.Tensor, float]:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        out.reshape(-1)[0].item()
        return out, time.perf_counter() - t0
    return run_eager
