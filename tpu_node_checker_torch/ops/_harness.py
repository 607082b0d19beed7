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


def card_graph(
    fn: Callable[[], torch.Tensor], warm: Callable[[], object], device: torch.device,
    label: str = "graph",
) -> Callable[[], Tuple[torch.Tensor, float]]:
    """``fn`` captured once as a CUDA graph on ``device``; returns a function
    that replays it between two CUDA events and gives (the graph's output,
    device seconds).

    ``warm`` runs first on a side stream, as capture requires: the
    libraries' handles and workspaces are created outside the capture.  The
    output tensor is the graph's own, rewritten by every replay.  Timed on
    the card, the figure is the chain's, not the host's: a host that stalls
    while it issues work does not read as a slow card.

    The round's spans (:mod:`tpu_node_checker_torch.probe.spans`):
    ``graph.capture.<label>`` (the warm-up and the capture) and
    ``graph.launch.<label>`` (the host's time in ``graph.replay()``), with
    the counters ``graph_captures`` and ``graph_replays``.
    """
    launch = f"graph.launch.{label}"
    with spans.span(f"graph.capture.{label}"):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
    spans.count("graph_captures")
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
