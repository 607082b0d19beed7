"""Tap: the rank group of ``tpu_node_checker_torch.parallel.mesh``.

In the probe child: the wall clock around the group's start
(``RankGroup.start``: spawning the ranks and the process group's start on
every rank), recorded as ``group_starts``.  In every process: the wall
clock of its first command (``_call``, which runs each command the child
posts, on the child and on each rank) as ``first_command_wall``, and each
command as a ``probebench:command:<name>`` range in the trace.  In a
spawned rank: its entry (``_rank_main``) gives the capture its rank's
prefix and, in a traced round, starts the profiler there, on the rank's
card, before the rank joins the process group.
"""

import functools
import time

MODULE = "tpu_node_checker_torch.parallel.mesh"


def install(cap, mesh) -> None:
    start = mesh.RankGroup.start

    @functools.wraps(start)
    def group_start(self):
        begun = time.time()
        try:
            return start(self)
        finally:
            cap.meta.setdefault("group_starts", []).append([begun, time.time()])

    mesh.RankGroup.start = group_start

    call = mesh._call

    @functools.wraps(call)
    def command(fn, args, kwargs):
        if cap.meta.get("first_command_wall") is None:
            cap.meta["first_command_wall"] = time.time()
        with cap.annotate(f"command:{getattr(fn, '__name__', 'call')}"):
            return call(fn, args, kwargs)

    mesh._call = command

    if cap.rank_base is None:
        return
    rank_main = mesh._rank_main

    @functools.wraps(rank_main)
    def rank_entry(*args, **kwargs):
        bound = cap.bound(rank_main, args, kwargs)
        cap.open_rank(bound["local_rank"])
        if cap.trace == "rounds":
            if bound["device_type"] == "cuda":
                # The rank's own first step, taken before the profiler's
                # start so that the tracer finds the rank's card current.
                cap.torch.cuda.set_device(bound["local_rank"])
            cap.start_profiler()
        return rank_main(*args, **kwargs)

    mesh._rank_main = rank_entry
