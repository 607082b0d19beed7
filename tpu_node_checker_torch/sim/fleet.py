"""Seeded synthetic fleets: multi-slice TPU clusters with per-node failure
programs.

A copy of the JAX package's ``sim/fleet.py``, held equal to it by
``tests/test_torch_copies.py``.  A :class:`SimCluster` is a scenario's
ground truth: the node dicts the simulated API server serves, each round's
probe verdicts, and kubelet-readiness overrides.  Programs per node:
``("steady",)``, ``("flap", phase, period)``,
``("flap-until", phase, period, die_at)``, ``("fail-at", r)``,
``("kubelet-down-at", r)`` and ``("torn-link", r)`` (a passing host whose
mesh report grades link ``t1/<host index>`` slow from round ``r``).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from tpu_node_checker_torch.sim.fixtures import TPU_TAINT, make_node

Program = Tuple


class SimCluster:
    """One synthetic cluster: slices of TPU hosts plus failure programs."""

    def __init__(self, name: str, slices: int = 2, hosts_per_slice: int = 4,
                 chips_per_host: int = 4):
        self.name = name
        self.hosts_per_slice = hosts_per_slice
        self.chips_per_host = chips_per_host
        self.topology = f"{chips_per_host}x{hosts_per_slice}"
        self.by_slice: Dict[str, List[str]] = {}
        self.programs: Dict[str, Program] = {}
        for s in range(slices):
            hosts = [f"{name}-s{s}-h{h}" for h in range(hosts_per_slice)]
            self.by_slice[f"{name}-pool-{s}"] = hosts
            for h in hosts:
                self.programs[h] = ("steady",)

    # -- synthesis ----------------------------------------------------------

    def node_names(self) -> List[str]:
        return [h for hosts in self.by_slice.values() for h in hosts]

    def assign(self, rng: random.Random, program_fn, per_slice: int = 1,
               eligible: Optional[set] = None) -> List[str]:
        """Assign ``per_slice`` rng-sampled steady hosts of every slice the
        program ``program_fn(index)`` returns; the sample order is the
        rng's, so the same seed always condemns the same hosts."""
        chosen: List[str] = []
        for _pool, hosts in sorted(self.by_slice.items()):
            pool_eligible = [
                h for h in hosts
                if self.programs[h] == ("steady",)
                and (eligible is None or h in eligible)
            ]
            for h in rng.sample(pool_eligible,
                                min(per_slice, len(pool_eligible))):
                self.programs[h] = program_fn(len(chosen))
                chosen.append(h)
        return chosen

    def nodes(self, round_i: int = 0) -> List[dict]:
        """The fleet as raw node dicts for one round (kubelet-down programs
        flip the Ready condition; everything else is probe-layer)."""
        out = []
        for pool, hosts in sorted(self.by_slice.items()):
            for name in hosts:
                out.append(make_node(
                    name,
                    ready=not self._kubelet_down(name, round_i),
                    allocatable={"google.com/tpu": str(self.chips_per_host)},
                    labels={
                        "cloud.google.com/gke-tpu-accelerator":
                            "tpu-v5-lite-podslice",
                        "cloud.google.com/gke-tpu-topology": self.topology,
                        "cloud.google.com/gke-nodepool": pool,
                    },
                    taints=[TPU_TAINT],
                ))
        return out

    # -- per-round ground truth ---------------------------------------------

    def _kubelet_down(self, name: str, round_i: int) -> bool:
        prog = self.programs[name]
        return prog[0] == "kubelet-down-at" and round_i >= prog[1]

    def verdicts(self, round_i: int) -> Dict[str, bool]:
        """Per-host probe verdicts for one round (kubelet-down hosts keep a
        passing probe: their failure mode is the node object)."""
        out = {}
        for name in self.node_names():
            prog = self.programs[name]
            if prog[0] == "flap":
                _, phase, period = prog
                out[name] = (round_i + phase) % period != 0
            elif prog[0] == "flap-until":
                _, phase, period, die_at = prog
                out[name] = (
                    round_i < die_at and (round_i + phase) % period != 0
                )
            elif prog[0] == "fail-at":
                out[name] = round_i < prog[1]
            else:
                out[name] = True
        return out

    def degraded(self, round_i: int) -> Dict[str, str]:
        """Hosts whose ``torn-link`` program is active this round, mapped
        to the name of their slow ICI link (``t1/<host index>``).  These
        hosts keep a True verdict and never enter :meth:`down` — degraded
        capacity is not lost capacity, the whole point of the class."""
        out: Dict[str, str] = {}
        for name in self.node_names():
            prog = self.programs[name]
            if prog[0] == "torn-link" and round_i >= prog[1]:
                out[name] = f"t1/{int(name.rsplit('-h', 1)[1])}"
        return out

    def down(self, round_i: int) -> set:
        """Hosts unusable this round by PROGRAM alone (verdict false or
        kubelet down) — cordons are the apiserver's state, not the
        fleet's, and the scenario unions them in separately."""
        verd = self.verdicts(round_i)
        return {
            n for n in self.node_names()
            if not verd[n] or self._kubelet_down(n, round_i)
        }

    def chips_per_slice(self) -> int:
        return self.hosts_per_slice * self.chips_per_host


def synth_cluster(name: str, nodes: int, hosts_per_slice: int = 4,
                  chips_per_host: int = 4, min_slices: int = 1) -> SimCluster:
    """``nodes`` rounded up to whole slices (a partial slice would tear by
    construction and poison every completeness invariant)."""
    slices = max(min_slices, (max(1, nodes) + hosts_per_slice - 1)
                 // hosts_per_slice)
    return SimCluster(name, slices=slices, hosts_per_slice=hosts_per_slice,
                      chips_per_host=chips_per_host)
