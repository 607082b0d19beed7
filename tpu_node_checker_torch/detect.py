"""Pure detection / analysis core.

TPU-first re-design of the reference's L2 layer (``is_ready``
check-gpu-node.py:172-178, ``gpu_capacity`` :181-196, ``extract_node_info``
:199-212, ``list_gpu_nodes`` :215-226).  Differences, all deliberate:

* Operates on **raw Kubernetes REST dicts** (``{"metadata": ..., "status": ...}``)
  instead of ``kubernetes.client`` model objects — the framework ships its own
  dependency-free HTTPS client (the JAX package's ``cluster.py``), and plain dicts
  make the core trivially testable with JSON fixtures.
* Reads ``status.allocatable`` (what pods can actually schedule against) with a
  ``capacity`` fallback; the reference reads only ``capacity``
  (check-gpu-node.py:184-187), which over-reports on nodes with reserved devices.
* Interprets GKE TPU topology labels the reference collects but ignores
  (labels gathered at check-gpu-node.py:207, surfaced raw only in ``--json``):
  ``cloud.google.com/gke-tpu-accelerator`` and
  ``cloud.google.com/gke-tpu-topology``.
* Adds slice grouping: a v5e-256 slice is 64 node objects that form ONE logical
  accelerator; :func:`group_slices` reconstructs that unit so readiness can be
  judged slice-wide (the reference judges per-node only,
  check-gpu-node.py:220-225).

Everything here is a pure function of its inputs: no I/O, no globals beyond the
default registry.

A copy of the JAX package's ``detect.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_node_checker_torch.resources import AcceleratorMatch, ResourceRegistry, default_registry

# GKE node labels that describe TPU hardware.  The accelerator/topology pair is
# the authoritative slice descriptor; the nodepool label is the slice identity
# (every host of one multi-host slice lives in one node pool).
LABEL_TPU_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
LABEL_TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"
LABEL_NODEPOOL = "cloud.google.com/gke-nodepool"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
# GPU-node identity labels, used for the same dead-device-plugin rescue as the
# TPU label above: GKE GPU pools carry gke-accelerator (e.g. "nvidia-tesla-t4");
# the NVIDIA GPU operator / feature-discovery stamps gpu.present="true".
LABEL_GPU_ACCELERATOR = "cloud.google.com/gke-accelerator"
LABEL_NVIDIA_GPU_PRESENT = "nvidia.com/gpu.present"
# Multislice grouping labels, checked in order.  A multislice job spans
# several slices joined over DCN; GKE has no single canonical *node* label
# for the grouping (it is a workload-level concept), so operators commonly
# stamp their TPU node pools with one of these — and ``--multislice-label``
# adds site-specific keys in front.
MULTISLICE_GROUP_LABELS = (
    "cloud.google.com/gke-multislice-group",
    "multislice-group",
)
# Annotation stamped by --cordon-failed (written in cluster.py, read here):
# marks a cordon as this tool's quarantine, so --uncordon-recovered can lift
# it without ever touching a human's cordon.
QUARANTINE_ANNOTATION = "tpu-node-checker.io/quarantined"

# Taints that announce a PLANNED disruption (the reference collects taints but
# never interprets them, check-gpu-node.py:207 — so a maintenance drain and a
# hardware fault read identically).  Interpreting these separates "GKE is
# taking this node, as scheduled" from "this node broke": same exit code,
# very different 2am response.
PLANNED_DISRUPTION_TAINTS = {
    # Cluster-autoscaler scale-down lifecycle (upstream taint keys).
    "ToBeDeletedByClusterAutoscaler": "autoscaler-scale-down",
    "DeletionCandidateOfClusterAutoscaler": "autoscaler-scale-down-candidate",
    # GKE stamps this ahead of host maintenance / spot reclaim.
    "cloud.google.com/impending-node-termination": "impending-termination",
}
# Interruptible-capacity labels: the node can vanish at any time by design.
INTERRUPTIBLE_LABELS = (
    "cloud.google.com/gke-spot",
    "cloud.google.com/gke-preemptible",
)
# The planned signals that can EXCUSE unavailability (trend math, Slack
# "expected downtime", slice context).  The autoscaler's soft candidate
# taint is deliberately absent: it marks an underutilized node that is
# still Ready and schedulable — if such a node is sick, something broke.
HARD_PLANNED_DISRUPTIONS = frozenset(
    {"autoscaler-scale-down", "impending-termination"}
)

_INSTANCE_CHIPS_RE = re.compile(r"-(\d+)t$")


def chips_per_host_from_instance_type(instance_type: Optional[str]) -> Optional[int]:
    """Chips per host from a GKE TPU machine type (``ct5lp-hightpu-4t`` → 4).

    TPU machine types encode the per-host chip count as a trailing ``-<n>t``;
    used as a fallback when NotReady hosts report no allocatable devices, so
    slice expectations stay correct even with every host down.
    """
    if not instance_type or not isinstance(instance_type, str):
        return None
    m = _INSTANCE_CHIPS_RE.search(instance_type)
    return int(m.group(1)) if m else None


def _as_dict(x) -> dict:
    """Defensive coercion: the reference tolerates partially-populated node
    objects (check-gpu-node.py:173,184,203-211); we go further and tolerate
    *wrongly-typed* slots too — a checker must never crash on API garbage."""
    return x if isinstance(x, dict) else {}


def _as_list(x) -> list:
    return x if isinstance(x, list) else []


# Adverse NodeConditions: status=="True" on any of these is a named fault
# channel even while the Ready condition itself may still say True.
ADVERSE_CONDITIONS = (
    "NetworkUnavailable",
    "MemoryPressure",
    "DiskPressure",
    "PIDPressure",
)


def ready_condition(node: dict) -> Tuple[bool, Optional[str], Optional[str]]:
    """``(ready, reason, message)`` from the Ready NodeCondition.

    The reference keeps only the boolean (check-gpu-node.py:172-178) and so
    discards the one field that answers "why is it NotReady" — kubelet's own
    ``reason`` (``KubeletNotReady``, ``NodeStatusUnknown``, …) and human
    ``message``, already present on the same LIST response.  Missing or
    malformed condition → ``(False, None, None)``; non-string reason/message
    slots (API garbage) fold to ``None`` rather than poisoning formatters.
    """
    conditions = _as_list(_as_dict(_as_dict(node).get("status")).get("conditions"))
    for cond in conditions:
        cond = _as_dict(cond)
        if cond.get("type") == "Ready":
            ready = cond.get("status") == "True"
            reason = cond.get("reason")
            message = cond.get("message")
            return (
                ready,
                reason if isinstance(reason, str) and reason else None,
                message if isinstance(message, str) and message else None,
            )
    return False, None, None


def adverse_conditions(node: dict) -> Tuple[str, ...]:
    """Adverse NodeCondition types currently asserted (status=="True").

    Order follows :data:`ADVERSE_CONDITIONS`, not the wire, so the JSON
    surface is stable for any condition ordering the API returns.
    """
    active = set()
    for cond in _as_list(_as_dict(_as_dict(node).get("status")).get("conditions")):
        cond = _as_dict(cond)
        if cond.get("type") in ADVERSE_CONDITIONS and cond.get("status") == "True":
            active.add(cond["type"])
    return tuple(c for c in ADVERSE_CONDITIONS if c in active)


def is_ready(node: dict) -> bool:
    """True iff a NodeCondition has type=="Ready" and status=="True".

    Same rule as check-gpu-node.py:172-178, including the defensive defaults:
    missing (or malformed) ``status``/``conditions`` → not ready.
    """
    return ready_condition(node)[0]


def format_why_not_ready(
    reason: Optional[str],
    message: Optional[str],
    adverse: Sequence[str] = (),
) -> Optional[str]:
    """``KubeletNotReady: container runtime is down`` — the one line every
    NotReady surface (table, Slack, trend causes) renders the same way.

    ``None`` when the API offered no detail at all.  The message is
    whitespace-collapsed (kubelet messages can be multi-line) and capped at
    100 chars so the line fits table cells and Slack bullets.
    """
    parts = []
    if reason:
        parts.append(reason)
    if adverse:
        parts.append("+".join(adverse))
    msg = " ".join(message.split()) if message else ""
    msg = f"{msg[:100]}{'…' if len(msg) > 100 else ''}" if msg else ""
    if not parts:
        # Message-only conditions happen (a controller that sets message but
        # no reason): the one field that answers "why" must still surface.
        return msg or None
    head = ", ".join(parts)
    return f"{head}: {msg}" if msg else head


def accelerator_allocatable(
    node: dict, registry: Optional[ResourceRegistry] = None
) -> Tuple[List[AcceleratorMatch], bool]:
    """Accelerator devices a node offers → (matches, schedulable).

    The reference's ``gpu_capacity`` (check-gpu-node.py:181-196) reads
    ``capacity`` only; allocatable is what schedulers actually see, so it is
    the primary source here.  Two fallback cases keep sick nodes *visible*
    instead of silently dropping them (which would flip exit 3 into exit 2):

    * allocatable map entirely absent (kubelet mid-registration) → use
      capacity, ``schedulable`` stays True (nothing contradicts it);
    * allocatable present but advertising zero accelerators while capacity
      shows some (dead device plugin) → report the capacity devices with
      ``schedulable=False``, so the node counts as an accelerator node that
      is not effectively Ready.
    """
    registry = registry or default_registry()
    status = _as_dict(_as_dict(node).get("status"))
    allocatable = status.get("allocatable")
    capacity = status.get("capacity")
    if not isinstance(capacity, dict):
        capacity = None
    if not isinstance(allocatable, dict):
        return registry.scan(capacity), True
    matches = registry.scan(allocatable)
    if matches:
        return matches, True
    cap_matches = registry.scan(capacity)
    if cap_matches:
        return cap_matches, False  # devices physically present, none schedulable
    return [], True


@dataclass
class NodeInfo:
    """Flattened view of one node — superset of the reference's dict
    (``extract_node_info``, check-gpu-node.py:199-212)."""

    name: str
    ready: bool
    accelerators: int  # total devices across matched keys ("gpus" in the reference)
    breakdown: Dict[str, int]  # per-key attribution ("gpu_breakdown")
    families: Tuple[str, ...]  # ("tpu",), ("gpu",), or both for mixed nodes
    labels: Dict[str, str]
    taints: List[Dict[str, Optional[str]]]
    # False when capacity shows devices but allocatable advertises none
    # (dead device plugin): the node is visible but must not count as Ready.
    schedulable: bool = True
    # spec.unschedulable — the node is cordoned (kubectl cordon or
    # --cordon-failed).  Kept OUT of readiness (parity: the reference counts
    # cordoned nodes as Ready); used to avoid re-cordoning and surfaced in
    # the payload.
    cordoned: bool = False
    # True when the cordon carries OUR quarantine annotation — the only
    # cordons --uncordon-recovered may lift.
    quarantined_by_us: bool = False
    # TPU-only fields (None on GPU/CPU nodes):
    tpu_accelerator: Optional[str] = None  # e.g. "tpu-v5-lite-podslice"
    tpu_topology: Optional[str] = None  # e.g. "16x16"
    nodepool: Optional[str] = None
    # Planned-disruption context (never a grade): taint-derived reasons
    # (PLANNED_DISRUPTION_TAINTS values) and the spot/preemptible flag.
    planned_disruptions: Tuple[str, ...] = ()
    interruptible: bool = False
    # "Why NotReady" triage, from the Ready condition the reference discards
    # (check-gpu-node.py:172-178): kubelet's reason (KubeletNotReady,
    # NodeStatusUnknown, …) and message, plus any asserted adverse
    # conditions (NetworkUnavailable / pressure) — distinct failure classes
    # that must not all read as a bare "NotReady".
    not_ready_reason: Optional[str] = None
    not_ready_message: Optional[str] = None
    adverse_conditions: Tuple[str, ...] = ()
    # Data-plane probe result, attached later by the probe layer (None = not probed):
    probe: Optional[dict] = None
    # Recent k8s Events for SICK nodes, attached by --node-events (None =
    # not fetched): [{type, reason, message, count, last_seen}], newest
    # first — the `kubectl describe node` triage block, pushed not dug for.
    events: Optional[list] = None
    # Hysteresis verdict from the --history subsystem (None = no history):
    # {state, streak, flaps} per history/fsm.py — the debounced view the
    # cordon/uncordon path consults instead of this round's raw snapshot.
    health: Optional[dict] = None

    @property
    def is_tpu(self) -> bool:
        return "tpu" in self.families

    @property
    def planned_word(self) -> Optional[str]:
        """Human word for the disruption class: ``maintenance`` (GKE host
        maintenance / impending termination) or ``scale-down`` (autoscaler)."""
        if not self.planned_disruptions:
            return None
        if "impending-termination" in self.planned_disruptions:
            return "maintenance"
        return "scale-down"

    @property
    def sickness_planned(self) -> bool:
        """True when this node's unavailability is *explained* by a planned
        disruption: a HARD signal (a drain/termination in progress, not a
        mere scale-down-candidate mark) and no failed chip-probe verdict —
        dead chips are never "planned"; a real hardware fault must not hide
        behind a maintenance drain."""
        if self.effectively_ready:
            return False
        if not HARD_PLANNED_DISRUPTIONS.intersection(self.planned_disruptions):
            return False
        return not (self.probe is not None and not self.probe.get("ok"))

    @property
    def why_not_ready(self) -> Optional[str]:
        """Compact triage line for a NotReady node — ``reason: message``,
        with asserted adverse conditions appended; ``None`` when ready or
        when the API offered no detail (condition missing entirely)."""
        if self.ready:
            return None
        return format_why_not_ready(
            self.not_ready_reason, self.not_ready_message, self.adverse_conditions
        )

    @property
    def effectively_ready(self) -> bool:
        """Kubelet Ready AND schedulable AND (if probed) chips alive.

        This is the readiness the exit-code and slice logic consume; plain
        ``ready`` stays the raw kubelet condition for reporting parity with
        the reference.
        """
        if not self.ready or not self.schedulable:
            return False
        return self.probe is None or bool(self.probe.get("ok"))

    def to_dict(self) -> dict:
        """JSON shape — superset of the reference payload's node entries
        (check-gpu-node.py:273-279: name/ready/gpus/gpu_breakdown/labels/taints)."""
        d = {
            "name": self.name,
            "ready": self.ready,
            "schedulable": self.schedulable,
            "cordoned": self.cordoned,
            "accelerators": self.accelerators,
            "breakdown": dict(self.breakdown),
            "families": list(self.families),
            "labels": dict(self.labels),
            "taints": list(self.taints),
        }
        if self.is_tpu:
            d["tpu"] = {
                "accelerator": self.tpu_accelerator,
                "topology": self.tpu_topology,
                "nodepool": self.nodepool,
            }
        if self.quarantined_by_us:
            d["quarantined_by_us"] = True
        if not self.ready and (self.not_ready_reason or self.not_ready_message):
            d["not_ready"] = {
                "reason": self.not_ready_reason,
                "message": self.not_ready_message,
            }
        if self.adverse_conditions:
            d["adverse_conditions"] = list(self.adverse_conditions)
        if self.planned_disruptions or self.interruptible:
            d["planned"] = {
                "disruptions": list(self.planned_disruptions),
                "interruptible": self.interruptible,
            }
        if self.probe is not None:
            d["probe"] = self.probe
        if self.events is not None:
            d["events"] = list(self.events)
        if self.health is not None:
            d["health"] = dict(self.health)
        return d


def extract_node_info(node: dict, registry: Optional[ResourceRegistry] = None) -> NodeInfo:
    """Flatten a raw node dict into :class:`NodeInfo`.

    Mirrors check-gpu-node.py:199-212 (name, ready, totals, breakdown, labels,
    taints) and additionally interprets the TPU topology labels.
    """
    node = _as_dict(node)
    metadata = _as_dict(node.get("metadata"))
    labels = _as_dict(metadata.get("labels"))
    matches, schedulable = accelerator_allocatable(node, registry)
    breakdown = {m.key: m.count for m in matches}
    families = tuple(sorted({m.family for m in matches}))
    if not matches:
        # Label rescue: hardware-identity labels say this is an accelerator
        # host even though the device plugin advertises nothing (fully dead
        # plugin — no allocatable AND no capacity entry).  Keep the node
        # visible as an unschedulable accelerator node so the cluster grades
        # exit 3 ("nodes exist, none usable"), not exit 2 ("no accelerator
        # nodes").  Symmetric across families (VERDICT r01 item #4): GKE TPU
        # label, GKE GPU pool label, NVIDIA feature-discovery label.
        if LABEL_TPU_ACCELERATOR in labels:
            families = ("tpu",)
            schedulable = False
        elif (
            LABEL_GPU_ACCELERATOR in labels
            or labels.get(LABEL_NVIDIA_GPU_PRESENT) == "true"
        ):
            families = ("gpu",)
            schedulable = False
    spec = _as_dict(node.get("spec"))
    taints = [
        {"key": t.get("key"), "value": t.get("value"), "effect": t.get("effect")}
        for t in map(_as_dict, _as_list(spec.get("taints")))
    ]
    # Planned-disruption signals: dedup preserving taint order, so the JSON
    # surface is stable for any taint ordering the API returns.  Key must be
    # a string — an unhashable garbage key (API garbage, fuzzed fixtures)
    # must not crash the checker.
    planned = tuple(
        dict.fromkeys(
            PLANNED_DISRUPTION_TAINTS[t["key"]]
            for t in taints
            if isinstance(t["key"], str) and t["key"] in PLANNED_DISRUPTION_TAINTS
        )
    )
    interruptible = any(labels.get(k) == "true" for k in INTERRUPTIBLE_LABELS)
    name = metadata.get("name")

    def _label(key: str) -> Optional[str]:
        # Labels come off the wire; a non-string value (API garbage, offline
        # fixtures) must not poison slice grouping's sort keys.
        v = labels.get(key)
        return v if isinstance(v, str) else None

    ready, nr_reason, nr_message = ready_condition(node)
    return NodeInfo(
        name=name if isinstance(name, str) else "",
        ready=ready,
        accelerators=sum(breakdown.values()),
        breakdown=breakdown,
        families=families,
        labels=dict(labels),
        taints=taints,
        schedulable=schedulable,
        cordoned=bool(spec.get("unschedulable")),
        quarantined_by_us=QUARANTINE_ANNOTATION
        in _as_dict(metadata.get("annotations")),
        tpu_accelerator=_label(LABEL_TPU_ACCELERATOR),
        tpu_topology=_label(LABEL_TPU_TOPOLOGY),
        nodepool=_label(LABEL_NODEPOOL),
        planned_disruptions=planned,
        interruptible=interruptible,
        not_ready_reason=None if ready else nr_reason,
        not_ready_message=None if ready else nr_message,
        adverse_conditions=adverse_conditions(node),
    )


def select_accelerator_nodes(
    nodes: Sequence[dict], registry: Optional[ResourceRegistry] = None
) -> Tuple[List[NodeInfo], List[NodeInfo]]:
    """Filter a node list to accelerator nodes; return (all, ready).

    Same contract as ``list_gpu_nodes`` (check-gpu-node.py:215-226) minus the
    API call — the transport layer hands raw dicts in.
    """
    infos = [extract_node_info(n, registry) for n in nodes]
    # Label-rescued nodes (non-empty families, zero advertised devices — dead
    # device plugin, TPU or GPU) stay visible: they are accelerator nodes
    # that cannot serve.
    accel = [i for i in infos if i.accelerators > 0 or i.families]
    ready = [i for i in accel if i.ready and i.schedulable]
    return accel, ready


# --------------------------------------------------------------------------- #
# Slice grouping — no reference analog (SURVEY §7 "hard parts").
# --------------------------------------------------------------------------- #


# Topology labels repeat fleet-wide (a 5k-node fleet carries a handful of
# distinct values) but parse per node per round — 2ms of every relist tick
# before this cache.  Bounded: label garbage must not grow it forever.
_TOPOLOGY_CACHE: dict = {}
_TOPOLOGY_CACHE_MAX = 1024
_TOPOLOGY_MISS = object()


def parse_topology(topology: Optional[str]) -> Optional[Tuple[int, ...]]:
    """Parse a GKE topology label value like ``"2x2x1"`` or ``"16x16"``."""
    if not topology or not isinstance(topology, str):
        return None
    cached = _TOPOLOGY_CACHE.get(topology, _TOPOLOGY_MISS)
    if cached is not _TOPOLOGY_MISS:
        return cached
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError:
        dims = None
    result = dims if dims and all(d > 0 for d in dims) else None
    if len(_TOPOLOGY_CACHE) >= _TOPOLOGY_CACHE_MAX:
        _TOPOLOGY_CACHE.clear()
    _TOPOLOGY_CACHE[topology] = result
    return result


def topology_chip_count(topology: Optional[str]) -> Optional[int]:
    """Total chips a topology describes: the product of its dimensions."""
    dims = parse_topology(topology)
    if dims is None:
        return None
    n = 1
    for d in dims:
        n *= d
    return n


@dataclass
class SliceInfo:
    """One logical TPU slice reconstructed from its member node objects.

    Identity is (nodepool, accelerator, topology): all hosts of a GKE
    multi-host slice share one node pool and carry identical topology labels.
    """

    accelerator: Optional[str]
    topology: Optional[str]
    nodepool: Optional[str]
    hosts: List[NodeInfo] = field(default_factory=list)
    # True when this is a degenerate one-host slice (topology fits on a single
    # host); several of these can share a nodepool, so unique identity comes
    # from the host name (see ``slice_id``).
    single_host: bool = False

    @property
    def ready_hosts(self) -> List[NodeInfo]:
        # Probe-aware: a kubelet-Ready host with dead chips is not a usable
        # slice member (properties re-evaluate after the probe layer attaches
        # results to the shared NodeInfo objects).
        return [h for h in self.hosts if h.effectively_ready]

    @property
    def chips(self) -> int:
        return sum(h.accelerators for h in self.hosts)

    @property
    def ready_chips(self) -> int:
        return sum(h.accelerators for h in self.ready_hosts)

    @property
    def expected_chips(self) -> Optional[int]:
        return topology_chip_count(self.topology)

    @property
    def expected_hosts(self) -> Optional[int]:
        """Hosts the topology implies: expected chips / per-host chip count.

        Per-host count comes from the largest live allocatable report, with a
        machine-type fallback (``ct5lp-hightpu-4t`` → 4) so a slice whose
        hosts are all down — reporting zero allocatable — still has correct
        expectations instead of disappearing from strictness checks.
        """
        total = self.expected_chips
        if total is None or not self.hosts:
            return None
        per_host = max((h.accelerators for h in self.hosts), default=0)
        if per_host <= 0:
            per_host = (
                max(
                    (
                        chips_per_host_from_instance_type(
                            h.labels.get(LABEL_INSTANCE_TYPE)
                        )
                        or 0
                        for h in self.hosts
                    ),
                    default=0,
                )
            )
        if per_host <= 0:
            return None
        return max(1, total // per_host)

    @property
    def complete(self) -> bool:
        """All hosts the topology implies are present AND Ready.

        This is the slice-wide readiness the reference cannot express: one
        NotReady (or missing) host makes the whole slice unusable for SPMD
        jobs even though every other node object reads Ready.
        """
        expected = self.expected_hosts
        if expected is None:
            return bool(self.hosts) and len(self.ready_hosts) == len(self.hosts)
        return len(self.ready_hosts) >= expected

    @property
    def slice_id(self) -> str:
        """Stable unique identifier: host name for single-host slices (many
        can share one nodepool), nodepool otherwise."""
        if self.single_host and self.hosts:
            return self.hosts[0].name
        return self.nodepool or (self.hosts[0].name if self.hosts else "?")

    @property
    def planned_context(self) -> Optional[str]:
        """``maintenance`` / ``scale-down`` when EVERY unusable host of an
        incomplete slice carries a planned-disruption signal — the state is
        expected, not a fault.  ``None`` when the slice is complete, when any
        sick host has no planned signal (a real fault may be hiding behind
        the drain), or when hosts are missing entirely (a drained host that
        got deleted can no longer explain anything)."""
        if self.complete:
            return None
        expected = self.expected_hosts
        if expected is not None and len(self.hosts) < expected:
            return None
        sick = [h for h in self.hosts if not h.effectively_ready]
        if not sick or any(not h.sickness_planned for h in sick):
            return None
        words = {h.planned_word for h in sick}
        return "maintenance" if "maintenance" in words else "scale-down"

    def to_dict(self) -> dict:
        d = {
            "id": self.slice_id,
            "accelerator": self.accelerator,
            "topology": self.topology,
            "nodepool": self.nodepool,
            "hosts": len(self.hosts),
            "ready_hosts": len(self.ready_hosts),
            "expected_hosts": self.expected_hosts,
            "chips": self.chips,
            "ready_chips": self.ready_chips,
            "expected_chips": self.expected_chips,
            "complete": self.complete,
            "host_names": [h.name for h in self.hosts],
        }
        if self.planned_context:
            d["planned_context"] = self.planned_context
        return d


@dataclass
class MultisliceInfo:
    """Several slices joined over DCN into one logical multislice job.

    Grouping comes from a node label (``MULTISLICE_GROUP_LABELS`` or an
    operator-supplied key).  The roll-up is over slices *present* in the
    cluster: the labels cannot express how many slices the job was meant to
    have, so "complete" means every member slice is complete — an entirely
    missing slice (its node pool scaled to zero) is invisible here and must
    be caught with ``--expected-chips``.
    """

    group: str
    slices: List[SliceInfo] = field(default_factory=list)
    # True when some member slice's hosts disagree about (or lack) the
    # grouping label — mid-rollout or after a node recreate; the roll-up is
    # still produced (majority label) but flagged so the flapping-label state
    # is visible instead of silently reshaping groups run to run.
    partial_labeling: bool = False

    @property
    def hosts(self) -> int:
        return sum(len(s.hosts) for s in self.slices)

    @property
    def chips(self) -> int:
        return sum(s.chips for s in self.slices)

    @property
    def ready_chips(self) -> int:
        return sum(s.ready_chips for s in self.slices)

    @property
    def expected_chips(self) -> Optional[int]:
        per_slice = [s.expected_chips for s in self.slices]
        if any(e is None for e in per_slice):
            return None
        return sum(per_slice)

    @property
    def complete(self) -> bool:
        return bool(self.slices) and all(s.complete for s in self.slices)

    def to_dict(self) -> dict:
        return {
            "group": self.group,
            "slices": [s.slice_id for s in self.slices],
            "num_slices": len(self.slices),
            "hosts": self.hosts,
            "chips": self.chips,
            "ready_chips": self.ready_chips,
            "expected_chips": self.expected_chips,
            "complete": self.complete,
            "partial_labeling": self.partial_labeling,
        }


def group_multislices(
    slices: Sequence[SliceInfo], extra_label_keys: Sequence[str] = ()
) -> List[MultisliceInfo]:
    """Group slices into multislices by their hosts' grouping label.

    ``extra_label_keys`` (from ``--multislice-label``) are checked before the
    built-in conventions.  Slices without any grouping label stay out —
    single-slice jobs need no roll-up.
    """
    keys = tuple(extra_label_keys) + MULTISLICE_GROUP_LABELS
    by_group: Dict[str, MultisliceInfo] = {}
    for s in slices:
        if not s.hosts:
            continue
        # Read the label from ALL hosts, not host[0]: under partial labeling
        # (mid-rollout, node recreate) API ordering would otherwise make a
        # slice's membership flap run to run.  Majority wins, ties break
        # lexically — deterministic for any host order.
        group, consistent = None, True
        for k in keys:
            counts: Dict[str, int] = {}
            for h in s.hosts:
                v = h.labels.get(k)
                if isinstance(v, str) and v:
                    counts[v] = counts.get(v, 0) + 1
            if counts:
                group = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0][0]
                consistent = len(counts) == 1 and sum(counts.values()) == len(s.hosts)
                break
        if group is None:
            continue
        m = by_group.setdefault(group, MultisliceInfo(group=group))
        m.slices.append(s)
        if not consistent:
            m.partial_labeling = True
    return sorted(by_group.values(), key=lambda m: m.group)


def slice_group_key(info: NodeInfo) -> Optional[Tuple]:
    """The slice-grouping key of one node — ``None`` for non-TPU nodes,
    ``("__single__", name)`` for degenerate single-host slices, otherwise
    ``(nodepool, accelerator, topology)``.  ONE definition, shared by
    :func:`group_slices` and the watch-stream engine's incremental slice
    cache, so the two can never group differently.
    """
    if not info.is_tpu:
        return None
    expected = topology_chip_count(info.tpu_topology)
    if expected is not None and expected <= info.accelerators:
        # Single-host slice type (topology fits on one host): every node
        # is its own logical slice.  Grouping them by nodepool would let
        # one Ready host mark a pool of dead ones "complete".
        return ("__single__", info.name)
    if info.tpu_topology is None and info.nodepool is None:
        return ("__single__", info.name)
    return (info.nodepool, info.tpu_accelerator, info.tpu_topology)


def build_slice(key: Tuple, hosts: Sequence[NodeInfo]) -> SliceInfo:
    """One slice group → its :class:`SliceInfo` (hosts in caller order)."""
    first = hosts[0]
    s = SliceInfo(
        accelerator=first.tpu_accelerator,
        topology=first.tpu_topology,
        nodepool=first.nodepool,
        single_host=key[0] == "__single__",
    )
    s.hosts.extend(hosts)
    return s


def sort_slices(slices) -> List[SliceInfo]:
    """Deterministic slice order: by nodepool then first host name — the
    payload-pinned ordering every payload assembly (full or incremental) shares."""
    return sorted(
        slices,
        key=lambda s: (s.nodepool or "", s.hosts[0].name if s.hosts else ""),
    )


def group_slices(infos: Sequence[NodeInfo]) -> List[SliceInfo]:
    """Group TPU nodes into logical slices by (nodepool, accelerator, topology).

    Nodes without TPU devices are ignored; TPU nodes without topology labels
    each form a degenerate single-host slice.
    """
    by_key: Dict[Tuple, List[NodeInfo]] = {}
    for info in infos:
        key = slice_group_key(info)
        if key is None:
            continue
        hosts = by_key.get(key)
        if hosts is None:
            hosts = by_key[key] = []
        hosts.append(info)
    return sort_slices(build_slice(k, hosts) for k, hosts in by_key.items())
