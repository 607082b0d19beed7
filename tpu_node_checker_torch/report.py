"""Presentation layer: human table + ``--json`` machine format.

Re-design of the reference's L3 (``print_table`` check-gpu-node.py:229-249 and
the JSON payload assembly :273-279).  The table gains TPU columns; the JSON
payload is a superset of the reference schema ``{total_nodes, ready_nodes,
nodes:[{name, ready, gpus, gpu_breakdown, labels, taints}]}`` and keeps the
legacy ``gpus`` / ``gpu_breakdown`` aliases inside each node entry so CI
consumers of the reference can switch without edits.

A copy of the JAX package's ``report.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from tpu_node_checker_torch.detect import NodeInfo, SliceInfo


def render_columns(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """Dynamic-width text table, same technique as check-gpu-node.py:234-249."""
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    lines = [
        "  ".join(h.ljust(widths[i]) for i, h in enumerate(headers)).rstrip(),
        "  ".join("-" * widths[i] for i in range(len(headers))),
    ]
    for row in rows:
        lines.append("  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip())
    return "\n".join(lines)


def _status(n: NodeInfo) -> str:
    """Kubelet readiness, annotated when the device plugin is dead (node is
    Ready but allocatable advertises zero devices) and when the node is
    under a PLANNED disruption (maintenance drain / autoscaler scale-down)
    — "GKE is taking this node, as scheduled" and "this node broke" must
    not read identically."""
    if not n.ready:
        # Kubelet's own reason token (short, camel-case) rides in the cell;
        # the full message stays in Slack bullets / JSON / trend causes.
        base = f"NotReady[{n.not_ready_reason}]" if n.not_ready_reason else "NotReady"
    else:
        base = "Ready" if n.schedulable else "Ready/NoAlloc"
    word = n.planned_word
    return f"{base} ({word})" if word else base


def format_node_table(nodes: Sequence[NodeInfo]) -> str:
    """NAME / READY / ACCEL(TOTAL) / KEYS / TPU-TOPOLOGY table.

    Empty input prints a single informational line, mirroring
    check-gpu-node.py:230-232.
    """
    if not nodes:
        return "No accelerator nodes found in the cluster."
    rows = []
    for n in nodes:
        keys = ", ".join(f"{k}:{v}" for k, v in sorted(n.breakdown.items()))
        topo = ""
        if n.is_tpu:
            topo = f"{n.tpu_accelerator or '?'} {n.tpu_topology or ''}".strip()
        probe = "-"
        if n.probe is not None:
            probe = "ok" if n.probe.get("ok") else "FAIL"
        rows.append([n.name, _status(n), str(n.accelerators), keys, topo, probe])
    return render_columns(["NAME", "READY", "ACCEL", "KEYS", "TPU", "PROBE"], rows)


def _degraded(s: SliceInfo) -> str:
    """Slice degraded-state word, annotated when every sick host is under a
    planned disruption: ``DEGRADED (maintenance)`` is expected downtime,
    bare ``DEGRADED`` is an incident."""
    ctx = s.planned_context
    return f"DEGRADED ({ctx})" if ctx else "DEGRADED"


def format_slice_table(slices: Sequence[SliceInfo]) -> str:
    """Per-slice readiness summary — no reference analog (slice grouping is new)."""
    if not slices:
        return ""
    rows = []
    for s in slices:
        expected_hosts = s.expected_hosts
        hosts = f"{len(s.ready_hosts)}/{expected_hosts if expected_hosts else len(s.hosts)}"
        expected_chips = s.expected_chips
        chips = f"{s.ready_chips}/{expected_chips if expected_chips else s.chips}"
        rows.append(
            [
                s.nodepool or "-",
                s.accelerator or "-",
                s.topology or "-",
                hosts,
                chips,
                "complete" if s.complete else _degraded(s),
            ]
        )
    return render_columns(
        ["SLICE(NODEPOOL)", "ACCELERATOR", "TOPOLOGY", "HOSTS", "CHIPS", "STATUS"], rows
    )


def format_multislice_table(multislices: Sequence) -> str:
    """DCN-joined multislice roll-up — one row per labeled group."""
    if not multislices:
        return ""
    rows = []
    for m in multislices:
        expected = m.expected_chips
        chips = f"{m.ready_chips}/{expected if expected else m.chips}"
        rows.append(
            [
                m.group,
                str(len(m.slices)),
                str(m.hosts),
                chips,
                "complete" if m.complete else "DEGRADED",
            ]
        )
    return render_columns(
        ["MULTISLICE(GROUP)", "SLICES", "HOSTS", "CHIPS", "STATUS"], rows
    )


def summary_line(accel: Sequence[NodeInfo], ready: Sequence[NodeInfo]) -> str:
    """Emoji status line in the spirit of check-gpu-node.py:281-287."""
    total_chips = sum(n.accelerators for n in accel)
    ready_chips = sum(n.accelerators for n in ready)
    if not accel:
        return "❌ No accelerator nodes found."
    if len(ready) == len(accel):
        return (
            f"✅ {len(ready)}/{len(accel)} accelerator nodes Ready "
            f"({ready_chips}/{total_chips} chips)."
        )
    if ready:
        return (
            f"⚠️ {len(ready)}/{len(accel)} accelerator nodes Ready "
            f"({ready_chips}/{total_chips} chips)."
        )
    return f"❌ 0/{len(accel)} accelerator nodes Ready (0/{total_chips} chips)."


def _node_entry(n: NodeInfo) -> dict:
    d = n.to_dict()
    # Drop-in aliases for the reference schema (check-gpu-node.py:273-279).
    d["gpus"] = n.accelerators
    d["gpu_breakdown"] = dict(n.breakdown)
    return d


def build_json_payload(
    accel: Sequence[NodeInfo],
    ready: Sequence[NodeInfo],
    slices: Sequence[SliceInfo],
    timings_ms: Optional[Dict[str, float]] = None,
    error: Optional[str] = None,
    entries: Optional[List[dict]] = None,
) -> dict:
    """``entries`` (the relist fast path) is the pre-built ``_node_entry``
    list aligned with ``accel`` — cached entries are reused BY REFERENCE
    for digest-unchanged nodes, so they must be byte-identical to what
    ``_node_entry`` would rebuild (same function, same inputs; pinned by
    the fast-path parity tests)."""
    payload = {
        "total_nodes": len(accel),
        "ready_nodes": len(ready),
        "total_chips": sum(n.accelerators for n in accel),
        "ready_chips": sum(n.accelerators for n in ready),
        "nodes": [_node_entry(n) for n in accel] if entries is None else entries,
        "slices": [s.to_dict() for s in slices],
    }
    if timings_ms is not None:
        payload["timings_ms"] = timings_ms
    if error is not None:
        payload["error"] = error
    return payload


def dumps(payload: dict) -> str:
    """Match the reference's serialization options (check-gpu-node.py:273:
    ``ensure_ascii=False, indent=2``)."""
    return json.dumps(payload, ensure_ascii=False, indent=2)


def error_payload(message: str) -> str:
    """Machine-readable error object for --json mode (check-gpu-node.py:321-322)."""
    return json.dumps({"error": message}, ensure_ascii=False)


def _cap_listing(items, is_problem, threshold: int, cap: int = 30):
    """Shared Slack scaling policy: small sets list exhaustively; above
    ``threshold`` only problem entries are listed, at most ``cap`` of them.

    Returns ``(listed, omitted_problems, omitted_healthy)`` — the caller
    renders the omission counts so truncation is never silent.
    """
    listed = list(items)
    omitted_problems = omitted_healthy = 0
    if len(listed) > threshold:
        problems = [x for x in listed if is_problem(x)]
        omitted_healthy = len(listed) - len(problems)
        listed = problems[:cap]
        omitted_problems = len(problems) - len(listed)
    return listed, omitted_problems, omitted_healthy


def _named_list(names: Sequence[str], cap: int = 10) -> str:
    """Backticked name list, capped: `a`, `b` … (+N more)."""
    shown = [f"`{n}`" for n in names[:cap]]
    extra = len(names) - len(shown)
    return ", ".join(shown) + (f" (+{extra} more)" if extra > 0 else "")


def _history_lines(history: Optional[dict]) -> List[str]:
    """Hysteresis surface of the Slack message (``--history``).

    Transition lines render only for ACTIONABLE transitions (→FAILED,
    →CHRONIC, a re-earned HEALTHY, a human override releasing CHRONIC) —
    sub-threshold SUSPECT/RECOVERING wobble is the churn the FSM absorbs
    and must not re-emit here.  Standing CHRONIC offenders get their own
    line every message: a flapper sitting cordoned is an open incident,
    not a one-time event.
    """
    if not history:
        return []
    lines: List[str] = []
    thresholds = history.get("thresholds") or {}
    k = thresholds.get("cordon_after")
    m = thresholds.get("uncordon_after")
    f = thresholds.get("flap_threshold")
    w = thresholds.get("flap_window")
    for t in history.get("transitions", []):
        if not t.get("actionable"):
            continue
        node, to, frm = t.get("node"), t.get("to"), t.get("from")
        if to == "CHRONIC":
            lines.append(
                f"🔁 `{node}` went CHRONIC: ≥{f} verdict flips inside "
                f"{w} rounds — staying cordoned, auto-uncordon disabled "
                "until a human investigates"
            )
        elif to == "FAILED":
            lines.append(
                f"⛔ `{node}` health {frm} → FAILED "
                f"({k} consecutive bad round(s)): cordon-eligible"
            )
        elif to == "HEALTHY":
            lines.append(
                f"♻️ `{node}` health {frm} → HEALTHY "
                f"({m} consecutive good round(s)): quarantine can lift"
            )
        elif frm == "CHRONIC" and to == "RECOVERING":
            lines.append(
                f"🤝 `{node}` CHRONIC quarantine lifted out-of-band: now "
                f"RECOVERING — must re-earn HEALTHY ({m} good round(s))"
            )
    chronic = history.get("chronic") or []
    if chronic:
        lines.append(
            f"🔁 {len(chronic)} chronic flapper(s) held in quarantine "
            f"(excluded from auto-uncordon): {_named_list(chronic)}"
        )
    return lines


def format_slack_message(
    accel: Sequence[NodeInfo],
    ready: Sequence[NodeInfo],
    slices: Sequence[SliceInfo] = (),
    healthy: Optional[bool] = None,
    multislices: Sequence = (),
    cordon: Optional[dict] = None,
    uncordon: Optional[dict] = None,
    history: Optional[dict] = None,
    drain: Optional[dict] = None,
    remediation: Optional[dict] = None,
) -> str:
    """Slack mrkdwn message.

    Preserves the reference's structure (format_slack_message,
    check-gpu-node.py:114-139): tri-state ✅/⚠️/❌ header, then per-node
    bullets with backticked names and per-key breakdown — and appends
    slice-status lines for TPU slices.  The header honors the *overall*
    check outcome when given (``healthy``), so a strict-slice or probe
    failure can't be reported under a ✅ banner; ``healthy=None`` falls back
    to the reference's ready>0 rule.
    """
    if healthy is None:
        healthy = bool(ready)
    sick = [n for n in accel if not n.effectively_ready]
    # Header-level planned context, under the same conservative rule as the
    # trend split: EVERY sick node must carry a hard planned signal and
    # every incomplete slice the matching context — one unexplained fault
    # keeps the incident header.
    planned_only = (
        bool(sick)
        and all(n.sickness_planned for n in sick)
        and all(s.complete or s.planned_context for s in slices)
    )
    if ready and healthy:
        header = "✅ *Accelerator node check: OK*"
    elif ready and planned_only:
        header = (
            "⚠️ *Accelerator node check: degraded (planned maintenance "
            "in progress)*"
        )
    elif ready:
        header = "⚠️ *Accelerator node check: degraded (slice incomplete or chip probe failed)*"
    elif accel:
        header = "⚠️ *Accelerator node check: nodes found but none Ready*"
    else:
        header = "❌ *Accelerator node check: no accelerator nodes*"
    lines: List[str] = [header, summary_line(accel, ready)]
    # Small clusters keep the reference's exhaustive per-node bullets
    # (check-gpu-node.py:128-137).  Large fleets (a v5e-256 slice is 64 node
    # objects) would bury the signal and hit Slack's message limits, so
    # above the threshold only problem nodes are listed — and a mass outage
    # must not overflow Slack either, hence the cap (_cap_listing).
    # effectively_ready already folds in probe failures (detect.py).
    listed, omitted_problems, omitted_healthy = _cap_listing(
        accel, lambda n: not n.effectively_ready, threshold=20
    )
    for n in listed:
        keys = ", ".join(f"{k}:{v}" for k, v in sorted(n.breakdown.items()))
        line = f"• `{n.name}`: {_status(n)}, devices: {n.accelerators} ({keys})"
        if not n.ready and n.why_not_ready:
            # "Why NotReady" is the first question on the page; kubelet's own
            # reason (KubeletNotReady vs NetworkUnavailable vs
            # NodeStatusUnknown) routes the response differently.
            line += f" — {n.why_not_ready}"
        if n.events:
            # --node-events attached the kubectl-describe triage block;
            # surface the top (Warnings-first, newest-first) entry.
            ev = n.events[0]
            # Already whitespace-collapsed and capped by _summarize_events;
            # only Slack's tighter width applies here.  Events need not
            # carry a reason (only type/message are common to every
            # writer): fall back to the type, and drop the fragment
            # entirely rather than render a literal "last event None".
            msg = str(ev.get("message") or "")
            label = ev.get("reason") or ev.get("type")
            if label:
                line += f" — last event {label}" + (
                    f": {msg[:90]}{'…' if len(msg) > 90 else ''}" if msg else ""
                )
            elif msg:
                line += f" — last event: {msg[:90]}{'…' if len(msg) > 90 else ''}"
        if n.probe is not None and not n.probe.get("ok"):
            # "Failed HOW" is the first question on every alert; the error
            # is truncated so a mass outage still fits Slack's limits.
            line += " — chip probe FAILED"
            err = n.probe.get("error")
            if err:
                # Collapse whitespace: a traceback tail with newlines would
                # break the bullet into unbulleted message lines.
                err = " ".join(str(err).split())
                line += f" ({err[:120]}{'…' if len(err) > 120 else ''})"
        lines.append(line)
    planned_sick = [n for n in accel if n.sickness_planned]
    if planned_sick:
        # Triage context, pushed rather than discovered: these nodes are
        # down by schedule (maintenance drain / autoscaler), not by fault.
        words = sorted({n.planned_word for n in planned_sick})
        lines.append(
            f"🔧 {len(planned_sick)} unavailable node(s) under planned "
            f"disruption ({', '.join(words)}) — expected downtime, not a fault"
        )
    if omitted_problems:
        lines.append(f"• … {omitted_problems} more problem nodes omitted")
    if omitted_healthy:
        lines.append(f"• … {omitted_healthy} healthy nodes omitted")
    # Same scaling policy as the node bullets: a pool of many single-host
    # slices must not bury the signal or overflow Slack's limits.
    listed_slices, omitted_bad_slices, omitted_ok_slices = _cap_listing(
        slices, lambda s: not s.complete, threshold=12
    )
    for s in listed_slices:
        expected = s.expected_chips or s.chips
        state = "complete" if s.complete else _degraded(s)
        lines.append(
            f"• slice `{s.nodepool or s.accelerator or '?'}` "
            f"[{s.accelerator or '?'} {s.topology or '?'}]: "
            f"{s.ready_chips}/{expected} chips, {state}"
        )
    if omitted_bad_slices:
        lines.append(f"• … {omitted_bad_slices} more degraded slices omitted")
    if omitted_ok_slices:
        lines.append(f"• … {omitted_ok_slices} complete slices omitted")
    # Multislice groups scale with however operators label their fleet (a
    # per-job grouping label can mint one group per workload), so they get
    # the same cap-and-summarize policy as nodes and slices.
    listed_ms, omitted_bad_ms, omitted_ok_ms = _cap_listing(
        multislices, lambda m: not m.complete, threshold=12
    )
    for m in listed_ms:
        expected = m.expected_chips or m.chips
        state = "complete" if m.complete else "DEGRADED"
        lines.append(
            f"• multislice `{m.group}`: {len(m.slices)} slice(s), "
            f"{m.ready_chips}/{expected} chips, {state}"
        )
    if omitted_bad_ms:
        lines.append(f"• … {omitted_bad_ms} more degraded multislice groups omitted")
    if omitted_ok_ms:
        lines.append(f"• … {omitted_ok_ms} complete multislice groups omitted")
    # Quarantine actions taken this round: scheduling capacity changed (or
    # would have, under dry-run) — exactly what an operator wants pushed,
    # not discovered later in a JSON log.
    if cordon:
        prefix = "[dry-run] would auto-cordon" if cordon.get("dry_run") else "auto-cordoned"
        if cordon.get("cordoned"):
            lines.append(
                f"🚧 {prefix} (chip probe failed): {_named_list(cordon['cordoned'])}"
            )
        if cordon.get("skipped_over_cap"):
            lines.append(
                f"⚠️ cordon budget exhausted — left alone: "
                f"{_named_list(cordon['skipped_over_cap'])}"
            )
        if cordon.get("failed"):
            # The worst state: a known-bad node the PATCH could not cordon is
            # STILL accepting workloads — it must not hide in stderr/JSON.
            names = [f.get("node", "?") for f in cordon["failed"]]
            lines.append(
                f"❌ cordon FAILED — still schedulable: {_named_list(names)}"
            )
    if drain:
        prefix = (
            "[dry-run] would drain" if drain.get("dry_run") else "drained"
        )
        if drain.get("drained"):
            lines.append(
                f"🚧 {prefix} (evict-then-cordon, "
                f"{drain.get('pods_evicted', 0)} pod(s), grace "
                f"{drain.get('grace_seconds_total', 0)}s): "
                f"{_named_list(drain['drained'])}"
            )
        if drain.get("failed"):
            names = [f.get("node", "?") for f in drain["failed"]]
            lines.append(
                f"❌ drain FAILED — still schedulable: {_named_list(names)}"
            )
    if remediation and remediation.get("denials"):
        # Budget refusals, DEDUPED to (domain, reason): a 30-node storm
        # inside one slice is one standing refusal line, not 30 — the
        # per-node detail lives in the payload/event log.  The watch
        # loop's change fingerprint keys on the same pairs, so a standing
        # storm alerts once per transition, not once per round.
        pairs: dict = {}
        for d in remediation["denials"]:
            key = (d.get("domain") or d.get("node") or "?",
                   d.get("reason") or "?")
            pairs[key] = pairs.get(key, 0) + 1
        for (domain, reason), count in sorted(pairs.items()):
            lines.append(
                f"🛑 remediation refused [{reason}] in `{domain}`: "
                f"{count} node(s) held back — budget protecting capacity"
            )
    if uncordon:
        prefix = "[dry-run] would uncordon" if uncordon.get("dry_run") else "uncordoned"
        if uncordon.get("uncordoned"):
            lines.append(
                f"♻️ {prefix} (probe recovered): {_named_list(uncordon['uncordoned'])}"
            )
        if uncordon.get("failed"):
            names = [f.get("node", "?") for f in uncordon["failed"]]
            lines.append(
                f"⚠️ uncordon failed — capacity still quarantined: "
                f"{_named_list(names)}"
            )
    lines.extend(_history_lines(history))
    return "\n".join(lines)
