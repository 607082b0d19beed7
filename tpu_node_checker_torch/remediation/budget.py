"""The two names of the JAX package's ``remediation/budget.py`` that the
watch loop uses, each equal to its original: :func:`denial_fingerprint`,
the refusal identity behind ``--slack-on-change`` dedup, and
:func:`_domain_name`, the failure-domain name a node's mesh links are
qualified under in ``tpu_node_checker_mesh_link_duration_us{slice}``.
The budget engine itself is not ported yet, so a round's payload carries
no ``remediation`` block and its fingerprint is empty.
"""

from __future__ import annotations

from typing import List, Tuple


def denial_fingerprint(denials: List[dict]) -> Tuple:
    """Refusal identity for Slack dedup: the set of (domain, reason)
    pairs, node names folding away (the domain is the failure unit) — one
    alert per standing condition, not one per refused node per round.
    The ONE definition: the watch loop's change fingerprint and the
    engine's round records both ride it."""
    return tuple(sorted({
        (d.get("domain") or d.get("node") or "", d.get("reason") or "")
        for d in denials
    }))


def _domain_name(key: Tuple) -> str:
    if key[0] == "__single__":
        return f"single/{key[1]}"
    return "/".join(str(part or "-") for part in key)
