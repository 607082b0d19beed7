"""TPU generation detection, shared by labels and PJRT device_kind strings.

This package's copy of the JAX package's module of the same name: the port
imports nothing of the JAX package, so it keeps its own.  Keep the two in
step; tests/test_torch_probe.py holds them equal.

One tiny pure module so the control plane (``checker`` — label vs enumerated
kind cross-check) and the data plane (``probe.floors`` — per-generation
performance expectations) resolve generations identically and cannot drift.

Spelling varies across libtpu versions ("TPU v5 lite" vs "TPU v5e"), so a
generation is a SET of alias substrings.  Only KNOWN generations participate;
unknown or too-vague strings (a bare "TPU v5" or "TPU v6" names no generation
here) resolve to nothing rather than guess — the strings come from two
independent vendors' surfaces and must never be able to cordon (or floor-fail)
a fleet by renaming.
"""

from __future__ import annotations

GENERATION_ALIASES = {
    "v2": ("v2",),
    "v3": ("v3",),
    "v4": ("v4",),
    "v5e": ("v5 lite", "v5e", "v5lite"),
    "v5p": ("v5p",),
    # As specific as the v5 set: a bare "v6" (or a hypothetical future "v6p")
    # resolves to nothing rather than satisfying a tpu-v6e-slice label —
    # the never-guess policy that keeps vague strings silent.
    "v6e": ("v6 lite", "v6e", "v6lite"),
}

# GKE ``cloud.google.com/gke-tpu-accelerator`` label values → generation.
LABEL_GENERATION = {
    "tpu-v4-podslice": "v4",
    "tpu-v5-lite-podslice": "v5e",
    "tpu-v5-lite-device": "v5e",
    "tpu-v5p-slice": "v5p",
    "tpu-v6e-slice": "v6e",
}


def generations_of(kind: str) -> set:
    """Generations a PJRT ``device_kind`` string clearly names (often 0 or 1)."""
    k = str(kind).lower()
    return {
        gen
        for gen, aliases in GENERATION_ALIASES.items()
        if any(a in k for a in aliases)
    }


def generation_of_kinds(kinds) -> str | None:
    """The single generation a device_kind list resolves to, else ``None``.

    ``None`` for empty, vague, unknown, or *mixed* kind lists — a host
    enumerating two generations is its own problem (kind_mismatch surfaces
    it); guessing one of them for floor grading would grade against the
    wrong spec sheet.
    """
    seen: set = set()
    for k in kinds or ():
        seen |= generations_of(k)
    return next(iter(seen)) if len(seen) == 1 else None
