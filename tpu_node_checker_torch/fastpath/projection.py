"""Projection decoding and content-addressed node reuse for the relist path.

A copy of the JAX package's ``fastpath/projection.py``, held equal to it by
``tests/test_torch_copies.py``:

* **Projection grammar** (:data:`GRADING_PROJECTION`): the fields
  ``detect.extract_node_info`` reads, with conditions stripped of their
  heartbeat timestamps, so a projected node grades as the full object does.
* **Byte-level page reuse** (:class:`ListProjector`): each LIST page is
  compared with the previous walk's page (whole body, then common prefix
  and suffix); items inside unchanged byte-runs are reused by reference,
  and only the changed window is decoded, item by item, with
  ``json.JSONDecoder.raw_decode``.
* **Content-addressed grading digests** (:func:`grading_digest`): a
  BLAKE2b over ``watchstream.grading_view``; an unchanged digest lets
  ``checker.run_check`` reuse the node's cached
  :class:`~tpu_node_checker_torch.detect.NodeInfo` and payload entry
  (:class:`NodeReuseCache`) when :func:`reuse_allowed` says no flag
  attaches per-round state.

**Fallback contract**: any surprise in the scan abandons the fast path for
that page and decodes it through :func:`oracle_decode_page` (one
``json.loads``), which yields the same :class:`ProjectedNode` contract.
``TNC_PROJECTION=off`` sends every page through it.

Thread contract: a :class:`ListProjector` (and its :class:`NodeReuseCache`)
is owned by one KubeClient and touched only by the round's thread; the
prefetch thread in ``cluster._paged_list`` only fetches.
"""

from __future__ import annotations

import json
import os
from hashlib import blake2b
from typing import Dict, FrozenSet, List, Optional, Tuple

# The projection grammar — the grading-view field set, one declaration the
# docs, the dict pruner and the tests all share.
GRADING_PROJECTION = {
    "metadata": ("name", "labels", "annotations"),
    "spec": ("unschedulable", "taints"),
    "status": ("allocatable", "capacity", "conditions"),
}
# Per-condition fields that survive projection: everything extract/grading
# reads, minus the heartbeat timestamps that churn every ~10s and would
# otherwise dirty every node on every relist.
CONDITION_FIELDS = ("type", "status", "reason", "message")

_DIGEST_SIZE = 16
# Pages cached per walk position; past this the walk still decodes
# correctly, it just stops keeping reuse state (a >128k-node single walk).
_MAX_CACHED_PAGES = 256

_decoder = json.JSONDecoder()
_raw_decode = _decoder.raw_decode
_WS = " \t\r\n"


class ProjectionError(ValueError):
    """The selective walk met a shape it does not handle — the caller
    falls back to the ``json.loads`` oracle for the page."""


def projection_enabled() -> bool:
    """Kill switch: ``TNC_PROJECTION=off`` forces every page through the
    oracle decoder (bench uses it to pin fast-path/oracle payload
    identity; an operator can use it to bisect a suspected scan bug)."""
    return os.environ.get("TNC_PROJECTION", "").lower() not in (
        "off", "0", "false"
    )


def project_node_doc(node) -> dict:
    """Prune one raw node dict to the projection grammar.

    The dict-side twin of the byte-level walk — also the shape the
    fallback path produces, so every consumer sees one contract.  Sections
    that are missing or not dicts are dropped (``detect``'s ``_as_dict``
    coercion reads them as ``{}`` either way); kept values are shared by
    reference, not copied.
    """
    node = node if isinstance(node, dict) else {}
    out: dict = {}
    for section, keys in GRADING_PROJECTION.items():
        src = node.get(section)
        if not isinstance(src, dict):
            continue
        dst: dict = {}
        for k in keys:
            if k not in src:
                continue
            v = src[k]
            if k == "conditions" and isinstance(v, list):
                v = [
                    {ck: c[ck] for ck in CONDITION_FIELDS if ck in c}
                    if isinstance(c, dict)
                    else c
                    for c in v
                ]
            dst[k] = v
        out[section] = dst
    return out


def grading_digest(doc: dict) -> bytes:
    """16-byte content address of one node's grading view.

    Defined ON ``watchstream.grading_view`` (the one projection of what
    grading reads), so "equal digest" means "grades identically" by
    construction: heartbeat-only churn hashes the same, and any field the
    view covers hashes differently.  ``repr`` is the canonical encoding —
    C-speed, type-distinguishing (``"1"`` vs ``1``), and stable for the
    dicts as decoded (key order differences only ever cause a spurious
    re-extract, never a stale reuse).
    """
    from tpu_node_checker_torch.watchstream import grading_view

    return blake2b(
        repr(grading_view(doc)).encode("utf-8", "surrogatepass"),
        digest_size=_DIGEST_SIZE,
    ).digest()


class ProjectedNode:
    """One node off the wire, reduced to what grading needs.

    ``doc`` is the pruned dict (projection grammar), ``digest`` its
    grading-view content address, ``name`` decoded eagerly because every
    reuse cache keys on it (``None`` when the object carries no usable
    name — such nodes are re-extracted every round, never cached).
    """

    __slots__ = ("name", "digest", "doc")

    def __init__(self, name: Optional[str], digest: bytes, doc: dict):
        self.name = name
        self.digest = digest
        self.doc = doc


def _project_item(item) -> ProjectedNode:
    doc = project_node_doc(item)
    meta = doc.get("metadata")
    name = meta.get("name") if isinstance(meta, dict) else None
    if not isinstance(name, str) or not name:
        name = None
    return ProjectedNode(name, grading_digest(doc), doc)


class ProjectedFleet(List[ProjectedNode]):
    """A full LIST walk's projected nodes, plus the walk's metadata and
    the reuse cache the decode rode — what ``run_check``'s fast path
    consumes in place of raw node dicts.  ``pages`` (optional) carries the
    walk's page entries so seed-time name maps merge prebuilt per-page
    fragments instead of re-walking every node."""

    def __init__(self, nodes, resource_version: Optional[str],
                 reuse: "NodeReuseCache", pages=None):
        super().__init__(nodes)
        self.resource_version = resource_version
        self.reuse = reuse
        self.pages = pages

    def docs(self) -> List[dict]:
        """The pruned dicts, for consumers that want plain nodes."""
        return [p.doc for p in self]

    def seed_maps(self) -> Tuple[Dict[str, dict], Dict[str, bytes]]:
        """``({name: doc}, {name: digest})`` for the whole walk — merged
        from cached per-page fragments when the page entries cover exactly
        this fleet (dict.update at C speed; a tier-0-reused page's
        fragments were built on a previous walk), one Python pass
        otherwise."""
        pages = self.pages
        if pages and sum(len(e.nodes) for e in pages) == len(self):
            docs: Dict[str, dict] = {}
            views: Dict[str, bytes] = {}
            for entry in pages:
                d, v = entry.fragments()
                docs.update(d)
                views.update(v)
            return docs, views
        named = [p for p in self if p.name is not None]
        return (
            {p.name: p.doc for p in named},
            {p.name: p.digest for p in named},
        )


def oracle_decode_page(resp) -> Tuple[list, dict]:
    """THE sanctioned full-body decode on the LIST hot path.

    Every page the projector cannot (or is configured not to) walk lands
    here: one ``json.loads`` of the body — or ``resp.json()`` for
    session doubles that carry no raw bytes — with the same null/shape
    tolerance the old ``_paged_list`` decode had.  tnc-lint TNC018 bans
    full-body decodes on the LIST path everywhere but this module, so the
    fallback cannot quietly multiply.
    """
    body = getattr(resp, "content", None)
    doc = json.loads(body) if body is not None else resp.json()
    if not isinstance(doc, dict):
        return (doc if isinstance(doc, list) else []), {}
    items = doc.get("items") or []
    meta = doc.get("metadata") or {}
    return (
        items if isinstance(items, list) else [],
        meta if isinstance(meta, dict) else {},
    )


def peek_continue(body: Optional[bytes]) -> Optional[str]:
    """Best-effort extraction of the list's ``continue`` token from raw
    page bytes — what lets the next page's fetch start BEFORE this page
    is decoded (the fetch/decode pipeline).

    Trust-but-verify: the walk compares this peek against the decoded
    metadata's authoritative token and discards the prefetch on mismatch
    (a ``"continue"`` key inside some annotation string can only cost one
    wasted request, never a wrong page in the result).  ``None`` — no
    match, an escaped or non-ASCII token — just means no prefetch.
    """
    if not body:
        return None
    i = body.rfind(b'"continue":')
    if i < 0:
        return None
    j = i + 11  # len(b'"continue":')
    n = len(body)
    while j < n and body[j] in b" \t\r\n":
        j += 1
    if j >= n or body[j] != 0x22:
        return None
    k = body.find(b'"', j + 1)
    if k < 0:
        return None
    token = body[j + 1:k]
    if not token or b"\\" in token:
        return None
    try:
        return token.decode("ascii")
    except UnicodeDecodeError:
        return None


# --------------------------------------------------------------------------- #
# C-speed affix math
# --------------------------------------------------------------------------- #


def _common_prefix(a: str, b: str) -> int:
    """Length of the longest common prefix — chunked slice equality
    (memcmp under the hood), halving into the first differing chunk."""
    n = min(len(a), len(b))
    lo = 0
    while lo < n:
        step = min(1 << 16, n - lo)
        if a[lo:lo + step] == b[lo:lo + step]:
            lo += step
            continue
        while step > 1:
            half = step // 2
            if a[lo:lo + half] == b[lo:lo + half]:
                lo += half
                step -= half
            else:
                step = half
        return lo
    return lo


def _common_suffix(a: str, b: str, limit: int) -> int:
    """Longest common suffix, capped at ``limit`` so the suffix never
    overlaps the already-claimed prefix region."""
    n = min(len(a), len(b), limit)
    la, lb = len(a), len(b)
    lo = 0
    while lo < n:
        step = min(1 << 16, n - lo)
        if a[la - lo - step:la - lo] == b[lb - lo - step:lb - lo]:
            lo += step
            continue
        while step > 1:
            half = step // 2
            if a[la - lo - half:la - lo] == b[lb - lo - half:lb - lo]:
                lo += half
                step -= half
            else:
                step = half
        return lo
    return lo


class _PageEntry:
    """One walk position's cached page: raw bytes (tier-0 equality), text
    + per-item spans (affix reuse), the projected nodes, and the list
    metadata.  ``text``/``spans`` are ``None`` for fallback-decoded pages
    — tier-0 still applies, affix does not."""

    __slots__ = ("body", "text", "spans", "nodes", "meta",
                 "frag_docs", "frag_views")

    def __init__(self, body, text, spans, nodes, meta):
        self.body = body
        self.text = text
        self.spans = spans
        self.nodes = nodes
        self.meta = meta
        # Lazy per-page seed fragments ({name: doc} / {name: digest}) —
        # built once per decoded page, carried with the entry across
        # tier-0 reuses, merged at C speed by ProjectedFleet.seed_maps.
        self.frag_docs = None
        self.frag_views = None

    def fragments(self):
        if self.frag_docs is None:
            docs: Dict[str, dict] = {}
            views: Dict[str, bytes] = {}
            for p in self.nodes:
                if p.name is not None:
                    docs[p.name] = p.doc
                    views[p.name] = p.digest
            self.frag_docs = docs
            self.frag_views = views
        return self.frag_docs, self.frag_views


class ListProjector:
    """Per-client page cache driving the three reuse tiers.

    ``decode_page(resp, index)`` is the page decoder ``cluster._paged_list``
    calls for node LISTs; ``index`` is the page's position in the walk
    (restarts reset to 0 — a restarted walk simply re-decodes).  Stats are
    plain monotonic counters, read by bench and tests.
    """

    def __init__(self):
        self.pages: Dict[int, _PageEntry] = {}
        self.reuse = NodeReuseCache()
        # Entries of the walk in progress (reset at page 0, consumed via
        # take_walk_pages by list_nodes_projected) — what lets the seed
        # path merge prebuilt per-page fragments instead of re-walking 5k
        # ProjectedNodes.  Owned by the round thread, like all decoding.
        self._walk_pages: List[_PageEntry] = []
        self.stats = {
            "pages_decoded": 0,      # full or windowed walks
            "pages_unchanged": 0,    # tier-0 whole-body equality hits
            "pages_fallback": 0,     # oracle decodes (error or disabled)
            "items_decoded": 0,
            "items_reused": 0,       # by-reference via affix runs
        }

    def take_walk_pages(self) -> List[_PageEntry]:
        """The finished walk's page entries, in order (and clear the
        slate for the next walk).  Cache positions past the walk's end are
        evicted here: a fleet that shrank (or a changed selector) must not
        pin megabytes of stale page bodies on the long-lived client."""
        pages = self._walk_pages
        self._walk_pages = []
        for index in [k for k in self.pages if k >= len(pages)]:
            del self.pages[index]
        return pages

    def decode_page(self, resp, index: int) -> Tuple[list, dict]:
        if index == 0:
            self._walk_pages = []  # a (re)started walk
        body = getattr(resp, "content", None)
        if body is None or not projection_enabled():
            return self._fallback(resp, body, index)
        entry = self.pages.get(index)
        if entry is not None and entry.body == body:
            self.stats["pages_unchanged"] += 1
            self._walk_pages.append(entry)
            return entry.nodes, entry.meta
        try:
            text = body.decode("utf-8")
            hook = self._affix_hook(entry, text) if entry is not None else None
            raw_items, spans, meta = _decode_page_text(text, hook)
        except (ValueError, IndexError, TypeError, KeyError, RecursionError):
            # The fallback contract: ANY walk surprise — bad UTF-8, a shape
            # the walker refuses, decoder errors, affix misalignment —
            # downgrades this page to the oracle, never to a wrong answer.
            return self._fallback(resp, body, index)
        nodes: List[ProjectedNode] = []
        reused = 0
        for item in raw_items:
            if type(item) is ProjectedNode:
                nodes.append(item)
                reused += 1
            else:
                nodes.append(_project_item(item))
        self.stats["pages_decoded"] += 1
        self.stats["items_reused"] += reused
        self.stats["items_decoded"] += len(nodes) - reused
        fresh = _PageEntry(body, text, spans, nodes, meta)
        if index < _MAX_CACHED_PAGES:
            self.pages[index] = fresh
        self._walk_pages.append(fresh)
        return nodes, meta

    def _fallback(self, resp, body, index: int) -> Tuple[list, dict]:
        items, meta = oracle_decode_page(resp)
        nodes = [_project_item(it) for it in items]
        self.stats["pages_fallback"] += 1
        self.stats["items_decoded"] += len(nodes)
        entry = _PageEntry(body, None, None, nodes, meta)
        if body is not None and index < _MAX_CACHED_PAGES:
            # Tier-0 equality still works next walk; affix needs spans and
            # stays off for this page until a clean walk lands.
            self.pages[index] = entry
        self._walk_pages.append(entry)
        return nodes, meta

    def _affix_hook(self, entry: _PageEntry, text: str):
        """Byte-run reuse map for a changed page: positions whose item
        bytes provably equal a previous item's bytes (entirely inside the
        common prefix or common suffix) resolve to that item by reference."""
        old_text, spans = entry.text, entry.spans
        if old_text is None or spans is None or not spans:
            return None
        p = _common_prefix(old_text, text)
        max_q = min(len(old_text), len(text)) - p
        q = _common_suffix(old_text, text, max_q) if max_q > 0 else 0
        shift = len(text) - len(old_text)
        suffix_floor = len(old_text) - q
        by_start: Dict[int, int] = {}
        by_start_shifted: Dict[int, int] = {}
        for j, (a, b) in enumerate(spans):
            if b <= a:
                continue  # degenerate span (non-array items) — never reuse
            if b <= p:
                by_start[a] = j
            if a >= suffix_floor:
                by_start_shifted[a + shift] = j
        if not by_start and not by_start_shifted:
            return None
        nodes = entry.nodes

        def hook(pos: int):
            j = by_start.get(pos)
            if j is not None and spans[j][1] <= p:
                # text[pos:end] == old_text[pos:end] (common prefix) — the
                # item's bytes, noise runs included, are untouched.
                return nodes[j], spans[j][1]
            j = by_start_shifted.get(pos)
            if j is not None:
                return nodes[j], spans[j][1] + shift
            return None

        return hook


def _decode_page_text(text: str, reuse_hook=None):
    """Walk one LIST page: items one at a time (reuse hook first, C
    ``raw_decode`` otherwise), every other top-level value via the C
    scanner.  Returns ``(items, item_spans, meta)`` where reused items are
    the previous walk's :class:`ProjectedNode` objects themselves.

    Raises on anything unexpected; the caller owns the oracle fallback.
    """
    n = len(text)
    i = 0
    while text[i] in _WS:
        i += 1
    if text[i] != "{":
        raise ProjectionError("LIST page is not a JSON object")
    i += 1
    while text[i] in _WS:
        i += 1
    items: list = []
    spans: List[Tuple[int, int]] = []
    meta: dict = {}
    if text[i] == "}":
        return items, spans, meta
    while True:
        key, i = _raw_decode(text, i)
        if not isinstance(key, str):
            raise ProjectionError("non-string object key")
        while text[i] in _WS:
            i += 1
        if text[i] != ":":
            raise ProjectionError("missing ':'")
        i += 1
        while text[i] in _WS:
            i += 1
        if key == "items" and text[i] == "[":
            # Duplicate-key semantics are last-wins (what json.loads does
            # for objects): a second "items" key replaces the first.
            items = []
            spans = []
            i += 1
            while text[i] in _WS:
                i += 1
            if text[i] == "]":
                i += 1
            else:
                while True:
                    start = i
                    hit = reuse_hook(start) if reuse_hook is not None else None
                    if hit is not None:
                        node, end = hit
                        items.append(node)
                        spans.append((start, end))
                        i = end
                    else:
                        obj, i = _raw_decode(text, i)
                        items.append(obj)
                        spans.append((start, i))
                    while text[i] in _WS:
                        i += 1
                    c = text[i]
                    if c == ",":
                        i += 1
                        while text[i] in _WS:
                            i += 1
                        continue
                    if c == "]":
                        i += 1
                        break
                    raise ProjectionError("bad items separator")
        else:
            value, i = _raw_decode(text, i)
            if key == "items":
                # Non-array "items" — null (Go-serialized empty lists) or
                # API garbage — grades as no items, like the oracle's
                # `.get("items") or []`.  Last-wins like the array branch
                # above: a duplicate key replaces earlier items.
                items = []
                spans = []
            elif key == "metadata":
                # Last-wins here too: a non-dict duplicate degrades to {}
                # exactly like the oracle's `.get("metadata") or {}`.
                meta = value if isinstance(value, dict) else {}
        while i < n and text[i] in _WS:
            i += 1
        if i >= n:
            raise ProjectionError("unterminated page object")
        c = text[i]
        if c == ",":
            i += 1
            while text[i] in _WS:
                i += 1
            continue
        if c == "}":
            return items, spans, meta
        raise ProjectionError("bad page separator")


class NodeReuseCache:
    """Content-addressed NodeInfo + payload-entry reuse for ``run_check``.

    Keyed by node name; a node whose grading digest is unchanged since the
    last round reuses its extracted :class:`NodeInfo` AND its serialized
    payload entry BY REFERENCE (both are pure functions of the digest's
    preimage).  The checker only engages this cache when no per-round
    attachment source (probe, probe reports, node events, history) is
    configured — those mutate NodeInfo per round, so reuse would leak one
    round's attachments into the next.

    ``select`` mirrors ``detect.select_accelerator_nodes``'s contract
    (accel in input order, ready = kubelet-Ready AND schedulable) and
    additionally returns the pre-built entries list plus the changed-name
    set (changed ∪ removed) the snapshot delta publisher keys on.
    """

    def __init__(self):
        self._nodes: Dict[str, tuple] = {}
        self._registry_key: Optional[tuple] = None
        self.extracts = 0  # monotonic: test seam for the O(changes) floor

    @staticmethod
    def _registry_signature(registry) -> tuple:
        # A cached NodeInfo is a function of (grading bytes, registry): a
        # changed --resource-key set must re-extract everything, digest
        # equality notwithstanding.
        return tuple(
            (m.pattern, m.family, m.vendor) for m in (registry or ())
        )

    def select(self, fleet, registry):
        from tpu_node_checker_torch.detect import extract_node_info
        from tpu_node_checker_torch.report import _node_entry

        registry_key = self._registry_signature(registry)
        if registry_key != self._registry_key:
            self._nodes = {}
            self._registry_key = registry_key

        accel: list = []
        entries: list = []
        changed: set = set()
        fresh: Dict[str, tuple] = {}
        for p in fleet:
            name = p.name
            cached = self._nodes.get(name) if name is not None else None
            if cached is not None and cached[0] == p.digest:
                _, info, entry = cached
            else:
                info = extract_node_info(p.doc, registry)
                self.extracts += 1
                entry = (
                    _node_entry(info)
                    if (info.accelerators > 0 or info.families)
                    else None
                )
                if name is not None:
                    changed.add(name)
            if name is not None:
                fresh[name] = (p.digest, info, entry)
            if info.accelerators > 0 or info.families:
                accel.append(info)
                entries.append(entry)
        removed = frozenset(self._nodes) - frozenset(fresh)
        self._nodes = fresh
        ready = [i for i in accel if i.ready and i.schedulable]
        return accel, ready, entries, frozenset(changed) | removed


def reuse_allowed(args) -> bool:
    """True when no flag attaches per-round state to NodeInfo objects —
    the precondition for reusing them (and their entries) by reference.
    Projection decode itself is unconditional; only the info/entry cache
    is gated."""
    return not any(
        getattr(args, flag, None)
        for flag in (
            "probe",
            "probe_results",
            "node_events",
            "history",
            "cordon_failed",
            "uncordon_recovered",
        )
    )
