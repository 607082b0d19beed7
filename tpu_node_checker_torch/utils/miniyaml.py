"""Conservative YAML-subset parser for kubeconfig files.

A copy of the JAX package's ``utils/miniyaml.py``, held equal to it by
``tests/test_torch_copies.py``.  It parses the block-style mappings, lists,
scalars, comments and quoted scalars that ``kubectl`` writes, and raises
:class:`UnsupportedYAML` on anything else (flow collections other than
``{}``/``[]``, anchors, aliases, merges, block scalars, tags, directives,
explicit keys, several documents, tabs); the caller then falls back to
PyYAML where it is installed.  Plain scalars convert as in YAML 1.1 core:
``true``/``false``/``null``/``~``, base-10 ints and floats.
"""

from __future__ import annotations

import json
import re


class UnsupportedYAML(ValueError):
    """Input uses YAML beyond the supported subset — use a real parser."""


_BAIL_LINE = re.compile(r"^\s*(\?\s|%|---|\.\.\.)|\t")
# ASCII-only digits throughout: PyYAML's resolver does not treat Unicode
# digits (e.g. Arabic-Indic) as numbers, so neither may this parser.
_INT = re.compile(r"^[+-]?[0-9]+$")
# YAML 1.1 floats (PyYAML's resolver) REQUIRE a signed exponent, and the
# dot-leading form (".5") is UNSIGNED there ("-.5" is a string); both rules
# must hold here too.
_FLOAT = re.compile(r"^([+-]?[0-9]+\.[0-9]*|\.[0-9]+)([eE][+-][0-9]+)?$")
# Scalars PyYAML's 1.1 resolver types differently from the simple rules
# below (octal/hex/binary/underscored numbers, sexagesimal ints AND floats,
# dates/timestamps — including the space-separated form — infinities):
# bail to the real parser rather than silently disagree.
_EXOTIC_NUMERIC = re.compile(
    r"^[+-]?("
    r"0[0-9xXoObB_]\S*"      # 010 octal / 0x1F / 0b1 / 0_1
    r"|[0-9_.]*_[0-9_.]*"    # 1_000 / 1_000.5 underscored numbers
    r"|[0-9]+(:[0-9_.]+)+"   # 1:30 / 1:30.5 sexagesimal
    r"|[0-9]{4}-[0-9]{2}-[0-9]{2}.*"  # anything date-led (incl. timestamps)
    r"|\.(inf|Inf|INF)"
    r")$|^\.(nan|NaN|NAN)$",
    re.ASCII | re.DOTALL,
)
# YAML 1.1 booleans/null as PyYAML resolves them: lowercase, Titlecase and
# UPPERCASE only — "tRue" is a STRING there and must stay one here.
_TRUE = frozenset(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"))
_FALSE = frozenset(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"))
_NULL = frozenset(("null", "Null", "NULL", "~"))


def _scalar(raw: str):
    """One plain/quoted scalar; raises UnsupportedYAML on exotic forms."""
    # ASCII-space strip only: PyYAML keeps exotic Unicode whitespace (NBSP
    # etc.) as scalar content, so stripping it would silently disagree.
    s = raw.strip(" ")
    if s == "" or s in _NULL:
        return None
    if s[0] in "\"'":
        if len(s) < 2 or s[-1] != s[0]:
            raise UnsupportedYAML(f"unterminated quote: {raw!r}")
        body = s[1:-1]
        if s[0] == "'":
            if "'" in body.replace("''", ""):
                raise UnsupportedYAML(f"nested quote: {raw!r}")
            return body.replace("''", "'")
        try:
            # Double-quoted YAML escapes are (for kubeconfig purposes) the
            # JSON ones; json.loads rejects anything beyond them.
            return json.loads(s)
        except json.JSONDecodeError as exc:
            raise UnsupportedYAML(f"unsupported escape in {raw!r}") from exc
    if s == "{}":
        return {}
    if s == "[]":
        return []
    if s[0] in "&*!|>{[]}@`,%" or s.startswith("<<") or s.startswith("- "):
        # "]" / "}" included: PyYAML REJECTS a plain scalar starting with a
        # closing flow indicator, and this parser must never succeed where
        # the real one errors.
        raise UnsupportedYAML(f"construct beyond the subset: {raw!r}")
    if s in ("-", "="):
        # PyYAML REJECTS a bare "-" ("sequence entries are not allowed
        # here") and errors constructing the 1.1 "=" value type; accepting
        # either would "succeed" on input the real parser refuses.
        raise UnsupportedYAML(f"scalar PyYAML rejects: {raw!r}")
    if ": " in s or s.endswith(":"):
        # "a: b: c" is a PyYAML parse ERROR (mapping values not allowed
        # in a plain scalar); accepting it here would "succeed" on input
        # the real parser rejects.
        raise UnsupportedYAML(f"colon-space inside plain scalar: {raw!r}")
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _EXOTIC_NUMERIC.match(s):
        raise UnsupportedYAML(f"scalar beyond the subset resolver: {raw!r}")
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    return s


def _strip_comment(line: str) -> str:
    """Drop a trailing comment (a ``#`` outside quotes, preceded by space).

    Quote characters are quote *delimiters* only where a scalar can start
    (line start, after ``: ``, after ``- ``); an apostrophe inside a plain
    scalar (``x'y``) is content to YAML, and treating it as a quote opener
    would silently swallow (or keep) comment text.  A quote appearing
    mid-scalar bails instead — PyYAML handles those files.
    """
    in_q = None
    scalar_start = True  # a scalar may begin at the next non-space char
    i = 0
    while i < len(line):
        c = line[i]
        if in_q:
            if c == "\\" and in_q == '"':
                i += 2  # skip the escaped char
                continue
            if c == in_q:
                if in_q == "'" and i + 1 < len(line) and line[i + 1] == "'":
                    i += 2  # '' escape stays inside the single-quoted scalar
                    continue
                in_q = None
            i += 1
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        if c in "\"'":
            if not scalar_start:
                raise UnsupportedYAML(f"quote inside a plain scalar: {line!r}")
            in_q = c
            scalar_start = False
        elif c == " ":
            pass  # spaces never end the scalar-start window
        elif c == ":" and (i + 1 == len(line) or line[i + 1] == " "):
            scalar_start = True  # "key: " — a value scalar may start next
        elif c == "-" and scalar_start and (i + 1 == len(line) or line[i + 1] == " "):
            pass  # "- " list marker keeps the window open
        else:
            scalar_start = False
        i += 1
    if in_q:
        # A quote spanning lines is a multiline scalar — beyond the subset.
        raise UnsupportedYAML(f"unterminated quote on line: {line!r}")
    return line


# re.ASCII: \s must mean ASCII whitespace — Unicode spaces are key/scalar
# content to PyYAML.
_KEY = re.compile(r"^(?P<key>[^\s:#][^:]*?):(?: (?P<val>.*))?$", re.ASCII)


def _parse_block(lines, i, indent):
    """Parse one block node starting at ``lines[i]`` with exact ``indent``.

    Returns ``(node, next_i)``.  ``lines`` holds ``(indent, content)``
    pairs, comments/blanks already removed.
    """
    if i >= len(lines) or lines[i][0] < indent:
        return None, i  # empty block value
    if lines[i][0] > indent:
        raise UnsupportedYAML(f"unexpected indent at: {lines[i][1]!r}")
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out_list = []
        while i < len(lines) and lines[i][0] == indent and (
            lines[i][1].startswith("- ") or lines[i][1] == "-"
        ):
            # ASCII-space strip only (cf. _scalar): Unicode whitespace is
            # scalar content to PyYAML.
            rest = lines[i][1][2:].strip(" ") if lines[i][1] != "-" else ""
            if rest and (_KEY.match(rest) or rest.startswith("- ") or rest == "-"):
                # "- key: value" (item is a mapping with an inline first
                # entry) or "- - x" (item is a nested list): rewrite the
                # line as the inner content at the deeper indent and parse
                # the block from there.
                item_indent = indent + 2
                lines[i] = (item_indent, rest)
                node, i = _parse_block(lines, i, item_indent)
                out_list.append(node)
            elif rest:
                out_list.append(_scalar(rest))
                i += 1
            else:
                # "-" alone: a nested block (list-of-lists or mapping).
                i += 1
                node, i = _parse_block(lines, i, indent + 2)
                out_list.append(node)
        return out_list, i
    out_map: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        content = lines[i][1]
        if content.startswith("- ") or content == "-":
            break
        m = _KEY.match(content)
        if not m:
            raise UnsupportedYAML(f"unrecognized line: {content!r}")
        key = _scalar(m.group("key"))
        if isinstance(key, (dict, list)):
            # "{}: v" — an unhashable key must refuse (and reach the real
            # parser via the fallback), not crash with a bare TypeError.
            raise UnsupportedYAML(f"non-scalar mapping key: {m.group('key')!r}")
        val = m.group("val")
        i += 1
        if val is None or val.strip() == "":
            # A nested block: deeper indent, OR — the kubectl convention —
            # a list whose "- " items sit at the SAME indent as the key
            # (they cannot be sibling keys, so ownership is unambiguous).
            if i < len(lines) and (
                lines[i][0] > indent
                or (
                    lines[i][0] == indent
                    and (lines[i][1].startswith("- ") or lines[i][1] == "-")
                )
            ):
                node, i = _parse_block(lines, i, lines[i][0])
            else:
                node = None
            out_map[key] = node
        else:
            out_map[key] = _scalar(val)
    return out_map, i


def safe_load_subset(text: str):
    """Parse the kubeconfig YAML subset; raise :class:`UnsupportedYAML`
    for anything beyond it (the caller falls back to a real parser)."""
    raw_lines = text.splitlines()
    # One optional leading document marker is fine; more is a stream.
    if raw_lines and raw_lines[0].strip() == "---":
        raw_lines = raw_lines[1:]
    lines = []
    for line in raw_lines:
        line = line.rstrip("\r")
        if _BAIL_LINE.search(line):
            raise UnsupportedYAML(f"construct beyond the subset: {line!r}")
        line = _strip_comment(line)
        # ASCII-space strip only (cf. _scalar): Unicode whitespace is
        # scalar content to PyYAML, never indentation.
        stripped = line.strip(" ")
        if not stripped:
            continue
        lines.append((len(line) - len(line.lstrip(" ")), stripped))
    if not lines:
        return None
    node, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise UnsupportedYAML(f"trailing content at: {lines[i][1]!r}")
    return node
