"""Minimal ``.env`` loader.

The reference calls ``dotenv.load_dotenv()`` at entry (check-gpu-node.py:331;
template ``.env-template:1`` holds ``SLACK_WEBHOOK_URL``).  ``python-dotenv``
is not a baked-in dependency here, so the framework ships the subset that
library actually provides for this use case:

* ``KEY=VALUE`` lines, ``#`` comment lines, optional ``export`` prefix;
* single/double quoting; **multiline** quoted values (a quote left open
  continues onto following lines);
* escape decoding inside double quotes (``\\n``, ``\\t``, ``\\"``, …);
* ``${VAR}`` interpolation in unquoted and double-quoted values (from the
  process environment, then keys earlier in the file) — single quotes stay
  literal, like a shell;
* unquoted trailing `` # comments`` stripped;
* like the upstream default, existing environment variables are **not**
  overridden.

Unsupported forms no longer fail silently: a line with no ``=`` outside a
multiline value is reported to stderr (once per load) instead of vanishing.

A copy of the JAX package's ``utils/env.py``, held equal to it by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Optional

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'", "\\": "\\"}
_VAR_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}")


def _interpolate(value: str, local: dict) -> str:
    """``${VAR}`` from the environment, then earlier keys in this file."""
    return _VAR_RE.sub(
        lambda m: os.environ.get(m.group(1), local.get(m.group(1), "")), value
    )


def _decode_escapes(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value) and value[i + 1] in _ESCAPES:
            out.append(_ESCAPES[value[i + 1]])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _closing_quote(text: str, quote: str) -> int:
    """Index of the first unescaped ``quote`` in ``text``, or -1."""
    i = 0
    while i < len(text):
        if text[i] == "\\" and quote == '"':
            i += 2
            continue
        if text[i] == quote:
            return i
        i += 1
    return -1


def load_dotenv(path: str = ".env") -> bool:
    """Load ``path`` into ``os.environ`` (setdefault semantics). Returns
    True iff the file existed."""
    if not os.path.isfile(path):
        return False
    with open(path) as f:
        lines = f.read().splitlines()
    parsed: dict = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line.startswith("export "):
            line = line[len("export ") :]
        if "=" not in line:
            print(f"Ignoring malformed .env line {i}: {line!r}", file=sys.stderr)
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if not key:
            print(f"Ignoring malformed .env line {i}: {line!r}", file=sys.stderr)
            continue
        if value and value[0] in "'\"":
            quote, rest = value[0], value[1:]
            start = i  # resume point if the quote never closes
            end = _closing_quote(rest, quote)
            while end < 0 and i < len(lines):
                # Multiline value: the quote stays open across lines.
                rest += "\n" + lines[i]
                i += 1
                end = _closing_quote(rest, quote)
            if end < 0:
                # Do NOT let a typo'd quote swallow the rest of the file:
                # lose only this line and resume parsing at the next one
                # (a later SLACK_WEBHOOK_URL= must still load).
                print(
                    f"Ignoring unterminated quote for {key!r} in .env "
                    f"(line {start})",
                    file=sys.stderr,
                )
                i = start
                continue
            value = rest[:end]
            if quote == '"':
                value = _interpolate(_decode_escapes(value), parsed)
        else:
            # Unquoted: strip trailing comments, then interpolate.
            value = value.split(" #", 1)[0].rstrip()
            value = _interpolate(value, parsed)
        parsed[key] = value
        os.environ.setdefault(key, value)
    return True


def env_or(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)
