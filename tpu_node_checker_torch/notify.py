"""Slack webhook notification with the reference's retry state machine.

A copy of the JAX package's ``notify.py``: the same code, transport
included (``requests``, imported lazily on the delivery path), so the two
packages gate, retry and fail alike on every error the webhook can give:

* POST ``{text, username, icon_emoji}`` with a 10 s timeout;
* retry **only** on connection errors whose message contains
  ``"Connection reset by peer"`` or ``"Connection aborted"``, up to
  ``max_retries`` times with ``retry_delay`` seconds between attempts;
* HTTP non-200 responses also retry, but **immediately**;
* any other request error (a URL with no scheme, a malformed reply) fails
  at once;
* delivery failure is never fatal to the check itself.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

DEFAULT_USERNAME = "tpu-node-checker"
DEFAULT_ICON = ":robot_face:"
DEFAULT_TIMEOUT_S = 10.0
DEFAULT_MAX_RETRIES = 3
DEFAULT_RETRY_DELAY_S = 30.0

_RETRYABLE_FRAGMENTS = ("Connection reset by peer", "Connection aborted")


def get_slack_webhook_url(flag_value: Optional[str]) -> Optional[str]:
    """Flag beats environment (check-gpu-node.py:142-144)."""
    return flag_value or os.environ.get("SLACK_WEBHOOK_URL") or None


def should_send_slack_message(
    webhook_url: Optional[str], only_on_error: bool, healthy: bool,
    transitions: bool = False,
) -> bool:
    """Gating policy (check-gpu-node.py:147-157): no URL → never;
    only-on-error → only when the check failed; else always.

    The reference gates on ``len(ready)==0``; here ``healthy`` is the full
    check outcome (exit code 0), so strict-slice and probe failures also
    count as errors — otherwise ``--strict-slices --slack-only-on-error``
    could exit 3 while Slack stays silent.

    ``transitions`` extends the same no-silent-failure rule to the
    ``--history`` hysteresis layer: an actionable per-node state transition
    (→FAILED, →CHRONIC, a re-earned HEALTHY) pages through
    ``--slack-only-on-error`` even on an exit-0 round — one node going
    chronic in a big fleet never moves the aggregate exit code.
    """
    if not webhook_url:
        return False
    if only_on_error:
        return (not healthy) or transitions
    return True


def _is_retryable(exc: Exception) -> bool:
    """Exactly the reference's classification (check-gpu-node.py:86-99):
    ConnectionError/Timeout AND the message names a reset/abort."""
    import requests

    if not isinstance(exc, (requests.exceptions.ConnectionError, requests.exceptions.Timeout)):
        return False
    msg = str(exc)
    return any(frag in msg for frag in _RETRYABLE_FRAGMENTS)


def send_slack_message(
    webhook_url: str,
    message: str,
    username: str = DEFAULT_USERNAME,
    max_retries: int = DEFAULT_MAX_RETRIES,
    retry_delay: float = DEFAULT_RETRY_DELAY_S,
    timeout: float = DEFAULT_TIMEOUT_S,
    sleep: Callable[[float], None] = time.sleep,
    post: Optional[Callable] = None,
    trace_id: Optional[str] = None,
) -> bool:
    """Deliver one message; returns True on HTTP 200.

    ``sleep`` and ``post`` are injectable so tests can drive the retry state
    machine without wall-clock delays or a live webhook.

    ``trace_id`` (watch/one-shot rounds) stamps the round's trace onto the
    message, so an alert joins straight to its timeline:
    ``GET /api/v1/debug/rounds/{trace_id}`` on the fleet API, the
    ``--trace`` file, or a ``trace_id`` grep over the ``--event-log``.

    ``requests`` is imported lazily: the happy path of a check with no
    webhook configured never pays its ~120 ms import cost (the <2 s budget
    includes process startup).
    """
    import requests

    post = post or requests.post
    if trace_id:
        message = f"{message}\n`trace: {trace_id}`"
    payload = {"text": message, "username": username, "icon_emoji": DEFAULT_ICON}
    attempts = max_retries + 1
    for attempt in range(1, attempts + 1):
        try:
            resp = post(webhook_url, json=payload, timeout=timeout)
            if getattr(resp, "status_code", None) == 200:
                if attempt > 1:
                    print(
                        f"Slack message delivered after {attempt} attempts.",
                        file=sys.stderr,
                    )
                return True
            print(
                f"Slack webhook returned HTTP {getattr(resp, 'status_code', '?')} "
                f"(attempt {attempt}/{attempts}).",
                file=sys.stderr,
            )
            # Non-200 retries immediately (check-gpu-node.py:83-84): the
            # server answered, so there is no transport to wait out — the
            # retry_delay pacing belongs to the connection-error branch only.
            continue
        except (requests.exceptions.ConnectionError, requests.exceptions.Timeout) as exc:
            if not _is_retryable(exc):
                print(f"Slack delivery failed: {exc}", file=sys.stderr)
                return False
            print(
                f"Slack connection error (attempt {attempt}/{attempts}): {exc}",
                file=sys.stderr,
            )
        except requests.exceptions.RequestException as exc:
            # Non-connection request errors fail immediately (check-gpu-node.py:101-109).
            print(f"Slack delivery failed: {exc}", file=sys.stderr)
            return False
        if attempt < attempts:
            sleep(retry_delay)
    print(f"Slack delivery failed after {attempts} attempts.", file=sys.stderr)
    return False


# Fleet-API lifecycle events worth a Slack line.  Anything else passed to
# server_event still sends (ℹ️) — the map curates icons, not policy.
_SERVER_EVENT_ICONS = {
    "server-start": "🛰️",
    "auth-failure": "🔒",
}


def server_event(
    webhook_url: Optional[str],
    event: str,
    detail: str,
    username: str = DEFAULT_USERNAME,
) -> bool:
    """Best-effort Slack note for fleet state API lifecycle events.

    Two classes today: ``server-start`` (the API came up — operators learn
    the surface exists and whether writes are token-gated) and
    ``auth-failure`` (a write was rejected 401/403 — rate-limited by the
    server so a scanner cannot turn Slack into the amplifier).  Zero
    retries and never fatal: these fire from (or next to) serving threads,
    which must not stall on a slow webhook the way a check round may.
    """
    if not webhook_url:
        return False
    icon = _SERVER_EVENT_ICONS.get(event, "ℹ️")
    return send_slack_message(
        webhook_url,
        f"{icon} *Fleet state API {event}*: {detail}",
        username=username,
        max_retries=0,
    )
