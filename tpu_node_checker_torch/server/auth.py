"""Bearer-token gate for the fleet API's write endpoints.

A copy of the JAX package's ``server/auth.py``, held equal to it by
``tests/test_torch_copies.py``.  Reads are open; writes are deny-by-default:
no token configured (``--serve-token`` or ``$TNC_SERVE_TOKEN``) answers 403,
a missing or wrong bearer 401 with ``WWW-Authenticate``, and a match goes on
to the evidence rules.  The comparison is constant-time.
"""

from __future__ import annotations

import hmac
import os
from typing import Optional, Tuple

TOKEN_ENV = "TNC_SERVE_TOKEN"


def resolve_serve_token(flag_value: Optional[str]) -> Optional[str]:
    """Flag beats environment (same precedence as the Slack webhook)."""
    return flag_value or os.environ.get(TOKEN_ENV) or None


def check_write_auth(
    token: Optional[str], authorization: Optional[str]
) -> Tuple[Optional[int], str]:
    """→ ``(None, "")`` when authorized, else ``(http_status, reason)``."""
    if not token:
        return 403, (
            "write endpoints disabled: no --serve-token (or $TNC_SERVE_TOKEN) "
            "configured on the server"
        )
    if not authorization or not authorization.startswith("Bearer "):
        return 401, "missing bearer token (Authorization: Bearer <token>)"
    presented = authorization[len("Bearer "):].strip()
    if not hmac.compare_digest(presented.encode("utf-8"), token.encode("utf-8")):
        return 401, "invalid bearer token"
    return None, ""
