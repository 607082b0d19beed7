"""Mesh link doctor: every link leg of the rank ring timed and graded.

The collective level answers "does the fabric work"; this package answers
"which link is sick".  :func:`mesh_link_sweep` walks the rank ring one hop
at a time, one single-pair transfer per leg, so each link gets its own
timing distribution and its own verdict (``OK | SLOW | DEAD``) under the
JAX package's link names (``axis/hop``).
"""

from tpu_node_checker_torch.meshprobe.sweep import (  # noqa: F401 — public API
    DEAD,
    OK,
    SLOW,
    VERDICTS,
    MeshLinkReport,
    expected_link_count,
    link_names,
    mesh_link_sweep,
    qualify_link,
)
