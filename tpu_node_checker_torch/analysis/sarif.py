"""SARIF 2.1.0 rendering for tnc-lint (``--format sarif``).

SARIF is the interchange format CI forges ingest for inline annotations
(GitHub code scanning et al.), so the lint job can upload findings
instead of parsing human output.  The document is deliberately minimal
but valid: one run, the full rule table on the driver (stable ``ruleId``
= TNC code, the suppression slug and ``doc`` text alongside), one result
per finding with a ``physicalLocation`` region, and suppressed findings
included with ``suppressions: [{"kind": "inSource"}]`` — a waived
finding is *visible but muted* in SARIF viewers, the same contract the
human renderer keeps by counting (not printing) suppressions.

The JSON (schema v3) and human surfaces are byte-unchanged by this
module's existence — SARIF is a third renderer, not a reshaping.
"""

from __future__ import annotations

import json
from typing import List

from tpu_node_checker_torch.analysis.engine import Finding, Report

SARIF_VERSION = "2.1.0"
_SCHEMA_URI = "https://json.schemastore.org/sarif-2.1.0.json"


def _result(finding: Finding, suppressed: bool) -> dict:
    out = {
        "ruleId": finding.code,
        "level": "error",
        "message": {"text": f"[{finding.rule}] {finding.message}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": finding.path,
                    "uriBaseId": "SRCROOT",
                },
                "region": {
                    "startLine": max(finding.line, 1),
                    # SARIF columns are 1-based; tnc-lint's are 0-based
                    "startColumn": finding.col + 1,
                },
            },
        }],
    }
    if suppressed:
        out["suppressions"] = [{"kind": "inSource"}]
    return out


def render_sarif(report: Report) -> str:
    from tpu_node_checker_torch.analysis.rules import ALL_RULES

    rules = [
        {
            "id": rule.code,
            "name": rule.slug,
            "shortDescription": {"text": rule.slug},
            "fullDescription": {"text": rule.doc},
            "defaultConfiguration": {"level": "error"},
        }
        for rule in ALL_RULES
    ]
    results: List[dict] = [_result(f, False) for f in report.findings]
    results += [_result(f, True) for f in report.suppressed]
    doc = {
        "$schema": _SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "tnc-lint",
                    "informationUri":
                        "https://github.com/tpu-node-checker/"
                        "tpu-node-checker",
                    "rules": rules,
                },
            },
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
