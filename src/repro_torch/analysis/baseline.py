"""Baseline suppression for the lint CLI (the reference's
`repro.analysis.baseline`, copied: the same fingerprints).

A baseline is a JSON file of finding fingerprints the team has accepted
(grandfathered debt, deliberate exceptions too broad for `# noqa`). The CI
gate runs with an *empty* baseline — the file exists so a future PR that
must land with a known finding can do so without weakening a rule.

Fingerprints are stable under reformatting and line churn:

    "<rule>:<relpath>:<sha1(normalized snippet)[:12]>#<occurrence>"

The normalized snippet is the finding's source line with whitespace
collapsed; the occurrence index disambiguates identical lines in one file.
Line numbers deliberately do not participate.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.lint import Finding

_WS = re.compile(r"\s+")


def _relpath(path: str) -> str:
    rel = os.path.relpath(path)
    return rel.replace(os.sep, "/")


def fingerprint(finding: Finding, occurrence: int = 0) -> str:
    normalized = _WS.sub(" ", finding.snippet).strip()
    digest = hashlib.sha1(normalized.encode("utf-8")).hexdigest()[:12]
    return (f"{finding.rule}:{_relpath(finding.path)}:{digest}"
            f"#{occurrence}")


def fingerprints(findings: Iterable[Finding]) -> List[Tuple[Finding, str]]:
    """Pair each finding with its occurrence-indexed fingerprint."""
    seen: Dict[str, int] = {}
    out: List[Tuple[Finding, str]] = []
    for f in findings:
        base = fingerprint(f, 0).rsplit("#", 1)[0]
        idx = seen.get(base, 0)
        seen[base] = idx + 1
        out.append((f, f"{base}#{idx}"))
    return out


def load(path: str) -> frozenset:
    """Read a baseline file; tolerates the two shapes we ever wrote:
    a bare JSON list of fingerprints, or {"fingerprints": [...]}."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        data = data.get("fingerprints", [])
    if not isinstance(data, list):
        raise ValueError(f"baseline {path}: expected a JSON list or "
                         f"{{'fingerprints': [...]}}, got {type(data).__name__}")
    return frozenset(str(x) for x in data)


def write(path: str, findings: Iterable[Finding]) -> int:
    """Snapshot current findings as the new baseline; returns the count."""
    fps = sorted(fp for _, fp in fingerprints(findings))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"fingerprints": fps}, fh, indent=2)
        fh.write("\n")
    return len(fps)


def filter_findings(findings: Iterable[Finding],
                    baseline: frozenset) -> List[Finding]:
    """Drop findings whose fingerprint appears in the baseline."""
    return [f for f, fp in fingerprints(findings) if fp not in baseline]
