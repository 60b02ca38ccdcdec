"""Finding records, suppression comments, and the grandfather baseline.

A :class:`Finding` is one rule hit at one source location.  Its
``fingerprint`` hashes (repo-relative path, rule name, *stripped source
line*) rather than the line number, so baselined findings survive edits
that merely shift code up or down -- the classic "baseline churn" failure
of line-keyed lint baselines.

Suppressions are in-source: a ``# reprolint: ignore[rule-a,rule-b]``
comment on the offending line (or a bare ``# reprolint: ignore`` for all
rules) silences that line.  The baseline is a checked-in JSON file
(``analysis_baseline.json`` at the repo root) of fingerprints with
human-written justification notes; ``python -m repro.analysis
--write-baseline`` regenerates it from the current findings.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re

_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")

# The note ``--write-baseline`` stamps on every grandfathered entry.  A
# baseline entry is only legitimate once a human replaces this with an
# actual justification; ``--check`` fails on any entry still carrying it.
PLACEHOLDER_NOTE = "TODO: justify or fix (see docs/analysis.md)"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                   # repo-relative, posix separators
    line: int                   # 1-based
    col: int
    message: str
    snippet: str = ""           # stripped source line (fingerprint input)

    @property
    def fingerprint(self) -> str:
        raw = f"{self.path}::{self.rule}::{self.snippet}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def suppressions(source_lines: list[str]) -> dict[int, set[str] | None]:
    """Map 1-based line number -> suppressed rule names (None == all)."""
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def is_suppressed(finding: Finding,
                  supp: dict[int, set[str] | None]) -> bool:
    rules = supp.get(finding.line, ())
    return rules is None or finding.rule in rules


# ---------------------------------------------------------------------------
# baseline file
# ---------------------------------------------------------------------------

def load_baseline(path) -> dict[str, dict]:
    """Fingerprint -> entry.  Missing file == empty baseline."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    if data.get("version") != 1:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path, findings: list[Finding]) -> None:
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "snippet": f.snippet,
            "note": PLACEHOLDER_NOTE,
        })
    with open(path, "w") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2)
        fh.write("\n")


def placeholder_entries(baseline: dict[str, dict]) -> list[dict]:
    """Baseline entries nobody ever justified: the note is still the
    ``--write-baseline`` placeholder (or blank).  A baseline is a debt
    ledger, not an amnesty -- ``--check`` fails on these."""
    stale = [e for e in baseline.values()
             if str(e.get("note", "")).strip() in ("", PLACEHOLDER_NOTE)]
    return sorted(stale, key=lambda e: (e.get("path", ""), e.get("rule", "")))


def split_baselined(findings: list[Finding], baseline: dict[str, dict]):
    """Partition into (new, grandfathered) against the baseline."""
    new, old = [], []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
