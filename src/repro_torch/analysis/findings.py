"""Findings and the checked-in waiver baseline.

A :class:`Finding` is one rule violation at a file:line with a fix hint.
Its *fingerprint* deliberately omits the line number — waivers must survive
unrelated edits above the finding — and instead keys on
``rule::path::symbol`` where ``symbol`` is the enclosing qualname plus the
violating token (field name, sink name, kwarg).  The :class:`Baseline` is a
JSON file of fingerprints with justification strings; the CI gate is
zero-new-findings: anything not in the baseline fails the build, and stale
waivers are reported so they get pruned.

The port's copy of ``repro.analysis.findings``.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""

    rule: str                 # e.g. "LK001"
    path: str                 # repo-relative, '/'-separated
    line: int
    symbol: str               # "Class.method:token" — the fingerprint anchor
    message: str
    hint: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}"

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def as_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.symbol))


class Baseline:
    """Waived findings: ``{fingerprint: justification}`` with JSON round-trip."""

    def __init__(self, waivers: Dict[str, str] = None):
        self.waivers: Dict[str, str] = dict(waivers or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            blob = json.load(fh)
        if blob.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{path}: baseline version {blob.get('version')!r} != "
                f"{BASELINE_VERSION}; regenerate with --write-baseline")
        waivers = {}
        for ent in blob.get("waivers", []):
            waivers[ent["fingerprint"]] = ent.get("reason", "")
        return cls(waivers)

    def save(self, path: str) -> None:
        blob = {"version": BASELINE_VERSION,
                "waivers": [{"fingerprint": fp, "reason": reason}
                            for fp, reason in sorted(self.waivers.items())]}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(blob, fh, indent=1, sort_keys=False)
            fh.write("\n")

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      reason: str = "baselined") -> "Baseline":
        return cls({f.fingerprint: reason for f in findings})

    def is_waived(self, finding: Finding) -> bool:
        return finding.fingerprint in self.waivers

    def split(self, findings: Iterable[Finding]):
        """(new, waived) partition of ``findings``."""
        new, waived = [], []
        for f in findings:
            (waived if self.is_waived(f) else new).append(f)
        return new, waived

    def stale(self, findings: Iterable[Finding]) -> List[str]:
        """Waiver fingerprints that no current finding matches."""
        live = {f.fingerprint for f in findings}
        return sorted(fp for fp in self.waivers if fp not in live)
