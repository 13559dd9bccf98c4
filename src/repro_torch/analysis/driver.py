"""repro-lint driver of the port: file discovery, pass dispatch, baseline
gate, CLI (``python -m repro_torch.analysis``).  The reference's driver
(``repro.analysis.driver``) with the port's roots, baseline file and rule
catalog.

Exit codes (the CI contract):

* ``0`` — no findings beyond the baseline,
* ``1`` — at least one new (un-waived) finding, and
* ``2`` — bad usage (unreadable baseline, no such path).

``--gate`` is the CI mode: machine-terse output, zero-new-findings policy,
and stale baseline waivers are reported (so they get pruned) without
failing the build.  ``--write-baseline`` waives everything currently
firing — the escape hatch for landing the analyzer ahead of the last fix —
and the reviewable artifact is the diff of
``tools/repro_torch_lint_baseline.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Iterable, Iterator, List, Optional

from .astutils import parse_module
from .findings import Baseline, Finding, sort_findings
from .kernels import check_kernels
from .locks import check_locks
from .privacy import check_privacy
from .registry import ALL_RULES

#: Analyzed by default when the CLI gets no paths (repo-relative).
DEFAULT_ROOTS = ("src/repro_torch",)

#: The waiver baseline read when ``--baseline`` is not given (repo-relative).
BASELINE = "tools/repro_torch_lint_baseline.json"

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "build", "dist"}


def iter_py_files(root: str) -> Iterator[str]:
    """Yield ``.py`` files under ``root`` (or ``root`` itself), sorted."""
    if os.path.isfile(root):
        if root.endswith(".py"):
            yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _rel(path: str, repo_root: Optional[str]) -> str:
    if repo_root:
        # ValueError: different drives on Windows — fall through to abspath
        with contextlib.suppress(ValueError):
            return os.path.relpath(path, repo_root).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def analyze_source(text: str, path: str) -> List[Finding]:
    """Run all three pass families over one source string."""
    try:
        info = parse_module(text, path)
    except SyntaxError as exc:
        return [Finding("LINT000", path, exc.lineno or 1, "<parse>",
                        f"could not parse: {exc.msg}",
                        hint="repro-lint only analyzes files that compile")]
    return sort_findings(
        check_privacy(info) + check_kernels(info) + check_locks(info))


def analyze_file(path: str, repo_root: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    return analyze_source(text, _rel(path, repo_root))


def analyze_paths(paths: Iterable[str],
                  repo_root: Optional[str] = None) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        for py in iter_py_files(root):
            findings.extend(analyze_file(py, repo_root))
    return sort_findings(findings)


def _print_rules() -> None:
    width = max(len(r) for r in ALL_RULES)
    for rule, desc in sorted(ALL_RULES.items()):
        print(f"{rule:<{width}}  {desc}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="privacy-flow, kernel-invariant, and lock-discipline "
                    "static analysis for the repro_torch tree")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to analyze (default: {DEFAULT_ROOTS})")
    ap.add_argument("--gate", action="store_true",
                    help="CI mode: fail on any finding not in the baseline")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="waiver baseline JSON (default: "
                         f"{BASELINE} if present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="waive every current finding into the baseline file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.rules:
        _print_rules()
        return 0

    repo_root = os.getcwd()
    paths = args.paths or [os.path.join(repo_root, p) for p in DEFAULT_ROOTS]
    for p in paths:
        if not os.path.exists(p):
            print(f"repro-lint: no such path: {p}", file=sys.stderr)
            return 2

    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(repo_root, BASELINE)
        baseline_path = cand if os.path.exists(cand) else None
    try:
        baseline = Baseline.load(baseline_path) if baseline_path else Baseline()
    except (ValueError, OSError, json.JSONDecodeError) as exc:
        print(f"repro-lint: bad baseline: {exc}", file=sys.stderr)
        return 2

    findings = analyze_paths(paths, repo_root=repo_root)

    if args.write_baseline:
        out = baseline_path or os.path.join(repo_root, BASELINE)
        Baseline.from_findings(findings).save(out)
        print(f"repro-lint: wrote {len(findings)} waiver(s) to {out}")
        return 0

    new, waived = baseline.split(findings)

    if args.as_json:
        print(json.dumps([f.as_dict() for f in new], indent=1))
    else:
        for f in new:
            print(f.render())
    for fp in baseline.stale(findings):
        print(f"repro-lint: stale waiver (prune it): {fp}", file=sys.stderr)
    if waived and not args.as_json:
        print(f"repro-lint: {len(waived)} baselined finding(s) suppressed",
              file=sys.stderr)

    if new:
        tail = " (gate)" if args.gate else ""
        print(f"repro-lint: {len(new)} new finding(s){tail}", file=sys.stderr)
        return 1
    if not args.as_json:
        print("repro-lint: clean")
    return 0


if __name__ == "__main__":                     # pragma: no cover
    sys.exit(main())
