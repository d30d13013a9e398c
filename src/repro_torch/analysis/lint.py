"""pmemlint's command line (the port's copy of ``repro/analysis/lint.py``).

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch \
        --update-baseline
    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch \
        --no-baseline   # raw report

Runs the three invariant families (persistence ordering, metadata-only
recovery, lock discipline) over the target paths and diffs the findings
against the checked-in baseline (``src/repro_torch/analysis/baseline.json``).
Exit status 1 iff there are NEW findings — CI fails on regressions, not
on the reviewed legacy set. Baseline entries are line-number-free
fingerprints, so unrelated edits never churn the file; entries that no
longer fire are reported as stale (fix the baseline with
``--update-baseline`` once the cleanup lands).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis import locks, persistence, recovery
from repro_torch.analysis.core import Finding, collect

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

PASSES = (
    ("persistence-ordering", persistence.run),
    ("metadata-only-recovery", recovery.run),
    ("lock-discipline", locks.run),
)


def run_lint(targets: List[Path], root: Path) -> List[Finding]:
    modules = collect(targets, root)
    findings: List[Finding] = []
    for _family, fn in PASSES:
        findings.extend(fn(modules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def load_baseline(path: Path) -> List[str]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    return list(data.get("findings", []))


def save_baseline(path: Path, findings: List[Finding]) -> None:
    payload = {
        "comment": "pmemlint baseline: reviewed pre-existing findings. "
                   "CI fails only on findings NOT in this list. "
                   "Regenerate with: python -m repro_torch.analysis.lint "
                   "src/repro_torch --update-baseline",
        "findings": sorted({f.fingerprint for f in findings}),
    }
    path.write_text(json.dumps(payload, indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="pmem data-plane invariant lint (pmemlint)")
    ap.add_argument("paths", nargs="+", help="files or directories")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding; exit 1 if any")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run and exit 0")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only new findings and the summary")
    args = ap.parse_args(argv)

    root = Path.cwd()
    targets = [Path(p) for p in args.paths]
    for t in targets:
        if not t.exists():
            print(f"pmemlint: no such path: {t}", file=sys.stderr)
            return 2
    findings = run_lint(targets, root)

    if args.update_baseline:
        save_baseline(args.baseline, findings)
        print(f"pmemlint: baseline updated: {len(findings)} finding(s) "
              f"-> {args.baseline}")
        return 0

    baseline = set() if args.no_baseline else \
        set(load_baseline(args.baseline))
    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]
    stale = baseline - {f.fingerprint for f in findings}

    if old and not args.quiet:
        print(f"-- {len(old)} baselined finding(s) (not failing):")
        for f in old:
            print(f"   {f.render()}")
    if stale and not args.quiet:
        print(f"-- {len(stale)} stale baseline entr(ies) — no longer "
              f"fire; prune with --update-baseline:")
        for fp in sorted(stale):
            print(f"   {fp}")
    if new:
        print(f"-- {len(new)} NEW finding(s):")
        for f in new:
            print(f"   {f.render()}")
    print(f"pmemlint: {len(findings)} finding(s): {len(new)} new, "
          f"{len(old)} baselined, {len(stale)} stale baseline")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
