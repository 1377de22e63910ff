"""CLI for the lint leg: ``python -m agentainer_tpu_torch.analysis``.

Reference: ``agentainer_tpu/analysis/__main__.py`` — the same flags and
exit codes: 0 when every violation is baselined; 1 on NEW violations (the
ratchet); 2 on analyzer misconfiguration.
"""

from __future__ import annotations

import argparse
import sys

from .framework import (
    AnalysisError,
    BASELINE_PATH,
    DEFAULT_ROOTS,
    load_baseline,
    prune_baseline,
    run_rules,
    save_baseline,
)
from .rules import ALL_RULES


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m agentainer_tpu_torch.analysis",
        description="repo-custom invariant lint (ATP rules) with a baseline ratchet",
    )
    ap.add_argument(
        "roots", nargs="*", default=list(DEFAULT_ROOTS),
        help="directories/files to scan (repo-relative; default: agentainer_tpu_torch)",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="freeze the current violation set into analysis/baseline.json "
        "(existing justifications are preserved; new entries get a TODO)",
    )
    ap.add_argument(
        "--prune", action="store_true",
        help="drop stale baseline entries whose violation no longer fires",
    )
    ap.add_argument(
        "--verbose", action="store_true", help="also list baselined violations"
    )
    ap.add_argument(
        "--rule", action="append", default=None, metavar="ATPnnn",
        help="run only these rule IDs (repeatable)",
    )
    args = ap.parse_args(argv)

    rules = ALL_RULES
    if (args.update_baseline or args.prune) and (
        args.rule or list(args.roots) != list(DEFAULT_ROOTS)
    ):
        # a filtered run — by rule OR by roots — sees only a slice of the
        # violation set; freezing or pruning from it would classify every
        # unscanned file's baseline entry as stale and eat it (along with
        # its hand-written justification)
        print(
            "--update-baseline/--prune require a full run "
            "(no --rule, no custom roots)",
            file=sys.stderr,
        )
        return 2
    if args.rule:
        wanted = set(args.rule)
        rules = tuple(r for r in ALL_RULES if r.rule_id in wanted)
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2

    try:
        baseline = load_baseline()
        violations, report = run_rules(rules, roots=args.roots, baseline=baseline)
    except AnalysisError as e:
        print(f"analysis error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        save_baseline(violations, baseline)
        print(f"baseline frozen: {len(violations)} entries -> {BASELINE_PATH}")
        return 0
    if args.prune:
        dropped = prune_baseline(violations, baseline)
        print(f"pruned {dropped} stale baseline entries")
        report.stale = []  # just deleted — don't advise pruning them again

    print(report.format(verbose=args.verbose))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
