"""``python -m repro_torch.analysis`` — the port's static-analysis CI gate
(the reference's `python -m repro.analysis`).

Usage:
    python -m repro_torch.analysis src/repro_torch      # lint, human output
    python -m repro_torch.analysis src/repro_torch --json report.json
    python -m repro_torch.analysis src/repro_torch --baseline bl.json
    python -m repro_torch.analysis src/repro_torch --write-baseline bl.json
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --contracts [--device cpu]
                                   # run the superstep, check contracts

Exit status: 0 when no unbaselined findings (and, with ``--contracts``,
all contracts hold); 1 otherwise; 2 on usage errors.  The contracts run
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.lint import Finding, lint_paths
from repro_torch.analysis.rules import default_rules


def _report(findings: List[Finding], rules, contracts=None) -> dict:
    return {
        "tool": "repro_torch.analysis",
        "rules": [{"id": r.rule_id, "name": r.name,
                   "invariant": r.invariant} for r in rules],
        "findings": [
            dict(f.to_dict(), fingerprint=fp)
            for f, fp in baseline_mod.fingerprints(findings)
        ],
        "counts": {r.rule_id: sum(1 for f in findings
                                  if f.rule == r.rule_id)
                   for r in rules},
        **({"contracts": contracts} if contracts is not None else {}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch-aware static lint + superstep contract checker "
                    "(rules RPT001-RPT007)")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--baseline", metavar="FILE",
                    help="JSON baseline of accepted fingerprints to "
                         "suppress")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="snapshot current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--json", metavar="FILE",
                    help="write a JSON report ('-' for stdout)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--contracts", action="store_true",
                    help="also run the device superstep and check its "
                         "contracts (on the card unless --device cpu)")
    ap.add_argument("--device", default=None,
                    help="the contracts' device (default: CUDA)")
    args = ap.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.rule_id}  {r.name:<16} {r.invariant}")
        return 0
    if not args.paths and not args.contracts:
        ap.print_usage(sys.stderr)
        print("error: no paths given (or use --list-rules/--contracts)",
              file=sys.stderr)
        return 2

    findings = lint_paths(args.paths, rules) if args.paths else []

    if args.write_baseline:
        n = baseline_mod.write(args.write_baseline, findings)
        print(f"wrote {n} fingerprint(s) to {args.write_baseline}")
        return 0

    if args.baseline:
        accepted = baseline_mod.load(args.baseline)
        findings = baseline_mod.filter_findings(findings, accepted)

    contracts = None
    contract_failures = 0
    if args.contracts:
        # deferred import: the lint path builds no session
        from repro_torch.analysis.contracts import check_all
        contracts = [c.to_dict() for c in check_all(device=args.device)]
        contract_failures = sum(1 for c in contracts if not c["ok"])

    if args.json:
        payload = json.dumps(_report(findings, rules, contracts), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as fh:
                fh.write(payload + "\n")

    for f in findings:
        print(f.format())
    if contracts is not None:
        for c in contracts:
            status = "ok" if c["ok"] else "FAIL"
            print(f"[contract] {c['name']}: {status} — {c['detail']}")

    n = len(findings)
    if n or contract_failures:
        print(f"\n{n} finding(s), {contract_failures} contract "
              f"failure(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
