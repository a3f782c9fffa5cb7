"""``python -m repro_torch.analysis`` — the static contract checker CLI.

Runs the trace contract, memory/traffic and repo-lint passes over the
solver's own step functions (each step once, at small shapes; no solve),
prints the human summary, optionally writes the machine-readable JSON
report, and exits nonzero on any violation that is not allowlisted.
The targets run on the card unless ``--device cpu`` is given; with no
card and no ``--device`` it raises.
"""
import argparse
import sys


def main(argv=None) -> int:
    from repro_torch.analysis import ALL_PASSES, run_all

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract checks (collectives, precision, "
                    "syncs, memory) over the solver's step functions")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=ALL_PASSES, default=None,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the steps run (default: the card)")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="per-device peak-live budget (default: the card's "
                         "memory; on the CPU, an H100 80GB's)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here "
                         "('-' for stdout)")
    args = ap.parse_args(argv)

    passes = tuple(args.passes) if args.passes else ALL_PASSES
    report = run_all(passes=passes, budget_bytes=args.budget_bytes,
                     device=args.device)
    if args.json == "-":
        print(report.to_json())
    else:
        print(report.summary())
        if args.json:
            with open(args.json, "w") as f:
                f.write(report.to_json() + "\n")
            print(f"report written to {args.json}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
