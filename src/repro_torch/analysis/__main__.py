"""``python -m repro_torch.analysis`` — lint every benchmark-built ST
program (port of ``python -m repro.analysis``; no XLA flags: one GPU
holds every rank, and ``--device-count`` sets how many).

Prints one diagnostics table per program (rule id, severity, pid,
descriptor index, message, enqueue site) and a final summary line.
Exit status is non-zero if any **error**-severity diagnostic is
emitted; ``--strict`` additionally fails on warning-severity findings
(shipped programs must lint completely clean) and prints a per-program
certificate table: the effect digest from
:func:`repro_torch.core.effects.program_certificate` plus the
happens-before race-free verdict (ST015–ST018 — race freedom under ANY
interleave policy, not just the emitted stream order).
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="STLint every ST program the benchmarks build")
    ap.add_argument("filter", nargs="?", default="",
                    help="only lint programs whose name contains this")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warning-severity diagnostics too, and "
                         "print the per-program effect-certificate table")
    ap.add_argument("--device", default=None,
                    help="the meshes' device (default: the card; 'cpu' builds "
                         "on the host)")
    ap.add_argument("--device-count", type=int, default=None,
                    help="ranks to build the benchmark grids with (default 8)")
    args = ap.parse_args(argv)

    from repro_torch.core.verify import format_diagnostics

    from .programs import certificates, lint_all

    results = [(name, diags) for name, diags in lint_all(args.device_count, args.device)
               if args.filter in name]
    if not results:
        print(f"no programs match {args.filter!r}", file=sys.stderr)
        return 2

    total = 0
    for name, diags in results:
        total += len(diags)
        print(f"== {name}")
        print(format_diagnostics(diags))

    rc = 0
    failing = ("error",) if not args.strict else ("error", "warning")
    dirty = [name for name, diags in results
             if any(d.severity in failing for d in diags)]
    if dirty:
        print(f"\nSTLint: {total} diagnostic(s) across "
              f"{len(dirty)}/{len(results)} failing program(s): "
              f"{', '.join(dirty)}",
              file=sys.stderr)
        rc = 1
    else:
        print(f"\nSTLint: {len(results)} program(s) clean"
              + ("" if total == 0 else f" ({total} non-failing finding(s))"))

    if args.strict:
        print("\n== effect certificates (STProve)")
        racy = []
        for name, cert in certificates(args.device_count, args.device):
            if args.filter not in name:
                continue
            verdict = ("race-free" if cert.race_free
                       else f"RACY ({cert.n_races} race(s))")
            print(f"  {name:28s} digest={cert.digest}  "
                  f"effects={cert.n_effects:4d}  {verdict}")
            if not cert.race_free:
                racy.append(name)
        if racy:
            print(f"\nSTProve: race(s) found in: {', '.join(racy)}",
                  file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
