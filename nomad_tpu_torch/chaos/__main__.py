"""`python -m nomad_tpu_torch.chaos` / `nomad dev chaos` — run the
scenario matrix (or one cell) and emit a CHAOS_rNN.json artifact.

Local tooling: no agent connection — the cells build their own
in-process servers, on the CUDA card unless `-device cpu` is given (no
probe of the card and no fallback: without one the default raises).
Exit status is the matrix verdict (non-zero when any cell failed), so
CI can gate on it directly.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.chaos",
        description="scenario matrix + fault injection harness")
    p.add_argument("-cell", default="",
                   help="comma-separated cell names (default: every "
                        "quick cell)")
    p.add_argument("-full", action="store_true",
                   help="full-scale cells (bigger fleets, soak "
                        "flatness bounds) instead of quick")
    p.add_argument("-seed", type=int, default=None,
                   help="override the per-cell derived fault seed")
    p.add_argument("-list", action="store_true", dest="list_cells",
                   help="list cells and exit")
    p.add_argument("-output", default="",
                   help="artifact path (default: next free "
                        "CHAOS_rNN.json in the cwd)")
    p.add_argument("-no-artifact", action="store_true",
                   dest="no_artifact", help="print JSON to stdout only")
    p.add_argument("-q", action="store_true", dest="quiet",
                   help="suppress per-cell progress logging")
    p.add_argument("-device", default=None,
                   help="where the cells' servers run their kernels: "
                        "the CUDA card by default, \"cpu\" for the "
                        "kernels' plain versions on the CPU")
    args = p.parse_args(argv)

    from .scenarios import SCENARIOS
    if args.list_cells:
        for s in SCENARIOS.values():
            kind = "cluster" if s.cluster else \
                ("quick" if s.quick else "full")
            print(f"{s.name:24s} [{kind:7s}] {s.title}")
        return 0

    logging.basicConfig(
        level=logging.ERROR if args.quiet else logging.WARNING)
    from .matrix import run_matrix, write_artifact
    names = [n.strip() for n in args.cell.split(",") if n.strip()] \
        or None
    try:
        result = run_matrix(names=names, quick=not args.full,
                            seed=args.seed, device=args.device)
    except KeyError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2

    for cell in result["cells"]:
        verdict = "PASS" if cell["pass"] else "FAIL"
        flat = cell["flatness"].get("pass")
        flat_s = {True: "flat", False: "DRIFTING",
                  None: "flatness n/a"}[flat]
        print(f"{cell['name']:24s} {verdict}  "
              f"{cell['placements_per_sec']:8.1f} placements/s  "
              f"p99 {cell['settle_p99_ms']:8.1f} ms  {flat_s}  "
              f"invariants {len(cell['invariants']) - len(cell['invariants_failed'])}"
              f"/{len(cell['invariants'])}"
              + (f"  failed: {cell['invariants_failed']}"
                 if cell["invariants_failed"] else ""))
    s = result["summary"]
    print(f"{s['passed']}/{s['cells']} cells passed, "
          f"{s['invariants_checked']} invariants checked "
          f"({s['invariants_failed']} failed), race: "
          f"{result['race']} ({s['race_findings']} findings)")

    if args.no_artifact:
        json.dump(result, sys.stdout, indent=1, default=str)
        print()
    else:
        path = write_artifact(result, path=args.output or None)
        print(f"artifact: {path}")
    return 0 if s["passed"] == s["cells"] else 1


if __name__ == "__main__":
    sys.exit(main())
