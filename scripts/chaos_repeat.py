"""One scenario-matrix cell of nomad_tpu_torch/chaos/ run again and
again, with each run's verdict and its raft elections and leader
step-downs (counted from the raft log, as chip_smoke.py phase 16 counts
them): how often a cell fails, and whether a leader flap came with it.

    python3 scripts/chaos_repeat.py --cell follower_fence --reps 20 [--cpu]
        [--full]

Prints one line a run and, last, one JSON object: `{"cell": ...,
"device": ..., "reps": N, "passed": n, "failed": {invariant: runs},
"runs_with_step_down": n, "elapsed_s": [s]}`. Without `--cpu` it runs on
the card. Run from the repository's root."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from nomad_tpu_torch.chaos.matrix import run_cell
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS

    if args.cpu:
        device = "cpu"
        torch.set_num_threads(2)
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("chaos_repeat: no CUDA device (pass --cpu)", file=sys.stderr)
        return 1
    failed, step_downs, walls, passed = {}, 0, [], 0
    for rep in range(args.reps):
        c = cs._run_counting_raft(run_cell, SCENARIOS[args.cell],
                                  quick=not args.full, device=device)
        r = c["raft"]
        passed += bool(c["pass"])
        step_downs += r["stepped_down"] > 0
        walls.append(c["elapsed_s"])
        for name in c["invariants_failed"]:
            failed[name] = failed.get(name, 0) + 1
        print(f"run {rep}: {'pass' if c['pass'] else 'FAIL'} "
              f"{c['invariants_failed']}, {c['elapsed_s']:.2f} s, "
              f"{r['elected']} elections won, {r['stepped_down']} leader "
              f"step-downs, highest term {r['term']}"
              + (f", error {c['error']}" if c.get("error") else ""),
              flush=True)
    print(json.dumps({"cell": args.cell, "device": device,
                      "reps": args.reps, "passed": passed,
                      "failed": failed, "runs_with_step_down": step_downs,
                      "elapsed_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
