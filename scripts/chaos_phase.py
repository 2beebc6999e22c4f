"""chip_smoke.py's scenario-matrix phase (phase 16) alone on the card: the
six quick single-process cells and the three cluster cells of
nomad_tpu_torch/chaos/ on the card, then the six -full cells on the card
and on the CPU, each card run held to the CPU's.

    python3 scripts/chaos_phase.py [--reps N] [--cpu]

Each repetition prints the phase's lines as chip_smoke.py does and
raises (exit code not 0) on a failed check. The last line is one JSON
object: `{"device": ..., "launches": [{kernel: n}], "phase_s": [s]}`.
`--cpu` rehearses the phase on the CPU instead (the kernels' plain
versions; both halves of the -full comparison on the CPU). Run from the
repository's root."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs

    device = "cpu" if args.cpu else "cuda"
    if args.cpu:
        info = {"raw": "CPU rehearsal"}
    else:
        if not torch.cuda.is_available():
            print("chaos_phase: no CUDA device", file=sys.stderr)
            return 1
        from nomad_tpu_torch.ops import kernels
        from nomad_tpu_torch.utils.platform import device_info
        info = device_info()
        print(f"device: {info['raw']}", flush=True)
        t0 = time.perf_counter()
        kernels.load_library()
        print(f"set-up: kernels built in {time.perf_counter() - t0:.2f} s",
              flush=True)
    launches, walls = [], []
    for _rep in range(args.reps):
        t0 = time.perf_counter()
        launches.append(cs.chaos_phase(info, device=device))
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"device": info["raw"], "launches": launches,
                      "phase_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
