"""chip_smoke.py's ring phase (phase 13) alone on the card: three Servers
joined by raft over loopback RPC, the 10,000 nodes through the leader's
raft, a follower reseeded by InstallSnapshot, phase 11's 70 jobs through
register_jobs_bulk with the followers scheduling remotely, then the
leader killed and two more jobs placed through the new one.

    python3 scripts/ring_phase.py [--reps N]

Each repetition first runs chip_smoke.py's single-server config (A) on
the card for the alloc-name manifest the ring must land, then the ring
phase, which prints its lines as chip_smoke.py does and raises (exit
code not 0) on a failed check. The last line is one JSON object:
`{"device": ..., "launches": [{kernel: n}], "phase_s": [s]}`. Run from
the repository's root."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("ring_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nomad_tpu_torch import mock
    from nomad_tpu_torch import models
    from nomad_tpu_torch.mock import seeded_mock_ids
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.utils.platform import device_info

    info = device_info()
    print(f"device: {info['raw']}", flush=True)
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"set-up: kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    nodes = cs.build_cluster(mock, seeded_mock_ids)
    warm, jobs = cs.server_jobs(mock, models)
    label, _what, cfg = cs.SERVER_RUNS[0]
    launches, walls = [], []
    for _rep in range(args.reps):
        r = cs.run_server(None, label, cfg, nodes, warm, jobs)
        manifest = {f"default/{job.id}": sorted(name for name, _n in placed)
                    for job, placed in zip(jobs, r["placements"])}
        t0 = time.perf_counter()
        launches.append(cs.ring_phase(nodes, mock, models, manifest, info))
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"device": info["raw"], "launches": launches,
                      "phase_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
