"""chip_smoke.py's agent phase (phase 14) alone on the card: the agent
started in this process through `start_agent` (-dev -clients 0
-acl-enabled -num-schedulers 1), the 10,000 nodes over its RPC port,
ACLs and a webhook sink through the CLI and three job files through
`nomad job run` (the agent as a subprocess is phase 15's, in
scripts/client_phase.py).

    python3 scripts/agent_phase.py [--reps N] [--cpu NODES]

Each repetition prints the phase's lines as chip_smoke.py does and
raises (exit code not 0) on a failed check. The last line is one JSON
object: `{"device": ..., "launches": [{kernel: n}], "phase_s": [s]}`.
`--cpu NODES` rehearses the phase on the CPU instead (the kernels' plain
versions, NODES nodes, the batch job cut to 600 and the spread job to
40). Run from the repository's root."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--cpu", type=int, default=0, metavar="NODES")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.mock import seeded_mock_ids

    kw = {}
    if args.cpu:
        cs.MAIN_NODES = args.cpu
        info = {"raw": "CPU rehearsal"}
        kw = dict(device="cpu",
                  jobs=(("agent-service", "service", 10, "chunked"),
                        ("agent-batch", "batch", 600, "kway"),
                        ("agent-spread", "service", 40, "scan")))
    else:
        if not torch.cuda.is_available():
            print("agent_phase: no CUDA device", file=sys.stderr)
            return 1
        from nomad_tpu_torch.ops import kernels
        from nomad_tpu_torch.utils.platform import device_info
        info = device_info()
        print(f"device: {info['raw']}", flush=True)
        t0 = time.perf_counter()
        kernels.load_library()
        print(f"set-up: kernels built in {time.perf_counter() - t0:.2f} s",
              flush=True)
    nodes = cs.build_cluster(mock, seeded_mock_ids)
    launches, walls = [], []
    for _rep in range(args.reps):
        t0 = time.perf_counter()
        launches.append(cs.agent_phase(nodes, info, **kw))
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"device": info["raw"], "launches": launches,
                      "phase_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
