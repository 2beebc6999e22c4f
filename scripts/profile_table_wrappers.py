"""Host cost of the resident table's scatter wrappers on the card, for one
or more checkouts of the port, step by step where the checkout has the
steps.

    python3 scripts/profile_table_wrappers.py [CHECKOUT ...]

Each checkout (default: the one holding this script) runs in a process of
its own. It builds `nomad_tpu_torch/ops/csrc/table_kernels.cu` alone into
`<checkout>/nomad_tpu_torch/_build/profile/`, then, at the main path's
table (n_pad 16,384, D 4) and m = 200 and 4,096 sorted host rows, times:

  - `scatter_set`, `overlay_add` and `feas_scatter`: the CUDA-event median
    of 51 calls after a warm-up, with the row values on the host (the
    main path's case: numpy arrays for scatter_set, as the mirror hands
    them, where the checkout takes them) and on the card, beside the
    library call (`index_copy` x2 / `index_add` / `index_copy`, idx on the
    card);
  - the host time of one call of each (perf_counter median of 400);
  - where the checkout has them, the host time of each step of the fused
    wrappers (the row check and sort, the pinned pack, the upload, the
    output allocation, the bare ctypes launch).

Prints one line `PROFILE {json}` a checkout, with the card's name and
power limit. To compare two versions, pass them in turns (A B B A ...) in
one run: two runs may land on different machines. When a checkout is
named more than once, the last line is `SUMMARY {json}`: for each
checkout, m and timing, the median, least and most of its runs. Needs a
CUDA card; imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_PAD, D = 16_384, 4
MS = (200, 4096)
TABLE_FNS = ("nomad_scatter_set", "nomad_overlay_add", "nomad_feas_scatter")


def event_ms(fn, reps=51):
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps=400):
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def profile(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout))
    import torch
    from nomad_tpu_torch.ops import kernels as K
    if not torch.cuda.is_available():
        raise SystemExit("profile_table_wrappers: no CUDA device")
    # the table kernels alone: a build of seconds, not of every source
    K.SOURCES = (K._CSRC / "table_kernels.cu",)
    K.HEADERS = ()
    K._ARGTYPES = {k: v for k, v in K._ARGTYPES.items() if k in TABLE_FNS}
    K.BUILD_DIR = checkout / "nomad_tpu_torch" / "_build" / "profile"
    lib = K.load_library()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20260417)
    used = torch.from_numpy(
        rng.uniform(0, 8000, (N_PAD, D)).astype(np.float32)).to(dev)
    ports = torch.from_numpy(
        rng.integers(0, 12000, N_PAD).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(N_PAD) > 0.3).to(dev)
    # the fused scatter_set takes the host table's numpy rows and values
    fused_set = hasattr(K, "_set_rows")
    out = {}
    for m in MS:
        idx = torch.from_numpy(np.sort(
            rng.choice(10_000, m, replace=False)).astype(np.int32))
        vals = torch.from_numpy(
            rng.uniform(-500, 500, (m, D)).astype(np.float32))
        bits = torch.from_numpy(rng.random(m) > 0.5)
        prow = torch.from_numpy(
            rng.integers(0, 12000, m).astype(np.float32))
        vals_d, bits_d, prow_d = vals.to(dev), bits.to(dev), prow.to(dev)
        idx_d = idx.to(dev, torch.long)
        if fused_set:
            set_host = (idx.numpy(), vals.numpy(), prow.numpy())
        else:
            set_host = (idx, vals, prow)
        r = {
            "scatter_set_ms": event_ms(
                lambda: K.scatter_set(used, ports, *set_host)),
            "scatter_set_card_values_ms": event_ms(
                lambda: K.scatter_set(used, ports, idx, vals_d, prow_d)),
            "index_copy_x2_ms": event_ms(
                lambda: (used.index_copy(0, idx_d, vals_d),
                         ports.index_copy(0, idx_d, prow_d))),
            "scatter_set_host_us": host_us(
                lambda: K.scatter_set(used, ports, *set_host)),
            "overlay_add_ms": event_ms(
                lambda: K.overlay_add(used, idx, vals)),
            "overlay_add_card_values_ms": event_ms(
                lambda: K.overlay_add(used, idx, vals_d)),
            "feas_scatter_ms": event_ms(
                lambda: K.feas_scatter(mask, idx, bits)),
            "feas_scatter_card_values_ms": event_ms(
                lambda: K.feas_scatter(mask, idx, bits_d)),
            "index_add_ms": event_ms(
                lambda: used.index_add(0, idx_d, vals_d)),
            "index_copy_ms": event_ms(
                lambda: mask.index_copy(0, idx_d, bits_d)),
            "overlay_add_host_us": host_us(
                lambda: K.overlay_add(used, idx, vals)),
            "feas_scatter_host_us": host_us(
                lambda: K.feas_scatter(mask, idx, bits)),
            "index_add_host_us": host_us(
                lambda: used.index_add(0, idx_d, vals_d)),
            "idx_to_card_host_us": host_us(lambda: idx.to(dev)),
            "clone_host_us": host_us(lambda: used.clone()),
            "empty_like_host_us": host_us(lambda: torch.empty_like(used)),
        }
        if hasattr(K, "_patch_on"):
            rows, _order = K._patch_rows(idx, N_PAD)
            host, _offs = K.pack_host([rows, vals.numpy()], pin=True)
            out_u = torch.empty_like(used)
            i32 = idx.to(dev)
            r.update(
                step_patch_rows_host_us=host_us(
                    lambda: K._patch_rows(idx, N_PAD)),
                step_pack_pinned_host_us=host_us(
                    lambda: K.pack_host([rows, vals.numpy()], pin=True)),
                step_upload_host_us=host_us(
                    lambda: host.to(dev, non_blocking=True)),
                step_launch_host_us=host_us(
                    lambda: lib.nomad_overlay_add(
                        used.data_ptr(), out_u.data_ptr(), i32.data_ptr(),
                        vals_d.data_ptr(), None, N_PAD, m, D,
                        K._stream(dev))))
        if fused_set:
            hi, hv, hp = set_host
            rows, _order = K._set_rows(hi, N_PAD)
            parts = [("used_rows", hv, torch.float32, (m, D)),
                     ("port_rows", hp, torch.float32, (m,))]
            o_used, o_ports = torch.empty_like(used), torch.empty_like(ports)
            i32 = idx.to(dev)
            r.update(
                set_step_rows_host_us=host_us(
                    lambda: K._set_rows(hi, N_PAD)),
                set_step_pack_pinned_host_us=host_us(
                    lambda: K.pack_host([rows, hv, hp], pin=True)),
                set_step_patch_on_host_us=host_us(
                    lambda: K._patch_on(dev, rows, None, parts)),
                set_step_outputs_host_us=host_us(
                    lambda: (torch.empty_like(used),
                             torch.empty_like(ports))),
                set_step_launch_host_us=host_us(
                    lambda: lib.nomad_scatter_set(
                        used.data_ptr(), ports.data_ptr(), o_used.data_ptr(),
                        o_ports.data_ptr(), i32.data_ptr(),
                        vals_d.data_ptr(), None, prow_d.data_ptr(), None,
                        N_PAD, m, D, K._stream(dev))))
        out[m] = r
    return out


def main(argv) -> int:
    if len(argv) > 2 and argv[1] == "--child":
        print("PROFILE " + json.dumps(
            {"checkout": argv[2], "m": profile(Path(argv[2]).resolve())}),
            flush=True)
        return 0
    checkouts = argv[1:] or [str(Path(__file__).resolve().parent.parent)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = {}
    for c in checkouts:
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", c], stdout=subprocess.PIPE,
                               text=True)
        print(child.stdout, end="", flush=True)
        if child.returncode != 0:
            return child.returncode
        for line in child.stdout.splitlines():
            if line.startswith("PROFILE "):
                runs.setdefault(c, []).append(json.loads(line[8:])["m"])
    if len(checkouts) > len(runs):
        print("SUMMARY " + json.dumps(summary(runs)), flush=True)
    return 0


def summary(runs) -> dict:
    """{checkout: {m: {timing: {median, min, max, runs}}}} over the runs
    of each checkout."""
    out = {}
    for c, profiles in runs.items():
        out[c] = {}
        for m in profiles[0]:
            out[c][m] = {}
            for key in profiles[0][m]:
                vals = [p[m][key] for p in profiles]
                out[c][m][key] = dict(median=statistics.median(vals),
                                      min=min(vals), max=max(vals),
                                      runs=len(vals))
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv))
