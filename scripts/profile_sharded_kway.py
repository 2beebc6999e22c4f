"""Where a phase of the node-sharded K-way kernel goes, on the card.

    python3 scripts/profile_sharded_kway.py

Builds two copies of the port's kernels under `nomad_tpu_torch/_build/`:
the sources as they are, and a copy whose `kway_batched_sharded_kernel`
adds up, in block 0 (shard 0 of lane 0), the `clock64()` cycles of each
section of a phase (a `__syncthreads()` closes each section, so thread 0
sees the block's time):

  sweep     the shard's sweep at phase 0
  topk      the shard's radix top-(w + 1) and its write to the exchange
  counts    the shard's counts at phase 0, and its sweep and counts once
            its own top turns invalid
  sync1     the first grid sync (the wait for the lane's slowest block)
  merge     the lane's top-(w + 1) from the S lists, and the owned winners
  streams   the owned winners' streams (kway_streams)
  sync2     the second grid sync
  place     the overshoot fallback, the owners' place and rescore

It prints `ptxas -v`'s registers, spills and shared memory of the kernel,
then for the main path's K-way request (10,000 nodes, count 10,000, W 128)
at 2, 8, 32 and the most shards the card holds, and for four lanes of
count 2,500 at 8 and 32 shards: the uninstrumented kernel's CUDA-event
median of 7 and its time a phase, the single-card kernel's on the same
padded request, and the instrumented run's cycles a phase by section.
One line `PROFILE {json}` a case; the card's name and power limit first.
Needs a CUDA card; imports nothing of JAX.
"""

import ctypes
import json
import sys
from pathlib import Path

from profile_common import PROBE_ACCESS, copy_sources, insert, load, \
    ptxas_report

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SECTIONS = ("sweep", "topk", "counts", "sync1", "merge", "streams", "sync2",
            "place")
# (text a section ends after, its index), each met once in the kernel
MARKS = (
    ("            if (step == 0) {\n                sw = local_sweep_rows(a, "
     "s_ask, lo, hi);\n                __syncthreads();\n            }\n", 0),
    ("                xg.li[s * kk + j] = s_li[j] + lo;\n            }\n", 1),
    ("                shard_counts(sw.cnt, sw.okc, a.d, xg.cnt + s * CNT_W,"
     " red);\n            }\n", 2),
    ("        if (!any_lane(x0.flag, lanes, 0)) break;\n", 3),
    ("            nown = s_ctl[2];\n", 4),
    ("                         xg.chunk, xg.chunk + W_MAX);\n", 5),
    ("        grid.sync();\n\n        if (active) {\n", 6),
    ("        // the rescored rows before the next top-k reads them\n"
     "        __syncthreads();\n", 7),
)
SLOTS = 16
PROBE = """
__device__ unsigned long long g_prof[%d];
#define PROF(i) do { __syncthreads();                                     \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {                          \\
        const unsigned long long t_ = clock64();                        \\
        g_prof[i] += t_ - t_last; t_last = t_; } } while (0)
""" % SLOTS + PROBE_ACCESS % SLOTS


def instrumented(src: Path, dst: Path) -> None:
    """A copy of the kernels' sources with the section probes added."""
    copy_sources(src, dst)
    text = (dst / "sharded_kernels.cu").read_text()
    text = insert(text, "#define CNT_W (D_MAX + 1)\n", PROBE,
                  "the kernel's constants")
    start = text.index("kway_batched_sharded_kernel(\n        LocalArgs a0")
    head, body = text[:start], text[start:]
    body = insert(body, "    while (true) {\n",
                  "    unsigned long long t_last = clock64();\n",
                  "the phase loop", before=True)
    for anchor, i in MARKS:
        probe = f"        PROF({i});\n"
        if i == 7:
            probe += ("        if (blockIdx.x == 0 && threadIdx.x == 0) "
                      "g_prof[8] += 1;\n")
        body = insert(body, anchor, probe, f"section {i}")
    (dst / "sharded_kernels.cu").write_text(head + body)


def cases(kernels, S):
    """(label, sharded kernel, single-card kernel, arguments, keyword
    arguments, shards) of each case."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    req = select_request_from_arrays(
        cs.request_arrays(cs.SEED + 5, n, 10_000, "kway"))
    lanes = cs.lane_batch("kway", [2500] * 4, cs.SEED + 700)
    most = kernels.max_shards("kway_sharded", "cuda")
    for shards in (2, 8, 32, most):
        n_pad = pad_for_mesh(make_mesh(shards, "cuda"), n)
        args, st = S.pack_request(req, n_pad)
        w = S._kway_w(n_pad)
        yield ("solo", kernels.select_kway_sharded, kernels.select_kway,
               sk._tensors(args, S._CHUNKED_ARGS),
               dict(max_steps=S._kway_steps(w), spread_alg=st["spread_alg"],
                    w=w), shards)
    for shards in (8, 32):
        n_pad = pad_for_mesh(make_mesh(shards, "cuda"), n)
        packs = [S.pack_request(select_request_from_arrays(f), n_pad)[0]
                 for f in lanes]
        w = S._kway_w(n_pad)
        yield ("B 4", kernels.select_kway_batched_sharded,
               kernels.select_kway_batched,
               sk._tensors(S.SelectKernel._stack_lanes(packs,
                                                       S._CHUNKED_ARGS),
                           S._CHUNKED_ARGS),
               dict(max_steps=S._kway_steps(w), spread_alg=False, w=w),
               shards)


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.utils.platform import device_info
    print(device_info()["raw"], flush=True)
    report = ptxas_report(kernels, "sharded_kernels.cu",
                          "kway_batched_sharded_kernel")
    print(f"ptxas, kway_batched_sharded_kernel: {report}", flush=True)
    src = kernels._CSRC
    build = ROOT / "nomad_tpu_torch" / "_build"
    instrumented(src, build / "profile_sharded" / "src")
    plain_lib = load(kernels, src, build / "profile_sharded" / "plain")
    prof_lib = load(kernels, build / "profile_sharded" / "src",
                    build / "profile_sharded" / "probed")
    for label, run, single, targs, kw, shards in cases(kernels, S):
        kernels._LIB = plain_lib
        got = run(**targs, **kw, shards=shards)
        ref = single(**targs, **kw)
        for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
            if not torch.equal(a, b):
                raise SystemExit(f"profile: {label} at {shards} shards "
                                 f"differs from the single-card kernel")
        packed = got[1][0]
        phases = int(packed.reshape(-1, packed.shape[-2],
                                    packed.shape[-1])[:, 0, -1].max())
        ms = cs.cuda_ms(lambda: run(**targs, **kw, shards=shards))
        single_ms = cs.cuda_ms(lambda: single(**targs, **kw))
        kernels._LIB = prof_lib
        run(**targs, **kw, shards=shards)
        torch.cuda.synchronize()
        prof_lib.nomad_prof_reset()
        run(**targs, **kw, shards=shards)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * SLOTS)()
        prof_lib.nomad_prof_read(buf)
        per = max(int(buf[8]), 1)
        cycles = {name: buf[i] / per for i, name in enumerate(SECTIONS)}
        print("PROFILE " + json.dumps(dict(
            case=label, shards=shards, phases=phases, ms=ms,
            us_a_phase=ms / max(phases, 1) * 1e3, single_card_ms=single_ms,
            block0_phases=int(buf[8]), cycles_a_phase=cycles,
            cycles_total=sum(cycles.values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
