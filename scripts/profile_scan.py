"""Where a step of the scan kernels goes, on the card; or how versions of
their sources compare.

    python3 scripts/profile_scan.py [--root DIR]
    python3 scripts/profile_scan.py --compare SRC [SRC ...] [--rounds R]
                                    [--sharded]
    python3 scripts/profile_scan.py --sharded [--times-only] [--root DIR]

The first form builds two copies of the kernels of the checkout at DIR
(default: this repository; another checkout, such as a parent commit
unpacked with `git archive`, is imported from DIR, its own
`nomad_tpu_torch` and `chip_smoke.py`) under DIR's
`nomad_tpu_torch/_build/`: the sources as they are, and a copy whose
`scan_body` adds up, in block 0 (the solo request, or lane 0 of a batch),
the `clock64()` cycles of each section of a step. A `__syncthreads()`
closes each section, so thread 0 sees the block's time, the closing
barrier's wait included:

  record      step 0's tables and its sweep that writes every row's
              record and lists the live rows
  step        a later step's tables and its sweep over the live rows'
              records, beside the last winner's outputs, update and
              rescoring on another warp (its critical path)
  meta_sweep  the first invalid step's tables and sweep of every row
              (where k_valid makes it invalid)
  best        block_best
  meta0       step 0's top-5 and block sums
  meta        the first invalid step's top-5 and block sums (and its
              sweep where no feasible row is left)
  outputs     a valid step's own outputs (the winner's score and spread,
              the no-meta rows)
  copies      the rows after the first invalid step, and the carries

A step that overlaps the last winner's update with the sweep has no
barrier to split the warps' work, so clocks are also read without one:
the cycles from the step's start to the tables' hand-over (thread 0), the
sweepers' start and the end of the sweep (thread 0), and the winner
warp's rescoring and new score (its lane 0); and from the winner warp's
start, its outputs and update issued, its row's terms loaded and its two
powers done. Also printed: `ptxas -v` of scan_kernel and the cycles of one
idle `__syncthreads()`.

The cases: the main path's scan request (10,000 nodes, count 200, 256
steps) and the two batched shapes (four lanes of count 200, one spread
stanza; 16 lanes of counts 16-61 with 0-2 stanzas and 0-1
distinct_property each, 64 steps): the uninstrumented kernel's CUDA-event
median of 7, its time a bucketed step and a step run, and the instrumented
run's cycles a step by section, one line `PROFILE {json}` a case; the
node-sharded scan (rows 10a and 10c, 8 shards, the same requests) timed
alone.

`--compare` builds the kernels from each SRC (a directory holding all of
the kernels' sources, such as a copy of nomad_tpu_torch/ops/csrc with one
change) into `nomad_tpu_torch/_build/compare/`, holds each build's
outputs bit for bit against the first's at every case, and then times the
scan kernels at the three cases R rounds (default 8), the builds in turn,
in reverse order every other round: one line `COMPARE {json}` a case with
each build's median, least and most CUDA-event time. With `--sharded` the
cases are rows 10a and 10c scan at S 2, 8, 16 and 32.

`--sharded` is the node-sharded scan (rows 10a and 10c scan) of the
checkout at DIR, which may be a parent commit (its own wrappers drive its
own kernels, so two versions compare only in separate runs, made in turns
in one call). It prints `ptxas -v` of the sharded scan kernels and of
scan_kernel, and one line `SASS {json}` each: their local-memory loads
and stores in the SASS, the loads counted by source line; one line
`TIME {json}` a case, the CUDA-event median of 7: rows 5 and 6 (B 4), 10a
and the 10c scan (B 4) at S 2, 8, 16, 32 and the most the card holds, 10b
and the 10c K-way at S 8, each with its steps run; one line `SYNC {json}`
a bare exchange in an empty loop of 1,000 turns (1024-thread blocks):
grid.sync() over 8, 32 and 132 blocks, and cluster.sync() in clusters of
2, 8 and 16 blocks (as many clusters as the card holds at once); and,
unless `--times-only`, one line `SHARDED {json}` at S 8 and S 32 (10a),
block 0's cycles a round by section, from a copy of sharded_kernels.cu
with `clock64()` probes (a `__syncthreads()` closing each): the parent's
body (one grid.sync() a step: sweep, best, sync, diag_merge, reduce,
diag, winner) or this one's (a round: step, report, best, sync, reduce,
outputs; with, without a barrier, the sweepers' end and the owner's
winner warp's end within an overlapped step).

The card's name and power limit come first. Needs a CUDA card; imports
nothing of JAX.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from profile_common import PROBE_ACCESS, compare_builds, copy_sources, \
    flat, insert, load, local_memory, probe_sums, ptxas_report

REPO = Path(__file__).resolve().parent.parent

NT = 1024
SLOTS = 24
SECTIONS = ("record", "step", "meta_sweep", "best", "meta0", "meta",
            "outputs", "copies")
# slots of the marks read without a barrier, each the cycles from a step's
# start (the last section's barrier) to the mark, summed over the steps
# that overlap the last winner's update with the sweep; and, from the
# winner warp's start (its lane 0), its outputs and update issued, its
# row's terms loaded, its two powers done
INNER = dict(tables_built=8, sweep_started=9, swept=10, winner_rescored=11,
             winner_composed=12, winner_updated=15, winner_terms=16,
             winner_powers=17)
OVERLAP_AT = 18    # slot: steps that overlap
BARRIER_AT = 13    # slot: cycles of 64 idle barriers
STEPS_AT = 14      # slot: steps block 0 ran

LOOP = "    for (;; ++step) {\n"
# (text a section ends after, the index of the section it closes or an
# expression choosing one), each met once in scan_body
MARKS = (
    ("        bool meta = !overlap;\n", "step == 0 ? 0 : (overlap ? 1 : 2)"),
    ("        block_best(bv, bi, red);\n", "3"),
    ("            if (lane == 0) o.ok_count[step] = -1;\n        }\n",
     "step == 0 ? 4 : (meta ? 5 : 6)"),
    ("        won = bi;\n", "6"),
)
TAIL = 7
# (text a mark follows, its slot, the thread that reads its clock)
BODY_MARKS = (
    ("                    named_arrive(BAR_TABLES, 32 * (TABLE_WARPS + 1));"
     "\n", INNER["tables_built"], 0),
    ("                named_sync(BAR_SWEEP, SWEEPERS);\n",
     INNER["sweep_started"], 0),
    ("                sw = scan_sweep_live_for(a, r, tab, nlive, won);\n",
     INNER["swept"], 0),
    ("                const float4 rec = scan_winner(a, o, r, s_ask, won,\n"
     "                                               step - 1);\n",
     INNER["winner_rescored"], NT - 32),
    ("                                             tab, won);\n",
     INNER["winner_composed"], NT - 32),
)
# marks in the header's scan_winner, from its start
WINNER_ENTRY = ("    const int lane = threadIdx.x & 31;\n"
                "    const int c = r.lrow[i];   // in L1 (scan_sweep_live)\n")
WINNER_MARKS = (
    ("        a.dev_slots[c] = v.dev_slots;\n    }\n",
     INNER["winner_updated"]),
    ("    ScanLocal l = scan_local_of(a, v);\n", INNER["winner_terms"]),
    ("                             + __shfl_sync(0xffffffffu, pw, 1));\n",
     INNER["winner_powers"]),
)
# the end of scan_body, where block 0's sums are written out
FLUSH_AT = "    scan_finish(a, o, sh, stop);\n"
# into the header: the sums in shared memory (g_prof is static, so the two
# sources that include the header each have their own)
PROBE_HEADER = """
static __device__ unsigned long long g_prof[%d];
static __shared__ unsigned long long s_prof[%d];
#define PROF(i) do { __syncthreads();                                     \\
    const unsigned long long t_ = clock64();                            \\
    if (blockIdx.x == 0 && threadIdx.x == 0) s_prof[i] += t_ - t_last;  \\
    t_last = t_; } while (0)
#define MARK(i, thread) do {                                            \\
    if (blockIdx.x == 0 && threadIdx.x == (thread))                     \\
        s_prof[i] += clock64() - t_last; } while (0)
""" % (SLOTS, SLOTS)
START = """    if (threadIdx.x < %d) s_prof[threadIdx.x] = 0;
    __syncthreads();
    {
        const unsigned long long b0_ = clock64();
        for (int i_ = 0; i_ < 64; ++i_) __syncthreads();
        if (threadIdx.x == 0) s_prof[%d] += clock64() - b0_;
    }
    unsigned long long t_last = clock64();
""" % (SLOTS, BARRIER_AT)
FLUSH = """    PROF(%d);
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x < %d)
        g_prof[threadIdx.x] += s_prof[threadIdx.x];
""" % (TAIL, SLOTS)


def instrumented(src: Path, dst: Path) -> None:
    """A copy of the kernels' sources with the section probes added."""
    copy_sources(src, dst)
    text = (dst / "select_kernels.cu").read_text()
    start = text.index("void scan_body(const ScanArgs& a")
    end = text.index("__global__ void __launch_bounds__(NT) scan_kernel")
    body = text[start:end]
    # one more step run by block 0, counted where a step's loop turn begins
    body = insert(body, LOOP, "        if (blockIdx.x == 0 && threadIdx.x == "
                  f"0) s_prof[{STEPS_AT}] += 1;\n", "the step loop")
    body = insert(body, LOOP, START, "the step loop", before=True)
    for anchor, at in MARKS:
        body = insert(body, anchor, f"        PROF({at});\n",
                      f"section {at}")
    for anchor, slot, thread in BODY_MARKS:
        mark = f"                MARK({slot}, {thread});\n"
        if slot == INNER["swept"]:
            mark += ("                if (blockIdx.x == 0 && threadIdx.x == "
                     f"0) s_prof[{OVERLAP_AT}] += 1;\n")
        body = insert(body, anchor, mark, f"mark {slot}")
    body = insert(body, FLUSH_AT, FLUSH, "the body's end")
    head = insert(text[:start], '#include "select_common.cuh"\n',
                  PROBE_ACCESS % SLOTS, "the header's include")
    (dst / "select_kernels.cu").write_text(head + body + text[end:])

    header = (dst / "select_common.cuh").read_text()
    header = insert(header, "#define HALF_NEG_INF (-5e29f)\n", PROBE_HEADER,
                    "the header's constants")
    header = insert(header, WINNER_ENTRY,
                    "    const unsigned long long t_w = clock64();\n",
                    "scan_winner's entry", before=True)
    for anchor, slot in WINNER_MARKS:
        header = insert(header, anchor, (
            f"    if (blockIdx.x == 0 && threadIdx.x == NT - 32) "
            f"s_prof[{slot}] += clock64() - t_w;\n"), f"mark {slot}")
    (dst / "select_common.cuh").write_text(header)


def cases(cs, kernels, S):
    """(label, kernel, arguments, keyword arguments, whether the kernel
    runs scan_body) of each case, at chip_smoke.py's seeds for the same
    shapes; the node-sharded scan (rows 10a and 10c) at 8 shards is timed
    beside them."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    req = select_request_from_arrays(
        cs.request_arrays(cs.SEED + 4, n, 200, "scan"))
    for shards in (None, 8):
        n_pad = S._pad_n(n) if shards is None \
            else pad_for_mesh(make_mesh(shards, "cuda"), n)
        args, st = S.pack_request(req, n_pad)
        kw = dict(k_steps=S._bucket_k(200), **st)
        if shards is None:
            yield ("row 5: n 10,000, count 200", kernels.select_scan,
                   sk._tensors(args, S._SCAN_ARGS), kw, True)
        else:
            yield ("row 10a: n 10,000, count 200, S 8",
                   kernels.select_scan_sharded,
                   sk._tensors(args, S._SCAN_ARGS), dict(kw, shards=8),
                   False)
    for case, counts, variant in ((5, [200] * 4, "one_spread"),
                                  (6, [16 + 3 * i for i in range(16)],
                                   "mixed")):
        fields = cs.lane_batch("scan", counts, cs.SEED + 100 * case, variant)
        for shards in (None, 8) if case == 5 else (None,):
            n_pad = S._pad_n(n) if shards is None \
                else pad_for_mesh(make_mesh(shards, "cuda"), n)
            packs, s_live, p_live = [], 0, 0
            for f in fields:
                a, st = S.pack_request(select_request_from_arrays(f), n_pad)
                packs.append(a)
                s_live = max(s_live, st["s_live"])
                p_live = max(p_live, st["p_live"])
            targs = sk._tensors(
                S.SelectKernel._stack_lanes(packs, S._SCAN_ARGS),
                S._SCAN_ARGS)
            kw = dict(k_steps=S._bucket_k(max(counts)),
                      spread_alg=st["spread_alg"], s_live=s_live,
                      p_live=p_live)
            label = f"B {len(counts)}, counts {min(counts)}-{max(counts)}"
            if shards is None:
                yield ("row 6: " + label, kernels.select_scan_batched,
                       targs, kw, True)
            else:
                yield (f"row 10c scan: {label}, S 8",
                       kernels.select_scan_batched_sharded, targs,
                       dict(kw, shards=8), False)


def profile(cs, kernels, S, root: Path) -> None:
    print(f"root {root}; ptxas, scan_kernel: "
          f"{ptxas_report(kernels, 'select_kernels.cu', 'scan_kernel')}",
          flush=True)
    src = kernels._CSRC
    build = root / "nomad_tpu_torch" / "_build" / "profile_scan"
    instrumented(src, build / "src")
    plain_lib = load(kernels, src, kernels.BUILD_DIR)
    prof_lib = load(kernels, build / "src", build / "probed")
    for label, run, targs, kw, profiled in cases(cs, kernels, S):
        kernels._LIB = plain_lib
        got = run(**targs, **kw)
        k = kw["k_steps"]
        ran = cs.scan_steps_run(got[1][0], k)
        ms = cs.cuda_ms(lambda: run(**targs, **kw))
        row = dict(case=label, k_steps=k, steps_run=ran, ms=ms,
                   us_a_step=ms / k * 1e3, us_a_step_run=ms / ran * 1e3)
        if profiled:
            buf = probe_sums(kernels, prof_lib, lambda: run(**targs, **kw),
                             flat(got), SLOTS, label)
            per = max(int(buf[STEPS_AT]), 1)
            over = max(int(buf[OVERLAP_AT]), 1)
            cycles = {name: buf[i] / per for i, name in enumerate(SECTIONS)}
            row.update(
                block0_steps=int(buf[STEPS_AT]), cycles_a_step=cycles,
                cycles_total=sum(cycles.values()),
                overlapping_steps=int(buf[OVERLAP_AT]),
                cycles_into_an_overlapping_step={
                    name: buf[i] / over for name, i in INNER.items()},
                cycles_a_barrier=buf[BARRIER_AT] / 64)
        print("PROFILE " + json.dumps(row), flush=True)


def compare(cs, kernels, S, srcs, rounds: int, sharded: bool) -> None:
    if sharded:
        todo = [(f"row {row}: {label}, S {shards}", run, targs, kw)
                for label, row, shards, run, targs, kw
                in sharded_cases(cs, kernels, S)
                if row in ("10a", "10c scan") and shards in COMPARE_SHARDS]
    else:
        todo = [(label, run, targs, kw)
                for label, run, targs, kw, in_body in cases(cs, kernels, S)
                if in_body]
    # the choices: the first of the 13 outputs after the carry
    compare_builds(cs, kernels, srcs,
                   REPO / "nomad_tpu_torch" / "_build" / "compare", todo,
                   rounds, lambda out, kw: dict(steps_run=cs.scan_steps_run(
                       out[-13], kw["k_steps"])))


# -- the node-sharded scan ----------------------------------------------------

# the bare exchanges, each in an empty loop of ITERS turns
SYNC_SRC = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(1024) grid_loop(int iters,
                                                  long long* out) {
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) cg::this_grid().sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64() - t0;
}
__global__ void __launch_bounds__(1024) cluster_loop(int iters,
                                                     long long* out) {
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) cg::this_cluster().sync();
    if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = clock64() - t0;
}
extern "C" int bare_grid(int blocks, int iters, long long* out) {
    void* args[] = {&iters, &out};
    return (int)cudaLaunchCooperativeKernel((const void*)grid_loop,
                                            dim3(blocks), dim3(1024), args,
                                            0, 0);
}
// clusters <= 0: as many as the card holds at once
extern "C" int bare_cluster(int size, int clusters, int iters,
                            long long* out, int* held) {
    cudaFuncSetAttribute((const void*)cluster_loop,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t c = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = size;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    c.blockDim = dim3(1024);
    c.gridDim = dim3(size);
    c.attrs = at;
    c.numAttrs = 1;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        held, (const void*)cluster_loop, &c);
    if (e != cudaSuccess) return (int)e;
    c.gridDim = dim3(size * (clusters > 0 ? clusters : *held));
    return (int)cudaLaunchKernelEx(&c, cluster_loop, iters, out);
}
"""
ITERS = 1000
# the sharded scan's shard counts `--compare --sharded` times
COMPARE_SHARDS = (2, 8, 16, 32)


def bare_syncs(kernels, build: Path) -> None:
    """The cost of one bare grid.sync() and one cluster.sync(): cycles a
    turn in block 0 (clock64) and microseconds a turn (CUDA events)."""
    import torch
    build.mkdir(parents=True, exist_ok=True)
    (build / "bare_sync.cu").write_text(SYNC_SRC)
    so = build / "bare_sync.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(build / "bare_sync.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    held = ctypes.c_int(0)
    runs = [("grid.sync", b, lambda b=b: lib.bare_grid(
        b, ITERS, ctypes.c_void_p(out.data_ptr()))) for b in (8, 32, 132)]
    runs += [("cluster.sync", c, lambda c=c: lib.bare_cluster(
        c, 0, ITERS, ctypes.c_void_p(out.data_ptr()), ctypes.byref(held)))
        for c in (2, 8, 16)]
    for what, size, launch in runs:
        ms = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = launch()
            b.record()
            b.synchronize()
            if rc != 0:
                raise SystemExit(f"profile: {what} over {size}: CUDA "
                                 f"error {rc}")
            ms.append(a.elapsed_time(b))
        row = dict(sync=what, blocks=size,
                   cycles_a_turn=int(out.item()) / ITERS,
                   us_a_turn=statistics.median(ms) * 1e3 / ITERS)
        if what == "cluster.sync":
            row["clusters"] = held.value
        print("SYNC " + json.dumps(row), flush=True)


def sharded_cases(cs, kernels, S):
    """(label, row, shards, kernel, arguments, keyword arguments) of each
    timed case, at chip_smoke.py's seeds and shapes."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    most = kernels.max_shards("scan_sharded", "cuda")
    counts = [2, 8, 16, 32, most]

    def pad(shards):
        return S._pad_n(n) if shards is None \
            else pad_for_mesh(make_mesh(shards, "cuda"), n)
    req = select_request_from_arrays(
        cs.request_arrays(cs.SEED + 4, n, 200, "scan"))
    for shards in [None] + counts:
        args, st = S.pack_request(req, pad(shards))
        targs = sk._tensors(args, S._SCAN_ARGS)
        kw = dict(k_steps=S._bucket_k(200), **st)
        if shards is None:
            yield "n 10,000, count 200", "5", None, kernels.select_scan, \
                targs, kw
        else:
            yield "n 10,000, count 200", "10a", shards, \
                kernels.select_scan_sharded, targs, dict(kw, shards=shards)
    # row 6 at phase 6's seed, the 10c scan at phase 9's (chip_smoke.py)
    lanes = {None: cs.lane_batch("scan", [200] * 4, cs.SEED + 500,
                                 "one_spread"),
             8: cs.lane_batch("scan", [200] * 4, cs.SEED + 600,
                              "one_spread")}
    for shards in [None] + counts:
        fields = lanes[None if shards is None else 8]
        packs, s_live, p_live = [], 0, 0
        for f in fields:
            a, st = S.pack_request(select_request_from_arrays(f),
                                   pad(shards))
            packs.append(a)
            s_live, p_live = max(s_live, st["s_live"]), max(p_live,
                                                            st["p_live"])
        targs = sk._tensors(S.SelectKernel._stack_lanes(packs, S._SCAN_ARGS),
                            S._SCAN_ARGS)
        kw = dict(k_steps=S._bucket_k(200), spread_alg=st["spread_alg"],
                  s_live=s_live, p_live=p_live)
        if shards is None:
            yield "B 4, count 200", "6", None, kernels.select_scan_batched, \
                targs, kw
        else:
            yield "B 4, count 200", "10c scan", shards, \
                kernels.select_scan_batched_sharded, targs, \
                dict(kw, shards=shards)
    shards = 8
    req = select_request_from_arrays(
        cs.request_arrays(cs.SEED + 5, n, 10_000, "kway"))
    args, st = S.pack_request(req, pad(shards))
    w = S._kway_w(pad(shards))
    yield "n 10,000, count 10,000", "10b", shards, \
        kernels.select_kway_sharded, sk._tensors(args, S._CHUNKED_ARGS), \
        dict(max_steps=S._kway_steps(w), spread_alg=st["spread_alg"], w=w,
             shards=shards)
    fields = cs.lane_batch("kway", [2500] * 4, cs.SEED + 700)
    packs = [S.pack_request(select_request_from_arrays(f), pad(shards))[0]
             for f in fields]
    w = S._kway_w(pad(shards))
    yield "B 4, count 2,500", "10c K-way", shards, \
        kernels.select_kway_batched_sharded, \
        sk._tensors(S.SelectKernel._stack_lanes(packs, S._CHUNKED_ARGS),
                    S._CHUNKED_ARGS), \
        dict(max_steps=S._kway_steps(w), spread_alg=st["spread_alg"], w=w,
             shards=shards)


# The sharded scan's sections, each (text a probe follows, or precedes
# where the index is negative: -(index + 1)), in the parent's body (one
# grid.sync() a step; the kernel scan_batched_sharded_kernel) and in this
# one's (scan_shard_body's rounds)
PARENT_LOOP = "    for (int step = 0; step < a.k_steps; ++step) {\n"
PARENT_SECTIONS = ("sweep", "best", "sync", "diag_merge", "reduce", "diag",
                   "winner")
PARENT_MARKS = (
    ("        block_best(bv, bi, red);\n", -1),
    ("        block_best(bv, bi, red);\n", 1),
    ("        grid.sync();\n", 2),
    ("        pending = -1;\n", 3),
    ("        block_best(gv, gi, red);\n", 4),
    ("            o.ok_count[step] = -1;\n        }\n", 5),
    ("    }\n    grid.sync();\n    if (s == 0) {\n", -7),
)
PARENT_END = ("            a.sp_present[e] = sh.pres[e];\n        }\n"
              "        for (int e = tid; e < P_MAX * C_AXIS; e += NT)\n"
              "            a.dp_counts[e] = sh.dp[e];\n    }\n")
SHARD_LOOP = "    for (int round = 0;; ++round) {\n"
SHARD_SECTIONS = ("step", "report", "best", "sync", "reduce", "outputs")
SHARD_MARKS = (
    ("                if (report) shard_report(a, cs, lo, per, &me->m, "
     "red);\n", -1),
    ("                if (report) shard_report(a, cs, lo, per, &me->m, "
     "red);\n", 1),
    ("        if (state == LANE_RUN && !last) {\n            "
     "x.exchange(par);\n", -3),
    ("            x.barrier(par);\n        }\n", 3),
    ("                    if (lane == 0) o.ok_count[step] = -1;\n"
     "                }\n            }\n", 4),
    ("        if (!x.more(state != LANE_DONE)) break;\n", -6),
)
SHARD_END = "    if (s == 0) scan_finish(a, o, sh, step);\n"
# after shard_step: the sweepers' end (thread 0) and, where block 0 owns
# the last winner, its warp's end (the owner's update, rescoring and new
# score), both from the round's start; slots
SHARD_STEP = ("                sw = shard_step(a, o, r, sh, tab, s_ask, "
              "won, wc, nlive,\n                                step);\n")
SWEPT_AT, OWNER_AT, OWNED_AT, OVERLAPS_AT = 16, 17, 18, 19
# within an exchange round, summed over those rounds: from the "best"
# section's end, the exchange done (thread 0); from the "sync" section's
# end, the winner read and block 0's outputs written (threads 0 and 32)
EXCHANGED_AT = 12
WINNER_AT = (20, 21)
WRITTEN_AT = (22, 23)
SHARD_EXCHANGE = "            x.exchange(par);\n"
SHARD_WINNER = "            const ScanCand g = x.winner(par);\n"
SHARD_WRITTEN = ("                    if (lane == 0) o.ok_count[step] = -1;\n"
                 "                }\n            }\n")


def sharded_instrumented(src: Path, dst: Path) -> tuple:
    """A copy of the sources whose sharded scan sums block 0's cycles by
    section; returns the section names."""
    copy_sources(src, dst)
    text = (dst / "sharded_kernels.cu").read_text()
    ours = "scan_shard_body" in text
    if ours:
        start = text.index("__device__ __forceinline__ void scan_shard_body(")
        end = text.index("// A lane's shard s of per rows: its slots at")
        loop, marks, tail, names = SHARD_LOOP, SHARD_MARKS, SHARD_END, \
            SHARD_SECTIONS
    else:
        start = text.index("__global__ void __launch_bounds__(NT) "
                           "scan_batched_sharded_kernel(")
        end = text.index("// chunked over S shards a lane")
        loop, marks, tail, names = PARENT_LOOP, PARENT_MARKS, PARENT_END, \
            PARENT_SECTIONS
    body = text[start:end]
    body = insert(body, loop, "        if (blockIdx.x == 0 && threadIdx.x == "
                  f"0) s_prof[{STEPS_AT}] += 1;\n", "the loop")
    body = insert(body, loop, START, "the loop", before=True)
    for anchor, at in marks:
        before = at < 0
        body = insert(body, anchor,
                      f"        PROF({-at - 1 if before else at});\n",
                      f"section {at}", before=before)
    if ours:
        body = insert(body, SHARD_STEP, (
            f"                MARK({SWEPT_AT}, 0);\n"
            "                if (blockIdx.x == 0 && threadIdx.x == NT - 32 "
            "&& won >= 0) {\n"
            f"                    s_prof[{OWNER_AT}] += clock64() - t_last;\n"
            f"                    s_prof[{OWNED_AT}] += 1;\n"
            "                }\n"
            "                if (blockIdx.x == 0 && threadIdx.x == 0) "
            f"s_prof[{OVERLAPS_AT}] += 1;\n"), "the overlapped step")
        body = insert(body, SHARD_EXCHANGE,
                      f"            MARK({EXCHANGED_AT}, 0);\n",
                      "the exchange")
        body = insert(body, SHARD_WINNER, (
            f"            MARK({WINNER_AT[0]}, 0);\n"
            f"            MARK({WINNER_AT[1]}, 32);\n"), "the winner")
        body = insert(body, SHARD_WRITTEN, (
            f"            MARK({WRITTEN_AT[0]}, 0);\n"
            f"            MARK({WRITTEN_AT[1]}, 32);\n"), "the outputs")
    flush = """    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x < %d)
        g_prof[threadIdx.x] += s_prof[threadIdx.x];
""" % SLOTS
    body = insert(body, tail, flush, "the body's end")
    head = insert(text[:start], '#include "select_common.cuh"\n',
                  PROBE_HEADER, "the include")
    (dst / "sharded_kernels.cu").write_text(
        head + body + text[end:] + PROBE_ACCESS % SLOTS)
    return names, ours


def sharded(cs, kernels, S, root: Path, times_only: bool) -> None:
    import torch
    ours = hasattr(kernels, "scan_sharded_info")
    names = ["scan_batched_cluster_kernel", "scan_batched_sharded_kernel"] \
        if ours else ["scan_batched_sharded_kernel"]
    for name in names + ["scan_kernel"]:
        src = "select_kernels.cu" if name == "scan_kernel" \
            else "sharded_kernels.cu"
        print(f"root {root}; ptxas, {name}: "
              f"{ptxas_report(kernels, src, name)}", flush=True)
        print("SASS " + json.dumps(local_memory(kernels, src, name)),
              flush=True)
    build = root / "nomad_tpu_torch" / "_build" / "profile_sharded"
    plain_lib = load(kernels, kernels._CSRC, kernels.BUILD_DIR)
    for label, row, shards, run, targs, kw in sharded_cases(cs, kernels, S):
        got = run(**targs, **kw)
        torch.cuda.synchronize()
        ms = cs.cuda_ms(lambda: run(**targs, **kw))
        out = dict(row=row, case=label, shards=shards, ms=ms)
        if row.startswith("10b") or row.startswith("10c K"):
            packed = got[1][0].reshape(-1, *got[1][0].shape[-2:])
            out["phases"] = int(packed[:, 0, -1].max())
        else:
            out["steps_run"] = cs.scan_steps_run(got[1][0], kw["k_steps"])
            out["us_a_step_run"] = ms / out["steps_run"] * 1e3
        if ours and shards is not None and row in ("10a", "10c scan"):
            per = targs["capacity"].shape[0] // shards
            out.update(kernels.scan_sharded_info(shards, per))
        print("TIME " + json.dumps(out), flush=True)
    bare_syncs(kernels, build)
    if times_only:
        return
    sections, _ = sharded_instrumented(kernels._CSRC, build / "src")
    prof_lib = load(kernels, build / "src", build / "probed")
    for label, row, shards, run, targs, kw in sharded_cases(cs, kernels, S):
        if row != "10a" or shards not in (8, 32):
            continue
        kernels._LIB = plain_lib
        want = flat(run(**targs, **kw))
        buf = probe_sums(kernels, prof_lib, lambda: run(**targs, **kw),
                         want, SLOTS, f"10a S {shards}")
        rounds = max(int(buf[STEPS_AT]), 1)
        out = dict(row=row, shards=shards, rounds=int(buf[STEPS_AT]),
                   cycles_a_round={nm: buf[i] / rounds
                                   for i, nm in enumerate(sections)},
                   cycles_a_barrier=buf[BARRIER_AT] / 64)
        out["cycles_total"] = sum(out["cycles_a_round"].values())
        if sections == SHARD_SECTIONS:
            over = max(int(buf[OVERLAPS_AT]), 1)
            owned = max(int(buf[OWNED_AT]), 1)
            out.update(overlapped_rounds=int(buf[OVERLAPS_AT]),
                       swept_at=buf[SWEPT_AT] / over,
                       owned_rounds=int(buf[OWNED_AT]),
                       owner_done_at=buf[OWNER_AT] / owned,
                       after_best={
                           "exchanged": buf[EXCHANGED_AT] / rounds,
                           "winner_read": [buf[i] / rounds
                                           for i in WINNER_AT],
                           "outputs_written": [buf[i] / rounds
                                               for i in WRITTEN_AT]})
        print("SHARDED " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose kernels are profiled")
    ap.add_argument("--compare", type=Path, nargs="+", metavar="SRC",
                    help="directories of the kernels' sources to time "
                         "against each other")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--sharded", action="store_true",
                    help="time and profile the node-sharded scan")
    ap.add_argument("--times-only", action="store_true",
                    help="with --sharded: no section profile")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.utils.platform import device_info
    if Path(kernels.__file__).resolve().parents[2] != root:
        raise SystemExit(f"profile: imported {kernels.__file__}, not {root}")
    print(device_info()["raw"], flush=True)
    if args.compare:
        compare(cs, kernels, S, [s.resolve() for s in args.compare],
                args.rounds, args.sharded)
    elif args.sharded:
        sharded(cs, kernels, S, root, args.times_only)
    else:
        profile(cs, kernels, S, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
