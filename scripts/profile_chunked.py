"""Where the chunked kernels' time goes, on the card; or how versions of
their sources compare.

    python3 scripts/profile_chunked.py [--root DIR] [--times-only] [--others]
    python3 scripts/profile_chunked.py [--root DIR] --host
    python3 scripts/profile_chunked.py --sharded
    python3 scripts/profile_chunked.py --compare SRC [SRC ...] [--rounds R]
                                       [--others]

The cases are rows 1 and 2 of PERF.md §6 at chip_smoke.py's seeds and
shapes (10,000 nodes, padded to 16,384 rows): row 1 (chunked_kernel) at
count 10 (the main path's) and 512, and on the all-alike table at count
512, binpack and spread (under spread every winner drops out of the kept
list: a new list every 255 steps); row 2 (chunked_batched_kernel)
at B 2, 8 and 16 lanes of count 10 and B 8 of count 512.

The first form times every case with the kernels of the checkout at DIR
(default: this repository; another checkout, such as a parent commit
unpacked with `git archive`, is imported from DIR, its own
`nomad_tpu_torch` and `chip_smoke.py`, so that parent and change run in
turns in one call as separate processes): one line `TIME {json}` a case,
the CUDA-event median, least and most of 15 launches after a warm-up, and
the steps run (the longest lane's); with `--others` also rows 3, 4, 10b
and the 10c K-way, which share the sweep's row function with the chunked
body, and the 10c chunked kernels (chunked_cases: 8 lanes of count 10 at
S 2, 8, 16, 32 and the card's most, of count 512 at S 8, and the
all-alike table at count 512, one lane, binpack and spread, at S 8).
Unless `--times-only` (which a parent checkout needs, since the probes'
anchors are this body's), it then prints
`ptxas -v` and the local-memory loads and stores in the SASS (`SASS
{json}`) of chunked_kernel, chunked_batched_kernel and
chunked_sweep_kernel, and one line `PROFILE {json}` a solo case (and
block 0 of B 8, count 512) from a copy of the sources with `clock64()`
probes read by thread 0 of block 0, which is lane 0 of the step warp:
the block's turns (`sweep`: step 0's counts from the pre-pass, or a
sweep; `counts`: their block sums; `list`: the radix top-m;
`steps`: the step warp's run; `wait`: the barrier after it), summed over
the launch, and the step warp's cycles a step by section (`top`: the
list's first two, the no-meta rows, the winner's row loaded and a_max;
`stream`: the winner's sub-placements against the runner-up; `rescore`:
the placed row written and rescored, the step's outputs;
`list_update`), with the steps, the stream's rounds and the block's
turns counted. The TIME lines also give `graph_ms`: the device time of a
call (its copies, the pre-pass and the kernel), ten calls replayed from
one CUDA graph, so that no host work lies in the timed window.

`--host` times, on the host's clock (median of 300 calls, each followed
outside its window by a synchronise), the chunked wrappers at count 10
(row 1, row 2 at B 8, 10c chunked at B 8 and S 8) and each host step they
take where the checkout has it (the device check, the names, the inputs'
checks and allocations, the outputs, the route, the exchange, the
scratch): one line `HOST {json}` a wrapper. `--sharded` prints `ptxas -v`
and the SASS's local-memory loads of the two sharded chunked kernels and,
from a copy of the sources with `clock64()` probes in every block of lane
0 of the cluster route (`sharded_instrumented`), one line
`PROFILE_SHARDED {json}` a 10c case up to 16 shards: the cycles of the
report rounds, the owners' steps, a message's handling, its wait and its
sending, a list made again, with the messages, runs, steps and lists
counted and the lane's cycles.

`--compare` builds the kernels from each directory of sources SRC (a
copy of `nomad_tpu_torch/ops/csrc` with a change to A/B) into
`nomad_tpu_torch/_build/compare/`, holds each build's outputs bit for bit
against the first's at every case (with `--others` the other rows' and
the 10c cases too), and times the cases R rounds (default 8), the builds
in turn, in reverse order every other round: one line
`COMPARE {json}` a case with each build's median, least and most time,
by CUDA events around a call (`ms`, medians of 7 a round) and as device
time from a CUDA graph (`graph_ms`), through profile_common.py's
compare_builds.

The card's name and power limit come first. Needs a CUDA card; imports
nothing of JAX.
"""

import argparse
import inspect
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from profile_common import PROBE_ACCESS, compare_builds, copy_sources, \
    flat, insert, load, local_memory, probe_sums, ptxas_report

REPO = Path(__file__).resolve().parent.parent

SLOTS = 16
BLOCK = ("sweep", "counts", "list", "steps", "wait")
WARP = ("top", "stream", "rescore", "list_update")
STEPS_AT, ROUNDS_AT, TURNS_AT, BARRIER_AT = 10, 11, 12, 13

PROBE_HEADER = """
static __device__ unsigned long long g_prof[%d];
static __shared__ unsigned long long s_prof[%d];
#define CLK(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) {           \\
    const unsigned long long t_ = clock64();                            \\
    s_prof[i] += t_ - t_last; t_last = t_; } } while (0)
#define COUNT(i, v) do { if (blockIdx.x == 0 && threadIdx.x == 0)        \\
    s_prof[i] += (v); } while (0)
""" % (SLOTS, SLOTS)
START = """    if (tid < %d) s_prof[tid] = 0;
    __syncthreads();
    {
        const unsigned long long b0_ = clock64();
        for (int i_ = 0; i_ < 64; ++i_) __syncthreads();
        if (tid == 0) s_prof[%d] += clock64() - b0_;
    }
    unsigned long long t_last = clock64();
""" % (SLOTS, BARRIER_AT)
FLUSH = """    __syncthreads();
    if (blockIdx.x == 0 && tid < %d) g_prof[tid] += s_prof[tid];
""" % SLOTS
# (text a probe follows, the probe) in chunked_body, each met once
BODY_MARKS = (
    ("    while (todo != CHUNK_END) {\n",
     f"        COUNT({TURNS_AT}, 1);\n        CLK(4);\n"),
    ("                sw = local_sweep(a, s_ask);\n            }\n",
     "            CLK(0);\n"),
    ("            if (tid == 0) o.feas[at] = okt;\n", "            CLK(1);\n"),
    ("        block_topk_radix<false>(a.masked, nullptr, a.n, m, s_lv, s_li, "
     "tk);\n", "        CLK(2);\n"),
    ("                a, o, s_ask, s_lv, s_li, s, m == a.n, "
     "todo == CHUNK_SWEEP);\n",
     "            CLK(3);\n"),
)
# in chunked_steps: (text a probe follows, the probe)
STEP_MARKS = (
    ("    for (;; meta = false) {\n",
     "        unsigned long long t_last = clock64();\n"),
    ("                                  (float)s.remaining);\n",
     "        CLK(5);\n"),
    ("            const float p = free_pow(sub_after(u_h, jf, ask_h), "
     "cap_h);\n", f"            COUNT({ROUNDS_AT}, 1);\n"),
    ("        const float chunk = fminf(fmaxf((float)f, 1.0f), a_max);\n",
     "        CLK(6);\n"),
    ("            o.chunk[s.step] = chunk_i;\n        }\n",
     "        CLK(7);\n"),
    ("        chunk_list_update(lv, li, s, sv, c, whole);\n",
     f"        CLK(8);\n        COUNT({STEPS_AT}, 1);\n"),
)
KERNELS = ("chunked_kernel", "chunked_batched_kernel", "chunked_sweep_kernel")


def instrumented(src: Path, dst: Path) -> None:
    """A copy of the kernels' sources with the probes added: the step
    warp's in chunked_steps (select_common.cuh, shared with the sharded
    kernels, whose block 0 records them too), the block's in chunked_body
    (select_kernels.cu)."""
    copy_sources(src, dst)
    text = (dst / "select_kernels.cu").read_text()
    start = text.index("__device__ __forceinline__ void chunked_body(")
    end = text.index("// Step 0's sweep across the card's SMs")
    body = text[start:end]
    for anchor, probe in BODY_MARKS:
        body = insert(body, anchor, probe, anchor.strip()[:40])
    body = insert(body, "    int at = 0;   // the step a sweep reports\n",
                  START, "the body's start")
    body = insert(body, "        o.steps[0] = s.step;\n    }\n", FLUSH,
                  "the body's end")
    head = insert(text[:start], '#include "select_common.cuh"\n',
                  PROBE_ACCESS % SLOTS, "the kernels' include")
    (dst / "select_kernels.cu").write_text(head + body + text[end:])
    header = (dst / "select_common.cuh").read_text()
    at = header.index("template <bool SH>\n"
                      "__device__ __forceinline__ int chunked_steps(")
    steps = header[at:]
    for anchor, probe in STEP_MARKS:
        steps = insert(steps, anchor, probe, anchor.strip()[:40])
    header = insert(header[:at], "#define HALF_NEG_INF (-5e29f)\n",
                    PROBE_HEADER, "the header's constants") + steps
    (dst / "select_common.cuh").write_text(header)


# the cluster route's sections (chunked_cluster_body and chunk_drive in
# csrc/sharded_kernels.cu), each block of lane 0 timing its own on thread
# 0, which is lane 0 of warp 0: a report round's sweep, list and report
# (step 0, an invalid step), its cluster.sync(), what follows it (the
# heads read, the first owner found, block 0's merge) and the block
# barriers; warp 0's waits for a message, a message's handling (its heads
# into the table, the barrier armed, the other shards' best head), the
# owner's steps, and its message sent; a list made again. Counts: the
# messages received, the owners' runs, their steps, the lists made again;
# and the longest block's cycles from its start to its end (the lane's).
SHARD_SLOTS = 16
SHARD_CYCLES = ("loop", "report", "run", "recv", "wait", "exchange_report",
                "send", "after", "rebuild")
MSGS_AT_S, RUNS_AT_S, STEPS_AT_S, REBUILDS_AT_S, WALL_AT_S = 10, 11, 12, \
    13, 14
SHARD_HEADER = """
static __device__ unsigned long long g_sprof[%d];
static __shared__ unsigned long long s_sprof[%d];
static __shared__ unsigned long long s_tlast, s_t0;
static __shared__ int s_prof_on;
#define SCLK(i) do { if (s_prof_on && threadIdx.x == 0) {                \\
    const unsigned long long t_ = clock64();                            \\
    s_sprof[i] += t_ - s_tlast; s_tlast = t_; } } while (0)
#define SCOUNT(i, v) do { if (s_prof_on && threadIdx.x == 0)             \\
    s_sprof[i] += (v); } while (0)
extern "C" int nomad_sprof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_sprof, sizeof(g_sprof));
}
extern "C" int nomad_sprof_reset() {
    unsigned long long z[%d] = {0};
    return (int)cudaMemcpyToSymbol(g_sprof, z, sizeof(z));
}
""" % (SHARD_SLOTS, SHARD_SLOTS, SHARD_SLOTS)
# (text, probe, before) in chunked_cluster_body and chunk_drive, each text
# met once in its function
DRIVE_MARKS = (
    ("            chunk_msg_wait(bar, got);\n", "            SCLK(6);\n",
     True),
    ("            chunk_msg_wait(bar, got);\n",
     "            SCLK(4);\n            SCOUNT(%d, 1);\n" % MSGS_AT_S, False),
    ("        ChunkState cs = {h, len, ln.step, ln.remaining, true};\n",
     "        SCLK(3);\n        const int st0_ = ln.step;\n", True),
    ("        ln.remaining = cs.remaining;\n",
     "        SCLK(2);\n        SCOUNT(%d, 1);\n"
     "        SCOUNT(%d, ln.step - st0_);\n" % (RUNS_AT_S, STEPS_AT_S),
     False),
    ("        return kind == CMSG_META ? CLANE_META : CLANE_DONE;\n    }\n}",
     "        SCLK(6);\n", True),
)
BODY_MARKS_S = (
    ("    chunk_outputs_init(a, o, s);\n",
     "    if (tid < %d) s_sprof[tid] = 0;\n"
     "    if (tid == 0) {\n        s_prof_on = blockIdx.x < S;\n"
     "        s_tlast = s_t0 = clock64();\n    }\n" % SHARD_SLOTS, True),
    ("    // the reports, the barriers' set-up and block 0's outputs "
     "before any\n",
     "    SCLK(1);\n", True),
    ("    // block reads or sends\n    cg::this_cluster().sync();\n",
     "    SCLK(5);\n", False),
    ("    while (ln.state == CLANE_RUN) {\n", "    SCLK(7);\n", True),
    ("            chunk_shard_list(a, lo, per, m, s_lv, s_li, tk);\n",
     "            SCLK(7);\n", True),
    ("            chunk_shard_list(a, lo, per, m, s_lv, s_li, tk);\n",
     "            SCLK(8);\n            SCOUNT(%d, 1);\n" % REBUILDS_AT_S,
     False),
    ("                     s_sum, x.mine(1));\n", "        SCLK(1);\n", False),
    ("        if (s == 0) chunk_merge(x, 1, a, o, ln.step, red);\n",
     "        SCLK(5);\n", True),
    ("    // no block leaves while another may read its entries or send "
     "to it\n",
     "    SCLK(7);\n    __syncthreads();\n"
     "    if (s_prof_on && tid < %d && tid != %d)\n"
     "        atomicAdd(&g_sprof[tid], s_sprof[tid]);\n"
     "    if (s_prof_on && tid == 0)\n"
     "        atomicMax(&g_sprof[%d], clock64() - s_t0);\n"
     % (SHARD_SLOTS, WALL_AT_S, WALL_AT_S), True),
)


def sharded_instrumented(src: Path, dst: Path) -> None:
    """A copy of the kernels' sources with the cluster route's probes."""
    copy_sources(src, dst)
    text = (dst / "sharded_kernels.cu").read_text()
    start = text.index("__device__ __forceinline__ int chunk_drive(")
    mid = text.index("__device__ __forceinline__ void chunked_cluster_body(")
    end = text.index("// S <= CHUNK_CLUSTER_MAX: a lane a cluster of S "
                     "blocks.")
    drive, body = text[start:mid], text[mid:end]
    for anchor, probe, before in DRIVE_MARKS:
        drive = insert(drive, anchor, probe, anchor.strip()[:40], before)
    for anchor, probe, before in BODY_MARKS_S:
        body = insert(body, anchor, probe, anchor.strip()[:40], before)
    head = insert(text[:start], '#include "select_common.cuh"\n',
                  SHARD_HEADER, "the sharded kernels' include")
    (dst / "sharded_kernels.cu").write_text(head + drive + body + text[end:])


def cases(cs, kernels, S):
    """(label, wrapper, arguments, keyword arguments) of each case, at
    chip_smoke.py's seeds for the same shapes."""
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args, pad_rows
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    n_pad = S._pad_n(n)
    for count, seed in ((10, cs.SEED), (512, cs.SEED + 1)):
        args, st = S.pack_request(select_request_from_arrays(
            cs.request_arrays(seed, n, count, "chunked")), n_pad)
        yield (f"row 1: count {count}", kernels.select_chunked,
               sk._tensors(args, S._CHUNKED_ARGS),
               dict(max_steps=64 if count <= 64 else 512,
                    spread_alg=st["spread_alg"]))
    alike = cs._card(pad_rows(kway_edge_args(n, 512, "alike", cs.SEED + 60),
                              n_pad))
    for spread_alg in (False, True):
        yield (f"row 1: all alike, count 512, "
               f"{'spread' if spread_alg else 'binpack'}",
               kernels.select_chunked, alike,
               dict(max_steps=512, spread_alg=spread_alg))
    for case, counts in enumerate(([10] * 8, [10] * 2, [10] * 16,
                                   [512] * 8)):
        fields = cs.lane_batch("chunked", counts, cs.SEED + 100 * (case + 1))
        packs = []
        for f in fields:
            args, st = S.pack_request(select_request_from_arrays(f), n_pad)
            packs.append(args)
        yield (f"row 2: B {len(counts)}, count {counts[0]}",
               kernels.select_chunked_batched,
               sk._tensors(S.SelectKernel._stack_lanes(packs,
                                                       S._CHUNKED_ARGS),
                           S._CHUNKED_ARGS),
               dict(max_steps=64 if counts[0] <= 64 else 512,
                    spread_alg=st["spread_alg"]))


def other_cases(cs, kernels, S):
    """(label, wrapper, arguments, keyword arguments) of the rows that share
    local_row with the chunked body (select_common.cuh): rows 3 and 4 (the
    K-way body), 10b and the 10c K-way (its shards, S 8) at chip_smoke.py's
    seeds and main shapes; then the 10c chunked kernels (chunked_cases)."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    for shards in (None, 8):
        n_pad = S._pad_n(n) if shards is None \
            else pad_for_mesh(make_mesh(shards, "cuda"), n)
        sh = {} if shards is None else dict(shards=shards)
        args, st = S.pack_request(select_request_from_arrays(
            cs.request_arrays(cs.SEED + 5, n, 10_000, "kway")), n_pad)
        w = S._kway_w(n_pad)
        kw = dict(max_steps=S._kway_steps(w), spread_alg=st["spread_alg"],
                  w=w)
        yield ("row 3: count 10,000" if shards is None
               else "row 10b: count 10,000, S 8",
               kernels.select_kway_sharded if shards else kernels.select_kway,
               sk._tensors(args, S._CHUNKED_ARGS), dict(kw, **sh))
        packs = [S.pack_request(select_request_from_arrays(f), n_pad)[0]
                 for f in cs.lane_batch("kway", [2500] * 4, cs.SEED + 700)]
        targs = sk._tensors(S.SelectKernel._stack_lanes(
            packs, S._CHUNKED_ARGS), S._CHUNKED_ARGS)
        yield (f"row {'10c K-way' if shards else '4'}: B 4, count 2500"
               + (f", S {shards}" if shards else ""),
               kernels.select_kway_batched_sharded if shards
               else kernels.select_kway_batched, targs, dict(kw, **sh))
    yield from chunked_cases(cs, kernels, S)


def chunked_cases(cs, kernels, S):
    """The 10c chunked kernels (select_chunked_batched_sharded) at
    chip_smoke.py's seeds: B 8 lanes of count 10 (the mesh gateway's group
    1) at S 2, 8, 16, 32 and the most shards the card holds; B 8 of count
    512 at S 8; and the all-alike table at count 512 (one lane, binpack and
    spread) at S 8."""
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args, pad_rows
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel("cuda")
    n = cs.MAIN_NODES
    most = kernels.max_shards("chunked_batched_sharded", "cuda")
    run = kernels.select_chunked_batched_sharded
    for counts, seed, shard_list in (([10] * 8, 500, (2, 8, 16, 32, most)),
                                     ([512] * 8, 600, (8,))):
        fields = cs.lane_batch("chunked", counts, cs.SEED + seed)
        for shards in shard_list:
            n_pad = pad_for_mesh(make_mesh(shards, "cuda"), n)
            packs, st = [], None
            for f in fields:
                args, st = S.pack_request(select_request_from_arrays(f),
                                          n_pad)
                packs.append(args)
            yield (f"row 10c chunked: B {len(counts)}, count {counts[0]}, "
                   f"S {shards}", run,
                   sk._tensors(S.SelectKernel._stack_lanes(
                       packs, S._CHUNKED_ARGS), S._CHUNKED_ARGS),
                   dict(max_steps=64 if counts[0] <= 64 else 512,
                        spread_alg=st["spread_alg"], shards=shards))
    n_pad = pad_for_mesh(make_mesh(8, "cuda"), n)
    alike = pad_rows(kway_edge_args(n, 512, "alike", cs.SEED + 60), n_pad)
    lane = {k: v if k == "capacity"
            else v[None] if isinstance(v, np.ndarray)
            else np.array([v], np.int32 if k == "k_valid" else np.float32)
            for k, v in alike.items()}
    for spread_alg in (False, True):
        yield (f"row 10c chunked: all alike, count 512, "
               f"{'spread' if spread_alg else 'binpack'}, S 8", run,
               cs._card(lane),
               dict(max_steps=512, spread_alg=spread_alg, shards=8))


def steps_of(got) -> int:
    """Steps (K-way phases) the longest lane ran."""
    out = got[1]
    if len(out) == 2:   # the K-way's packed rows: steps in the last column
        return int(out[0][..., 0, -1].max())
    return int(out[7].max())


def event_ms(run, reps):
    """CUDA-event times (ms) of `reps` calls after a warm-up."""
    import torch
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def times(cs, kernels, S, root: Path, others: bool) -> None:
    todo = list(cases(cs, kernels, S))
    if others:
        todo += list(other_cases(cs, kernels, S))
    for label, run, targs, kw in todo:
        got = run(**targs, **kw)
        ms = event_ms(lambda: run(**targs, **kw), 15)
        steps = steps_of(got)
        med = statistics.median(ms)
        print("TIME " + json.dumps(dict(
            root=str(root), case=label, steps=steps, ms=med, least=min(ms),
            most=max(ms), us_a_step=med / max(steps, 1) * 1e3,
            graph_ms=cs.graph_ms(lambda: run(**targs, **kw), launches=10))),
            flush=True)


def host_us(fn, reps=300):
    """Median host time (us) of a call of `fn`, each timed alone and
    followed, outside its window, by a synchronise (so that no call waits
    for a full launch queue)."""
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


def host_cases(cs, kernels, S):
    """(label, wrapper, arguments, keyword arguments, host steps) of the
    chunked wrappers at count 10: row 1, row 2 at B 8 and 10c chunked at B
    8 and S 8. The steps are the wrapper's own helpers, each called as the
    wrapper calls it, where the checkout has them (a step it does not have
    is left out)."""
    import torch
    todo = [c for c in cases(cs, kernels, S)
            if c[0] in ("row 1: count 10", "row 2: B 8, count 10")]
    todo += [c for c in chunked_cases(cs, kernels, S)
             if c[0] == "row 10c chunked: B 8, count 10, S 8"]
    k = kernels
    for label, run, targs, kw in todo:
        dev = targs["capacity"].device
        n, d = targs["capacity"].shape
        steps = {"device check": lambda: k._is_cpu(targs["capacity"]),
                 "library": k.load_library,
                 "stream": lambda: k._stream(dev)}
        solo = label.startswith("row 1:")
        lanes = 1 if solo else targs["used0"].shape[0]
        copies = {} if "copies" not in inspect.signature(
            k._local_inputs).parameters else dict(copies=False)
        if solo:
            steps["inputs"] = lambda: k._local_inputs(
                *(targs[x] for x in k._LOCAL_INPUTS), **copies)
        else:
            steps["names"] = lambda: k._named(k.LOCAL_NAMES, targs)
            steps["inputs"] = lambda: k._local_batched(targs, **copies)
        lead = () if solo else (lanes,)
        ms = kw["max_steps"]
        if hasattr(k, "_chunked_outputs"):
            steps["outputs"] = lambda: k._chunked_outputs(
                lanes, ms, d, dev, solo=solo)
        else:
            def outputs():
                i32 = dict(dtype=torch.int32, device=dev)
                return [torch.empty(lead + s, **i32) for s in (
                    (ms,), (ms,), (ms, k.TOP_K))] + [
                    torch.empty(lead + (ms, k.TOP_K), dtype=torch.float32,
                                device=dev)] + [
                    torch.empty(lead + s, **i32)
                    for s in ((ms, d), (ms,), (2,))]
            steps["outputs"] = outputs
        if "shards" in kw:
            shards = kw["shards"]
            steps["layout"] = lambda: k._shard_layout(
                shards, n, targs.values())
            if hasattr(k, "_chunked_plan"):
                steps["route"] = lambda: k._chunked_plan(lanes, shards, dev)
            else:
                steps["route"] = lambda: k._lane_groups(
                    "chunked_batched_sharded", lanes, shards, dev)
                steps["exchange"] = lambda: k._xchg(lanes, shards, k.TOP_K,
                                                    dev)
        else:
            if "device" in inspect.signature(k._chunked_part).parameters:
                steps["scratch"] = lambda: k._chunked_part(lanes, n, dev)
        yield label, run, targs, kw, steps


def host(cs, kernels, S, root: Path) -> None:
    """One line `HOST {json}` a wrapper: its host time a call and each
    step's."""
    for label, run, targs, kw, steps in host_cases(cs, kernels, S):
        whole = host_us(lambda: run(**targs, **kw))
        parts = {name: host_us(fn) for name, fn in steps.items()}
        print("HOST " + json.dumps(dict(
            root=str(root), case=label, call_us=whole, steps_us=parts,
            rest_us=whole - sum(parts.values()))), flush=True)


def profile(cs, kernels, S, root: Path) -> None:
    for name in KERNELS:
        print(f"ptxas, {name}: "
              f"{ptxas_report(kernels, 'select_kernels.cu', name)}",
              flush=True)
        print("SASS " + json.dumps(local_memory(kernels, "select_kernels.cu",
                                                name)), flush=True)
    build = root / "nomad_tpu_torch" / "_build" / "profile_chunked"
    instrumented(kernels._CSRC, build / "src")
    plain_lib = load(kernels, kernels._CSRC, kernels.BUILD_DIR)
    prof_lib = load(kernels, build / "src", build / "probed")
    for label, run, targs, kw in cases(cs, kernels, S):
        if label.startswith("row 2") and label != "row 2: B 8, count 512":
            continue
        kernels._LIB = plain_lib
        want = flat(run(**targs, **kw))
        buf = probe_sums(kernels, prof_lib, lambda: run(**targs, **kw),
                         want, SLOTS, label)
        steps = max(int(buf[STEPS_AT]), 1)
        print("PROFILE " + json.dumps(dict(
            case=label, block0_steps=int(buf[STEPS_AT]),
            block_turns=int(buf[TURNS_AT]),
            stream_rounds=int(buf[ROUNDS_AT]),
            cycles_block={nm: int(buf[i]) for i, nm in enumerate(BLOCK)},
            cycles_a_step={nm: buf[5 + i] / steps
                           for i, nm in enumerate(WARP)},
            cycles_a_barrier=buf[BARRIER_AT] / 64)), flush=True)
    kernels._LIB = plain_lib


def sharded_profile(cs, kernels, S) -> None:
    """`ptxas -v` and the SASS's local-memory loads of the two sharded
    chunked kernels, then one line `PROFILE_SHARDED {json}` a 10c case of
    the cluster route from a copy of the sources with its probes (every
    block of lane 0, thread 0, summed over the blocks: SHARD_CYCLES, the
    counts, and the lane's cycles, from which the latency a handoff adds
    beyond the owners' own work)."""
    for name in ("chunked_batched_cluster_kernel",
                 "chunked_batched_sharded_kernel"):
        print(f"ptxas, {name}: "
              f"{ptxas_report(kernels, 'sharded_kernels.cu', name)}",
              flush=True)
        print("SASS " + json.dumps(local_memory(
            kernels, "sharded_kernels.cu", name)), flush=True)
    build = REPO / "nomad_tpu_torch" / "_build" / "profile_chunked_sharded"
    sharded_instrumented(kernels._CSRC, build / "src")
    plain_lib = load(kernels, kernels._CSRC, kernels.BUILD_DIR)
    prof_lib = load(kernels, build / "src", build / "probed")
    for label, run, targs, kw in chunked_cases(cs, kernels, S):
        kernels._LIB = plain_lib
        want = flat(run(**targs, **kw))
        buf = probe_sums(kernels, prof_lib, lambda: run(**targs, **kw),
                         want, SHARD_SLOTS, label, name="sprof")
        shards = kw["shards"]
        if shards > 16:
            continue    # the grid route has no probes
        cyc = {nm: int(buf[i]) for i, nm in enumerate(SHARD_CYCLES)}
        msgs, runs = int(buf[MSGS_AT_S]), int(buf[RUNS_AT_S])
        steps = max(int(buf[STEPS_AT_S]), 1)
        print("PROFILE_SHARDED " + json.dumps(dict(
            case=label, shards=shards, messages=msgs, runs=runs,
            steps=int(buf[STEPS_AT_S]), rebuilds=int(buf[REBUILDS_AT_S]),
            lane_cycles=int(buf[WALL_AT_S]), cycles=cyc,
            run_a_step=cyc["run"] / steps,
            recv_a_message=cyc["recv"] / max(msgs, 1),
            send_a_run=cyc["send"] / max(runs, 1),
            report_a_block=cyc["report"] / shards,
            # what the owners' work leaves of the lane's time, a handoff
            latency_a_handoff=(int(buf[WALL_AT_S]) - (
                cyc["run"] + cyc["recv"] + cyc["send"]) - (
                cyc["report"] + cyc["exchange_report"] + cyc["after"]) /
                shards) / max(runs - 1, 1))), flush=True)
    kernels._LIB = plain_lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose kernels are timed")
    ap.add_argument("--times-only", action="store_true",
                    help="no ptxas, SASS or section profile")
    ap.add_argument("--compare", type=Path, nargs="+", metavar="SRC",
                    help="directories of the kernels' sources to time "
                         "against each other")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--others", action="store_true",
                    help="also time rows 3, 4, 10b and 10c (the K-way "
                         "bodies and the sharded chunked kernels)")
    ap.add_argument("--host", action="store_true",
                    help="the chunked wrappers' host time by step only")
    ap.add_argument("--sharded", action="store_true",
                    help="the sharded chunked kernels' ptxas, SASS and "
                         "section profile only")
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
        todo = list(cases(cs, kernels, S))
        if args.others:
            todo += list(other_cases(cs, kernels, S))
        compare_builds(cs, kernels, [s.resolve() for s in args.compare],
                       REPO / "nomad_tpu_torch" / "_build" / "compare",
                       todo, args.rounds,
                       lambda out, kw: dict(steps=int(out[-1].max())),
                       graph=True)
        return 0
    if args.host:
        host(cs, kernels, S, root)
        return 0
    if args.sharded:
        sharded_profile(cs, kernels, S)
        return 0
    times(cs, kernels, S, root, args.others)
    if not args.times_only:
        profile(cs, kernels, S, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
