"""Where a step of the scan kernels goes, on the card; or how versions of
their sources compare.

    python3 scripts/profile_scan.py [--root DIR]
    python3 scripts/profile_scan.py --compare SRC [SRC ...] [--rounds R]

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
each build's median, least and most CUDA-event time.

The card's name and power limit come first. Needs a CUDA card; imports
nothing of JAX.
"""

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

from profile_common import PROBE_ACCESS, copy_sources, insert, load, \
    ptxas_report

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
FLUSH_AT = ("    for (int e = tid; e < P_MAX * C_AXIS; e += NT) "
            "a.dp_counts[e] = sh.dp[e];\n")
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


def flat(got):
    return list(got[0]) + list(got[1])


def profile(cs, kernels, S, root: Path) -> None:
    import torch
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
            kernels._LIB = prof_lib
            probed = run(**targs, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b)
                       for a, b in zip(flat(got), flat(probed))):
                raise SystemExit(f"profile: {label}: the instrumented "
                                 f"kernel's outputs differ")
            prof_lib.nomad_prof_reset()
            run(**targs, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * SLOTS)()
            prof_lib.nomad_prof_read(buf)
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


def compare(cs, kernels, S, srcs, rounds: int) -> None:
    import torch
    build = REPO / "nomad_tpu_torch" / "_build" / "compare"
    names = [s.name for s in srcs]
    libs = [load(kernels, s, build / str(i)) for i, s in enumerate(srcs)]
    for label, run, targs, kw, in_body in cases(cs, kernels, S):
        if not in_body:
            continue
        outs = []
        for lib in libs:
            kernels._LIB = lib
            outs.append(flat(run(**targs, **kw)))
            torch.cuda.synchronize()
        for name, got in zip(names[1:], outs[1:]):
            if not all(torch.equal(a, b) for a, b in zip(outs[0], got)):
                raise SystemExit(f"compare: {label}: {name}'s outputs "
                                 f"differ from {names[0]}'s")
        times = [[] for _ in libs]
        for r in range(rounds):
            order = list(range(len(libs)))
            for i in order if r % 2 == 0 else order[::-1]:
                kernels._LIB = libs[i]
                times[i].append(cs.cuda_ms(lambda: run(**targs, **kw)))
        # the choices: the first of the 13 outputs after the carry
        ran = cs.scan_steps_run(outs[0][-13], kw["k_steps"])
        print("COMPARE " + json.dumps(dict(
            case=label, steps_run=ran, rounds=rounds,
            ms={n: dict(median=statistics.median(t), least=min(t),
                        most=max(t)) for n, t in zip(names, times)})),
            flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose kernels are profiled")
    ap.add_argument("--compare", type=Path, nargs="+", metavar="SRC",
                    help="directories of the kernels' sources to time "
                         "against each other")
    ap.add_argument("--rounds", type=int, default=8)
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
                args.rounds)
    else:
        profile(cs, kernels, S, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
