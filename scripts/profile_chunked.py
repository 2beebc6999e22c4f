"""Where the chunked kernels' time goes, on the card; or how versions of
their sources compare.

    python3 scripts/profile_chunked.py [--root DIR] [--times-only]
    python3 scripts/profile_chunked.py --compare SRC [SRC ...] [--rounds R]

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
the steps run (the longest lane's); with `--others` also rows 3, 4, 10b,
the 10c K-way and the 10c chunked kernel (S 8), which share the sweep's
row function with the chunked body. Unless `--times-only` (which a parent
checkout needs, since the probes' anchors are this body's), it then prints
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

`--compare` builds the kernels from each directory of sources SRC (a
copy of `nomad_tpu_torch/ops/csrc` with a change to A/B) into
`nomad_tpu_torch/_build/compare/`, holds each build's outputs bit for bit
against the first's at every case, and times the cases R rounds (default
8), the builds in turn, in reverse order every other round: one line
`COMPARE {json}` a case with each build's median, least and most time,
by CUDA events around a call (`ms`, medians of 7 a round) and as device
time from a CUDA graph (`graph_ms`), through profile_common.py's
compare_builds.

The card's name and power limit come first. Needs a CUDA card; imports
nothing of JAX.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

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
    ("                                           m == a.n, todo == CHUNK_SWEEP);"
     "\n",
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
    """A copy of the kernels' sources with the probes added."""
    copy_sources(src, dst)
    text = (dst / "select_kernels.cu").read_text()
    start = text.index("__device__ __forceinline__ int chunked_steps(")
    end = text.index("// Step 0's sweep across the card's SMs")
    body = text[start:end]
    for anchor, probe in STEP_MARKS + BODY_MARKS:
        body = insert(body, anchor, probe, anchor.strip()[:40])
    body = insert(body, "    int at = 0;   // the step a sweep reports\n",
                  START, "the body's start")
    body = insert(body, "        o.rem_steps[1] = s.step;\n    }\n", FLUSH,
                  "the body's end")
    head = insert(text[:start], '#include "select_common.cuh"\n',
                  PROBE_ACCESS % SLOTS, "the header's include")
    (dst / "select_kernels.cu").write_text(head + body + text[end:])
    header = (dst / "select_common.cuh").read_text()
    header = insert(header, "#define HALF_NEG_INF (-5e29f)\n", PROBE_HEADER,
                    "the header's constants")
    (dst / "select_common.cuh").write_text(header)


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
    K-way body), 10b and the 10c K-way (its shards, S 8) and the 10c
    chunked kernel (S 8), at chip_smoke.py's seeds and main shapes."""
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
        for kind, counts, seed in (("kway", [2500] * 4, 700),
                                   ("chunked", [10] * 8, 500)):
            if kind == "chunked" and shards is None:
                continue
            packs = [S.pack_request(select_request_from_arrays(f), n_pad)[0]
                     for f in cs.lane_batch(kind, counts, cs.SEED + seed)]
            targs = sk._tensors(S.SelectKernel._stack_lanes(
                packs, S._CHUNKED_ARGS), S._CHUNKED_ARGS)
            kw = dict(max_steps=S._kway_steps(w), spread_alg=st["spread_alg"],
                      w=w) if kind == "kway" \
                else dict(max_steps=64, spread_alg=st["spread_alg"])
            name = f"select_{kind}_batched" + ("_sharded" if shards else "")
            row = ("4" if kind == "kway" else "2") if shards is None \
                else f"10c {'K-way' if kind == 'kway' else 'chunked'}"
            yield (f"row {row}: B {len(counts)}, count {counts[0]}"
                   + (f", S {shards}" if shards else ""),
                   getattr(kernels, name), targs, dict(kw, **sh))


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
                         "bodies and the sharded chunked kernel)")
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
        compare_builds(cs, kernels, [s.resolve() for s in args.compare],
                       REPO / "nomad_tpu_torch" / "_build" / "compare",
                       list(cases(cs, kernels, S)), args.rounds,
                       lambda out, kw: dict(steps=int(out[-1].max())),
                       graph=True)
        return 0
    times(cs, kernels, S, root, args.others)
    if not args.times_only:
        profile(cs, kernels, S, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
