// Hand-written Hopper (sm_90a) kernels for the three placement programs of
// the scheduler's main path. Each replaces one jax.jit program of the JAX
// package (nomad_tpu/ops/select.py):
//
//   chunked_kernel          <- _select_chunked_fn   (select.py:446, jit :591)
//   kway_kernel             <- _kway_core           (select.py:612, jit :772)
//   scan_kernel             <- _select_scan_fn      (select.py:180, jit :377)
//   chunked_batched_kernel  <- _chunked_batched_jit (select.py:597)
//   kway_batched_kernel     <- _select_kway_batched (select.py:785)
//   scan_batched_kernel     <- _scan_batched_jit    (select.py:395)
//
// Design (first, simple version): ONE thread block of 1024 threads per
// request. The greedy step loop (lax.while_loop / lax.scan in JAX) runs
// inside the block, so a dispatch is one launch however many steps it
// takes. Per-node state (used, coll, job_cnt, scan_placed, free_p,
// dev_slots) is updated in place in device memory, on copies the Python
// wrapper allocates; per-step outputs go to wrapper-allocated buffers.
// The body of each kernel is a __device__ function (chunked_body,
// kway_body, scan_body): the solo kernel runs it in one block, the batched
// kernel (the JAX package's vmap over B lanes) in B blocks, block b on
// lane b's inputs, carries, outputs and masked scratch, all lanes reading
// one shared capacity table. B lanes cost one launch as long as the
// slowest lane, each lane's block on its own SM.
//
// What bounds it on an H100: each step re-reads every node's columns
// (~60 bytes/node, L2-resident after the first step) and evaluates two
// double-precision pow() per node, all on ONE of the 132 SMs, followed by
// block-wide reductions (argmax, top-k) that serialise on __syncthreads.
// So a step costs the latency of one SM's sweep over the table, not the
// card's memory rate; the design accepts that to stay exact and simple.
// A batched launch fills B SMs with B such sweeps; B lanes' used columns
// (256 KB a lane at 16,384 rows) stay in the 50 MB L2. A grid-wide or
// cluster version is later work. The chunked, K-way and scan bodies have
// since been redesigned (see their sections): each evaluates every row's
// node-local terms once a launch and then only the rows its steps placed
// on.
//
// The __device__ pieces these kernels share with the node-sharded kernels
// (sharded_kernels.cu) live in select_common.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false (ops/kernels.py NVCC_FLAGS). The chunk lengths are found
// with warp ballots, not shared-memory atomicMin: with atomicMin the
// chunked kernel chose wrong winners on an H100 when ptxas optimised at
// -O2 or -O3 (and agreed at -O0/-O1); the ballot form agrees at -O3.
//
// Exactness rules kept everywhere:
//   * 10**x is (float)pow(10.0, (double)x); build with --fmad=false and no
//     fast math, so no a*b+c is contracted into an FMA;
//   * every float expression keeps the JAX program's operation order;
//   * every reduction orders by (score descending, index ascending), the
//     tie rule of jnp.argmax and lax.top_k.

#include "select_common.cuh"

// ---------------------------------------------------------------------------
// chunked: greedy while-loop; each step places a chunk on the argmax node
// that keeps beating the runner-up (select.py:446-588).
//
// Design (redesigned after the first version's full sweep, two argmax
// passes and all CHUNK_J sub-placement scores at every step):
//   * scores are node-local, so a step changes masked at its winner's row
//     only. masked is swept in full at each launch's step 0 (a
//     continuation launch too: the scratch is fresh) and at a step whose
//     top is invalid (for the counts it reports; the loop ends there);
//     every other step rescores its winner's row with local_row's own
//     pieces (row_feasible, dim_fits, free_pow, local_score_of), so the
//     two give the same bits;
//   * step 0's sweep runs across the card's SMs: chunked_sweep_kernel, one
//     row a thread, launched just before the body on the same stream,
//     copies each row's carries from the caller's (LocalCarry) into the
//     launch's own, writes masked and each of its blocks' counts; the body
//     adds the counts up (integer sums: exact in any order);
//   * the winner and the runner-up are the first two entries of a kept
//     list: the top-CHUNK_M of masked in (score desc, row asc) order, made
//     by block_topk_radix (NEG_INF ties in row order; step 0's top-5 are
//     its first five). A step takes its winner out and puts it back at its
//     new score when that still ranks above the list's last entry, and
//     drops it otherwise: every row outside the list ranks below the last
//     entry, so the list stays the exact top of masked, one shorter. A
//     list that holds every row never drops one. Below two entries the
//     list is made again from masked, which is current;
//   * after step 0 a step is one stream, fit_cap, place, one rescored row
//     and one list update: warp 0 runs step after step (chunked_steps,
//     the winner's row in its registers, __syncwarp only) while the other
//     warps wait at one barrier, and they join when the warp asks for a
//     sweep (an invalid step) or a new list, through a word every thread
//     reads after that barrier;
//   * a chunk is min(max(first loser, 1), a_max), so the winner's stream
//     against the runner-up is walked CHUNK_ROUND sub-placements a round,
//     a lane pair's two powers each (warp ballots, no atomics), until its
//     first loser or once past a_max.
// Every output and carry is bit for bit the first version's. What bounds
// it: a later step is one warp's latency (the winner's row from L2, one
// round of powers for the stream and one for the rescoring); step 0 is the
// radix list. The list's length and the pre-pass were chosen by A/B
// (scripts/profile_chunked.py --compare; PERF.md §6).
// ---------------------------------------------------------------------------
#define PRE_NT 256     // chunked_sweep_kernel's threads, one row each

// The kept list, its update and the step warp (ChunkState,
// chunk_list_update, chunked_steps) live in select_common.cuh: the
// node-sharded chunked kernels run the same step on their owner's warp.

// The body of one request: the solo kernel runs it once, the batched kernel
// once per block, each block on its own lane. `part` holds the pre-pass's
// counts of this lane's `parts` blocks: step 0's counts.
__device__ __forceinline__ void chunked_body(const LocalArgs& a,
                                             const ChunkedOut& o,
                                             const int* part, int parts) {
    __shared__ Red red;
    __shared__ TopkShared tk;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_lv[CHUNK_M];
    __shared__ int s_li[CHUNK_M];
    __shared__ int s_ctl[2];
    const int tid = threadIdx.x, warp = tid >> 5;
    for (int s = tid; s < a.max_steps; s += NT) {
        o.choice[s] = -1;
        o.chunk[s] = 0;
        o.feas[s] = 0;
        for (int k = 0; k < TOP_K; ++k) {
            o.ti[s * TOP_K + k] = -1;
            o.ts[s * TOP_K + k] = NEG_INF;
        }
        for (int dd = 0; dd < a.d; ++dd) o.exh[s * a.d + dd] = 0;
    }
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    __syncthreads();

    // the list's length: a step drops at most one entry and a launch runs
    // at most min(max_steps, k_valid) steps, so that many plus one never
    // needs a new list; at least TOP_K (step 0's top-5), at most CHUNK_M
    const int m = min(a.n, max(TOP_K, min(CHUNK_M,
                                          min(a.max_steps, a.k_valid) + 1)));
    ChunkState s = {0, 0, 0, a.k_valid, true};
    int todo = a.k_valid > 0 && a.max_steps > 0 ? CHUNK_SWEEP : CHUNK_END;
    int at = 0;   // the step a sweep reports
    while (todo != CHUNK_END) {
        if (todo == CHUNK_SWEEP) {
            Sweep sw{};
            if (at == 0) {
                // the pre-pass's counts, 0 past d; sw.cnt indexed by
                // constants only, so that it stays in registers
                for (int g = tid; g < parts; g += NT) {
                    const int* p = part + (size_t)g * (D_MAX + 1);
#pragma unroll
                    for (int dd = 0; dd < D_MAX; ++dd) sw.cnt[dd] += p[dd];
                    sw.okc += p[D_MAX];
                }
            } else {
                sw = local_sweep(a, s_ask);
            }
            // masked swept before the list reads it (the sums' barriers)
#pragma unroll
            for (int dd = 0; dd < D_MAX; ++dd) {
                if (dd < a.d) {   // uniform over the block
                    int tot = block_sum(sw.cnt[dd], red);
                    if (tid == 0) o.exh[at * a.d + dd] = tot;
                }
            }
            int okt = block_sum(sw.okc, red);
            if (tid == 0) o.feas[at] = okt;
        }
        block_topk_radix<false>(a.masked, nullptr, a.n, m, s_lv, s_li, tk);
        if (warp == 0) {
            // a sweep's top-5: the list's first five (m >= TOP_K)
            if (todo == CHUNK_SWEEP && tid < TOP_K) {
                o.ti[at * TOP_K + tid] = s_li[tid];
                o.ts[at * TOP_K + tid] = s_lv[tid];
            }
            __syncwarp();
            s.h = 0;
            s.len = m;
            const int next = chunked_steps<false>(
                a, o, s_ask, s_lv, s_li, s, m == a.n, todo == CHUNK_SWEEP);
            if (tid == 0) {
                s_ctl[0] = next;
                s_ctl[1] = s.step;
            }
        }
        __syncthreads();
        todo = s_ctl[0];
        at = s_ctl[1];
    }
    if (tid == 0) {
        o.rem[0] = s.remaining;
        o.steps[0] = s.step;
    }
}

// Step 0's sweep across the card's SMs: block (g, b) copies the carries of
// rows [g * PRE_NT, (g + 1) * PRE_NT) of lane b (`lanes`: the batched
// kernel's LocalLanes; null for one request) from c0 into the launch's
// own, writes their masked, and its counts of first failing dimensions and
// ok rows into part[(b * gridDim.x + g) * (D_MAX + 1) + k] (k < D_MAX a
// dimension, D_MAX the ok rows).
__global__ void __launch_bounds__(PRE_NT) chunked_sweep_kernel(
        LocalArgs a0, LocalCarry c0, LocalLanes l, bool lanes, int* part) {
    __shared__ float s_ask[D_MAX];
    __shared__ int s_sum[PRE_NT / 32][D_MAX + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const LocalArgs a = lanes ? local_lane(a0, l, b) : a0;
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    __syncthreads();
    Sweep r{};
    const int x = blockIdx.x * PRE_NT + tid;
    if (x < a.n) {
        copy_carry(lanes ? carry_lane(c0, a0, b) : c0, a, x);
        a.masked[x] = local_row(a, s_ask, x, r);
    }
#pragma unroll
    for (int k = 0; k <= D_MAX; ++k) {
        const int v = warp_sum(k < D_MAX ? r.cnt[k] : r.okc);
        if (lane == 0) s_sum[warp][k] = v;
    }
    __syncthreads();
    if (tid <= D_MAX) {
        int t = 0;
        for (int w = 0; w < PRE_NT / 32; ++w) t += s_sum[w][tid];
        part[((size_t)b * gridDim.x + blockIdx.x) * (D_MAX + 1) + tid] = t;
    }
}

// The pre-pass's blocks a lane, and the ints of its counts over `lanes`
// lanes (the wrappers' scratch, kernels.py _chunked_part).
static inline int chunked_parts(int n) { return (n + PRE_NT - 1) / PRE_NT; }

__global__ void __launch_bounds__(NT) chunked_kernel(LocalArgs a, ChunkedOut o,
                                                     const int* part,
                                                     int parts) {
    chunked_body(a, o, part, parts);
}

// _chunked_batched_jit (select.py:597): one block per lane. A lane whose
// loop ends early leaves its block; the outputs past its own steps keep
// their initial values, as a vmapped while_loop keeps a finished lane's
// state.
__global__ void __launch_bounds__(NT) chunked_batched_kernel(
        LocalArgs a, ChunkedOut o, LocalLanes l, const int* part,
        int parts) {
    const int b = blockIdx.x;
    chunked_body(local_lane(a, l, b), chunked_out_lane(o, b, a),
                 part + (size_t)b * parts * (D_MAX + 1), parts);
}

// ---------------------------------------------------------------------------
// K-way: each phase takes the top W nodes and gives each the prefix of its
// CHUNK_J-long score stream that stays above the (W+1)-th node's score
// (select.py:612-769). Outputs are written straight into the packed int
// layout of select.py:765-768: per row [widx (W) | chunk (W) | top-k idx (5)
// | exhausted (d) | feasible count | remaining | steps].
//
// Design (redesigned after the first version's 129 argmax passes a phase):
//   * scores are node-local, so a phase changes masked only at the rows it
//     placed on. masked is swept in full at each launch's first phase (a
//     continuation launch too: the scratch is fresh); after that, each
//     phase's winner threads rescore their own rows through local_row, the
//     sweep's own per-row function. A phase whose top is invalid sweeps
//     once more for the counts it reports (the loop ends there);
//   * top_k(masked, W + 1) is block_topk_radix: a few radix passes over
//     masked, a compaction in row order and a rank sort of <= 256
//     candidates, in place of W + 1 argmax passes;
//   * a chunk is min(max(first loser, 1), a_max), so each winner's stream
//     stops at its first loser or once past a_max, in place of all
//     W x CHUNK_J scores: a first round of 8 sub-placements for four
//     winners a warp, then every later round (32 sub-placements) of every
//     stream still open at once, shared by the warps (the double-precision
//     pow of each score is what the streams cost).
// The top-k and the stream walk (kway_streams) live in select_common.cuh:
// the node-sharded K-way kernel runs the same two, shard by shard. Every
// output is bit for bit the first version's.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void kway_body(const LocalArgs& a,
                                          const KwayOut& o) {
    __shared__ Red red;
    // the top-k's scratch, and the streams' after it (never both live)
    __shared__ union { TopkShared tk; StreamShared st; } sm;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_tv[W_MAX + 1];
    __shared__ int s_ti[W_MAX + 1];
    __shared__ float s_chunk[W_MAX];
    __shared__ float s_chunk0;
    __shared__ int s_ctl[2];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int w = o.w;
    const int stride = 2 * w + TOP_K + a.d + 3;
    for (int s = tid; s < a.max_steps; s += NT) {
        int* row = o.packed + (size_t)s * stride;
        for (int k = 0; k < w; ++k) { row[k] = -1; row[w + k] = 0; }
        for (int k = 0; k < TOP_K; ++k) {
            row[2 * w + k] = -1;
            o.ts[s * TOP_K + k] = NEG_INF;
        }
        for (int dd = 0; dd < a.d; ++dd) row[2 * w + TOP_K + dd] = 0;
        row[stride - 3] = 0;
    }
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    __syncthreads();

    int remaining = a.k_valid, step = 0;
    bool alive = true;
    Sweep sw;
    while (remaining > 0 && alive && step < a.max_steps) {
        // masked is swept in full at a launch's first phase only; after
        // that each phase rescores the rows it placed on (below), the only
        // rows whose carries it changed
        if (step == 0) {
            sw = local_sweep(a, s_ask);
            __syncthreads();
        }
        block_topk_radix<false>(a.masked, nullptr, a.n, w + 1, s_tv, s_ti,
                                sm.tk);
        const bool valid = s_tv[0] > HALF_NEG_INF;
        int* row = o.packed + (size_t)step * stride;

        if (step == 0 || !valid) {
            // a failing phase's counts: one more sweep, which rewrites
            // masked with the values it holds
            if (step > 0) sw = local_sweep(a, s_ask);
            for (int dd = 0; dd < a.d; ++dd) {
                int tot = block_sum(sw.cnt[dd], red);
                if (tid == 0) row[2 * w + TOP_K + dd] = tot;
            }
            int okt = block_sum(sw.okc, red);
            if (tid == 0) {
                row[stride - 3] = okt;
                // top_k(masked, 5) is the prefix of top_k(masked, w + 1)
                for (int k = 0; k < TOP_K; ++k) {
                    row[2 * w + k] = s_ti[k];
                    o.ts[step * TOP_K + k] = s_tv[k];
                }
            }
        } else if (tid == 0) {
            for (int k = 0; k < TOP_K; ++k) {
                row[2 * w + k] = -1;
                o.ts[step * TOP_K + k] = NEG_INF;
            }
            for (int dd = 0; dd < a.d; ++dd) row[2 * w + TOP_K + dd] = -1;
            row[stride - 3] = -1;
        }

        // the winners' chunks (kway_streams: each stream walked up to its
        // first loser), then the overshoot fallback
        kway_streams(a, s_ask, s_tv, s_ti, w, nullptr, w, sm.st, s_chunk,
                     &s_chunk0);
        __syncthreads();
        if (warp == 0) {
            const int placed = kway_fallback(s_chunk, s_chunk0, w,
                                             remaining, valid);
            if (lane == 0) {
                s_ctl[0] = remaining - placed;
                s_ctl[1] = valid ? 1 : 0;
            }
        }
        __syncthreads();
        if (tid < w) {
            // winner rows are distinct: one thread per row places, then
            // rescores its row for the next phase (a row placed with
            // chunk 0 rescores to the value it held)
            const int c = s_ti[tid];
            const float chunk = s_chunk[tid];
            const int chunk_i = (int)chunk;
            place(a, s_ask, c, chunk);
            row[tid] = chunk_i > 0 ? c : -1;
            row[w + tid] = chunk_i;
            Sweep unused{};
            a.masked[c] = local_row(a, s_ask, c, unused);
        }
        // the rescored rows before the next top-k reads them
        __syncthreads();
        remaining = s_ctl[0];
        alive = s_ctl[1] != 0;
        step += 1;
    }
    for (int s = tid; s < a.max_steps; s += NT) {
        int* r = o.packed + (size_t)s * stride;
        r[stride - 2] = remaining;
        r[stride - 1] = step;
    }
}

__global__ void __launch_bounds__(NT) kway_kernel(LocalArgs a, KwayOut o) {
    kway_body(a, o);
}

// _select_kway_batched (select.py:785): one block per lane, W shared.
__global__ void __launch_bounds__(NT) kway_batched_kernel(
        LocalArgs a, KwayOut o, LocalLanes l) {
    const int b = blockIdx.x;
    kway_body(local_lane(a, l, b), kway_out_lane(o, b, a));
}

// ---------------------------------------------------------------------------
// scan: one instance per step over k_steps steps with the full scoring
// surface — distinct_hosts, reserved-port exclusivity, distinct_property
// limits, spread stanzas (select.py:180-374). The S spread histograms and
// the P distinct-property counts live in shared memory.
//
// Design (redesigned after the first version's full evaluation of every row,
// two double-precision pow each, at every step):
//   * a step changes the node-local state of one row, its winner's, so each
//     row's node-local terms are cached in a record (ScanRecs,
//     select_common.cuh): step 0's sweep writes every row's record; after
//     a valid step, the winner's row alone is rescored by the same
//     functions (scan_local_of, scan_local_fit) before a sweep reads it;
//   * a row that is not feasible or does not fit at step 0 never is later,
//     so step 0 lists the live rows in row order, and the later steps sweep
//     only their records (scan_sweep_live), kept in the dynamic shared
//     memory as far as it holds them (about 9,400 rows) and in device
//     memory past that;
//   * the spread and distinct_property terms depend on a row only through
//     its codes, so they are per-code tables in shared memory (scan_tables:
//     a placement changes one code's entries a stanza, or the whole column
//     where the stanza's bounds move), and a row's score is composed from
//     its record and the tables with the reference's float operations in its
//     order (scan_compose): the sweep has no pow and no branch, and takes
//     as many table lookups as the request has stanzas and constraints;
//   * the last winner's outputs, update and rescoring (its two powers on
//     two lanes) run on one warp while warps 0-15 count its placement in
//     the histograms and build the step's tables and the other warps sweep
//     the other live rows; the winner's warp composes its new score from
//     the tables (handed over through a named barrier) and joins the
//     argmax;
//   * the carry changes only at a valid step, and a step is invalid from
//     the first invalid one on (step >= k_valid, or no feasible row left),
//     so every later step repeats the first invalid one: the body stops
//     there and copies its outputs into the rows after it.
// masked is written only where a step reports its top-5 and counts: step 0
// and the first invalid step. Every output and carry is bit for bit the
// first version's.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void scan_body(const ScanArgs& a,
                                          const ScanOut& o,
                                          ScanRecs r) {
    // the first live slots' records, as many as the launch's dynamic
    // shared memory holds (scan_smem)
    extern __shared__ float4 s_dyn[];
    r.srec = s_dyn;
    r.scodes = (uint2*)(s_dyn + r.ns);
    __shared__ Red red;
    __shared__ ScanShared sh;
    __shared__ ScanTables tab;
    __shared__ float s_ask[D_MAX];
    __shared__ int s_cnt[2][NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    scan_state_init(a, sh, tab, s_ask);
    __syncthreads();

    int nlive = 0;
    int won = -1;   // the last step's winner (its slot), while its update
                    // waits; then the loop ends at the first invalid step
    int step = 0;
    for (;; ++step) {
        const bool last = step == a.k_steps;
        // a step that sweeps the live slots: the last winner's outputs,
        // update and rescoring on WINNER_WARP, while the table warps count
        // its placement in the histograms and build the step's tables, and
        // then every other warp sweeps the other slots
        const bool overlap = won >= 0 && !last && step < a.k_valid;
        ScanBest sw;
        ScanCounts cs;   // set where the step reports its counts
        if (overlap) {
            if (warp == WINNER_WARP) {
                const float4 rec = scan_winner(a, o, r, s_ask, won,
                                               step - 1);
                // the step's tables, then the winner's new score
                named_sync(BAR_TABLES, 32 * (TABLE_WARPS + 1));
                sw = no_best();
                if (lane == 0)
                    sweep_slot<S_MAX, P_MAX>(sw, rec, *slot_codes(r, won),
                                             tab, won);
            } else {
                scan_tables(a, sh, tab, slot_codes(r, won), true);
                if (warp < TABLE_WARPS)
                    named_arrive(BAR_TABLES, 32 * (TABLE_WARPS + 1));
                named_sync(BAR_SWEEP, SWEEPERS);
                sw = scan_sweep_live_for(a, r, tab, nlive, won);
            }
        } else {
            // step 0 (every row's record written, the live rows listed),
            // a step at or past k_valid (the first invalid one: every row's
            // record swept for its top-5 and counts), or the end: the last
            // winner's update done before the step's tables and sweep
            if (won >= 0 && warp == WINNER_WARP)
                scan_winner(a, o, r, s_ask, won, step - 1);
            scan_tables(a, sh, tab, won >= 0 ? slot_codes(r, won) : nullptr,
                        !last);
            __syncthreads();
            if (last) break;
            if (step == 0) {
                sw = scan_sweep_build(a, s_ask, r, tab, s_cnt, &nlive, cs,
                                      0, a.n);
            } else {
                cs = scan_sweep_meta(a, r, tab, 0, a.n);
                sw = no_best();
            }
        }
        bool meta = !overlap;
        float bv = sw.bv;
        int bi = sw.bi;
        block_best(bv, bi, red);
        const bool valid = bv > HALF_NEG_INF && step < a.k_valid;
        if (!valid && !meta) {
            // no feasible row is left: this step's counts and top-5, from
            // every row's record
            cs = scan_sweep_meta(a, r, tab, 0, a.n);
            meta = true;
        }

        if (meta) {
            for (int dd = 0; dd < a.d; ++dd) {
                int tot = block_sum(cs.cnt[dd], red);
                if (tid == 0) o.exh[step * a.d + dd] = tot;
            }
            int okt = block_sum(cs.okc, red);
            if (tid == 0) o.ok_count[step] = okt;
            block_topk(a.masked, a.n, TOP_K, o.ts + step * TOP_K,
                       o.ti + step * TOP_K, red);
        } else if (warp == 1) {
            if (lane < TOP_K) {
                o.ti[step * TOP_K + lane] = -1;
                o.ts[step * TOP_K + lane] = NEG_INF;
            }
            if (lane < a.d) o.exh[step * a.d + lane] = -1;
            if (lane == 0) o.ok_count[step] = -1;
        }

        if (!valid) {
            if (tid == 0) {
                o.choice[step] = -1;
                o.final_[step] = 0.0f;
                o.binpack[step] = 0.0f;
                o.anti[step] = 0.0f;
                o.pen[step] = 0.0f;
                o.aff[step] = 0.0f;
                o.spread[step] = 0.0f;
                o.dev[step] = 0.0f;
                o.pre[step] = 0.0f;
            }
            break;
        }
        // the winner's slot is its sweeper's own best
        if (sw.bi == bi) {
            o.final_[step] = bv;
            o.spread[step] = sw.bst;
        }
        won = bi;
    }
    // the invalid step's outputs before the copies read them
    __syncthreads();
    const int stop = step;   // the first invalid step, or k_steps
    scan_finish(a, o, sh, stop);
}

__global__ void __launch_bounds__(NT) scan_kernel(ScanArgs a, ScanOut o,
                                                  ScanRecs r) {
    scan_body(a, o, r);
}

// _scan_batched_jit (select.py:395): one block per lane, each stopping at
// its own first invalid step. k_steps, s_live and p_live are the batch's
// largest; a lane's stanzas past its own count have sp_valid / dp_valid
// false and add nothing.
__global__ void __launch_bounds__(NT) scan_batched_kernel(
        ScanArgs a, ScanOut o, ScanLanes l, ScanRecs r) {
    const int b = blockIdx.x;
    scan_body(scan_lane(a, l, b), scan_out_lane(o, b, a),
              scan_recs_lane(r, b, a));
}

// ---------------------------------------------------------------------------
// Launchers: plain C entry points bound with ctypes. Each launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" int nomad_select_chunked(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* coll, const uint8_t* penalty,
        const float* affinity, float* free_p, const uint8_t* port_ok,
        float* dev_slots, const float* dev_score, const float* pre_score,
        float* masked, const float* used0, const int* coll0,
        const float* free0, const float* slots0, int n, int d, int k_valid,
        int max_steps, int spread_alg, float desired, float port_need,
        float dev_fires, int* out_choice, int* out_chunk, int* out_ti,
        float* out_ts, int* out_exh, int* out_feas, int* out_rem,
        int* out_steps, int* part, int part_ints, void* stream) {
    const int parts = chunked_parts(n);
    if (n < TOP_K || d < 2 || d > D_MAX || part_ints < parts * (D_MAX + 1))
        return (int)cudaErrorInvalidValue;
    const LocalCarry c = {used0, coll0, free0, slots0};
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, k_valid, max_steps, spread_alg,
                   desired, port_need, dev_fires};
    ChunkedOut o = {out_choice, out_chunk, out_ti, out_ts, out_exh, out_feas,
                    out_rem, out_steps};
    chunked_sweep_kernel<<<dim3(parts, 1), PRE_NT, 0,
                           (cudaStream_t)stream>>>(a, c, LocalLanes{}, false,
                                                   part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    chunked_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a, o, part, parts);
    return (int)cudaGetLastError();
}

extern "C" int nomad_select_kway(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* coll, const uint8_t* penalty,
        const float* affinity, float* free_p, const uint8_t* port_ok,
        float* dev_slots, const float* dev_score, const float* pre_score,
        float* masked, int n, int d, int k_valid, int max_steps,
        int spread_alg, float desired, float port_need, float dev_fires,
        int w, int* packed, float* out_ts, void* stream) {
    if (w < 1 || w > W_MAX || n < w + 1 || d < 2 || d > D_MAX)
        return (int)cudaErrorInvalidValue;
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, k_valid, max_steps, spread_alg,
                   desired, port_need, dev_fires};
    KwayOut o = {packed, out_ts, w};
    kway_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a, o);
    return (int)cudaGetLastError();
}

extern "C" int nomad_select_scan(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* tg_coll, int* job_cnt, int* scan_placed,
        const uint8_t* penalty, const float* affinity, float* free_p,
        const uint8_t* port_ok, float* dev_slots, const float* dev_score,
        const float* pre_score,
        const int* sp_codes, const float* sp_counts0,
        const uint8_t* sp_present0, const float* sp_desired,
        const float* sp_weight, const uint8_t* sp_has_targets,
        const uint8_t* sp_valid, const int* dp_codes,
        const float* dp_counts0, const float* dp_limit,
        const uint8_t* dp_valid,
        float* sp_counts, uint8_t* sp_present, float* dp_counts,
        float* masked, void* recs, int n, int d, int k_valid, int k_steps,
        int spread_alg, int s_live, int p_live,
        float distinct_hosts, float scan_exclusive, float desired,
        float port_need, float dev_fires, float sum_spread_w,
        int* out_choice, float* out_final, float* out_binpack,
        float* out_anti, float* out_pen, float* out_aff, float* out_spread,
        float* out_dev, float* out_pre, int* out_ti, float* out_ts,
        int* out_exh, int* out_ok, void* stream) {
    if (n < TOP_K || d < 2 || d > D_MAX || s_live < 0 || s_live > S_MAX
            || p_live < 0 || p_live > P_MAX)
        return (int)cudaErrorInvalidValue;
    ScanArgs a = {capacity, used, feasible, ask, tg_coll, job_cnt,
                  scan_placed, penalty, affinity, free_p, port_ok, dev_slots,
                  dev_score, pre_score, sp_codes, sp_counts0, sp_present0,
                  sp_desired, sp_weight, sp_has_targets, sp_valid, dp_codes,
                  dp_counts0, dp_limit, dp_valid, sp_counts, sp_present,
                  dp_counts, masked, n, d, k_valid, k_steps, spread_alg,
                  s_live, p_live, distinct_hosts, scan_exclusive, desired,
                  port_need, dev_fires, sum_spread_w};
    ScanOut o = {out_choice, out_final, out_binpack, out_anti, out_pen,
                 out_aff, out_spread, out_dev, out_pre, out_ti, out_ts,
                 out_exh, out_ok};
    static const int smem = scan_smem((const void*)scan_kernel);
    if (smem < 0) return (int)cudaErrorInvalidConfiguration;
    scan_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
        a, o, scan_recs(recs, 1, n, smem));
    return (int)cudaGetLastError();
}

// The live slots a scan kernel keeps in shared memory (the solo kernel, or
// the batched one where `batched`): *out; the sweep reads the later slots'
// records from device memory.
extern "C" int nomad_scan_shared_slots(int batched, int* out) {
    const int smem = scan_smem(batched ? (const void*)scan_batched_kernel
                                       : (const void*)scan_kernel);
    if (smem < 0) return (int)cudaErrorInvalidConfiguration;
    *out = scan_slots(smem);
    return (int)cudaSuccess;
}

// Batched entry points: B = `lanes` requests over one shared capacity table
// in one launch of `lanes` blocks. Every per-node argument is [lanes, ...]
// at its solo shape; the per-lane scalars are [lanes] device arrays.
extern "C" int nomad_select_chunked_batched(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* coll, const uint8_t* penalty,
        const float* affinity, float* free_p, const uint8_t* port_ok,
        float* dev_slots, const float* dev_score, const float* pre_score,
        float* masked, const float* used0, const int* coll0,
        const float* free0, const float* slots0, int lanes, int n, int d,
        int max_steps, int spread_alg, const int* k_valid,
        const float* desired, const float* port_need,
        const float* dev_fires, int* out_choice, int* out_chunk,
        int* out_ti, float* out_ts, int* out_exh, int* out_feas,
        int* out_rem, int* out_steps, int* part, int part_ints,
        void* stream) {
    const int parts = chunked_parts(n);
    if (lanes < 1 || n < TOP_K || d < 2 || d > D_MAX
            || part_ints < lanes * parts * (D_MAX + 1))
        return (int)cudaErrorInvalidValue;
    const LocalCarry c = {used0, coll0, free0, slots0};
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, 0, max_steps, spread_alg, 0.0f, 0.0f, 0.0f};
    ChunkedOut o = {out_choice, out_chunk, out_ti, out_ts, out_exh, out_feas,
                    out_rem, out_steps};
    LocalLanes l = {k_valid, desired, port_need, dev_fires};
    chunked_sweep_kernel<<<dim3(parts, lanes), PRE_NT, 0,
                           (cudaStream_t)stream>>>(a, c, l, true, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    chunked_batched_kernel<<<lanes, NT, 0, (cudaStream_t)stream>>>(
        a, o, l, part, parts);
    return (int)cudaGetLastError();
}

extern "C" int nomad_select_kway_batched(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* coll, const uint8_t* penalty,
        const float* affinity, float* free_p, const uint8_t* port_ok,
        float* dev_slots, const float* dev_score, const float* pre_score,
        float* masked, int lanes, int n, int d, int max_steps,
        int spread_alg, const int* k_valid, const float* desired,
        const float* port_need, const float* dev_fires,
        int w, int* packed, float* out_ts, void* stream) {
    if (lanes < 1 || w < 1 || w > W_MAX || n < w + 1 || d < 2 || d > D_MAX)
        return (int)cudaErrorInvalidValue;
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, 0, max_steps, spread_alg, 0.0f, 0.0f, 0.0f};
    KwayOut o = {packed, out_ts, w};
    LocalLanes l = {k_valid, desired, port_need, dev_fires};
    kway_batched_kernel<<<lanes, NT, 0, (cudaStream_t)stream>>>(a, o, l);
    return (int)cudaGetLastError();
}

extern "C" int nomad_select_scan_batched(
        const float* capacity, float* used, const uint8_t* feasible,
        const float* ask, int* tg_coll, int* job_cnt, int* scan_placed,
        const uint8_t* penalty, const float* affinity, float* free_p,
        const uint8_t* port_ok, float* dev_slots, const float* dev_score,
        const float* pre_score,
        const int* sp_codes, const float* sp_counts0,
        const uint8_t* sp_present0, const float* sp_desired,
        const float* sp_weight, const uint8_t* sp_has_targets,
        const uint8_t* sp_valid, const int* dp_codes,
        const float* dp_counts0, const float* dp_limit,
        const uint8_t* dp_valid,
        float* sp_counts, uint8_t* sp_present, float* dp_counts,
        float* masked, void* recs, int lanes, int n, int d, int k_steps,
        int spread_alg, int s_live, int p_live,
        const int* k_valid, const float* distinct_hosts,
        const float* scan_exclusive, const float* desired,
        const float* port_need, const float* dev_fires,
        const float* sum_spread_w,
        int* out_choice, float* out_final, float* out_binpack,
        float* out_anti, float* out_pen, float* out_aff, float* out_spread,
        float* out_dev, float* out_pre, int* out_ti, float* out_ts,
        int* out_exh, int* out_ok, void* stream) {
    if (lanes < 1 || n < TOP_K || d < 2 || d > D_MAX || s_live < 0
            || s_live > S_MAX || p_live < 0 || p_live > P_MAX)
        return (int)cudaErrorInvalidValue;
    ScanArgs a = {capacity, used, feasible, ask, tg_coll, job_cnt,
                  scan_placed, penalty, affinity, free_p, port_ok, dev_slots,
                  dev_score, pre_score, sp_codes, sp_counts0, sp_present0,
                  sp_desired, sp_weight, sp_has_targets, sp_valid, dp_codes,
                  dp_counts0, dp_limit, dp_valid, sp_counts, sp_present,
                  dp_counts, masked, n, d, 0, k_steps, spread_alg,
                  s_live, p_live, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    ScanOut o = {out_choice, out_final, out_binpack, out_anti, out_pen,
                 out_aff, out_spread, out_dev, out_pre, out_ti, out_ts,
                 out_exh, out_ok};
    ScanLanes l = {k_valid, distinct_hosts, scan_exclusive, desired,
                   port_need, dev_fires, sum_spread_w};
    static const int smem = scan_smem((const void*)scan_batched_kernel);
    if (smem < 0) return (int)cudaErrorInvalidConfiguration;
    scan_batched_kernel<<<lanes, NT, smem, (cudaStream_t)stream>>>(
        a, o, l, scan_recs(recs, lanes, n, smem));
    return (int)cudaGetLastError();
}
