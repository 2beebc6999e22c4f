// Hand-written Hopper (sm_90a) kernels for the node-sharded (mesh) placement
// path. Each replaces a jax.jit program of the JAX package run SPMD over a
// `nodes` mesh, where XLA splits the node axis over the mesh's devices,
// replicates the lane axis of a batch, and inserts the cross-shard
// collectives (nomad_tpu/parallel/sharded.py):
//
//   scan_batched_sharded_kernel    <- _select_scan over the mesh (one lane:
//                                     parallel/sharded.py:73-98 on
//                                     select.py:180) and _scan_batched_jit
//                                     over it (select.py:2257 on :395)
//   kway_batched_sharded_kernel    <- _select_kway over the mesh (one lane:
//                                     select.py:1870-1892, sharded.py:198
//                                     on select.py:612) and
//                                     _select_kway_batched over it
//                                     (select.py:2028-2043 on :785)
//   chunked_batched_sharded_kernel <- _chunked_batched_jit over the mesh
//                                     (select.py:2179 on :597)
//
// Here every shard of the mesh lives on ONE card. A launch covers B lanes
// (requests over one shared capacity table) split into S shards each: block
// lane * S + shard owns that lane's table rows [s*per, (s+1)*per) of the
// table padded by pad_for_mesh (parallel/sharded_table.py; padded rows are
// infeasible) and sweeps them on its own SM. The launch is cooperative
// (cudaLaunchCooperativeKernel), so all B * S blocks are resident at once
// and the step loop stays on the device: XLA's collectives become exchanges
// through global memory between grid-wide syncs
// (cooperative_groups::this_grid().sync()), each lane through its own slice
// of the exchange buffers. Every block of a lane reduces that lane's S
// candidates itself, in the same order, so the lane's replicated state (the
// winner, the spread and distinct_property histograms, `remaining`) is
// identical in all its blocks without a broadcast. Lanes share only the
// read-only capacity.
//
// A grid sync is grid-wide: every block calls it the same number of times,
// whatever its lane is doing. So each decision around a sync (run another
// step; is any lane still placing) is taken from values every block reads
// alike after a sync; a finished lane's blocks keep syncing and do no work.
//
// scan, each step (k_steps for every lane): every block sweeps its rows and
// writes its local best (score, global row) to a buffer chosen by step
// parity; one grid sync; every block of the lane takes the best of the S
// candidates. On step 0 and on invalid steps each block also writes its
// local top-5 and its counts (by parity), and the lane's block 0 merges
// them after the NEXT step's sync (or the final one), so a step costs one
// sync. The winner's owner recomputes its score components from the state
// before the update (as scan_body does) and applies the per-node carry
// updates; every block of the lane applies the same histogram updates.
//
// chunked, each step: every block of a running lane writes its shard's best
// two (score, global row) (best five on step 0, with its counts); one grid
// sync; every block of the lane merges the S lists into the winner and the
// runner-up (exact: the global runner-up is the winner's shard's second or
// another shard's first). The winner's owner scores the CHUNK_J stream
// against the runner-up, places the chunk and publishes (runs the next
// step, remaining) by parity; every block reads it after the next step's
// sync. A lane's blocks sweep the next step unless its winner was invalid
// or its budget is spent, and a sweep the published count shows was not
// needed writes nothing but scratch. An invalid step's top-5 and counts
// are merged after the next sync. The loop ends after the first sync at
// which no lane of the launch runs.
//
// K-way, each phase (the single-card body's design, kway_body, shard by
// shard): every block of a running lane takes its shard's top-(w + 1) by
// the radix top-k (block_topk_radix over its own rows of masked: its
// whole slice when that is shorter) and writes it, with global rows, to
// the exchange; a grid sync; every block of the lane takes the lane's
// top-(w + 1) from the S lists by the same radix top-k, reading them end
// to end in shard order (a shard's rows all lie below the next shard's
// and each list is sorted, so among equal scores position order is row
// order and the result is lax.top_k's, ties at NEG_INF included). Its
// last entry is the waterline. Each block walks the streams of the
// winners its shard owns (kway_streams, the single-card body's stream
// walk: each stops at its first loser or past a_max; winner 0's also
// against the runner-up) and writes their chunks; a second grid sync;
// every block applies the overshoot fallback (select.py:716-728) to the W
// chunks, so `remaining` agrees everywhere, and the owners place their
// winners and rescore those rows (local_row, the sweep's own per-row
// function): a block sweeps its shard only at a launch's first phase (a
// continuation launch too: the scratch is fresh). The lane's top is
// invalid only where every shard's is, so a block reports its counts at
// phase 0 and once its own top turns invalid, after one more sweep of its
// shard; no row of a shard without a feasible row is placed on again, so
// those counts stand for the rest of the launch. The lane's block 0
// publishes whether the lane runs the next phase; every block reads all
// lanes' flags after the next phase's first sync.
//
// Exactness: the rules of select_kernels.cu, through the same pieces
// (select_common.cuh). Every cross-shard reduction is exact: integer sums,
// and arg-max / top-k merges under (score desc, global row asc), whose
// result does not depend on how the rows were split. So each lane's outputs
// equal the single-card kernel's on the same padded lane, bit for bit.
//
// What bounds it on an H100: latency, as for the solo kernels, not bytes or
// operations. A shard sweeps 1/S of the table, but every step adds a grid
// sync (two a K-way phase) and block-wide reductions over the S candidates
// (the K-way's over S * min(w + 1, per) of them: at S 132 the whole
// table).
// One 1024-thread block per shard keeps the shared device functions as they
// are; at large S most of a block's threads idle. B * S may not exceed the
// blocks the card holds at once (nomad_sharded_max_blocks): a cooperative
// launch over more is refused, so the wrappers launch the lanes in groups.
//
// The exchange buffers are read with __ldcg (through L2, never the SM's own
// L1, which is not coherent across SMs) after the grid sync that orders
// them after their writes.

#include <cooperative_groups.h>
#include "select_common.cuh"

namespace cg = cooperative_groups;

#define CNT_W (D_MAX + 1)

// Cross-shard exchange buffers in global memory, allocated by the wrapper;
// lane b's blocks use its slice (xchg_lane). A buffer kept "by parity" has
// one half for even steps and one for odd, so what a step writes before a
// grid sync stays readable until the next one.
struct ShardXchg {
    float* lv;     // [lanes, 2, S, kl] each shard's candidates, by parity
    int* li;       //   (scan kl = 1, its best; chunked 5; K-way w + 1,
                   //   of which it fills min(w + 1, per) a shard, end to
                   //   end, in parity 0)
    float* dv;     // [lanes, 2, S, TOP_K] a diagnostic step's top-5, by
    int* di;       //   parity
    int* cnt;      // [lanes, 2, S, CNT_W] first-failing-dimension counts,
                   // then the feasible count, by parity
    float* chunk;  // [lanes, W_MAX + 1] K-way: the winners' chunks; [W_MAX]
                   // holds winner 0's chunk against the runner-up
    int* flag;     // [lanes, 2, 2] chunked: (runs the next step, remaining
                   // after this one), by parity; K-way: [0] runs the next
                   // phase
    int shards, per, kl;
};

__device__ __forceinline__ ShardXchg xchg_lane(ShardXchg x, int b) {
    const size_t s2 = 2 * (size_t)x.shards;
    x.lv += b * s2 * x.kl;
    x.li += b * s2 * x.kl;
    x.dv += b * s2 * TOP_K;
    x.di += b * s2 * TOP_K;
    x.cnt += b * s2 * CNT_W;
    x.chunk += (size_t)b * (W_MAX + 1);
    x.flag += (size_t)b * 4;
    return x;
}

// Offset of shard s's entry of k values in a [2, S, k] by-parity buffer.
__device__ __forceinline__ size_t at(const ShardXchg& x, int par, int s,
                                     int k) {
    return ((size_t)par * x.shards + s) * k;
}

// Block-wide: the first kout entries, in (value desc, row asc) order, of
// the union of `lists` sorted lists (list t's k entries at t * stride),
// which other blocks wrote before a grid sync. Thread t < lists walks list
// t, and each pass takes the best of the lists' heads. Thread 0 writes
// ov[j], oi[j]. Needs at least kout real entries in the union: a sentinel
// (-inf, INT_MAX) is never taken.
static __device__ void merge_sorted(const float* lv, const int* li,
                                    int lists, int stride, int k, int kout,
                                    float* ov, int* oi, Red& r) {
    const int t = threadIdx.x;
    int head = 0;
    for (int j = 0; j < kout; ++j) {
        float v = -INFINITY;
        int i = INT_MAX;
        if (t < lists && head < k) {
            v = __ldcg(lv + t * stride + head);
            i = __ldcg(li + t * stride + head);
        }
        const int mine = i;
        block_best(v, i, r);
        if (t < lists && head < k && mine == i) ++head;
        if (t == 0) {
            ov[j] = v;
            oi[j] = i;
        }
    }
}

// Block-wide: the block's top-k over its rows [lo, lo + per) of `masked`,
// sorted, with global rows, into its entry of the exchange (tv, ti);
// entries past the shard's rows are (-inf, INT_MAX).
static __device__ void shard_topk(const float* masked, int lo, int per,
                                  int k, float* tv, int* ti, Red& r) {
    const int kk = k < per ? k : per;
    block_topk(masked + lo, per, kk, tv, ti, r);
    if (threadIdx.x == 0) {
        for (int j = 0; j < kk; ++j) ti[j] += lo;
        for (int j = kk; j < k; ++j) {
            tv[j] = -INFINITY;
            ti[j] = INT_MAX;
        }
    }
}

// Block-wide: the block's exhaustion counts (d of them) and feasible count
// into its entry of the exchange.
__device__ __forceinline__ void shard_counts(const int* cnt, int okc, int d,
                                             int* out, Red& r) {
    for (int dd = 0; dd < d; ++dd) {
        const int tot = block_sum(cnt[dd], r);
        if (threadIdx.x == 0) out[dd] = tot;
    }
    const int okt = block_sum(okc, r);
    if (threadIdx.x == 0) out[D_MAX] = okt;
}

// One thread: the S shards' counts (cnt, S entries of CNT_W) summed into a
// step's outputs.
static __device__ void sum_counts(const int* cnt, int shards, int d,
                                  int* exh, int* ok) {
    for (int dd = 0; dd <= d; ++dd) {
        const int col = dd < d ? dd : D_MAX;
        int tot = 0;
        for (int s = 0; s < shards; ++s) tot += __ldcg(cnt + s * CNT_W + col);
        if (dd < d) exh[dd] = tot;
        else *ok = tot;
    }
}

// Block-wide, in the lane's block 0: a diagnostic step's S top-5 lists
// (parity par) merged and its counts summed into that step's outputs.
static __device__ void merge_diag(const ShardXchg& xg, int par, int d,
                                  float* ts, int* ti, int* exh, int* ok,
                                  Red& r) {
    merge_sorted(xg.dv + at(xg, par, 0, TOP_K), xg.di + at(xg, par, 0, TOP_K),
                 xg.shards, TOP_K, TOP_K, TOP_K, ts, ti, r);
    if (threadIdx.x == 0)
        sum_counts(xg.cnt + at(xg, par, 0, CNT_W), xg.shards, d, exh, ok);
}

// Block-wide: whether any of the launch's `lanes` lanes has its flag at
// `off` (of its 4) set. Every block reads the same values after the same
// grid sync, so every block gets the same answer.
static __device__ bool any_lane(const int* flag, int lanes, int off) {
    const int t = threadIdx.x;
    return __syncthreads_or(t < lanes && __ldcg(flag + t * 4 + off) != 0);
}

// ---------------------------------------------------------------------------
// scan over S shards a lane (_select_scan_fn, select.py:180-374, node axis
// split; batched as _scan_batched_jit, select.py:395). With l.k_valid null
// the launch is one lane whose scalars are a's own.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) scan_batched_sharded_kernel(
        ScanArgs a0, ScanOut o0, ScanLanes l, ShardXchg x0) {
    cg::grid_group grid = cg::this_grid();
    __shared__ Red red;
    __shared__ ScanShared sh;
    __shared__ float s_ask[D_MAX];
    const int tid = threadIdx.x, S = x0.shards;
    const int b = blockIdx.x / S, s = blockIdx.x - b * S;
    const ScanArgs a = l.k_valid ? scan_lane(a0, l, b) : a0;
    const ScanOut o = scan_out_lane(o0, b, a0);
    const ShardXchg xg = xchg_lane(x0, b);
    const int lo = s * xg.per, hi = lo + xg.per;
    for (int e = tid; e < S_MAX * C_AXIS; e += NT) {
        sh.cnt[e] = a.sp_counts0[e];
        sh.pres[e] = a.sp_present0[e];
        sh.des[e] = a.sp_desired[e];
    }
    for (int e = tid; e < P_MAX * C_AXIS; e += NT) sh.dp[e] = a.dp_counts0[e];
    if (tid < S_MAX) {
        sh.w[tid] = a.sp_weight[tid] / fmaxf(a.sum_spread_w, 1e-9f);
        sh.hast[tid] = a.sp_has_targets[tid];
        sh.spv[tid] = a.sp_valid[tid];
    }
    if (tid < P_MAX) {
        sh.dpl[tid] = a.dp_limit[tid];
        sh.dpv[tid] = a.dp_valid[tid];
    }
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    __syncthreads();

    int pending = -1;   // a diagnostic step waiting for the next grid sync
    for (int step = 0; step < a.k_steps; ++step) {
        const int par = step & 1;
        // even-spread bounds over the present codes (select.py:270-275),
        // from this block's copy of the histograms: identical in the lane
        if (tid < a.s_live) {
            float mn = 1e30f, mx = -1e30f;
            int any = 0;
            for (int c = 0; c < C_AXIS; ++c) {
                const bool p = sh.pres[tid * C_AXIS + c] != 0;
                const float v = sh.cnt[tid * C_AXIS + c];
                mn = fminf(mn, p ? v : 1e30f);
                mx = fmaxf(mx, p ? v : -1e30f);
                any |= p ? 1 : 0;
            }
            sh.mn[tid] = mn;
            sh.mx[tid] = mx;
            sh.any[tid] = any;
        }
        __syncthreads();

        // the shard's sweep
        float bv = -INFINITY;
        int bi = INT_MAX;
        int cnt[D_MAX];
        int okc = 0;
#pragma unroll
        for (int dd = 0; dd < D_MAX; ++dd) cnt[dd] = 0;
        for (int x = lo + tid; x < hi; x += NT) {
            ScanEval e = scan_eval(a, sh, s_ask, x);
            bool earlier = true;
#pragma unroll
            for (int dd = 0; dd < D_MAX; ++dd) {
                if (dd < a.d) {
                    const bool f = (e.fit_bits >> dd) & 1u;
                    if (e.feas && earlier && !f) cnt[dd] += 1;
                    earlier = earlier && f;
                }
            }
            const bool ok = e.feas && e.fit;
            if (ok) okc += 1;
            const float m = ok ? e.final_ : NEG_INF;
            a.masked[x] = m;
            if (better(m, x, bv, bi)) { bv = m; bi = x; }
        }
        block_best(bv, bi, red);
        if (tid == 0) {
            xg.lv[at(xg, par, s, 1)] = bv;
            xg.li[at(xg, par, s, 1)] = bi;
        }
        grid.sync();
        if (s == 0 && pending >= 0)
            merge_diag(xg, pending & 1, a.d, o.ts + pending * TOP_K,
                       o.ti + pending * TOP_K, o.exh + pending * a.d,
                       o.ok_count + pending, red);
        pending = -1;

        // cross-shard arg-max: every block reduces the lane's S bests
        float gv = -INFINITY;
        int gi = INT_MAX;
        if (tid < S) {
            gv = __ldcg(xg.lv + at(xg, par, tid, 1));
            gi = __ldcg(xg.li + at(xg, par, tid, 1));
        }
        block_best(gv, gi, red);
        const int c = gi;
        const bool valid = gv > HALF_NEG_INF && step < a.k_valid;

        if (step == 0 || !valid) {
            // diagnostics: the shard's counts and top-5, merged by the
            // lane's block 0 after the next grid sync
            shard_counts(cnt, okc, a.d, xg.cnt + at(xg, par, s, CNT_W), red);
            shard_topk(a.masked, lo, xg.per, TOP_K,
                       xg.dv + at(xg, par, s, TOP_K),
                       xg.di + at(xg, par, s, TOP_K), red);
            pending = step;
        } else if (s == 0 && tid == 0) {
            for (int k = 0; k < TOP_K; ++k) {
                o.ti[step * TOP_K + k] = -1;
                o.ts[step * TOP_K + k] = NEG_INF;
            }
            for (int dd = 0; dd < a.d; ++dd) o.exh[step * a.d + dd] = -1;
            o.ok_count[step] = -1;
        }

        if (tid == 0) {
            if (c >= lo && c < hi) {
                // the owner: the chosen node's components, recomputed from
                // the same pre-update state with the same function, then
                // the per-node carries (only this block touches row c)
                const ScanEval e = scan_eval(a, sh, s_ask, c);
                o.choice[step] = valid ? c : -1;
                o.final_[step] = valid ? gv : 0.0f;
                o.binpack[step] = valid ? e.binpack : 0.0f;
                o.anti[step] = valid ? e.anti : 0.0f;
                o.pen[step] = valid ? e.pen : 0.0f;
                o.aff[step] = valid ? e.aff : 0.0f;
                o.spread[step] = valid ? e.spread : 0.0f;
                o.dev[step] = valid ? e.dev : 0.0f;
                o.pre[step] = valid ? a.pre_score[c] : 0.0f;
                if (valid) {
                    for (int dd = 0; dd < a.d; ++dd)
                        a.used[c * a.d + dd] = a.used[c * a.d + dd]
                                               + s_ask[dd];
                    a.tg_coll[c] += 1;
                    a.job_cnt[c] += 1;
                    a.scan_placed[c] += 1;
                    a.free_p[c] = a.free_p[c] + (-1.0f * a.port_need);
                    a.dev_slots[c] = a.dev_slots[c] + (-1.0f);
                }
            }
            if (valid) {
                // replicated: every block of the lane counts the placement
                // in its own histograms, every stanza row, live or padding
                for (int sp = 0; sp < S_MAX; ++sp) {
                    const int code = a.sp_codes[sp * a.n + c];
                    sh.cnt[sp * C_AXIS + code] += 1.0f;
                    sh.pres[sp * C_AXIS + code] = 1;
                }
                for (int p = 0; p < P_MAX; ++p) {
                    const int code = a.dp_codes[p * a.n + c];
                    sh.dp[p * C_AXIS + code] += 1.0f;
                }
            }
        }
        __syncthreads();
    }
    grid.sync();
    if (s == 0) {
        if (pending >= 0)
            merge_diag(xg, pending & 1, a.d, o.ts + pending * TOP_K,
                       o.ti + pending * TOP_K, o.exh + pending * a.d,
                       o.ok_count + pending, red);
        for (int e = tid; e < S_MAX * C_AXIS; e += NT) {
            a.sp_counts[e] = sh.cnt[e];
            a.sp_present[e] = sh.pres[e];
        }
        for (int e = tid; e < P_MAX * C_AXIS; e += NT)
            a.dp_counts[e] = sh.dp[e];
    }
}

// ---------------------------------------------------------------------------
// chunked over S shards a lane (_select_chunked_fn, select.py:446-588, node
// axis split; batched as _chunked_batched_jit, select.py:597): outputs as
// chunked_body's, lane by lane.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) chunked_batched_sharded_kernel(
        LocalArgs a0, ChunkedOut o0, LocalLanes l, ShardXchg x0, int lanes) {
    cg::grid_group grid = cg::this_grid();
    __shared__ Red red;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_tv[TOP_K];
    __shared__ int s_ti[TOP_K];
    __shared__ unsigned s_lose[CHUNK_J / 32];
    const int tid = threadIdx.x, S = x0.shards;
    const int b = blockIdx.x / S, s = blockIdx.x - b * S;
    const LocalArgs a = l.k_valid ? local_lane(a0, l, b) : a0;
    const ChunkedOut o = chunked_out_lane(o0, b, a0);
    const ShardXchg xg = xchg_lane(x0, b);
    const int lo = s * xg.per, hi = lo + xg.per;
    if (s == 0) {
        for (int r = tid; r < a.max_steps; r += NT) {
            o.choice[r] = -1;
            o.chunk[r] = 0;
            o.feas[r] = 0;
            for (int k = 0; k < TOP_K; ++k) {
                o.ti[r * TOP_K + k] = -1;
                o.ts[r * TOP_K + k] = NEG_INF;
            }
            for (int dd = 0; dd < a.d; ++dd) o.exh[r * a.d + dd] = 0;
        }
    }
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    // the lane's state, the same in each of its blocks
    int remaining = a.k_valid, steps = 0, pending = -1;
    bool ran = false;                               // ran the previous step
    bool maybe = remaining > 0 && a.max_steps > 0;  // may run this one
    if (s == 0 && tid == 0) xg.flag[1 * 2] = maybe ? 1 : 0;  // "step -1"
    __syncthreads();

    for (int step = 0;; ++step) {
        const int par = step & 1, k = step == 0 ? TOP_K : 2;
        Sweep sw = {};
        if (maybe) {
            sw = local_sweep_rows(a, s_ask, lo, hi);
            if (step == 0)
                shard_counts(sw.cnt, sw.okc, a.d,
                             xg.cnt + at(xg, 0, s, CNT_W), red);
            shard_topk(a.masked, lo, xg.per, k,
                       xg.lv + at(xg, par, s, TOP_K),
                       xg.li + at(xg, par, s, TOP_K), red);
        }
        grid.sync();
        // the lane's state after the previous step, as its winner's owner
        // published it (or block 0 when the lane did not run)
        const int* prev = xg.flag + (par ^ 1) * 2;
        const bool active = __ldcg(prev) != 0;
        if (ran) remaining = __ldcg(prev + 1);
        if (s == 0 && pending >= 0)
            merge_diag(xg, pending & 1, a.d, o.ts + pending * TOP_K,
                       o.ti + pending * TOP_K, o.exh + pending * a.d,
                       o.feas + pending, red);
        pending = -1;
        if (!any_lane(x0.flag, lanes, (par ^ 1) * 2)) break;
        if (!active) {
            if (s == 0 && tid == 0) xg.flag[par * 2] = 0;
            ran = maybe = false;
            continue;
        }

        // every block of the lane: the winner and the runner-up (the first
        // two of top_k(masked)) from the S shards' lists
        merge_sorted(xg.lv + at(xg, par, 0, TOP_K),
                     xg.li + at(xg, par, 0, TOP_K), S, TOP_K, k, k, s_tv,
                     s_ti, red);
        __syncthreads();
        const int c = s_ti[0];
        const bool valid = s_tv[0] > HALF_NEG_INF;
        const float rv = s_tv[1];
        const int ri = s_ti[1];
        if (s == 0 && tid == 0) {
            if (step == 0) {
                for (int j = 0; j < TOP_K; ++j) {
                    o.ti[j] = s_ti[j];
                    o.ts[j] = s_tv[j];
                }
                sum_counts(xg.cnt + at(xg, 0, 0, CNT_W), S, a.d, o.exh,
                           o.feas);
            } else if (valid) {
                for (int j = 0; j < TOP_K; ++j) {
                    o.ti[step * TOP_K + j] = -1;
                    o.ts[step * TOP_K + j] = NEG_INF;
                }
                for (int dd = 0; dd < a.d; ++dd) o.exh[step * a.d + dd] = -1;
                o.feas[step] = -1;
            }
        }
        if (step > 0 && !valid) {
            // the step's diagnostics, merged after the next grid sync
            shard_counts(sw.cnt, sw.okc, a.d,
                         xg.cnt + at(xg, par, s, CNT_W), red);
            shard_topk(a.masked, lo, xg.per, TOP_K,
                       xg.dv + at(xg, par, s, TOP_K),
                       xg.di + at(xg, par, s, TOP_K), red);
            pending = step;
        }
        if (c >= lo && c < hi) {
            // the owner: the leading run of sub-placements that still beat
            // the runner-up; each of the first CHUNK_J / 32 warps ballots
            // its losers
            if (tid < CHUNK_J) {
                const float fj = sub_score(a, s_ask, c, tid);
                const bool wins = fj > rv || (fj == rv && c < ri);
                const unsigned lose = __ballot_sync(0xffffffffu, !wins);
                if ((tid & 31) == 0) s_lose[tid >> 5] = lose;
            }
            __syncthreads();
            if (tid == 0) {
                const float a_max = fminf(fit_cap(a, s_ask, c),
                                          (float)remaining);
                float chunk = fminf(fmaxf((float)first_loser(s_lose), 1.0f),
                                    a_max);
                if (!valid) chunk = 0.0f;
                const int chunk_i = (int)chunk;
                place(a, s_ask, c, chunk);
                o.choice[step] = valid ? c : -1;
                o.chunk[step] = chunk_i;
                xg.flag[par * 2] = remaining - chunk_i > 0 && valid
                                   && step + 1 < a.max_steps;
                xg.flag[par * 2 + 1] = remaining - chunk_i;
            }
        }
        ran = true;
        steps = step + 1;
        maybe = valid && step + 1 < a.max_steps;
        __syncthreads();
    }
    if (s == 0 && tid == 0) {
        o.rem_steps[0] = remaining;
        o.rem_steps[1] = steps;
    }
}

// ---------------------------------------------------------------------------
// K-way over S shards a lane (_kway_core, select.py:612-769, node axis
// split; batched as _select_kway_batched, select.py:785); outputs in the
// packed layout of kway_kernel. With l.k_valid null the launch is one lane
// whose scalars are a's own.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) kway_batched_sharded_kernel(
        LocalArgs a0, KwayOut o0, LocalLanes l, ShardXchg x0, int lanes) {
    cg::grid_group grid = cg::this_grid();
    __shared__ Red red;
    // the top-k's scratch, and the streams' after it (never both live)
    __shared__ union { TopkShared tk; StreamShared st; } sm;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_lv[W_MAX + 1];   // the shard's top-(w + 1)
    __shared__ int s_li[W_MAX + 1];
    __shared__ float s_tv[W_MAX + 1];   // the lane's top-(w + 1)
    __shared__ int s_ti[W_MAX + 1];
    __shared__ int s_own[W_MAX];        // positions of the winners it owns
    __shared__ float s_chunk[W_MAX];
    __shared__ int s_ctl[3];            // placed-after, valid, owned count
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int S = x0.shards;
    const int b = blockIdx.x / S, s = blockIdx.x - b * S;
    const LocalArgs a = l.k_valid ? local_lane(a0, l, b) : a0;
    const KwayOut o = kway_out_lane(o0, b, a0);
    const ShardXchg xg = xchg_lane(x0, b);
    const int lo = s * xg.per, hi = lo + xg.per;
    const int w = o.w, k1 = w + 1;
    // each shard's list holds min(w + 1, per) entries: its whole slice
    // when that is shorter, so the S lists hold at least w + 1 rows
    const int kk = min(k1, xg.per);
    const int stride = 2 * w + TOP_K + a.d + 3;
    if (s == 0) {
        for (int r = tid; r < a.max_steps; r += NT) {
            int* row = o.packed + (size_t)r * stride;
            for (int k = 0; k < w; ++k) { row[k] = -1; row[w + k] = 0; }
            for (int k = 0; k < TOP_K; ++k) {
                row[2 * w + k] = -1;
                o.ts[r * TOP_K + k] = NEG_INF;
            }
            for (int dd = 0; dd < a.d; ++dd) row[2 * w + TOP_K + dd] = 0;
            row[stride - 3] = 0;
        }
    }
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    int remaining = a.k_valid, step = 0;
    bool alive = true;
    bool dry = false;   // the shard has no feasible row; its counts stand
    Sweep sw = {};
    if (s == 0 && tid == 0) xg.flag[0] = remaining > 0 && a.max_steps > 0;
    __syncthreads();

    while (true) {
        // replicated in the lane, and what its block 0 published
        const bool active = remaining > 0 && alive && step < a.max_steps;
        if (active) {
            // the shard is swept at a launch's first phase only; after that
            // its owned winners' rows are rescored (below), the only rows
            // whose carries a phase changed
            if (step == 0) {
                sw = local_sweep_rows(a, s_ask, lo, hi);
                __syncthreads();
            }
            block_topk_radix<false>(a.masked + lo, nullptr, xg.per, kk, s_lv,
                                    s_li, sm.tk);
            for (int j = tid; j < kk; j += NT) {
                xg.lv[s * kk + j] = s_lv[j];
                xg.li[s * kk + j] = s_li[j] + lo;
            }
            // the lane's top is invalid only where every shard's is, so a
            // shard reports counts at phase 0 and once its own top turns
            // invalid: one more sweep then (rewriting masked with the values
            // it holds), after which no row of the shard is placed on and
            // the counts it wrote stand for the rest of the launch
            const bool local_valid = s_lv[0] > HALF_NEG_INF;
            if (step == 0 || (!local_valid && !dry)) {
                if (step > 0) sw = local_sweep_rows(a, s_ask, lo, hi);
                shard_counts(sw.cnt, sw.okc, a.d, xg.cnt + s * CNT_W, red);
            }
            dry = !local_valid;
        }
        grid.sync();
        if (!any_lane(x0.flag, lanes, 0)) break;

        bool valid = false;
        int nown = 0;
        int* row = o.packed + (size_t)step * stride;
        if (active) {
            // every block of the lane: the lane's top-(w + 1) from the S
            // lists, laid end to end in shard order (rows ascend among
            // equal scores), by the same radix top-k
            block_topk_radix<true>(xg.lv, xg.li, S * kk, k1, s_tv, s_ti,
                                   sm.tk);
            if (warp == 0) {
                // the winners this block owns, in position order
                int own = 0;
                for (int k0 = 0; k0 < w; k0 += 32) {
                    const int k = k0 + lane;
                    const bool mine = k < w && s_ti[k] >= lo && s_ti[k] < hi;
                    const unsigned bal = __ballot_sync(0xffffffffu, mine);
                    if (mine) s_own[own + __popc(bal & ((1u << lane) - 1u))]
                        = k;
                    own += __popc(bal);
                }
                if (lane == 0) s_ctl[2] = own;
            }
            __syncthreads();
            valid = s_tv[0] > HALF_NEG_INF;
            nown = s_ctl[2];

            if (s == 0 && tid == 0) {
                if (step == 0 || !valid) {
                    sum_counts(xg.cnt, S, a.d, row + 2 * w + TOP_K,
                               row + stride - 3);
                    // top_k(masked, 5) is the prefix of top_k(masked, w + 1)
                    for (int k = 0; k < TOP_K; ++k) {
                        row[2 * w + k] = s_ti[k];
                        o.ts[step * TOP_K + k] = s_tv[k];
                    }
                } else {
                    for (int k = 0; k < TOP_K; ++k) {
                        row[2 * w + k] = -1;
                        o.ts[step * TOP_K + k] = NEG_INF;
                    }
                    for (int dd = 0; dd < a.d; ++dd)
                        row[2 * w + TOP_K + dd] = -1;
                    row[stride - 3] = -1;
                }
            }

            // the owned winners' chunks (the stream walk of kway_body), and
            // winner 0's against the runner-up, into the exchange
            kway_streams(a, s_ask, s_tv, s_ti, w, s_own, nown, sm.st,
                         xg.chunk, xg.chunk + W_MAX);
        }
        grid.sync();

        if (active) {
            if (warp == 0) {
                // every block of the lane: the overshoot fallback on the
                // W chunks, so `remaining` agrees everywhere
                for (int k = lane; k < w; k += 32)
                    s_chunk[k] = __ldcg(xg.chunk + k);
                const int placed = kway_fallback(
                    s_chunk, __ldcg(xg.chunk + W_MAX), w, remaining, valid);
                if (lane == 0) {
                    s_ctl[0] = remaining - placed;
                    s_ctl[1] = valid ? 1 : 0;
                }
            }
            __syncthreads();
            if (tid < nown) {
                // the owner places its winners (rows are distinct), then
                // rescores each row for the next phase (a row placed with
                // chunk 0 rescores to the value it held)
                const int wi = s_own[tid];
                const int c = s_ti[wi];
                place(a, s_ask, c, s_chunk[wi]);
                Sweep unused{};
                a.masked[c] = local_row(a, s_ask, c, unused);
            }
            if (s == 0 && tid < w) {
                const int chunk_i = (int)s_chunk[tid];
                row[tid] = chunk_i > 0 ? s_ti[tid] : -1;
                row[w + tid] = chunk_i;
            }
            remaining = s_ctl[0];
            alive = s_ctl[1] != 0;
            step += 1;
        }
        if (s == 0 && tid == 0)
            xg.flag[0] = remaining > 0 && alive && step < a.max_steps;
        // the rescored rows before the next top-k reads them
        __syncthreads();
    }
    if (s == 0) {
        for (int r = tid; r < a.max_steps; r += NT) {
            int* row = o.packed + (size_t)r * stride;
            row[stride - 2] = remaining;
            row[stride - 1] = step;
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers: plain C entry points bound with ctypes. Each launches
// lanes * shards blocks cooperatively on the caller's stream, does not
// synchronise, and returns the launch's error code. The batched entry
// points take every per-node argument as [lanes, ...] at its solo shape and
// the per-lane scalars as [lanes] device arrays; the solo ones (one lane)
// take the scalars by value.
// ---------------------------------------------------------------------------
template <typename... A>
static int launch_cooperative(void (*kernel)(A...), int blocks, void* stream,
                              A... args) {
    void* ptrs[] = {(void*)&args...};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)kernel, dim3(blocks), dim3(NT), ptrs, 0,
        (cudaStream_t)stream);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// The most blocks of one sharded kernel (0 scan, 1 K-way, 2 chunked) the
// current card holds at once: its blocks per SM times its SMs; 0 when the
// card has no cooperative launch.
extern "C" int nomad_sharded_max_blocks(int kernel, int* out) {
    const void* fn = kernel == 0 ? (const void*)scan_batched_sharded_kernel
                   : kernel == 1 ? (const void*)kway_batched_sharded_kernel
                                 : (const void*)chunked_batched_sharded_kernel;
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
    *out = coop ? per_sm * sms : 0;
    return (int)e;
}

static bool layout_ok(int lanes, int shards, int per, long long n) {
    return lanes >= 1 && shards >= 1 && shards <= NT && lanes <= NT
           && per >= TOP_K && (long long)shards * per == n;
}

static ShardXchg xchg(float* lv, int* li, float* dv, int* di, int* cnt,
                      float* chunk, int* flag, int shards, int per, int kl) {
    ShardXchg x = {lv, li, dv, di, cnt, chunk, flag, shards, per, kl};
    return x;
}

static int launch_scan(const ScanArgs& a, const ScanOut& o,
                       const ScanLanes& l, const ShardXchg& x, int lanes,
                       void* stream) {
    if (a.n < TOP_K || a.d < 2 || a.d > D_MAX || a.s_live < 0
            || a.s_live > S_MAX || a.p_live < 0 || a.p_live > P_MAX
            || !layout_ok(lanes, x.shards, x.per, a.n))
        return (int)cudaErrorInvalidValue;
    return launch_cooperative(scan_batched_sharded_kernel, lanes * x.shards,
                              stream, a, o, l, x);
}

static int launch_kway(const LocalArgs& a, const KwayOut& o,
                       const LocalLanes& l, const ShardXchg& x, int lanes,
                       void* stream) {
    if (o.w < 1 || o.w > W_MAX || a.n < o.w + 1 || a.d < 2 || a.d > D_MAX
            || !layout_ok(lanes, x.shards, x.per, a.n))
        return (int)cudaErrorInvalidValue;
    return launch_cooperative(kway_batched_sharded_kernel, lanes * x.shards,
                              stream, a, o, l, x, lanes);
}

#define SCAN_PARAMS                                                         \
        const float* capacity, float* used, const uint8_t* feasible,        \
        const float* ask, int* tg_coll, int* job_cnt, int* scan_placed,     \
        const uint8_t* penalty, const float* affinity, float* free_p,       \
        const uint8_t* port_ok, float* dev_slots, const float* dev_score,   \
        const float* pre_score,                                             \
        const int* sp_codes, const float* sp_counts0,                       \
        const uint8_t* sp_present0, const float* sp_desired,                \
        const float* sp_weight, const uint8_t* sp_has_targets,              \
        const uint8_t* sp_valid, const int* dp_codes,                       \
        const float* dp_counts0, const float* dp_limit,                     \
        const uint8_t* dp_valid,                                            \
        float* sp_counts, uint8_t* sp_present, float* dp_counts,            \
        float* masked
#define SCAN_OUT_PARAMS                                                     \
        int* out_choice, float* out_final, float* out_binpack,              \
        float* out_anti, float* out_pen, float* out_aff, float* out_spread, \
        float* out_dev, float* out_pre, int* out_ti, float* out_ts,         \
        int* out_exh, int* out_ok
#define LOCAL_PARAMS                                                        \
        const float* capacity, float* used, const uint8_t* feasible,        \
        const float* ask, int* coll, const uint8_t* penalty,                \
        const float* affinity, float* free_p, const uint8_t* port_ok,       \
        float* dev_slots, const float* dev_score, const float* pre_score,   \
        float* masked
#define XCHG_PARAMS                                                         \
        float* x_lv, int* x_li, float* x_dv, int* x_di, int* x_cnt,         \
        float* x_chunk, int* x_flag, int shards, int per

extern "C" int nomad_select_scan_sharded(
        SCAN_PARAMS, int n, int d, int k_valid, int k_steps,
        int spread_alg, int s_live, int p_live,
        float distinct_hosts, float scan_exclusive, float desired,
        float port_need, float dev_fires, float sum_spread_w,
        SCAN_OUT_PARAMS, XCHG_PARAMS, void* stream) {
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
    ScanLanes l = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr};
    return launch_scan(a, o, l, xchg(x_lv, x_li, x_dv, x_di, x_cnt, x_chunk,
                                     x_flag, shards, per, 1), 1, stream);
}

extern "C" int nomad_select_scan_batched_sharded(
        SCAN_PARAMS, int lanes, int n, int d, int k_steps,
        int spread_alg, int s_live, int p_live,
        const int* k_valid, const float* distinct_hosts,
        const float* scan_exclusive, const float* desired,
        const float* port_need, const float* dev_fires,
        const float* sum_spread_w,
        SCAN_OUT_PARAMS, XCHG_PARAMS, void* stream) {
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
    if (!k_valid) return (int)cudaErrorInvalidValue;
    return launch_scan(a, o, l, xchg(x_lv, x_li, x_dv, x_di, x_cnt, x_chunk,
                                     x_flag, shards, per, 1), lanes, stream);
}

extern "C" int nomad_select_kway_sharded(
        LOCAL_PARAMS, int n, int d, int k_valid, int max_steps,
        int spread_alg, float desired, float port_need, float dev_fires,
        int w, int* packed, float* out_ts, XCHG_PARAMS, void* stream) {
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, k_valid, max_steps, spread_alg,
                   desired, port_need, dev_fires};
    KwayOut o = {packed, out_ts, w};
    LocalLanes l = {nullptr, nullptr, nullptr, nullptr};
    return launch_kway(a, o, l, xchg(x_lv, x_li, x_dv, x_di, x_cnt, x_chunk,
                                     x_flag, shards, per, w + 1), 1, stream);
}

extern "C" int nomad_select_kway_batched_sharded(
        LOCAL_PARAMS, int lanes, int n, int d, int max_steps,
        int spread_alg, const int* k_valid, const float* desired,
        const float* port_need, const float* dev_fires,
        int w, int* packed, float* out_ts, XCHG_PARAMS, void* stream) {
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, 0, max_steps, spread_alg, 0.0f, 0.0f, 0.0f};
    KwayOut o = {packed, out_ts, w};
    LocalLanes l = {k_valid, desired, port_need, dev_fires};
    if (!k_valid) return (int)cudaErrorInvalidValue;
    return launch_kway(a, o, l, xchg(x_lv, x_li, x_dv, x_di, x_cnt, x_chunk,
                                     x_flag, shards, per, w + 1), lanes,
                       stream);
}

extern "C" int nomad_select_chunked_batched_sharded(
        LOCAL_PARAMS, int lanes, int n, int d, int max_steps,
        int spread_alg, const int* k_valid, const float* desired,
        const float* port_need, const float* dev_fires,
        int* out_choice, int* out_chunk, int* out_ti, float* out_ts,
        int* out_exh, int* out_feas, int* rem_steps, XCHG_PARAMS,
        void* stream) {
    if (!k_valid || n < TOP_K || d < 2 || d > D_MAX
            || !layout_ok(lanes, shards, per, n))
        return (int)cudaErrorInvalidValue;
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, 0, max_steps, spread_alg, 0.0f, 0.0f, 0.0f};
    ChunkedOut o = {out_choice, out_chunk, out_ti, out_ts, out_exh, out_feas,
                    rem_steps};
    LocalLanes l = {k_valid, desired, port_need, dev_fires};
    return launch_cooperative(
        chunked_batched_sharded_kernel, lanes * shards, stream, a, o, l,
        xchg(x_lv, x_li, x_dv, x_di, x_cnt, x_chunk, x_flag, shards, per,
             TOP_K), lanes);
}
