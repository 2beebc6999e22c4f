// Hand-written Hopper (sm_90a) kernels for the node-sharded (mesh) placement
// path. Each replaces a jax.jit program of the JAX package run SPMD over a
// `nodes` mesh, where XLA splits the node axis over the mesh's devices,
// replicates the lane axis of a batch, and inserts the cross-shard
// collectives (nomad_tpu/parallel/sharded.py):
//
//   scan_batched_cluster_kernel    <- _select_scan over the mesh (one lane:
//     (S <= 16)                       parallel/sharded.py:73-98 on
//   scan_batched_sharded_kernel       select.py:180) and _scan_batched_jit
//     (S > 16)                        over it (select.py:2257 on :395)
//   kway_batched_sharded_kernel    <- _select_kway over the mesh (one lane:
//                                     select.py:1870-1892, sharded.py:198
//                                     on select.py:612) and
//                                     _select_kway_batched over it
//                                     (select.py:2028-2043 on :785)
//   chunked_batched_cluster_kernel <- _chunked_batched_jit over the mesh
//     (S <= 16)                       (select.py:2179 on :597)
//   chunked_batched_sharded_kernel
//     (S > 16)
//
// Here every shard of the mesh lives on ONE card. A launch covers B lanes
// (requests over one shared capacity table) split into S shards each: block
// lane * S + shard owns that lane's table rows [s*per, (s+1)*per) of the
// table padded by pad_for_mesh (parallel/sharded_table.py; padded rows are
// infeasible) and sweeps them on its own SM. The step loop stays on the
// device, and XLA's collectives become exchanges between the blocks of a
// lane: for the K-way kernel, and the scan and the chunked kernel past 16
// shards, the launch is cooperative (cudaLaunchCooperativeKernel), so all
// B * S blocks are resident at once, and the exchanges go through global
// memory between grid-wide syncs (cooperative_groups::this_grid().sync()),
// each lane through its own slice of the exchange buffers; the scan and the
// chunked kernel up to 16 shards run a lane as one thread-block cluster
// instead (see their sections). Every block of a lane reduces what the
// lane's blocks published itself, in the same order, so the lane's
// replicated state (the winner, the spread and distinct_property
// histograms, `remaining`) is identical in all its blocks without a
// broadcast. Lanes share only the read-only capacity.
//
// A grid sync is grid-wide: every block calls it the same number of times,
// whatever its lane is doing. So each decision around a sync (run another
// step; is any lane still placing) is taken from values every block reads
// alike after a sync; a finished lane's blocks keep syncing and do no work.
//
// scan: see its section below (scan_body's design shard by shard, one
// exchange a step, a stop at the first invalid step).
//
// chunked: see its section below (chunked_body's kept list a shard, the
// steps its rows win on its own warp, one exchange a handoff).
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
// operations. A shard sweeps 1/S of the table, but every step adds an
// exchange (a grid sync, two a K-way phase; the scan's cluster barrier
// costs less) and block-wide reductions over the S candidates (the
// K-way's over S * min(w + 1, per) of them: at S 132 the whole table).
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

// The K-way kernels' cross-shard exchange buffers in global memory,
// allocated by the wrapper; lane b's blocks use its slice (xchg_lane).
struct ShardXchg {
    float* lv;     // [lanes, 2, S, kl] each shard's candidates (K-way
    int* li;       //   kl = w + 1, of which it fills min(w + 1, per) a
                   //   shard, end to end, in parity 0)
    int* cnt;      // [lanes, 2, S, CNT_W] first-failing-dimension counts,
                   // then the feasible count
    float* chunk;  // [lanes, W_MAX + 1] K-way: the winners' chunks; [W_MAX]
                   // holds winner 0's chunk against the runner-up
    int* flag;     // [lanes, 2, 2] K-way: [0] runs the next phase
    int shards, per, kl;
};

__device__ __forceinline__ ShardXchg xchg_lane(ShardXchg x, int b) {
    const size_t s2 = 2 * (size_t)x.shards;
    x.lv += b * s2 * x.kl;
    x.li += b * s2 * x.kl;
    x.cnt += b * s2 * CNT_W;
    x.chunk += (size_t)b * (W_MAX + 1);
    x.flag += (size_t)b * 4;
    return x;
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

// Block-wide: whether any of the launch's `lanes` lanes has its flag at
// `off` (of its 4) set. Every block reads the same values after the same
// grid sync, so every block gets the same answer.
static __device__ bool any_lane(const int* flag, int lanes, int off) {
    const int t = threadIdx.x;
    return __syncthreads_or(t < lanes && __ldcg(flag + t * 4 + off) != 0);
}

// ---------------------------------------------------------------------------
// scan over S shards a lane (_select_scan_fn, select.py:180-374, node axis
// split; batched as _scan_batched_jit, select.py:395): scan_body's design
// (select_kernels.cu), shard by shard. Block s of a lane owns the rows
// [s * per, (s + 1) * per) and keeps, like scan_body over the whole table,
// their records (rec and codes by row, in the lane's scratch), its live
// rows' slots (in dynamic shared memory sized to the shard, device memory
// past it: slot i of shard s at scratch index s * per + i), and its own
// copy of the lane's histograms and per-code tables (the replicated state:
// every block of the lane counts every placement from the winner's codes,
// so the copies stay identical). The lane runs in rounds, one exchange a
// round:
//   * step 0: each block writes its rows' records and lists its live rows
//     (scan_sweep_build over [lo, hi)); a later step sweeps only its live
//     slots, beside the last winner's update and rescoring on the owner
//     block's WINNER_WARP and the tables on warps 0-15 (shard_step, the
//     overlapped step of scan_body);
//   * each block's best (score, position s * per + slot: positions order as
//     rows do) with the slot's codes is published by WINNER_WARP, which
//     takes it from the warps' bests; at a report step (step 0, or a step
//     at or past k_valid) each block also writes its counts and top-5 over
//     its rows; one exchange; every block takes the lane's winner from the
//     S candidates under (score desc, position asc), so the decision to go
//     on is the same in every block of the lane;
//   * the owner block alone (the winner's position lies in its shard)
//     writes the step's final and spread, and its update and rescoring at
//     the next round; the lane's block 0 merges a report step's S top-5
//     lists and sums its counts (in shard order: exact);
//   * the first invalid step ends the lane: where it was found in a later
//     step's sweep, one more round sweeps every shard's records for its
//     top-5 and counts (scan_sweep_meta over [lo, hi)); block 0 then copies
//     that step into the rest of the k_steps rows (scan_finish).
// Two kernels run this body, the route fixed by S alone:
//   scan_batched_cluster_kernel  S <= SCAN_CLUSTER_MAX: a lane is one
//       thread-block cluster (cudaLaunchKernelEx with the cluster dimension
//       S; past 8 blocks the non-portable size). Each block stores its
//       candidate into every block's shared memory with st.async, counted
//       on that block's transaction barrier (ClusterXchg). Clusters need
//       no co-residency beyond their own, so every lane is in one launch
//       and stops on its own. A block leaves only after a last
//       cluster.sync(), so no block exits while another may still read its
//       shared memory.
//   scan_batched_sharded_kernel  S > SCAN_CLUSTER_MAX: the cooperative
//       launch over lanes * S blocks, the entries in global memory, one
//       grid.sync() a round (GridXchg); a lane that has stopped keeps
//       syncing (each round every lane's block 0 publishes whether it still
//       runs, and the loop ends once none does), so every block syncs
//       equally often.
// What bounds a step on an H100 (PERF.md §6): not bytes or
// operations but latency: the per-code tables (≈ 2K cycles, as in
// scan_body), the shard's best, the exchange, and ≈ 3-5K cycles after it
// before the next step starts, which the sections profiled so far do not
// explain (scripts/profile_scan.py --sharded).
// ---------------------------------------------------------------------------
#define SCAN_CLUSTER_MAX 16

// The sharded scan's route, fixed by the shard count alone; the wrappers
// read it through nomad_scan_sharded_info.
static inline bool scan_on_cluster(int shards) {
    return shards <= SCAN_CLUSTER_MAX;
}

// A shard's candidate for a step: its best live slot's masked score, its
// position, and the slot's spread and distinct_property codes (a byte
// each), which every block needs to count the winner's placement.
struct __align__(16) ScanCand {
    float v;
    int pos;
    unsigned sp, dp;
};

// A report step's counts (first-failing dimensions, then the feasible
// count) and top-5 (global rows) over a shard's rows.
struct ScanMeta {
    int cnt[CNT_W];
    float tv[TOP_K];
    int ti[TOP_K];
};

// What a block exchanges in a round.
struct __align__(16) ScanEntry {
    ScanCand c;
    ScanMeta m;
};
static_assert(sizeof(ScanEntry) == 96,
              "kernels.py (_scan_xchg) allocates 96 bytes an entry");

__device__ __forceinline__ ScanCand no_cand() {
    ScanCand c;
    c.v = -INFINITY;
    c.pos = INT_MAX;
    c.sp = c.dp = 0u;
    return c;
}

// The best (v, i) of a warp's, one a lane, under (v desc, i asc), in every
// lane.
__device__ __forceinline__ void warp_best(float& v, int& i) {
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
}

// The best of a warp's candidates (one a lane) under (score desc, position
// asc), in every lane: positions are distinct, and the no_cand() entries
// are alike, so every lane ends with the same one.
__device__ __forceinline__ ScanCand warp_best_cand(ScanCand b) {
    for (int off = 16; off > 0; off >>= 1) {
        ScanCand o;
        o.v = __shfl_xor_sync(0xffffffffu, b.v, off);
        o.pos = __shfl_xor_sync(0xffffffffu, b.pos, off);
        o.sp = __shfl_xor_sync(0xffffffffu, b.sp, off);
        o.dp = __shfl_xor_sync(0xffffffffu, b.dp, off);
        if (better(o.v, o.pos, b.v, b.pos)) b = o;
    }
    return b;
}

// Shared-memory addresses for the cluster path's asynchronous stores.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// The same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(a), "r"(rank));
    return out;
}

// The cluster path's exchange. Each round, the publishing warp stores the
// block's candidate into slot s of cand[b] in every block of the cluster
// with st.async, which counts its 16 bytes on that block's transaction
// barrier mbar[b] (b: the exchange's parity), and arms its own mbar[b] to
// expect S candidates; every thread of a block waits on its own mbar[b],
// then reads the S candidates from its own shared memory. So a step pays
// no cluster barrier, which compiles to a GPU-wide memory fence and an
// invalidation of the SM's L1 (MEMBAR.ALL.GPU, CCTL.IVALL in the SASS): a
// cluster.sync() a step took 4-6% longer a launch at S 2, 8 and 16 on an
// H100 (scripts/profile_scan.py --compare --sharded). Two exchanges a
// buffer apart cannot overlap: a block pushes into cand[b] again only
// after it has every block's candidate of the exchange in between, which
// each block sends after reading cand[b]. A report step's counts and
// top-5 stay in
// the reporting block's own entry (own, [2] by round parity), read by the
// lane's block 0 through distributed shared memory after a cluster.sync()
// (a report round, and a round without candidates, pay one).
struct ClusterXchg {
    ScanEntry* own;
    ScanCand (*cand)[SCAN_CLUSTER_MAX];   // [2] by exchange parity
    unsigned long long* mbar;             // [2] by exchange parity
    int s, shards, per;
    int ex;                               // exchanges so far
    __device__ __forceinline__ ScanEntry* mine(int par) const {
        return own + par;
    }
    __device__ __forceinline__ const ScanEntry* of(int j, int par) const {
        return cg::this_cluster().map_shared_rank(own + par, j);
    }
    template <typename T>
    __device__ __forceinline__ T load(const T* p) const { return *p; }
    // the barriers initialised, and every block of the cluster started
    // (its shared memory exists) before any block writes into it
    __device__ __forceinline__ void start() {
        if (threadIdx.x == 0) {
            for (int b = 0; b < 2; ++b)
                asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                             :: "r"(smem_addr(mbar + b)) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;"
                         ::: "memory");
        }
        cg::this_cluster().sync();
    }
    __device__ __forceinline__ void begin(int, bool) const {}
    // one warp, every lane: the block's candidate c into every block, and
    // its own barrier armed for the S candidates it receives
    __device__ __forceinline__ void publish(int, const ScanCand& c) const {
        const int lane = threadIdx.x & 31, b = ex & 1;
        const unsigned bar = smem_addr(mbar + b);
        if (lane == 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], "
                         "%1;" :: "r"(bar), "r"(shards * 16) : "memory");
        if (lane < shards)
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::"
                         "bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
                         :: "r"(cluster_addr(smem_addr(&cand[b][s]), lane)),
                            "r"(__float_as_uint(c.v)), "r"(c.pos),
                            "r"(c.sp), "r"(c.dp),
                            "r"(cluster_addr(bar, lane))
                         : "memory");
    }
    // every thread: this exchange's S candidates have arrived
    __device__ __forceinline__ void exchange(int) const {
        const unsigned bar = smem_addr(mbar + (ex & 1));
        const unsigned parity = (ex >> 1) & 1;
        const long long t0 = clock64();
        unsigned done = 0;
        while (!done) {
            asm volatile("{\n.reg .pred p;\n"
                         "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                         "%2;\nselp.u32 %0, 1, 0, p;\n}"
                         : "=r"(done) : "r"(bar), "r"(parity) : "memory");
            // a block that never publishes (a fault) ends the launch with
            // an error after ~2^34 cycles (seconds) instead of holding the
            // card
            if (!done && clock64() - t0 > (1ll << 34)) __trap();
        }
    }
    // the reports written before it visible to the lane's block 0
    __device__ __forceinline__ void reports() { cg::this_cluster().sync(); }
    // a round without candidates
    __device__ __forceinline__ void barrier(int) {
        cg::this_cluster().sync();
    }
    // every thread, once an exchange: the lane's winner, each warp
    // reducing the S candidates itself (no block barrier)
    __device__ __forceinline__ ScanCand winner(int) {
        const int lane = threadIdx.x & 31;
        ScanCand c = no_cand();
        if (lane < shards) c = cand[ex & 1][lane];
        ++ex;
        return warp_best_cand(c);
    }
    __device__ __forceinline__ bool more(bool running) const {
        return running;
    }
    __device__ __forceinline__ void finish() { cg::this_cluster().sync(); }
};

// The grid path's exchange: every lane's entries in global memory, [2][S]
// a lane by round parity, read through L2 (__ldcg) after the round's
// grid.sync(); flags [lanes][2] say by round parity whether a lane still
// runs. After the sync warp 0 takes the lane's winner into *win and every
// block reads all lanes' flags (one block barrier for both).
struct GridXchg {
    ScanEntry* lane_x;   // this lane's entries
    int* flags;
    ScanCand* win;       // shared memory
    int s, shards, per, lanes, b;
    bool any;
    __device__ __forceinline__ ScanEntry* mine(int par) const {
        return lane_x + par * shards + s;
    }
    __device__ __forceinline__ const ScanEntry* of(int j, int par) const {
        return lane_x + par * shards + j;
    }
    __device__ __forceinline__ float load(const float* p) const {
        return __ldcg(p);
    }
    __device__ __forceinline__ int load(const int* p) const {
        return __ldcg(p);
    }
    __device__ __forceinline__ void start() const {}
    __device__ __forceinline__ void begin(int par, bool running) const {
        if (s == 0 && threadIdx.x == 0) flags[b * 2 + par] = running ? 1 : 0;
    }
    // one warp, every lane: the block's candidate c into its entry
    __device__ __forceinline__ void publish(int par, const ScanCand& c)
            const {
        if ((threadIdx.x & 31) == 0) mine(par)->c = c;
    }
    __device__ __forceinline__ void exchange(int par) { sync(par); }
    __device__ __forceinline__ void reports() const {}
    __device__ __forceinline__ void barrier(int par) { sync(par); }
    __device__ __forceinline__ void sync(int par) {
        cg::this_grid().sync();
        const int tid = threadIdx.x;
        if (tid < 32) {
            ScanCand c = no_cand();
            for (int j = tid; j < shards; j += 32) {
                const int4 q =
                    __ldcg(reinterpret_cast<const int4*>(of(j, par)));
                const ScanCand e = {__int_as_float(q.x), q.y, (unsigned)q.z,
                                    (unsigned)q.w};
                if (better(e.v, e.pos, c.v, c.pos)) c = e;
            }
            c = warp_best_cand(c);
            if (tid == 0) *win = c;
        }
        any = __syncthreads_or(tid < lanes
                               && __ldcg(flags + tid * 2 + par) != 0);
    }
    __device__ __forceinline__ ScanCand winner(int) const { return *win; }
    __device__ __forceinline__ bool more(bool) const { return any; }
    __device__ __forceinline__ void finish() const {}
};

// Block-wide: a report step's counts and top-5 over the shard's rows [lo,
// lo + per) of masked (per >= TOP_K: five real rows) into *m. The counts'
// loop is unrolled, so that cs stays in registers (an index known only at
// run time would put it in local memory).
static __device__ __forceinline__ void shard_report(const ScanArgs& a,
                                                    const ScanCounts& cs,
                                                    int lo, int per,
                                                    ScanMeta* m, Red& red) {
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) {
        if (dd < a.d) {
            const int tot = block_sum(cs.cnt[dd], red);
            if (threadIdx.x == 0) m->cnt[dd] = tot;
        }
    }
    const int okt = block_sum(cs.okc, red);
    if (threadIdx.x == 0) m->cnt[D_MAX] = okt;
    block_topk(a.masked + lo, per, TOP_K, m->tv, m->ti, red);
    if (threadIdx.x == 0)
        for (int k = 0; k < TOP_K; ++k) m->ti[k] += lo;
}

// Block-wide, in a lane's block 0: the S shards' reports of round parity
// par into step `step`'s outputs. The top-5 of the S lists (each sorted,
// of TOP_K distinct real rows) by TOP_K passes, each taking the best entry
// strictly after the last under (score desc, row asc): top_k over every
// row; the counts summed, in shard order.
template <class X>
static __device__ __forceinline__ void merge_report(const X& x, int par, const ScanArgs& a,
                                    const ScanOut& o, int step, Red& red) {
    const int t = threadIdx.x;
    float v = -INFINITY;
    int i = INT_MAX;
    if (t < x.shards * TOP_K) {
        const ScanMeta& m = x.of(t / TOP_K, par)->m;
        v = x.load(m.tv + t % TOP_K);
        i = x.load(m.ti + t % TOP_K);
    }
    float pv = INFINITY;
    int pi = -1;
    for (int j = 0; j < TOP_K; ++j) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        if (better(pv, pi, v, i)) { bv = v; bi = i; }
        block_best(bv, bi, red);
        if (t == 0) {
            o.ts[step * TOP_K + j] = bv;
            o.ti[step * TOP_K + j] = bi;
        }
        pv = bv;
        pi = bi;
    }
    if (t <= a.d) {
        const int col = t < a.d ? t : D_MAX;
        int tot = 0;
        for (int j = 0; j < x.shards; ++j)
            tot += x.load(x.of(j, par)->m.cnt + col);
        if (t < a.d) o.exh[step * a.d + t] = tot;
        else o.ok_count[step] = tot;
    }
}

// One later step of a shard, scan_body's overlapped step: where this block
// owns the last winner (slot won >= 0), its outputs, update and rescoring
// on WINNER_WARP, which then composes its new score from the step's
// tables; meanwhile the table warps count the placement (codes wc) in the
// block's histograms and build the tables, and the sweepers sweep the
// shard's other live slots. In another block WINNER_WARP only meets the
// tables' hand-over. Returns the thread's best.
static __device__ __forceinline__ ScanBest shard_step(
        const ScanArgs& a, const ScanOut& o, const ScanRecs& r,
        ScanShared& sh, ScanTables& tab, const float* s_ask, int won,
        const uint2& wc, int nlive, int step) {
    if ((threadIdx.x >> 5) == WINNER_WARP) {
        float4 rec;
        if (won >= 0) rec = scan_winner(a, o, r, s_ask, won, step - 1);
        named_sync(BAR_TABLES, 32 * (TABLE_WARPS + 1));
        ScanBest sw = no_best();
        if (won >= 0 && (threadIdx.x & 31) == 0)
            sweep_slot<S_MAX, P_MAX>(sw, rec, wc, tab, won);
        return sw;
    }
    scan_tables(a, sh, tab, &wc, true);
    if ((threadIdx.x >> 5) < TABLE_WARPS)
        named_arrive(BAR_TABLES, 32 * (TABLE_WARPS + 1));
    named_sync(BAR_SWEEP, SWEEPERS);
    return scan_sweep_live_for(a, r, tab, nlive, won);
}

// a lane's state between rounds
#define LANE_RUN 0    // placing, a step a round
#define LANE_META 1   // its first invalid step was found in a live sweep:
                      // this round reports that step's top-5 and counts
#define LANE_DONE 2

template <class X>
__device__ __forceinline__ void scan_shard_body(const ScanArgs& a,
                                                const ScanOut& o,
                                                const ScanRecs& r, X& x) {
    __shared__ Red red;
    __shared__ ScanShared sh;
    __shared__ ScanTables tab;
    __shared__ float s_ask[D_MAX];
    __shared__ int s_cnt[2][NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s = x.s, per = x.per, lo = s * per, hi = lo + per;
    scan_state_init(a, sh, tab, s_ask);
    __syncthreads();
    x.start();

    int nlive = 0, step = 0, state = LANE_RUN;
    int won = -1;         // the last valid step's winner, its slot, where
                          // this block owns it
    bool placed = false;  // the last step placed: this one counts it
    uint2 wc = make_uint2(0u, 0u);   // the last winner's codes
    ScanBest sw = no_best();
    for (int round = 0;; ++round) {
        const int par = round & 1;
        const bool running = state != LANE_DONE;
        ScanEntry* me = x.mine(par);
        bool report = false;   // this round reports the shard's top-5
        bool last = false;     // and counts
        x.begin(par, running);
        if (state == LANE_RUN) {
            last = step == a.k_steps;
            ScanCounts cs;
            if (placed && !last && step < a.k_valid) {
                sw = shard_step(a, o, r, sh, tab, s_ask, won, wc, nlive,
                                step);
            } else {
                // step 0, a step at or past k_valid, or the end: the last
                // winner's update before the step's tables and sweep
                if (won >= 0 && warp == WINNER_WARP)
                    scan_winner(a, o, r, s_ask, won, step - 1);
                scan_tables(a, sh, tab, placed ? &wc : nullptr, !last);
                __syncthreads();
                if (!last) {
                    if (step == 0) {
                        sw = scan_sweep_build(a, s_ask, r, tab, s_cnt,
                                              &nlive, cs, lo, hi);
                    } else {
                        cs = scan_sweep_meta(a, r, tab, lo, hi);
                        sw = no_best();
                    }
                    report = true;
                }
            }
            if (!last) {
                if (report) shard_report(a, cs, lo, per, &me->m, red);
                // the shard's best: each warp's, then WINNER_WARP's over
                // the warps, which publishes it (the block's other warps
                // do not need it)
                float bv = sw.bv;
                int bi = sw.bi;
                warp_best(bv, bi);
                if (lane == 0) {
                    red.v[warp] = bv;
                    red.i[warp] = bi;
                }
                __syncthreads();
                if (warp == WINNER_WARP) {
                    bv = red.v[lane];
                    bi = red.i[lane];
                    warp_best(bv, bi);
                    ScanCand c = no_cand();
                    if (bi != INT_MAX) {
                        const uint2 cd = *slot_codes(r, bi);
                        c.v = bv;
                        c.pos = lo + bi;
                        c.sp = cd.x;
                        c.dp = cd.y;
                    }
                    x.publish(par, c);
                }
            }
        } else if (state == LANE_META) {
            // every shard's records with the invalid step's tables
            const ScanCounts cs = scan_sweep_meta(a, r, tab, lo, hi);
            shard_report(a, cs, lo, per, &me->m, red);
            report = true;
        }
        if (state == LANE_RUN && !last) {
            x.exchange(par);
            if (report) x.reports();
        } else {
            x.barrier(par);
        }

        if (state == LANE_RUN && !last) {
            const ScanCand g = x.winner(par);
            const bool valid = g.v > HALF_NEG_INF && step < a.k_valid;
            if (s == 0) {
                if (report) {
                    merge_report(x, par, a, o, step, red);
                } else if (valid && warp == 1) {
                    if (lane < TOP_K) {
                        o.ti[step * TOP_K + lane] = -1;
                        o.ts[step * TOP_K + lane] = NEG_INF;
                    }
                    if (lane < a.d) o.exh[step * a.d + lane] = -1;
                    if (lane == 0) o.ok_count[step] = -1;
                }
            }
            if (valid) {
                won = g.pos >= lo && g.pos < hi ? g.pos - lo : -1;
                // the winner's slot is its sweeper's own best
                if (won >= 0 && sw.bi == won) {
                    o.final_[step] = g.v;
                    o.spread[step] = sw.bst;
                }
                wc = make_uint2(g.sp, g.dp);
                placed = true;
                ++step;
            } else {
                won = -1;
                placed = false;
                state = report ? LANE_DONE : LANE_META;
            }
        } else if (state == LANE_RUN) {
            state = LANE_DONE;   // every step placed
        } else if (state == LANE_META) {
            if (s == 0) merge_report(x, par, a, o, step, red);
            state = LANE_DONE;
        }
        if (state == LANE_DONE && step < a.k_steps && s == 0 && tid == 0
                && running) {
            // the first invalid step places nothing
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
        if (!x.more(state != LANE_DONE)) break;
    }
    // no block leaves while another may read its entries (the cluster
    // path), and the invalid step's outputs before the copies read them
    x.finish();
    __syncthreads();
    if (s == 0) scan_finish(a, o, sh, step);
}

// A lane's shard s of per rows: its slots at scratch index s * per
// onwards, the first of them in dynamic shared memory (scan_shard_smem).
__device__ __forceinline__ ScanRecs scan_recs_shard(ScanRecs r, int s,
                                                    int per) {
    extern __shared__ float4 s_dyn[];
    const int lo = s * per;
    r.lrec += lo;
    r.lcodes += lo;
    r.lcomp += lo;
    r.lrow += lo;
    r.srec = s_dyn;
    r.scodes = (uint2*)(s_dyn + r.ns);
    return r;
}

// Lane b's arguments, outputs and shard s's records, written into shared
// memory by one thread, then the shard body. Held by each thread, the
// lane's pointers (about 50) do not fit beside the body's state in the 64
// registers a thread of a 1024-thread block has: ptxas kept them on the
// stack (224 bytes in the cluster kernel, 352 in the grid kernel, against
// 112 and 128 from shared memory) and reloaded them (LDL) in the step
// loop (scripts/profile_scan.py --sharded prints the SASS's reloads by
// source line).
template <class X>
__device__ __forceinline__ void scan_shard_lane(const ScanArgs& a0,
                                                const ScanOut& o0,
                                                const ScanLanes& l,
                                                const ScanRecs& r0, int b,
                                                X& x) {
    __shared__ ScanArgs s_a;
    __shared__ ScanOut s_o;
    __shared__ ScanRecs s_r;
    if (threadIdx.x == 0) {
        s_a = l.k_valid ? scan_lane(a0, l, b) : a0;
        s_o = scan_out_lane(o0, b, a0);
        s_r = scan_recs_shard(scan_recs_lane(r0, b, a0), x.s, x.per);
    }
    __syncthreads();
    scan_shard_body(s_a, s_o, s_r, x);
}

// S <= SCAN_CLUSTER_MAX: a lane a cluster of S blocks. With l.k_valid null
// the launch is one lane whose scalars are a's own. (A second copy of the
// body for that case, reading the launch's arguments as passed, took 2-9%
// longer in five of six cases at S 2-16 on an H100, 3% shorter in one:
// scripts/profile_scan.py --compare --sharded.)
__global__ void __launch_bounds__(NT) scan_batched_cluster_kernel(
        ScanArgs a0, ScanOut o0, ScanLanes l, ScanRecs r0, int per) {
    __shared__ ScanEntry s_x[2];
    __shared__ ScanCand s_cand[2][SCAN_CLUSTER_MAX];
    __shared__ unsigned long long s_mbar[2];
    const cg::cluster_group cl = cg::this_cluster();
    const int S = (int)cl.num_blocks(), s = (int)cl.block_rank();
    ClusterXchg x = {s_x, s_cand, s_mbar, s, S, per, 0};
    scan_shard_lane(a0, o0, l, r0, blockIdx.x / S, x);
}

// S > SCAN_CLUSTER_MAX: one cooperative launch of lanes * S blocks.
__global__ void __launch_bounds__(NT) scan_batched_sharded_kernel(
        ScanArgs a0, ScanOut o0, ScanLanes l, ScanRecs r0, ScanEntry* xe,
        int* flags, int shards, int per, int lanes) {
    __shared__ ScanCand s_win;
    const int S = shards, b = blockIdx.x / S, s = blockIdx.x - b * S;
    GridXchg x = {xe + (size_t)b * 2 * S, flags, &s_win, s, S, per, lanes,
                  b, false};
    scan_shard_lane(a0, o0, l, r0, b, x);
}

// ---------------------------------------------------------------------------
// chunked over S shards a lane (_select_chunked_fn, select.py:446-588, node
// axis split; batched as _chunked_batched_jit, select.py:597): chunked_body's
// design (select_kernels.cu, PR 12), shard by shard. A step changes masked
// at its winner's row only, so only the list of the shard that owns that
// row changes; the other shards' heads stay what they were until one of
// them wins. So:
//   * step 0 (a report round): each block sweeps its rows [lo, lo + per)
//     into masked with their counts, and takes its shard's top-m by the
//     radix top-k (block_topk_radix over its slice; global rows, in (score
//     desc, row asc) order, NEG_INF ties in row order), m chunked_body's
//     fitted length capped at the shard's rows: a list that holds its
//     shard never drops an entry, and one of min(max_steps, k_valid) + 1
//     never needs a new one. It publishes its head, counts and first five;
//     one exchange; every block keeps every shard's head in a table in
//     shared memory, and the lane's block 0 merges the S top-5 lists (in
//     shard order: a shard's rows lie below the next shard's) and sums the
//     counts (exact in any order) into step 0's outputs;
//   * the lane's winner is the best head, and its runner-up the better of
//     the winner shard's second entry and the other shards' heads: both
//     exact, since each list is the exact top of its shard, and ties go to
//     the lower row, which lies in the lower shard;
//   * the owner of the best head runs step after step on its warp 0 with
//     PR 12's step (chunked_steps<true>: the stream 16 sub-placements a
//     round, fit_cap, place, the row's rescoring and the list update on
//     its own list, __syncwarp only), reading the other shards' best head
//     from its table. It stops at a handoff (another shard's head ranks
//     above its own), at the lane's end, or when every head is invalid; a
//     list short of two entries (and not whole) its block makes again from
//     its own rows, and carries on. Only the owner ever writes its rows
//     (masked, the carries);
//   * a step whose top is invalid still reports its counts and top-5: if it
//     is step 0, from step 0's report; else one more report round, in which
//     every block sweeps its shard (the values masked holds) and publishes
//     its counts and top-5. The loop ends there.
// So a shard's rows are swept only at a launch's step 0 (a continuation
// launch too: the scratch is fresh) and at an invalid step, a list is made
// only at step 0 and when it runs short, and a lane exchanges only at
// step 0, at a handoff, at its end and at an invalid step. Two kernels run
// this body, the route fixed by S alone (chunked_on_cluster):
//   chunked_batched_cluster_kernel  S <= CHUNK_CLUSTER_MAX: a lane is one
//       thread-block cluster (cudaLaunchKernelEx with the cluster dimension
//       S; past 8 blocks the non-portable size). A report round is one
//       cluster.sync(), after which the blocks read each other's entries
//       through distributed shared memory. Between report rounds only warp
//       0 of each block runs, the other warps waiting at one barrier: a
//       handoff is one message from the owner to the next owner alone (the
//       lane's state and every shard's head, ChunkMsg), stored by st.async
//       into the next owner's shared memory and counted on its transaction
//       barrier, with no cluster or block barrier; the lane's end and an
//       invalid step are the same message to every block. Every lane goes
//       in one launch and stops on its own; a block leaves only after a
//       last cluster.sync(), so that none leaves while another may still
//       read or write its shared memory. (PR 5's one grid sync a step and
//       a first cut with one cluster.sync() and a block barrier a handoff
//       took 0.163 and 0.067 ms at B 8 count 10 S 8 on an H100, device
//       time: PERF.md section 6.)
//   chunked_batched_sharded_kernel  S > CHUNK_CLUSTER_MAX: the cooperative
//       launch over lanes * S blocks, the entries in global memory read
//       through L2 (__ldcg), one grid.sync() a round (a report round, a
//       handoff); each round every lane's block 0 publishes whether the
//       lane still runs, every block reads all lanes' flags after the sync,
//       and the loop ends once none does, so every block syncs equally
//       often (a finished lane keeps syncing).
// Every output and carry is bit for bit chunked_batched_kernel's on the
// same padded lane. What bounds it on an H100: latency, as for the single
// card: step 0 (the shard's sweep and radix list), then per step one warp's
// two float64 powers and one row's load, and per handoff one message or
// one grid sync.
// ---------------------------------------------------------------------------
#define CHUNK_CLUSTER_MAX 16
// the most shards a lane: the heads table's entries, and the lane's S
// top-5 lists merged by one block
#define CHUNK_SHARDS_MAX (NT / TOP_K)

// The chunked kernels' route, fixed by the shard count alone; the wrappers
// read it through nomad_chunked_sharded_info.
static inline bool chunked_on_cluster(int shards) {
    return shards <= CHUNK_CLUSTER_MAX;
}

// What a block publishes in a round.
struct __align__(16) ChunkEntry {
    float v;              // the head of its list (its shard's best row)
    int i;                //   and that row
    int step, remaining;  // the lane after the owner's steps
    int cnt[CNT_W];       // a report round: the shard's counts (first
                          // failing dimensions, then the feasible count)
    float tv[TOP_K];      //   and its top-5 (global rows)
    int ti[TOP_K];
};
static_assert(sizeof(ChunkEntry) == 96,
              "kernels.py (CHUNK_ENTRY_INTS) counts 96 bytes an entry");

// The cluster route's report rounds: a block's entries [2] (step 0's, an
// invalid step's) in its own shared memory, read by the lane's blocks
// through distributed shared memory after a cluster.sync().
struct ChunkClusterX {
    ChunkEntry* own;
    int shards;
    __device__ __forceinline__ ChunkEntry* mine(int par) const {
        return own + par;
    }
    __device__ __forceinline__ const ChunkEntry* of(int j, int par) const {
        return cg::this_cluster().map_shared_rank(own + par, j);
    }
    template <typename T>
    __device__ __forceinline__ T load(const T* p) const { return *p; }
};

// The grid route's exchange: every lane's entries in global memory, [2][S]
// a lane by round parity; flags [lanes][2] say by round parity whether a
// lane still runs.
struct ChunkGridX {
    ChunkEntry* lane_x;   // this lane's entries
    int* flags;
    int s, shards, per, lanes, b;
    bool any;
    __device__ __forceinline__ ChunkEntry* mine(int par) const {
        return lane_x + par * shards + s;
    }
    __device__ __forceinline__ const ChunkEntry* of(int j, int par) const {
        return lane_x + par * shards + j;
    }
    __device__ __forceinline__ float load(const float* p) const {
        return __ldcg(p);
    }
    __device__ __forceinline__ int load(const int* p) const {
        return __ldcg(p);
    }
    __device__ __forceinline__ void begin(int par, bool running) const {
        if (s == 0 && threadIdx.x == 0) flags[b * 2 + par] = running ? 1 : 0;
    }
    __device__ __forceinline__ void exchange(int par) {
        cg::this_grid().sync();
        const int t = threadIdx.x;
        any = __syncthreads_or(t < lanes && __ldcg(flags + t * 2 + par) != 0);
    }
    __device__ __forceinline__ bool more(bool) const { return any; }
};

// The lane's state between rounds, the same in each of its blocks.
#define CLANE_START 0   // step 0: every block sweeps, makes its list, reports
#define CLANE_RUN 1     // the best head's owner runs steps
#define CLANE_META 2    // a later step is invalid: every block reports it
#define CLANE_DONE 3

// Block-wide in a lane's block 0: the outputs' values for the steps no
// step writes (choice -1, chunk 0, top-5 (-1, NEG_INF), counts 0).
__device__ __forceinline__ void chunk_outputs_init(const LocalArgs& a,
                                                   const ChunkedOut& o,
                                                   int s) {
    if (s != 0) return;
    for (int r = threadIdx.x; r < a.max_steps; r += NT) {
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

// A shard's list length: chunked_body's, at most the shard's rows.
__device__ __forceinline__ int chunk_list_len(const LocalArgs& a, int per) {
    return min(per, max(TOP_K, min(CHUNK_M, min(a.max_steps, a.k_valid)
                                            + 1)));
}

// One warp, every lane: the best head of the shards other than s (of
// every shard where s is -1; the sentinel where there is none).
__device__ __forceinline__ void chunk_other(const float* hv, const int* hi,
                                            int shards, int s, float& ov,
                                            int& oi) {
    const int lane = threadIdx.x & 31;
    ov = -INFINITY;
    oi = INT_MAX;
    for (int j = lane; j < shards; j += 32)
        if (j != s && better(hv[j], hi[j], ov, oi)) {
            ov = hv[j];
            oi = hi[j];
        }
    warp_best(ov, oi);
}

// Block-wide: the shard's k best rows of masked (the first k of its rows
// [lo, lo + per) in (score desc, row asc) order) into lv, li, as global
// rows.
static __device__ __forceinline__ void chunk_shard_list(const LocalArgs& a,
                                                        int lo, int per,
                                                        int k, float* lv,
                                                        int* li,
                                                        TopkShared& tk) {
    block_topk_radix<false>(a.masked + lo, nullptr, per, k, lv, li, tk);
    if (threadIdx.x < k) li[threadIdx.x] += lo;
    __syncthreads();
}

// Block-wide, a report round: the shard swept (masked rewritten, its
// counts into *me; at step 0 each row's carries first copied from c), its
// top-k list made (k >= TOP_K), and its head and first five into *me.
static __device__ __forceinline__ void chunk_report(const LocalArgs& a,
                                                    const LocalCarry* c,
                                                    const float* s_ask,
                                                    int lo, int per, int k,
                                                    float* lv, int* li,
                                                    TopkShared& tk,
                                                    int (*sums)[CNT_W],
                                                    ChunkEntry* me) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const Sweep sw = c ? local_sweep_copy(a, *c, s_ask, lo, lo + per)
                       : local_sweep_rows(a, s_ask, lo, lo + per);
    // each warp's counts, then thread k <= D_MAX's over the warps; the
    // loop is unrolled so that sw.cnt stays in registers
#pragma unroll
    for (int q = 0; q < CNT_W; ++q) {
        const int v = warp_sum(q < D_MAX ? sw.cnt[q] : sw.okc);
        if (lane == 0) sums[warp][q] = v;
    }
    // the sums, and masked swept before the list reads it
    __syncthreads();
    if (tid < CNT_W) {
        int t = 0;
        for (int w = 0; w < NWARPS; ++w) t += sums[w][tid];
        me->cnt[tid] = t;
    }
    chunk_shard_list(a, lo, per, k, lv, li, tk);
    if (tid < TOP_K) {
        me->tv[tid] = lv[tid];
        me->ti[tid] = li[tid];
    }
    if (tid == 0) {
        me->v = lv[0];
        me->i = li[0];
    }
}

// Block-wide, in a lane's block 0 after a report round's exchange: the S
// shards' reports (parity par) into step `step`'s outputs. The top-5 of
// the S lists (each sorted, of TOP_K distinct rows) by TOP_K passes, each
// taking the best entry strictly after the last under (score desc, row
// asc): top_k over every row; the counts summed, in shard order.
template <class X>
static __device__ __forceinline__ void chunk_merge(const X& x, int par,
                                                   const LocalArgs& a,
                                                   const ChunkedOut& o,
                                                   int step, Red& red) {
    const int t = threadIdx.x;
    float v = -INFINITY;
    int i = INT_MAX;
    if (t < x.shards * TOP_K) {
        const ChunkEntry* e = x.of(t / TOP_K, par);
        v = x.load(e->tv + t % TOP_K);
        i = x.load(e->ti + t % TOP_K);
    }
    float pv = INFINITY;
    int pi = -1;
    for (int j = 0; j < TOP_K; ++j) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        if (better(pv, pi, v, i)) { bv = v; bi = i; }
        block_best(bv, bi, red);
        if (t == 0) {
            o.ts[step * TOP_K + j] = bv;
            o.ti[step * TOP_K + j] = bi;
        }
        pv = bv;
        pi = bi;
    }
    if (t <= a.d) {
        const int col = t < a.d ? t : D_MAX;
        int tot = 0;
        for (int j = 0; j < x.shards; ++j)
            tot += x.load(x.of(j, par)->cnt + col);
        if (t < a.d) o.exh[step * a.d + t] = tot;
        else o.feas[step] = tot;
    }
}

// The grid route's lane, every thread of block s of S: rounds of one
// grid.sync() each (a report round, the owner's steps, or nothing), every
// block of the lane taking the published heads into its table after the
// sync, as the design above describes.
__device__ __forceinline__ void chunked_grid_body(const LocalArgs& a,
                                                  const LocalCarry& c,
                                                  const ChunkedOut& o,
                                                  ChunkGridX& x) {
    __shared__ Red red;
    __shared__ TopkShared tk;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_lv[CHUNK_M];          // the shard's kept list
    __shared__ int s_li[CHUNK_M];
    __shared__ float s_hv[CHUNK_SHARDS_MAX]; // every shard's head
    __shared__ int s_hi[CHUNK_SHARDS_MAX];
    __shared__ int s_sum[NWARPS][CNT_W];
    __shared__ int s_ctl[4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s = x.s, S = x.shards, per = x.per, lo = s * per;
    chunk_outputs_init(a, o, s);
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    const int m = chunk_list_len(a, per);
    const bool whole = m == per;
    int state = a.k_valid > 0 && a.max_steps > 0 ? CLANE_START : CLANE_DONE;
    int step = 0, remaining = a.k_valid;
    int own = -1;            // the shard of the best head
    int h = 0, len = 0;      // this block's list: s_lv[h, h + len)
    float ov = -INFINITY;    // warp 0: the best head of the other shards
    int oi = INT_MAX;
    // a lane that places nothing still hands back its carries
    if (state == CLANE_DONE)
        for (int r = lo + tid; r < lo + per; r += NT) copy_carry(c, a, r);
    __syncthreads();

    for (int round = 0;; ++round) {
        const int par = round & 1;
        const bool running = state != CLANE_DONE;
        ChunkEntry* me = x.mine(par);
        x.begin(par, running);
        if (state == CLANE_START || state == CLANE_META) {
            const bool start = state == CLANE_START;
            chunk_report(a, start ? &c : nullptr, s_ask, lo, per,
                         start ? m : TOP_K, s_lv, s_li, tk, s_sum, me);
            h = 0;
            len = m;
        } else if (state == CLANE_RUN && own == s) {
            // the owner: steps on warp 0 until a handoff, the lane's end or
            // an invalid top; a short list is made again from its rows
            for (;;) {
                if (warp == 0) {
                    ChunkState cs = {h, len, step, remaining, true};
                    const int next = chunked_steps<true>(
                        a, o, s_ask, s_lv, s_li, cs, whole, step == 0, ov,
                        oi);
                    h = cs.h;
                    len = cs.len;
                    step = cs.step;
                    remaining = cs.remaining;
                    if (lane == 0) {
                        s_ctl[0] = next;
                        if (next != CHUNK_REBUILD) {
                            me->v = len > 0 ? s_lv[h] : -INFINITY;
                            me->i = len > 0 ? s_li[h] : INT_MAX;
                            me->step = step;
                            me->remaining = remaining;
                        }
                    }
                }
                __syncthreads();
                if (s_ctl[0] != CHUNK_REBUILD) break;
                chunk_shard_list(a, lo, per, m, s_lv, s_li, tk);
                h = 0;
                len = m;
            }
        }
        x.exchange(par);

        if (running) {
            if (warp == 0) {
                // the published heads into the table: every shard's after a
                // report round, the owner's after its steps
                if (state == CLANE_RUN) {
                    if (lane == 0) {
                        const ChunkEntry* e = x.of(own, par);
                        s_hv[own] = x.load(&e->v);
                        s_hi[own] = x.load(&e->i);
                        s_ctl[1] = x.load(&e->step);
                        s_ctl[2] = x.load(&e->remaining);
                    }
                } else {
                    for (int j = lane; j < S; j += 32) {
                        const ChunkEntry* e = x.of(j, par);
                        s_hv[j] = x.load(&e->v);
                        s_hi[j] = x.load(&e->i);
                    }
                    if (lane == 0) {
                        s_ctl[1] = step;
                        s_ctl[2] = remaining;
                    }
                }
                __syncwarp();
                // the best head, and the best of the other shards' heads
                float bv;
                int bi;
                chunk_other(s_hv, s_hi, S, -1, bv, bi);
                chunk_other(s_hv, s_hi, S, s, ov, oi);
                if (lane == 0) {
                    int st = s_ctl[1], next = CLANE_RUN;
                    const int rem = s_ctl[2];
                    const bool valid = bv > HALF_NEG_INF;
                    if (state == CLANE_META) {
                        st += 1;   // the invalid step places nothing
                        next = CLANE_DONE;
                    } else if (state == CLANE_START && !valid) {
                        st = 1;    // step 0 is invalid: its report stands
                        next = CLANE_DONE;
                    } else if (!(rem > 0 && st < a.max_steps)) {
                        next = CLANE_DONE;
                    } else if (!valid) {
                        next = CLANE_META;
                    }
                    s_ctl[0] = next;
                    s_ctl[1] = st;
                    s_ctl[3] = bi / per;
                }
            }
            if (s == 0 && state != CLANE_RUN)
                chunk_merge(x, par, a, o, step, red);
            __syncthreads();
            state = s_ctl[0];
            step = s_ctl[1];
            remaining = s_ctl[2];
            own = s_ctl[3];
        }
        if (!x.more(state != CLANE_DONE)) break;
    }
    if (s == 0 && tid == 0) {
        o.rem[0] = remaining;
        o.steps[0] = step;
    }
}

// Lane b's arguments and outputs, written into shared memory by one
// thread: held by each thread, the lane's pointers would take registers
// the body's state needs (as the sharded scan found, scan_shard_lane).
struct ChunkLaneArgs {
    LocalArgs a;
    LocalCarry c;
    ChunkedOut o;
};

__device__ __forceinline__ void chunk_lane_args(ChunkLaneArgs& sh,
                                                const LocalArgs& a0,
                                                const LocalCarry& c0,
                                                const ChunkedOut& o0,
                                                const LocalLanes& l,
                                                int b) {
    if (threadIdx.x == 0) {
        sh.a = local_lane(a0, l, b);
        sh.c = carry_lane(c0, a0, b);
        sh.o = chunked_out_lane(o0, b, a0);
    }
    __syncthreads();
}

// The cluster route's handoff: the owner sends the next owner one message,
// by st.async into that block's shared memory, counted on its transaction
// barrier: the lane's state and every shard's head (ChunkMsg, 16-byte
// chunks). Only the next owner needs them, since only the owner steps; a
// block's message buffer is written only when it becomes the owner, after
// it read its last message (it sent a message since), so one buffer a
// block suffices. The lane's end, and an invalid step, go to every block
// alike (a message of the same size). Each block arms its barrier for its
// next message once it has read the last.
#define CMSG_RUN 0    // you own the best head
#define CMSG_META 1   // step `step` is invalid: report it, then the end
#define CMSG_DONE 2   // the lane ends
struct __align__(16) ChunkMsg {
    int kind, step, remaining, pad;
    float2 head[CHUNK_CLUSTER_MAX];   // (score, row as int bits) a shard
};

// The bytes of a message over S shards (whole 16-byte chunks).
__device__ __forceinline__ int chunk_msg_bytes(int shards) {
    return 16 * (1 + (shards + 1) / 2);
}

// This block's barrier armed for its next message.
__device__ __forceinline__ void chunk_msg_arm(unsigned bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Warp 0, every lane: a message to block `to` (kind, step, remaining, and
// the heads s_hv / s_hi of the S shards), one 16-byte chunk a lane.
__device__ __forceinline__ void chunk_msg_send(int to, int kind, int step,
                                               int remaining,
                                               const float* hv,
                                               const int* hi, int shards,
                                               unsigned msg, unsigned bar) {
    const int lane = threadIdx.x & 31;
    if (lane >= 1 + (shards + 1) / 2) return;
    unsigned q[4] = {(unsigned)kind, (unsigned)step, (unsigned)remaining, 0u};
    if (lane > 0) {
        const int j = 2 * (lane - 1);
        q[0] = __float_as_uint(hv[j]);
        q[1] = (unsigned)hi[j];
        q[2] = j + 1 < shards ? __float_as_uint(hv[j + 1]) : 0u;
        q[3] = j + 1 < shards ? (unsigned)hi[j + 1] : 0u;
    }
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
                 " [%0], {%1, %2, %3, %4}, [%5];"
                 :: "r"(cluster_addr(msg + 16 * lane, to)), "r"(q[0]),
                    "r"(q[1]), "r"(q[2]), "r"(q[3]),
                    "r"(cluster_addr(bar, to))
                 : "memory");
}

// Warp 0, every lane: wait for this block's message number `got` (its
// barrier's phase of that parity). A message that never comes (a fault)
// ends the launch with an error after ~2^34 cycles instead of holding the
// card.
__device__ __forceinline__ void chunk_msg_wait(unsigned bar, int got) {
    const long long t0 = clock64();
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
                     "%2;\nselp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(got & 1) : "memory");
        if (!done && clock64() - t0 > (1ll << 34)) __trap();
    }
}

// The lane's state as a block knows it: CLANE_*, the next step, the count
// left, and the shard of the best head.
struct ChunkLane {
    int state, step, remaining, own;
};

// Warp 0 of block s, every lane: from the lane state `ln` (CLANE_RUN, `own`
// the best head's shard), steps while this block owns the best head, a
// message to the next owner at each handoff, and a wait for a message
// while another block owns it; returns the lane's state at a list to make
// again (CLANE_RUN: this block still owns the best head), at an invalid
// step (CLANE_META) or at the lane's end (CLANE_DONE).
__device__ __forceinline__ int chunk_drive(
        const LocalArgs& a, const ChunkedOut& o, const float* s_ask,
        float* lv, int* li, float* hv, int* hi, const ChunkMsg& msg,
        unsigned msg_at, unsigned bar, int& got, ChunkLane& ln, int& h,
        int& len, bool whole, int s, int shards, int per) {
    const int lane = threadIdx.x & 31;
    const int bytes = chunk_msg_bytes(shards);
    for (;;) {
        if (ln.own != s) {
            chunk_msg_wait(bar, got);
            const int kind = msg.kind;
            ln.step = msg.step;
            ln.remaining = msg.remaining;
            if (lane < shards) {
                const float2 e = msg.head[lane];
                hv[lane] = e.x;
                hi[lane] = __float_as_int(e.y);
            }
            __syncwarp();
            got += 1;
            if (lane == 0) chunk_msg_arm(bar, bytes);
            if (kind != CMSG_RUN)
                return kind == CMSG_META ? CLANE_META : CLANE_DONE;
            ln.own = s;
        }
        float ov;
        int oi;
        chunk_other(hv, hi, shards, s, ov, oi);
        ChunkState cs = {h, len, ln.step, ln.remaining, true};
        const int next = chunked_steps<true>(a, o, s_ask, lv, li, cs, whole,
                                             ln.step == 0, ov, oi);
        h = cs.h;
        len = cs.len;
        ln.step = cs.step;
        ln.remaining = cs.remaining;
        if (next == CHUNK_REBUILD) return CLANE_RUN;
        if (lane == 0) {
            hv[s] = len > 0 ? lv[h] : -INFINITY;
            hi[s] = len > 0 ? li[h] : INT_MAX;
        }
        __syncwarp();
        if (next == CHUNK_HANDOFF) {
            ln.own = oi / per;
            chunk_msg_send(ln.own, CMSG_RUN, ln.step, ln.remaining, hv, hi,
                           shards, msg_at, bar);
            continue;
        }
        // the lane's end (CHUNK_END) or an invalid top (CHUNK_SWEEP), to
        // every other block
        const int kind = next == CHUNK_END ? CMSG_DONE : CMSG_META;
        for (int t = 0; t < shards; ++t)
            if (t != s)
                chunk_msg_send(t, kind, ln.step, ln.remaining, hv, hi,
                               shards, msg_at, bar);
        return kind == CMSG_META ? CLANE_META : CLANE_DONE;
    }
}

// The cluster route's lane, every thread of block s of S: a report round
// at step 0 and at an invalid step (one cluster.sync() and the pull of
// every block's ChunkEntry through distributed shared memory); between
// them warp 0 alone drives the steps (chunk_drive) while the block's other
// warps wait at one barrier, and the block joins it to make its list
// again.
__device__ __forceinline__ void chunked_cluster_body(const LocalArgs& a,
                                                     const LocalCarry& c,
                                                     const ChunkedOut& o,
                                                     int per) {
    __shared__ Red red;
    __shared__ TopkShared tk;
    __shared__ float s_ask[D_MAX];
    __shared__ float s_lv[CHUNK_M];          // the shard's kept list
    __shared__ int s_li[CHUNK_M];
    __shared__ float s_hv[CHUNK_CLUSTER_MAX];   // every shard's head
    __shared__ int s_hi[CHUNK_CLUSTER_MAX];
    __shared__ int s_sum[NWARPS][CNT_W];
    __shared__ ChunkEntry s_x[2];            // the report rounds' entries
    __shared__ ChunkMsg s_msg;               // this block's next message
    __shared__ unsigned long long s_bar;
    __shared__ ChunkLane s_ln;
    const cg::cluster_group cl = cg::this_cluster();
    const int S = (int)cl.num_blocks(), s = (int)cl.block_rank();
    const int tid = threadIdx.x, warp = tid >> 5, lo = s * per;
    const ChunkClusterX x = {s_x, S};
    const unsigned bar = smem_addr(&s_bar), msg_at = smem_addr(&s_msg);
    chunk_outputs_init(a, o, s);
    if (tid < D_MAX) s_ask[tid] = tid < a.d ? a.ask[tid] : 0.0f;
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        chunk_msg_arm(bar, chunk_msg_bytes(S));
    }
    const int m = chunk_list_len(a, per);
    const bool whole = m == per;
    ChunkLane ln = {a.k_valid > 0 && a.max_steps > 0 ? CLANE_START
                                                     : CLANE_DONE,
                    0, a.k_valid, -1};
    int h = 0, len = 0, got = 0;
    if (ln.state == CLANE_DONE)
        for (int r = lo + tid; r < lo + per; r += NT) copy_carry(c, a, r);
    __syncthreads();
    if (ln.state == CLANE_START) {
        chunk_report(a, &c, s_ask, lo, per, m, s_lv, s_li, tk, s_sum,
                     x.mine(0));
        h = 0;
        len = m;
    }
    // the reports, the barriers' set-up and block 0's outputs before any
    // block reads or sends
    cg::this_cluster().sync();
    if (ln.state == CLANE_START) {
        if (warp == 0) {
            const int lane = tid & 31;
            if (lane < S) {
                const ChunkEntry* e = x.of(lane, 0);
                s_hv[lane] = e->v;
                s_hi[lane] = e->i;
            }
            __syncwarp();
            float bv;
            int bi;
            chunk_other(s_hv, s_hi, S, -1, bv, bi);
            if (lane == 0) {
                s_ln = ln;
                s_ln.own = bi / per;
                // step 0 invalid: its report stands, and the lane ends
                if (!(bv > HALF_NEG_INF)) {
                    s_ln.state = CLANE_DONE;
                    s_ln.step = 1;
                } else {
                    s_ln.state = CLANE_RUN;
                }
            }
        }
        if (s == 0) chunk_merge(x, 0, a, o, 0, red);
        __syncthreads();
        ln = s_ln;
    }
    while (ln.state == CLANE_RUN) {
        if (warp == 0) {
            const int next = chunk_drive(a, o, s_ask, s_lv, s_li, s_hv, s_hi,
                                         s_msg, msg_at, bar, got, ln, h, len,
                                         whole, s, S, per);
            if ((tid & 31) == 0) {
                s_ln = ln;
                s_ln.state = next;
            }
        }
        __syncthreads();
        ln = s_ln;
        if (ln.state == CLANE_RUN) {   // this block's list, made again
            chunk_shard_list(a, lo, per, m, s_lv, s_li, tk);
            h = 0;
            len = m;
        }
    }
    if (ln.state == CLANE_META) {
        // every shard's counts and top-5 at the invalid step
        chunk_report(a, nullptr, s_ask, lo, per, TOP_K, s_lv, s_li, tk,
                     s_sum, x.mine(1));
        cg::this_cluster().sync();
        if (s == 0) chunk_merge(x, 1, a, o, ln.step, red);
        ln.step += 1;   // the invalid step places nothing
    }
    // no block leaves while another may read its entries or send to it
    cg::this_cluster().sync();
    if (s == 0 && tid == 0) {
        o.rem[0] = ln.remaining;
        o.steps[0] = ln.step;
    }
}

// S <= CHUNK_CLUSTER_MAX: a lane a cluster of S blocks.
__global__ void __launch_bounds__(NT) chunked_batched_cluster_kernel(
        LocalArgs a0, LocalCarry c0, ChunkedOut o0, LocalLanes l, int per) {
    __shared__ ChunkLaneArgs sh;
    chunk_lane_args(sh, a0, c0, o0, l,
                    blockIdx.x / (int)cg::this_cluster().num_blocks());
    chunked_cluster_body(sh.a, sh.c, sh.o, per);
}

// S > CHUNK_CLUSTER_MAX: one cooperative launch of lanes * S blocks.
__global__ void __launch_bounds__(NT) chunked_batched_sharded_kernel(
        LocalArgs a0, LocalCarry c0, ChunkedOut o0, LocalLanes l,
        ChunkEntry* xe, int* flags, int shards, int per, int lanes) {
    __shared__ ChunkLaneArgs sh;
    const int S = shards, b = blockIdx.x / S, s = blockIdx.x - b * S;
    ChunkGridX x = {xe + (size_t)b * 2 * S, flags, s, S, per, lanes, b,
                    false};
    chunk_lane_args(sh, a0, c0, o0, l, b);
    chunked_grid_body(sh.a, sh.c, sh.o, x);
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
static int launch_cooperative(void (*kernel)(A...), int blocks, int smem,
                              void* stream, A... args) {
    void* ptrs[] = {(void*)&args...};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)kernel, dim3(blocks), dim3(NT), ptrs, smem,
        (cudaStream_t)stream);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// The sharded scan kernels' dynamic shared memory: the most a block may
// have (set once a kernel, with, for the cluster kernel, cluster sizes past
// 8), or -1.
static int scan_grid_smem() {
    static const int bytes =
        scan_smem((const void*)scan_batched_sharded_kernel);
    return bytes;
}

static int scan_cluster_smem() {
    static const int bytes = [] {
        const void* fn = (const void*)scan_batched_cluster_kernel;
        const int b = scan_smem(fn);
        if (b < 0 || cudaFuncSetAttribute(
                         fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                         1) != cudaSuccess)
            return -1;
        return b;
    }();
    return bytes;
}

// Whether the chunked cluster kernel takes cluster sizes past 8 (set once).
static bool chunked_cluster_ready() {
    static const bool ok = cudaFuncSetAttribute(
        (const void*)chunked_batched_cluster_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess;
    return ok;
}

// A sharded scan launch's dynamic shared memory: a shard's per live slots
// at most, as far as `most` bytes hold them.
static int scan_shard_smem(int most, int per) {
    const int slots = scan_slots(most);
    return (per < slots ? per : slots) * (int)(sizeof(float4) + sizeof(uint2));
}

// The cluster kernel's launch over `lanes` clusters of `shards` blocks.
static cudaLaunchConfig_t cluster_config(int lanes, int shards, int smem,
                                         void* stream,
                                         cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t c = {};
    c.gridDim = dim3(lanes * shards);
    c.blockDim = dim3(NT);
    c.dynamicSmemBytes = smem;
    c.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = shards;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    c.attrs = attr;
    c.numAttrs = 1;
    return c;
}

// The most blocks of one sharded kernel (0 the scan's grid path, 1 K-way,
// 2 chunked) the current card holds at once: its blocks per SM (with its
// largest dynamic shared memory) times its SMs; 0 when the card has no
// cooperative launch.
extern "C" int nomad_sharded_max_blocks(int kernel, int* out) {
    const void* fn = kernel == 0 ? (const void*)scan_batched_sharded_kernel
                   : kernel == 1 ? (const void*)kway_batched_sharded_kernel
                                 : (const void*)chunked_batched_sharded_kernel;
    const int smem = kernel == 0 ? scan_grid_smem() : 0;
    if (smem < 0) return (int)cudaErrorInvalidConfiguration;
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT,
                                                          smem);
    *out = coop ? per_sm * sms : 0;
    return (int)e;
}

// The sharded scan's route and its shard's shared memory for `shards`
// shards of `per` rows: out[0] 1 on the cluster path (scan_on_cluster),
// else 0; out[1] the live slots a block keeps in shared memory; out[2] on
// the cluster path the most clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters), else 0.
extern "C" int nomad_scan_sharded_info(int shards, int per, int* out) {
    const bool cluster = scan_on_cluster(shards);
    const int most = cluster ? scan_cluster_smem() : scan_grid_smem();
    if (shards < 1 || per < TOP_K || most < 0)
        return (int)cudaErrorInvalidValue;
    const int smem = scan_shard_smem(most, per);
    out[0] = cluster ? 1 : 0;
    out[1] = scan_slots(smem);
    out[2] = 0;
    if (!cluster) return (int)cudaSuccess;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t c = cluster_config(1, shards, smem, nullptr,
                                                attr);
    return (int)cudaOccupancyMaxActiveClusters(
        out + 2, (const void*)scan_batched_cluster_kernel, &c);
}

static bool layout_ok(int lanes, int shards, int per, long long n) {
    return lanes >= 1 && shards >= 1 && shards <= NT && lanes <= NT
           && per >= TOP_K && (long long)shards * per == n;
}

static ShardXchg xchg(float* lv, int* li, int* cnt, float* chunk,
                      int* flag, int shards, int per, int kl) {
    ShardXchg x = {lv, li, cnt, chunk, flag, shards, per, kl};
    return x;
}

// The sharded scan over `lanes` lanes of `shards` shards, by the route S
// fixes: clusters up to SCAN_CLUSTER_MAX shards, the cooperative grid past
// that (xe, flags: its exchange, ScanEntry [lanes, 2, S] and int [lanes,
// 2]). A launch that fails returns its error; nothing retries it.
static int launch_scan(const ScanArgs& a, const ScanOut& o,
                       const ScanLanes& l, void* recs, int lanes, int shards,
                       int per, void* xe, int* flags, void* stream) {
    if (a.n < TOP_K || a.d < 2 || a.d > D_MAX || a.s_live < 0
            || a.s_live > S_MAX || a.p_live < 0 || a.p_live > P_MAX
            || !layout_ok(lanes, shards, per, a.n))
        return (int)cudaErrorInvalidValue;
    if (scan_on_cluster(shards)) {
        const int most = scan_cluster_smem();
        if (most < 0) return (int)cudaErrorInvalidConfiguration;
        const int smem = scan_shard_smem(most, per);
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t c = cluster_config(lanes, shards, smem,
                                                    stream, attr);
        const cudaError_t e = cudaLaunchKernelEx(
            &c, scan_batched_cluster_kernel, a, o, l,
            scan_recs(recs, lanes, a.n, smem), per);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
        return (int)cudaGetLastError();
    }
    if (!xe || !flags) return (int)cudaErrorInvalidValue;
    const int most = scan_grid_smem();
    if (most < 0) return (int)cudaErrorInvalidConfiguration;
    const int smem = scan_shard_smem(most, per);
    return launch_cooperative(scan_batched_sharded_kernel, lanes * shards,
                              smem, stream, a, o, l,
                              scan_recs(recs, lanes, a.n, smem),
                              (ScanEntry*)xe, flags, shards, per, lanes);
}

static int launch_kway(const LocalArgs& a, const KwayOut& o,
                       const LocalLanes& l, const ShardXchg& x, int lanes,
                       void* stream) {
    if (o.w < 1 || o.w > W_MAX || a.n < o.w + 1 || a.d < 2 || a.d > D_MAX
            || !layout_ok(lanes, x.shards, x.per, a.n))
        return (int)cudaErrorInvalidValue;
    return launch_cooperative(kway_batched_sharded_kernel, lanes * x.shards,
                              0, stream, a, o, l, x, lanes);
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
        float* x_lv, int* x_li, int* x_cnt, float* x_chunk, int* x_flag,    \
        int shards, int per

// The scan's exchange on the grid path (unused on the cluster path, where
// they may be null): ScanEntry [lanes, 2, shards] and int [lanes, 2].
#define SCAN_XCHG_PARAMS                                                    \
        void* x_entries, int* x_flags, int shards, int per

extern "C" int nomad_select_scan_sharded(
        SCAN_PARAMS, void* recs, int n, int d, int k_valid, int k_steps,
        int spread_alg, int s_live, int p_live,
        float distinct_hosts, float scan_exclusive, float desired,
        float port_need, float dev_fires, float sum_spread_w,
        SCAN_OUT_PARAMS, SCAN_XCHG_PARAMS, void* stream) {
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
    return launch_scan(a, o, l, recs, 1, shards, per, x_entries, x_flags,
                       stream);
}

extern "C" int nomad_select_scan_batched_sharded(
        SCAN_PARAMS, void* recs, int lanes, int n, int d, int k_steps,
        int spread_alg, int s_live, int p_live,
        const int* k_valid, const float* distinct_hosts,
        const float* scan_exclusive, const float* desired,
        const float* port_need, const float* dev_fires,
        const float* sum_spread_w,
        SCAN_OUT_PARAMS, SCAN_XCHG_PARAMS, void* stream) {
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
    return launch_scan(a, o, l, recs, lanes, shards, per, x_entries, x_flags,
                       stream);
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
    return launch_kway(a, o, l, xchg(x_lv, x_li, x_cnt, x_chunk,
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
    return launch_kway(a, o, l, xchg(x_lv, x_li, x_cnt, x_chunk,
                                     x_flag, shards, per, w + 1), lanes,
                       stream);
}

// The chunked kernels' exchange on the grid route (unused on the cluster
// route, where they may be null): ChunkEntry [lanes, 2, shards] and int
// [lanes, 2].
#define CHUNK_XCHG_PARAMS                                                   \
        void* x_entries, int* x_flags, int shards, int per

extern "C" int nomad_select_chunked_batched_sharded(
        LOCAL_PARAMS, const float* used0, const int* coll0,
        const float* free0, const float* slots0, int lanes, int n, int d,
        int max_steps,
        int spread_alg, const int* k_valid, const float* desired,
        const float* port_need, const float* dev_fires,
        int* out_choice, int* out_chunk, int* out_ti, float* out_ts,
        int* out_exh, int* out_feas, int* out_rem, int* out_steps,
        CHUNK_XCHG_PARAMS, void* stream) {
    if (!k_valid || n < TOP_K || d < 2 || d > D_MAX
            || shards > CHUNK_SHARDS_MAX || !layout_ok(lanes, shards, per, n))
        return (int)cudaErrorInvalidValue;
    LocalArgs a = {capacity, used, feasible, ask, coll, penalty, affinity,
                   free_p, port_ok, dev_slots, dev_score, pre_score, masked,
                   n, d, 0, max_steps, spread_alg, 0.0f, 0.0f, 0.0f};
    ChunkedOut o = {out_choice, out_chunk, out_ti, out_ts, out_exh, out_feas,
                    out_rem, out_steps};
    LocalLanes l = {k_valid, desired, port_need, dev_fires};
    const LocalCarry c = {used0, coll0, free0, slots0};
    if (chunked_on_cluster(shards)) {
        if (!chunked_cluster_ready())
            return (int)cudaErrorInvalidConfiguration;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg = cluster_config(lanes, shards, 0,
                                                      stream, attr);
        const cudaError_t e = cudaLaunchKernelEx(
            &cfg, chunked_batched_cluster_kernel, a, c, o, l, per);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
        return (int)cudaGetLastError();
    }
    if (!x_entries || !x_flags) return (int)cudaErrorInvalidValue;
    return launch_cooperative(chunked_batched_sharded_kernel, lanes * shards,
                              0, stream, a, c, o, l, (ChunkEntry*)x_entries,
                              x_flags, shards, per, lanes);
}

// The chunked kernels' route for `shards` shards: out[0] 1 on the cluster
// route (chunked_on_cluster), else 0; out[1] on the cluster route the most
// clusters of that size the card holds at once
// (cudaOccupancyMaxActiveClusters), else 0.
extern "C" int nomad_chunked_sharded_info(int shards, int* out) {
    if (shards < 1 || shards > CHUNK_SHARDS_MAX)
        return (int)cudaErrorInvalidValue;
    const bool cluster = chunked_on_cluster(shards);
    out[0] = cluster ? 1 : 0;
    out[1] = 0;
    if (!cluster) return (int)cudaSuccess;
    if (!chunked_cluster_ready()) return (int)cudaErrorInvalidConfiguration;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t c = cluster_config(1, shards, 0, nullptr, attr);
    return (int)cudaOccupancyMaxActiveClusters(
        out + 1, (const void*)chunked_batched_cluster_kernel, &c);
}
