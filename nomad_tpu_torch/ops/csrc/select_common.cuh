// The __device__ pieces the placement kernels share: block-wide reductions,
// the node-local score and sweep (chunked and K-way), the scan's per-node
// evaluation, and each batched kernel's view of one lane. Included by
// select_kernels.cu (the solo and batched kernels, one block a request) and
// sharded_kernels.cu (the node-sharded kernels, one block a shard of a
// lane); see select_kernels.cu for the exactness rules every piece keeps.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#define NT 1024
#define NWARPS (NT / 32)
#define TOP_K 5
#define CHUNK_J 256
#define D_MAX 8
#define S_MAX 4
#define P_MAX 4
#define C_AXIS 65
#define W_MAX 128
#define NEG_INF (-1e30f)
#define HALF_NEG_INF (-5e29f)

__device__ __forceinline__ float pow10_exact(float x) {
    return (float)pow(10.0, (double)x);
}

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
    return av > bv || (av == bv && ai < bi);
}

struct Red {
    float v[NWARPS];
    int i[NWARPS];
    int s[NWARPS];
    float rv;
    int ri;
    int rs;
};

// Block-wide argmax under (value desc, index asc). Every thread calls it
// and every thread gets the result.
static __device__ void block_best(float& v, int& i, Red& r) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, v, off);
        int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { r.v[warp] = v; r.i[warp] = i; }
    __syncthreads();
    if (warp == 0) {
        v = r.v[lane];
        i = r.i[lane];
        for (int off = 16; off > 0; off >>= 1) {
            float ov = __shfl_down_sync(0xffffffffu, v, off);
            int oi = __shfl_down_sync(0xffffffffu, i, off);
            if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
        if (lane == 0) { r.rv = v; r.ri = i; }
    }
    __syncthreads();
    v = r.rv;
    i = r.ri;
}

// Block-wide integer sum; every thread gets the result.
static __device__ int block_sum(int x, Red& r) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) r.s[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = r.s[lane];
        for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) r.rs = x;
    }
    __syncthreads();
    return r.rs;
}

// top_k(masked, k) by k argmax passes, for the chunked and scan kernels'
// k <= TOP_K (the K-way's w + 1 takes block_topk_radix below): pass j
// takes the best element that comes strictly after pass j-1's winner in
// (value desc, index asc) order, so no exclusion set is needed. Thread t reads only the elements it wrote
// itself (x = t + m*NT), so the scratch needs no extra barrier. Thread 0
// writes tv[j], ti[j]; the caller synchronises before others read them.
static __device__ void block_topk(const float* masked, int n, int k,
                                  float* tv, int* ti, Red& r) {
    float pv = INFINITY;
    int pi = -1;
    for (int j = 0; j < k; ++j) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int x = threadIdx.x; x < n; x += NT) {
            float v = masked[x];
            if (better(pv, pi, v, x) && better(v, x, bv, bi)) { bv = v; bi = x; }
        }
        block_best(bv, bi, r);
        if (threadIdx.x == 0) { tv[j] = bv; ti[j] = bi; }
        pv = bv;
        pi = bi;
    }
}

// top_k(v, k) for k up to TOPK_CAND, in a few passes over v instead of k
// argmax passes. Entry x of v has row `rows[x]` (rows null: row x); the
// order is (value desc, row asc), so the rows must ascend among equal
// values in position order (true of x itself, and of the shards' sorted
// lists laid end to end, shard by shard: see sharded_kernels.cu). Each
// score maps to an unsigned key that orders as the floats do (order_key;
// -0.0 and +0.0 one key, as better() holds them equal). Warp w owns the
// contiguous positions [w * seg, (w + 1) * seg), read 32 consecutive ones
// a round. Radix passes of 8 bits from the top find the window of keys
// holding rank k: each pass counts, in warp w's own histogram row, its
// keys whose upper bits match the window so far (one add a distinct digit
// a round, by its __match_any_sync leader: no atomics), and narrows the
// window to the bin holding rank k; each warp then adds up its own keys
// above the new window and in it, and clears its row. The passes stop
// once every key at or above the window fits the candidate buffer, or
// after the last pass, when the window is the k-th key itself. Each read
// of a warp's positions loads TOPK_DEPTH rounds ahead (rows_ahead). A
// block scan of the warps' counts then gives each warp the slots of its
// candidates, in position order: every key above the window, plus all of
// the window's keys (early stop) or its first positions up to rank k (the
// ties of lax.top_k: value desc, index asc; rows at NEG_INF included); a
// warp with none skips its second read. A rank sort of the at most
// TOPK_CAND candidates, each one 64-bit (key, ~row) word, writes tv[r],
// ti[r] (the row) for r < k, with the score's own bits. v stays in global
// memory, so n is not limited; 3 barriers a pass and 3 more. L2 reads v
// and rows through L2 only (__ldcg), for lists other blocks wrote before
// a grid sync; otherwise v is read through L1 (the block's own writes).
// Every thread calls it, after a barrier that orders the writes to v
// before its reads; the results are visible to all threads when it
// returns.
#define TOPK_CAND 256
#define RADIX 256
#define TOPK_DEPTH 8   // rounds of rows a warp loads ahead

struct TopkShared {
    unsigned hist[NWARPS][RADIX];
    unsigned long long cand[TOPK_CAND];
    float val[TOPK_CAND];
    int part[NT / TOPK_CAND][TOPK_CAND];
    int seg[2][NWARPS];
    int sel[3];
};

__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The sum of x over a warp's lanes, in every lane.
__device__ __forceinline__ int warp_sum(int x) {
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// The exclusive sum, over the warps before this one, of each warp's x
// (one value a warp, in s[NWARPS]); called by every lane of a warp.
__device__ __forceinline__ int warps_before(const int* s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return warp_sum(lane < warp ? s[lane] : 0);
}

template <bool L2, typename T>
__device__ __forceinline__ T load_as(const T* p) {
    if constexpr (L2) return __ldcg(p);
    else return *p;
}

// v[x + 32 u] for u < TOPK_DEPTH (0 past hi): a warp's next rounds of
// positions, loaded before any is used, so their latencies overlap.
template <bool L2>
__device__ __forceinline__ void rows_ahead(const float* v, int x, int hi,
                                           float* out) {
#pragma unroll
    for (int u = 0; u < TOPK_DEPTH; ++u)
        out[u] = x + 32 * u < hi ? load_as<L2>(v + x + 32 * u) : 0.0f;
}

template <bool L2>
static __device__ void block_topk_radix(const float* vals, const int* rows,
                                        int n, int k, float* tv, int* ti,
                                        TopkShared& t) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int seg = ((n + NWARPS - 1) / NWARPS + 31) & ~31;
    const int lo = min(n, warp * seg), hi = min(n, lo + seg);
    unsigned* h = t.hist[warp];
    for (int b = lane; b < RADIX; b += 32) h[b] = 0u;
    __syncwarp();
    unsigned prefix = 0u, pmask = 0u;
    int above = 0;   // keys above the window
    int krem = k;    // rank of the k-th key inside the window
    int take = 0;    // window keys to take, lowest rows first
    int wa = 0, wt = 0;   // this warp's keys above the window, and in it
    for (int shift = 24;; shift -= 8) {
        for (int x0 = lo; x0 < hi; x0 += 32 * TOPK_DEPTH) {
            float v[TOPK_DEPTH];
            rows_ahead<L2>(vals, x0 + lane, hi, v);
#pragma unroll
            for (int u = 0; u < TOPK_DEPTH; ++u) {
                if (x0 + 32 * u >= hi) break;
                unsigned dig = RADIX;   // out of the window: counted nowhere
                if (x0 + 32 * u + lane < hi) {
                    const unsigned key = order_key(v[u]);
                    if ((key & pmask) == prefix)
                        dig = (key >> shift) & 255u;
                }
                // a round with no row in the window adds nothing
                if (!__any_sync(0xffffffffu, dig < RADIX)) continue;
                const unsigned peers = __match_any_sync(0xffffffffu, dig);
                if (dig < RADIX && lane == __ffs(peers) - 1)
                    h[dig] += __popc(peers);
                __syncwarp();   // the next round's leaders read these adds
            }
        }
        __syncthreads();
        // thread b < RADIX totals bin b over the warps, then the keys in
        // the bins above b
        int c = 0;
        if (tid < RADIX)
            for (int w = 0; w < NWARPS; ++w) c += t.hist[w][tid];
        int s = c;   // bins [b, end of this warp's 32 bins]
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_down_sync(0xffffffffu, s, off);
            if (lane + off < 32) s += o;
        }
        if (tid < RADIX && lane == 0) t.seg[0][warp] = s;
        __syncthreads();
        if (tid < RADIX) {
            int gt = s - c;
            for (int w = warp + 1; w < RADIX / 32; ++w) gt += t.seg[0][w];
            if (gt < krem && krem <= gt + c) {
                t.sel[0] = tid;
                t.sel[1] = gt;
                t.sel[2] = c;
            }
        }
        __syncthreads();
        const int bin = t.sel[0], gt = t.sel[1], cb = t.sel[2];
        int up = 0, in = 0;
        for (int b = lane; b < RADIX; b += 32) {
            const int cnt = (int)h[b];
            up += b > bin ? cnt : 0;
            in += b == bin ? cnt : 0;
            h[b] = 0u;
        }
        __syncwarp();
        wa += warp_sum(up);
        wt = warp_sum(in);
        above += gt;
        krem -= gt;
        prefix |= (unsigned)bin << shift;
        pmask |= 255u << shift;
        if (above + cb <= TOPK_CAND) { take = cb; break; }
        if (shift == 0) { take = krem; break; }
    }

    // the candidates' slots, in row order
    if (lane == 0) {
        t.seg[0][warp] = wa;
        t.seg[1][warp] = wt;
    }
    __syncthreads();
    int ra = warps_before(t.seg[0]), rt = warps_before(t.seg[1]);
    const int ra_end = ra + wa, rt_end = min(take, rt + wt);
    const unsigned lt = (1u << lane) - 1u;
    for (int x0 = lo; x0 < hi && (ra < ra_end || rt < rt_end);
         x0 += 32 * TOPK_DEPTH) {
        float v[TOPK_DEPTH];
        rows_ahead<L2>(vals, x0 + lane, hi, v);
#pragma unroll
        for (int u = 0; u < TOPK_DEPTH; ++u) {
            if (x0 + 32 * u >= hi) break;
            const int x = x0 + 32 * u + lane;
            bool up = false, tie = false;
            unsigned key = 0u;
            if (x < hi) {
                key = order_key(v[u]);
                up = (key & pmask) > prefix;
                tie = (key & pmask) == prefix;
            }
            const unsigned bu = __ballot_sync(0xffffffffu, up);
            const unsigned bt = __ballot_sync(0xffffffffu, tie);
            int slot = -1;
            if (up) slot = ra + __popc(bu & lt);
            if (tie && rt + __popc(bt & lt) < take)
                slot = above + rt + __popc(bt & lt);
            if (slot >= 0) {
                const int row = rows ? load_as<L2>(rows + x) : x;
                t.cand[slot] = ((unsigned long long)key << 32)
                               | (unsigned)~row;
                t.val[slot] = v[u];
            }
            ra += __popc(bu);
            rt += __popc(bt);
        }
    }
    __syncthreads();

    // rank sort: candidate i's rank is the count of candidates before it
    // in (key desc, row asc), i.e. of larger (key, ~row) words, summed
    // over NT / TOPK_CAND parts
    const int m = above + take;
    const int i = tid % TOPK_CAND, p = tid / TOPK_CAND;
    const int per = TOPK_CAND / (NT / TOPK_CAND);
    if (i < m) {
        const unsigned long long ci = t.cand[i];
        const int end = min(m, (p + 1) * per);
        int r = 0;
#pragma unroll 8
        for (int j = p * per; j < end; ++j) r += t.cand[j] > ci ? 1 : 0;
        t.part[p][i] = r;
    }
    __syncthreads();
    if (tid < m) {
        int r = 0;
        for (int q = 0; q < NT / TOPK_CAND; ++q) r += t.part[q][tid];
        if (r < k) {
            tv[r] = t.val[tid];
            ti[r] = (int)~(unsigned)t.cand[tid];
        }
    }
    __syncthreads();
}

// _local_final_score (select.py:411-443), term for term.
__device__ __forceinline__ float local_score(
        float after0, float after1, float cap_cpu, float cap_mem, float coll,
        bool pen, float aff, float desired, int spread_alg, float dev_score,
        float dev_fires, float pre) {
    float free_cpu = 1.0f - after0 / cap_cpu;
    float free_mem = 1.0f - after1 / cap_mem;
    float total = pow10_exact(free_cpu) + pow10_exact(free_mem);
    float fit = spread_alg ? fminf(fmaxf(total - 2.0f, 0.0f), 18.0f)
                           : fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
    float binpack = fit / 18.0f;
    bool anti_f = coll > 0.0f;
    float anti = anti_f ? -(coll + 1.0f) / fmaxf(desired, 1.0f) : 0.0f;
    float penv = pen ? -1.0f : 0.0f;
    bool aff_f = aff != 0.0f;
    float dev = dev_fires > 0.0f ? dev_score : 0.0f;
    bool pre_f = pre != 0.0f;
    float fired = 1.0f + (anti_f ? 1.0f : 0.0f) + (pen ? 1.0f : 0.0f)
                  + (aff_f ? 1.0f : 0.0f) + (dev_fires > 0.0f ? 1.0f : 0.0f)
                  + (pre_f ? 1.0f : 0.0f);
    return (binpack + anti + penv + aff + dev + pre) / fired;
}

// Index of the first losing sub-placement in one CHUNK_J-long score
// stream, from its per-warp ballots of losers (CHUNK_J if none loses).
__device__ __forceinline__ int first_loser(const unsigned* lose) {
    for (int k = 0; k < CHUNK_J / 32; ++k)
        if (lose[k]) return k * 32 + __ffs(lose[k]) - 1;
    return CHUNK_J;
}

// Inputs shared by the node-local kernels (chunked and K-way).
struct LocalArgs {
    const float* capacity;   // [n, d]
    float* used;             // [n, d] carry, updated in place
    const uint8_t* feasible; // [n] (bool as uint8)
    const float* ask;        // [d]
    int* coll;               // [n] carry
    const uint8_t* penalty;  // [n]
    const float* affinity;   // [n]
    float* free_p;           // [n] carry
    const uint8_t* port_ok;  // [n]
    float* dev_slots;        // [n] carry
    const float* dev_score;  // [n]
    const float* pre_score;  // [n]
    float* masked;           // [n] scratch
    int n, d, k_valid, max_steps, spread_alg;
    float desired, port_need, dev_fires;
};

// One sweep's per-thread results: its first-failing-dimension and ok
// counts.
struct Sweep {
    int okc;
    int cnt[D_MAX];
};

// Row x's masked score (its score where it is feasible and fits, NEG_INF
// elsewhere), counting its first failing dimension and its ok into r. The
// sweeps and the K-way kernel's winner-only rescoring both evaluate a row
// through this one function, so the two give the same bits.
__device__ __forceinline__ float local_row(const LocalArgs& a,
                                           const float* s_ask, int x,
                                           Sweep& r) {
    bool feas = a.feasible[x] && (a.free_p[x] >= a.port_need)
                && a.port_ok[x] && (a.dev_slots[x] >= 1.0f);
    bool fit = true, earlier = true;
    float after0 = 0.0f, after1 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) {
        if (dd < a.d) {
            float af = a.used[x * a.d + dd] + s_ask[dd];
            bool f = af <= a.capacity[x * a.d + dd] + 1e-6f;
            if (feas && earlier && !f) r.cnt[dd] += 1;
            earlier = earlier && f;
            fit = fit && f;
            if (dd == 0) after0 = af;
            if (dd == 1) after1 = af;
        }
    }
    float cap_cpu = fmaxf(a.capacity[x * a.d + 0], 1e-9f);
    float cap_mem = fmaxf(a.capacity[x * a.d + 1], 1e-9f);
    float sc = local_score(after0, after1, cap_cpu, cap_mem,
                           (float)a.coll[x], a.penalty[x] != 0,
                           a.affinity[x], a.desired, a.spread_alg,
                           a.dev_score[x], a.dev_fires, a.pre_score[x]);
    bool ok = feas && fit;
    if (ok) r.okc += 1;
    return ok ? sc : NEG_INF;
}

// One sweep over the table rows [lo, hi): writes masked[x] for this
// thread's rows.
__device__ __forceinline__ Sweep local_sweep_rows(const LocalArgs& a,
                                                  const float* s_ask,
                                                  int lo, int hi) {
    Sweep r;
    r.okc = 0;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) r.cnt[dd] = 0;
    for (int x = lo + threadIdx.x; x < hi; x += NT)
        a.masked[x] = local_row(a, s_ask, x, r);
    return r;
}

// One sweep over the whole table.
__device__ __forceinline__ Sweep local_sweep(const LocalArgs& a,
                                             const float* s_ask) {
    return local_sweep_rows(a, s_ask, 0, a.n);
}

// Score of the s-th sub-placement on node c (select.py:538-544).
__device__ __forceinline__ float sub_score(const LocalArgs& a,
                                           const float* s_ask, int c, int j) {
    float jf = (float)j;
    float after0 = a.used[c * a.d + 0] + (jf + 1.0f) * s_ask[0];
    float after1 = a.used[c * a.d + 1] + (jf + 1.0f) * s_ask[1];
    float coll_j = (float)a.coll[c] + jf;
    return local_score(after0, after1, fmaxf(a.capacity[c * a.d + 0], 1e-9f),
                       fmaxf(a.capacity[c * a.d + 1], 1e-9f), coll_j,
                       a.penalty[c] != 0, a.affinity[c], a.desired,
                       a.spread_alg, a.dev_score[c], a.dev_fires,
                       a.pre_score[c]);
}

// Instances that physically fit on node c (select.py:526-533), before the
// remaining-count cap.
__device__ __forceinline__ float fit_cap(const LocalArgs& a,
                                         const float* s_ask, int c) {
    float m_fit = INFINITY;
    for (int dd = 0; dd < a.d; ++dd) {
        float pd = s_ask[dd] > 0.0f
            ? floorf(((a.capacity[c * a.d + dd] - a.used[c * a.d + dd]) + 1e-6f)
                     / s_ask[dd])
            : 1e9f;
        m_fit = fminf(m_fit, pd);
    }
    float m_port = a.port_need > 0.0f ? floorf(a.free_p[c] / a.port_need)
                                      : 1e9f;
    return fminf(fminf(m_fit, m_port), a.dev_slots[c]);
}

// Scatter `chunk` instances onto node c (select.py:557-560).
__device__ __forceinline__ void place(const LocalArgs& a, const float* s_ask,
                                      int c, float chunk) {
    for (int dd = 0; dd < a.d; ++dd)
        a.used[c * a.d + dd] = a.used[c * a.d + dd] + chunk * s_ask[dd];
    a.coll[c] = a.coll[c] + (int)chunk;
    a.free_p[c] = a.free_p[c] + (-chunk) * a.port_need;
    a.dev_slots[c] = a.dev_slots[c] + (-chunk);
}

// The K-way streams' shared state, per owned winner (slot p of the
// block's list): its first round's a_max, first loser and whether it is
// still open, and the loser ballots of its later rounds (32
// sub-placements each, from sub-placement 8); the same for winner 0's
// stream against the runner-up.
#define STREAM_ROUNDS ((CHUNK_J - 8 + 31) / 32)
struct StreamShared {
    float a_max[W_MAX];
    int fl[W_MAX];
    int open[W_MAX];
    int rounds[W_MAX];
    unsigned lose[W_MAX * STREAM_ROUNDS];
    unsigned lose0[STREAM_ROUNDS];
    unsigned short pair[W_MAX * STREAM_ROUNDS];
    int fl0, open0, npairs;
};

// The first loser of a stream still open after its first round, from the
// ballots of its `rounds` later rounds; with none, the sub-placement its
// walk stopped at (past a_max, or the end of the stream).
__device__ __forceinline__ int stream_first_loser(const unsigned* lose,
                                                  int rounds) {
    for (int q = 0; q < rounds; ++q)
        if (lose[q]) return 8 + 32 * q + __ffs(lose[q]) - 1;
    return min(8 + 32 * rounds, CHUNK_J);
}

// Block-wide, one K-way phase (select.py:668-714): the chunks of the
// winners at positions own[p], p < nown, of the phase's top-(w + 1)
// (tv, ti; entry w the waterline), own ascending, or every position < w
// when own is null. A chunk is min(max(first loser, 1), a_max), a_max =
// min(fit_cap, CHUNK_J), and 0 for an invalid winner; each winner's
// CHUNK_J-long score stream is walked until its first loser against the
// waterline, or until it has passed a_max (every chunk is capped there,
// so a later loser changes nothing). Winner 0's stream, when owned, is
// also held against the runner-up (tv[1], ti[1]; the overshoot fallback)
// by the same rule, into *chunk0, not capped at the remaining count; it
// loses to the runner-up no later than to the waterline. A first round
// gives each owned winner 8 lanes of a warp (sub-placements 0-7: most
// streams end there), warp v slots v, v + 32, v + 64 and v + 96; the
// streams still open go on from sub-placement 8, 32 a round, every round
// of every open stream at once: warp 0 lists them, one (slot, round) pair
// each up to the round that reaches a_max, and the warps share the list
// (a round past the stream's first loser is computed and not read). The
// double-precision pow of each score is what the streams cost. Writes
// chunk[own[p]] (shared or global memory) from thread p; the caller
// synchronises before reading them. Every thread calls it, after a
// barrier that orders tv, ti and own before its reads; ss may share its
// memory with the top-k's scratch.
static __device__ void kway_streams(const LocalArgs& a, const float* s_ask,
                                    const float* tv, const int* ti, int w,
                                    const int* own, int nown,
                                    StreamShared& ss, float* chunk,
                                    float* chunk0) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float wl_val = tv[w], rv = tv[1];
    const int wl_idx = ti[w], ri = ti[1];
    // slot 0 holds winner 0 when the block owns it (own ascends)
    const bool has0 = nown > 0 && (own == nullptr || own[0] == 0);
    {
        const int g = lane >> 3;
        const int p = warp + NWARPS * g;
        int c = 0, fl = CHUNK_J, fl0 = CHUNK_J, open = 0, open0 = 0;
        float a_max = 0.0f;
        if (p < nown) {
            const int wi = own ? own[p] : p;
            c = ti[wi];
            a_max = fminf(fit_cap(a, s_ask, c), (float)CHUNK_J);
            open = tv[wi] > HALF_NEG_INF;
            open0 = open && wi == 0;
            if (open && 0.0f >= a_max) {
                fl = fl0 = 0;
                open = open0 = 0;
            }
        }
        float fj = 0.0f;
        if (open) fj = sub_score(a, s_ask, c, lane & 7);
        const unsigned lose = __ballot_sync(
            0xffffffffu,
            open && !(fj > wl_val || (fj == wl_val && c < wl_idx)))
            >> (8 * g) & 0xffu;
        const unsigned lose0 = __ballot_sync(
            0xffffffffu, open0 && !(fj > rv || (fj == rv && c < ri)))
            >> (8 * g) & 0xffu;
        if (open && lose) {
            fl = __ffs(lose) - 1;
            open = 0;
        }
        if (open0 && lose0) {
            fl0 = __ffs(lose0) - 1;
            open0 = 0;
        }
        if ((lane & 7) == 0 && p < nown) {
            ss.a_max[p] = a_max;
            ss.fl[p] = fl;
            ss.open[p] = open;
            if (p == 0 && has0) {
                ss.fl0 = fl0;
                ss.open0 = open0;
            }
        }
    }
    __syncthreads();
    if (warp == 0) {
        int nq[W_MAX / 32], tot = 0;
        for (int r = 0; r < W_MAX / 32; ++r) {
            const int k = (W_MAX / 32) * lane + r;
            int q = 0;
            if (k < nown && ss.open[k])
                while (q < STREAM_ROUNDS
                       && (float)(8 + 32 * q) < ss.a_max[k]) ++q;
            nq[r] = q;
            tot += q;
        }
        int start = tot;
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, start, off);
            if (lane >= off) start += o;
        }
        if (lane == 31) ss.npairs = start;
        start -= tot;
        for (int r = 0; r < W_MAX / 32; ++r) {
            const int k = (W_MAX / 32) * lane + r;
            if (k < nown) ss.rounds[k] = nq[r];
            for (int q = 0; q < nq[r]; ++q)
                ss.pair[start++] = (unsigned short)(k * STREAM_ROUNDS + q);
        }
    }
    __syncthreads();
    for (int p = warp; p < ss.npairs; p += NWARPS) {
        const int code = ss.pair[p];
        const int k = code / STREAM_ROUNDS;
        const int j = 8 + 32 * (code % STREAM_ROUNDS) + lane;
        const int c = ti[own ? own[k] : k];
        const float fj = sub_score(a, s_ask, c, j);
        const unsigned l = __ballot_sync(
            0xffffffffu, j < CHUNK_J
            && !(fj > wl_val || (fj == wl_val && c < wl_idx)));
        if (lane == 0) ss.lose[code] = l;
        if (k == 0 && has0) {
            const unsigned l0 = __ballot_sync(
                0xffffffffu, j < CHUNK_J
                && !(fj > rv || (fj == rv && c < ri)));
            if (lane == 0) ss.lose0[code] = l0;
        }
    }
    __syncthreads();
    if (tid < nown) {
        const int wi = own ? own[tid] : tid;
        const float am = ss.a_max[tid];
        const int f = ss.open[tid]
            ? stream_first_loser(ss.lose + tid * STREAM_ROUNDS,
                                 ss.rounds[tid])
            : ss.fl[tid];
        chunk[wi] = tv[wi] > HALF_NEG_INF
            ? fminf(fmaxf((float)f, 1.0f), am) : 0.0f;
        if (wi == 0) {
            const int f0 = ss.open0
                ? stream_first_loser(ss.lose0, ss.rounds[0])
                : ss.fl0;
            *chunk0 = fminf(fmaxf((float)f0, 1.0f), am);
        }
    }
}

// Warp 0 of a K-way body, every lane: the overshoot fallback
// (select.py:716-728) applied in place to the phase's chunks chunk[k], k
// < w: when they sum past `remaining`, only the best node places, chunk0
// (its stream against the runner-up) capped at `remaining`; an invalid
// phase places nothing. Lane l reads and writes only k = l + 32 r. The
// chunks are whole numbers and their sum is below 2^24, so the warp's
// sums are exact in any order. Returns the instances placed, in every
// lane.
__device__ __forceinline__ int kway_fallback(float* chunk, float chunk0,
                                             int w, int remaining,
                                             bool valid) {
    const int lane = threadIdx.x & 31;
    float total = 0.0f;
    for (int k = lane; k < w; k += 32) total = total + chunk[k];
    for (int off = 16; off > 0; off >>= 1)
        total = total + __shfl_xor_sync(0xffffffffu, total, off);
    const bool first_only = total > (float)remaining;
    int placed = 0;
    for (int k = lane; k < w; k += 32) {
        float c = chunk[k];
        if (first_only) c = k == 0 ? fminf(chunk0, (float)remaining) : 0.0f;
        if (!valid) c = 0.0f;
        chunk[k] = c;
        placed += (int)c;
    }
    return warp_sum(placed);
}

// Outputs of the K-way kernels, in the packed int layout of
// select.py:765-768: per row [widx (W) | chunk (W) | top-k idx (5) |
// exhausted (d) | feasible count | remaining | steps].
struct KwayOut {
    int* packed;   // [max_steps, 2w + 5 + d + 3]
    float* ts;     // [max_steps, 5]
    int w;
};

struct ScanArgs {
    const float* capacity;   // [n, d]
    float* used;             // [n, d] carry
    const uint8_t* feasible; // [n]
    const float* ask;        // [d]
    int* tg_coll;            // [n] carry
    int* job_cnt;            // [n] carry
    int* scan_placed;        // [n] carry (zeros on entry)
    const uint8_t* penalty;  // [n]
    const float* affinity;   // [n]
    float* free_p;           // [n] carry
    const uint8_t* port_ok;  // [n]
    float* dev_slots;        // [n] carry
    const float* dev_score;  // [n]
    const float* pre_score;  // [n]
    const int* sp_codes;     // [S, n]
    const float* sp_counts0; // [S, C]
    const uint8_t* sp_present0;  // [S, C]
    const float* sp_desired; // [S, C]
    const float* sp_weight;  // [S]
    const uint8_t* sp_has_targets;  // [S]
    const uint8_t* sp_valid; // [S]
    const int* dp_codes;     // [P, n]
    const float* dp_counts0; // [P, C]
    const float* dp_limit;   // [P]
    const uint8_t* dp_valid; // [P]
    float* sp_counts;        // [S, C] carry out
    uint8_t* sp_present;     // [S, C] carry out
    float* dp_counts;        // [P, C] carry out
    float* masked;           // [n] scratch
    int n, d, k_valid, k_steps, spread_alg, s_live, p_live;
    float distinct_hosts, scan_exclusive, desired, port_need, dev_fires,
          sum_spread_w;
};

struct ScanOut {
    int* choice;
    float *final_, *binpack, *anti, *pen, *aff, *spread, *dev, *pre;
    int* ti;       // [k_steps, 5]
    float* ts;     // [k_steps, 5]
    int* exh;      // [k_steps, d]
    int* ok_count; // [k_steps]
};

struct ScanShared {
    float cnt[S_MAX * C_AXIS];
    uint8_t pres[S_MAX * C_AXIS];
    float des[S_MAX * C_AXIS];
    float dp[P_MAX * C_AXIS];
    float mn[S_MAX], mx[S_MAX], w[S_MAX], dpl[P_MAX];
    int any[S_MAX], hast[S_MAX], spv[S_MAX], dpv[P_MAX];
};

struct ScanEval {
    bool feas, fit;
    unsigned fit_bits;
    float binpack, anti, pen, aff, spread, dev, final_;
};

// One node's feasibility and score components (select.py:202-304).
static __device__ ScanEval scan_eval(const ScanArgs& a,
                                     const ScanShared& sh,
                                     const float* s_ask, int x) {
    ScanEval e;
    bool feas = a.feasible[x] != 0;
    if (a.distinct_hosts > 0.0f) feas = feas && a.job_cnt[x] == 0;
    if (a.scan_exclusive > 0.0f) feas = feas && a.scan_placed[x] == 0;
    feas = feas && (a.free_p[x] >= a.port_need);
    feas = feas && (a.port_ok[x] != 0);
    feas = feas && (a.dev_slots[x] >= 1.0f);
    for (int p = 0; p < a.p_live; ++p) {
        const int code = a.dp_codes[p * a.n + x];
        const float cnt = sh.dp[p * C_AXIS + code];
        const bool missing = code == C_AXIS - 1;
        const bool ok = (cnt + 1.0f <= sh.dpl[p]) && !missing;
        if (sh.dpv[p]) feas = feas && ok;
    }
    bool fit = true;
    unsigned bits = 0;
    float after0 = 0.0f, after1 = 0.0f;
    for (int dd = 0; dd < a.d; ++dd) {
        float af = a.used[x * a.d + dd] + s_ask[dd];
        bool f = af <= a.capacity[x * a.d + dd] + 1e-6f;
        if (f) bits |= 1u << dd;
        fit = fit && f;
        if (dd == 0) after0 = af;
        if (dd == 1) after1 = af;
    }
    const float cap_cpu = fmaxf(a.capacity[x * a.d + 0], 1e-9f);
    const float cap_mem = fmaxf(a.capacity[x * a.d + 1], 1e-9f);
    float free_cpu = 1.0f - after0 / cap_cpu;
    float free_mem = 1.0f - after1 / cap_mem;
    float total = pow10_exact(free_cpu) + pow10_exact(free_mem);
    float fs = a.spread_alg ? fminf(fmaxf(total - 2.0f, 0.0f), 18.0f)
                            : fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
    e.binpack = fs / 18.0f;
    const float coll = (float)a.tg_coll[x];
    const bool anti_f = coll > 0.0f;
    e.anti = anti_f ? -(coll + 1.0f) / fmaxf(a.desired, 1.0f) : 0.0f;
    const bool pen_f = a.penalty[x] != 0;
    e.pen = pen_f ? -1.0f : 0.0f;
    e.aff = a.affinity[x];
    const bool aff_f = e.aff != 0.0f;
    e.dev = a.dev_fires > 0.0f ? a.dev_score[x] : 0.0f;
    const float pre = a.pre_score[x];
    const bool pre_f = pre != 0.0f;

    float st = 0.0f;
    for (int s = 0; s < a.s_live; ++s) {
        const int code = a.sp_codes[s * a.n + x];
        const bool missing = code == C_AXIS - 1;
        const float used_cnt = sh.cnt[s * C_AXIS + code] + 1.0f;
        const float desired = sh.des[s * C_AXIS + code];
        const bool has_desired = desired >= 0.0f;
        const float targeted = has_desired
            ? (desired - used_cnt) / fmaxf(desired, 1e-9f) * sh.w[s]
            : -1.0f;
        const float min_cnt = sh.mn[s], max_cnt = sh.mx[s];
        const float cur = sh.cnt[s * C_AXIS + code];
        float even = (min_cnt == 0.0f)
            ? -1.0f : (min_cnt - cur) / fmaxf(min_cnt, 1e-9f);
        if (cur == min_cnt)
            even = (min_cnt == max_cnt) ? -1.0f
                 : ((min_cnt == 0.0f) ? 1.0f
                    : (max_cnt - min_cnt) / fmaxf(min_cnt, 1e-9f));
        if (!sh.any[s]) even = 0.0f;
        if (missing) even = -1.0f;
        const float contrib = sh.hast[s] ? (missing ? -1.0f : targeted) : even;
        st = st + (sh.spv[s] ? contrib : 0.0f);
    }
    e.spread = st;
    const bool spread_f = st != 0.0f;
    const float fired = 1.0f + (anti_f ? 1.0f : 0.0f) + (pen_f ? 1.0f : 0.0f)
                        + (aff_f ? 1.0f : 0.0f) + (spread_f ? 1.0f : 0.0f)
                        + (a.dev_fires > 0.0f ? 1.0f : 0.0f)
                        + (pre_f ? 1.0f : 0.0f);
    e.final_ = (e.binpack + e.anti + e.pen + e.aff + st + e.dev + pre) / fired;
    e.feas = feas;
    e.fit = fit;
    e.fit_bits = bits;
    return e;
}

// ---------------------------------------------------------------------------
// Batched launches: every per-node argument, carry, scratch and output
// carries a leading lane axis at its solo shape; capacity is shared by all
// lanes, and the per-lane scalars are [lanes] device arrays (vmap maps
// them on axis 0: select.py:607-608, :406-407, _KWAY_BATCH_AXES). The
// functions below give lane b's solo view.
// ---------------------------------------------------------------------------

// Outputs of the chunked kernels.
struct ChunkedOut {
    int* choice;   // [max_steps]
    int* chunk;    // [max_steps]
    int* ti;       // [max_steps, 5]
    float* ts;     // [max_steps, 5]
    int* exh;      // [max_steps, d]
    int* feas;     // [max_steps]
    int* rem_steps;  // [2]: remaining, steps
};

// Per-lane scalars of the batched node-local kernels.
struct LocalLanes {
    const int* k_valid;
    const float* desired;
    const float* port_need;
    const float* dev_fires;
};

// Per-lane scalars of the batched scan.
struct ScanLanes {
    const int* k_valid;
    const float *distinct_hosts, *scan_exclusive, *desired, *port_need,
                *dev_fires, *sum_spread_w;
};

__device__ __forceinline__ LocalArgs local_lane(LocalArgs a,
                                                const LocalLanes& l, int b) {
    const size_t n = a.n, nd = (size_t)a.n * a.d;
    a.used += b * nd;
    a.feasible += b * n;
    a.ask += (size_t)b * a.d;
    a.coll += b * n;
    a.penalty += b * n;
    a.affinity += b * n;
    a.free_p += b * n;
    a.port_ok += b * n;
    a.dev_slots += b * n;
    a.dev_score += b * n;
    a.pre_score += b * n;
    a.masked += b * n;
    a.k_valid = l.k_valid[b];
    a.desired = l.desired[b];
    a.port_need = l.port_need[b];
    a.dev_fires = l.dev_fires[b];
    return a;
}

__device__ __forceinline__ ChunkedOut chunked_out_lane(ChunkedOut o, int b,
                                                       const LocalArgs& a) {
    const size_t ms = a.max_steps;
    o.choice += b * ms;
    o.chunk += b * ms;
    o.ti += b * ms * TOP_K;
    o.ts += b * ms * TOP_K;
    o.exh += b * ms * a.d;
    o.feas += b * ms;
    o.rem_steps += (size_t)b * 2;
    return o;
}

__device__ __forceinline__ KwayOut kway_out_lane(KwayOut o, int b,
                                                 const LocalArgs& a) {
    const size_t ms = a.max_steps;
    o.packed += b * ms * (2 * o.w + TOP_K + a.d + 3);
    o.ts += b * ms * TOP_K;
    return o;
}

// Lane b's scan: k_steps, s_live and p_live are the batch's largest; a
// lane's stanzas past its own count have sp_valid / dp_valid false and add
// nothing.
__device__ __forceinline__ ScanArgs scan_lane(ScanArgs a,
                                              const ScanLanes& l, int b) {
    const size_t n = a.n, nd = (size_t)a.n * a.d;
    const size_t sc = (size_t)S_MAX * C_AXIS, pc = (size_t)P_MAX * C_AXIS;
    a.used += b * nd;
    a.feasible += b * n;
    a.ask += (size_t)b * a.d;
    a.tg_coll += b * n;
    a.job_cnt += b * n;
    a.scan_placed += b * n;
    a.penalty += b * n;
    a.affinity += b * n;
    a.free_p += b * n;
    a.port_ok += b * n;
    a.dev_slots += b * n;
    a.dev_score += b * n;
    a.pre_score += b * n;
    a.sp_codes += b * S_MAX * n;
    a.sp_counts0 += b * sc;
    a.sp_present0 += b * sc;
    a.sp_desired += b * sc;
    a.sp_weight += (size_t)b * S_MAX;
    a.sp_has_targets += (size_t)b * S_MAX;
    a.sp_valid += (size_t)b * S_MAX;
    a.dp_codes += b * P_MAX * n;
    a.dp_counts0 += b * pc;
    a.dp_limit += (size_t)b * P_MAX;
    a.dp_valid += (size_t)b * P_MAX;
    a.sp_counts += b * sc;
    a.sp_present += b * sc;
    a.dp_counts += b * pc;
    a.masked += b * n;
    a.k_valid = l.k_valid[b];
    a.distinct_hosts = l.distinct_hosts[b];
    a.scan_exclusive = l.scan_exclusive[b];
    a.desired = l.desired[b];
    a.port_need = l.port_need[b];
    a.dev_fires = l.dev_fires[b];
    a.sum_spread_w = l.sum_spread_w[b];
    return a;
}

__device__ __forceinline__ ScanOut scan_out_lane(ScanOut o, int b,
                                                 const ScanArgs& a) {
    const size_t k = a.k_steps;
    o.choice += b * k;
    o.final_ += b * k;
    o.binpack += b * k;
    o.anti += b * k;
    o.pen += b * k;
    o.aff += b * k;
    o.spread += b * k;
    o.dev += b * k;
    o.pre += b * k;
    o.ti += b * k * TOP_K;
    o.ts += b * k * TOP_K;
    o.exh += b * k * a.d;
    o.ok_count += b * k;
    return o;
}
