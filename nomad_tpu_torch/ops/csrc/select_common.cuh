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

// A fit dimension's power: 10**(1 - after / cap), cap clamped by the
// caller (select.py:419-421).
__device__ __forceinline__ float free_pow(float after, float cap) {
    return pow10_exact(1.0f - after / cap);
}

// _local_final_score (select.py:411-443), term for term, from the sum of
// the two powers (cpu + mem).
__device__ __forceinline__ float local_score_of(
        float total, float coll, bool pen, float aff, float desired,
        int spread_alg, float dev_score, float dev_fires, float pre) {
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

__device__ __forceinline__ float local_score(
        float after0, float after1, float cap_cpu, float cap_mem, float coll,
        bool pen, float aff, float desired, int spread_alg, float dev_score,
        float dev_fires, float pre) {
    return local_score_of(
        free_pow(after0, cap_cpu) + free_pow(after1, cap_mem), coll, pen,
        aff, desired, spread_alg, dev_score, dev_fires, pre);
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

// A row's feasibility before its fit (select.py:478-479), and one fit
// dimension (:480-482): used + ask within the capacity.
__device__ __forceinline__ bool row_feasible(bool feasible, float free_p,
                                             float port_need, bool port_ok,
                                             float dev_slots) {
    return feasible && (free_p >= port_need) && port_ok
           && (dev_slots >= 1.0f);
}

__device__ __forceinline__ bool dim_fits(float after, float cap) {
    return after <= cap + 1e-6f;
}

// Row x's masked score (its score where it is feasible and fits, NEG_INF
// elsewhere), counting its first failing dimension and its ok into r. The
// sweeps and the K-way kernel's winner-only rescoring both evaluate a row
// through this one function, and the chunked step warp through its pieces
// (row_feasible, dim_fits, free_pow, local_score_of), so all give the same
// bits.
__device__ __forceinline__ float local_row(const LocalArgs& a,
                                           const float* s_ask, int x,
                                           Sweep& r) {
    bool feas = row_feasible(a.feasible[x], a.free_p[x], a.port_need,
                             a.port_ok[x], a.dev_slots[x]);
    bool fit = true, earlier = true;
    float after0 = 0.0f, after1 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) {
        if (dd < a.d) {
            float af = a.used[x * a.d + dd] + s_ask[dd];
            bool f = dim_fits(af, a.capacity[x * a.d + dd]);
            if (feas && earlier && !f) r.cnt[dd] += 1;
            earlier = earlier && f;
            fit = fit && f;
            if (dd == 0) after0 = af;
            if (dd == 1) after1 = af;
        }
    }
    // a row that is not feasible or does not fit spends no power
    if (!(feas && fit)) return NEG_INF;
    r.okc += 1;
    float cap_cpu = fmaxf(a.capacity[x * a.d + 0], 1e-9f);
    float cap_mem = fmaxf(a.capacity[x * a.d + 1], 1e-9f);
    return local_score(after0, after1, cap_cpu, cap_mem, (float)a.coll[x],
                       a.penalty[x] != 0, a.affinity[x], a.desired,
                       a.spread_alg, a.dev_score[x], a.dev_fires,
                       a.pre_score[x]);
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

// The chunked kernels' carries as the caller passed them. Their step-0
// sweep copies each row it reads into LocalArgs' carries (the launch's own,
// fresh outputs), so the wrappers launch no copy of their own.
struct LocalCarry {
    const float* used;       // [n, d]
    const int* coll;         // [n]
    const float* free_p;     // [n]
    const float* dev_slots;  // [n]
};

// Row x's carries copied from the caller's into the launch's own.
__device__ __forceinline__ void copy_carry(const LocalCarry& c,
                                           const LocalArgs& a, int x) {
    for (int dd = 0; dd < a.d; ++dd)
        a.used[x * a.d + dd] = c.used[x * a.d + dd];
    a.coll[x] = c.coll[x];
    a.free_p[x] = c.free_p[x];
    a.dev_slots[x] = c.dev_slots[x];
}

// local_sweep_rows, each row's carries first copied from c.
__device__ __forceinline__ Sweep local_sweep_copy(const LocalArgs& a,
                                                  const LocalCarry& c,
                                                  const float* s_ask,
                                                  int lo, int hi) {
    Sweep r;
    r.okc = 0;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) r.cnt[dd] = 0;
    for (int x = lo + threadIdx.x; x < hi; x += NT) {
        copy_carry(c, a, x);
        a.masked[x] = local_row(a, s_ask, x, r);
    }
    return r;
}

// One sweep over the whole table.
__device__ __forceinline__ Sweep local_sweep(const LocalArgs& a,
                                             const float* s_ask) {
    return local_sweep_rows(a, s_ask, 0, a.n);
}

// A fit dimension's usage after sub-placement jf (select.py:538).
__device__ __forceinline__ float sub_after(float used, float jf, float ask) {
    return used + (jf + 1.0f) * ask;
}

// Score of the s-th sub-placement on node c (select.py:538-544).
__device__ __forceinline__ float sub_score(const LocalArgs& a,
                                           const float* s_ask, int c, int j) {
    float jf = (float)j;
    float after0 = sub_after(a.used[c * a.d + 0], jf, s_ask[0]);
    float after1 = sub_after(a.used[c * a.d + 1], jf, s_ask[1]);
    float coll_j = (float)a.coll[c] + jf;
    return local_score(after0, after1, fmaxf(a.capacity[c * a.d + 0], 1e-9f),
                       fmaxf(a.capacity[c * a.d + 1], 1e-9f), coll_j,
                       a.penalty[c] != 0, a.affinity[c], a.desired,
                       a.spread_alg, a.dev_score[c], a.dev_fires,
                       a.pre_score[c]);
}

// Instances that physically fit on node c (select.py:526-533), before the
// remaining-count cap: one dimension's (fit_dim), then the least of them
// with the ports' and the device slots' (fit_rest).
__device__ __forceinline__ float fit_dim(float cap, float used, float ask) {
    return ask > 0.0f ? floorf(((cap - used) + 1e-6f) / ask) : 1e9f;
}

__device__ __forceinline__ float fit_rest(float m_fit, float free_p,
                                          float port_need, float dev_slots) {
    float m_port = port_need > 0.0f ? floorf(free_p / port_need) : 1e9f;
    return fminf(fminf(m_fit, m_port), dev_slots);
}

__device__ __forceinline__ float fit_cap(const LocalArgs& a,
                                         const float* s_ask, int c) {
    float m_fit = INFINITY;
    for (int dd = 0; dd < a.d; ++dd)
        m_fit = fminf(m_fit, fit_dim(a.capacity[c * a.d + dd],
                                     a.used[c * a.d + dd], s_ask[dd]));
    return fit_rest(m_fit, a.free_p[c], a.port_need, a.dev_slots[c]);
}

// A row's used, free ports and device slots after `chunk` instances
// (select.py:557-560).
__device__ __forceinline__ float placed_used(float used, float chunk,
                                             float ask) {
    return used + chunk * ask;
}

__device__ __forceinline__ float placed_ports(float free_p, float chunk,
                                              float port_need) {
    return free_p + (-chunk) * port_need;
}

__device__ __forceinline__ float placed_slots(float dev_slots, float chunk) {
    return dev_slots + (-chunk);
}

// Scatter `chunk` instances onto node c (select.py:557-560).
__device__ __forceinline__ void place(const LocalArgs& a, const float* s_ask,
                                      int c, float chunk) {
    for (int dd = 0; dd < a.d; ++dd)
        a.used[c * a.d + dd] = placed_used(a.used[c * a.d + dd], chunk,
                                           s_ask[dd]);
    a.coll[c] = a.coll[c] + (int)chunk;
    a.free_p[c] = placed_ports(a.free_p[c], chunk, a.port_need);
    a.dev_slots[c] = placed_slots(a.dev_slots[c], chunk);
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
    float w[S_MAX], dpl[P_MAX];
    int hast[S_MAX], spv[S_MAX], dpv[P_MAX];
};

// One row's node-local terms (select.py:202-253 and the fired count's
// node-local flags): everything in its score and feasibility but the
// spread and distinct_property terms, which depend on the row only through
// its codes. A step changes them only at its winner's row.
struct ScanLocal {
    bool feas, fit;      // node-local feasibility; every dimension fits
    unsigned fit_bits;   // bit dd: dimension dd fits
    float free_cpu, free_mem;   // the powers' exponents
    float binpack, anti, pen, aff, dev, pre;
    float part;          // ((binpack + anti) + pen) + aff
    float fired_base;    // the fired count without the spread's flag
};

// What row x's node-local terms read, its loads issued in one round (no
// short-circuit makes one wait on another): its fit to one more instance
// dimension by dimension, and its other state and inputs.
struct ScanRow {
    unsigned fit_bits;        // bit dd: used + ask fits dimension dd
    bool fit;                 // every dimension fits
    float after0, after1;     // used + ask in dimensions 0 and 1
    float cap0, cap1;         // capacity in dimensions 0 and 1
    float free_p, dev_slots, affinity, dev_score, pre;
    int job_cnt, scan_placed, tg_coll;
    bool feasible, port_ok, penalty;
};

// One dimension's fit (select.py:220-222), and the row's after and
// capacity in dimensions 0 and 1.
__device__ __forceinline__ void row_dim(ScanRow& v, int dd, float used,
                                        float cap, float ask) {
    const float af = used + ask;
    const bool f = af <= cap + 1e-6f;
    if (f) v.fit_bits |= 1u << dd;
    v.fit = v.fit && f;
    if (dd == 0) { v.after0 = af; v.cap0 = cap; }
    if (dd == 1) { v.after1 = af; v.cap1 = cap; }
}

// Row x's state and inputs but its dimensions.
__device__ __forceinline__ void row_scalars(ScanRow& v, const ScanArgs& a,
                                            int x) {
    v.free_p = a.free_p[x];
    v.dev_slots = a.dev_slots[x];
    v.affinity = a.affinity[x];
    v.dev_score = a.dev_score[x];
    v.pre = a.pre_score[x];
    v.job_cnt = a.job_cnt[x];
    v.scan_placed = a.scan_placed[x];
    v.tg_coll = a.tg_coll[x];
    v.feasible = a.feasible[x] != 0;
    v.port_ok = a.port_ok[x] != 0;
    v.penalty = a.penalty[x] != 0;
}

__device__ __forceinline__ ScanRow scan_row(const ScanArgs& a,
                                            const float* s_ask, int x) {
    ScanRow v;
    v.fit_bits = 0u;
    v.fit = true;
    v.after0 = v.after1 = v.cap0 = v.cap1 = 0.0f;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd)
        if (dd < a.d)
            row_dim(v, dd, a.used[x * a.d + dd], a.capacity[x * a.d + dd],
                    s_ask[dd]);
    row_scalars(v, a, x);
    return v;
}

// A row's node-local terms but binpack and part, which take the two
// powers (scan_local_fit), from what scan_row loaded.
static __device__ __forceinline__ ScanLocal scan_local_of(
        const ScanArgs& a, const ScanRow& v) {
    ScanLocal l;
    bool feas = v.feasible;
    if (a.distinct_hosts > 0.0f) feas = feas && v.job_cnt == 0;
    if (a.scan_exclusive > 0.0f) feas = feas && v.scan_placed == 0;
    feas = feas && (v.free_p >= a.port_need);
    feas = feas && v.port_ok;
    feas = feas && (v.dev_slots >= 1.0f);
    const float cap_cpu = fmaxf(v.cap0, 1e-9f);
    const float cap_mem = fmaxf(v.cap1, 1e-9f);
    l.free_cpu = 1.0f - v.after0 / cap_cpu;
    l.free_mem = 1.0f - v.after1 / cap_mem;
    const float coll = (float)v.tg_coll;
    const bool anti_f = coll > 0.0f;
    l.anti = anti_f ? -(coll + 1.0f) / fmaxf(a.desired, 1.0f) : 0.0f;
    const bool pen_f = v.penalty;
    l.pen = pen_f ? -1.0f : 0.0f;
    l.aff = v.affinity;
    const bool aff_f = l.aff != 0.0f;
    l.dev = a.dev_fires > 0.0f ? v.dev_score : 0.0f;
    l.pre = v.pre;
    const bool pre_f = l.pre != 0.0f;
    // whole numbers below 8: exact in any order
    l.fired_base = 1.0f + (anti_f ? 1.0f : 0.0f) + (pen_f ? 1.0f : 0.0f)
                   + (aff_f ? 1.0f : 0.0f)
                   + (a.dev_fires > 0.0f ? 1.0f : 0.0f)
                   + (pre_f ? 1.0f : 0.0f);
    l.feas = feas;
    l.fit = v.fit;
    l.fit_bits = v.fit_bits;
    return l;
}

// Row x's node-local terms but binpack and part.
static __device__ __forceinline__ ScanLocal scan_local_terms(
        const ScanArgs& a, const float* s_ask, int x) {
    return scan_local_of(a, scan_row(a, s_ask, x));
}

// binpack and part from total = 10**free_cpu + 10**free_mem.
__device__ __forceinline__ void scan_local_fit(const ScanArgs& a,
                                               ScanLocal& l, float total) {
    float fs = a.spread_alg ? fminf(fmaxf(total - 2.0f, 0.0f), 18.0f)
                            : fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
    l.binpack = fs / 18.0f;
    l.part = l.binpack + l.anti + l.pen + l.aff;
}

// Row x's node-local terms. With `lazy`, the two pow are taken only where
// the row is feasible, fits and is `admitted` (by the distinct_property
// limits): elsewhere binpack and part are meaningless, and no caller reads
// them.
static __device__ __forceinline__ ScanLocal scan_local(const ScanArgs& a,
                                                       const float* s_ask,
                                                       int x,
                                                       bool lazy = false,
                                                       bool admitted = true) {
    ScanLocal l = scan_local_terms(a, s_ask, x);
    float total = 0.0f;
    if (!lazy || (l.feas && l.fit && admitted))
        total = pow10_exact(l.free_cpu) + pow10_exact(l.free_mem);
    scan_local_fit(a, l, total);
    return l;
}

// Spread stanza s's term for a row of attribute code `code`
// (select.py:256-296), from the histograms and the step's bounds over the
// present codes (min_cnt, max_cnt, any); 0.0f for a stanza that is not
// valid.
static __device__ __forceinline__ float spread_term_at(const ScanShared& sh,
                                                       int s, int code,
                                                       float min_cnt,
                                                       float max_cnt,
                                                       int any) {
    const bool missing = code == C_AXIS - 1;
    const float used_cnt = sh.cnt[s * C_AXIS + code] + 1.0f;
    const float desired = sh.des[s * C_AXIS + code];
    const bool has_desired = desired >= 0.0f;
    const float targeted = has_desired
        ? (desired - used_cnt) / fmaxf(desired, 1e-9f) * sh.w[s]
        : -1.0f;
    const float cur = sh.cnt[s * C_AXIS + code];
    float even = (min_cnt == 0.0f)
        ? -1.0f : (min_cnt - cur) / fmaxf(min_cnt, 1e-9f);
    if (cur == min_cnt)
        even = (min_cnt == max_cnt) ? -1.0f
             : ((min_cnt == 0.0f) ? 1.0f
                : (max_cnt - min_cnt) / fmaxf(min_cnt, 1e-9f));
    if (!any) even = 0.0f;
    if (missing) even = -1.0f;
    const float contrib = sh.hast[s] ? (missing ? -1.0f : targeted) : even;
    return sh.spv[s] ? contrib : 0.0f;
}

// Whether distinct_property p admits one more placement on a row of code
// `code` (select.py:211-217); true for a constraint that is not valid.
static __device__ __forceinline__ bool dp_admits(const ScanShared& sh, int p,
                                                 int code) {
    const float cnt = sh.dp[p * C_AXIS + code];
    const bool missing = code == C_AXIS - 1;
    const bool ok = (cnt + 1.0f <= sh.dpl[p]) && !missing;
    return !sh.dpv[p] || ok;
}

// A row's score from its node-local terms and its spread total st: the sum
// (binpack + anti + pen + aff + st + dev + pre) left to right, over the
// fired count with the spread's flag added last (select.py:298-305).
__device__ __forceinline__ float scan_score(float part, float st, float dev,
                                            float pre, float fired_base) {
    return (((part + st) + dev) + pre)
           / (fired_base + (st != 0.0f ? 1.0f : 0.0f));
}

// ---------------------------------------------------------------------------
// The scan body's cached terms (select_kernels.cu, scan_body): each row's
// node-local terms, kept between steps.
//   rec   by row (part, dev, pre, flags); flags (the float's bits) hold the
//         fit bits (0-7), the fired count without the spread's flag
//         (8-11), node-local feasibility (bit 12) and whether every
//         dimension fits (bit 13);
//   codes by row: the S_MAX spread codes (.x) and the P_MAX
//         distinct_property codes (.y), a byte each (codes are at most
//         C_AXIS - 1).
// A row that is not feasible or does not fit at step 0 never is at a later
// step: its state changes only if it wins a step, which takes a row that
// is feasible and fits, and the distinct_property counts only grow. So
// step 0 lists the other rows, the live ones, in row order: slot i is row
// lrow[i], with its record (part, dev, pre, w: scan_slot_rec) and codes in
// the dynamic shared memory below slot ns and in device memory from it,
// and its score components (binpack, anti, pen, aff) in lcomp for the
// winner's outputs. The later steps sweep only the slots; the records by
// row give the first invalid step's top-5 and counts. After step 0 only
// the winner's records change, rescored from its updated state.
// ---------------------------------------------------------------------------
#define REC_FIRED_SHIFT 8
#define REC_FEAS (1u << 12)
#define REC_FIT (1u << 13)

struct ScanRecs {
    float4* rec;     // [n] by row
    uint2* codes;    // [n] by row
    float4* lrec;    // [n] by slot: the live rows' records, from slot ns
    uint2* lcodes;   // [n] by slot, from slot ns
    float4* lcomp;   // [n] by slot
    int* lrow;       // [n] by slot: the slot's row
    // the first ns slots' records in shared memory (scan_body)
    float4* srec;
    uint2* scodes;
    int ns;
};

// Slot i's record and codes, in shared memory below ns.
__device__ __forceinline__ float4* slot_rec(const ScanRecs& r, int i) {
    return i < r.ns ? r.srec + i : r.lrec + i;
}
__device__ __forceinline__ uint2* slot_codes(const ScanRecs& r, int i) {
    return i < r.ns ? r.scodes + i : r.lcodes + i;
}

// The step's per-code tables: sp[s][code] is spread_term_at(s, code) for
// s < s_live and +0.0f past it; dp[p][code] is dp_admits(p, code) for p <
// p_live and 1 past it (scan_tables_init). A row's spread total adds all
// S_MAX terms from +0.0f: a sum that starts at +0.0f is never -0.0f (in
// round-to-nearest x + y is -0.0f only where both are), so adding +0.0f
// past s_live leaves its bits as the reference's sum over the live
// stanzas (select.py:256-296); and admitting past p_live changes nothing.
// So a row's terms take no branch on s_live or p_live.
struct ScanTables {
    float sp[S_MAX][C_AXIS];
    uint8_t dp[P_MAX][C_AXIS];
    // each live stanza's bounds over its present codes (scan_tables): the
    // minimum count and how many present codes hold it, the maximum, any
    float mn[S_MAX], mx[S_MAX];
    int nmin[S_MAX], any[S_MAX];
    int full[S_MAX];   // this step rebuilds the stanza's whole column
};

// The tables' entries past s_live and p_live, once a launch; the caller
// synchronises before they are read.
__device__ __forceinline__ void scan_tables_init(ScanTables& t) {
    for (int e = threadIdx.x; e < S_MAX * C_AXIS; e += NT)
        (&t.sp[0][0])[e] = 0.0f;
    for (int e = threadIdx.x; e < P_MAX * C_AXIS; e += NT)
        (&t.dp[0][0])[e] = 1;
}

// A scan body's start: the request's histograms, stanzas and constraints
// into the block's shared memory (every block of a sharded lane keeps its
// own copy, identical in all of them), the ask, and the tables' entries
// past s_live and p_live. The caller synchronises before they are read.
static __device__ __forceinline__ void scan_state_init(const ScanArgs& a,
                                                       ScanShared& sh,
                                                       ScanTables& tab,
                                                       float* s_ask) {
    const int tid = threadIdx.x;
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
    scan_tables_init(tab);
}

// A scan body's end, block-wide, after a barrier that orders the outputs
// of step `stop` (the first invalid step, or k_steps): every later step
// repeats that one, so its outputs are copied into the rows after it; and
// the histograms out.
static __device__ __forceinline__ void scan_finish(const ScanArgs& a,
                                                   const ScanOut& o,
                                                   const ScanShared& sh,
                                                   int stop) {
    const int tid = threadIdx.x;
    for (int s = stop + 1 + tid; s < a.k_steps; s += NT) {
        o.choice[s] = -1;
        o.final_[s] = 0.0f;
        o.binpack[s] = 0.0f;
        o.anti[s] = 0.0f;
        o.pen[s] = 0.0f;
        o.aff[s] = 0.0f;
        o.spread[s] = 0.0f;
        o.dev[s] = 0.0f;
        o.pre[s] = 0.0f;
        for (int k = 0; k < TOP_K; ++k) {
            o.ti[s * TOP_K + k] = o.ti[stop * TOP_K + k];
            o.ts[s * TOP_K + k] = o.ts[stop * TOP_K + k];
        }
        for (int dd = 0; dd < a.d; ++dd)
            o.exh[s * a.d + dd] = o.exh[stop * a.d + dd];
        o.ok_count[s] = o.ok_count[stop];
    }
    for (int e = tid; e < S_MAX * C_AXIS; e += NT) {
        a.sp_counts[e] = sh.cnt[e];
        a.sp_present[e] = sh.pres[e];
    }
    for (int e = tid; e < P_MAX * C_AXIS; e += NT) a.dp_counts[e] = sh.dp[e];
}

// A record from a row's node-local terms.
__device__ __forceinline__ float4 scan_rec(const ScanLocal& l) {
    const unsigned flags = l.fit_bits
        | ((unsigned)l.fired_base << REC_FIRED_SHIFT)
        | (l.feas ? REC_FEAS : 0u) | (l.fit ? REC_FIT : 0u);
    return make_float4(l.part, l.dev, l.pre, __uint_as_float(flags));
}

// A slot's record: (part, dev, pre, w), w the fired count without the
// spread's flag where the row is feasible (node-local) and fits, -1
// elsewhere. (Slots that kept the row's record, its flags decoded in the
// sweep, took 4-9% longer a launch at the main shapes on an H100:
// scripts/profile_scan.py --compare.)
__device__ __forceinline__ float4 scan_slot_rec(const ScanLocal& l) {
    return make_float4(l.part, l.dev, l.pre,
                       l.feas && l.fit ? l.fired_base : -1.0f);
}

// Row x's codes, a byte each.
__device__ __forceinline__ uint2 scan_codes(const ScanArgs& a, int x) {
    unsigned sp = 0u, dp = 0u;
#pragma unroll
    for (int s = 0; s < S_MAX; ++s)
        sp |= (unsigned)a.sp_codes[s * a.n + x] << (8 * s);
#pragma unroll
    for (int p = 0; p < P_MAX; ++p)
        dp |= (unsigned)a.dp_codes[p * a.n + x] << (8 * p);
    return make_uint2(sp, dp);
}

// Whether every distinct_property admits a row of these codes (1 or 0).
__device__ __forceinline__ unsigned scan_dp_ok(const ScanTables& t,
                                               unsigned dp) {
    return t.dp[0][dp & 255u] & t.dp[1][(dp >> 8) & 255u]
           & t.dp[2][(dp >> 16) & 255u] & t.dp[3][dp >> 24];
}

// A row's spread total from its spread codes: the reference's sum over
// the stanzas, in stanza order, from +0.0f (select.py:256-296).
__device__ __forceinline__ float scan_spread(const ScanTables& t,
                                             unsigned sp) {
    float st = 0.0f;
    st = st + t.sp[0][sp & 255u];
    st = st + t.sp[1][(sp >> 8) & 255u];
    st = st + t.sp[2][(sp >> 16) & 255u];
    st = st + t.sp[3][sp >> 24];
    return st;
}

// A row's masked score from its record and codes and the step's tables
// (its score where it is feasible and fits, NEG_INF elsewhere): the
// reference's float operations in its order (select.py:298-305), with no
// pow and no branch. feas is the row's whole feasibility (node-local and
// distinct_property), st its spread total.
__device__ __forceinline__ float scan_compose(const float4& rec,
                                              const uint2& cd,
                                              const ScanTables& t,
                                              bool& feas, float& st) {
    const unsigned flags = __float_as_uint(rec.w);
    // REC_FEAS's bit and the constraints' (bitwise: no branch)
    feas = ((flags >> 12) & scan_dp_ok(t, cd.y)) != 0u;
    st = scan_spread(t, cd.x);
    const float fired_base = (float)((flags >> REC_FIRED_SHIFT) & 15u);
    const float sc = scan_score(rec.x, st, rec.y, rec.z, fired_base);
    return feas && (flags & REC_FIT) ? sc : NEG_INF;
}

// Named barriers beside __syncthreads (barrier 0), used by scan_body and
// scan_tables: the sweepers' start; the tables' hand-over from the warps
// that build them to the winner's warp; and one a stanza, among the warps
// that build its table.
#define BAR_SWEEP 1
#define BAR_TABLES 2
#define BAR_STANZA 3   // BAR_STANZA + s for stanza s < S_MAX

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// The warps that build the tables: STANZA_WARPS a spread stanza (one code
// a thread), then one a distinct_property.
#define STANZA_WARPS 3
#define TABLE_WARPS (STANZA_WARPS * S_MAX + P_MAX)

// The step's tables from the histograms, on warps 0 to TABLE_WARPS - 1.
// When `won` is given (the last valid step's winner's codes), the first
// warp of stanza s counts the placement in its histogram and the warp of
// distinct_property p in its counts, every stanza and constraint row, live
// or padding. A placement changes one code's count a stanza, so with
// `build` only that code's entries change, unless a stanza's bounds over
// its present codes change, on which every code's even-spread term
// depends (select.py:270-293): the counting thread finds the new bounds
// from the old ones where one comparison does (a count that rises past
// the maximum, or a code at the minimum that others share or that was not
// present before: bounds change only as the full scan would change them)
// and fills that code's entry; a targeted stanza's entries need no bounds.
// Otherwise, and at the first build, the STANZA_WARPS warps of the stanza
// meet at their named barrier, each finds its bounds over the present
// codes (a minimum and a maximum are exact in any order), and each thread
// fills one code's entry. The caller synchronises before the tables are
// read.
static __device__ __forceinline__ void scan_tables(const ScanArgs& a,
                                                   ScanShared& sh,
                                                   ScanTables& t,
                                                   const uint2* won,
                                                   bool build) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < STANZA_WARPS * S_MAX) {
        const int s = warp / STANZA_WARPS, k = warp - s * STANZA_WARPS;
        const bool live = build && s < a.s_live;
        if (won && k == 0 && lane == 0) {
            // byte s of the codes (a byte permute: no shift kept live)
            const int c = __byte_perm(won->x, 0u, 0x4440u | s);
            const float old = sh.cnt[s * C_AXIS + c];
            const bool was = sh.pres[s * C_AXIS + c] != 0;
            const float now = old + 1.0f;
            sh.cnt[s * C_AXIS + c] = now;
            sh.pres[s * C_AXIS + c] = 1;
            if (live) {
                bool full = false;
                int nmin = t.nmin[s];
                if (!sh.hast[s]) {
                    if (!t.any[s] || now > t.mx[s]) full = true;
                    else if (was && old == t.mn[s]) {
                        if (nmin > 1) nmin -= 1;
                        else full = true;
                    } else if (!was && now <= t.mn[s]) {
                        if (now < t.mn[s]) full = true;
                        else nmin += 1;
                    }
                }
                t.full[s] = full;
                if (!full) {
                    t.nmin[s] = nmin;
                    t.sp[s][c] = spread_term_at(sh, s, c, t.mn[s], t.mx[s],
                                                t.any[s]);
                }
            }
        }
        if (!live) return;
        // the count (and the step's choice of rebuild) before the stanza's
        // warps read them
        named_sync(BAR_STANZA + s, 32 * STANZA_WARPS);
        if (won && !t.full[s]) return;
        float mn = 1e30f, mx = -1e30f;
        int any = 0;
        for (int c = lane; c < C_AXIS; c += 32) {
            const bool p = sh.pres[s * C_AXIS + c] != 0;
            const float v = sh.cnt[s * C_AXIS + c];
            mn = fminf(mn, p ? v : 1e30f);
            mx = fmaxf(mx, p ? v : -1e30f);
            any |= p ? 1 : 0;
        }
        for (int off = 16; off > 0; off >>= 1) {
            mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            any |= __shfl_xor_sync(0xffffffffu, any, off);
        }
        const int c = k * 32 + lane;
        if (c < C_AXIS) t.sp[s][c] = spread_term_at(sh, s, c, mn, mx, any);
        if (k == 0) {
            // the present codes at the minimum, for the next steps
            int at = 0;
            for (int x = lane; x < C_AXIS; x += 32)
                at += sh.pres[s * C_AXIS + x] != 0
                      && sh.cnt[s * C_AXIS + x] == mn;
            at = warp_sum(at);
            if (lane == 0) {
                t.mn[s] = mn;
                t.mx[s] = mx;
                t.any[s] = any;
                t.nmin[s] = at;
            }
        }
    } else if (warp < TABLE_WARPS) {
        // a count changes one code's entry only
        const int p = warp - STANZA_WARPS * S_MAX;
        const bool live = build && p < a.p_live;
        if (won) {
            if (lane == 0) {
                const int c = __byte_perm(won->y, 0u, 0x4440u | p);
                sh.dp[p * C_AXIS + c] += 1.0f;
                if (live) t.dp[p][c] = dp_admits(sh, p, c) ? 1 : 0;
            }
        } else if (live) {
            for (int c = lane; c < C_AXIS; c += 32)
                t.dp[p][c] = dp_admits(sh, p, c) ? 1 : 0;
        }
    }
}

// A sweep's per-thread best (score, slot) and that row's spread total.
struct ScanBest {
    float bv, bst;
    int bi;
};

__device__ __forceinline__ ScanBest no_best() {
    ScanBest b;
    b.bv = -INFINITY;
    b.bst = 0.0f;
    b.bi = INT_MAX;
    return b;
}

// A sweep's per-thread first-failing-dimension and ok counts, where a
// step reports them (step 0 and the first invalid step). Kept apart from
// ScanBest, so that the live rows' sweep carries no count.
struct ScanCounts {
    int okc;
    int cnt[D_MAX];
};

__device__ __forceinline__ ScanCounts no_counts() {
    ScanCounts c;
    c.okc = 0;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) c.cnt[dd] = 0;
    return c;
}

// A row's first-failing-dimension and ok counts (select.py:318-325).
__device__ __forceinline__ void sweep_count(ScanCounts& w, unsigned flags,
                                            bool feas, int d) {
    bool earlier = true;
#pragma unroll
    for (int dd = 0; dd < D_MAX; ++dd) {
        if (dd < d) {
            const bool f = (flags >> dd) & 1u;
            if (feas && earlier && !f) w.cnt[dd] += 1;
            earlier = earlier && f;
        }
    }
    if (feas && (flags & REC_FIT)) w.okc += 1;
}

// Step 0's sweep over the rows [lo, hi) (every row, or a shard's), thread
// t taking rows lo + t + m * NT, in two passes. The first finds the live
// rows (feasible, fitting and admitted by every distinct_property limit:
// those whose score is not NEG_INF) and gives them slots in row order, a
// round of NT rows at a time (a ballot a warp and the warps' counts in
// s_cnt, double-buffered, one barrier a round); masked[x] holds row x's
// slot (or -1) until the second pass, which writes every row's record
// (rec, codes; the two pow only for live rows), its masked score and its
// counts, and the live rows' slot records, with no barrier. The argmax is
// over slots. Returns the live rows' count in *nlive, in every thread.
static __device__ __forceinline__ ScanBest scan_sweep_build(
        const ScanArgs& a, const float* s_ask, const ScanRecs& r,
        const ScanTables& t, int (*s_cnt)[NWARPS], int* nlive,
        ScanCounts& cs, int lo, int hi) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int live = 0;
    for (int x0 = lo, round = 0; x0 < hi; x0 += NT, ++round) {
        const int x = x0 + threadIdx.x;
        bool ok = false;
        if (x < hi) {
            const ScanLocal l = scan_local_terms(a, s_ask, x);
            ok = l.feas && l.fit && scan_dp_ok(t, scan_codes(a, x).y);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        int* cnt = s_cnt[round & 1];
        if (lane == 0) cnt[warp] = __popc(bal);
        __syncthreads();
        const int i = live + warps_before(cnt)
                      + __popc(bal & ((1u << lane) - 1u));
        if (x < hi) a.masked[x] = __int_as_float(ok ? i : -1);
        live += warp_sum(cnt[lane]);
    }
    *nlive = live;

    ScanBest w = no_best();
    cs = no_counts();
    for (int x = lo + threadIdx.x; x < hi; x += NT) {
        const int i = __float_as_int(a.masked[x]);
        const uint2 cd = scan_codes(a, x);
        const ScanLocal l = scan_local(a, s_ask, x, true, i >= 0);
        const float4 rec = scan_rec(l);
        r.rec[x] = rec;
        r.codes[x] = cd;
        bool feas;
        float st;
        const float m = scan_compose(rec, cd, t, feas, st);
        sweep_count(cs, __float_as_uint(rec.w), feas, a.d);
        a.masked[x] = m;
        if (i >= 0) {
            *slot_rec(r, i) = scan_slot_rec(l);
            *slot_codes(r, i) = cd;
            r.lcomp[i] = make_float4(l.binpack, l.anti, l.pen, l.aff);
            r.lrow[i] = x;
            if (better(m, i, w.bv, w.bi)) { w.bv = m; w.bi = i; w.bst = st; }
        }
    }
    return w;
}

// A live slot's masked score from its slot record and codes (scan_compose's
// float operations in its order), with SL spread and PL distinct_property
// lookups, SL >= s_live and PL >= p_live: the tables past those add +0.0f
// and admit, so SL and PL need not be the request's own.
template <int SL, int PL>
__device__ __forceinline__ float scan_compose_slot(const float4& rec,
                                                   const uint2& cd,
                                                   const ScanTables& t,
                                                   float& st) {
    bool ok = rec.w > 0.0f;
#pragma unroll
    for (int p = 0; p < PL; ++p)
        ok = ok & (t.dp[p][(cd.y >> (8 * p)) & 255u] != 0);
    st = 0.0f;
#pragma unroll
    for (int s = 0; s < SL; ++s) st = st + t.sp[s][(cd.x >> (8 * s)) & 255u];
    const float sc = scan_score(rec.x, st, rec.y, rec.z, rec.w);
    return ok ? sc : NEG_INF;
}

// One live slot composed into the sweep's argmax.
template <int SL, int PL>
__device__ __forceinline__ void sweep_slot(ScanBest& w, const float4& rec,
                                           const uint2& cd,
                                           const ScanTables& t, int i) {
    float st;
    const float m = scan_compose_slot<SL, PL>(rec, cd, t, st);
    if (better(m, i, w.bv, w.bi)) {
        w.bv = m;
        w.bi = i;
        w.bst = st;
    }
}

// A later step's sweep over the live rows' slots but `skip` (the last
// winner's, rescored meanwhile by another warp), by the first NT - 32
// threads, thread t taking slots t + m * (NT - 32): those in shared memory,
// then the others from device memory. The argmax is over slots (slots
// ascend with rows, so ties go to the lower row). (Every slot read from
// device memory, through L2, took 18-60% longer a launch at the main
// shapes on an H100.)
#define SWEEPERS (NT - 32)
// the warp that runs a winner's update and rescoring: one that builds no
// table and sweeps no slot
#define WINNER_WARP (NWARPS - 1)
template <int SL, int PL>
static __device__ __forceinline__ ScanBest scan_sweep_live(
        const ScanRecs& r, const ScanTables& t, int nlive, int skip) {
    ScanBest w = no_best();
    const int ns = min(r.ns, nlive);
    for (int i = threadIdx.x; i < ns; i += SWEEPERS)
        if (i != skip) sweep_slot<SL, PL>(w, r.srec[i], r.scodes[i], t, i);
    for (int i = ns + threadIdx.x; i < nlive; i += SWEEPERS)
        if (i != skip)
            sweep_slot<SL, PL>(w, __ldcg(r.lrec + i), __ldcg(r.lcodes + i),
                               t, i);
    // the row of this thread's best into L1, where the winner's warp reads
    // it if the slot wins
    if (w.bi < nlive)
        asm volatile("prefetch.global.L1 [%0];" :: "l"(r.lrow + w.bi));
    return w;
}

// scan_sweep_live with as few lookups as the request's stanzas and
// constraints allow: 0, 1, 2 or S_MAX spread lookups, 0, 1 or P_MAX
// distinct_property ones. (The <S_MAX, P_MAX> sweep for every request
// took 7-16% longer a launch at the main shapes on an H100.)
static __device__ __forceinline__ ScanBest scan_sweep_live_for(
        const ScanArgs& a, const ScanRecs& r, const ScanTables& t,
        int nlive, int skip) {
    const int sl = a.s_live <= 2 ? a.s_live : S_MAX;
    const int pl = a.p_live <= 1 ? a.p_live : P_MAX;
    switch (sl * (P_MAX + 1) + pl) {
#define SCAN_LIVE_CASE(S, P) \
        case S * (P_MAX + 1) + P: return scan_sweep_live<S, P>(r, t, nlive, skip);
        SCAN_LIVE_CASE(0, 0) SCAN_LIVE_CASE(0, 1) SCAN_LIVE_CASE(0, P_MAX)
        SCAN_LIVE_CASE(1, 0) SCAN_LIVE_CASE(1, 1) SCAN_LIVE_CASE(1, P_MAX)
        SCAN_LIVE_CASE(2, 0) SCAN_LIVE_CASE(2, 1) SCAN_LIVE_CASE(2, P_MAX)
#undef SCAN_LIVE_CASE
        default:
            return sl == S_MAX && pl == 0 ? scan_sweep_live<S_MAX, 0>(r, t, nlive, skip)
                 : sl == S_MAX && pl == 1 ? scan_sweep_live<S_MAX, 1>(r, t, nlive, skip)
                 : scan_sweep_live<S_MAX, P_MAX>(r, t, nlive, skip);
    }
}

// The first invalid step's sweep over the records of the rows [lo, hi)
// (every row, or a shard's), thread t taking rows lo + t + m * NT: their
// masked scores and counts (no argmax: the step places nothing).
static __device__ __forceinline__ ScanCounts scan_sweep_meta(
        const ScanArgs& a, const ScanRecs& r, const ScanTables& t, int lo,
        int hi) {
    ScanCounts cs = no_counts();
    for (int x = lo + threadIdx.x; x < hi; x += NT) {
        const float4 rec = __ldcg(r.rec + x);
        const uint2 cd = __ldcg(r.codes + x);
        bool feas;
        float st;
        a.masked[x] = scan_compose(rec, cd, t, feas, st);
        sweep_count(cs, __float_as_uint(rec.w), feas, a.d);
    }
    return cs;
}

// One warp, every lane: the last valid step's winner (slot i, step
// `step`). Lane dd < d takes the row's dimension dd: its used updated
// (select.py:337-345) and stored, and its fit to one more instance; every
// lane loads the row's other state, and lane 0 writes the winner's
// component outputs from its slot (the state before the update) and the
// other carries' update. The record is rescored from the updated values,
// the two powers on lanes 0 and 1 at once, and lane 0 writes it. Returns
// the new slot record. The step's choice is the row; the owner of the slot
// wrote final_ and spread when the step found it.
static __device__ __forceinline__ float4 scan_winner(const ScanArgs& a,
                                                     const ScanOut& o,
                                                     const ScanRecs& r,
                                                     const float* s_ask,
                                                     int i, int step) {
    const int lane = threadIdx.x & 31;
    const int c = r.lrow[i];   // in L1 (scan_sweep_live)
    const bool dim = lane < a.d;
    float u = 0.0f, cap = 0.0f;
    if (dim) {
        u = a.used[c * a.d + lane];
        cap = a.capacity[c * a.d + lane];
    }
    ScanRow v;
    row_scalars(v, a, c);
    const float4 rc = i < r.ns ? r.srec[i] : __ldcg(r.lrec + i);
    const float4 cp = __ldcg(r.lcomp + i);
    u = u + s_ask[lane < D_MAX ? lane : 0];
    if (dim) a.used[c * a.d + lane] = u;
    const float af = u + s_ask[lane < D_MAX ? lane : 0];
    v.fit_bits = __ballot_sync(0xffffffffu, dim && af <= cap + 1e-6f);
    v.fit = v.fit_bits == (1u << a.d) - 1u;
    v.after0 = __shfl_sync(0xffffffffu, af, 0);
    v.after1 = __shfl_sync(0xffffffffu, af, 1);
    v.cap0 = __shfl_sync(0xffffffffu, cap, 0);
    v.cap1 = __shfl_sync(0xffffffffu, cap, 1);
    v.tg_coll += 1;
    v.job_cnt += 1;
    v.scan_placed += 1;
    v.free_p = v.free_p + (-1.0f * a.port_need);
    v.dev_slots = v.dev_slots + (-1.0f);
    if (lane == 0) {
        o.choice[step] = c;
        o.binpack[step] = cp.x;
        o.anti[step] = cp.y;
        o.pen[step] = cp.z;
        o.aff[step] = cp.w;
        o.dev[step] = rc.y;
        o.pre[step] = rc.z;
        a.tg_coll[c] = v.tg_coll;
        a.job_cnt[c] = v.job_cnt;
        a.scan_placed[c] = v.scan_placed;
        a.free_p[c] = v.free_p;
        a.dev_slots[c] = v.dev_slots;
    }
    ScanLocal l = scan_local_of(a, v);
    const float pw = pow10_exact(lane == 1 ? l.free_mem : l.free_cpu);
    scan_local_fit(a, l, __shfl_sync(0xffffffffu, pw, 0)
                             + __shfl_sync(0xffffffffu, pw, 1));
    const float4 sr = scan_slot_rec(l);
    if (lane == 0) {
        r.rec[c] = scan_rec(l);
        *slot_rec(r, i) = sr;
        r.lcomp[i] = make_float4(l.binpack, l.anti, l.pen, l.aff);
    }
    return sr;
}

// Host side of the scan kernels' records (select_kernels.cu, and the
// sharded scan in sharded_kernels.cu).
// The live slots whose records and codes `smem` bytes of shared memory hold.
static inline int scan_slots(int smem) {
    return smem / (int)(sizeof(float4) + sizeof(uint2));
}

// The records of `lanes` lanes in one scratch buffer of 17 floats a row a
// lane (kernels.py, _scan_records): the 16-byte arrays first, n a lane
// each, then the 8-byte ones, then lrow; and the slots that the dynamic
// shared memory of `smem` bytes holds.
static inline ScanRecs scan_recs(void* buf, int lanes, int n, int smem) {
    ScanRecs r;
    const size_t m = (size_t)lanes * n;
    r.rec = (float4*)buf;
    r.lrec = r.rec + m;
    r.lcomp = r.lrec + m;
    r.codes = (uint2*)(r.lcomp + m);
    r.lcodes = r.codes + m;
    r.lrow = (int*)(r.lcodes + m);
    r.srec = nullptr;
    r.scodes = nullptr;
    r.ns = scan_slots(smem);
    return r;
}

// The dynamic shared memory a scan kernel launches with: all that a block
// may have beside its static shared memory (set once a kernel; the same
// value for every caller).
static inline int scan_smem(const void* kernel) {
    cudaFuncAttributes fa;
    int dev = 0, optin = 0;
    if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess
            || cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(
                   &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
                   != cudaSuccess)
        return -1;
    const int bytes = optin - (int)fa.sharedSizeBytes;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
        return -1;
    return bytes;
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
    int* rem;      // [1]: remaining
    int* steps;    // [1]: steps run
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

__device__ __forceinline__ LocalCarry carry_lane(LocalCarry c,
                                                const LocalArgs& a, int b) {
    const size_t n = a.n, nd = (size_t)a.n * a.d;
    c.used += b * nd;
    c.coll += b * n;
    c.free_p += b * n;
    c.dev_slots += b * n;
    return c;
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
    o.rem += b;
    o.steps += b;
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

__device__ __forceinline__ ScanRecs scan_recs_lane(ScanRecs r, int b,
                                                   const ScanArgs& a) {
    const size_t n = a.n;
    r.rec += b * n;
    r.codes += b * n;
    r.lrec += b * n;
    r.lcodes += b * n;
    r.lcomp += b * n;
    r.lrow += b * n;
    return r;
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

// ---------------------------------------------------------------------------
// The chunked step (PR 12's body, select_kernels.cu chunked_body): a kept
// top-m list of masked, and one warp that runs step after step from it.
// The single-card kernels keep one list over the whole table; the
// node-sharded kernels (sharded_kernels.cu) one a shard, whose owner runs
// the steps its rows win.
// ---------------------------------------------------------------------------
#define CHUNK_M 256    // the kept list's most entries (at most TOPK_CAND)

// What the step warp's block does next, as the warp hands it over.
#define CHUNK_END 0
#define CHUNK_SWEEP 1     // sweep masked for a step's counts, then a list
                          // (sharded: the lane's top is invalid)
#define CHUNK_REBUILD 2   // the list again from masked
#define CHUNK_HANDOFF 3   // sharded: another shard's head is the best

// The step warp's state: the list's first entry and length (its entries
// at lv[h], ..., lv[h + len - 1]), the next step, the count left, and
// whether the last step was valid.
struct ChunkState {
    int h, len, step, remaining;
    bool alive;
};

// The kept list after its first entry, row c, was rescored to sv (one
// warp, every lane): c put back where (sv, c) ranks, the entries ranked
// above it moved one place up, or dropped when it ranks below the last
// entry (unless the list holds every row, `whole`).
__device__ __forceinline__ void chunk_list_update(float* lv, int* li,
                                                  ChunkState& s, float sv,
                                                  int c, bool whole) {
    const int lane = threadIdx.x & 31;
    const int last = s.h + s.len - 1;
    if (!whole && !better(sv, c, lv[last], li[last])) {
        s.h += 1;
        s.len -= 1;
        return;
    }
    // r: the entries after the first that rank above (sv, c), a prefix
    int r = 0;
    for (int k0 = 1; k0 < s.len; k0 += 32) {
        const int k = k0 + lane;
        const unsigned above = __ballot_sync(
            0xffffffffu, k < s.len && better(lv[s.h + k], li[s.h + k], sv, c));
        r += __popc(above);
        if (above != 0xffffffffu) break;
    }
    for (int k0 = 0; k0 < r; k0 += 32) {
        const int k = k0 + lane;
        float v = 0.0f;
        int i = 0;
        if (k < r) {
            v = lv[s.h + 1 + k];
            i = li[s.h + 1 + k];
        }
        __syncwarp();
        if (k < r) {
            lv[s.h + k] = v;
            li[s.h + k] = i;
        }
    }
    __syncwarp();
    if (lane == 0) {
        lv[s.h + r] = sv;
        li[s.h + r] = c;
    }
}

// Row c as the step warp holds it: lane dd < d its dimension dd's used
// and capacity (0 past d), every lane the row's other columns.
struct ChunkRow {
    float used, cap, free_p, dev_slots, aff, dev_score, pre;
    int coll;
    bool feasible, port_ok, pen;
};

__device__ __forceinline__ ChunkRow chunk_row(const LocalArgs& a, int c) {
    const int lane = threadIdx.x & 31;
    ChunkRow r;
    r.used = lane < a.d ? a.used[c * a.d + lane] : 0.0f;
    r.cap = lane < a.d ? a.capacity[c * a.d + lane] : 0.0f;
    r.free_p = a.free_p[c];
    r.dev_slots = a.dev_slots[c];
    r.aff = a.affinity[c];
    r.dev_score = a.dev_score[c];
    r.pre = a.pre_score[c];
    r.coll = a.coll[c];
    r.feasible = a.feasible[c] != 0;
    r.port_ok = a.port_ok[c] != 0;
    r.pen = a.penalty[c] != 0;
    return r;
}

// The step warp, every lane: steps from s.step on, each from the list's
// first two entries, until the loop ends, the list is short or a step is
// invalid without its counts (`meta`: the block swept at this step, and
// wrote its counts and top-5). A step loads the winner's row once into the
// warp (chunk_row) and computes from it, with the shared pieces of
// fit_cap, sub_score, place and local_row in their operation order: a_max
// by one dimension a lane; the stream CHUNK_ROUND sub-placements a round,
// the two powers of one on a lane pair; the placed row's new masked score
// as local_row gives it, its two powers on lanes 0 and 1. Returns what the
// block does next. SH (the node-sharded kernels): the list is the shard's,
// and (ov, oi) the best head of the lane's other shards, which no step of
// this shard changes; the warp hands off once that head ranks above its
// own, and takes the runner-up as the better of its second entry and that
// head (both exact: each list is the exact top of its shard's rows).
#define CHUNK_ROUND 16
template <bool SH>
__device__ __forceinline__ int chunked_steps(const LocalArgs& a,
                                             const ChunkedOut& o,
                                             const float* s_ask, float* lv,
                                             int* li, ChunkState& s,
                                             bool whole, bool meta,
                                             float ov = -INFINITY,
                                             int oi = INT_MAX) {
    const int lane = threadIdx.x & 31, half = lane & 1;
    const bool dim = lane < a.d;
    const float ask = s_ask[dim ? lane : 0];
    for (;; meta = false) {
        if (!(s.remaining > 0 && s.alive && s.step < a.max_steps))
            return CHUNK_END;
        if constexpr (SH) {
            if (s.len > 0 && !better(lv[s.h], li[s.h], ov, oi))
                return CHUNK_HANDOFF;
        }
        if (s.len < 2) return CHUNK_REBUILD;
        const float tv = lv[s.h];
        const int c = li[s.h];
        float rv = lv[s.h + 1];
        int ri = li[s.h + 1];
        if constexpr (SH) {
            if (!better(rv, ri, ov, oi)) {
                rv = ov;
                ri = oi;
            }
        }
        if (!(tv > HALF_NEG_INF)) {
            if (!meta) return CHUNK_SWEEP;
            // no feasible row: chunk 0, choice -1 as initialised
            s.step += 1;
            s.alive = false;
            continue;
        }
        if (!meta) {
            if (dim) o.exh[s.step * a.d + lane] = -1;
            if (lane == 0) o.feas[s.step] = -1;
        }
        const ChunkRow r = chunk_row(a, c);
        float m_fit = dim ? fit_dim(r.cap, r.used, ask) : INFINITY;
        for (int off = 16; off > 0; off >>= 1)
            m_fit = fminf(m_fit, __shfl_xor_sync(0xffffffffu, m_fit, off));
        const float a_max = fminf(fit_rest(m_fit, r.free_p, a.port_need,
                                           r.dev_slots),
                                  (float)s.remaining);
        // the chunk: the winner's stream against the runner-up, walked up
        // to its first loser or past a_max (every chunk is capped there);
        // lanes 2k and 2k + 1 hold sub-placement j0 + k's cpu and mem
        const float u_h = __shfl_sync(0xffffffffu, r.used, half);
        const float cap_h = fmaxf(__shfl_sync(0xffffffffu, r.cap, half),
                                  1e-9f);
        const float ask_h = s_ask[half];
        int f = CHUNK_J;
        for (int j0 = 0; j0 < CHUNK_J; j0 += CHUNK_ROUND) {
            if (!((float)j0 < a_max)) {
                f = j0;
                break;
            }
            const float jf = (float)(j0 + (lane >> 1));
            const float p = free_pow(sub_after(u_h, jf, ask_h), cap_h);
            const float q = __shfl_xor_sync(0xffffffffu, p, 1);
            const float fj = local_score_of(
                half ? q + p : p + q, (float)r.coll + jf, r.pen, r.aff,
                a.desired, a.spread_alg, r.dev_score, a.dev_fires, r.pre);
            const unsigned lose = __ballot_sync(
                0xffffffffu, !(fj > rv || (fj == rv && c < ri)))
                & 0x55555555u;
            if (lose) {
                f = j0 + ((__ffs(lose) - 1) >> 1);
                break;
            }
        }
        const float chunk = fminf(fmaxf((float)f, 1.0f), a_max);
        const int chunk_i = (int)chunk;
        // place, then the row's masked score as local_row gives it
        const float used = placed_used(r.used, chunk, ask);
        const float free_p = placed_ports(r.free_p, chunk, a.port_need);
        const float dev_slots = placed_slots(r.dev_slots, chunk);
        const int coll = r.coll + chunk_i;
        if (dim) a.used[c * a.d + lane] = used;
        const float after = used + ask;
        const unsigned fits = __ballot_sync(0xffffffffu,
                                            dim && dim_fits(after, r.cap));
        float sv = NEG_INF;
        if (row_feasible(r.feasible, free_p, a.port_need, r.port_ok,
                         dev_slots) && fits == (1u << a.d) - 1u) {
            const float p = free_pow(after, fmaxf(r.cap, 1e-9f));
            sv = local_score_of(
                __shfl_sync(0xffffffffu, p, 0)
                    + __shfl_sync(0xffffffffu, p, 1),
                (float)coll, r.pen, r.aff, a.desired, a.spread_alg,
                r.dev_score, a.dev_fires, r.pre);
        }
        if (lane == 0) {
            a.coll[c] = coll;
            a.free_p[c] = free_p;
            a.dev_slots[c] = dev_slots;
            a.masked[c] = sv;
            o.choice[s.step] = c;
            o.chunk[s.step] = chunk_i;
        }
        chunk_list_update(lv, li, s, sv, c, whole);
        // the list, the row's carries and masked before the next step
        __syncwarp();
        s.remaining -= chunk_i;
        s.step += 1;
    }
}
