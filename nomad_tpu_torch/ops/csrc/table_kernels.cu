// Hand-written Hopper (sm_90a) kernels for the resident node table: the row
// scatters that keep the node table and the parked feasibility masks on the
// card across evals. Each replaces one jax.jit program of the JAX package
// (nomad_tpu/ops/device_table.py):
//
//   scatter_set_kernel   <- _scatter_set  (device_table.py:614)
//   overlay_add_kernel   <- _overlay_add  (device_table.py:623)
//   feas_scatter_kernel  <- _feas_scatter (device_table.py:631)
//
// Semantics are JAX's `.at[idx].set / .add`, out of place: the resident
// column itself is never written, because a dispatch, a continuation launch
// or a parked mask's token may still be reading it.
//
// What bounds them on an H100: bytes, and at the main path's sizes (a
// 256 KB used column, a 64 KB port column, a 16 KB mask, m of 10 to 4,096
// rows) the bound is well under a microsecond, so a call costs its launch
// and the host work around it.
//
// All three are fused copy-and-patch kernels: ONE launch writes the whole
// output (both columns, for scatter_set) exactly once, so no separate copy
// runs first. Each block owns a contiguous tile of rows. Every thread
// loads its input element into registers and clears its share of a slot
// map in shared memory while the first warp finds the tile's slice
// [lo, hi) of the sorted patch rows (two warp-wide searches over idx
// walked together, 32 probes each a round). After a barrier the block
// fills the map, slot[r - r0] = k for patch row k (-1 elsewhere), and
// after a second each thread adds (overlay_add) or sets (scatter_set,
// feas_scatter) the patch value where slot >= 0 and writes its output
// once. The fill is shared by the block, not left to the first warp: a
// 4,096-row mask tile may hold thousands of patch rows. Nothing is
// ordered across blocks and no atomics are needed: the wrapper proves on
// the host that the rows are in range and distinct, and sorts them when
// they are not increasing (scatter_set's rows may repeat, as
// `.at[idx].set` allows: the wrapper keeps each repeated row's last
// value, as a sequential index_copy_ does). `order` (may be null) maps a
// sorted position to the row of `vals`, for values that are already on
// the card and were not sorted with the rows. The wrapper ships the rows
// (and host-side values) in one asynchronous upload of a pinned buffer.
//
// Vector paths: at D = 4 a used row is one 16-byte float4 (one row a
// thread, with its port for scatter_set); a mask is written 16 bytes
// (uint4) a thread, its ragged tail byte by byte. Each is taken only when
// the input and output pointers are 16-byte aligned (and, for overlay_add
// and scatter_set, D = 4); otherwise a scalar path walks the tile element
// by element.
//
// overlay_add adds in IEEE float32 and nothing else (__fadd_rn; no FMA is
// possible in a single add), so the result is bit-identical to the host's
// base_used + plan_delta.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
// overlay_add: one row a thread on the vector path
#define OVERLAY_TILE THREADS
// feas_scatter: 16 bytes a thread on the vector path
#define FEAS_TILE (THREADS * 16)

// The tile's slice [lo, hi) of the sorted rows: lo the first k with
// idx[k] >= r0 (m when none), hi the first with idx[k] >= r1. Called by a
// whole warp, which walks both searches together, 32 probes a search a
// round, so their loads overlap: about log32(m) + 1 rounds of one
// dependent load each. Every lane returns the same values.
static __device__ void warp_tile_bounds(const int* __restrict__ idx, int m,
                                        int r0, int r1, int& lo, int& hi) {
    const int lane = threadIdx.x & 31;
    // the answers lie in [a0, a1] and [b0, b1]: idx[< a0] < r0,
    // idx[>= a1] >= r0, and likewise for r1
    int a0 = 0, a1 = m, b0 = 0, b1 = m;
    while (a0 < a1 || b0 < b1) {
        // a search within 32 rows probes one row a lane and ends
        const int sa = max(1, (a1 - a0 + 31) / 32);
        const int sb = max(1, (b1 - b0 + 31) / 32);
        const int pa = a0 + (lane + 1) * sa - 1;
        const int pb = b0 + (lane + 1) * sb - 1;
        const bool la = pa < a1 && idx[pa] < r0;
        const bool lb = pb < b1 && idx[pb] < r1;
        // the probes below the key are a prefix (idx is sorted)
        const int ca = __popc(__ballot_sync(0xffffffffu, la));
        const int cb = __popc(__ballot_sync(0xffffffffu, lb));
        a1 = min(a1, a0 + (ca + 1) * sa - 1);
        a0 += ca * sa;
        b1 = min(b1, b0 + (cb + 1) * sb - 1);
        b0 += cb * sb;
    }
    lo = a0;
    hi = b0;
}

// The slot map of the tile [r0, r0 + rows), filled by the whole block:
// slot[i] = k where idx[k] is r0 + i, else -1. Every thread clears its
// share while the first warp finds the tile's slice of idx; after a
// barrier every thread writes its share of the slice, and after a second
// the map is read.
static __device__ void tile_slots(const int* __restrict__ idx, int m,
                                  int r0, int rows, int* slot, int* bounds) {
    for (int i = threadIdx.x; i < rows; i += THREADS) slot[i] = -1;
    if (threadIdx.x < 32) {
        int lo, hi;
        warp_tile_bounds(idx, m, r0, r0 + rows, lo, hi);
        if (threadIdx.x == 0) {
            bounds[0] = lo;
            bounds[1] = hi;
        }
    }
    __syncthreads();
    for (int k = bounds[0] + threadIdx.x; k < bounds[1]; k += THREADS)
        slot[idx[k] - r0] = k;
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
overlay_add_kernel(const float* __restrict__ used, float* __restrict__ out,
                   const int* __restrict__ idx,
                   const float* __restrict__ vals,
                   const int* __restrict__ order, int n, int m, int d,
                   int vec) {
    __shared__ int slot[OVERLAY_TILE];
    __shared__ int bounds[2];
    const int r0 = blockIdx.x * OVERLAY_TILE;
    const int rows = min(OVERLAY_TILE, n - r0);
    const int t = threadIdx.x;
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vec && t < rows)
        row = reinterpret_cast<const float4*>(used)[r0 + t];
    tile_slots(idx, m, r0, rows, slot, bounds);
    if (vec) {
        if (t >= rows) return;
        const int k = slot[t];
        if (k >= 0) {
            const float* v = vals + (long long)(order ? order[k] : k) * 4;
            row.x = __fadd_rn(row.x, v[0]);
            row.y = __fadd_rn(row.y, v[1]);
            row.z = __fadd_rn(row.z, v[2]);
            row.w = __fadd_rn(row.w, v[3]);
        }
        reinterpret_cast<float4*>(out)[r0 + t] = row;
        return;
    }
    const long long base = (long long)r0 * d;
    for (int e = t; e < rows * d; e += THREADS) {
        const int r = e / d;
        const int k = slot[r];
        float x = used[base + e];
        if (k >= 0)
            x = __fadd_rn(
                x, vals[(long long)(order ? order[k] : k) * d + (e - r * d)]);
        out[base + e] = x;
    }
}

// `vals` and `pvals` each have their own order (null when the values were
// packed in the rows' sorted order).
__global__ void __launch_bounds__(THREADS)
scatter_set_kernel(const float* __restrict__ used,
                   const float* __restrict__ ports, float* __restrict__ out,
                   float* __restrict__ out_ports, const int* __restrict__ idx,
                   const float* __restrict__ vals,
                   const int* __restrict__ order,
                   const float* __restrict__ pvals,
                   const int* __restrict__ porder, int n, int m, int d,
                   int vec) {
    __shared__ int slot[OVERLAY_TILE];
    __shared__ int bounds[2];
    const int r0 = blockIdx.x * OVERLAY_TILE;
    const int rows = min(OVERLAY_TILE, n - r0);
    const int t = threadIdx.x;
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    float port = 0.f;
    if (t < rows) {
        port = ports[r0 + t];
        if (vec) row = reinterpret_cast<const float4*>(used)[r0 + t];
    }
    tile_slots(idx, m, r0, rows, slot, bounds);
    if (t < rows) {
        const int k = slot[t];
        if (k >= 0) port = pvals[porder ? porder[k] : k];
        out_ports[r0 + t] = port;
        if (vec) {
            if (k >= 0) {
                const float* v = vals + (long long)(order ? order[k] : k) * 4;
                row = make_float4(v[0], v[1], v[2], v[3]);
            }
            reinterpret_cast<float4*>(out)[r0 + t] = row;
        }
    }
    if (vec) return;
    const long long base = (long long)r0 * d;
    for (int e = t; e < rows * d; e += THREADS) {
        const int r = e / d;
        const int k = slot[r];
        out[base + e] = k >= 0
            ? vals[(long long)(order ? order[k] : k) * d + (e - r * d)]
            : used[base + e];
    }
}

__global__ void __launch_bounds__(THREADS)
feas_scatter_kernel(const uint8_t* __restrict__ mask,
                    uint8_t* __restrict__ out,
                    const int* __restrict__ idx,
                    const uint8_t* __restrict__ vals,
                    const int* __restrict__ order, int n, int m, int vec) {
    __shared__ int slot[FEAS_TILE];
    __shared__ int bounds[2];
    const int r0 = blockIdx.x * FEAS_TILE;
    const int rows = min(FEAS_TILE, n - r0);
    const int b0 = threadIdx.x * 16;   // this thread's bytes on the vector path
    const bool whole = vec && b0 + 16 <= rows;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (whole) w = *reinterpret_cast<const uint4*>(mask + r0 + b0);
    tile_slots(idx, m, r0, rows, slot, bounds);
    if (whole) {
        uint8_t* bytes = reinterpret_cast<uint8_t*>(&w);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int k = slot[b0 + j];
            if (k >= 0) bytes[j] = vals[order ? order[k] : k];
        }
        *reinterpret_cast<uint4*>(out + r0 + b0) = w;
        return;
    }
    // the ragged tail of the vector path, or the whole tile of the scalar one
    const int from = vec ? b0 : threadIdx.x;
    const int to = vec ? min(rows, b0 + 16) : rows;
    const int stride = vec ? 1 : THREADS;
    for (int i = from; i < to; i += stride) {
        const int k = slot[i];
        out[r0 + i] = k >= 0 ? vals[order ? order[k] : k] : mask[r0 + i];
    }
}

static unsigned blocks_for(long long elems, int per_block) {
    return (unsigned)((elems + per_block - 1) / per_block);
}

static bool aligned16(const void* a, const void* b) {
    return (((uintptr_t)a | (uintptr_t)b) & 15u) == 0;
}

extern "C" int nomad_scatter_set(const float* used, const float* ports,
                                 float* out, float* out_ports,
                                 const int* idx, const float* vals,
                                 const int* order, const float* pvals,
                                 const int* porder, int n, int m, int d,
                                 void* stream) {
    if (n < 1 || m < 1 || d < 1) return (int)cudaErrorInvalidValue;
    const int vec = d == 4 && aligned16(used, out);
    scatter_set_kernel<<<blocks_for(n, OVERLAY_TILE), THREADS, 0,
                         (cudaStream_t)stream>>>(used, ports, out, out_ports,
                                                 idx, vals, order, pvals,
                                                 porder, n, m, d, vec);
    return (int)cudaGetLastError();
}

extern "C" int nomad_overlay_add(const float* used, float* out,
                                 const int* idx, const float* vals,
                                 const int* order, int n, int m, int d,
                                 void* stream) {
    if (n < 1 || m < 1 || d < 1) return (int)cudaErrorInvalidValue;
    const int vec = d == 4 && aligned16(used, out);
    overlay_add_kernel<<<blocks_for(n, OVERLAY_TILE), THREADS, 0,
                         (cudaStream_t)stream>>>(used, out, idx, vals, order,
                                                 n, m, d, vec);
    return (int)cudaGetLastError();
}

extern "C" int nomad_feas_scatter(const uint8_t* mask, uint8_t* out,
                                  const int* idx, const uint8_t* vals,
                                  const int* order, int n, int m,
                                  void* stream) {
    if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
    const int vec = aligned16(mask, out);
    feas_scatter_kernel<<<blocks_for(n, FEAS_TILE), THREADS, 0,
                          (cudaStream_t)stream>>>(mask, out, idx, vals, order,
                                                  n, m, vec);
    return (int)cudaGetLastError();
}
