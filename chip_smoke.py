"""Chip smoke test of the PyTorch + CUDA port (nomad_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
  1. the card's name and power limit; the kernels' build (set-up);
  2. each kernel against its plain PyTorch version on the card, on seeded
     requests at the main path's shapes (and two more K-way shapes):
     identical choices, chunks, top-k indices and carries, scores within
     1e-6 absolute, for every launch of SelectKernel's chunked and K-way
     loops, each continuing from the carry the previous launch left on the
     card; CUDA-event times of the first launch (and per step or K-way
     phase) and of the plain version (median of 7 after a warm-up), and
     the bound of each from the real node count and the work this run's
     outputs need (greedy_ops: one sweep a launch, the rows placed on
     rescored, the instances placed); the chunked kernel bit for bit (max
     abs error 0), then at its edge shapes (CHUNKED_EDGES of
     nomad_tpu_torch.mock.chunked_edges: all-alike rows at count 512, whose
     spread winners drop out of the kept list, timed; a first step with no
     feasible row; a request that runs dry; two feasible rows; fewer than 5
     rows; a chunk of CHUNK_J; a tie with the runner-up won and lost),
     binpack and spread, every launch and a continuation from the card's
     carry bit for bit; then the K-way kernel at its edge shapes
     (KWAY_EDGES: n = w + 1, 50 feasible rows of 10,000, exactly w + 1,
     all-alike nodes at 10,000 and 1,000 rows, an invalid first phase, a
     lane that runs dry),
     binpack and spread, each with an 8-phase budget so that its launches
     continue from the card's carry, every launch bit for bit; the scan
     held bit for bit at its main shape, its bound counted from the work
     its outputs need (scan_ops; a sweep of every row at every step
     printed beside it), and the scan kernels at their edge shapes
     (SCAN_EDGES of nomad_tpu_torch.mock.scan_edges: a tie storm, n not a
     multiple of 1024, one feasible row, none, k_valid 1, a count above
     1024, requests that run dry, every stanza with empty histograms,
     16,384 rows all live: more than the kernels keep in shared memory,
     which fails unless it is so), binpack and spread,
     solo and as two lanes over one table, and ten batched lanes of counts
     16-61 (one with no feasible row) at 10,000 nodes, every launch bit for
     bit against its plain version and each batched lane against the solo
     kernel;
  3. the resident table's three row scatters (scatter_set, overlay_add,
     feas_scatter, each one fused copy-and-patch launch) against their
     plain versions and the library call
     (index_copy / index_add) on the card at the main path's table (n_pad
     16,384, D 4) with m = 10, 200 and 4,096 rows, the row values on the
     card and on the host: exactly equal, one launch a call, inputs left
     unchanged (the scatters are out of place); CUDA-event medians of 51
     after a warm-up for the wrapper (values on the card, and on the
     host), the plain version, the library call given idx on the card and
     given it on the host as the wrappers are, and (kernel_ms) the launch
     alone on inputs already on the card, timed as 20 launches replayed
     from one CUDA graph; then overlay_add and feas_scatter at the fused
     kernels' edge shapes (one row, every tile's first and last row, an
     n_pad of 10,001, every row, and columns 4 bytes off 16-byte
     alignment with rows out of order), scatter_set at its own (the same
     and rows out of order, repeated rows), and the three wrappers once
     under torch.cuda.set_sync_debug_mode("error");
  4. the main path: the port's Harness(device=None), which is the card,
     with 10,000 mock nodes runs a service job (chunked kernel), a
     count-10,000 batch job (K-way kernel) and a spread + affinity job
     (scan kernel); every alloc placed,
     each kernel launched, placements identical to Harness(device="cpu");
  5. the steady state over the resident node table: a second Harness on
     the card over the same nodes runs E1-E8 (a service job; a spread +
     affinity job; a job with two task groups; a destructive update of the
     first job; a node meta change and a job with the first job's
     feasibility key; a CSI volume that leaves out a third of the nodes
     and three jobs that claim it) and the same sequence on
     Harness(device="cpu"). Every alloc placed, placements identical, each
     scatter kernel launched, every dispatch after E1 served by the mirror
     (no fallback), the CSI jobs' feasibility tokens kept through their
     residue, and at the end the mirror equal to the host table row for
     row;
  6. the batched kernels (chunked-, K-way- and scan-batched: B lanes over
     one shared capacity table, one block a lane) at 10,000 nodes with
     lanes from different seeds: every lane held exactly (max abs error 0)
     against the batched plain version and against the solo kernel run on
     that lane's request, and with an 8-phase budget every K-way lane
     continued on the solo kernel from the batched launch's carry;
     CUDA-event medians of the batched launch (and per step of its
     longest lane), of B solo launches one after another and of the plain
     version, and the bound summed over the lanes; K-way lanes of mixed
     counts (10 / 2,500 / 10,000 / a lane with no feasible row) among
     them, and eight chunked lanes of counts 1-512 (CHUNKED_LANES: one that
     runs dry, one with no feasible row), binpack and spread;
  7. the eval gateways: on one snapshot of the 10,000 nodes, three groups
     of concurrent lane evals through a BatchGateway (8 service jobs of
     count 10, chunked-batched; 4 spread jobs of count 200, scan-batched;
     4 batch jobs of count 2,500, K-way-batched) and 8 more service jobs
     through a MicroBatchGateway after calibrate_cost_model, on the card
     and with device="cpu": every alloc placed, placements identical, each
     batched kernel launched, every gateway fire serving its lanes; the
     groups' walls, lanes per dispatch, the measured round trip and the
     windows it gives, and the cost model's per-lane costs;
  8. the node-sharded (mesh) path: the sharded scan and K-way kernels at
     the main path's shapes (10,000 nodes; the spread eval's scan request,
     count 200, and the batch eval's K-way request, count 10,000) with 8
     shards (the scan's cluster kernel, a thread-block cluster a lane),
     and the scan with 32 (its grid kernel, one cooperative launch), held
     exactly against their plain versions (every launch of the K-way
     loop, continuing from the card's carry) and against the solo kernel
     on the same padded request; then 2, 32 (the scan: 2, 16, 32) and the
     most shards the card holds at once, each held exactly against the
     8-shard result and timed (CUDA-event medians of 7; us a step or K-way
     phase, the scan's steps run, its route, the live slots a shard keeps
     in shared memory and the clusters the card holds at once), beside
     the solo kernel on the same padded request and the plain version;
     then the sharded K-way kernel at the edge shapes of phase 2 and at
     mixed batched lanes (one with no feasible row, one that runs dry) at
     2, 8, 32 and the most shards, each call with an 8-phase budget
     continued from the card's carry, and the sharded scan at SCAN_EDGES
     and at mixed batched lanes (MIXED_LANES and a lane that runs dry, at
     10,000 nodes) at 1, 2, 8, 16, 32 and the most shards (both routes;
     at 1 shard the 16,384-row all-live case outgrows a shard's shared
     memory, which fails unless it is so), every launch held bit for bit
     against its plain version and the single-card kernel on the same
     padded table. Then set_mesh(make_mesh(8)), and set_mesh(make_mesh(32)),
     and the three main-path evals through the card's Harness: placements
     identical to the single-card run's, the sharded kernels of the
     mesh's route launched (the scan's cluster kernel at 8, its grid
     kernel at 32) and no single-card placement kernel; and E1-E4 of the
     steady state on a fresh store over a fresh mesh of 8: one upload of
     the mesh table, every dispatch after E1 served by it, placements
     identical to the single-card run's, and the mesh table equal to the
     host table row for row;
  9. the mesh's gateways: the batched node-sharded kernels (chunked-,
     scan- and K-way-batched over B lanes of S shards, B * S blocks) at
     10,000 nodes and the main shapes of phase 6, with 8 shards (and the
     chunked and scan grid kernels at 32), then 2, 32 (the scan and the
     chunked kernels: 2, 16, 32) and the most the card holds (32 shards
     of 8 lanes exceed the card, so the lanes of a cooperative kernel
     launch in groups; the cluster kernels take every lane in one launch):
     every launch held exactly against its plain version and against the
     single-card batched kernel on the same padded lanes, and with an
     8-phase budget every K-way lane continued on the single-card solo
     kernel from the batched carry; CUDA-event medians of the kernel (and
     us a step or phase of the longest lane), the single-card batched
     kernel and the plain version, and the bound as phase 6 counts it; for
     the chunked kernels also the device time of a CUDA-graph replay
     beside the single card's and the handoffs a lane, B 8 lanes of count
     512 and the all-alike table (one lane of count 512, binpack and
     spread) at 8 shards, and CHUNKED_EDGES (one lane each, binpack and
     spread) and CHUNKED_LANES (an 8-step budget) at 2, 8, 16, 32 and the
     most shards, every launch and a continuation from the card's carry
     bit for bit against the plain version and the single-card batched
     kernel. Then phase 7's gateway groups under set_mesh(make_mesh(8)) on
     a fresh store, and its chunked and spread groups under
     set_mesh(make_mesh(32)): placements identical to the single-card
     groups', each batched sharded kernel of the mesh's route launched
     and no single-card batched kernel.
 10. the cold start: the main path's store after its three evals is dumped
     (StateStore.dump_columnar, packed with msgpack), restored into a
     fresh store (StateStore.restore), primed from its decoded alloc
     columns (NodeTableCache.prime(snapshot, pop_cold_columns())) and its
     device mirror uploaded to the card on a thread
     (NodeTableCache.prefetch_device, PrefetchThread) before the first
     eval; then the main path's three jobs again (new ids) and E1-E4 on
     the restored store and on the store that was never dumped, and the
     same pipeline with device="cpu": every alloc placed, placements
     identical, no full table build on the restored store, the prefetch's
     the mirror's one upload, every dispatch from the first served by the
     mirror, each kernel of the path launched, the mirror equal to the
     host table at the end. Then the pipeline again under
     set_mesh(make_mesh(8)): the prefetch uploads the mesh-resident table
     before the first dispatch (one upload, none per eval), every dispatch
     served by it, the mesh's kernels launched and no single-card
     placement kernel, placements identical to the single card's. Printed:
     the snapshot's bytes, the seconds of dump_columnar, restore, prime and
     prefetch_device, and the first eval's wall after the restore against
     the never-dumped store's, with the card's name and power limit.
The line before the last is the card's name and power limit, the one
before it the kernels' JSON record; the last line is the JSON verdict.
Imports nothing of JAX or of the JAX package.
"""

import json
import statistics
import sys
import time

import numpy as np

SEED = 20260417
MAIN_NODES = 10_000
RACKS = 16
TOL = 1e-6
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM data sheet, float32 without tensor cores
FP64_OPS_PER_S = 34e12        # H100 SXM data sheet, float64 without tensor cores
# Operations per node per step of the scoring sweep, counted from the
# kernel's expression (local_score, scan_local_of and scan_score in
# select_common.cuh).
# float32: port and device-slot tests 2, AllocsFit add + compare over 4
# dims 8, capacity clamps 2, free_cpu/free_mem 4, sum of the powers 1, fit
# clip 3, binpack 1, anti-affinity 1, fired count 10, final sum and
# division 6, masked select 1, argmax 1.
F32_OPS_LOCAL = 40
# Of those, what the scan composes a row a step from its node-local terms
# and its spread total (scan_score, scan_compose): the spread's fired flag
# and its add 2, the three adds after the spread term 3, the division 1,
# masked select 1, argmax 1; the rest are the node-local terms.
F32_OPS_COMPOSE = 8
F32_OPS_NODE = F32_OPS_LOCAL - F32_OPS_COMPOSE
# float64: each 10**x is pow(10.0, (double)x), counted as ONE float64
# operation although the library routine takes many, so the bound stays a
# lower bound.
F64_OPS_POW = 2
# float32 per spread stanza (code gather, count and desired lookups,
# targeted or even-spread boost, min/max over present codes, weight) and
# per distinct_property (gather, count, limit test)
F32_OPS_SPREAD = 14
F32_OPS_DP = 4
# float32 per row per chunked or K-way step to select the step's top
# scores: one comparison, a floor, since a selection reads every score
F32_OPS_SELECT = 1

REPLACES = {
    "chunked": "nomad_tpu/ops/select.py:446",
    "kway": "nomad_tpu/ops/select.py:612",
    "scan": "nomad_tpu/ops/select.py:180",
    "chunked_batched": "nomad_tpu/ops/select.py:597",
    "kway_batched": "nomad_tpu/ops/select.py:785",
    "scan_batched": "nomad_tpu/ops/select.py:395",
    "scatter_set": "nomad_tpu/ops/device_table.py:614",
    "overlay_add": "nomad_tpu/ops/device_table.py:623",
    "feas_scatter": "nomad_tpu/ops/device_table.py:631",
    "scan_cluster": "nomad_tpu/parallel/sharded.py:73",
    "scan_sharded": "nomad_tpu/parallel/sharded.py:73",
    "kway_sharded": "nomad_tpu/ops/select.py:1870",
    # the batched programs SPMD over the mesh (select_many, select.py:1966)
    "chunked_batched_cluster": "nomad_tpu/ops/select.py:597",
    "chunked_batched_sharded": "nomad_tpu/ops/select.py:597",
    "kway_batched_sharded": "nomad_tpu/ops/select.py:785",
    "scan_batched_cluster": "nomad_tpu/ops/select.py:395",
    "scan_batched_sharded": "nomad_tpu/ops/select.py:395",
}
SELECT_ARMS = ("chunked", "kway", "scan")
# the CUDA kernels a wrapper launches where it launches more than one, in
# order: the chunked wrappers' step-0 sweep across the SMs, then the body
# (its launches and time are the pair's)
CUDA_KERNELS = {
    "chunked": ["chunked_sweep_kernel", "chunked_kernel"],
    "chunked_batched": ["chunked_sweep_kernel", "chunked_batched_kernel"],
}
TABLE_KERNELS = ("scatter_set", "overlay_add", "feas_scatter")
BATCHED = ("chunked_batched", "kway_batched", "scan_batched")
SOURCE = {arm: "nomad_tpu_torch/ops/csrc/select_kernels.cu"
          for arm in SELECT_ARMS + BATCHED}
SOURCE.update({k: "nomad_tpu_torch/ops/csrc/table_kernels.cu"
               for k in TABLE_KERNELS})
# the sharded scan's and chunked kernels' two kernels each, the route the
# library fixes by S (kernels.scan_sharded_info, chunked_sharded_info): a
# thread-block cluster a lane ("scan_cluster", "scan_batched_cluster":
# scan_batched_cluster_kernel; "chunked_batched_cluster":
# chunked_batched_cluster_kernel), the cooperative grid past the shards a
# cluster takes ("scan_sharded", "scan_batched_sharded":
# scan_batched_sharded_kernel; "chunked_batched_sharded":
# chunked_batched_sharded_kernel)
SHARDED = ("scan_cluster", "scan_sharded", "kway_sharded")
BATCHED_SHARDED = ("chunked_batched_cluster", "chunked_batched_sharded",
                   "scan_batched_cluster", "scan_batched_sharded",
                   "kway_batched_sharded")
# the batched sharded kernels of the grid route, whose main path is the
# MESH_GRID mesh's
GRID_ROUTE = ("scan_batched_sharded", "chunked_batched_sharded")
SOURCE.update({k: "nomad_tpu_torch/ops/csrc/sharded_kernels.cu"
               for k in SHARDED + BATCHED_SHARDED})
# the mesh of the main path, the mesh whose scans and batched chunked
# lanes take the grid route (its own main path), and the other shard counts
# timed beside them (with the most the card holds at once; the scan and
# the chunked kernels at 16 too, the cluster route's largest)
MESH_SHARDS = 8
MESH_GRID = 32
MESH_SWEEP = (2, 32)
CLUSTER_SWEEP = (2, 16, 32)
# phase 6's main shapes: (kernel, lane counts, variant)
BATCHED_MAIN = (("chunked_batched", [10] * 8, ""),
                ("scan_batched", [200] * 4, "one_spread"),
                ("kway_batched", [2500] * 4, ""))
# the resident table at the main path's size: 10,000 nodes pad to 16,384
TABLE_N_PAD = 16_384
TABLE_D = 4
# the fused overlay_add / feas_scatter kernels' tiles (table_kernels.cu):
# 256 rows, and 4,096 mask bytes
TABLE_TILE = 256
FEAS_TILE = 4096
TABLE_REPS = 51
TABLE_MS = (10, 200, 4096)
# the row count each scatter meets on the steady-state path, as near as
# TABLE_MS comes: a plan's rows (scatter_set, overlay_add) and a CSI
# residue of a third of the table (feas_scatter)
TABLE_MAIN_M = {"scatter_set": 200, "overlay_add": 200,
                "feas_scatter": 4096}
RESIDENT = ("nomad.select.dispatches", "nomad.select.resident_dispatch",
            "nomad.select.resident_fallback",
            "nomad.select.resident_feas_resident",
            "nomad.select.resident_feas_residue",
            "nomad.select.mesh_resident_dispatch",
            "nomad.select.mesh_resident_fallback")
TOKENS = ("token_survivals", "token_invalidations", "residue_rows")
# the share of a table's rows past which a journal replay re-uploads the
# mesh table instead of scattering (ops/device_table.py SPARSE_MAX_FRAC)
SPARSE_MAX_FRAC = 0.5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def request_arrays(seed, n, count, kind):
    """A seeded SelectRequest field dict: heterogeneous capacities and
    usage, ports, penalties, affinity, device slots, preemption scores;
    for the scan two spreads (one targeted) and one distinct_property."""
    rng = np.random.default_rng(seed)
    cap = np.stack([rng.choice([2000., 4000., 8000., 16000.], n),
                    rng.choice([4096., 8192., 16384.], n),
                    np.full(n, 102400.), np.full(n, 1000.)],
                   1).astype(np.float32)
    used = (cap * rng.uniform(0.0, 0.7, (n, 1))).astype(np.float32)
    used[:, 2:] = 0.0
    d = dict(
        ask=np.array([100., 128., 10., 0.], np.float32), count=count,
        feasible=rng.random(n) > 0.05, capacity=cap, used=used,
        desired_count=float(count),
        tg_collisions=rng.integers(0, 3, n).astype(np.int32),
        job_count=rng.integers(0, 3, n).astype(np.int32),
        penalty=rng.random(n) < 0.05,
        affinity=np.where(rng.random(n) < 0.2, 50.0, 0.0).astype(np.float32),
        affinity_sum_weights=50.0,
        port_need=1.0,
        free_ports=rng.integers(0, 400, n).astype(np.float32),
        port_ok=rng.random(n) > 0.02,
        dev_slots=rng.integers(0, 400, n).astype(np.float32),
        pre_score=np.where(rng.random(n) < 0.05,
                           rng.uniform(0.1, 0.9, n), 0.0).astype(np.float32),
    )
    if kind == "scan":
        codes = rng.integers(0, RACKS, n).astype(np.int32)
        counts = np.zeros(RACKS + 1, np.float32)
        counts[:RACKS] = rng.integers(0, 4, RACKS)
        desired = np.full(RACKS + 1, -1.0, np.float32)
        desired[:3] = [80.0, 60.0, 40.0]
        codes2 = rng.integers(0, 8, n).astype(np.int32)
        counts2 = np.zeros(9, np.float32)
        counts2[:8] = rng.integers(0, 2, 8)
        d["spreads"] = [
            dict(codes=codes, counts=counts, present=counts > 0,
                 desired=desired, weight=60.0, has_targets=True),
            dict(codes=codes2, counts=counts2, present=counts2 > 0,
                 desired=np.full(9, -1.0, np.float32), weight=40.0,
                 has_targets=False)]
        d["sum_spread_weights"] = 100.0
        dcodes = rng.integers(0, 12, n).astype(np.int32)
        d["distinct_props"] = [dict(
            codes=dcodes, counts=rng.integers(0, 3, 13).astype(np.float32),
            limit=30.0)]
    return d


def cuda_ms(fn, reps=7):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, want, tol=TOL):
    """Max abs error over float outputs; raises on any integer, boolean or
    out-of-tolerance float difference."""
    import torch
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g if isinstance(g, torch.Tensor) else torch.tensor(g)
        w = w if isinstance(w, torch.Tensor) else torch.tensor(w)
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            fail(f"{name} output {i}: shape {tuple(g.shape)} vs "
                 f"{tuple(w.shape)}")
        if g.dtype.is_floating_point:
            e = float((g.double() - w.double()).abs().max()) if g.numel() \
                else 0.0
            if not e <= tol:
                fail(f"{name} output {i}: max abs error {e}")
            err = max(err, e)
        elif not torch.equal(g.to(w.dtype), w):
            bad = (g.to(w.dtype) != w).nonzero()[:5].tolist()
            fail(f"{name} output {i} differs at {bad}")
    return err


def progress(kind, got, kw):
    """(remaining count, steps run, whether the last step placed nothing)
    of one chunked or K-way launch, read as SelectKernel's loops read it."""
    if kind == "kway":
        packed_i, w = got[1][0], kw["w"]
        steps, rem = int(packed_i[0, -1]), int(packed_i[0, -2])
        stalled = steps > 0 and int(packed_i[steps - 1, w:2 * w].sum()) == 0
    else:
        rem, steps = int(got[1][6]), int(got[1][7])
        stalled = steps > 0 and int(got[1][1][steps - 1]) == 0
    return rem, steps, stalled


def held_launches(kind, label, run, plain, targs, kw, count, single=None):
    """Run the kernel as SelectKernel's loop does, each launch after the
    first continuing from the carry the previous launch left on the card,
    and hold every launch against the plain version on the same inputs
    (and, given `single`, exactly against that kernel: the single-card
    kernel beside a sharded one, called without `shards`). When the first
    launch drains the count, one continuation launch (half the count, from
    the first launch's carry) is held all the same, so the continuation
    inputs are always checked. Returns the max abs error and the (steps,
    remaining) of each launch."""
    import torch
    args, err, trail = dict(targs), 0.0, []
    solo_kw = {k: v for k, v in kw.items() if k != "shards"}
    for launch in range(4):
        got = run(**args, **kw)
        torch.cuda.synchronize()
        want = plain(**args, **kw)
        tag = f"{label} launch {launch}"
        err = max(err, compare(f"{tag} carry", got[0], want[0]),
                  compare(f"{tag} outputs", got[1], want[1]))
        if single is not None:
            ref = single(**args, **solo_kw)
            err = max(err, compare(f"{tag} carry vs single card", got[0],
                                   ref[0], 0.0),
                      compare(f"{tag} outputs vs single card", got[1],
                              ref[1], 0.0))
        if kind == "scan":
            return err, [(kw["k_steps"], 0)]
        rem, steps, stalled = progress(kind, got, kw)
        trail.append((steps, rem))
        if rem <= 0 or steps == 0 or stalled:
            if launch > 0:
                break
            rem = max(count // 2, 1)
        used, coll, freep, devs = got[0]
        args.update(used0=used, tg_coll0=coll, free_ports=freep,
                    dev_slots0=devs, k_valid=rem)
    return err, trail


def rows_bytes(tensors, n, n_pad, steps=None, max_steps=None):
    """Bytes of the given tensors counted over the n real rows (not the
    padding) and, for per-step outputs, over the steps this run needed."""
    import torch
    total = 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        shape = list(t.shape)
        for i, s in enumerate(shape):
            if s == n_pad:
                shape[i] = n
            elif max_steps is not None and i == 0 and s == max_steps:
                shape[i] = steps
        total += int(np.prod(shape)) * t.element_size()
    return total


def kernel_phase(device):
    import torch
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel(device)
    # (kernel, nodes, count, whether this is the main path's shape, seed)
    cases = [("chunked", 10_000, 10, True, SEED),
             ("chunked", 10_000, 512, False, SEED + 1),
             ("kway", 1_000, 10_240, False, SEED + 2),
             ("kway", 10_000, 10_000, True, SEED + 5),
             ("kway", 50_000, 10_000, False, SEED + 3),
             ("scan", 10_000, 200, True, SEED + 4)]
    rows = []
    for kind, n, count, main, seed in cases:
        req = select_request_from_arrays(
            request_arrays(seed, n, count, kind))
        n_pad = S._pad_n(n)
        args, statics = S.pack_request(req, n_pad)
        spread_alg = statics["spread_alg"]
        if kind == "scan":
            targs = sk._tensors(args, S._SCAN_ARGS)
            kw = dict(k_steps=S._bucket_k(count), **statics)
            run, plain = kernels.select_scan, kernels.scan_plain
        elif kind == "kway":
            targs = sk._tensors(args, S._CHUNKED_ARGS)
            w = S._kway_w(n_pad)
            kw = dict(max_steps=S._kway_steps(w), spread_alg=spread_alg, w=w)
            run, plain = kernels.select_kway, kernels.kway_plain
        else:
            targs = sk._tensors(args, S._CHUNKED_ARGS)
            kw = dict(max_steps=64 if count <= 64 else 512,
                      spread_alg=spread_alg)
            run, plain = kernels.select_chunked, kernels.chunked_plain
        label = f"{kind} n={n} count={count}"
        err, trail = held_launches(kind, label, run, plain, targs, kw, count)
        if kind in ("scan", "chunked") and err != 0.0:
            fail(f"{label}: max abs err {err} against the plain version")
        # the timed call is the first launch, from the request's own inputs
        steps = trail[0][0]
        ms = cuda_ms(lambda: run(**targs, **kw))
        plain_ms = cuda_ms(lambda: plain(**targs, **kw), reps=5)
        got = run(**targs, **kw)
        row = dict(kind=kind, n=n, count=count, main=main, steps=steps,
                   launches_held=len(trail), max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, us_per_step=ms / steps * 1e3)
        bounds = [False, True] if kind == "scan" else [False]
        for full in bounds:
            io_bytes, f32, f64 = lane_bound(
                kind, targs, got[0], got[1], n, n_pad, steps, kw,
                len(req.spreads), len(req.distinct_props), full)
            io_bytes += rows_bytes([targs["capacity"]], n, n_pad)
            b_ms, by = bound_of(io_bytes, f32, f64)
            row.update({"bound_full_ms": b_ms} if full
                       else dict(bound_ms=b_ms, bound_by=by))
        extra = ""
        if kind == "scan":
            row["steps_run"] = scan_steps_run(got[1][0], kw["k_steps"])
            extra = (f"; {row['steps_run']} steps run, "
                     f"{ms / row['steps_run'] * 1e3:.1f} us each; bound "
                     f"over every step and row {row['bound_full_ms']:.6f} ms")
        rows.append(row)
        print(f"kernel {label}: agrees over {len(trail)} launches "
              f"(steps, remaining {trail}; max abs err {err:.3g}); first "
              f"launch {ms:.3f} ms ({ms / steps * 1e3:.1f} us a "
              f"{'phase' if kind == 'kway' else 'step'}), plain "
              f"{plain_ms:.3f} ms, bound {row['bound_ms']:.6f} ms{extra}",
              flush=True)
    rows += chunked_edge_checks()
    kway_edge_checks()
    scan_edge_checks()
    return rows


def bound_of(nbytes, f32, f64):
    """(ms, "bytes" or "operations"): the least time the card takes to
    move nbytes and do the operations, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32 / FP32_OPS_PER_S, f64 / FP64_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_steps_run(choice, k_steps):
    """Steps a scan lane runs: up to and including its first invalid one
    (the longest lane's, for a batch)."""
    most = 0
    for lane in choice.reshape(-1, k_steps).cpu():
        bad = (lane < 0).nonzero()
        most = max(most, int(bad[0]) + 1 if len(bad) else k_steps)
    return most


def scan_edge_checks():
    """The scan kernels at SCAN_EDGES (nomad_tpu_torch.mock.scan_edges),
    binpack and spread: the solo kernel against the plain version, and
    each case as two lanes over one table (the case, and the same shape
    from another seed) against the batched plain version and lane by lane
    the solo kernel; then ten lanes of counts 16-61 with their own stanzas
    and constraints, the last with no feasible row, at 10,000 nodes. Every
    launch equal, max abs error 0."""
    import torch
    from nomad_tpu_torch.mock import scan_edges as edges
    from nomad_tpu_torch.ops import kernels

    def held(label, targs, kw, batched):
        name = "scan_batched" if batched else "scan"
        got = getattr(kernels, "select_" + name)(**targs, **kw)
        torch.cuda.synchronize()
        want = getattr(kernels, name + "_plain")(**targs, **kw)
        compare(f"{label} carry", got[0], want[0], 0.0)
        compare(f"{label} outputs", got[1], want[1], 0.0)
        if batched:
            for i in range(targs["used0"].shape[0]):
                s_carry, s_outs = kernels.select_scan(
                    **kernels.lane_args(targs, i), **kw)
                compare(f"{label} lane {i} carry vs solo",
                        [t[i] for t in got[0]], s_carry, 0.0)
                compare(f"{label} lane {i} outputs vs solo",
                        [t[i] for t in got[1]], s_outs, 0.0)
        # the rows live at step 0 (its ok_count), the most of any lane
        live = int(got[1][12].reshape(-1, kw["k_steps"])[:, 0].max())
        return scan_steps_run(got[1][0], kw["k_steps"]), live

    held_runs = []
    for i, label in enumerate(edges.SCAN_EDGES):
        for spread_alg in (False, True):
            seed = SEED + 80 + i
            args, st = edges.edge_case(label, seed, spread_alg)
            solo = held(f"scan edge {label} (spread_alg {spread_alg})",
                        _card(args), st, False)
            lanes = [edges.edge_case(label, seed + j, spread_alg)
                     for j in range(2)]
            lanes[1][0]["capacity"] = lanes[0][0]["capacity"]
            args, st = edges.lanes_batch(lanes)
            st["k_steps"] = lanes[0][1]["k_steps"]
            batched = held(f"scan_batched edge {label} (spread_alg "
                           f"{spread_alg})", _card(args), st, True)
            held_runs.append((label, spread_alg, st["k_steps"], solo[0],
                              batched[0], solo[1]))
    args, st = edges.mixed_lanes(MAIN_NODES, SEED + 90)
    mixed = held("scan_batched mixed lanes", _card(args), st, True)
    slots = (kernels.scan_shared_slots(), kernels.scan_shared_slots(True))
    print("kernel scan edge shapes: every launch equal to the plain version "
          "bit for bit, each batched lane also to the solo kernel (label, "
          "spread_alg, k_steps, steps run solo, steps run batched, rows "
          f"live at step 0 solo): {held_runs}; mixed lanes at {MAIN_NODES} "
          f"nodes: {mixed[0]} of {st['k_steps']} steps run, {mixed[1]} rows "
          f"live at step 0 in the largest lane; live records kept in shared "
          f"memory (solo, batched): {slots}", flush=True)
    past = [r for r in held_runs if r[5] > max(slots)]
    if not past:
        fail("scan edge shapes: no case has more live rows than the "
             f"kernels' {slots} records in shared memory")


# The K-way kernel's edge shapes (its radix top-(w + 1), winner-only
# rescoring and early-exit streams), as (label, n, count, kind, w, the
# rows kept feasible or None), with kind as in
# nomad_tpu_torch.mock.kway_edges: "random", "alike" (every node the
# same: the main path's tie storm) or "dry" (room for fewer instances
# than the count: an invalid later phase). The main shapes, n 1,000 at w
# 32 and n 50,000 are kernel_phase's own cases.
KWAY_EDGES = (("n = w + 1", 129, 2_000, "random", 128, None),
              ("50 of 10,000 feasible", 10_000, 2_000, "random", 128, 50),
              ("exactly w + 1 feasible", 10_000, 2_000, "random", 128, 129),
              ("all alike", 10_000, 10_000, "alike", 128, None),
              ("first phase invalid", 10_000, 2_000, "random", 128, 0),
              ("runs dry", 10_000, 40_000, "dry", 128, None),
              ("n 1,000 all alike", 1_000, 10_240, "alike", 32, None))


def _card(a):
    """Arguments on the card: arrays as tensors there, numpy scalars as
    Python numbers (as the wrappers and plain versions take them)."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            if isinstance(v, np.ndarray)
            else v.item() if isinstance(v, np.generic) else v
            for k, v in a.items()}


def chunked_edge_checks():
    """The chunked kernel at CHUNKED_EDGES (nomad_tpu_torch.mock.
    chunked_edges) at their card rows, binpack and spread, with
    SelectKernel's step budget and continuation launches from the card's
    own carry, every launch held bit for bit against the plain version;
    the all-alike table at count 512 (a winner that drops out of the kept
    list every step under spread: a new list every 255 steps) is
    also timed. Returns the timed rows."""
    from nomad_tpu_torch.mock.chunked_edges import (CHUNKED_EDGES,
                                                    chunked_edge_args)
    from nomad_tpu_torch.ops import kernels
    held, rows = [], []
    for i, label in enumerate(CHUNKED_EDGES):
        _n_cpu, n, count, _kind, _keep = CHUNKED_EDGES[label]
        for spread_alg in (False, True):
            targs = _card(chunked_edge_args(label, SEED + 60 + i, card=True))
            kw = dict(max_steps=64 if count <= 64 else 512,
                      spread_alg=spread_alg)
            tag = f"chunked edge {label} (n {n}, spread_alg {spread_alg})"
            err, trail = held_launches(
                "chunked", tag, kernels.select_chunked,
                kernels.chunked_plain, targs, kw, count)
            if err != 0.0:
                fail(f"{tag}: max abs err {err}")
            held.append((label, spread_alg, trail))
            if label != "all alike, count 512":
                continue
            run, plain = kernels.select_chunked, kernels.chunked_plain
            ms = cuda_ms(lambda: run(**targs, **kw))
            plain_ms = cuda_ms(lambda: plain(**targs, **kw), reps=3)
            got = run(**targs, **kw)
            steps = trail[0][0]
            n_pad = targs["capacity"].shape[0]
            io_bytes, f32, f64 = lane_bound("chunked", targs, got[0],
                                            got[1], n, n_pad, steps, kw,
                                            0, 0)
            io_bytes += rows_bytes([targs["capacity"]], n, n_pad)
            b_ms, by = bound_of(io_bytes, f32, f64)
            rows.append(dict(kind="chunked", n=n, count=count, main=False,
                             edge=label, spread_alg=spread_alg,
                             steps=steps, launches_held=len(trail),
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             us_per_step=ms / steps * 1e3, bound_ms=b_ms,
                             bound_by=by))
            print(f"kernel {tag}: first launch {ms:.3f} ms ({steps} steps, "
                  f"{ms / steps * 1e3:.2f} us a step), plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms", flush=True)
    print("kernel chunked edge shapes: every launch equal to the plain "
          "version bit for bit (label, spread_alg, (steps, left) a "
          f"launch): {held}", flush=True)
    return rows


def kway_edge_checks():
    """The K-way kernel at KWAY_EDGES, binpack and spread, each with an
    8-phase budget so that its launches continue from the card's own
    carry: every launch held bit for bit against the plain version."""
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args
    from nomad_tpu_torch.ops import kernels
    held = []
    for i, (label, n, count, kind, w, keep) in enumerate(KWAY_EDGES):
        for spread_alg in (False, True):
            targs = _card(kway_edge_args(n, count, kind, SEED + 40 + i,
                                         feasible_rows=keep))
            kw = dict(max_steps=8, spread_alg=spread_alg, w=w)
            err, trail = held_launches(
                "kway", f"kway edge {label} (n {n}, w {w}, spread_alg "
                f"{spread_alg})", kernels.select_kway, kernels.kway_plain,
                targs, kw, count)
            if err != 0.0:
                fail(f"kway edge {label}: max abs err {err}")
            held.append((label, spread_alg, trail))
    print("kernel kway edge shapes: every launch equal to the plain "
          "version bit for bit (label, spread_alg, (phases, left) a "
          f"launch): {held}", flush=True)


def mesh_shard_counts(device, kernel):
    """The shard counts the mesh phases run: MESH_SHARDS, MESH_SWEEP (the
    scan's and the chunked kernels' CLUSTER_SWEEP) and the most the card
    holds at once."""
    from nomad_tpu_torch.ops import kernels
    sweep = CLUSTER_SWEEP if kernel.startswith(("scan", "chunked")) \
        else MESH_SWEEP
    grid = "scan_sharded" if kernel.startswith("scan") else kernel
    return sorted(set((MESH_SHARDS,) + sweep
                      + (kernels.max_shards(grid, device),)))


def scan_route(shards, per, batched=False):
    """The LAUNCHES key of the sharded scan kernel that S shards of `per`
    rows take, as the library routes them."""
    from nomad_tpu_torch.ops import kernels
    route = "cluster" if kernels.scan_sharded_info(
        shards, per)["route"] == "cluster" else "sharded"
    return f"scan_batched_{route}" if batched else f"scan_{route}"


def chunked_route(shards):
    """The LAUNCHES key of the sharded chunked kernel that S shards take,
    as the library routes them."""
    from nomad_tpu_torch.ops import kernels
    route = kernels.chunked_sharded_info(shards)["route"]
    return f"chunked_batched_{'cluster' if route == 'cluster' else 'sharded'}"


def kway_sharded_edge_checks(device):
    """The node-sharded K-way kernel at KWAY_EDGES (one lane, binpack and
    spread) and at mixed batched lanes (K-way lanes of 10, 2,000 and 2,000
    instances over 50 feasible rows, one with no feasible row and one
    that runs dry, over one capacity table), at S 2, 8, 32 and the most
    the card holds, each table padded as a mesh of S shards pads it and
    each call with an 8-phase budget continued from the card's own carry:
    every launch held bit for bit against its plain version and against
    the single-card kernel on the same padded table."""
    import torch
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args, pad_rows
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shard_counts = mesh_shard_counts(device, "kway_sharded")
    held = []
    for i, (label, n, count, kind, w, keep) in enumerate(KWAY_EDGES):
        args = kway_edge_args(n, count, kind, SEED + 40 + i,
                              feasible_rows=keep)
        for shards in shard_counts:
            targs = _card(pad_rows(args, pad_for_mesh(
                make_mesh(shards, device), n)))
            for spread_alg in (False, True):
                kw = dict(max_steps=8, spread_alg=spread_alg, w=w,
                          shards=shards)
                err, trail = held_launches(
                    "kway", f"kway_sharded edge {label} (n {n}, w {w}, "
                    f"spread_alg {spread_alg}, shards {shards})",
                    kernels.select_kway_sharded, kernels.kway_sharded_plain,
                    targs, kw, count, single=kernels.select_kway)
                if err != 0.0:
                    fail(f"kway_sharded edge {label}: max abs err {err}")
                held.append((label, shards, spread_alg, len(trail)))
    print("kernel kway_sharded edge shapes: every launch equal to the plain "
          "version and the single-card kernel bit for bit (label, shards, "
          f"spread_alg, launches): {held}", flush=True)

    n, w = MAIN_NODES, 128
    lanes = [kway_edge_args(n, c, kind, SEED + 60, feasible_rows=keep)
             for c, kind, keep in ((10, "random", None),
                                   (2_000, "random", None),
                                   (2_000, "random", 50),
                                   (2_000, "random", 0),
                                   (40_000, "dry", None))]
    trails = []
    for shards in shard_counts:
        n_pad = pad_for_mesh(make_mesh(shards, device), n)
        padded = [pad_rows(ln, n_pad) for ln in lanes]
        batch = {}
        for k in padded[0]:
            if k == "capacity":
                batch[k] = padded[0][k]
            elif k == "k_valid":
                batch[k] = np.array([ln[k] for ln in padded], np.int32)
            elif isinstance(padded[0][k], np.ndarray):
                batch[k] = np.stack([ln[k] for ln in padded])
            else:
                batch[k] = np.array([ln[k] for ln in padded], np.float32)
        targs = _card(batch)
        kw = dict(max_steps=8, spread_alg=False, w=w)
        trail = []
        for launch in range(6):
            tag = f"kway_batched_sharded mixed lanes shards {shards} " \
                  f"launch {launch}"
            got = kernels.select_kway_batched_sharded(**targs, **kw,
                                                      shards=shards)
            torch.cuda.synchronize()
            want = kernels.kway_batched_sharded_plain(**targs, **kw,
                                                      shards=shards)
            ref = kernels.select_kway_batched(**targs, **kw)
            for what, other in (("plain", want), ("single card", ref)):
                compare(f"{tag} carry vs {what}", got[0], other[0], 0.0)
                compare(f"{tag} outputs vs {what}", got[1], other[1], 0.0)
            packed = got[1][0]
            left = packed[:, 0, -2].clamp(min=0).to(torch.int32)
            trail.append(left.tolist())
            if int(left.sum()) == 0 or int(packed[:, :, w:2 * w].sum()) == 0:
                break
            used, coll, freep, devs = got[0]
            targs.update(used0=used, tg_coll0=coll, free_ports=freep,
                         dev_slots0=devs, k_valid=left)
        if len(trail) < 2:
            fail(f"kway_batched_sharded mixed lanes shards {shards}: "
                 f"nothing continued ({trail})")
        trails.append((shards, trail))
    print("kernel kway_batched_sharded mixed lanes: every launch equal to "
          "the plain version and the single-card batched kernel bit for "
          "bit (shards, lanes' counts left after each 8-phase launch): "
          f"{trails}", flush=True)


def chunk_handoffs(choice, steps, per):
    """A sharded chunked lane's handoffs: its steps whose winner lies in
    another shard than the last step's (one exchange each)."""
    rows = [int(c) for c in choice[:steps] if int(c) >= 0]
    return sum(1 for a, b in zip(rows, rows[1:]) if a // per != b // per)


def held_chunked_sharded(targs, kw, shards, label, launches=2):
    """Batched sharded chunked launches as SelectKernel continues a lane:
    each launch after the first from the carry the last one left on the
    card (a first launch that drains every lane is followed by one from its
    carry all the same, at half the counts), every launch held exactly
    against its plain version and the single-card batched kernel, on the
    kernel of the route the library gives for S and no other. Returns each
    launch's (steps, remaining) a lane."""
    import torch
    from nomad_tpu_torch.ops import kernels
    name, args, trail = chunked_route(shards), dict(targs), []
    for launch in range(launches):
        before = kernels.LAUNCHES[name]
        got = kernels.select_chunked_batched_sharded(**args, **kw,
                                                     shards=shards)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] == before:
            fail(f"{label}: {name} not launched")
        tag = f"{label} launch {launch}"
        for what, other in (
                ("plain", kernels.chunked_batched_sharded_plain(
                    **args, **kw, shards=shards)),
                ("single card", kernels.select_chunked_batched(**args,
                                                               **kw))):
            compare(f"{tag} carry vs {what}", got[0], other[0], 0.0)
            compare(f"{tag} outputs vs {what}", got[1], other[1], 0.0)
        rem, steps = got[1][6], got[1][7]
        trail.append(list(zip(steps.tolist(), rem.tolist())))
        left = rem.clamp(min=0).to(torch.int32)
        if int(left.sum()) == 0:
            left = (args["k_valid"] // 2).clamp(min=1).to(torch.int32)
        used, coll, freep, devs = got[0]
        args.update(used0=used, tg_coll0=coll, free_ports=freep,
                    dev_slots0=devs, k_valid=left)
    return trail


def chunked_sharded_edge_checks(device):
    """The sharded chunked kernels at CHUNKED_EDGES' card rows (one lane,
    binpack and spread, SelectKernel's step budget) and at CHUNKED_LANES
    over 10,000 rows (an 8-step budget), at every shard count of the mesh
    phases, each table padded as a mesh of S shards pads it: every launch,
    and a continuation from the card's own carry, held bit for bit against
    the plain version and the single-card batched kernel."""
    from nomad_tpu_torch.mock.chunked_edges import (
        CHUNKED_EDGES, CHUNKED_LANES, chunked_edge_args, chunked_lanes,
        edge_rows, one_lane, pad_lanes)
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shard_counts = mesh_shard_counts(device, "chunked_batched_sharded")
    held = []
    for i, label in enumerate(CHUNKED_EDGES):
        count = CHUNKED_EDGES[label][2]
        for shards in shard_counts:
            n_pad = pad_for_mesh(make_mesh(shards, device),
                                 edge_rows(label, card=True))
            targs = _card(one_lane(chunked_edge_args(
                label, SEED + 60 + i, card=True, n_pad=n_pad)))
            for spread_alg in (False, True):
                kw = dict(max_steps=64 if count <= 64 else 512,
                          spread_alg=spread_alg)
                trail = held_chunked_sharded(
                    targs, kw, shards, f"chunked sharded edge {label} "
                    f"(shards {shards}, spread_alg {spread_alg})")
                held.append((label, shards, spread_alg,
                             [t[0] for t in trail]))
    print("kernel chunked sharded edge shapes: every launch equal to the "
          "plain version and the single-card batched kernel bit for bit "
          "(label, shards, spread_alg, (steps, left) a launch): "
          f"{held}", flush=True)
    trails = []
    for shards in shard_counts:
        n_pad = pad_for_mesh(make_mesh(shards, device), MAIN_NODES)
        targs = _card(pad_lanes(chunked_lanes(MAIN_NODES, CHUNKED_LANES,
                                              SEED + 70), n_pad))
        trail = held_chunked_sharded(
            targs, dict(max_steps=8, spread_alg=False), shards,
            f"chunked sharded mixed lanes (shards {shards})", launches=4)
        trails.append((shards, [[left for _s, left in t] for t in trail]))
    print("kernel chunked sharded mixed lanes: every launch equal to the "
          "plain version and the single-card batched kernel bit for bit "
          "(shards, lanes' counts left after each 8-step launch): "
          f"{trails}", flush=True)


def graph_ms(fn, launches=20, reps=7):
    """Device time of one call of `fn`: `launches` calls captured in one
    CUDA graph and replayed, so no host work lies in the timed window;
    the median over `reps` replays, divided by `launches`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def _launch_alone(lib, name, out, col, idx, vals, n, m, d):
    """One launch of a table kernel's C entry point on inputs already on
    the card (sorted rows), with no wrapper around it, on the current
    stream: the kernel_ms column. Not counted in LAUNCHES (a measurement,
    not the main path)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    if name == "scatter_set":
        (o_used, o_ports), (c_used, c_ports), (v_used, v_ports) = \
            out, col, vals
        rc = lib.nomad_scatter_set(c_used.data_ptr(), c_ports.data_ptr(),
                                   o_used.data_ptr(), o_ports.data_ptr(),
                                   idx.data_ptr(), v_used.data_ptr(), None,
                                   v_ports.data_ptr(), None, n, m, d,
                                   stream)
    elif name == "overlay_add":
        rc = lib.nomad_overlay_add(col.data_ptr(), out.data_ptr(),
                                   idx.data_ptr(), vals.data_ptr(), None,
                                   n, m, d, stream)
    else:
        rc = lib.nomad_feas_scatter(col.data_ptr(), out.data_ptr(),
                                    idx.data_ptr(), vals.data_ptr(), None,
                                    n, m, stream)
    if rc != 0:
        fail(f"{name}: launch failed with CUDA error {rc}")


def _held_scatter(name, label, run, plain, lib, inputs):
    """One wrapper call: exactly one launch, equal bit for bit to its plain
    version and to the library call, its inputs left as they were."""
    import torch
    from nomad_tpu_torch.ops import kernels
    keep = [x.clone() for x in inputs]
    before = kernels.LAUNCHES[name]
    got = run()
    torch.cuda.synchronize()
    if kernels.LAUNCHES[name] != before + 1:
        fail(f"{name} {label}: {kernels.LAUNCHES[name] - before} launches "
             "in one call, expected 1")
    got, want, libv = [x if isinstance(x, tuple) else (x,)
                       for x in (got, plain(), lib())]
    for g, w, li in zip(got, want, libv):
        if not (torch.equal(g, w) and torch.equal(g, li)):
            bad = (g != w).nonzero()[:5].tolist()
            fail(f"{name} {label}: kernel differs from its plain version "
                 f"or the library call at {bad}")
    for x, k in zip(inputs, keep):
        if not torch.equal(x, k):
            fail(f"{name} {label}: the scatter wrote its input")


def table_edge_checks(rng):
    """overlay_add and feas_scatter at the fused kernels' edge shapes
    (tiles of TABLE_TILE rows and FEAS_TILE mask bytes): one row; every
    tile's first and last row of the main table (row n_pad - 1 among
    them); an n_pad of 10,001 (not a multiple of 16, so a ragged mask
    tail); every row; and a column and a mask 4 bytes off 16-byte
    alignment (the scalar paths), with rows out of order. Row values on
    the host (the main path's case) and on the card. Returns the count of
    calls held."""
    import torch
    from nomad_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    d, n_main = TABLE_D, TABLE_N_PAD
    ends = sorted({r for t in range(0, n_main, TABLE_TILE)
                   for r in (t, t + TABLE_TILE - 1)})
    ragged = np.unique(np.concatenate([
        [0, FEAS_TILE - 1, FEAS_TILE, 9_999, 10_000],
        rng.choice(10_001, 300, replace=False)]))
    cases = [("m 1", n_main, np.array([7_777]), False),
             ("tile ends", n_main, np.array(ends), False),
             ("n_pad 10,001", 10_001, ragged, False),
             ("every row", 1_000, np.arange(1_000), False),
             ("4 bytes off alignment, rows out of order", 10_001,
              rng.permutation(ragged), True)]
    held = 0
    for label, n, rows, offset in cases:
        m = rows.size
        used = torch.from_numpy(
            rng.uniform(0, 8000, (n, d)).astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.random(n) > 0.3).to(dev)
        if offset:
            flat = torch.empty(n * d + 1, dtype=torch.float32, device=dev)
            flat[1:].copy_(used.view(-1))
            used = flat[1:].view(n, d)
            raw = torch.empty(n + 4, dtype=torch.bool, device=dev)
            raw[4:].copy_(mask)
            mask = raw[4:]
            if used.data_ptr() % 16 != 4 or mask.data_ptr() % 16 != 4:
                fail("the offset columns are not 4 bytes off alignment")
        idx = torch.from_numpy(rows.astype(np.int32))
        idx_dev = idx.to(dev, torch.long)
        vals = torch.from_numpy(
            rng.uniform(-500, 500, (m, d)).astype(np.float32))
        bits = torch.from_numpy(rng.random(m) > 0.5)
        vd, bd = vals.to(dev), bits.to(dev)
        for on, v, b in (("host", vals, bits), ("card", vd, bd)):
            _held_scatter(
                "overlay_add", f"{label} (n_pad {n}, m {m}, values on the "
                f"{on})", lambda: kernels.overlay_add(used, idx, v),
                lambda: kernels.overlay_add_plain(used, idx, v),
                lambda: used.index_add(0, idx_dev, vd), [used, v])
            _held_scatter(
                "feas_scatter", f"{label} (n_pad {n}, m {m}, values on the "
                f"{on})", lambda: kernels.feas_scatter(mask, idx, b),
                lambda: kernels.feas_scatter_plain(mask, idx, b),
                lambda: mask.index_copy(0, idx_dev, bd), [mask, b])
            held += 2
    print(f"table edge shapes: overlay_add and feas_scatter equal to their "
          f"plain versions and the library call in {held} calls "
          f"({', '.join(c[0] for c in cases)}; values on the host and on "
          f"the card)", flush=True)
    return held


def scatter_set_edge_checks(rng):
    """The fused scatter_set at its edge shapes: one row; every tile's
    first and last row of the main table; an n_pad of 10,001; rows out of
    order; a repeated row (its last value wins); columns 4 bytes off
    16-byte alignment (the scalar path); row values on the host (numpy, as
    the mirror hands them) and on the card. Each call one launch, its
    inputs unchanged, equal bit for bit to scatter_set_plain on the CPU
    (whose sequential copy keeps a repeated row's last value). Returns the
    count of calls held."""
    import torch
    from nomad_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    d, n_main = TABLE_D, TABLE_N_PAD
    ends = sorted({r for t in range(0, n_main, TABLE_TILE)
                   for r in (t, t + TABLE_TILE - 1)})
    ragged = np.unique(np.concatenate([
        [0, TABLE_TILE - 1, TABLE_TILE, 9_999, 10_000],
        rng.choice(10_001, 300, replace=False)]))
    again = np.concatenate([ragged, ragged[rng.choice(ragged.size, 20)]])
    cases = [("m 1", n_main, np.array([7_777]), False),
             ("tile ends", n_main, np.array(ends), False),
             ("n_pad 10,001", 10_001, ragged, False),
             ("rows out of order", 10_001, rng.permutation(ragged), False),
             ("repeated rows, out of order", 10_001, rng.permutation(again),
              False),
             ("4 bytes off alignment, rows out of order", 10_001,
              rng.permutation(ragged), True)]
    held = 0
    for label, n, rows, offset in cases:
        m = rows.size
        used_h = rng.uniform(0, 8000, (n, d)).astype(np.float32)
        ports_h = rng.integers(0, 12000, n).astype(np.float32)
        used = torch.from_numpy(used_h).to(dev)
        ports = torch.from_numpy(ports_h).to(dev)
        if offset:
            flat = torch.empty(n * d + 1, dtype=torch.float32, device=dev)
            flat[1:].copy_(used.view(-1))
            used = flat[1:].view(n, d)
            if used.data_ptr() % 16 != 4:
                fail("the offset column is not 4 bytes off alignment")
        idx = rows.astype(np.int32)
        vals = rng.uniform(-500, 500, (m, d)).astype(np.float32)
        prow = rng.integers(0, 12000, m).astype(np.float32)
        want = kernels.scatter_set_plain(
            torch.from_numpy(used_h), torch.from_numpy(ports_h),
            torch.from_numpy(idx), torch.from_numpy(vals),
            torch.from_numpy(prow))
        for on, v, pv in (("host", vals, prow),
                          ("card", torch.from_numpy(vals).to(dev),
                           torch.from_numpy(prow).to(dev))):
            keep = (used.clone(), ports.clone())
            before = kernels.LAUNCHES["scatter_set"]
            got = kernels.scatter_set(used, ports, idx, v, pv)
            torch.cuda.synchronize()
            tag = f"scatter_set {label} (n_pad {n}, m {m}, values on the {on})"
            if kernels.LAUNCHES["scatter_set"] != before + 1:
                fail(f"{tag}: {kernels.LAUNCHES['scatter_set'] - before} "
                     "launches in one call, expected 1")
            for g, w in zip(got, want):
                if not torch.equal(g.cpu().view(torch.int32),
                                   w.view(torch.int32)):
                    fail(f"{tag}: differs from the plain version")
            if not (torch.equal(used, keep[0])
                    and torch.equal(ports, keep[1])):
                fail(f"{tag}: the scatter wrote its input")
            held += 1
    print(f"table edge shapes: scatter_set equal to its plain version in "
          f"{held} calls ({', '.join(c[0] for c in cases)}; values on the "
          f"host and on the card)", flush=True)
    return held


def table_sync_check(rng):
    """The three fused wrappers called once as the main path calls them
    (host rows, host values: numpy for scatter_set, as the mirror hands
    them) under torch.cuda.set_sync_debug_mode("error"): any
    synchronising operation in them raises."""
    import torch
    from nomad_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    n, d, m = TABLE_N_PAD, TABLE_D, TABLE_MAIN_M["overlay_add"]
    used = torch.from_numpy(
        rng.uniform(0, 8000, (n, d)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n) > 0.3).to(dev)
    idx = torch.from_numpy(np.sort(
        rng.choice(MAIN_NODES, m, replace=False)).astype(np.int32))
    vals = torch.from_numpy(rng.uniform(-500, 500, (m, d)).astype(np.float32))
    bits = torch.from_numpy(rng.random(m) > 0.5)
    ports = torch.from_numpy(
        rng.integers(0, 12000, n).astype(np.float32)).to(dev)
    prow = rng.integers(0, 12000, m).astype(np.float32)
    shuffled = rng.permutation(m)
    set_idx = idx.numpy()[shuffled]
    set_vals, set_prow = vals.numpy()[shuffled], prow[shuffled]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_u = kernels.overlay_add(used, idx, vals)
        got_m = kernels.feas_scatter(mask, idx, bits)
        got_s = kernels.scatter_set(used, ports, set_idx, set_vals, set_prow)
    except RuntimeError as e:
        fail(f"a fused scatter wrapper synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want_s = kernels.scatter_set_plain(
        used, ports, torch.from_numpy(set_idx), torch.from_numpy(set_vals),
        torch.from_numpy(set_prow))
    if not (torch.equal(got_u, kernels.overlay_add_plain(used, idx, vals))
            and torch.equal(got_m,
                            kernels.feas_scatter_plain(mask, idx, bits))
            and torch.equal(got_s[0], want_s[0])
            and torch.equal(got_s[1], want_s[1])):
        fail("the wrappers called under sync debug mode differ from their "
             "plain versions")
    print("table sync check: overlay_add, feas_scatter and scatter_set "
          "(rows out of order) ran under set_sync_debug_mode('error') "
          "without raising", flush=True)


def table_kernel_phase():
    """The three row scatters against their plain versions on the card,
    exactly, at the main path's table and m = TABLE_MS rows; timed with
    the plain version and the library call; then the fused kernels' edge
    shapes and the sync check."""
    import torch
    from nomad_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    n_pad, d = TABLE_N_PAD, TABLE_D
    used = torch.from_numpy(
        rng.uniform(0, 8000, (n_pad, d)).astype(np.float32)).to(dev)
    ports = torch.from_numpy(
        rng.integers(0, 12000, n_pad).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n_pad) > 0.3).to(dev)
    lib = kernels.load_library()
    rows = []
    for m in TABLE_MS:
        # host rows, as the main path hands them to the wrappers
        idx = torch.from_numpy(np.sort(
            rng.choice(MAIN_NODES, m, replace=False)).astype(np.int32))
        idx_dev = idx.to(dev, torch.long)
        idx32 = idx.to(dev)
        vals = torch.from_numpy(
            rng.uniform(-500, 500, (m, d)).astype(np.float32)).to(dev)
        prow = torch.from_numpy(
            rng.integers(0, 12000, m).astype(np.float32)).to(dev)
        bits = torch.from_numpy(rng.random(m) > 0.5).to(dev)
        # the same values on the host, as the main path's callers hand them
        vals_h, prow_h, bits_h = vals.cpu(), prow.cpu(), bits.cpu()
        cases = {
            "scatter_set": (
                lambda: kernels.scatter_set(used, ports, idx, vals, prow),
                lambda: kernels.scatter_set(used, ports, idx, vals_h, prow_h),
                lambda: kernels.scatter_set_plain(used, ports, idx, vals,
                                                  prow),
                # two calls: the function updates two columns
                lambda: (used.index_copy(0, idx_dev, vals),
                         ports.index_copy(0, idx_dev, prow)),
                lambda: (lambda i: (used.index_copy(0, i, vals),
                                    ports.index_copy(0, i, prow)))(
                    idx.to(dev, torch.long)),
                ((torch.empty_like(used), torch.empty_like(ports)),
                 (used, ports), (vals, prow)),
                [used, ports],
                2 * n_pad * (d + 1) * 4 + m * (4 + d * 4 + 4), 0),
            "overlay_add": (
                lambda: kernels.overlay_add(used, idx, vals),
                lambda: kernels.overlay_add(used, idx, vals_h),
                lambda: kernels.overlay_add_plain(used, idx, vals),
                lambda: used.index_add(0, idx_dev, vals),
                lambda: used.index_add(0, idx.to(dev, torch.long), vals),
                (torch.empty_like(used), used, vals), [used],
                2 * n_pad * d * 4 + m * (4 + d * 4), m * d),
            "feas_scatter": (
                lambda: kernels.feas_scatter(mask, idx, bits),
                lambda: kernels.feas_scatter(mask, idx, bits_h),
                lambda: kernels.feas_scatter_plain(mask, idx, bits),
                lambda: mask.index_copy(0, idx_dev, bits),
                lambda: mask.index_copy(0, idx.to(dev, torch.long), bits),
                (torch.empty_like(mask).view(torch.uint8),
                 mask.view(torch.uint8), bits.view(torch.uint8)), [mask],
                2 * n_pad + m * (4 + 1), 0),
        }
        for name, (run, run_host, plain, library, library_host, alone,
                   inputs, nbytes, ops) in cases.items():
            _held_scatter(name, f"m={m}", run, plain, library, inputs)
            _held_scatter(name, f"m={m}, values on the host", run_host,
                          plain, library, inputs)
            out, col, kvals = alone
            _launch_alone(lib, name, out, col, idx32, kvals, n_pad, m, d)
            torch.cuda.synchronize()
            want = plain()
            for g, w in zip(out if isinstance(out, tuple) else (out,),
                            want if isinstance(want, tuple) else (want,)):
                if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                    fail(f"{name} m={m}: the launch alone differs from the "
                         "plain version")
            # the calls are tens of microseconds of host work each, so
            # their medians take TABLE_REPS calls
            ms = cuda_ms(run, TABLE_REPS)
            host_vals_ms = cuda_ms(run_host, TABLE_REPS)
            kernel_ms = graph_ms(lambda: _launch_alone(
                lib, name, out, col, idx32, kvals, n_pad, m, d))
            plain_ms = cuda_ms(plain, TABLE_REPS)
            library_ms = cuda_ms(library, TABLE_REPS)
            library_graph_ms = graph_ms(library)
            library_host_ms = cuda_ms(library_host, TABLE_REPS)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_OPS_PER_S * 1e3
            rows.append(dict(
                kind=name, n_pad=n_pad, m=m, main=m == TABLE_MAIN_M[name],
                max_abs_err=0.0, ms=ms, host_vals_ms=host_vals_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_host_ms=library_host_ms,
                library_graph_ms=library_graph_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_counts="the n_pad-row column read and written once "
                             "plus the m indices and row values read"))
            print(f"kernel {name} n_pad={n_pad} m={m}: equal to its plain "
                  f"version and the library call; wrapper {ms:.4f} ms "
                  f"(values on the host {host_vals_ms:.4f}), launch alone "
                  f"{kernel_ms:.4f} ms (graph replay), plain {plain_ms:.4f} "
                  f"ms, library {library_ms:.4f} ms (idx from the host "
                  f"{library_host_ms:.4f}; graph replay "
                  f"{library_graph_ms:.4f}), bound "
                  f"{max(t_bytes, t_ops):.6f} ms", flush=True)
    table_edge_checks(rng)
    scatter_set_edge_checks(rng)
    table_sync_check(rng)
    return rows


def build_cluster(mock, seeded_mock_ids):
    nodes = []
    with seeded_mock_ids(SEED):
        for i in range(MAIN_NODES):
            node = mock.node()
            node.name = f"node-{i}"
            node.meta["rack"] = f"r{i % RACKS}"
            # every node runs the CSI plugin the steady-state volume uses
            node.attributes["csi.plugin.p1"] = "1"
            node.compute_class()
            nodes.append(node)
    return nodes


def main_path_jobs(mock, models):
    with mock.seeded_mock_ids(SEED + 1):
        service = mock.job()
        batch = mock.batch_job()
        spread = mock.job()
    batch.task_groups[0].count = 10_000
    spread.id = "spread-affinity"
    spread.name = spread.id
    spread.spreads = [models.Spread(
        attribute="${meta.rack}", weight=60,
        spread_target=[models.SpreadTarget(value="r1", percent=30),
                       models.SpreadTarget(value="r2", percent=20)])]
    spread.affinities = [models.Affinity(
        ltarget="${meta.rack}", rtarget="r3", operand="=", weight=40)]
    spread.task_groups[0].count = 200
    return [("service", service, "chunked"), ("batch", batch, "kway"),
            ("service", spread, "scan")]


def run_main_path(device, jobs, nodes):
    import copy
    import torch
    from nomad_tpu_torch import models
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.utils.ids import generate_uuid
    h = Harness(device=device)
    for node in nodes:
        h.store.upsert_node(h.next_index(), copy.deepcopy(node))
    names = {node.id: node.name for node in nodes}
    placements, walls, launched = [], [], []
    for kind, job, arm in jobs:
        job = copy.deepcopy(job)
        h.store.upsert_job(h.next_index(), job)
        ev = models.Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority,
            triggered_by=models.TRIGGER_JOB_REGISTER, job_id=job.id,
            status=models.EVAL_STATUS_PENDING, type=job.type)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        h.process(kind, ev)
        if device != "cpu":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in before})
        done = h.evals[-1]
        allocs = h.store.allocs_by_job(job.namespace, job.id)
        want = sum(tg.count for tg in job.task_groups)
        if done.status != "complete" or done.failed_tg_allocs \
                or len(allocs) != want:
            fail(f"{job.id}: status {done.status}, {len(allocs)}/{want} "
                 f"placed, failed {list(done.failed_tg_allocs)}")
        placements.append(sorted((a.name, names[a.node_id])
                                 for a in allocs))
    return placements, walls, launched, h


def steady_state_steps(mock, models, nodes):
    """E1-E8 as ("job", label, job), ("node", node) and ("volume", volume)
    steps; each "job" step is one eval."""
    import copy
    from nomad_tpu_torch.models.csi import ACCESS_MULTI_NODE_MULTI_WRITER
    with mock.seeded_mock_ids(SEED + 2):
        e1, spread, two, e5 = (mock.job() for _ in range(4))
        csi = [mock.job() for _ in range(3)]
    e1.id = e1.name = "e1-service"
    spread.id = spread.name = "e2-spread-affinity"
    spread.spreads = [models.Spread(
        attribute="${meta.rack}", weight=60,
        spread_target=[models.SpreadTarget(value="r1", percent=30),
                       models.SpreadTarget(value="r2", percent=20)])]
    spread.affinities = [models.Affinity(
        ltarget="${meta.rack}", rtarget="r3", operand="=", weight=40)]
    spread.task_groups[0].count = 200
    two.id = two.name = "e3-two-groups"
    api = copy.deepcopy(two.task_groups[0])
    api.name = "api"
    two.task_groups.append(api)
    for tg in two.task_groups:
        tg.count = 50
    update = copy.deepcopy(e1)
    update.task_groups[0].tasks[0].config = {"command": "/bin/true"}
    canary = copy.deepcopy(nodes[5])
    canary.meta["canary"] = "x"
    e5.id = e5.name = "e5-service"
    vol = models.CSIVolume(
        id="data-vol", plugin_id="p1",
        access_mode=ACCESS_MULTI_NODE_MULTI_WRITER,
        topology_node_ids=[n.id for j, n in enumerate(nodes) if j % 3])
    for i, job in enumerate(csi):
        job.id = job.name = f"e{6 + i}-csi"
        tg = job.task_groups[0]
        tg.count = 2
        for task in tg.tasks:
            task.resources.networks = []
            task.resources.cpu = 20
            task.resources.memory_mb = 32
        tg.volumes = {"vol": models.VolumeRequest(
            name="vol", type="csi", source="data-vol")}
    return [("job", "E1", e1), ("job", "E2", spread), ("job", "E3", two),
            ("job", "E4", update), ("node", canary), ("job", "E5", e5),
            ("volume", vol), ("job", "E6", csi[0]), ("job", "E7", csi[1]),
            ("job", "E8", csi[2])]


def steady_counters(h):
    from nomad_tpu_torch.scheduler import feasible_compiler
    from nomad_tpu_torch.utils import metrics
    totals = metrics.counter_totals()
    mirror = h.store.table_cache.device
    out = {k.rsplit(".", 1)[1]: totals.get(k, 0.0) for k in RESIDENT}
    out.update({k: feasible_compiler.STATS[k] for k in TOKENS})
    out.update({f"table_{k}": mirror.stats[k] for k in (
        "uploads", "folds", "scatter_rows", "overlay_rows")})
    out.update({f"feas_{k}": mirror.feas.stats[k] for k in (
        "uploads", "patch_rows", "residue_rows")})
    return out


def run_evals(h, evals, names, device, split_first=False):
    """The evals through Harness `h`: per eval its label, placements,
    wall, launches, counter deltas (steady_counters), the mesh table's
    uploads during it and the rows (nodes) its job's allocs occupy; with
    `split_first`, the first eval's wall split by stage too
    (utils/stages.py)."""
    import copy
    import torch
    from nomad_tpu_torch import models
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import mesh_stats_snapshot
    from nomad_tpu_torch.utils import stages
    from nomad_tpu_torch.utils.ids import generate_uuid
    out = []
    for label, sched, job in evals:
        first = split_first and not out
        job = copy.deepcopy(job)
        h.store.upsert_job(h.next_index(), job)
        ev = models.Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority,
            triggered_by=models.TRIGGER_JOB_REGISTER, job_id=job.id,
            status=models.EVAL_STATUS_PENDING, type=job.type)
        c0, l0 = steady_counters(h), dict(kernels.LAUNCHES)
        u0 = mesh_stats_snapshot().get("reshard_uploads", 0)
        if first:
            stages.enable()
        t0 = time.perf_counter()
        h.process(sched, ev)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = None
        if first:
            split = {k: v["seconds"] for k, v in stages.snapshot().items()
                     if v["calls"]}
            stages.disable()
        c1 = steady_counters(h)
        uploads = mesh_stats_snapshot().get("reshard_uploads", 0) - u0
        done = h.evals[-1]
        allocs = h.store.allocs_by_job(job.namespace, job.id)
        live = [a for a in allocs if a.desired_status == "run"]
        want = sum(tg.count for tg in job.task_groups)
        if done.status != "complete" or done.failed_tg_allocs \
                or len(live) != want:
            fail(f"{label} {job.id} on {device}: status {done.status}, "
                 f"{len(live)}/{want} placed, failed "
                 f"{list(done.failed_tg_allocs)}")
        out.append(dict(
            label=label, job=job.id, wall=wall,
            placements=sorted((a.name, a.desired_status, names[a.node_id])
                              for a in allocs),
            launches={k: kernels.LAUNCHES[k] - l0[k] for k in l0
                      if kernels.LAUNCHES[k] != l0[k]},
            counters={k: c1[k] - c0[k] for k in c1},
            mesh_uploads=uploads, rows=len({a.node_id for a in allocs}),
            stages=split))
    return out


def run_steady_state(device, steps, nodes, mesh=False):
    """One Harness over the nodes runs the steps. Returns, per eval, its
    label, placements, wall, launches and counter deltas (run_evals); and
    the mirror (with `mesh`, the mesh table) checked against the host
    table row for row at the end."""
    import copy
    from nomad_tpu_torch.scheduler.harness import Harness
    h = Harness(device=device)
    for node in nodes:
        h.store.upsert_node(h.next_index(), copy.deepcopy(node))
    names = {node.id: node.name for node in nodes}
    evals = []
    for step in steps:
        if step[0] == "node":
            h.store.upsert_node(h.next_index(), copy.deepcopy(step[1]))
            continue
        if step[0] == "volume":
            h.store.upsert_csi_volumes(h.next_index(),
                                       [copy.deepcopy(step[1])])
            continue
        _kind, label, job = step
        evals += run_evals(h, [(label, "service", job)], names, device)
    served_table_matches(h.store, f"steady state on {device}",
                         "mesh table" if mesh else "mirror")
    return evals


def served_table_matches(store, where, what):
    """The table that serves the store's latest snapshot, the mirror
    (`what` "mirror") or the mesh table ("mesh table"), equal to the host
    table row for row."""
    import torch
    t = store.snapshot().node_table()
    if what == "mirror":
        st = t.device_mirror.arrays_for(t, store.table_cache.device.device)
    else:
        from nomad_tpu_torch.ops.select import get_shared_sharded
        st = get_shared_sharded().resident.arrays_for(t)
    if st is None:
        fail(f"{where}: the {what} does not serve the latest table")
    for name, col, host in (("capacity", st.capacity, t.capacity),
                            ("used", st.used, t.base_used),
                            ("free_ports", st.free_ports, t.free_ports)):
        if not torch.equal(col[:t.n].cpu(), torch.from_numpy(host)):
            fail(f"{where}: the {what}'s {name} differs from the host "
                 f"table")


def steady_state_phase(nodes, mock, models):
    """The E1-E8 sequence on the card and on the CPU; fails unless the
    card's run is served by the resident table throughout and places as
    the CPU does."""
    from nomad_tpu_torch.ops import kernels
    steps = steady_state_steps(mock, models, nodes)
    kernels.reset_launches()
    gpu = run_steady_state("cuda", steps, nodes)
    launches = dict(kernels.LAUNCHES)
    cpu = run_steady_state("cpu", steps, nodes)
    for name in TABLE_KERNELS:
        if launches[name] < 1:
            fail(f"steady state never launched the {name} kernel")
    for g, c in zip(gpu, cpu):
        if g["placements"] != c["placements"]:
            diff = [x for x in g["placements"]
                    if x not in c["placements"]][:3]
            fail(f"{g['label']}: card and CPU placements differ, e.g. "
                 f"{diff}")
    after = {k: sum(e["counters"][k] for e in gpu[1:])
             for k in gpu[0]["counters"]}
    if after["resident_fallback"] != 0 \
            or after["resident_dispatch"] != after["dispatches"]:
        fail(f"after E1, {after['resident_dispatch']:.0f} of "
             f"{after['dispatches']:.0f} dispatches were resident, "
             f"{after['resident_fallback']:.0f} fell back")
    csi = {k: sum(e["counters"][k] for e in gpu[5:8])
           for k in ("token_survivals", "token_invalidations")}
    if csi["token_survivals"] < 3 or csi["token_invalidations"] != 0:
        fail(f"E6-E8 feasibility tokens: {csi}")
    for g, c in zip(gpu, cpu):
        print(f"steady state {g['label']} {g['job']}: {g['wall']:.3f} s on "
              f"the card, {c['wall']:.3f} s with plain versions on the CPU; "
              f"launches {g['launches']}; counters {g['counters']}",
              flush=True)
    print(f"steady state: placements identical, mirror equal to the host "
          f"table, launches {launches}", flush=True)
    return launches, gpu


def lane_batch(kind, counts, seed, variant=""):
    """Field dicts of len(counts) lanes over lane 0's capacity table, each
    lane from its own seed (its usage kept as a fraction of the shared
    capacity). variant "one_spread": one spread stanza and no
    distinct_property, as the main path's spread job; "mixed": lane i keeps
    i % 3 spread stanzas and i % 2 distinct_property constraints, so the
    batch's s_live / p_live exceed most lanes' own; "none_feasible_last":
    the last lane has no feasible row."""
    lanes = [request_arrays(seed + i, MAIN_NODES, c, kind)
             for i, c in enumerate(counts)]
    cap = lanes[0]["capacity"]
    for i, f in enumerate(lanes):
        frac = f["used"][:, :1] / f["capacity"][:, :1]
        used = (cap * frac).astype(np.float32)
        used[:, 2:] = 0.0
        f["capacity"], f["used"] = cap, used
        if variant == "one_spread":
            f["spreads"], f["distinct_props"] = f["spreads"][:1], []
        elif variant == "mixed":
            f["spreads"] = f["spreads"][:i % 3]
            f["distinct_props"] = f["distinct_props"][:i % 2]
        elif variant == "none_feasible_last" and i == len(lanes) - 1:
            f["feasible"] = np.zeros(MAIN_NODES, bool)
        if kind == "scan":
            f["sum_spread_weights"] = sum(sp["weight"] for sp in f["spreads"])
    return lanes


def lane_bound(kind, lane, carry, outs, n, n_pad, steps, kw, nspread, ndp,
               full=False):
    """(bytes, float32 ops, float64 ops) of one lane's launch, its inputs
    without the shared capacity; `full` as scan_ops takes it."""
    max_steps = kw.get("max_steps")
    nbytes = (rows_bytes([v for k, v in lane.items() if k != "capacity"], n,
                         n_pad)
              + rows_bytes(carry, n, n_pad)
              + rows_bytes(outs, n, n_pad, steps, max_steps))
    if kind.startswith("scan"):
        return (nbytes,) + scan_ops(outs, n, kw["k_steps"], nspread, ndp,
                                    carry[6].shape[-1], full)
    return (nbytes,) + greedy_ops(kind, outs, n, steps, kw.get("w", 1))


def scan_ops(outs, n, k_steps, nspread, ndp, c_axis, full=False):
    """(float32, float64) operations a scan launch needs for the outputs
    this run's data gave. A step changes the node-local state of its
    winner's row only, so the node-local terms are needed once a row a
    launch and once more a placement (the winner's row rescored), their
    two powers only where a row is live at step 0 (feasible, fitting and
    admitted: ok_count[0]; no other row ever is) and at each placement.
    The spread and distinct_property terms depend on a row only through
    its codes, so each step up to and including the first invalid one
    (every later step repeats it) needs them once a code (c_axis codes a
    stanza or constraint), and a live row only its stanzas' adds and its
    score composed and compared. With `full`, the count before that:
    every term of every row at every one of the k_steps steps."""
    if full:
        f32 = k_steps * n * (F32_OPS_LOCAL + F32_OPS_SPREAD * nspread
                             + F32_OPS_DP * ndp)
        return f32, k_steps * n * F64_OPS_POW
    choice = outs[0].cpu().numpy().reshape(-1)
    bad = np.nonzero(choice < 0)[0]
    steps = int(bad[0]) + 1 if len(bad) else k_steps
    placed = int((choice >= 0).sum())
    live = max(int(outs[12].reshape(-1)[0]), 0)
    f32 = ((n + placed) * F32_OPS_NODE
           + steps * c_axis * (F32_OPS_SPREAD * nspread + F32_OPS_DP * ndp)
           + steps * live * (nspread + F32_OPS_COMPOSE))
    return f32, (live + placed) * F64_OPS_POW


def greedy_ops(kind, outs, n, steps, w):
    """(float32, float64) operations a chunked or K-way launch needs for
    the outputs this run's data gave, counted from its chunks. Scores are
    node-local, so the launch needs one sweep over the n rows, then only
    the rows a step placed on (chunk > 0) rescored for the next step, and
    one more sweep where a later step found no feasible row (for its
    counts). Each winner's sub-placement stream needs at least its chunk's
    scores (it stops at its first loser or a_max), so the streams add the
    instances placed. Each step also selects its top scores over n."""
    if steps == 0:
        return 0, 0
    if kind.startswith("kway"):
        chunks = outs[0][:steps, w:2 * w]
    else:
        chunks = outs[1][:steps].reshape(steps, 1)
    chunks = chunks.cpu().numpy()
    sweeps = 2 if steps > 1 and chunks[-1].sum() == 0 else 1
    cells = sweeps * n + int((chunks[:-1] > 0).sum()) + int(chunks.sum())
    return (cells * F32_OPS_LOCAL + steps * n * F32_OPS_SELECT,
            cells * F64_OPS_POW)


def batched_kernel_phase(device):
    """Each batched kernel against its plain version and, lane by lane,
    against the solo kernel on that lane's request, exactly, at 10,000
    nodes; timed with B solo launches and the plain version."""
    import torch
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel(device)
    n, n_pad = MAIN_NODES, S._pad_n(MAIN_NODES)
    # (kernel, lane counts, whether this is the main path's shape, variant)
    cases = [("chunked_batched", [10] * 8, True, ""),
             ("chunked_batched", [10] * 2, False, ""),
             ("chunked_batched", [10] * 16, False, ""),
             ("chunked_batched", [512] * 8, False, ""),
             ("scan_batched", [200] * 4, True, "one_spread"),
             ("scan_batched", [16 + 3 * i for i in range(16)], False,
              "mixed"),
             ("kway_batched", [2500] * 4, True, ""),
             ("kway_batched", [10, 2500, 10_000, 2500], False,
              "none_feasible_last")]
    rows = []
    for case, (kind, counts, main, variant) in enumerate(cases):
        base = kind[:-len("_batched")]
        fields = lane_batch(base, counts, SEED + 100 * (case + 1), variant)
        packs, s_live, p_live = [], 0, 0
        for f in fields:
            args, st = S.pack_request(select_request_from_arrays(f), n_pad)
            packs.append(args)
            s_live, p_live = max(s_live, st["s_live"]), max(p_live,
                                                            st["p_live"])
        spread_alg = st["spread_alg"]
        if kind == "scan_batched":
            names = S._SCAN_ARGS
            kw = dict(k_steps=S._bucket_k(max(counts)), spread_alg=spread_alg,
                      s_live=s_live, p_live=p_live)
        elif kind == "kway_batched":
            names = S._CHUNKED_ARGS
            w = S._kway_w(n_pad)
            kw = dict(max_steps=S._kway_steps(w), spread_alg=spread_alg, w=w)
        else:
            names = S._CHUNKED_ARGS
            kw = dict(max_steps=64 if max(counts) <= 64 else 512,
                      spread_alg=spread_alg)
        run = getattr(kernels, "select_" + kind)
        plain = getattr(kernels, base + "_batched_plain")
        solo = getattr(kernels, "select_" + base)
        targs = sk._tensors(S.SelectKernel._stack_lanes(packs, names), names)
        lanes = [kernels.lane_args(targs, i) for i in range(len(counts))]
        label = f"{kind} n={n} lanes={len(counts)} counts={min(counts)}-" \
                f"{max(counts)}"
        got = run(**targs, **kw)
        torch.cuda.synchronize()
        want = plain(**targs, **kw)
        err = max(compare(f"{label} carry vs plain", got[0], want[0], 0.0),
                  compare(f"{label} outputs vs plain", got[1], want[1], 0.0))
        nbytes = rows_bytes([targs["capacity"]], n, n_pad)
        f32 = f64 = 0
        full = np.zeros(3)   # the scan's bound over every step and row
        most = 0
        for i, lane in enumerate(lanes):
            s_carry, s_outs = solo(**lane, **kw)
            g_carry = [t[i] for t in got[0]]
            g_outs = [t[i] for t in got[1]]
            err = max(err, compare(f"{label} lane {i} carry vs solo",
                                   g_carry, s_carry, 0.0),
                      compare(f"{label} lane {i} outputs vs solo", g_outs,
                              s_outs, 0.0))
            if kind == "scan_batched":
                steps = kw["k_steps"]
            elif kind == "kway_batched":
                steps = int(g_outs[0][0, -1])
            else:
                steps = int(g_outs[7])
            nspread = len(fields[i].get("spreads", ()))
            ndp = len(fields[i].get("distinct_props", ()))
            b, o32, o64 = lane_bound(kind, lane, g_carry, g_outs, n, n_pad,
                                     steps, kw, nspread, ndp)
            nbytes, f32, f64 = nbytes + b, f32 + o32, f64 + o64
            if kind == "scan_batched":
                full += np.array(lane_bound(kind, lane, g_carry, g_outs, n,
                                            n_pad, steps, kw, nspread, ndp,
                                            full=True))
            most = max(most, steps)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: run(**targs, **kw))
        solo_ms = cuda_ms(lambda: [solo(**ln, **kw) for ln in lanes])
        plain_ms = cuda_ms(lambda: plain(**targs, **kw), reps=3)
        b_ms, by = bound_of(nbytes, f32, f64)
        row = dict(kind=kind, n=n, lanes=len(counts),
                   counts=[min(counts), max(counts)], main=main,
                   max_abs_err=err, ms=ms, solo_ms=solo_ms,
                   plain_ms=plain_ms, steps=most,
                   us_per_step=ms / max(most, 1) * 1e3, bound_ms=b_ms,
                   bound_by=by)
        extra = ""
        if kind == "scan_batched":
            row["steps_run"] = scan_steps_run(got[1][0], kw["k_steps"])
            row["bound_full_ms"] = bound_of(
                full[0] + rows_bytes([targs["capacity"]], n, n_pad),
                full[1], full[2])[0]
            extra = (f"; {row['steps_run']} steps run in the longest lane, "
                     f"{ms / row['steps_run'] * 1e3:.1f} us each; bound over "
                     f"every step and row {row['bound_full_ms']:.6f} ms")
        rows.append(row)
        print(f"kernel {label}{' ' + variant if variant else ''}: every "
              f"lane equals the plain version and the solo kernel (max abs "
              f"err {err:.3g}); {ms:.3f} ms ({most} steps in the longest "
              f"lane, {ms / max(most, 1) * 1e3:.1f} us a step), "
              f"{len(counts)} solo launches {solo_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms{extra}", flush=True)
        if kind == "kway_batched" and main:
            kway_continuations(targs, kw, run, plain, label)
    rows.append(chunked_mixed_lanes())
    return rows


def chunked_mixed_lanes():
    """The batched chunked kernel on CHUNKED_LANES (eight lanes of counts
    1-512 over one table of 10,000 rows, one that runs dry and one with
    no feasible row), binpack and spread: equal to the batched plain
    version and to each lane's solo kernel, exactly; the binpack launch
    timed. Returns its row."""
    import torch
    from nomad_tpu_torch.mock.chunked_edges import (CHUNKED_LANES,
                                                    chunked_lanes)
    from nomad_tpu_torch.ops import kernels
    n = MAIN_NODES
    targs = _card(chunked_lanes(n, CHUNKED_LANES, SEED + 70))
    label = f"chunked_batched n={n} mixed lanes {len(CHUNKED_LANES)}"
    row = None
    for spread_alg in (True, False):
        kw = dict(max_steps=512, spread_alg=spread_alg)
        got = kernels.select_chunked_batched(**targs, **kw)
        torch.cuda.synchronize()
        want = kernels.chunked_batched_plain(**targs, **kw)
        err = max(compare(f"{label} carry vs plain", got[0], want[0], 0.0),
                  compare(f"{label} outputs vs plain", got[1], want[1],
                          0.0))
        for i in range(len(CHUNKED_LANES)):
            s_carry, s_outs = kernels.select_chunked(
                **kernels.lane_args(targs, i), **kw)
            err = max(err, compare(f"{label} lane {i} vs solo",
                                   [t[i] for t in got[0] + got[1]],
                                   list(s_carry) + list(s_outs), 0.0))
        if int(got[1][6][2]) <= 0:
            fail(f"{label}: lane 2 did not run dry")
        steps = [int(s) for s in got[1][7]]
        ms = cuda_ms(lambda: kernels.select_chunked_batched(**targs, **kw))
        row = dict(kind="chunked_batched", n=n, lanes=len(CHUNKED_LANES),
                   counts=[1, 512], main=False, variant="mixed",
                   spread_alg=spread_alg, max_abs_err=err, ms=ms,
                   steps=max(steps), us_per_step=ms / max(steps) * 1e3)
        print(f"kernel {label} (spread_alg {spread_alg}): every lane equals "
              f"the plain version and the solo kernel; steps a lane "
              f"{steps}; {ms:.3f} ms", flush=True)
    return row


def kway_continuations(targs, kw, run, plain, label, shards=None):
    """A batched K-way launch (over `shards` shards when given) with an
    8-phase budget leaves every lane short; each lane continues on the
    single-card solo kernel from its carry on the card, launch after launch
    until its count drains, as SelectKernel.select_many continues it, every
    launch held against the plain version from the same carry."""
    import torch
    from nomad_tpu_torch.ops import kernels, select as S
    short = dict(kw, max_steps=8)
    if shards is not None:
        short["shards"] = shards
    got = run(**targs, **short)
    torch.cuda.synchronize()
    want = plain(**targs, **short)
    compare(f"{label} 8-phase carry", got[0], want[0], 0.0)
    compare(f"{label} 8-phase outputs", got[1], want[1], 0.0)
    trail = []
    for i in range(got[0][0].shape[0]):
        rem = int(got[1][0][i, 0, -2])
        if rem <= 0:
            fail(f"{label}: lane {i} finished in 8 phases; nothing continues")
        lane = S.SelectKernel._lane_carry(targs, got[0], i, rem)
        _err, steps = held_launches("kway", f"{label} lane {i} continuation",
                                    kernels.select_kway, kernels.kway_plain,
                                    lane, kw, rem)
        trail.append((rem, steps))
    print(f"kernel {label}: every lane continued from the batched carry "
          f"after 8 phases on the single-card solo kernel, every launch "
          f"equal to the plain version (left, then (phases, left) a "
          f"launch): {trail}", flush=True)


def gateway_groups(mock, models):
    """(label, scheduler, jobs, batched kernel, gateway) of the four
    gateway groups."""
    with mock.seeded_mock_ids(SEED + 3):
        service = [mock.job() for _ in range(8)]
        spread = [mock.job() for _ in range(4)]
        batch = [mock.batch_job() for _ in range(4)]
        micro = [mock.job() for _ in range(8)]
    for tag, jobs in (("service", service), ("spread", spread),
                      ("batch", batch), ("micro", micro)):
        for i, job in enumerate(jobs):
            job.id = job.name = f"gw-{tag}-{i}"
    for job in spread:
        job.spreads = [models.Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[models.SpreadTarget(value="r1", percent=30),
                           models.SpreadTarget(value="r2", percent=20)])]
        job.affinities = [models.Affinity(
            ltarget="${meta.rack}", rtarget="r3", operand="=", weight=40)]
        job.task_groups[0].count = 200
    for job in batch:
        job.task_groups[0].count = 2500
    return [("group 1", "service", service, "chunked_batched", "batch"),
            ("group 2", "service", spread, "scan_batched", "batch"),
            ("group 3", "batch", batch, "kway_batched", "batch"),
            ("group 1 micro", "service", micro, "chunked_batched", "micro")]


def run_gateways(device, groups, nodes):
    """Every group's evals as concurrent lanes on ONE snapshot of the
    nodes, through the group's gateway. Returns per group its wall, the
    gateway's stats and window, launches and placements."""
    import copy
    import threading
    import torch
    from nomad_tpu_torch import models
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import SelectKernel, calibrate_cost_model
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.server import BatchGateway, MicroBatchGateway
    h = Harness(device=device)
    for node in nodes:
        h.store.upsert_node(h.next_index(), copy.deepcopy(node))
    evals = {}
    for _label, _sched, jobs, _arm, _gw in groups:
        for job in jobs:
            job = copy.deepcopy(job)
            h.store.upsert_job(h.next_index(), job)
            evals[job.id] = models.Evaluation(
                id=f"ev-{job.id}", namespace=job.namespace,
                priority=job.priority,
                triggered_by=models.TRIGGER_JOB_REGISTER, job_id=job.id,
                status=models.EVAL_STATUS_PENDING, type=job.type)
    snap = h.store.snapshot()
    names = {node.id: node.name for node in nodes}
    kernel = SelectKernel(device)
    out = []
    for label, sched_name, jobs, _arm, kind in groups:
        calib = None
        if kind == "batch":
            gw = BatchGateway(kernel, lanes=len(jobs), partition=False)
            window = gw.window_s
            gw.window_s = 60.0       # fire at full width
        else:
            calib = calibrate_cost_model(MAIN_NODES, kernel=kernel)
            gw = MicroBatchGateway(kernel=kernel, partition=False)
            window = gw.window_s()
        errors = []

        def lane(job):
            try:
                sched = new_scheduler(sched_name, snap, h)
                sched.kernel_dispatch = gw.dispatch
                sched.process(copy.deepcopy(evals[job.id]))
            except Exception as e:
                errors.append(f"{job.id}: {e!r}")
            finally:
                if kind == "batch":
                    gw.lane_finished()

        threads = [threading.Thread(target=lane, args=(job,))
                   for job in jobs]
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if errors:
            fail(f"{label} on {device}: {errors[:3]}")
        done = {e.job_id: e for e in h.evals}
        placements = []
        for job in jobs:
            allocs = h.store.allocs_by_job(job.namespace, job.id)
            ev = done.get(job.id)
            if ev is None or ev.status != "complete" or ev.failed_tg_allocs \
                    or len(allocs) != job.task_groups[0].count:
                fail(f"{label} {job.id} on {device}: "
                     f"{len(allocs)}/{job.task_groups[0].count} placed, "
                     f"eval {ev.status if ev else None}")
            placements.append(sorted((a.name, names[a.node_id])
                                     for a in allocs))
        if gw.stats["lanes_sum"] < len(jobs) or (
                kind == "batch" and gw.stats["batches"] < 1):
            fail(f"{label} on {device}: the gateway served "
                 f"{gw.stats['lanes_sum']} of {len(jobs)} lanes "
                 f"({gw.stats})")
        out.append(dict(label=label, wall=wall, stats=dict(gw.stats),
                        window_s=window, calibration=calib,
                        launches={k: kernels.LAUNCHES[k] - before[k]
                                  for k in before
                                  if kernels.LAUNCHES[k] != before[k]},
                        placements=placements))
    return out


def gateway_phase(nodes, mock, models):
    """The gateway groups on the card and on the CPU; fails unless they
    place identically and each batched kernel launched on the card."""
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import (_pad_n, cost_model,
                                            cuda_roundtrip_s)
    groups = gateway_groups(mock, models)
    kernels.reset_launches()
    gpu = run_gateways("cuda", groups, nodes)
    launches = dict(kernels.LAUNCHES)
    cpu = run_gateways("cpu", groups, nodes)
    for name in BATCHED:
        if launches[name] < 1:
            fail(f"the gateway groups never launched the {name} kernel")
    for g, c in zip(gpu, cpu):
        if g["placements"] != c["placements"]:
            fail(f"{g['label']}: card and CPU placements differ")
    rtt = cuda_roundtrip_s()
    print(f"gateways: measured host-card round trip {rtt * 1e6:.1f} us; "
          f"BatchGateway window {gpu[0]['window_s'] * 1e3:.3f} ms, "
          f"MicroBatchGateway window {gpu[3]['window_s'] * 1e3:.3f} ms on "
          f"the card", flush=True)
    for (label, _s, jobs, arm, kind), g, c in zip(groups, gpu, cpu):
        gate = "BatchGateway" if kind == "batch" else "MicroBatchGateway"
        per = [r["stats"]["lanes_sum"] / max(r["stats"]["dispatches"], 1)
               for r in (g, c)]
        print(f"gateway {label} ({len(jobs)} lanes, {gate}, {arm}): "
              f"{g['wall']:.3f} s on the card, {c['wall']:.3f} s with plain "
              f"versions on the CPU; {g['stats']['dispatches']} dispatches, "
              f"{per[0]:.2f} lanes per dispatch on the card ({per[1]:.2f} on "
              f"the CPU); launches {g['launches']}; placements identical",
              flush=True)
    n_pad = _pad_n(MAIN_NODES)
    per_lane = {k: v for k, v in cost_model.snapshot().items()
                if k.endswith(f"@{n_pad}")}
    print(f"cost model at n_pad {n_pad} (per-lane seconds, EWMA): "
          f"{json.dumps(per_lane)}", flush=True)
    return launches, gpu

def sharded_kernel_phase(device):
    """The node-sharded kernels at the main path's shapes: at MESH_SHARDS
    shards (and the scan's grid path at MESH_GRID) against their plain
    versions (every launch of the K-way loop) and the solo kernel,
    exactly, and timed beside both; at every other shard count of
    MESH_SWEEP (the scan's CLUSTER_SWEEP) and the card's most, against the
    MESH_SHARDS result on the real rows, exactly, and timed."""
    import torch
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel(device)
    n = MAIN_NODES
    rows = []
    for kind, count, seed in (("scan", 200, SEED + 4),
                              ("kway", 10_000, SEED + 5)):
        fields = request_arrays(seed, n, count, kind)
        run = getattr(kernels, f"select_{kind}_sharded")
        plain = getattr(kernels, kind + "_sharded_plain")
        solo = getattr(kernels, "select_" + kind)
        ref = None
        for shards in [MESH_SHARDS] + [
                x for x in mesh_shard_counts(device, kind + "_sharded")
                if x != MESH_SHARDS]:
            n_pad = pad_for_mesh(make_mesh(shards, device), n)
            name = scan_route(shards, n_pad // shards) if kind == "scan" \
                else "kway_sharded"
            main = shards == MESH_SHARDS or (
                name == "scan_sharded" and shards == MESH_GRID)
            req = select_request_from_arrays(fields)
            args, statics = S.pack_request(req, n_pad)
            if kind == "scan":
                targs = sk._tensors(args, S._SCAN_ARGS)
                kw = dict(k_steps=S._bucket_k(count), **statics)
            else:
                targs = sk._tensors(args, S._CHUNKED_ARGS)
                w = S._kway_w(n_pad)
                kw = dict(max_steps=S._kway_steps(w),
                          spread_alg=statics["spread_alg"], w=w)
            skw = dict(kw, shards=shards)
            label = f"{name} n={n} count={count} shards={shards}"
            got = run(**targs, **skw)
            torch.cuda.synchronize()
            row = dict(kind=name, n=n, count=count, shards=shards,
                       n_pad=n_pad, main=main)
            err = 0.0
            if main:
                err, trail = held_launches(kind, label, run, plain, targs,
                                           skw, count, single=solo)
                row.update(launches_held=len(trail),
                           plain_ms=cuda_ms(lambda: plain(**targs, **skw),
                                            reps=3))
            if ref is None:
                ref, ref_pad = got, n_pad
            else:
                # the same request at another padding: the real rows and
                # every per-step output equal the MESH_SHARDS result
                def real(ts, pad):
                    return [t[:n] if t.dim() and t.shape[0] == pad else t
                            for t in ts]
                err = max(err,
                          compare(f"{label} carry vs {MESH_SHARDS} shards",
                                  real(got[0], n_pad),
                                  real(ref[0], ref_pad), 0.0),
                          compare(f"{label} outputs vs {MESH_SHARDS} "
                                  f"shards", got[1], ref[1], 0.0))
            row["ms"] = cuda_ms(lambda: run(**targs, **skw))
            # the single-card kernel on the same padded request
            row["solo_ms"] = cuda_ms(lambda: solo(**targs, **kw))
            extra = ""
            if kind == "scan":
                steps = kw["k_steps"]
                row["steps_run"] = scan_steps_run(got[1][0], steps)
                row.update(kernels.scan_sharded_info(shards,
                                                     n_pad // shards))
                extra = (f"; {row['steps_run']} steps run, "
                         f"{row['ms'] / row['steps_run'] * 1e3:.1f} us "
                         f"each; {row['route']} path, {row['slots']} live "
                         f"slots a shard in shared memory, the card holds "
                         f"{row['max_clusters']} such clusters")
            else:
                steps = int(got[1][0][0, -1])
            nbytes, f32, f64 = lane_bound(
                name, targs, got[0], got[1], n, n_pad, steps, kw,
                len(fields.get("spreads", ())),
                len(fields.get("distinct_props", ())))
            nbytes += rows_bytes([targs["capacity"]], n, n_pad)
            b_ms, by = bound_of(nbytes, f32, f64)
            row.update(steps=steps, max_abs_err=err,
                       us_per_step=row["ms"] / max(steps, 1) * 1e3,
                       bound_ms=b_ms, bound_by=by)
            rows.append(row)
            extra += f", plain {row['plain_ms']:.3f} ms" if main else ""
            print(f"kernel {label} (n_pad {n_pad}, {steps} steps): equal "
                  f"(max abs err {err:.3g}); {row['ms']:.3f} ms "
                  f"({row['us_per_step']:.1f} us a "
                  f"{'phase' if kind == 'kway' else 'step'}), single-card "
                  f"kernel {row['solo_ms']:.3f} ms{extra}, bound "
                  f"{row['bound_ms']:.6f} ms", flush=True)
    kway_sharded_edge_checks(device)
    scan_sharded_edge_checks(device)
    return rows


def scan_shard_live(targs, st, shards):
    """The most rows live at step 0 in one shard of each lane (feasible,
    fitting and admitted: the slots a shard's sweep lists), from the plain
    sweep on the card."""
    import torch
    from nomad_tpu_torch.ops import kernels
    batched = targs["used0"].dim() == 3
    lanes = [kernels.lane_args(targs, i)
             for i in range(targs["used0"].shape[0])] if batched \
        else [targs]
    most = 0
    for a in lanes:
        a = dict(a)
        carry = (a["used0"], a["tg_coll0"], a["job_count0"],
                 torch.zeros_like(a["tg_coll0"]), a["free_ports"],
                 a["dev_slots0"], a["sp_counts0"], a["sp_present0"],
                 a["dp_counts0"])
        masked = kernels._scan_sweep(a, carry, spread_alg=st["spread_alg"],
                                     s_live=st["s_live"],
                                     p_live=st["p_live"])[0]
        live = (masked > kernels.NEG_INF / 2).view(shards, -1).sum(dim=1)
        most = max(most, int(live.max()))
    return most


def scan_sharded_edge_checks(device):
    """The sharded scan at SCAN_EDGES (one lane, binpack) and at mixed
    batched lanes at 10,000 nodes (MIXED_LANES and a lane that runs dry),
    at S 1, 2, 8, 16, 32 and the most the card holds, each table padded
    as a mesh of S shards pads it: every launch held bit for bit against
    its plain version (scan_plain(shards=)) and against the single-card
    kernel on the same padded request, on both paths (a cluster a lane up
    to 16 shards, the grid past it). Prints for each S the path, the
    clusters the card holds at once, and the most live rows of a shard
    against the live slots it keeps in shared memory; fails unless some
    shard's live rows outgrow them (so its device-memory tier ran)."""
    import torch
    from nomad_tpu_torch.mock import scan_edges as edges
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh

    def held(label, targs, st, shards, batched):
        name = scan_route(shards, targs["capacity"].shape[0] // shards,
                          batched)
        solo = "scan_batched" if batched else "scan"
        before = kernels.LAUNCHES[name]
        got = getattr(kernels, f"select_{solo}_sharded")(**targs, **st,
                                                         shards=shards)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] == before:
            fail(f"{label}: {name} was not launched")
        want = getattr(kernels, f"{solo}_sharded_plain")(**targs, **st,
                                                         shards=shards)
        single = getattr(kernels, "select_" + solo)(**targs, **st)
        for what, other in (("plain", want), ("single card", single)):
            compare(f"{label} carry vs {what}", got[0], other[0], 0.0)
            compare(f"{label} outputs vs {what}", got[1], other[1], 0.0)
        return scan_steps_run(got[1][0], st["k_steps"])

    shard_counts = sorted({1} | set(mesh_shard_counts(device,
                                                      "scan_sharded")))
    report, past = [], []
    for shards in shard_counts:
        mesh = make_mesh(shards, device)
        runs, most_live = [], 0
        for i, label in enumerate(edges.SCAN_EDGES):
            args, st = edges.edge_case(label, SEED + 80 + i)
            n = args["capacity"].shape[0]
            targs = _card(edges.pad_rows(args, pad_for_mesh(mesh, n)))
            steps = held(f"scan sharded edge {label} (shards {shards})",
                         targs, st, shards, False)
            live = scan_shard_live(targs, st, shards)
            per = targs["capacity"].shape[0] // shards
            slots = kernels.scan_sharded_info(shards, per)["slots"]
            most_live = max(most_live, live)
            if live > slots:
                past.append((label, shards, live, slots))
            runs.append((label, steps))
        n_pad = pad_for_mesh(mesh, MAIN_NODES)
        args, st = edges.mixed_lanes(MAIN_NODES, SEED + 95, dry=True,
                                     n_pad=n_pad)
        targs = _card(args)
        steps = held(f"scan_batched sharded mixed lanes (shards {shards})",
                     targs, st, shards, True)
        info = kernels.scan_sharded_info(shards, n_pad // shards)
        report.append(dict(shards=shards, path=info["route"],
                           max_clusters=info["max_clusters"],
                           slots_at_10000=info["slots"],
                           most_live_a_shard_edges=most_live,
                           mixed_lanes_steps=steps,
                           mixed_lanes_most_live_a_shard=scan_shard_live(
                               targs, st, shards),
                           edges_steps=runs))
    for r in report:
        print(f"kernel scan sharded edge shapes and mixed lanes: every "
              f"launch equal to the plain version and the single-card "
              f"kernel bit for bit: {json.dumps(r)}", flush=True)
    if not past:
        fail("scan sharded edge shapes: no shard has more live rows than "
             "its records in shared memory")
    print(f"kernel scan sharded: shards past their shared-memory slots "
          f"(label, shards, live, slots): {past}", flush=True)


def mesh_phase(device, nodes, jobs, single_places, single_walls, steps,
               single_steady):
    """The main path with the mesh set, at MESH_SHARDS shards (the sharded
    scan's cluster path) and at MESH_GRID (its grid path), and E1-E4 of
    the steady state at MESH_SHARDS; fails unless they place as the single
    card did, each main path launched its sharded kernels (the scan's of
    its route only) and no single-card placement kernel, and the mesh
    table served every dispatch after E1 from one upload. Returns the
    launches of the two main paths."""
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import mesh_stats_snapshot, set_mesh
    from nomad_tpu_torch.parallel import make_mesh
    paths = {MESH_SHARDS: ("scan_cluster", "kway_sharded"),
             MESH_GRID: ("scan_sharded", "kway_sharded")}
    out = {}
    try:
        for shards, names in paths.items():
            set_mesh(make_mesh(shards, device))
            kernels.reset_launches()
            places, walls, launched, _h = run_main_path(device, jobs,
                                                        nodes)
            launches = dict(kernels.LAUNCHES)
            out[shards] = launches
            for name in names:
                if launches[name] < 1:
                    fail(f"the main path on {shards} shards never launched "
                         f"{name}")
            other = {k: launches[k] for k in SHARDED
                     if k not in names and launches[k]}
            solo = {k: launches[k] for k in SELECT_ARMS + BATCHED
                    if launches[k]}
            if other or solo:
                fail(f"the main path on {shards} shards launched "
                     f"{other or solo}")
            for (kind, job, _arm), got, want, wall, single, ln in zip(
                    jobs, places, single_places, walls, single_walls,
                    launched):
                if got != want:
                    diff = [p for p in got if p not in want][:3]
                    fail(f"{job.id} on {shards} shards: placements differ "
                         f"from the single card's, e.g. {diff}")
                print(f"mesh main path {kind} {job.id} (count "
                      f"{job.task_groups[0].count}, launches "
                      f"{ {k: v for k, v in ln.items() if v} }): "
                      f"{wall:.3f} s on the card over {shards} shards, "
                      f"{single:.3f} s on the single-card route; "
                      f"placements identical", flush=True)
        set_mesh(make_mesh(MESH_SHARDS, device))    # a fresh mesh table
        evals = run_steady_state(device, steps[:4], nodes, mesh=True)
        stats = mesh_stats_snapshot()
    finally:
        set_mesh(None)
    if stats["reshard_uploads"] != 1:
        fail(f"E1-E4 on the mesh: {stats['reshard_uploads']} uploads")
    after = {k: sum(e["counters"][k] for e in evals[1:])
             for k in evals[0]["counters"]}
    if after["mesh_resident_fallback"] != 0 \
            or after["mesh_resident_dispatch"] != after["dispatches"]:
        fail(f"E2-E4 on the mesh: {after['mesh_resident_dispatch']:.0f} of "
             f"{after['dispatches']:.0f} dispatches served by the mesh "
             f"table, {after['mesh_resident_fallback']:.0f} fell back")
    for g, c in zip(evals, single_steady):
        if g["placements"] != c["placements"]:
            fail(f"{g['label']} on the mesh: placements differ from the "
                 f"single card's")
        print(f"mesh steady state {g['label']} {g['job']}: {g['wall']:.3f} s "
              f"on the card over {MESH_SHARDS} shards, {c['wall']:.3f} s on "
              f"the single-card route; launches {g['launches']}", flush=True)
    print(f"mesh steady state: placements identical, one upload, mesh table "
          f"equal to the host table; {json.dumps(stats)}", flush=True)
    return out[MESH_SHARDS], out[MESH_GRID]


def batched_sharded_kernel_phase(device):
    """The batched node-sharded kernels at phase 6's main shapes, at
    MESH_SHARDS and every count of MESH_SWEEP (the scan's and the chunked
    kernels' CLUSTER_SWEEP):
    each call held exactly against its plain version and the single-card
    batched kernel on the same padded lanes; timed beside both (the plain
    version at MESH_SHARDS, and for the grid routes at MESH_GRID). The
    chunked kernels also at B 8 of count 512 and on the all-alike table
    (one lane of count 512, binpack and spread) at MESH_SHARDS, and at the
    edge shapes (chunked_sharded_edge_checks)."""
    import torch
    from nomad_tpu_torch.mock.chunked_edges import one_lane
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args, pad_rows
    from nomad_tpu_torch.ops import kernels, select as S
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from nomad_tpu_torch.state.carry import select_request_from_arrays
    sk = S.SelectKernel(device)
    n = MAIN_NODES
    rows = []
    extra = [("chunked_batched", [512] * 8, "", [MESH_SHARDS]),
             ("chunked_batched", [512], "alike binpack", [MESH_SHARDS]),
             ("chunked_batched", [512], "alike spread", [MESH_SHARDS])]
    for case, (kind, counts, variant, shard_list) in enumerate(
            [(k, c, v, None) for k, c, v in BATCHED_MAIN] + extra):
        base = kind[:-len("_batched")]
        alike = variant.startswith("alike")
        fields = [{}] if alike else lane_batch(
            base, counts, SEED + 500 + 100 * case, variant)
        run = getattr(kernels, f"select_{kind}_sharded")
        plain = getattr(kernels, f"{kind}_sharded_plain")
        single = getattr(kernels, "select_" + kind)
        most = kernels.max_shards(kind + "_sharded", device)
        for shards in shard_list or [MESH_SHARDS] + [
                x for x in mesh_shard_counts(device, kind + "_sharded")
                if x != MESH_SHARDS]:
            n_pad = pad_for_mesh(make_mesh(shards, device), n)
            name = scan_route(shards, n_pad // shards, True) \
                if base == "scan" else chunked_route(shards) \
                if base == "chunked" else kind + "_sharded"
            main = (shards == MESH_SHARDS and shard_list is None) or (
                name in GRID_ROUTE and shards == MESH_GRID)
            packs, s_live, p_live = [], 0, 0
            for f in [] if alike else fields:
                args, st = S.pack_request(select_request_from_arrays(f),
                                          n_pad)
                packs.append(args)
                s_live = max(s_live, st["s_live"])
                p_live = max(p_live, st["p_live"])
            if alike:
                kw = dict(max_steps=512, spread_alg=variant.endswith(
                    "spread"))
            elif kind == "scan_batched":
                names = S._SCAN_ARGS
                kw = dict(k_steps=S._bucket_k(max(counts)),
                          spread_alg=st["spread_alg"], s_live=s_live,
                          p_live=p_live)
            elif kind == "kway_batched":
                names = S._CHUNKED_ARGS
                w = S._kway_w(n_pad)
                kw = dict(max_steps=S._kway_steps(w),
                          spread_alg=st["spread_alg"], w=w)
            else:
                names = S._CHUNKED_ARGS
                kw = dict(max_steps=64 if max(counts) <= 64 else 512,
                          spread_alg=st["spread_alg"])
            skw = dict(kw, shards=shards)
            targs = _card(one_lane(pad_rows(kway_edge_args(
                n, 512, "alike", SEED + 60), n_pad))) if alike \
                else sk._tensors(S.SelectKernel._stack_lanes(packs, names),
                                 names)
            label = (f"{name} n={n} lanes={len(counts)} count={counts[0]} "
                     f"shards={shards}{' ' + variant if variant else ''}")
            before = kernels.LAUNCHES[name]
            got = run(**targs, **skw)
            torch.cuda.synchronize()
            launches = kernels.LAUNCHES[name] - before
            groups = 1 if name.endswith("_cluster") \
                else -(-len(counts) // (most // shards))
            if launches != groups:
                fail(f"{label}: {launches} launches, expected {groups}")
            want = plain(**targs, **skw)
            err = max(compare(f"{label} carry vs plain", got[0], want[0], 0.0),
                      compare(f"{label} outputs vs plain", got[1], want[1],
                              0.0))
            ref = single(**targs, **kw)
            err = max(err,
                      compare(f"{label} carry vs single card", got[0],
                              ref[0], 0.0),
                      compare(f"{label} outputs vs single card", got[1],
                              ref[1], 0.0))
            nbytes = rows_bytes([targs["capacity"]], n, n_pad)
            f32 = f64 = longest = handoffs = 0
            for i, f in enumerate(fields):
                lane = kernels.lane_args(targs, i)
                g_carry = [t[i] for t in got[0]]
                g_outs = [t[i] for t in got[1]]
                if kind == "scan_batched":
                    steps = kw["k_steps"]
                elif kind == "kway_batched":
                    steps = int(g_outs[0][0, -1])
                else:
                    steps = int(g_outs[7])
                    handoffs += chunk_handoffs(g_outs[0], steps,
                                               n_pad // shards)
                longest = max(longest, steps)
                b, o32, o64 = lane_bound(kind, lane, g_carry, g_outs, n,
                                         n_pad, steps, kw,
                                         len(f.get("spreads", ())),
                                         len(f.get("distinct_props", ())))
                nbytes, f32, f64 = nbytes + b, f32 + o32, f64 + o64
            torch.cuda.synchronize()
            row = dict(kind=name, n=n, n_pad=n_pad, lanes=len(counts),
                       counts=[min(counts), max(counts)], shards=shards,
                       launches_held=launches, main=main, max_blocks=most,
                       max_abs_err=err,
                       ms=cuda_ms(lambda: run(**targs, **skw)),
                       solo_ms=cuda_ms(lambda: single(**targs, **kw)))
            if variant:
                row["variant"] = variant
            if base == "chunked":
                row.update(handoffs_a_lane=handoffs / len(fields),
                           graph_ms=graph_ms(lambda: run(**targs, **skw),
                                             launches=10),
                           solo_graph_ms=graph_ms(
                               lambda: single(**targs, **kw), launches=10))
            if main:
                row["plain_ms"] = cuda_ms(lambda: plain(**targs, **skw),
                                          reps=3)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = max(f32 / FP32_OPS_PER_S, f64 / FP64_OPS_PER_S) * 1e3
            row.update(steps=longest,
                       us_per_step=row["ms"] / max(longest, 1) * 1e3,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            rows.append(row)
            extra = f", plain {row['plain_ms']:.3f} ms" if main else ""
            if kind == "scan_batched":
                row["steps_run"] = scan_steps_run(got[1][0], kw["k_steps"])
                row["route"] = kernels.scan_sharded_info(
                    shards, n_pad // shards)["route"]
                extra += (f"; {row['route']} path, {row['steps_run']} steps "
                          f"run in the longest lane, "
                          f"{row['ms'] / row['steps_run'] * 1e3:.1f} us "
                          f"each")
            if base == "chunked":
                row.update(kernels.chunked_sharded_info(shards))
                extra += (f"; {row['route']} route (the card holds "
                          f"{row['max_clusters']} such clusters), "
                          f"{row['handoffs_a_lane']:.2f} handoffs a lane; "
                          f"device {row['graph_ms']:.4f} ms, single card "
                          f"{row['solo_graph_ms']:.4f} ms")
            print(f"kernel {label} (n_pad {n_pad}, {launches} launch"
                  f"{'es' if launches > 1 else ''}, the card holds {most} "
                  f"blocks): equal to its plain version and the single-card "
                  f"batched kernel (max abs err {err:.3g}); {row['ms']:.3f} "
                  f"ms ({longest} steps in the longest lane, "
                  f"{row['us_per_step']:.1f} us a "
                  f"{'phase' if kind == 'kway_batched' else 'step'}), "
                  f"single-card batched {row['solo_ms']:.3f} ms{extra}, "
                  f"bound {row['bound_ms']:.6f} ms", flush=True)
            if kind == "kway_batched" and main:
                kway_continuations(targs, kw, run, plain, label, shards)
    chunked_sharded_edge_checks(device)
    return rows


def mesh_gateway_phase(nodes, mock, models, single_groups):
    """Phase 7's gateway groups with the mesh set at MESH_SHARDS shards, on
    a fresh store, then its chunked and scan-batched groups (groups 1 and
    2) at MESH_GRID shards (the grid routes); fails unless they place as
    the single card's groups did, launch every batched sharded kernel of
    their route and no single-card batched kernel. Returns the launches of
    the two runs."""
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import mesh_stats_snapshot, set_mesh
    from nomad_tpu_torch.parallel import make_mesh
    groups = gateway_groups(mock, models)
    runs = [(MESH_SHARDS, groups, single_groups,
             [k for k in BATCHED_SHARDED if k not in GRID_ROUTE]),
            (MESH_GRID, groups[:2], single_groups[:2], list(GRID_ROUTE))]
    out = {}
    for shards, mine, singles, names in runs:
        try:
            set_mesh(make_mesh(shards, "cuda"))
            kernels.reset_launches()
            got = run_gateways("cuda", mine, nodes)
            launches = dict(kernels.LAUNCHES)
            stats = mesh_stats_snapshot()
        finally:
            set_mesh(None)
        out[shards] = launches
        for name in names:
            if launches[name] < 1:
                fail(f"the mesh's gateway groups on {shards} shards never "
                     f"launched {name}")
        other = {k: launches[k] for k in BATCHED_SHARDED
                 if k not in names and launches[k]}
        single = {k: launches[k] for k in BATCHED if launches[k]}
        if other or single:
            fail(f"the mesh's gateway groups on {shards} shards launched "
                 f"{other or single}")
        for (label, _s, jobs, arm, kind), g, c in zip(mine, got, singles):
            if g["placements"] != c["placements"]:
                fail(f"{label} on {shards} shards: placements differ from "
                     f"the single card's")
            gate = "BatchGateway" if kind == "batch" else "MicroBatchGateway"
            name = next(k for k in names if k.startswith(arm))
            print(f"mesh gateway {label} ({len(jobs)} lanes, {gate}, "
                  f"{name} over {shards} shards): {g['wall']:.3f} s "
                  f"on the card, {c['wall']:.3f} s on the single card; "
                  f"{g['stats']['dispatches']} dispatches; launches "
                  f"{g['launches']}; placements identical", flush=True)
        print(f"mesh gateways on {shards} shards: launches "
              f"{ {k: v for k, v in launches.items() if v} }; mesh table "
              f"{json.dumps(stats)}", flush=True)
    return out[MESH_SHARDS], out[MESH_GRID]


def cold_evals(jobs, steps):
    """The cold-start phase's evals as (label, scheduler, job): the main
    path's three jobs again under new ids, then E1-E4."""
    import copy
    out = []
    for kind, job, arm in jobs:
        job = copy.deepcopy(job)
        job.id = f"{job.id}-again"
        out.append((f"{arm} again", kind, job))
    out += [(label, "service", job) for _k, label, job in steps[:4]]
    return out


def restore_primed(blob, device):
    """The cold-start pipeline up to the first eval: unpack, restore,
    prime from the decoded alloc columns, and prefetch the device mirror
    (and the mesh table, with a mesh set) on a thread. Returns the store
    and the seconds of each stage."""
    import msgpack
    import torch
    from nomad_tpu_torch.ops.tables import PrefetchThread
    from nomad_tpu_torch.state import StateStore
    secs = {}
    t0 = time.perf_counter()
    data = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    secs["unpack"] = time.perf_counter() - t0
    store = StateStore()
    t0 = time.perf_counter()
    store.restore(data)
    secs["restore"] = time.perf_counter() - t0
    cache = store.table_cache
    t0 = time.perf_counter()
    cache.prime(store.snapshot(), store.pop_cold_columns())
    secs["prime"] = time.perf_counter() - t0
    thread = PrefetchThread(cache, device)
    t0 = time.perf_counter()
    thread.start()
    thread.join(timeout=300)
    if thread.is_alive():
        fail(f"cold start on {device}: prefetch_device did not end")
    if device != "cpu":
        torch.cuda.synchronize()
    secs["prefetch_device"] = time.perf_counter() - t0
    if cache.device.stats["uploads"] != 1 or \
            cache.device.device != torch.device(device):
        fail(f"cold start on {device}: the prefetch left the mirror "
             f"{cache.device.snapshot()} on {cache.device.device}")
    return store, secs


def cold_store_checks(store, evals, device, what):
    """No full table build, one upload (the prefetch's), and every
    dispatch from the first served by the mirror (`what` "mirror") or the
    mesh table ("mesh table"); the table it serves equal to the host
    table row for row at the end."""
    cache = store.table_cache
    if cache.stats["full_builds"] != 0 or cache.stats.get("primes") != 1:
        fail(f"cold start on {device} ({what}): table cache {cache.stats}")
    tot = {k: sum(e["counters"][k] for e in evals)
           for k in evals[0]["counters"]}
    key = "resident" if what == "mirror" else "mesh_resident"
    if tot[f"{key}_fallback"] != 0 or tot["dispatches"] < len(evals) \
            or tot[f"{key}_dispatch"] != tot["dispatches"]:
        fail(f"cold start on {device}: {tot[f'{key}_dispatch']:.0f} of "
             f"{tot['dispatches']:.0f} dispatches served by the {what}, "
             f"{tot[f'{key}_fallback']:.0f} fell back")
    if what == "mirror" and cache.device.stats["uploads"] != 1:
        fail(f"cold start on {device}: the mirror was uploaded "
             f"{cache.device.stats['uploads']} times")
    served_table_matches(store, f"cold start on {device}", what)
    return tot


def same_placements(got, want, what):
    for g, w in zip(got, want):
        if g["placements"] != w["placements"]:
            diff = [x for x in g["placements"]
                    if x not in w["placements"]][:3]
            fail(f"cold start {g['label']}: {what} differ, e.g. {diff}")


def cold_start_phase(warm, nodes, jobs, steps, info):
    """Phase 10 (see the module's docstring). `warm` is the main path's
    Harness on the card after its three evals. Returns the launches of
    the restored store's run on the card and of its run on the mesh."""
    import msgpack
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops.select import mesh_stats_snapshot, set_mesh
    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.scheduler.harness import Harness
    names = {node.id: node.name for node in nodes}
    evals = cold_evals(jobs, steps)
    held = (len(warm.store.nodes()), len(warm.store.allocs()),
            len(warm.store.evals()))
    t0 = time.perf_counter()
    data = warm.store.dump_columnar()
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = msgpack.packb(data, use_bin_type=True)
    pack_s = time.perf_counter() - t0
    del data

    kernels.reset_launches()
    store, secs = restore_primed(blob, "cuda")
    cold = run_evals(Harness(store, device="cuda"), evals, names, "cuda",
                     split_first=True)
    launches = dict(kernels.LAUNCHES)
    tot = cold_store_checks(store, cold, "cuda", "mirror")
    for name in SELECT_ARMS + ("scatter_set", "overlay_add"):
        if launches[name] < 1:
            fail(f"cold start never launched the {name} kernel")
    warm_run = run_evals(warm, evals, names, "cuda", split_first=True)
    same_placements(cold, warm_run, "the restored and never-dumped "
                    "stores' placements")
    cpu_store, _ = restore_primed(blob, "cpu")
    cpu = run_evals(Harness(cpu_store, device="cpu"), evals, names, "cpu")
    cold_store_checks(cpu_store, cpu, "cpu", "mirror")
    same_placements(cold, cpu, "the card's and the CPU's placements")
    for c, w, h in zip(cold, warm_run, cpu):
        print(f"cold start {c['label']} {c['job']}: {c['wall']:.3f} s on "
              f"the card after the restore, {w['wall']:.3f} s on the "
              f"never-dumped store, {h['wall']:.3f} s with plain versions "
              f"on the CPU; launches {c['launches']}", flush=True)

    try:
        set_mesh(make_mesh(MESH_SHARDS, "cuda"))
        kernels.reset_launches()
        mesh_store, mesh_secs = restore_primed(blob, "cuda")
        before = mesh_stats_snapshot()
        mesh = run_evals(Harness(mesh_store, device="cuda"), evals, names,
                         "cuda")
        mesh_launches = dict(kernels.LAUNCHES)
        after = mesh_stats_snapshot()
        mesh_tot = cold_store_checks(mesh_store, mesh, "cuda",
                                     "mesh table")
    finally:
        set_mesh(None)
    # the prefetch made the mesh table's upload before the first eval,
    # whose dispatch found it resident; a later upload is only the
    # journal's wide-delta path, taken at the dispatch after an eval whose
    # plan changed more than SPARSE_MAX_FRAC of the rows (one contiguous
    # upload instead of a scatter of most of the table), never a per-eval
    # re-put
    wide = [m["label"] for m in mesh
            if m["rows"] > SPARSE_MAX_FRAC * len(nodes)]
    if before["reshard_uploads"] != 1 or mesh[0]["mesh_uploads"] != 0 \
            or after["journal_gaps"] != 0 or any(
                m["mesh_uploads"] > (p["label"] in wide)
                for p, m in zip(mesh, mesh[1:])):
        fail(f"cold start on the mesh: {before['reshard_uploads']} mesh "
             f"table uploads before the first eval, then "
             f"{[(m['label'], m['mesh_uploads']) for m in mesh]} (wide "
             f"deltas: {wide}), {after['journal_gaps']} journal gaps")
    for name in ("scan_cluster", "kway_sharded"):
        if mesh_launches[name] < 1:
            fail(f"cold start on the mesh never launched {name}")
    solo = {k: mesh_launches[k] for k in SELECT_ARMS + BATCHED
            if mesh_launches[k]}
    if solo:
        fail(f"cold start on the mesh launched {solo}")
    same_placements(mesh, cold, "the mesh's and the single card's "
                    "placements")
    for m, c in zip(mesh, cold):
        print(f"cold start mesh {m['label']} {m['job']}: {m['wall']:.3f} s "
              f"on the card over {MESH_SHARDS} shards after the restore, "
              f"{c['wall']:.3f} s on the single card; launches "
              f"{m['launches']}", flush=True)
    print(f"cold start: snapshot {len(blob)} bytes ({held[0]} nodes, "
          f"{held[1]} allocs, {held[2]} evals); dump_columnar "
          f"{dump_s:.3f} s, msgpack "
          f"pack {pack_s:.3f} s, unpack {secs['unpack']:.3f} s, restore "
          f"{secs['restore']:.3f} s, prime {secs['prime']:.3f} s, "
          f"prefetch_device {secs['prefetch_device']:.3f} s (on the mesh: "
          f"restore {mesh_secs['restore']:.3f} s, prime "
          f"{mesh_secs['prime']:.3f} s, prefetch_device "
          f"{mesh_secs['prefetch_device']:.3f} s); first eval after the "
          f"restore {cold[0]['wall']:.3f} s against the never-dumped "
          f"store's {warm_run[0]['wall']:.3f} s (by stage, s: "
          f"{cold[0]['stages']} against {warm_run[0]['stages']}); "
          f"{tot['dispatches']:.0f} "
          f"dispatches all resident ({mesh_tot['dispatches']:.0f} on the "
          f"mesh), no full table build, one mirror upload, the mesh "
          f"table's first upload the prefetch's ("
          f"{after['reshard_uploads']} in all, "
          f"{after['reshard_uploads'] - 1} by wide deltas: {wide}); card: "
          f"{info['raw']}", flush=True)
    print(f"cold start: placements identical (restored, never-dumped, CPU, "
          f"mesh); launches {launches}; mesh launches "
          f"{ {k: v for k, v in mesh_launches.items() if v} }; mesh table "
          f"{json.dumps(after)}", flush=True)
    return launches, mesh_launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from nomad_tpu_torch import mock, models
    from nomad_tpu_torch.mock import seeded_mock_ids
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.utils.platform import device_info

    info = device_info()
    print(f"device: {info['raw']} ({info['kind']}, {info['count']} visible)",
          flush=True)
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"set-up: kernels built in {time.perf_counter() - t0:.2f} s "
          f"({kernels.BUILD_INFO['path']})", flush=True)

    rows = kernel_phase("cuda")
    table_rows = table_kernel_phase()
    batched_rows = batched_kernel_phase("cuda")

    nodes = build_cluster(mock, seeded_mock_ids)
    jobs = main_path_jobs(mock, models)
    kernels.reset_launches()
    # Harness(device=None): the entry point's own default is the card
    gpu_places, gpu_walls, gpu_launched, main_h = run_main_path(
        None, jobs, nodes)
    main_launches = dict(kernels.LAUNCHES)
    for (_kind, job, arm), got in zip(jobs, gpu_launched):
        if got[arm] < 1:
            fail(f"{job.id}: the {arm} kernel was not launched ({got})")
    for arm in SELECT_ARMS:
        if main_launches[arm] < 1:
            fail(f"main path never launched the {arm} kernel")
    cpu_places, cpu_walls, _, _ = run_main_path("cpu", jobs, nodes)
    for (_kind, job, _arm), g, c in zip(jobs, gpu_places, cpu_places):
        if g != c:
            diff = [p for p in g if p not in c][:3]
            fail(f"{job.id}: card and CPU placements differ, e.g. {diff}")
    for (kind, job, arm), wall, cw, got in zip(jobs, gpu_walls, cpu_walls,
                                               gpu_launched):
        print(f"main path {kind} {job.id} "
              f"(count {job.task_groups[0].count}, {arm} kernel, "
              f"launches {got}): {wall:.3f} s on the card, {cw:.3f} s "
              f"with plain versions on the CPU; placements identical",
              flush=True)

    steady_launches, steady_gpu = steady_state_phase(nodes, mock, models)
    gateway_launches, gateway_gpu = gateway_phase(nodes, mock, models)
    sharded_rows = sharded_kernel_phase("cuda")
    mesh_launches = mesh_phase("cuda", nodes, jobs, gpu_places, gpu_walls,
                               steady_state_steps(mock, models, nodes),
                               steady_gpu)
    bs_rows = batched_sharded_kernel_phase("cuda")
    mesh_gw_launches = mesh_gateway_phase(nodes, mock, models, gateway_gpu)
    cold_launches, cold_mesh_launches = cold_start_phase(
        main_h, nodes, jobs, steady_state_steps(mock, models, nodes), info)
    # each sharded kernel's launches on its main path: the grid route's
    # kernels on the MESH_GRID mesh's, every other on MESH_SHARDS'
    grid = ("scan_sharded",) + GRID_ROUTE

    record = []
    for arm in SELECT_ARMS:
        mine = [r for r in rows if r["kind"] == arm]
        top = next(r for r in mine if r["main"])
        record.append(dict(
            name=arm, route="cuda", source=SOURCE[arm],
            replaces=REPLACES[arm],
            launches=main_launches[arm],
            cold_start_launches=cold_launches[arm],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=None,
            **({"cuda_kernels": CUDA_KERNELS[arm]} if arm in CUDA_KERNELS
               else {}),
            shapes=[{k: r[k] for k in ("n", "count", "main", "edge",
                                       "spread_alg", "steps", "steps_run",
                                       "launches_held", "ms", "us_per_step",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "max_abs_err") if k in r}
                    for r in mine]))
    for name in TABLE_KERNELS:
        mine = [r for r in table_rows if r["kind"] == name]
        top = next(r for r in mine if r["main"])
        record.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=steady_launches[name],
            cold_start_launches=cold_launches[name],
            max_abs_err=0.0, ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=top["library_ms"], kernel_ms=top["kernel_ms"],
            host_vals_ms=top["host_vals_ms"],
            library_host_ms=top["library_host_ms"],
            shapes=[{k: r[k] for k in (
                "n_pad", "m", "main", "ms", "host_vals_ms", "kernel_ms",
                "plain_ms", "library_ms", "library_host_ms",
                "library_graph_ms", "bound_ms", "bound_by",
                "bound_counts")} for r in mine]))
    for name in BATCHED:
        mine = [r for r in batched_rows if r["kind"] == name]
        top = next(r for r in mine if r["main"])
        record.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=gateway_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=None, solo_ms=top["solo_ms"],
            **({"cuda_kernels": CUDA_KERNELS[name]} if name in CUDA_KERNELS
               else {}),
            shapes=[{k: r[k] for k in (
                "n", "lanes", "counts", "main", "variant", "spread_alg",
                "steps", "steps_run", "ms", "us_per_step", "solo_ms",
                "plain_ms", "bound_ms", "bound_by", "max_abs_err") if k in r}
                for r in mine]))
    for name in SHARDED:
        mine = [r for r in sharded_rows if r["kind"] == name]
        top = next(r for r in mine if r["main"])
        record.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name],
            launches=mesh_launches[name in grid][name],
            cold_start_launches=cold_mesh_launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=None, solo_ms=top["solo_ms"], shards=top["shards"],
            shapes=[{k: r[k] for k in (
                "n", "count", "shards", "n_pad", "main", "steps",
                "steps_run", "route", "slots", "max_clusters", "ms",
                "us_per_step", "solo_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err") if k in r} for r in mine]))
    for name in BATCHED_SHARDED:
        mine = [r for r in bs_rows if r["kind"] == name]
        top = next(r for r in mine if r["main"])
        record.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name],
            launches=mesh_gw_launches[name in grid][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=None, solo_ms=top["solo_ms"], shards=top["shards"],
            max_blocks=top["max_blocks"],
            shapes=[{k: r[k] for k in (
                "n", "n_pad", "lanes", "counts", "shards", "variant",
                "launches_held", "main", "steps", "steps_run", "route",
                "max_clusters", "handoffs_a_lane", "ms", "graph_ms",
                "us_per_step",
                "solo_ms", "solo_graph_ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err") if k in r} for r in mine]))
    print(json.dumps({"kernels": record}))
    print(info["raw"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
