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
     phase; median of 7 after a warm-up) and of the plain version (median
     of 5 after a warm-up, or the one call after it where the warm-up took
     more than PLAIN_ONCE_MS; the same rule, with 3, in the later
     phases), and
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
     on the same padded request; then 32 (the scan: 16, 32) and the
     most shards the card holds at once, each held exactly against the
     8-shard result and timed (CUDA-event medians of 7; us a step or K-way
     phase, the scan's steps run, its route, the live slots a shard keeps
     in shared memory and the clusters the card holds at once), beside
     the solo kernel on the same padded request and the plain version;
     then the sharded K-way kernel at the edge shapes of phase 2 and at
     mixed batched lanes (one with no feasible row, one that runs dry) at
     8 and the most shards, each call with an 8-phase budget
     continued from the card's carry, and the sharded scan at SCAN_EDGES
     and at mixed batched lanes (MIXED_LANES and a lane that runs dry, at
     10,000 nodes) at 1, 8 and the most shards (both routes;
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
     chunked and scan grid kernels at 32), then 32 (the scan and the
     chunked kernels: 16, 32) and the most the card holds (32 shards
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
     spread) and CHUNKED_LANES (an 8-step budget) at 8 and the most
     shards (the edge checks' shard counts; the sweep's 16 and 32 run
     at the main shapes only), every launch and a
     continuation from the card's carry
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
 11. the dev-mode server (nomad_tpu_torch.server.Server): over the 10,000
     nodes (seeded into its store), 70 jobs — 64 service jobs of count 10
     (the JAX package's bench_broker_service job), 4 of the main path's
     spread job (count 200) and 2 batch jobs of count 2,500 — registered
     while the workers are paused, after one warm eval that builds the
     node table and uploads the mirror, and timed from the workers'
     resume until every job is placed; three fresh servers, each starting
     from an empty dispatch cost model calibrated at the table's shape:
     (A) one worker, no batching, no micro-batch gateway; (B) two workers
     draining 8 ready evals each into a BatchGateway; (C) two workers
     draining 8 each into the server-wide MicroBatchGateway at its default
     window; then (A) with device="cpu". Every server runs with its
     defaults, the governor, the flight recorder and the telemetry
     collector on; (A) runs once more on the card with the three off
     (governor_enabled=False, telemetry_sample_interval_s=0,
     trace_enabled=False). After (A) with them on (card and CPU): every
     completed eval has an acked trace; the kernel spans by arm equal the
     device accounting's dispatches (device_stats_snapshot) and, on the
     card, the chunked, K-way and scan launches of the run; on the card
     device_hbm_bytes() > 0 equals torch.cuda.memory_allocated, and one
     Governor.sample_once() and one TelemetryCollector.sample_once() run
     under torch.cuda.set_sync_debug_mode("error"); then the governor's
     forced node_table.delta_debt reclaim re-uploads the mirror
     (fold_device), which must equal the host table bit for bit, and two
     more service jobs follow (the second one's eval scatters the first
     one's rows: scatter_set must launch on the card). Fails unless every
     job is placed to its count with no node over capacity (recomputed
     from the store), every eval completes, (A) places every alloc on the
     same node on the card with the three on and off and on the CPU (the
     two jobs after the fold too), and (B) and (C) launched the
     chunked-batched kernel and the K-way- or scan-batched one. Printed
     per run: the warm eval,
     wall, placements/s, evals/s, eval latency p50 / p99 (broker enqueue
     -> ack), worker batches, gateway fires and lanes a fire, applier
     commits and mean group size, rejected placements, batched dispatches
     and fallbacks, launches, the per-stage seconds and the governor's
     events; for (A) the wall with the three on over the wall with them
     off, the traces, kernel spans by arm, the stage percentiles, each
     span's summed seconds as a share of the wall (the `kernel` share),
     the card's bytes in use and the fold's debt and seconds; and the
     phase's seconds. The kernels line's `server_launches` sums the card
     runs' launches.
 12. the server's restart: a server on the card with a data directory
     (server/persistence.py) takes phase 11's 70 jobs in its first life —
     the 10,000 nodes seeded into its store and a first (columnar)
     snapshot of them, the warm job, half the jobs, a second snapshot,
     the other half, then every placed alloc marked running in client
     updates of 100 allocs a WAL entry — and shuts down. Two copies of
     its directory restart a server each, on the card and with
     device="cpu", each from an empty dispatch cost model: the snapshot
     restored, the node table primed, the mirror uploaded on a
     PrefetchThread beside the WAL tail's replay and joined, the cost
     model loaded from its file. Fails unless each restored store equals
     the first life's at shutdown (jobs, allocs by id with node and
     statuses, eval statuses, the latest index), the cost model holds the
     saved shapes, and then, for a service job of count 10, the main
     path's spread job and a batch job of count 2,500 registered one
     after another: no full table build (the first eval takes the delta
     path from the snapshot's index and scatters the replayed rows onto
     the mirror, whose version moves and which equals the host table
     row for row), one mirror upload (the prefetch's), the chunked,
     K-way, scan and scatter_set kernels launched (counts set to 0 just
     before the jobs), every job placed to its count with no node over
     capacity, and placements identical on the card and the CPU. Printed:
     the WAL's entries by kind and bytes, the snapshot's bytes,
     cold_start_stats (prefetch_join_s among them), each eval's wall, the
     first eval's wall and stages against the first life's first eval,
     the cost model's shapes restored, sampled since, or live only, and
     the launches. The kernels line's `restart_launches` holds them.
 13. the 3-server ring: three Servers (one worker each, the follower
     plane at its defaults, raft_multiplier 5) in this process on the card,
     each with an RpcServer on a loopback port, joined by attach_raft with
     the full peer list. One leader elected; the 10,000 nodes registered
     through the leader's raft (32 threads); the leader's log compacted
     and one follower's needs_snapshot set, so the leader reseeds it by
     InstallSnapshot; phase 11's 70 jobs (after one warm job) registered
     through register_jobs_bulk, both followers dequeuing evals over RPC
     and scheduling on the card against their own replicas; then the
     leader's RpcServer and Server shut down and, once a new leader is
     elected, a service job of count 10 and the main path's spread job
     registered through it. Fails unless a leader is elected, every job
     is placed to its count with no node over capacity, every eval chain
     ends complete, the survivors' stores are equal (jobs, allocs by id
     with node and statuses, eval statuses, the latest index), each
     server that followed through the 70 jobs (not the leader they
     started under, nor one elected while they ran) made remote dequeues
     and plans, the reseeded follower's
     store equals the leader's with its table primed and its mirror equal
     to its host table row for row, the reseed's frame fits MAX_FRAME,
     the alloc-name manifest equals phase 11's single card server's (A),
     the chunked, K-way, scan and scatter_set kernels launched (counts set
     to 0 just before the 70 jobs, read after the failover's jobs), and
     one heartbeat timers thread runs (the new leader's). Printed: the
     election, seeding seconds, log entries and AppendEntries calls, the
     reseed's bytes and seconds, the ring's wall, placements/s and
     evals/s, remote dequeues and plans, fence-wait p99 and fence
     timeouts by follower, applier commits and mean group, rejected
     placements, ingest batches and mean size, failed evals whose work
     went on in another, the stage split, the re-election's seconds after
     the kill and the launches. The kernels line's `ring_launches` holds
     them.
 14. the agent: (a) `cli.main.start_agent` in this process with `-dev
     -clients 0 -acl-enabled -num-schedulers 1` (ephemeral HTTP and RPC
     ports, the card); the 10,000 nodes registered over its RPC port
     (Node.Register, 32 threads); through the port's CLI `main()`: `acl
     bootstrap`, `acl policy-apply` of a write policy on `default` (and
     of a read-only one), `acl token-create` of a token under each, `event
     sink-register` of a loopback webhook receiver in this script, then
     with the write token `job run` of three HCL files this script
     writes: a service job of count 10 (chunked), a batch job of count
     2,500 (K-way) and the main path's `${meta.rack}` spread job with its
     affinity, count 200 (scan), one after another. Fails unless the
     read-only token's register answers 403, each job is placed to its
     count with no node over capacity (recomputed from /v1/allocations
     and /v1/nodes), each eval ends complete, the placements by node name
     equal an in-process Server(device="cpu") fed the same nodes and the
     same parsed jobs in the same order, the receiver got each job's
     registration and every alloc's PlanResult, and the chunked, K-way,
     scan and scatter_set kernels launched (counts set to 0 just before
     the jobs), and through the in-process ApiClient
     /v1/operator/trace holds the jobs' traces, its ?format=chrome form
     loads as trace-event JSON with a worker, the gateway and the applier
     track, /v1/operator/governor and /v1/operator/telemetry serve the
     live governor and ring, and /v1/metrics?format=prometheus names the
     device.* family. Printed: the nodes' registration seconds, each
     `job run`'s wall (CLI call to eval complete), a `job status`'s, the
     sink's delivered events, the launches and what the four routes
     answered. The kernels line's `agent_launches` holds them. Its
     subprocess half is phase 15 (b).
 15. the node agent on the card: (a) `start_agent` (-dev -clients 1
     -num-schedulers 1, ephemeral ports, the card) with its local client
     `dev-client-0`, and a second Client in this process, `gpu-client`
     (ClientConfig(fingerprint_accelerators=True,
     plugin_device_fingerprint=False), its alloc dirs apart from the
     agent's, so that its logs travel server -> client over RPC); the
     10,000 nodes over the agent's RPC port; through the port's CLI
     `main()`, `job run` of three HCL files this script writes: a batch
     job of count 1 on raw_exec (`/bin/sh -c 'echo $NOMAD_ALLOC_ID;
     sleep 3'`) asking `device "gpu" { count = 1 }`, the same job again
     while the first holds the card (it must block on the exhausted
     device), and a service job of count 3 on mock_driver constrained to
     `${node.unique.name} = dev-client-0`, then `job stop` of it. Fails
     unless gpu-client's node lists one device group of vendor nvidia,
     type gpu, named after torch.cuda.get_device_name(0), with
     torch.cuda.device_count() instances; the device job lands on
     gpu-client with an instance id on its alloc and ends complete;
     `alloc logs` through the CLI prints its alloc id; the second device
     job's eval names the device in failed_tg_allocs and leaves a blocked
     eval; the service job's three allocs reach running on dev-client-0
     and complete after the stop; the placements equal an in-process
     Server(device="cpu") fed the same nodes (the two clients' first)
     and jobs in the same order; ExternalDevicePlugin().fingerprint()
     equals the in-process group and its stats() report the card's used
     memory; cluster_stats() counts both clients' heartbeat payloads; and
     the chunked and scatter_set kernels launched (counts set to 0 just
     before the jobs). (b) `python -m nomad_tpu_torch agent -dev` as a
     user starts it (its one local client, the card), `python -m
     nomad_tpu_torch job init` and `job run` of the example job
     (mock_driver): fails unless the start lines name the card and one
     node, the job is running on the local client and `job status` shows
     it; then (phase 14's subprocess checks) /v1/status/leader answers,
     1,000 nodes over its RPC port, all ready with the local client in
     /v1/nodes, `job run` of phase 14's service file kept off the local
     client placed to its count with its evals complete and no node over
     capacity (recomputed from /v1/allocations), /v1/metrics showing
     nomad.select.dispatches > 0, and exit 0 on SIGTERM. Printed: the fingerprint's and the clients'
     construction seconds, each `job run`'s wall (CLI call to eval
     complete) and to complete / running, the task's start latency (the
     alloc first seen placed in the store -> the client's task
     started_at), `alloc logs`' seconds, the subprocess's start seconds
     and the launches, which the kernels line holds as `client_launches`.
 16. the scenario matrix on the card (nomad_tpu_torch/chaos/): (a) the six
     quick single-process cells (system_fanout, spread_antiaffinity,
     batch_backfill, drain_storm, client_failure_burst, blocked_herd) and
     the three cluster cells (swim_partition, follower_fence,
     leader_failover_commit) through `run_cell(..., device="cuda")`,
     each a seeded workload on real Servers under an injected fault
     (dropped heartbeats, a forced governor reclaim, a worker killed
     between its plan's commit and its ack, a drain storm and a reboot
     over a corrupted WAL tail, a mass client failure, a blocked-eval
     herd, a SWIM partition, lagged replication, the leader killed
     mid-group-commit); every cell must pass, and a cell's error fails
     the phase; (b) the six single-process cells at their -full sizes
     on the card, then again on the CPU: each card run's invariant names
     and verdicts, fault-event kinds, placement count and placement
     shape (every live alloc, the alloc count of each node) must equal
     the CPU's, and in system_fanout,
     spread_antiaffinity and batch_backfill every live alloc must sit on
     the same node; the others' node ids vary from run to run on either
     device, with thread timings. The -full flatness verdicts over
     seconds-long windows and spread_antiaffinity's per-node p99 bound
     fail on both devices, as they do in the JAX package, and are
     printed, not failed on. The launches of
     (a) and (b)'s card runs (counts set to 0 just before them) must
     include the chunked, scan and scatter_set kernels; the kernels line
     holds them as `chaos_launches`. Printed: each cell's elapsed
     seconds, placements a second and settle p50 / p99 ms, each cluster
     cell's raft elections won, leader step-downs and highest term (from
     the raft log), the cells whose every alloc sat on the same node on
     both devices, with the card's name and power limit.
The line before the last is the card's name and power limit, the one
before it the kernels' JSON record; the last line is the JSON verdict.
Imports nothing of JAX or of the JAX package.
"""

import json
import logging
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
MESH_SWEEP = (32,)
CLUSTER_SWEEP = (16, 32)
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
# a plain version whose first call takes longer is timed once more, not
# `reps` times (time_plain)
PLAIN_ONCE_MS = 200.0


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


def cuda_ms(fn, reps=7, warm=True):
    import torch
    if warm:
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


def time_plain(fn, reps):
    """A plain version's time: the median of `reps` after a warm-up,
    or, where the warm-up call took more than PLAIN_ONCE_MS, the one
    call after it (a plain version's time is recorded, never held
    against a bound; its repetitions on the host were most of the
    script's wall)."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    return cuda_ms(fn, reps=1 if first > PLAIN_ONCE_MS else reps,
                   warm=False)


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
        plain_ms = time_plain(lambda: plain(**targs, **kw), reps=5)
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
            plain_ms = time_plain(lambda: plain(**targs, **kw), reps=3)
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


def edge_shard_counts(device, kernel):
    """The shard counts the sharded kernels' edge checks run: MESH_SHARDS
    (a thread-block cluster a lane where the kernel has that route), for
    the scan and chunked kernels also 16 (their one cluster size past the
    portable 8), and the most the card holds (the cooperative grid). 32,
    which takes the grid route as the most does, runs at the main shapes
    only (the sharded and batched sharded kernel phases), which keeps the
    script inside its time limit."""
    from nomad_tpu_torch.ops import kernels
    grid = "scan_sharded" if kernel.startswith("scan") else kernel
    cluster = (16,) if kernel.startswith(("scan", "chunked")) else ()
    return sorted({MESH_SHARDS, kernels.max_shards(grid, device)}
                  | set(cluster))


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
    that runs dry, over one capacity table), at S 8 and the most the
    card holds (edge_shard_counts), each table padded as a mesh of S
    shards pads it and
    each call with an 8-phase budget continued from the card's own carry:
    every launch held bit for bit against its plain version and against
    the single-card kernel on the same padded table."""
    import torch
    from nomad_tpu_torch.mock.kway_edges import kway_edge_args, pad_rows
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shard_counts = edge_shard_counts(device, "kway_sharded")
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
    over 10,000 rows (an 8-step budget), at S 8 and the most the card
    holds (edge_shard_counts), each table padded as a mesh of S shards
    pads it: every launch,
    and a continuation from the card's own carry, held bit for bit against
    the plain version and the single-card batched kernel."""
    from nomad_tpu_torch.mock.chunked_edges import (
        CHUNKED_EDGES, CHUNKED_LANES, chunked_edge_args, chunked_lanes,
        edge_rows, one_lane, pad_lanes)
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shard_counts = edge_shard_counts(device, "chunked_batched_sharded")
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
        plain_ms = time_plain(lambda: plain(**targs, **kw), reps=3)
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
    timed, its bound summed over the lanes as phase 6 counts it. Returns
    its row."""
    import torch
    from nomad_tpu_torch.mock.chunked_edges import (CHUNKED_LANES,
                                                    chunked_lanes)
    from nomad_tpu_torch.ops import kernels
    n = MAIN_NODES
    targs = _card(chunked_lanes(n, CHUNKED_LANES, SEED + 70))
    n_pad = targs["capacity"].shape[0]
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
        nbytes, f32, f64 = rows_bytes([targs["capacity"]], n, n_pad), 0, 0
        for i, st in enumerate(steps):
            b, o32, o64 = lane_bound(
                "chunked_batched", kernels.lane_args(targs, i),
                [t[i] for t in got[0]], [t[i] for t in got[1]], n, n_pad,
                st, kw, 0, 0)
            nbytes, f32, f64 = nbytes + b, f32 + o32, f64 + o64
        b_ms, by = bound_of(nbytes, f32, f64)
        ms = cuda_ms(lambda: kernels.select_chunked_batched(**targs, **kw))
        row = dict(kind="chunked_batched", n=n, lanes=len(CHUNKED_LANES),
                   counts=[1, 512], main=False, variant="mixed",
                   spread_alg=spread_alg, max_abs_err=err, ms=ms,
                   steps=max(steps), us_per_step=ms / max(steps) * 1e3,
                   bound_ms=b_ms, bound_by=by)
        print(f"kernel {label} (spread_alg {spread_alg}): every lane equals "
              f"the plain version and the solo kernel; steps a lane "
              f"{steps}; {ms:.3f} ms, bound {b_ms:.6f} ms ({by})",
              flush=True)
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
                           plain_ms=time_plain(
                               lambda: plain(**targs, **skw), reps=3))
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
    at S 1, 8 and the most the card holds, each table padded
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

    shard_counts = sorted({1} | set(edge_shard_counts(device,
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
                row["plain_ms"] = time_plain(
                    lambda: plain(**targs, **skw), reps=3)
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


# the server phase's three servers: (label, what, ServerConfig fields)
SERVER_RUNS = (("A", "sequential", dict(num_schedulers=1, eval_batch_size=1,
                                        gateway_window_us=0)),
               ("B", "drained batches", dict(num_schedulers=2,
                                             eval_batch_size=8,
                                             gateway_window_us=0)),
               ("C", "micro-batch gateway", dict(num_schedulers=2,
                                                 eval_batch_size=8)))
SERVER_WAIT_S = 180
# (A) once more with the governor, the flight recorder and the telemetry
# collector off: the observability layer's overhead is (A)'s wall over
# this one's
SERVER_OBSERVABILITY_OFF = dict(governor_enabled=False,
                                telemetry_sample_interval_s=0,
                                trace_enabled=False)
# the solo arms whose kernel spans (A) holds to their launches
SOLO_SPAN_ARMS = ("chunked", "kway", "scan")


def server_jobs(mock, models):
    """The server phase's traffic in registration order — 64 service jobs
    of count 10 (the JAX package's bench_broker_service job: no networks,
    a rack affinity), 4 spread jobs of count 200 (the main path's spread
    job) and 2 batch jobs of count 2,500 — and one more service job that
    warms the server. The first drain of 8 evals is the spread jobs with
    4 service jobs behind them, the second 8 service jobs and the third
    the batch jobs with 6 service jobs: a fire that mixes spread and
    service lanes runs the scan-batched kernel, one of service lanes the
    chunked-batched kernel and one that mixes batch and service lanes the
    K-way-batched kernel (spread and batch lanes in one fire would run
    one by one). So the first two drains, which the workers decide on
    right after the calibration, reach both batched arms that the phase
    requires."""
    with mock.seeded_mock_ids(SEED + 4):
        service = [mock.job() for _ in range(65)]
        spread = [mock.job() for _ in range(4)]
        batch = [mock.batch_job() for _ in range(2)]
    for i, job in enumerate(service):
        job.id = job.name = f"srv-service-{i}"
        tg = job.task_groups[0]
        tg.count = 10
        for t in tg.tasks:
            t.resources.networks = []
        tg.networks = []
        tg.affinities = [models.Affinity(
            ltarget="${meta.rack}", rtarget="r3", operand="=", weight=50)]
    for i, job in enumerate(spread):
        job.id = job.name = f"srv-spread-{i}"
        job.spreads = [models.Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[models.SpreadTarget(value="r1", percent=30),
                           models.SpreadTarget(value="r2", percent=20)])]
        job.affinities = [models.Affinity(
            ltarget="${meta.rack}", rtarget="r3", operand="=", weight=40)]
        job.task_groups[0].count = 200
    for i, job in enumerate(batch):
        job.id = job.name = f"srv-batch-{i}"
        job.task_groups[0].count = 2500
    warm = service.pop()
    return warm, spread + service[:12] + batch + service[12:]


def fold_jobs(mock):
    """The two service jobs (count 10) registered after (A)'s forced
    fold of the mirror: the second one's eval scatters the first one's
    rows onto the folded mirror."""
    with mock.seeded_mock_ids(SEED + 6):
        jobs = [mock.job() for _ in range(2)]
    for i, job in enumerate(jobs):
        job.id = job.name = f"srv-after-fold-{i}"
        tg = job.task_groups[0]
        tg.count = 10
        for t in tg.tasks:
            t.resources.networks = []
        tg.networks = []
    return jobs


def _wait_placed(s, jobs, timeout_s):
    want = {j.id: j.task_groups[0].count for j in jobs}
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if all(len(s.store.allocs_by_job("default", j)) >= n
               for j, n in want.items()):
            return True
        time.sleep(0.002)
    return False


def _pause(s, paused):
    for w in s.workers:
        w.set_pause(paused)
    if paused:
        # a worker inside its blocking dequeue notices on its next loop
        time.sleep(0.6)


def server_capacity_check(s, names, what):
    """No node's live allocs use more CPU or memory than it offers after
    its reservation, or share a port, recomputed from the store."""
    for node in s.store.nodes():
        total = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        cpu, mem, ports = reserved.cpu_shares, reserved.memory_mb, []
        for a in s.store.allocs_by_node(node.id):
            if a.terminal_status() or a.allocated_resources is None:
                continue
            c = a.allocated_resources.comparable()
            cpu += c.cpu_shares
            mem += c.memory_mb
            for t in a.allocated_resources.tasks.values():
                for net in t.networks:
                    ports += [p.value for p in net.reserved_ports
                              + net.dynamic_ports]
        if cpu > total.cpu_shares or mem > total.memory_mb \
                or len(ports) != len(set(ports)):
            fail(f"{what}: node {names[node.id]} over capacity: cpu "
                 f"{cpu}/{total.cpu_shares}, memory {mem}/"
                 f"{total.memory_mb}, ports {sorted(ports)}")


def run_server(device, label, cfg, nodes, warm, jobs, after_fold=(),
               observe=False):
    """One fresh Server over the nodes: the dispatch cost model a fresh
    process starts with (empty), calibrated after the nodes are seeded
    as the JAX package's bench_broker_service calibrates it; the warm job
    (its eval builds the node table and uploads the mirror); then the
    traffic, registered while the workers are paused and timed from
    their resume until every job is placed to its count. With `observe`
    (a sequential run on the card, observability on) the run's traces
    are checked (trace_checks); with `after_fold`, the governor's forced
    fold of the mirror and those jobs follow (fold_checks). Returns the
    run's record."""
    import copy
    import torch
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.trace import tracer
    from nomad_tpu_torch.utils import metrics, stages
    what = f"server {label} on {device or 'the card'}"
    # the process-wide recorder starts empty: the ring and the stage
    # reservoirs then hold this run's evals only
    tracer.reset()
    s = Server(ServerConfig(heartbeat_ttl_s=3600.0, **cfg), device=device)
    s.start()
    try:
        _pause(s, True)
        idx = s._raft_index
        for node in nodes:
            idx += 1
            s.store.upsert_node(idx, copy.deepcopy(node))
        s._raft_index = idx
        names = {node.id: node.name for node in nodes}
        S.cost_model.clear()
        S.calibrate_cost_model(len(nodes), count=10,
                               lanes=cfg.get("eval_batch_size", 1),
                               kernel=S.SelectKernel(s.device))
        s.register_job(copy.deepcopy(warm))
        t0 = time.perf_counter()
        _pause(s, False)
        if not _wait_placed(s, [warm], SERVER_WAIT_S):
            fail(f"{what}: the warm job was not placed")
        first = time.perf_counter() - t0
        _pause(s, True)
        for w in s.workers:
            w.latencies_s.clear()
        stats0 = [dict(w.stats) for w in s.workers]
        applier0 = dict(s.plan_applier.stats)
        gw0 = dict(s.gateway.stats) if s.gateway is not None else None
        counters = ("nomad.plan.node_rejected",
                    "nomad.select.batch_dispatch",
                    "nomad.select.batch_fallback")
        c0 = metrics.counter_totals()
        for job in jobs:
            s.register_job(copy.deepcopy(job))
        if device != "cpu":
            torch.cuda.synchronize()
        kernels.reset_launches()
        dev0 = S.device_stats_snapshot()["dispatches"]
        stages.enable()
        t0 = time.perf_counter()
        _pause(s, False)
        if not _wait_placed(s, jobs, SERVER_WAIT_S):
            fail(f"{what}: not every job placed in {SERVER_WAIT_S} s")
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and (
                s.eval_broker.stats.total_ready
                or s.eval_broker.stats.total_unacked):
            time.sleep(0.01)
        split = {k: v["seconds"] for k, v in stages.snapshot().items()
                 if v["calls"]}
        stages.disable()
        obs = None
        if observe:
            obs = trace_checks(s, jobs, wall, dict(kernels.LAUNCHES), dev0,
                               what)
        c1 = metrics.counter_totals()
        placements, placed = [], 0
        for job in jobs:
            allocs = s.store.allocs_by_job(job.namespace, job.id)
            want = job.task_groups[0].count
            evals = s.store.evals_by_job(job.namespace, job.id)
            if len(allocs) != want or any(e.status != "complete"
                                          for e in evals):
                fail(f"{what}: {job.id} {len(allocs)}/{want} placed, evals "
                     f"{[e.status for e in evals]}")
            placed += len(allocs)
            placements.append(sorted((a.name, names[a.node_id])
                                     for a in allocs))
        server_capacity_check(s, names, what)
        lat = sorted(x for w in s.workers for x in w.latencies_s)
        stat = {k: sum(w.stats[k] for w in s.workers) - sum(
            st[k] for st in stats0) for k in stats0[0]}
        ap = {k: s.plan_applier.stats[k] - applier0[k] for k in applier0}
        if s.gateway is not None:
            fires = s.gateway.stats["dispatches"] - gw0["dispatches"]
            lanes = s.gateway.stats["lanes_sum"] - gw0["lanes_sum"]
            multi = s.gateway.stats["batches"] - gw0["batches"]
        else:
            fires, lanes = stat["gateway_dispatches"], stat["gateway_lanes"]
            multi = stat["gateway_batches"]
        # after the run's numbers: the fold and its jobs are not the run's
        folded = fold_checks(s, after_fold, names, what) if after_fold \
            else None
        events = s.governor.events() if s.governor is not None else None
        return dict(
            label=label, device=device or "cuda", first_s=first,
            wall=wall, placed=placed, evals=stat["processed"],
            p50=lat[len(lat) // 2] if lat else None,
            p99=lat[min(len(lat) - 1, int(0.99 * len(lat)))]
            if lat else None,
            batches=stat["batches"], fires=fires, lanes=lanes, multi=multi,
            commits=ap["groups"], plans=ap["plans"],
            **{k.rsplit(".", 1)[1]: c1.get(k, 0.0) - c0.get(k, 0.0)
               for k in counters},
            conflicts=ap["conflict_retries"], launches=launches,
            gated=stat["gated_drains"],
            cost_model={k: v for k, v in S.cost_model.snapshot().items()
                        if k.endswith(f"@{S._pad_n(len(nodes))}")},
            stages=split, placements=placements, obs=obs, folded=folded,
            events=events)
    finally:
        stages.disable()
        s.shutdown()


def trace_checks(s, jobs, wall, launches, dev0, what):
    """The flight recorder's account of a run with it on: every eval of
    the run's jobs that completed has an acked trace; the kernel spans by
    arm (solo arms only, as (A) dispatches; each arm dispatched) equal the
    device accounting's dispatches since `dev0` and, on the card, the
    run's LAUNCHES; on the card
    device_hbm_bytes reads the caching allocator's bytes (> 0), and one
    governor and one collector sample synchronise nothing
    (torch.cuda.set_sync_debug_mode("error") raises at a synchronising
    call). Returns the per-stage percentiles, the spans' seconds by name
    summed over the traces, the kernel spans by arm and the bytes."""
    import torch
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.trace import tracer
    ids = {j.id for j in jobs}
    want = {e.id for j in jobs for e in s.store.evals_by_job(j.namespace,
                                                              j.id)
            if e.status == "complete"}
    deadline = time.perf_counter() + 30
    while True:
        traces = [t for t in tracer.recent(100_000) if t["job_id"] in ids]
        acked = {t["eval_id"] for t in traces if t["status"] == "acked"}
        if want <= acked or time.perf_counter() > deadline:
            break
        time.sleep(0.01)
    if not want <= acked:
        fail(f"{what}: {len(want - acked)} of {len(want)} completed evals "
             f"have no acked trace (ring {tracer.status(limit=0)['ring']})")
    spans, seconds = {}, {}
    for t in traces:
        for sp in t["spans"]:
            seconds[sp["name"]] = seconds.get(sp["name"], 0.0) \
                + sp["dur_ms"] / 1e3
            if sp["name"] == "kernel":
                arm = sp["attrs"]["arm"]
                spans[arm] = spans.get(arm, 0) + 1
    d1 = S.device_stats_snapshot()["dispatches"]
    dispatches = {a: d1[a] - dev0.get(a, 0) for a in d1
                  if d1[a] != dev0.get(a, 0)}
    # the plain versions report as "<arm>@cpu" and count no launch
    card = s.device.type == "cuda"
    suffix = "" if card else "@cpu"
    if set(spans) - {a + suffix for a in SOLO_SPAN_ARMS}:
        fail(f"{what}: kernel spans of other arms than the solo ones: "
             f"{spans}")
    for arm in SOLO_SPAN_ARMS:
        got = (spans.get(arm + suffix, 0), dispatches.get(arm + suffix, 0),
               launches.get(arm, 0) if card else
               spans.get(arm + suffix, 0))
        if len(set(got)) != 1 or not got[0]:
            fail(f"{what}: {arm}: kernel spans {got[0]}, device "
                 f"accounting's dispatches {got[1]}, launches {got[2]}")
    hbm = None
    if card:
        hbm = S.device_hbm_bytes(s.device)
        alloc = torch.cuda.memory_allocated(s.device)
        if not hbm > 0 or hbm != alloc:
            fail(f"{what}: device_hbm_bytes {hbm}, the caching "
                 f"allocator's bytes {alloc}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            s.governor.sample_once()
            s.telemetry.sample_once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(traces=len(traces), evals=len(want), spans=spans,
                seconds=seconds, wall=wall, hbm=hbm,
                percentiles=tracer.stage_percentiles())


def fold_checks(s, after, names, what):
    """The governor's node_table.delta_debt reclaim forced: the mirror is
    re-uploaded from the host table in one piece (fold_device) and equals
    it bit for bit; then `after`'s jobs, registered one by one, place to
    their counts with no node over capacity, and (on the card) the
    mirror's scatter_set kernel launches for them. Returns the debt the
    fold cleared, its seconds, the scatter_set launches and the jobs'
    placements."""
    import copy
    import torch
    from nomad_tpu_torch.ops import kernels
    debt = s.store.table_cache.device_delta_debt()
    card = s.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fired = s.governor.force_reclaim("node_table.delta_debt")
    if card:
        torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    if len(fired) != 1 or not fired[0]["detail"].get("folded"):
        fail(f"{what}: the forced reclaim did not fold the mirror: {fired}")
    if s.store.table_cache.device_delta_debt() != 0:
        fail(f"{what}: the fold left a scatter debt")
    served_table_matches(s.store, f"{what} after the fold", "mirror")
    scatters0 = kernels.LAUNCHES["scatter_set"]
    placements = []
    for job in after:
        s.register_job(copy.deepcopy(job))
        if not _wait_placed(s, [job], SERVER_WAIT_S):
            fail(f"{what}: {job.id} was not placed after the fold")
        placements.append(sorted(
            (a.name, names[a.node_id])
            for a in s.store.allocs_by_job(job.namespace, job.id)))
    server_capacity_check(s, names, f"{what} after the fold")
    scatters = kernels.LAUNCHES["scatter_set"] - scatters0
    if card and scatters < 1:
        fail(f"{what}: scatter_set did not launch after the fold")
    return dict(debt=debt, fold_s=fold_s, scatters=scatters,
                placements=placements)


def server_phase(nodes, mock, models, info):
    """The dev-mode server on the card: broker -> workers -> kernels (solo,
    BatchGateway or MicroBatchGateway) -> plan queue -> group-committing
    applier -> store, under three configurations on fresh servers; (A)
    again with device="cpu". Fails unless every job is placed to its
    count with no node over capacity, (A) places identically on the card
    and the CPU, and (B) and (C) launched the chunked-batched kernel and
    the K-way- or scan-batched one. Returns the card runs' launches summed
    by kernel."""
    t_phase = time.perf_counter()
    warm, jobs = server_jobs(mock, models)
    after = fold_jobs(mock)
    label_a, what_a, cfg_a = SERVER_RUNS[0]
    runs = []
    plan = [(None, label_a, what_a, cfg_a, after, True),
            (None, f"{label_a}-off", "sequential, governor, flight "
             "recorder and telemetry off", dict(cfg_a,
                                                **SERVER_OBSERVABILITY_OFF),
             (), False),
            *[(None, label, what, cfg, (), False)
              for label, what, cfg in SERVER_RUNS[1:]],
            ("cpu", label_a, what_a, cfg_a, after, True)]
    for device, label, what, cfg, fold_after, observe in plan:
        r = run_server(device, label, cfg, nodes, warm, jobs, fold_after,
                       observe)
        r["what"] = what
        print_server_run(r, len(jobs))
        runs.append(r)
    cpu_a = runs.pop()
    off_a = runs.pop(1)
    for r in runs[1:]:
        check_batched_reached(r)
    for r in runs + [cpu_a]:
        # the 70-job burst stays under the pressure watermarks' defaults
        # (8,192 ready; p99 1,000 ms once 640 latencies exist)
        engaged = [e for e in r["events"] if e["kind"] == "backpressure"]
        if engaged:
            fail(f"server {r['label']} on {r['device']}: the governor "
                 f"engaged backpressure: {engaged}")
    for job, g, o, c in zip(jobs, runs[0]["placements"],
                            off_a["placements"], cpu_a["placements"]):
        for other, where in ((c, "the CPU"),
                             (o, "the card with observability off")):
            if g != other:
                diff = [p for p in g if p not in other][:3]
                fail(f"server A: {job.id} placed differently on the card "
                     f"and {where}, e.g. {diff}")
    for job, g, c in zip(after, runs[0]["folded"]["placements"],
                         cpu_a["folded"]["placements"]):
        if g != c:
            diff = [p for p in g if p not in c][:3]
            fail(f"server A: {job.id}, placed after the fold, placed "
                 f"differently on the card and the CPU, e.g. {diff}")
    print_observability(runs[0], off_a, cpu_a, info)
    print(f"server A: placements identical on the card with the "
          f"governor, flight recorder and telemetry on and off, and on "
          f"the CPU (the jobs after the fold too); every job placed to its "
          f"count and no node over capacity in A, B and C; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({info['raw']})",
          flush=True)
    total = {}
    for r in runs:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    # the single card server's alloc-name manifest of (A), per job: what
    # the ring phase must land too
    manifest = {f"default/{job.id}": sorted(name for name, _node in placed)
                for job, placed in zip(jobs, runs[0]["placements"])}
    return total, manifest


def check_batched_reached(r):
    """Fail unless the run launched the chunked-batched kernel and the
    K-way- or scan-batched one; the failure shows the batching gate's
    decisions (drains run one by one) and the cost model it read."""
    got = r["launches"]
    if got.get("chunked_batched", 0) < 1 or not (
            got.get("kway_batched", 0) or got.get("scan_batched", 0)):
        fail(f"server {r['label']}: the batched arms were not reached from "
             f"the server ({got}); {r['gated']} drains run one by one by "
             f"the batching gate; cost model per lane at the run's end "
             f"{json.dumps(r['cost_model'])}")


def print_server_run(r, n_jobs):
    """One line of a server run's numbers."""
    where = ("with plain versions on the CPU" if r["device"] == "cpu"
             else "on the card")
    print(f"server {r['label']} ({r['what']}) {where}: first eval "
          f"{r['first_s']:.3f} s (node table build and mirror upload); "
          f"then {n_jobs} jobs, {r['placed']} placements, {r['evals']} "
          f"evals in {r['wall']:.3f} s: {r['placed'] / r['wall']:.1f} "
          f"placements/s, {r['evals'] / r['wall']:.2f} evals/s; eval "
          f"latency (broker enqueue -> ack) p50 {r['p50']:.3f} s, p99 "
          f"{r['p99']:.3f} s; worker batches {r['batches']} (drains run "
          f"one by one by the batching gate {r['gated']}); gateway fires "
          f"{r['fires']} ({r['lanes'] / max(r['fires'], 1):.2f} lanes a "
          f"fire, {r['multi']} of more than one); applier commits "
          f"{r['commits']} of {r['plans']} plans (mean group "
          f"{r['plans'] / max(r['commits'], 1):.2f}), rejected placements "
          f"{r['node_rejected']:.0f}, conflict retries {r['conflicts']}; "
          f"batched dispatches {r['batch_dispatch']:.0f}, batch fallbacks "
          f"{r['batch_fallback']:.0f}; "
          f"launches {r['launches']}; stage seconds summed over the evals "
          f"{json.dumps(r['stages'])}", flush=True)
    if r["events"] is not None:
        print(f"server {r['label']} on {r['device']}: governor events "
              f"{json.dumps(r['events'])}", flush=True)


def print_observability(on, off, cpu, info):
    """(A)'s flight-recorder account on the card: the overhead of the
    three samplers and the recorder (wall on over wall off, one run
    each), the traces, the kernel spans by arm, the stage percentiles,
    each span's summed seconds as a share of the wall (the `kernel`
    share first), the card's bytes in use, and the forced fold."""
    o, f = on["obs"], on["folded"]
    shares = {k: round(v / o["wall"], 4) for k, v in sorted(
        o["seconds"].items(), key=lambda kv: -kv[1])}
    print(f"server A observability on the card: wall {on['wall']:.3f} s "
          f"with the governor, flight recorder and telemetry on, "
          f"{off['wall']:.3f} s with them off: ratio "
          f"{on['wall'] / off['wall']:.4f}; {o['traces']} traces for "
          f"{o['evals']} completed evals, every one acked; kernel spans by "
          f"arm {json.dumps(o['spans'])} = launches = the device "
          f"accounting's dispatches; kernel share of the wall "
          f"{shares.get('kernel', 0.0)}; span seconds over the wall by "
          f"name {json.dumps(shares)}; device_hbm_bytes {o['hbm']} = "
          f"torch.cuda.memory_allocated; one governor and one collector "
          f"sample under set_sync_debug_mode('error') ({info['raw']})",
          flush=True)
    print(f"server A stage percentiles on the card (ms): "
          f"{json.dumps(o['percentiles'])}", flush=True)
    print(f"server A forced reclaim node_table.delta_debt: debt "
          f"{f['debt']} rows, fold_device {f['fold_s']:.4f} s on the card "
          f"({cpu['folded']['fold_s']:.4f} s on the CPU); the mirror equals "
          f"the host table bit for bit; then {len(f['placements'])} jobs "
          f"placed as on the CPU, scatter_set launched {f['scatters']} "
          f"times after the fold", flush=True)


# the restart phase: WAL entries between automatic snapshots, set above
# the phase's whole first life so that only its two explicit snapshots
# are taken; client updates a WAL entry
RESTART_SNAPSHOT_EVERY = 1_000_000
RESTART_UPDATE_GROUP = 100
RESTART_CFG = dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0,
                   heartbeat_ttl_s=3600.0, snapshot_background=False,
                   snapshot_every=RESTART_SNAPSHOT_EVERY)
# the kernels the first evals after the restart must launch: rows 1, 3, 5
# (placements) and 7 (the replayed tail's rows reaching the mirror)
RESTART_KERNELS = ("chunked", "kway", "scan", "scatter_set")
MIRROR_KEYS = ("version", "uploads", "folds", "scatters", "scatter_rows")


def restart_jobs(mock, models):
    """The jobs registered after the restart, first eval first: a service
    job of count 10 (the server phase's shape), the main path's spread job
    (count 200) and a batch job of count 2,500."""
    with mock.seeded_mock_ids(SEED + 5):
        service, spread, batch = mock.job(), mock.job(), mock.batch_job()
    service.id = service.name = "restart-service"
    tg = service.task_groups[0]
    tg.count = 10
    for t in tg.tasks:
        t.resources.networks = []
    tg.networks = []
    tg.affinities = [models.Affinity(
        ltarget="${meta.rack}", rtarget="r3", operand="=", weight=50)]
    spread.id = spread.name = "restart-spread"
    spread.spreads = [models.Spread(
        attribute="${meta.rack}", weight=60,
        spread_target=[models.SpreadTarget(value="r1", percent=30),
                       models.SpreadTarget(value="r2", percent=20)])]
    spread.affinities = [models.Affinity(
        ltarget="${meta.rack}", rtarget="r3", operand="=", weight=40)]
    spread.task_groups[0].count = 200
    batch.id = batch.name = "restart-batch"
    batch.task_groups[0].count = 2500
    return [service, spread, batch]


def server_state(s):
    """What a restart must bring back: jobs, allocs by id with their
    node's name and statuses, eval statuses and the latest index."""
    names = {n.id: n.name for n in s.store.nodes()}
    return dict(
        jobs=sorted((j.id, j.version, j.status, j.stop)
                    for j in s.store.jobs()),
        allocs=sorted((a.id, a.name, names.get(a.node_id), a.client_status,
                       a.desired_status) for a in s.store.allocs()),
        evals=sorted((e.id, e.status) for e in s.store.evals()),
        index=s.store.latest_index())


def _idle(s, what):
    """Wait until the broker holds no ready or unacked eval: every entry
    of the placed jobs is applied."""
    deadline = time.perf_counter() + 60
    while s.eval_broker.stats.total_ready or \
            s.eval_broker.stats.total_unacked:
        if time.perf_counter() > deadline:
            fail(f"{what}: the broker did not drain")
        time.sleep(0.005)


def restart_first_life(data_dir, nodes, warm, jobs):
    """The first life on the card: the nodes seeded into the store and a
    first snapshot of them, the warm job (the first eval of a fresh
    server: a full table build and the mirror's upload), half the jobs,
    a second snapshot, the other half, then every placed alloc marked
    running in client updates of RESTART_UPDATE_GROUP allocs an entry.
    Returns the state at shutdown, the warm eval's wall and stages, and
    the snapshots' seconds."""
    import copy
    from dataclasses import replace
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils import stages
    what = "restart phase, first life"
    s = Server(ServerConfig(data_dir=data_dir, **RESTART_CFG))
    s.start()
    try:
        _pause(s, True)
        idx = s._raft_index
        for node in nodes:
            idx += 1
            s.store.upsert_node(idx, copy.deepcopy(node))
        s._raft_index = idx
        snaps = []
        t0 = time.perf_counter()
        with s._raft_l:
            s.persistence.snapshot(s.store)
        snaps.append(time.perf_counter() - t0)
        S.cost_model.clear()
        S.calibrate_cost_model(len(nodes), count=10, lanes=1,
                               kernel=S.SelectKernel(s.device))
        s.register_job(copy.deepcopy(warm))
        stages.enable()
        t0 = time.perf_counter()
        _pause(s, False)
        if not _wait_placed(s, [warm], SERVER_WAIT_S):
            fail(f"{what}: the warm job was not placed")
        warm_wall = time.perf_counter() - t0
        _idle(s, what)
        warm_stages = {k: v["seconds"] for k, v in stages.snapshot().items()
                       if v["calls"]}
        stages.disable()
        half = len(jobs) // 2
        for part, last in ((jobs[:half], False), (jobs[half:], True)):
            _pause(s, True)
            for job in part:
                s.register_job(copy.deepcopy(job))
            _pause(s, False)
            if not _wait_placed(s, part, SERVER_WAIT_S):
                fail(f"{what}: not every job placed in {SERVER_WAIT_S} s")
            _idle(s, what)
            if not last:
                t0 = time.perf_counter()
                with s._raft_l:
                    s.persistence.snapshot(s.store)
                snaps.append(time.perf_counter() - t0)
        allocs = [replace(a, client_status="running")
                  for job in [warm] + jobs
                  for a in s.store.allocs_by_job(job.namespace, job.id)]
        s.update_alloc_status_from_client_batch(
            [allocs[i:i + RESTART_UPDATE_GROUP]
             for i in range(0, len(allocs), RESTART_UPDATE_GROUP)])
        if s.store.table_cache.stats["full_builds"] != 1:
            fail(f"{what}: table cache {s.store.table_cache.stats}")
        state = server_state(s)
        running = sum(a[3] == "running" for a in state["allocs"])
        if running != len(allocs) or running != len(state["allocs"]):
            fail(f"{what}: {running} of {len(state['allocs'])} allocs "
                 f"running")
    finally:
        stages.disable()
        s.shutdown()
    return state, warm_wall, warm_stages, snaps


def restart_life(data_dir, device, want, saved_model, nodes, jobs):
    """A server restarted from `data_dir` on `device` (None: the card)
    from an empty cost model: its restored state held against `want`, the
    cost model's shapes against the saved file's, then the restart's jobs
    placed one after another. Returns the run's record."""
    import copy
    import torch
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils import stages
    where = "the card" if device is None else device
    what = f"restart phase on {where}"
    S.cost_model.clear()
    t0 = time.perf_counter()
    s = Server(ServerConfig(data_dir=data_dir, **RESTART_CFG), device=device)
    construct_s = time.perf_counter() - t0
    print(f"{what}: constructed in {construct_s:.3f} s", flush=True)
    try:
        got = server_state(s)
        if got != want:
            diff = {k: (len(got[k]) if isinstance(got[k], list) else got[k],
                        len(want[k]) if isinstance(want[k], list)
                        else want[k])
                    for k in want if got[k] != want[k]}
            fail(f"{what}: the restored store differs from the first "
                 f"life's at shutdown (restored, first life): {diff}")
        restored = S.cost_model.snapshot()
        missing = sorted(set(saved_model) - set(restored))
        if not saved_model or missing:
            fail(f"{what}: the cost model lacks the saved shapes {missing} "
                 f"(saved {sorted(saved_model)})")
        cache = s.store.table_cache
        mirror = cache.device
        dev = torch.device("cuda" if device is None else device)
        if cache.stats.get("primes") != 1 or cache.stats["full_builds"] \
                or mirror.stats["uploads"] != 1 or mirror.device != dev:
            fail(f"{what}: after the construction the table cache "
                 f"{cache.stats}, the mirror {mirror.snapshot()} on "
                 f"{mirror.device}")
        version0 = mirror.version
        t0 = time.perf_counter()
        s.start()
        start_s = time.perf_counter() - t0
        print(f"{what}: started in {start_s:.3f} s", flush=True)
        names = {n.id: n.name for n in nodes}
        if device is None:
            torch.cuda.synchronize()
        kernels.reset_launches()
        walls, first_stages, placements = [], None, []
        for i, job in enumerate(jobs):
            if i == 0:
                stages.enable()
            s.register_job(copy.deepcopy(job))
            t0 = time.perf_counter()
            if not _wait_placed(s, [job], SERVER_WAIT_S):
                fail(f"{what}: {job.id} was not placed")
            walls.append(time.perf_counter() - t0)
            _idle(s, what)
            if i == 0:
                first_stages = {k: v["seconds"]
                                for k, v in stages.snapshot().items()
                                if v["calls"]}
                stages.disable()
                if cache.stats["full_builds"] or \
                        mirror.version == version0:
                    fail(f"{what}: the first eval's table: cache "
                         f"{cache.stats}, mirror version {mirror.version} "
                         f"(primed {version0})")
                served_table_matches(s.store, what + ", first eval",
                                     "mirror")
            allocs = s.store.allocs_by_job(job.namespace, job.id)
            evals = s.store.evals_by_job(job.namespace, job.id)
            if len(allocs) != job.task_groups[0].count or any(
                    e.status != "complete" for e in evals):
                fail(f"{what}: {job.id} {len(allocs)} placed, evals "
                     f"{[e.status for e in evals]}")
            placements.append(sorted((a.name, names[a.node_id])
                                     for a in allocs))
        if device is None:
            torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if cache.stats["full_builds"] or mirror.stats["uploads"] != 1:
            fail(f"{what}: after the restart's jobs the table cache "
                 f"{cache.stats}, the mirror {mirror.snapshot()}")
        served_table_matches(s.store, what, "mirror")
        server_capacity_check(s, names, what)
        model = S.cost_model.snapshot()
        return dict(cold=dict(s.cold_start_stats), construct_s=construct_s,
                    start_s=start_s, walls=walls, stages=first_stages,
                    placements=placements, launches=launches,
                    table=dict(cache.stats), mirror=mirror.snapshot(),
                    seeded=sorted(k for k in saved_model
                                  if model[k]["samples"]
                                  == S.DispatchCostModel.MIN_SAMPLES),
                    sampled=sorted(k for k in saved_model
                                   if model[k]["samples"]
                                   > S.DispatchCostModel.MIN_SAMPLES),
                    live=sorted(set(model) - set(saved_model)))
    finally:
        stages.disable()
        s.shutdown()


def restart_phase(nodes, mock, models, info):
    """Phase 12 (see the module's docstring). Returns the card server's
    launches during the restart's jobs."""
    import os
    import shutil
    import tempfile
    from nomad_tpu_torch.server.persistence import Persistence, RaftLog
    t_phase = time.perf_counter()
    warm, jobs = server_jobs(mock, models)
    after = restart_jobs(mock, models)
    base = tempfile.mkdtemp(prefix="nomad-torch-restart-")
    try:
        life = os.path.join(base, "life")
        want, warm_wall, warm_stages, snaps = restart_first_life(
            life, nodes, warm, jobs)
        log = os.path.join(life, Persistence.WAL)
        snap = os.path.join(life, Persistence.SNAPSHOT)
        entries = RaftLog(log).replay()
        kinds = {}
        for _i, kind, _p, _ts in entries:
            kinds[kind] = kinds.get(kind, 0) + 1
        with open(os.path.join(life, Persistence.COST_MODEL)) as f:
            saved_model = json.load(f)
        print(f"restart phase: first life {len(want['allocs'])} allocs of "
              f"{len(want['jobs'])} jobs at index {want['index']}; WAL tail "
              f"{len(entries)} entries {kinds}, {os.path.getsize(log)} "
              f"bytes; snapshot {os.path.getsize(snap)} bytes (columnar; "
              f"taken in {snaps[0]:.3f} s with the nodes alone, "
              f"{snaps[1]:.3f} s after {len(jobs) // 2 + 1} jobs); cost "
              f"model saved with {len(saved_model)} shapes", flush=True)
        dirs = {dev: shutil.copytree(life, os.path.join(base, str(dev)))
                for dev in (None, "cpu")}
        card = restart_life(dirs[None], None, want, saved_model, nodes,
                            after)
        cpu = restart_life(dirs["cpu"], "cpu", want, saved_model, nodes,
                           after)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    for job, g, c in zip(after, card["placements"], cpu["placements"]):
        if g != c:
            diff = [p for p in g if p not in c][:3]
            fail(f"restart phase: {job.id} placed differently on the card "
                 f"and the CPU, e.g. {diff}")
    for name in RESTART_KERNELS:
        if card["launches"].get(name, 0) < 1:
            fail(f"restart phase: the restart's jobs never launched the "
                 f"{name} kernel ({card['launches']})")
    for r, where in ((card, "the card"), (cpu, "the CPU")):
        cold = {k: round(v, 6) for k, v in r["cold"].items()}
        walls = ", ".join(f"{j.id} {w:.3f} s"
                          for j, w in zip(after, r["walls"]))
        print(f"restart phase on {where}: construction "
              f"{r['construct_s']:.3f} s, cold_start_stats "
              f"{json.dumps(cold)}; start {r['start_s']:.3f} s; evals "
              f"{walls}; table cache {r['table']}; mirror "
              f"{json.dumps({k: r['mirror'][k] for k in MIRROR_KEYS})}; "
              f"cost model: restored "
              f"with no live sample counted since (a restored shape drops "
              f"its first) {r['seeded']}, restored then sampled live "
              f"{r['sampled']}, live only {r['live']}", flush=True)
    print(f"restart phase: first eval after the restart "
          f"{card['walls'][0]:.3f} s on the card (by stage, s: "
          f"{json.dumps(card['stages'])}) against the first life's first "
          f"eval {warm_wall:.3f} s ({json.dumps(warm_stages)}); restored "
          f"state equal to the first life's on the card and the CPU; "
          f"placements identical; no full table build; one mirror upload "
          f"(the prefetch's); launches {card['launches']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({info['raw']})",
          flush=True)
    return card["launches"]


# the ring phase: three servers on the card, one worker each and the
# follower scheduling plane at its defaults (follower_max_remote 2). The
# three share one process and its interpreter lock: a peer stalled by
# another's host work (a full garbage collection of the replicas' heap
# takes seconds) must not read as dead, so the failure timers scale as
# Nomad's raft_multiplier scales raft's (its documented maximum is 10)
RING_RAFT_MULTIPLIER = 5
# five schedulers on three replicas collide on the same best nodes: an
# eval whose plans two (batch) or five (service) rounds in a row place
# nothing is blocked until the leader's timer requeues it, and one nacked
# past the broker's delivery limit (a fence timed out on a stalled
# replica) is failed with a follow-up eval; both wait Nomad's 60 s,
# shortened to fit the phase
RING_UNBLOCK_S = 5.0
RING_CFG = dict(num_schedulers=1, heartbeat_ttl_s=3600.0,
                dead_server_cleanup_s=0.0, gc_safepoints=True,
                raft_multiplier=RING_RAFT_MULTIPLIER,
                failed_eval_unblock_delay_s=RING_UNBLOCK_S)
RING_WAIT_S = 240
# threads that register the nodes through the leader's raft at once, so
# the log's entries ride AppendEntries in batches
RING_SEEDERS = 32
# the kernels the ring must launch: rows 1, 3, 5 (each replica's
# placements) and 7 (each replica's table deltas reaching its mirror)
RING_KERNELS = ("chunked", "kway", "scan", "scatter_set")


def _ring_leader(servers, what, timeout_s=30.0):
    """The ring's one leader, waited for; fails if none is elected."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        leaders = [s for s in servers if s.raft.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.005)
    fail(f"{what}: no single leader elected in {timeout_s:.0f} s "
         f"({[s.raft.role for s in servers]})")


def _ring_call(servers, what, fn):
    """fn(leader) through the ring's current leader, again through the
    next one while a leadership move refuses it (RpcRefused and the
    raft's "not the leader" / term-moved errors are RuntimeErrors), as a
    client rehomes."""
    deadline = time.perf_counter() + 60
    while True:
        try:
            return fn(_ring_leader(servers, what))
        except RuntimeError:
            if time.perf_counter() > deadline:
                raise
            time.sleep(0.05)


def _ring_register(servers, what, jobs):
    """Every job through the leader's register_jobs_bulk; slots a
    leadership move refused go again through the next leader."""
    import copy
    pending = list(jobs)
    deadline = time.perf_counter() + 60
    while pending:
        out = _ring_call(servers, what, lambda lead: lead.register_jobs_bulk(
            [copy.deepcopy(j) for j in pending]))
        bad = [(j, r) for j, r in zip(pending, out)
               if isinstance(r, Exception)]
        other = [(j.id, r) for j, r in bad
                 if not isinstance(r, RuntimeError)]
        if other or (bad and time.perf_counter() > deadline):
            fail(f"{what}: registers failed: {(other or bad)[:3]}")
        pending = [j for j, _r in bad]


def _evals_done(store, job):
    """Every eval of the job complete, or failed with the eval it left
    done in turn: the blocked eval of an eval out of plan attempts
    (`blocked_eval`, requeued by the leader's timer) or the reaper's
    follow-up of an eval past the broker's delivery limit (`next_eval`).
    The chain each eval started ends complete."""
    evs = {e.id: e for e in store.evals_by_job(job.namespace, job.id)}

    def done(e, depth=0):
        if e.status == "complete":
            return True
        if e.status != "failed" or depth >= 16:
            return False
        nxt = evs.get(e.blocked_eval or e.next_eval)
        return nxt is not None and done(nxt, depth + 1)
    return all(done(e) for e in evs.values())


def _failed_evals(store, jobs):
    """The jobs' evals that failed, by what took their work on: out of
    plan attempts (a blocked eval) and past the broker's delivery limit
    (the reaper's follow-up)."""
    evs = [e for j in jobs for e in store.evals_by_job(j.namespace, j.id)
           if e.status == "failed"]
    return dict(max_plans=sum(1 for e in evs if e.blocked_eval),
                delivery_limit=sum(1 for e in evs if not e.blocked_eval))


def _ring_settled(servers, jobs, what):
    """Every job placed to its count on the leader, every eval chain of
    them ended complete (_evals_done), the leader's broker idle, and
    every replica at the leader's applied index."""
    deadline = time.perf_counter() + RING_WAIT_S
    while time.perf_counter() < deadline:
        lead = _ring_leader(servers, what)
        if all(len(lead.store.allocs_by_job(j.namespace, j.id))
               >= j.task_groups[0].count for j in jobs) and all(
                _evals_done(lead.store, j) for j in jobs) \
                and not lead.eval_broker.stats.total_ready \
                and not lead.eval_broker.stats.total_unacked \
                and all(s._raft_index == lead._raft_index
                        for s in servers):
            return lead
        time.sleep(0.01)
    lead = _ring_leader(servers, what)
    short = [(j.id, len(lead.store.allocs_by_job(j.namespace, j.id)),
              j.task_groups[0].count,
              [(e.status, e.triggered_by) for e in
               lead.store.evals_by_job(j.namespace, j.id)])
             for j in jobs
             if len(lead.store.allocs_by_job(j.namespace, j.id))
             < j.task_groups[0].count or not _evals_done(lead.store, j)]
    fail(f"{what}: not settled in {RING_WAIT_S} s: "
         f"{sum(len(lead.store.allocs_by_job(j.namespace, j.id)) for j in jobs)}"
         f" allocs, broker {lead.eval_broker.stats.as_dict()}, blocked "
         f"{lead.blocked_evals.blocked_count()}, applied "
         f"{[s._raft_index for s in servers]}; jobs short or with evals "
         f"not complete (id, allocs, count, evals) {short[:4]}")


def ring_phase(nodes, mock, models, single_manifest, info):
    """Phase 13 (see the module's docstring). Returns the phase's
    launches."""
    import copy
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.ops import select as S
    from nomad_tpu_torch.rpc import RpcServer
    from nomad_tpu_torch.rpc.codec import MAX_FRAME, dumps
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils import gcsafe, metrics, stages
    what = "ring phase"
    t_phase = time.perf_counter()
    warm, jobs = server_jobs(mock, models)
    after = restart_jobs(mock, models)[:2]
    for job in after:
        job.id = job.name = job.id.replace("restart", "failover")
    names = {n.id: n.name for n in nodes}
    # the process-wide dispatch cost model as a fresh server starts it,
    # calibrated at the phase's table shape (phase 11's idiom)
    S.cost_model.clear()
    S.calibrate_cost_model(len(nodes), count=10, lanes=1,
                           kernel=S.SelectKernel(None))
    servers, rpcs = [], []
    for _ in range(3):
        s = Server(ServerConfig(**RING_CFG), device=None)
        if s.device.type != "cuda":
            fail(f"{what}: a server runs on {s.device}, not the card")
        servers.append(s)
        rpcs.append(RpcServer(s, port=0))
    addrs = [r.addr for r in rpcs]
    alive = list(zip(servers, rpcs))
    try:
        for s, r in alive:
            s.attach_raft(r, addrs)
            r.start()
            s.start()
        t0 = time.perf_counter()
        lead = _ring_leader(servers, what)
        elect_s = time.perf_counter() - t0
        index0 = lead.raft.last_log()[0]

        def raft_totals():
            return {k: sum(s.raft.stats[k] for s in servers)
                    for k in ("append_entries", "entries_sent")}
        raft0 = raft_totals()

        # 1. the nodes through the leader's raft
        t0 = time.perf_counter()
        with ThreadPoolExecutor(RING_SEEDERS) as pool:
            list(pool.map(lambda n: _ring_call(
                servers, what, lambda ld: ld.register_node(
                    copy.deepcopy(n))), nodes))
        seed_s = time.perf_counter() - t0
        deadline = time.perf_counter() + 60
        while any(s.store.node_count() != len(nodes) for s in servers):
            if time.perf_counter() > deadline:
                fail(f"{what}: nodes did not replicate "
                     f"({[s.store.node_count() for s in servers]})")
            time.sleep(0.01)
        lead = _ring_leader(servers, what)
        seeded_entries = lead.raft.last_log()[0] - index0
        seed_raft = {k: v - raft0[k] for k, v in raft_totals().items()}

        # 2. a follower reseeded by InstallSnapshot from the compacted log
        follower = next(s for s in servers if s is not lead)
        fi = servers.index(follower)
        while any(s._raft_index != lead._raft_index for s in servers):
            time.sleep(0.005)
        lead.raft.compact(keep=0)
        base = lead.raft.base_index
        snaps0 = lead.raft.stats["snapshots_sent"]
        t0 = time.perf_counter()
        follower.raft.needs_snapshot = True
        deadline = time.perf_counter() + 120
        while follower.raft.needs_snapshot or \
                follower.raft.base_index < base or \
                lead.raft.stats["snapshots_sent"] == snaps0:
            if time.perf_counter() > deadline:
                fail(f"{what}: the follower was not reseeded")
            time.sleep(0.002)
        reseed_s = time.perf_counter() - t0
        frame = len(dumps([0, "Raft.InstallSnapshot", dict(
            term=lead.raft.term, leader=lead.raft.self_addr,
            snapshot=lead.store.snapshot().dump(),
            base_index=follower.raft.base_index,
            base_term=follower.raft.base_term)]))
        if frame > MAX_FRAME:
            fail(f"{what}: the reseed's frame {frame} bytes is past "
                 f"MAX_FRAME {MAX_FRAME}")
        if server_state(follower) != server_state(lead):
            fail(f"{what}: the reseeded follower's store differs from the "
                 f"leader's")
        cache = follower.store.table_cache
        if cache.stats.get("primes") != 1 or cache.stats["full_builds"] \
                or cache.device.stats["uploads"] != 1 \
                or cache.device.device.type != "cuda":
            fail(f"{what}: the reseeded follower's table cache "
                 f"{cache.stats}, mirror {cache.device.snapshot()} on "
                 f"{cache.device.device}")
        served_table_matches(follower.store, f"{what}, reseeded follower",
                             "mirror")
        # the three replicas' nodes are the long-lived heap: out of every
        # later collection (the servers' gc_safepoints collect the young
        # generations between evals, a full pass every 10 s)
        gcsafe.freeze_steady_state()
        print(f"{what}: 3 servers on the card, leader elected in "
              f"{elect_s:.3f} s; {len(nodes)} nodes registered through "
              f"the leader's raft in {seed_s:.3f} s ({RING_SEEDERS} "
              f"threads): {seeded_entries} log entries in "
              f"{seed_raft['append_entries']} AppendEntries calls "
              f"({seed_raft['entries_sent']} entries sent); reseed by "
              f"InstallSnapshot of the compacted log (base index {base}) "
              f"in {reseed_s:.3f} s, frame {frame} bytes against MAX_FRAME "
              f"{MAX_FRAME}; the follower's store equals the leader's, its "
              f"table primed (no full build) and its mirror on the card "
              f"equal to its host table row for row", flush=True)

        # 3. the warm job, then the 70 jobs through register_jobs_bulk
        _ring_register(servers, what, [warm])
        lead = _ring_settled(servers, [warm], what + ", warm job")
        stats0 = {s.raft.self_addr: dict(s.follower_sched.snapshot_stats())
                  for s in servers}
        timeouts0 = {s.raft.self_addr: sum(
            w.stats["fence_timeouts"] for w in s.follower_sched.workers)
            for s in servers}
        # summed over the three servers: only the leader's applier,
        # ingest gateway and replication pumps run, whichever it is
        def totals():
            return dict(
                applier={k: sum(s.plan_applier.stats[k] for s in servers)
                         for k in ("groups", "plans", "conflict_retries")},
                ingest={k: sum(s.ingest.stats[k] for s in servers)
                        for k in ("requests", "batches", "entries_sum")},
                raft={k: sum(s.raft.stats[k] for s in servers)
                      for k in ("append_entries", "entries_sent")})
        before = totals()
        lead0 = lead
        term0 = lead.raft.term
        index0 = lead.raft.last_log()[0]
        c0 = metrics.counter_totals()
        torch.cuda.synchronize()
        kernels.reset_launches()
        stages.enable()
        t0 = time.perf_counter()
        _ring_register(servers, what, jobs)
        lead = _ring_settled(servers, jobs, what)
        wall = time.perf_counter() - t0
        split = {k: v["seconds"] for k, v in stages.snapshot().items()
                 if v["calls"]}
        stages.disable()
        c1 = metrics.counter_totals()
        placed = sum(len(lead.store.allocs_by_job(j.namespace, j.id))
                     for j in jobs)
        n_evals = sum(len(lead.store.evals_by_job(j.namespace, j.id))
                      for j in jobs)
        for job in jobs:
            allocs = lead.store.allocs_by_job(job.namespace, job.id)
            if len(allocs) != job.task_groups[0].count:
                fail(f"{what}: {job.id} {len(allocs)}/"
                     f"{job.task_groups[0].count} placed")
        server_capacity_check(lead, names, what)
        manifest = {k: v for k, v in
                    lead.store.scheduler_parity_manifest().items()
                    if k in single_manifest}
        if manifest != single_manifest:
            diff = sorted(k for k in single_manifest
                          if manifest.get(k) != single_manifest[k])
            fail(f"{what}: the alloc-name manifest differs from the single "
                 f"server's for {diff[:5]}")
        plane = {}
        for s in servers:
            # a follower through the whole run: not the leader the jobs
            # started under, nor one elected while they ran (an election
            # after the reseed may move the lead; its term is printed)
            if s is lead or s is lead0:
                continue
            st = s.follower_sched.snapshot_stats()
            a = s.raft.self_addr
            plane[a] = dict(
                remote_dequeues=st["remote_dequeues"]
                - stats0[a]["remote_dequeues"],
                remote_plans=st["remote_plans"] - stats0[a]["remote_plans"],
                demoted_plans=st["demoted_plans"]
                - stats0[a]["demoted_plans"],
                fence_wait_p99_ms=st["fence_wait_p99_ms"],
                fence_timeouts=sum(w.stats["fence_timeouts"]
                                   for w in s.follower_sched.workers)
                - timeouts0[a])
            if plane[a]["remote_dequeues"] < 1 or \
                    plane[a]["remote_plans"] < 1:
                fail(f"{what}: follower {a} did not schedule remotely "
                     f"({plane[a]})")
        after_ = totals()
        ap, ing, raft = ({k: after_[part][k] - before[part][k]
                          for k in before[part]}
                         for part in ("applier", "ingest", "raft"))
        rejected = c1.get("nomad.plan.node_rejected", 0.0) - c0.get(
            "nomad.plan.node_rejected", 0.0)
        entries = lead.raft.last_log()[0] - index0
        print(f"{what}: {len(jobs)} jobs through register_jobs_bulk, "
              f"{placed} placements, {n_evals} evals in {wall:.3f} s: "
              f"{placed / wall:.1f} placements/s, {n_evals / wall:.2f} "
              f"evals/s; by follower (remote dequeues, plans, demoted "
              f"plans, fence-wait p99 ms, fence timeouts) "
              f"{json.dumps(plane)}; applier commits {ap['groups']} of "
              f"{ap['plans']} plans (mean group "
              f"{ap['plans'] / max(ap['groups'], 1):.2f}), rejected "
              f"placements {rejected:.0f}, conflict retries "
              f"{ap['conflict_retries']}; leader terms {term0}-"
              f"{lead.raft.term}; ingest {ing['requests']} writes "
              f"in {ing['batches']} batches (mean "
              f"{ing['entries_sum'] / max(ing['batches'], 1):.2f}); raft "
              f"{entries} entries in {raft['append_entries']} AppendEntries "
              f"calls; failed evals whose work went on in another (out of "
              f"plan attempts, requeued on the leader's "
              f"{RING_UNBLOCK_S:.0f} s timer; past the delivery limit, "
              f"followed up after {RING_UNBLOCK_S:.0f} s) "
              f"{json.dumps(_failed_evals(lead.store, jobs))}; manifest "
              f"equal to the "
              f"single card server's; no node over capacity; stage seconds summed over the three servers' "
              f"evals {json.dumps(split)}", flush=True)

        # 4. the leader killed; the survivors elect and keep placing
        li = servers.index(lead)
        t0 = time.perf_counter()
        rpcs[li].shutdown()
        lead.shutdown()
        killed = time.perf_counter() - t0
        alive = [(s, r) for s, r in alive if s is not lead]
        rest = [s for s, _r in alive]
        t0 = time.perf_counter()
        new = _ring_leader(rest, what + " after the kill")
        reelect_s = time.perf_counter() - t0
        _ring_register(rest, what + " after the kill", after)
        new = _ring_settled(rest, after, what + " after the kill")
        server_capacity_check(new, names, what + " after the kill")
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        # writes may still trickle in (SWIM's removal of the killed
        # server rides the log): compare once both replicas applied the
        # same index
        deadline = time.perf_counter() + 60
        while True:
            applied = [s._raft_index for s in rest]
            states = [server_state(s) for s in rest]
            if applied[0] == applied[1] and states[0] == states[1]:
                break
            if time.perf_counter() > deadline:
                diff = {k: (states[0][k], states[1][k])
                        if k == "index" else len(states[0][k])
                        for k in states[0] if states[0][k] != states[1][k]}
                fail(f"{what}: the surviving replicas' stores differ "
                     f"(applied {applied}): {diff}")
            time.sleep(0.05)
        for name in RING_KERNELS:
            if launches.get(name, 0) < 1:
                fail(f"{what}: the {name} kernel was never launched "
                     f"({launches})")
        end_frame = len(dumps(new.store.snapshot().dump()))
        print(f"{what}: leader stopped in {killed:.3f} s; new leader "
              f"elected {reelect_s:.3f} s after; {', '.join(j.id for j in after)} "
              f"placed through it; the survivors' stores equal (jobs, "
              f"allocs by id with node and statuses, eval statuses, index "
              f"{states[0]['index']}); a snapshot of the whole store would "
              f"be {end_frame} bytes against MAX_FRAME {MAX_FRAME}; "
              f"launches {launches}; the reseeded follower "
              f"{'survived as the new leader' if servers[fi] is new else 'survived as a follower' if servers[fi] in rest else 'was the killed leader'}"
              f"; phase {time.perf_counter() - t_phase:.1f} s "
              f"({info['raw']})", flush=True)
        # one heartbeat timers thread, the new leader's, for every node
        deadline = time.perf_counter() + 5
        while True:
            timers = [t for t in threading.enumerate()
                      if t.name == "heartbeat-timers" and t.is_alive()]
            if timers == [new._heartbeats._thread]:
                break
            if time.perf_counter() > deadline:
                fail(f"{what}: {len(timers)} heartbeat timers threads "
                     f"alive, the new leader's "
                     f"{new._heartbeats._thread is not None}")
            time.sleep(0.01)
        return launches
    finally:
        stages.disable()
        for s, r in alive:
            r.shutdown()
            s.shutdown()
        gcsafe.unfreeze_steady_state()



# phase 14: the agent's front door (the HTTP API, the CLI, ACLs, the
# event-sink manager) in this process through start_agent, then
# `python -m nomad_tpu_torch agent` as a user starts it
AGENT_SEEDERS = 32
# the nodes part (b) registers with the subprocess agent
AGENT_SUB_NODES = 1_000
# no node heartbeats here: the TTL outlasts the phase
AGENT_HEARTBEAT_TTL_S = 3600
AGENT_WAIT_S = 120
# (job id, type, count, the kernel its eval runs); the spread job is the
# main path's `${meta.rack}` spread with its affinity
AGENT_JOBS = (("agent-service", "service", 10, "chunked"),
              ("agent-batch", "batch", 2_500, "kway"),
              ("agent-spread", "service", 200, "scan"))
AGENT_KERNELS = ("chunked", "kway", "scan", "scatter_set")
# each instance's ask, as the job files say
AGENT_CPU, AGENT_MEM = 500, 256
WRITE_POLICY = 'namespace "default" { policy = "write" }\n'
READ_POLICY = 'namespace "default" { policy = "read" }\n'


def agent_hcl(job_id, kind, count, cpu=AGENT_CPU, memory=AGENT_MEM,
              not_on=""):
    """The job file `nomad job run` reads: `count` instances of `cpu`
    MHz and `memory` MB, kept off the node named `not_on` if given."""
    spread = ""
    if not_on:
        spread = f'''
  constraint {{
    attribute = "${{node.unique.name}}"
    operator  = "!="
    value     = "{not_on}"
  }}'''
    if job_id.endswith("spread"):
        spread = '''
  spread {
    attribute = "${meta.rack}"
    weight    = 60
    target "r1" { percent = 30 }
    target "r2" { percent = 20 }
  }
  affinity {
    attribute = "${meta.rack}"
    value     = "r3"
    weight    = 40
  }'''
    return f'''job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "{kind}"{spread}
  group "g" {{
    count = {count}
    task "t" {{
      driver = "exec"
      config {{ command = "/bin/date" }}
      resources {{
        cpu    = {cpu}
        memory = {memory}
      }}
    }}
  }}
}}
'''


class _Receiver:
    """A loopback webhook: collects the NDJSON events the sink POSTs."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer
        self.events = []
        self._l = threading.Lock()
        rx = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                with rx._l:
                    rx.events.extend(json.loads(line) for line in
                                     body.decode().splitlines()
                                     if line.strip())
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/hook"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def snapshot(self):
        with self._l:
            return list(self.events)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join()


def _cli(addr, token, *argv):
    """One `nomad` command through the port's CLI main(), in this
    process: (exit code, standard output, seconds)."""
    import contextlib
    import io
    from nomad_tpu_torch.cli.main import main as cli_main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-address", addr, "-token", token, *argv])
    return rc, out.getvalue(), time.perf_counter() - t0


def _secret(out):
    for line in out.splitlines():
        if line.startswith("Secret ID"):
            return line.split("=", 1)[1].strip()
    fail(f"agent phase: no secret in {out!r}")


def _register_over_rpc(addr, nodes, threads):
    """Node.Register for every node over the agent's RPC port, from
    `threads` threads with a connection each; returns the seconds."""
    import copy
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from nomad_tpu_torch.rpc.client import RpcClient
    from nomad_tpu_torch.utils.codec import to_wire
    local = threading.local()
    clients = []

    def register(node):
        c = getattr(local, "c", None)
        if c is None:
            c = local.c = RpcClient(addr)
            clients.append(c)
        c.call("Node.Register", {"node": to_wire(copy.deepcopy(node))})

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(register, nodes))
    finally:
        for c in clients:
            c.close()
    return time.perf_counter() - t0


def agent_placements(api, names, jobs, nodes, what, local=()):
    """Every job placed to its count, every eval complete and no node
    over capacity, recomputed from /v1/allocations and /v1/nodes;
    returns ({job id: sorted (alloc name, node name)}, alloc ids).
    `local` names the agent's own client nodes: /v1/nodes lists them
    ready beside `nodes`, and their allocs are not counted."""
    listed = api.list_nodes()
    served = {n["id"]: n for n in listed if n["name"] not in local}
    own = {n["id"] for n in listed if n["name"] in local}
    if len(served) != len(nodes) or len(own) != len(local) or any(
            n["status"] != "ready" for n in listed):
        fail(f"{what}: /v1/nodes lists {len(listed)} nodes, "
             f"{sum(n['status'] == 'ready' for n in listed)} ready, of "
             f"{len(nodes)} and the local {list(local)}")
    allocs = api.list_allocations()
    by_node, places, ids = {}, {}, set()
    for a in allocs:
        if a["desired_status"] != "run" or a["node_id"] in own:
            continue
        by_node[a["node_id"]] = by_node.get(a["node_id"], 0) + 1
        places.setdefault(a["job_id"], []).append(
            (a["name"], names[a["node_id"]]))
        ids.add(a["id"])
    for job_id, _kind, count, _arm in jobs:
        got = len(places.get(job_id, []))
        evals = api._request("GET", f"/v1/job/{job_id}/evaluations")
        if got != count or not evals or any(
                e["status"] != "complete" for e in evals):
            fail(f"{what}: {job_id} has {got}/{count} allocs, evals "
                 f"{[e['status'] for e in evals]}")
    for node in nodes:
        total = node.comparable_resources()
        reserved = node.comparable_reserved_resources()
        k = by_node.get(node.id, 0)
        if reserved.cpu_shares + k * AGENT_CPU > total.cpu_shares or \
                reserved.memory_mb + k * AGENT_MEM > total.memory_mb:
            fail(f"{what}: node {node.name} over capacity with {k} allocs")
    return {j: sorted(p) for j, p in places.items()}, ids


def agent_reference(nodes, parsed, names):
    """The same nodes and parsed jobs, in the same order, through an
    in-process Server(device="cpu"): {job id: sorted placements}."""
    import copy
    from nomad_tpu_torch.server import Server, ServerConfig
    s = Server(ServerConfig(num_schedulers=1,
                            heartbeat_ttl_s=AGENT_HEARTBEAT_TTL_S),
               device="cpu")
    s.start()
    try:
        for node in nodes:
            s.register_node(copy.deepcopy(node))
        out = {}
        for job in parsed:
            s.register_job(copy.deepcopy(job))
            want = sum(tg.count for tg in job.task_groups)
            deadline = time.perf_counter() + AGENT_WAIT_S
            while True:
                evals = s.store.evals_by_job(job.namespace, job.id)
                if evals and all(e.status == "complete" for e in evals):
                    break
                if time.perf_counter() > deadline:
                    fail(f"agent phase: the CPU server left {job.id} "
                         f"with evals {[e.status for e in evals]}")
                time.sleep(0.01)
            allocs = s.store.allocs_by_job(job.namespace, job.id)
            if len(allocs) != want:
                fail(f"agent phase: the CPU server placed "
                     f"{len(allocs)}/{want} of {job.id}")
            out[job.id] = sorted((a.name, names[a.node_id])
                                 for a in allocs)
        return out
    finally:
        s.shutdown()


def agent_in_process(nodes, info, jobs, device, tmp):
    """Part (a): start_agent with -dev -clients 0 -acl-enabled
    -num-schedulers 1 on `device` (None: the card), the nodes over its
    RPC port, ACLs, a webhook sink and the job files through the CLI.
    Returns the launches of the jobs' run."""
    import os
    import torch
    from nomad_tpu_torch.api import ApiClient, ApiError
    from nomad_tpu_torch.cli.main import build_parser, start_agent
    from nomad_tpu_torch.jobspec import job_to_spec, parse_job_file
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.utils import gcsafe
    what = "agent phase (a)"
    names = {n.id: n.name for n in nodes}
    argv = ["agent", "-dev", "-clients", "0", "-acl-enabled",
            "-num-schedulers", "1", "-http-port", "0", "-rpc-port", "0",
            "-heartbeat-ttl", str(AGENT_HEARTBEAT_TTL_S)]
    if device is not None:
        argv += ["-device", device]
    agent = start_agent(build_parser().parse_args(argv))
    rx = _Receiver()
    try:
        if device is None and agent.server.device.type != "cuda":
            fail(f"{what}: the agent schedules on {agent.server.device}")
        addr = f"http://127.0.0.1:{agent.api.port}"
        seed_s = _register_over_rpc(agent.rpc.addr, nodes, AGENT_SEEDERS)
        # 1. ACLs through the CLI
        rc, out, _ = _cli(addr, "", "acl", "bootstrap")
        if rc != 0:
            fail(f"{what}: acl bootstrap exited {rc}: {out}")
        mgmt = _secret(out)
        paths = {}
        for name, text in (("write-default", WRITE_POLICY),
                           ("read-default", READ_POLICY)):
            paths[name] = os.path.join(tmp, f"{name}.hcl")
            with open(paths[name], "w") as f:
                f.write(text)
            rc, out, _ = _cli(addr, mgmt, "acl", "policy-apply", name,
                              paths[name])
            if rc != 0:
                fail(f"{what}: acl policy-apply {name} exited {rc}")
        rc, out, _ = _cli(addr, mgmt, "acl", "token-create", "-name",
                          "deployer", "-policy", "write-default")
        client_tok = _secret(out)
        rc, out, _ = _cli(addr, mgmt, "acl", "token-create", "-name",
                          "reader", "-policy", "read-default")
        reader_tok = _secret(out)
        # 2. the webhook sink
        rc, out, _ = _cli(addr, mgmt, "event", "sink-register", rx.url)
        if rc != 0:
            fail(f"{what}: event sink-register exited {rc}: {out}")
        # 3. the jobs through `nomad job run`, one after another
        files = []
        for job_id, kind, count, _arm in jobs:
            path = os.path.join(tmp, f"{job_id}.hcl")
            with open(path, "w") as f:
                f.write(agent_hcl(job_id, kind, count))
            files.append(path)
        parsed = [parse_job_file(p) for p in files]
        gcsafe.freeze_steady_state()
        if device is None:
            torch.cuda.synchronize()
        kernels.reset_launches()
        walls = []
        for path, (job_id, _k, _c, _a) in zip(files, jobs):
            rc, out, wall = _cli(addr, client_tok, "job", "run", path)
            if rc != 0 or "finished with status \"complete\"" not in out:
                fail(f"{what}: job run {job_id} exited {rc}: {out}")
            walls.append(wall)
        if device is None:
            torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        rc, out, status_s = _cli(addr, client_tok, "job", "status",
                                 jobs[0][0])
        if rc != 0 or jobs[0][0] not in out:
            fail(f"{what}: job status exited {rc}: {out}")
        # 4. a token that may only read default may not write there
        try:
            ApiClient(addr, token=reader_tok).register_job(
                job_to_spec(parsed[0]))
            fail(f"{what}: a read-only token registered a job")
        except ApiError as e:
            if e.status != 403:
                fail(f"{what}: a read-only token's register answered "
                     f"{e.status}, not 403")
        api = ApiClient(addr, token=mgmt)
        places, alloc_ids = agent_placements(api, names, jobs, nodes, what)
        # 5. the sink delivered the jobs' registrations and allocations
        deadline = time.perf_counter() + 30
        while True:
            got = rx.snapshot()
            registered = {e["key"] for e in got
                          if e["type"] == "JobRegistered"}
            placed = {e["key"] for e in got if e["type"] == "PlanResult"}
            if registered >= {j[0] for j in jobs} and placed >= alloc_ids:
                break
            if time.perf_counter() > deadline:
                fail(f"{what}: the sink delivered {len(registered)} job "
                     f"registrations and {len(placed & alloc_ids)} of "
                     f"{len(alloc_ids)} placements")
            time.sleep(0.05)
        # 6. the flight recorder, governor and telemetry collector
        obs = agent_observability(api, jobs, what)
        ref = agent_reference(nodes, parsed, names)
        for job_id, *_ in jobs:
            if places[job_id] != ref[job_id]:
                diff = [p for p in places[job_id]
                        if p not in ref[job_id]][:3]
                fail(f"{what}: {job_id}'s placements differ from the CPU "
                     f"server's, e.g. {diff}")
        if device is None:
            for name in AGENT_KERNELS:
                if launches.get(name, 0) < 1:
                    fail(f"{what}: the {name} kernel was never launched "
                         f"({launches})")
        print(f"{what}: {len(nodes)} nodes over RPC ({AGENT_SEEDERS} "
              f"threads) in {seed_s:.3f} s; job run "
              + ", ".join(f"{j[0]} (count {j[2]}, {j[3]}) {w:.3f} s"
                          for j, w in zip(jobs, walls))
              + f" (CLI call to eval complete, polled every 0.2 s); job "
              f"status {status_s:.3f} s; a read-only token's register "
              f"403; the sink delivered {len(got)} events ("
              f"{len(registered)} job registrations, {len(placed)} "
              f"placements); placements identical to an in-process "
              f"Server(device=\"cpu\"); launches {launches} "
              f"({info['raw']})", flush=True)
        print(f"{what}: /v1/operator/trace {obs['traces']} traces in the "
              f"ring, the jobs' evals among them; ?format=chrome "
              f"{obs['events']} trace events on tracks {obs['tracks']}; "
              f"/v1/operator/governor {obs['gauges']} gauges; "
              f"/v1/operator/telemetry {obs['samples']} samples of "
              f"{obs['series']} series; /v1/metrics?format=prometheus "
              f"{obs['device_metrics']} nomad_device_* lines; "
              f"{obs['seconds']:.3f} s", flush=True)
        return launches
    finally:
        gcsafe.unfreeze_steady_state()
        agent.shutdown()
        rx.close()


def agent_observability(api, jobs, what):
    """The agent's observability routes through the in-process ApiClient
    (a CLI process would import torch anew): /v1/operator/trace as JSON
    (enabled, the jobs' evals among its recent traces) and as Chrome
    trace-event JSON (loads, every event a complete or metadata event on
    a named track, with a worker, the gateway and the applier track),
    /v1/operator/governor (enabled, gauges), /v1/operator/telemetry (a
    sample of the ring) and /v1/metrics?format=prometheus naming the
    device.* family. Returns what it read."""
    t0 = time.perf_counter()
    tr = api.trace({"n": "512"})
    got = {t["job_id"] for t in tr.get("recent", [])}
    if not tr.get("enabled") or not {j[0] for j in jobs} <= got:
        fail(f"{what}: /v1/operator/trace lacks the jobs' traces "
             f"({tr.get('ring')}, jobs {sorted(got)[:8]})")
    chrome = json.loads(json.dumps(api.trace({"format": "chrome",
                                              "n": "512"})))
    evs = chrome.get("traceEvents") or []
    named = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    for e in evs:
        if e["ph"] not in ("X", "M") or e["tid"] not in named or (
                e["ph"] == "X" and not (e["ts"] >= 0 and e["dur"] >= 0)):
            fail(f"{what}: a Chrome trace event out of schema: {e}")
    tracks = set(named.values())
    if not ({"gateway", "applier"} <= tracks
            and any(t.startswith("worker-") for t in tracks)):
        fail(f"{what}: the Chrome export's tracks are {sorted(tracks)}")
    gov = api.governor()
    if not gov.get("enabled") or not gov.get("gauges"):
        fail(f"{what}: /v1/operator/governor answered {gov}")
    # the collector samples once a second
    deadline = time.perf_counter() + 5
    while True:
        tel = api.telemetry()
        prom = api.metrics(format="prometheus")
        device = [ln for ln in prom.splitlines()
                  if ln.startswith("nomad_device_")]
        if (tel.get("samples", 0) >= 1 and device) or \
                time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    if not tel.get("enabled") or not tel.get("samples"):
        fail(f"{what}: /v1/operator/telemetry answered "
             f"{ {k: tel.get(k) for k in ('enabled', 'samples')} }")
    if not device:
        fail(f"{what}: /v1/metrics?format=prometheus names no device.* "
             f"metric")
    return dict(traces=tr["ring"]["traces"], events=len(evs),
                tracks=sorted(tracks), gauges=len(gov["gauges"]),
                samples=tel["samples"], series=tel["series_count"],
                device_metrics=len(device),
                seconds=time.perf_counter() - t0)


def agent_phase(nodes, info, device=None, jobs=AGENT_JOBS):
    """Phase 14 (see the module's docstring). Returns the launches of its
    jobs. `device="cpu"` rehearses it on the CPU."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="agent-phase-")
    try:
        launches = agent_in_process(nodes, info, jobs, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"agent phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 15: the node agent on the card (client/, plugins/): the dev
# agent's local client, a client that fingerprints the card, and the
# agent as a user starts it
CLIENT_WAIT_S = 60
CLIENT_KERNELS = ("chunked", "scatter_set")
GPU_CLIENT = "gpu-client"
DEV_CLIENT = "dev-client-0"
# the device job's task holds the card this long, so that the second
# device job meets it exhausted
DEVICE_TASK_S = 3
PINNED_COUNT = 3
# the device group a CPU rehearsal configures in place of the card's
REHEARSAL_GPU = "rehearsal-gpu"


def device_hcl(job_id):
    """A batch job of one raw_exec task that prints its alloc id and
    holds one card for DEVICE_TASK_S seconds."""
    return f'''job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "batch"
  group "g" {{
    count = 1
    task "t" {{
      driver = "raw_exec"
      config {{
        command = "/bin/sh"
        args    = ["-c", "echo $NOMAD_ALLOC_ID; sleep {DEVICE_TASK_S}"]
      }}
      resources {{
        cpu    = 100
        memory = 64
        device "gpu" {{
          count = 1
        }}
      }}
    }}
  }}
}}
'''


def pinned_hcl(job_id, count=PINNED_COUNT):
    """A service job of `count` mock_driver tasks on the dev agent's
    local client."""
    return f'''job "{job_id}" {{
  datacenters = ["dc1"]
  type        = "service"
  constraint {{
    attribute = "${{node.unique.name}}"
    value     = "{DEV_CLIENT}"
  }}
  group "g" {{
    count = {count}
    task "t" {{
      driver = "mock_driver"
      config {{
        run_for = "3600s"
      }}
      resources {{
        cpu    = 100
        memory = 64
      }}
    }}
  }}
}}
'''


def _wait_for(what, pred, timeout_s=CLIENT_WAIT_S, every_s=0.02):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            fail(f"{what}: not reached in {timeout_s} s")
        time.sleep(every_s)


def _allocs_in(store, job_id, status):
    allocs = store.allocs_by_job("default", job_id)
    return allocs if allocs and all(
        a.client_status == status for a in allocs) else []


class _AllocWatch:
    """Polls the store every 5 ms from a thread of its own and keeps the
    time each alloc of `job_id` was first seen placed."""

    def __init__(self, store, job_id):
        import threading
        self.store, self.job_id = store, job_id
        self.placed = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.005):
            for a in self.store.allocs_by_job("default", self.job_id):
                self.placed.setdefault(a.id, time.time())

    def close(self):
        self._stop.set()
        self._thread.join()


def _card_group(device):
    """The device group gpu-client must list: the card's, or on a CPU
    rehearsal the one it is configured with."""
    from nomad_tpu_torch.models import NodeDevice, NodeDeviceResource
    if device is None:
        import torch
        n = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
    else:
        n, name = 1, REHEARSAL_GPU
    return NodeDeviceResource(
        vendor="nvidia", type="gpu", name=name.replace(" ", "-").lower(),
        attributes={"count": n},
        instances=[NodeDevice(id=f"gpu-{i}", healthy=True)
                   for i in range(n)])


def client_reference(client_nodes, nodes, parsed, names):
    """The two clients' nodes, then the 10,000, and the parsed jobs in
    the same order through an in-process Server(device="cpu") with no
    client (its allocs stay pending): {job id: sorted (alloc name, node
    name, device ids)}."""
    import copy
    from nomad_tpu_torch.server import Server, ServerConfig
    s = Server(ServerConfig(num_schedulers=1,
                            heartbeat_ttl_s=AGENT_HEARTBEAT_TTL_S),
               device="cpu")
    s.start()
    try:
        for node in list(client_nodes) + list(nodes):
            s.register_node(copy.deepcopy(node))
        out = {}
        for job in parsed:
            s.register_job(copy.deepcopy(job))
            _wait_for(f"client phase: the CPU server's {job.id}",
                      lambda: (evs := s.store.evals_by_job(
                          job.namespace, job.id)) and all(
                          e.status in ("complete", "blocked")
                          for e in evs))
            out[job.id] = _placements(s.store, job.id, names)
        return out
    finally:
        s.shutdown()


def _placements(store, job_id, names):
    out = []
    for a in store.allocs_by_job("default", job_id):
        devs = []
        if a.allocated_resources is not None:
            for tr in a.allocated_resources.tasks.values():
                for d in tr.devices:
                    devs += list(d.device_ids)
        out.append((a.name, names.get(a.node_id), tuple(devs)))
    return sorted(out)


def client_in_process(nodes, info, device, tmp):
    """Part (a) of phase 15 (see the module's docstring). Returns the
    launches of its jobs."""
    import os
    import torch
    from nomad_tpu_torch.cli.main import build_parser, start_agent
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.client.agent import fingerprint_accelerator_devices
    from nomad_tpu_torch.jobspec import parse_job_file
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.plugins.device_client import ExternalDevicePlugin
    from nomad_tpu_torch.utils.codec import to_wire
    what = "client phase (a)"
    argv = ["agent", "-dev", "-clients", "1", "-num-schedulers", "1",
            "-http-port", "0", "-rpc-port", "0",
            "-heartbeat-ttl", str(AGENT_HEARTBEAT_TTL_S)]
    if device is not None:
        argv += ["-device", device]
    agent = start_agent(build_parser().parse_args(argv))
    gpu = None
    plugin = ExternalDevicePlugin()
    try:
        s = agent.server
        if device is None and s.device.type != "cuda":
            fail(f"{what}: the agent schedules on {s.device}")
        if len(agent.clients) != 1:
            fail(f"{what}: the dev agent runs {len(agent.clients)} clients")
        addr = f"http://127.0.0.1:{agent.api.port}"
        want_group = to_wire(_card_group(device))
        t0 = time.perf_counter()
        groups = fingerprint_accelerator_devices()
        fp_s = time.perf_counter() - t0
        if device is None and [to_wire(g) for g in groups] != [want_group]:
            fail(f"{what}: fingerprint_accelerator_devices() gave "
                 f"{[to_wire(g) for g in groups]}, not [{want_group}]")
        t0 = time.perf_counter()
        gpu = Client(s, ClientConfig(
            node_name=GPU_CLIENT, fingerprint_accelerators=device is None,
            plugin_device_fingerprint=False,
            devices=() if device is None else (_card_group(device),),
            alloc_dir=os.path.join(tmp, "gpu-allocs")))
        client_s = time.perf_counter() - t0
        got_groups = [to_wire(g) for g in gpu.node.node_resources.devices]
        if got_groups != [want_group]:
            fail(f"{what}: {GPU_CLIENT}'s node lists {got_groups}")
        gpu.start()
        local = agent.clients[0]
        _wait_for(f"{what}: both clients ready", lambda: all(
            (n := s.store.node_by_id(c.node.id)) is not None
            and n.status == "ready" for c in (local, gpu)))
        client_nodes = [s.store.node_by_id(c.node.id) for c in (local, gpu)]
        seed_s = _register_over_rpc(agent.rpc.addr, nodes, AGENT_SEEDERS)
        names = {n.id: n.name for n in nodes}
        names.update({n.id: n.name for n in client_nodes})
        jobs = (("gpu-batch", device_hcl("gpu-batch")),
                ("gpu-batch-2", device_hcl("gpu-batch-2")),
                ("pinned", pinned_hcl("pinned")))
        files = []
        for job_id, text in jobs:
            path = os.path.join(tmp, f"{job_id}.hcl")
            with open(path, "w") as f:
                f.write(text)
            files.append(path)
        parsed = [parse_job_file(p) for p in files]
        watch = _AllocWatch(s.store, "gpu-batch")
        if device is None:
            torch.cuda.synchronize()
        kernels.reset_launches()
        walls = {}
        try:
            rc, out, walls["gpu-batch"] = _cli(addr, "", "job", "run",
                                               files[0])
            if rc != 0 or 'finished with status "complete"' not in out:
                fail(f"{what}: job run gpu-batch exited {rc}: {out}")
            # the second asks the card the first holds
            rc, out, walls["gpu-batch-2"] = _cli(addr, "", "job", "run",
                                                 files[1])
            if rc != 0 or "Blocked eval" not in out:
                fail(f"{what}: job run gpu-batch-2 exited {rc} without a "
                     f"blocked eval: {out}")
            evs = s.store.evals_by_job("default", "gpu-batch-2")
            failed = [e.failed_tg_allocs for e in evs if e.failed_tg_allocs]
            blocked = [e for e in evs if e.status == "blocked"]
            if not failed or "device" not in json.dumps(
                    to_wire(failed[0])).lower() or not blocked or \
                    s.store.allocs_by_job("default", "gpu-batch-2"):
                fail(f"{what}: gpu-batch-2 has failed_tg_allocs {failed}, "
                     f"{len(blocked)} blocked evals and allocs "
                     f"{s.store.allocs_by_job('default', 'gpu-batch-2')}")
            if _allocs_in(s.store, "gpu-batch", "complete"):
                fail(f"{what}: gpu-batch released the card before "
                     f"gpu-batch-2 was checked")
            # stopped before the first's release could wake its eval
            rc, out, _ = _cli(addr, "", "job", "stop", "-detach",
                              "gpu-batch-2")
            if rc != 0:
                fail(f"{what}: job stop gpu-batch-2 exited {rc}: {out}")
            t0 = time.perf_counter()
            _wait_for(f"{what}: gpu-batch complete",
                      lambda: _allocs_in(s.store, "gpu-batch", "complete"))
            done_s = walls["gpu-batch"] + time.perf_counter() - t0
        finally:
            watch.close()
        alloc = s.store.allocs_by_job("default", "gpu-batch")[0]
        if alloc.node_id != gpu.node.id:
            fail(f"{what}: gpu-batch landed on {names.get(alloc.node_id)}")
        ts = alloc.task_states["t"]
        start_latency = ts.started_at - watch.placed[alloc.id]
        rc, out, logs_s = _cli(addr, "", "alloc", "logs", alloc.id, "t")
        if rc != 0 or alloc.id not in out:
            fail(f"{what}: alloc logs exited {rc} without the alloc id: "
                 f"{out!r}")
        # the service job pinned to the dev agent's local client
        rc, out, walls["pinned"] = _cli(addr, "", "job", "run", files[2])
        if rc != 0 or 'finished with status "complete"' not in out:
            fail(f"{what}: job run pinned exited {rc}: {out}")
        t0 = time.perf_counter()
        _wait_for(f"{what}: pinned running", lambda: len(_allocs_in(
            s.store, "pinned", "running")) == PINNED_COUNT)
        running_s = walls["pinned"] + time.perf_counter() - t0
        if device is None:
            torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        places = {j: _placements(s.store, j, names)
                  for j in ("gpu-batch", "gpu-batch-2", "pinned")}
        if {p[1] for p in places["pinned"]} != {DEV_CLIENT}:
            fail(f"{what}: pinned placed {places['pinned']}")
        if not places["gpu-batch"][0][2]:
            fail(f"{what}: gpu-batch's alloc holds no device instance")
        rc, out, stop_s = _cli(addr, "", "job", "stop", "pinned")
        if rc != 0:
            fail(f"{what}: job stop pinned exited {rc}: {out}")
        t0 = time.perf_counter()
        _wait_for(f"{what}: pinned complete after the stop", lambda: len(
            _allocs_in(s.store, "pinned", "complete")) == PINNED_COUNT)
        stop_s += time.perf_counter() - t0
        # the same nodes and jobs through a CPU server
        ref = client_reference(client_nodes, nodes, parsed, names)
        if ref != places:
            diff = {j: (places[j], ref[j]) for j in places
                    if places[j] != ref[j]}
            fail(f"{what}: placements differ from the CPU server's: "
                 f"{diff}")
        # the card behind the device plugin's process boundary
        t0 = time.perf_counter()
        plugin_groups = [to_wire(g) for g in plugin.fingerprint()]
        plugin_s = time.perf_counter() - t0
        stats = plugin.stats()
        if device is None:
            if plugin_groups != [want_group]:
                fail(f"{what}: the device plugin fingerprints "
                     f"{plugin_groups}")
            if not stats or any(st["memory_used_bytes"] <= 0
                                for st in stats):
                fail(f"{what}: the device plugin's stats {stats}")
        _wait_for(f"{what}: both clients' heartbeat payloads", lambda:
                  s.cluster_stats()["nodes_reporting"] >= 2,
                  timeout_s=3 * local.config.heartbeat_interval_s + 10)
        cs = s.cluster_stats()
        if device is None:
            for name in CLIENT_KERNELS:
                if launches.get(name, 0) < 1:
                    fail(f"{what}: the {name} kernel was never launched "
                         f"({launches})")
        used = ", ".join(f"{st['id']} {st['memory_used_bytes']} of "
                         f"{st['memory_limit_bytes']} bytes used"
                         for st in stats)
        print(f"{what}: {GPU_CLIENT} lists {want_group['name']} x "
              f"{len(want_group['instances'])} (vendor "
              f"{want_group['vendor']}); fingerprint "
              f"{fp_s:.3f} s, the client's construction {client_s:.3f} s, "
              f"the device plugin's fingerprint (a process of its own) "
              f"{plugin_s:.3f} s, its stats {used or 'none'}; "
              f"{len(nodes)} nodes over RPC in {seed_s:.3f} s; job run "
              f"gpu-batch {walls['gpu-batch']:.3f} s (to complete "
              f"{done_s:.3f} s, on {places['gpu-batch'][0][1]} with "
              f"{list(places['gpu-batch'][0][2])}), task start latency "
              f"{start_latency:.3f} s (placed -> started), gpu-batch-2 "
              f"blocked in {walls['gpu-batch-2']:.3f} s; alloc logs "
              f"{logs_s:.3f} s; job run pinned {walls['pinned']:.3f} s "
              f"(to {PINNED_COUNT} running {running_s:.3f} s), job stop to "
              f"complete {stop_s:.3f} s; placements identical to an "
              f"in-process Server(device=\"cpu\"); cluster_stats "
              f"nodes_reporting {cs['nodes_reporting']:.0f} of "
              f"{cs['nodes_total']:.0f}; launches {launches} "
              f"({info['raw']})", flush=True)
        return launches
    finally:
        plugin.shutdown()
        if gpu is not None:
            gpu.shutdown()
        agent.shutdown()


def client_subprocess(nodes, info, device_args, tmp):
    """Part (b) of phase 15 (see the module's docstring)."""
    import os
    import signal
    import subprocess
    import torch
    from nomad_tpu_torch.api import ApiClient
    what = "client phase (b)"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch", "agent", "-dev",
         "-http-port", "0", "-rpc-port", "0",
         "-heartbeat-ttl", str(AGENT_HEARTBEAT_TTL_S), *device_args],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("    Device:"):
            line = proc.stdout.readline()
            if not line:
                fail(f"{what}: the agent exited {proc.wait()} before it "
                     f"started: {''.join(lines)} {proc.stderr.read()}")
            lines.append(line)
        start_s = time.perf_counter() - t0
        fields = {ln.split(":", 1)[0].strip(): ln.split(":", 1)[1].strip()
                  for ln in lines if ln.startswith("    ")}
        if not device_args and \
                torch.cuda.get_device_name(0) not in fields["Device"]:
            fail(f"{what}: the start lines name {fields['Device']!r}")
        if fields.get("Nodes") != "1":
            fail(f"{what}: the start lines name {fields.get('Nodes')!r} "
                 f"nodes, not 1")
        addr = fields["HTTP API"]
        api = ApiClient(addr)
        cli = [sys.executable, "-m", "nomad_tpu_torch"]
        t1 = time.perf_counter()
        init = subprocess.run(cli + ["job", "init", "example.nomad"],
                              cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=CLIENT_WAIT_S)
        if init.returncode != 0:
            fail(f"{what}: job init exited {init.returncode}: "
                 f"{init.stderr}")
        run = subprocess.run(cli + ["-address", addr, "job", "run",
                                    "example.nomad"],
                             cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=CLIENT_WAIT_S)
        run_s = time.perf_counter() - t1
        if run.returncode != 0:
            fail(f"{what}: job run exited {run.returncode}: "
                 f"{run.stdout} {run.stderr}")
        nodes_by_id = {n["id"]: n["name"] for n in api.list_nodes()}

        def running():
            allocs = api._request("GET", "/v1/job/example/allocations")
            return allocs and all(
                a["client_status"] == "running"
                and nodes_by_id.get(a["node_id"]) == DEV_CLIENT
                for a in allocs)
        _wait_for(f"{what}: example running on {DEV_CLIENT}", running,
                  every_s=0.1)
        running_s = time.perf_counter() - t1
        rc, out, status_s = _cli(addr, "", "job", "status", "example")
        if rc != 0 or "example" not in out or "running" not in out:
            fail(f"{what}: job status exited {rc}: {out}")
        # phase 14's subprocess checks: the leader answers, nodes over
        # RPC all ready, a job run placed to its count on them with its
        # evals complete and no node over capacity
        leader = api._request("GET", "/v1/status/leader")
        if not leader:
            fail(f"{what}: /v1/status/leader answers {leader!r}")
        seed_s = _register_over_rpc(fields["RPC"], nodes, AGENT_SEEDERS)
        job_id, kind, count, _arm = AGENT_JOBS[0]
        path = os.path.join(tmp, f"{job_id}.hcl")
        with open(path, "w") as f:
            f.write(agent_hcl(job_id, kind, count, not_on=DEV_CLIENT))
        rc, out, svc_s = _cli(addr, "", "job", "run", path)
        if rc != 0 or 'finished with status "complete"' not in out:
            fail(f"{what}: job run {job_id} exited {rc}: {out}")
        names = {n.id: n.name for n in nodes}
        agent_placements(api, names, AGENT_JOBS[:1], nodes, what,
                         local=(DEV_CLIENT,))
        counters = {c["Name"]: c["Sum"]
                    for c in api._request("GET", "/v1/metrics")["Counters"]}
        dispatches = counters.get("nomad.select.dispatches", 0)
        if dispatches <= 0:
            fail(f"{what}: /v1/metrics shows no nomad.select.dispatches")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            fail(f"{what}: the agent exited {rc} on SIGTERM: "
                 f"{proc.stderr.read()[-2000:]}")
        print(f"{what}: agent up in {start_s:.3f} s on "
              f"{fields['Device']} with {fields['Nodes']} node, leader "
              f"{leader}; job init + "
              f"job run (processes of their own) {run_s:.3f} s, running "
              f"on {DEV_CLIENT} {running_s:.3f} s after; job status "
              f"{status_s:.3f} s; {len(nodes)} nodes over RPC in "
              f"{seed_s:.3f} s; job run {job_id} {svc_s:.3f} s; "
              f"nomad.select.dispatches {dispatches:.0f}; exit 0 on "
              f"SIGTERM ({info['raw']})", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def client_phase(nodes, info, device=None, sub_nodes=AGENT_SUB_NODES):
    """Phase 15 (see the module's docstring). Returns the launches of
    part (a)'s jobs. `device="cpu"` rehearses it on the CPU."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="client-phase-")
    try:
        launches = client_in_process(nodes, info, device, tmp)
        client_subprocess(nodes[:sub_nodes], info,
                          [] if device is None else ["-device", device],
                          tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"client phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 16: the kernels the scenario matrix's cells must launch on the
# card (every service and batch cell places through the chunked kernel,
# spread_antiaffinity through the scan, node registrations and failures
# patch the resident table with scatter_set)
CHAOS_KERNELS = ("chunked", "scan", "scatter_set")


def _chaos_line(label, c):
    flat = c["flatness"]
    verdict = {True: "flat", False: "drifting", None: "flatness n/a"}[
        flat.get("pass")]
    failed = c["invariants_failed"]
    return (f"chaos {label} {c['name']}: "
            f"{'pass' if c['pass'] else 'FAIL'}, {c['elapsed_s']:.2f} s, "
            f"{c['placements']} placements, "
            f"{c['placements_per_sec']:.1f} placements/s, settle p50 "
            f"{c['settle_p50_ms']:.1f} / p99 {c['settle_p99_ms']:.1f} ms, "
            f"invariants {len(c['invariants']) - len(failed)}/"
            f"{len(c['invariants'])}"
            + (f" (failed: {', '.join(failed)})" if failed else "")
            + f", {verdict}"
            + (f" ({flat.get('reason', '')})"
               if flat.get("pass") is False else "")
            + (f", error {c['error']}" if c.get("error") else ""))


# the -full cells whose every live alloc lands on the same node from one
# run to the next. In the others a race of thread timings (the two
# scheduler workers, the drain and heartbeat timers) picks which of
# several equally good nodes an alloc takes, and only the placements'
# shape is held: the same allocs, the same count on each node
CHAOS_EXACT_CELLS = ("system_fanout", "spread_antiaffinity",
                     "batch_backfill")


def _chaos_outcome(c):
    """What the card's -full run must share with the CPU's: the
    invariant verdicts, the fault kinds, the placement count and shape,
    and in CHAOS_EXACT_CELLS the node of every live alloc."""
    from nomad_tpu_torch.chaos.matrix import placement_shape
    out = {"invariants": [(i["name"], i["pass"]) for i in c["invariants"]],
           "placements": c["placements"],
           "shape": placement_shape(c["placed"]),
           "faults": sorted({e["kind"] for e in c["faults"]})}
    if c["name"] in CHAOS_EXACT_CELLS:
        out["placed"] = c["placed"]
    return out


class _RaftEvents(logging.Handler):
    """Counts the elections won and the leaders' step-downs that a
    cell's raft servers log, and the highest term they reach."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.elected = self.stepped_down = self.term = 0

    def emit(self, record):
        if record.msg.startswith("elected leader"):
            self.elected += 1
        elif record.msg.startswith("stepping down"):
            self.stepped_down += 1
        else:
            return
        self.term = max(self.term, int(record.args[0]))


def _run_counting_raft(run_cell, sc, **kw):
    """run_cell with the raft log's elections and step-downs counted
    into the cell's result as `raft`."""
    log = logging.getLogger("nomad_tpu.raft")
    ev = _RaftEvents()
    log.addHandler(ev)
    try:
        c = run_cell(sc, **kw)
    finally:
        log.removeHandler(ev)
    c["raft"] = {"elected": ev.elected, "stepped_down": ev.stepped_down,
                 "term": ev.term}
    return c


def chaos_phase(info, device="cuda"):
    """Phase 16 (see the module's docstring). Returns the launches of
    the card's cells, parts (a) and (b). `device="cpu"` rehearses it on
    the CPU (both halves of (b) on the CPU)."""
    import torch
    from nomad_tpu_torch.chaos.matrix import run_cell
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    from nomad_tpu_torch.ops import kernels
    from nomad_tpu_torch.utils import gcsafe
    what = "chaos phase"
    t_phase = time.perf_counter()
    single = [sc for sc in SCENARIOS.values()
              if sc.quick and not sc.cluster]
    cluster = [sc for sc in SCENARIOS.values() if sc.cluster]
    # the earlier phases' heap out of every collection the cells' threads
    # would otherwise sit through (phase 13's idiom); no cell's settings
    # change
    gcsafe.freeze_steady_state()
    if device == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    quick = [run_cell(sc, quick=True, device=device) for sc in single]
    quick += [_run_counting_raft(run_cell, sc, quick=True, device=device)
              for sc in cluster]
    t_quick = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = [run_cell(sc, quick=False, device=device) for sc in single]
    t_full = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    full_cpu = [run_cell(sc, quick=False, device="cpu") for sc in single]
    t_full_cpu = time.perf_counter() - t0
    for c in quick:
        print(_chaos_line(f"quick on {device}", c), flush=True)
        if "raft" in c:
            r = c["raft"]
            print(f"chaos raft {c['name']} on {device}: {r['elected']} "
                  f"elections won, {r['stepped_down']} leader step-downs, "
                  f"highest term {r['term']}", flush=True)
    for c in full:
        print(_chaos_line(f"full on {device}", c), flush=True)
    for c in full_cpu:
        print(_chaos_line("full on cpu", c), flush=True)
    bad = [c["name"] for c in quick if not c["pass"]]
    if bad:
        fail(f"{what}: cells failed on {device}: {bad}")
    for c in full + full_cpu:
        if c.get("error"):
            fail(f"{what}: -full cell {c['name']} crashed: {c['error']}")
    same_nodes = []
    for g, c in zip(full, full_cpu):
        got, want = _chaos_outcome(g), _chaos_outcome(c)
        if got != want:
            fail(f"{what}: -full cell {g['name']} on {device} {got} "
                 f"differs from the CPU's {want}")
        if g["placed"] == c["placed"]:
            same_nodes.append(g["name"])
    missing = [k for k in CHAOS_KERNELS if launches.get(k, 0) < 1]
    if device == "cuda" and missing:
        fail(f"{what}: the cells never launched {missing} ({launches})")
    def failures(cells):
        return {c["name"]: c["invariants_failed"]
                + (["flatness"] if c["flatness"].get("pass") is False
                   else []) for c in cells if not c["pass"]}
    print(f"chaos phase: {len(quick)}/{len(quick)} quick and cluster "
          f"cells pass on {device} ({t_quick:.1f} s, "
          f"{sum(len(c['invariants']) for c in quick)} invariants); -full "
          f"{sum(c['pass'] for c in full)}/{len(full)} pass on {device} "
          f"({t_full:.1f} s) and {sum(c['pass'] for c in full_cpu)}/"
          f"{len(full_cpu)} on the CPU ({t_full_cpu:.1f} s), the same "
          f"invariant verdicts, fault kinds and placement shapes, every "
          f"live alloc on the same node in {same_nodes} (held in "
          f"{list(CHAOS_EXACT_CELLS)}); -full "
          f"failures on {device} {failures(full)}, on the CPU "
          f"{failures(full_cpu)}; launches {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({info['raw']})",
          flush=True)
    return launches


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

    # each phase's seconds, printed before the kernels line: the script's
    # whole run must stay inside the chip call's limit
    marks = [("set-up", t0)]

    def mark(name):
        marks.append((name, time.perf_counter()))

    rows = kernel_phase("cuda")
    mark("kernels")
    table_rows = table_kernel_phase()
    mark("table kernels")
    batched_rows = batched_kernel_phase("cuda")
    mark("batched kernels")

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
    mark("main path")

    steady_launches, steady_gpu = steady_state_phase(nodes, mock, models)
    mark("steady state")
    gateway_launches, gateway_gpu = gateway_phase(nodes, mock, models)
    mark("gateways")
    sharded_rows = sharded_kernel_phase("cuda")
    mark("sharded kernels")
    mesh_launches = mesh_phase("cuda", nodes, jobs, gpu_places, gpu_walls,
                               steady_state_steps(mock, models, nodes),
                               steady_gpu)
    mark("mesh")
    bs_rows = batched_sharded_kernel_phase("cuda")
    mark("batched sharded kernels")
    mesh_gw_launches = mesh_gateway_phase(nodes, mock, models, gateway_gpu)
    mark("mesh gateways")
    cold_launches, cold_mesh_launches = cold_start_phase(
        main_h, nodes, jobs, steady_state_steps(mock, models, nodes), info)
    mark("cold start")
    server_launches, single_manifest = server_phase(nodes, mock, models,
                                                    info)
    mark("server")
    restart_launches = restart_phase(nodes, mock, models, info)
    mark("restart")
    ring_launches = ring_phase(nodes, mock, models, single_manifest, info)
    mark("ring")
    agent_launches = agent_phase(nodes, info)
    mark("agent")
    client_launches = client_phase(nodes, info)
    mark("client")
    chaos_launches = chaos_phase(info)
    mark("chaos")
    print("phase seconds: " + json.dumps(
        {name: round(t - marks[i][1], 1)
         for i, (name, t) in enumerate(marks[1:])}
        | {"total": round(marks[-1][1] - t0, 1)}), flush=True)
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
    for rec in record:
        rec["server_launches"] = server_launches.get(rec["name"], 0)
        rec["restart_launches"] = restart_launches.get(rec["name"], 0)
        rec["ring_launches"] = ring_launches.get(rec["name"], 0)
        rec["agent_launches"] = agent_launches.get(rec["name"], 0)
        rec["client_launches"] = client_launches.get(rec["name"], 0)
        rec["chaos_launches"] = chaos_launches.get(rec["name"], 0)
    print(json.dumps({"kernels": record}))
    print(info["raw"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
