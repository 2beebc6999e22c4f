"""nomad_tpu_torch: the PyTorch + CUDA port of nomad_tpu's placement path.

The scheduler's main path — `scheduler.harness.Harness.process` ->
`GenericScheduler` -> `PlacementEngine.select_batch` ->
`ops.select.SelectKernel.select` — runs here with hand-written Hopper
kernels (ops/csrc/*.cu, bound in ops/kernels.py) in place of the JAX
package's jitted device programs. `Harness(device=...)` and
`SelectKernel(device=...)` run on the CUDA card by default; `device="cpu"`
runs the kernels' plain PyTorch versions instead.

Concurrent evals' dispatches can meet in a gateway (server/worker.py):
`BatchGateway` (one lane an eval of a drained batch) or `MicroBatchGateway`
(continuous batching across lanes) set as each scheduler's
`kernel_dispatch`; a fire runs `SelectKernel.select_many`, which places B
requests over one node table with one launch of a batched kernel, one
block a lane.

With `ops.select.set_mesh(parallel.make_mesh(S, device))` every dispatch
runs over a mesh instead: the node axis split into S shards on one device,
one thread block a shard, the scan for every request and the K-way kernel
for big chunk-eligible batches (ops/csrc/sharded_kernels.cu, one
cooperative launch each), the hot columns kept on a mesh-resident table;
select_many runs its batched arms' node-sharded forms, B lanes of S shards
in one launch of B * S blocks; `set_mesh(None)` goes back to the
single-card route.

The node table is device-resident (ops/device_table.py), always on: each
store's NodeTableCache keeps a mirror of capacity / used / free_ports and
the parked feasibility masks on the device of the first SelectKernel that
dispatches against it, advanced by the row-scatter kernels; dispatches
read the mirror and compute used0 on the card from the plan overlay.

The package imports torch and nothing of nomad_tpu or JAX. Modules it
needs from nomad_tpu are its own copies, with the same relative paths:

Copies of the file of the same path under nomad_tpu/, identical in code
(comments that cite the JAX package's own issue and PR numbers dropped):
  models/*.py, mock/__init__.py, mock/fixtures.py, mock/seeded.py,
  utils/__init__.py, utils/ids.py, utils/codec.py, utils/hamt.py,
  utils/layermap.py, utils/stages.py, utils/metrics.py, utils/cron.py,
  plugins/psstructs.py,
  ops/__init__.py, ops/targets.py, ops/versions.py,
  state/__init__.py, state/alloc_index.py, state/columnar.py,
  state/store.py (the snapshots' dump, dump_columnar, restore and
  pop_cold_columns included),
  scheduler/__init__.py, scheduler/annotate.py, scheduler/context.py,
  scheduler/devices.py, scheduler/reconcile.py,
  scheduler/reconcile_util.py, scheduler/scheduler.py, scheduler/util.py.

Copies changed only where they reached modules this package does not
carry, or to carry the device:
  utils/locks.py        without the race-sanitizer hook;
  ops/tables.py         NodeTableCache without the NOMAD_TPU_TABLE_DELTA
                        switch; fold_mesh and mesh_reshard_debt read the
                        mesh set by set_mesh; prefetch_device(device)
                        takes the device it uploads to and raises where
                        the JAX package's swallows a failed upload, and
                        PrefetchThread runs it on a thread whose join()
                        re-raises;
  acl/acl.py, server/event_sink.py, server/vault.py   the records the
                        store holds and a snapshot carries (AclPolicy,
                        AclToken, EventSink, VaultAccessor) only, not the
                        policy engine, the sink manager or the token
                        authority beside them;
  scheduler/stack.py    SelectKernel(device); feasibility tokens parked
                        on the kernel's device;
  scheduler/generic.py, scheduler/system.py   pass the planner's device;

The JAX package's runtime switches are fixed to their defaults here: the
columnar reconcile, columnar preemption, compiled feasibility and
residue paths always run, and the copies read no environment variable
and have no configure() hook (reconcile_columnar.py, preemption.py,
feasible_compiler.py, whose push_combined takes the device, spread.py,
node_attr_index.py).
  scheduler/harness.py  Harness(store, device);
  plugins/__init__.py   exports nothing (only psstructs is carried).

Written for the port:
  ops/select.py         the kernel layer, rewritten for torch, with the
                        batched select_many arm, partition_lanes, the
                        DispatchCostModel and calibrate_cost_model, and a
                        measured CUDA round trip (cuda_roundtrip_s) in
                        place of the accelerator round trip; the mesh is
                        switched by set_mesh(mesh) / set_mesh(None), not by
                        NOMAD_TPU_MESH, and never engages by itself;
                        without the host routing (_pick_device) and the
                        device-economics counters; batched lanes are not
                        padded to a power of two;
  server/worker.py      BatchGateway and MicroBatchGateway only (not the
                        Worker, EvalLane or process_eval_batch, which need
                        the broker, plan queue and raft); without the
                        flight-recorder spans and the JAX package's
                        NOMAD_TPU_EVAL_BATCH / NOMAD_TPU_MICROBATCH
                        switches; BatchGateway gains `partition` and
                        `stats`;
  ops/device_table.py   the resident node table on torch tensors, without
                        the NOMAD_TPU_TABLE_DELTA switch, the sanitizer
                        calls, the row-bucket padding and the mesh's row
                        journal switch; kernel failures propagate;
  ops/kernels.py        kernel wrappers, plain versions, launch counts;
  ops/csrc/select_kernels.cu   the placement kernels, solo and batched
                        (CUDA C++, sm_90a);
  ops/csrc/sharded_kernels.cu  the node-sharded scan and K-way kernels;
  ops/csrc/select_common.cuh   the __device__ pieces both files share;
  parallel/sharded.py   counterpart of nomad_tpu/parallel/sharded.py: a
                        Mesh of its own (S shards on ONE device, not a
                        jax.sharding.Mesh over devices), make_mesh(S,
                        device), ShardedSelect on the sharded kernels;
                        without place_batched_chunked_args and
                        _resident_capacity_for_table (the batched mesh
                        slice); stats report one device and its shards;
  parallel/sharded_table.py  counterpart of the JAX mesh-resident table:
                        columns on the mesh's device at pad_for_mesh rows,
                        replayed through the port's DeviceNodeTable journal
                        with the scatter_set / overlay_add kernels; always
                        on (no NOMAD_TPU_MESH_RESIDENT, configure or
                        resident_enabled), failures propagate, no row-bucket
                        padding, no parked feasibility masks;
  parallel/__init__.py  the JAX package's exports without resident_enabled,
                        with Mesh and pad_for_mesh;
  ops/csrc/table_kernels.cu    the resident table's row scatters;
  utils/platform.py     default device and device_info();
  state/carry.py        state carried across from the JAX package.
"""

__version__ = "0.1.0"
