"""nomad_tpu_torch: the PyTorch + CUDA port of nomad_tpu's placement path.

The scheduler's main path — `scheduler.harness.Harness.process` ->
`GenericScheduler` -> `PlacementEngine.select_batch` ->
`ops.select.SelectKernel.select` — runs here with hand-written Hopper
kernels (ops/csrc/*.cu, bound in ops/kernels.py) in place of the JAX
package's jitted device programs. `Harness(device=...)` and
`SelectKernel(device=...)` run on the CUDA card by default; `device="cpu"`
runs the kernels' plain PyTorch versions instead.

`server.Server(ServerConfig(...), device=None)` is the server: alone it
runs in dev mode (one process, one leader, no raft); it registers nodes
and jobs, enqueues
evals in the EvalBroker, and its Workers dequeue them, drain ready evals
into batches and run the schedulers; plans go through the PlanQueue to the
group-committing PlanApplier, which writes the store. Every kernel it owns
(each Worker's, each EvalLane's planner device, the server-wide
MicroBatchGateway's, the start-up calibration) runs on its device. With
`ServerConfig(data_dir=...)` it logs every applied entry to a WAL and
takes snapshots (server/persistence.py), and a new Server on the same
directory restores: snapshot, primed node table, the mirror uploaded to
its device beside the WAL tail's replay, and the dispatch cost model.
With `RpcServer(server, port=0)` (rpc/) and `server.attach_raft(rpc,
peers)` servers form a cluster: raft (server/raft.py) replicates every
write and applies it at commit on each replica, a lagging follower is
reseeded by snapshot onto its device, SWIM and autopilot keep the member
set, and followers schedule on their own devices against their own
replicas, dequeuing from the leader's broker and submitting plans to its
applier over RPC (server/follower_sched.py). Every Server runs the
governor (governor/: gauges, watermarks, reclaims, backpressure), the
process-wide flight recorder (trace/: a span tree an eval, a kernel span
a dispatch) and the telemetry collector (telemetry/), served at
/v1/operator/governor, /v1/operator/trace, /v1/operator/telemetry and
/v1/metrics. `python -m nomad_tpu_torch.chaos` (or `dev chaos`) runs the
scenario matrix (chaos/): seeded workloads on real Servers, on the card
unless `-device cpu`, under faults that chaos/faults.py's FaultInjector
delivers through hook points in the worker, follower scheduling, the
applier, raft, SWIM and the heartbeat path, judged by invariants.

`python -m nomad_tpu_torch agent -dev` is the agent as a user runs it
(cli/main.py: `start_agent` builds the Server on `-device`, the card
unless `-device cpu`, its RpcServer, the HTTP API of api/http.py and
`-clients N` local clients; `agent -client -servers` joins a client to a
server over RPC), and `python -m nomad_tpu_torch job run <file.hcl>`
parses a jobspec (jobspec/) and submits it through api/client.py.

The node agent is client/: `Client(server or transport, ClientConfig())`
fingerprints its node, registers, heartbeats (with its host-stats
payload, client/stats.py), watches its allocs and runs their tasks
through the task drivers (client/drivers.py: mock_driver, raw_exec,
exec with its out-of-process executor, java, qemu, docker), each alloc
in its own dir tree with its hooks, services, Vault lease and durable
state; servers forward logs, fs and exec to its RPC listener
(client/remote.py). With `ClientConfig(fingerprint_accelerators=True)`
it lists the CUDA cards (torch.cuda) as a device group of type "gpu",
vendor "nvidia", in this process or behind the device plugin's process
boundary (plugins/device_client.py); a job asking for `device "gpu"` is
placed onto them through the kernels' device slots. With `-acl-enabled` every request
resolves its token against the ACL engine (acl/acl.py); the leader runs
the event-sink manager (server/event_sink.py) and, outside the
authoritative region, ACL and namespace replication
(server/replication.py).

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
  scheduler/reconcile_util.py, scheduler/scheduler.py, scheduler/util.py,
  server/plan_queue.py,
  server/event_broker.py, server/core_sched.py, server/periodic.py,
  server/deployment_watcher.py, server/drainer.py, utils/timetable.py,
  utils/gcsafe.py, server/persistence.py, server/connect_hook.py,
  jobspec/*.py, acl/__init__.py, acl/acl.py (its docstring's paths
  relative), api/__init__.py, api/client.py, api/ui.py, cli/__init__.py,
  cli/agent_config.py, utils/monitor.py, __main__.py,
  client/__init__.py, client/allocdir.py, client/allocwatcher.py,
  client/docklog.py, client/fs_service.py, client/hooks.py,
  client/logmon.py, client/remote.py, client/services_hook.py,
  client/state_db.py, client/taskenv.py, client/vaultclient.py,
  plugins/__init__.py, plugins/hclspec.py, rpc/transport.py,
  server/vault.py, governor/__init__.py, governor/policy.py,
  governor/registry.py, governor/drift.py, governor/governor.py,
  chaos/__init__.py, chaos/faults.py, chaos/scenarios.py (its servers
  built by the matrix's Cell on the cell's device).

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
  client/agent.py       fingerprint_accelerator_devices reads the CUDA
                        cards through torch.cuda (vendor "nvidia") and
                        raises a CUDA error where the JAX package's
                        returns []; ClientConfig(csi_plugins=...) raises
                        ValueError (CSI is not carried); the cloud probes'
                        metadata URLs come from cloud_metadata_urls;
                        no NOMAD_CLOUD_FINGERPRINT or
                        NOMAD_TPU_CLIENT_STATS switch
                        (stats_sample_interval_s=0 is the off arm);
  client/stats.py       its ring telemetry/'s TelemetryCollector
                        (device_fn=None), as in the JAX package; without
                        the race-sanitizer hook and the switch;
  trace/tracer.py, trace/__init__.py   the flight recorder without the
                        NOMAD_TPU_TRACE switch: Tracer.set_enabled(on)
                        and configure(..., enabled=) (a Server's
                        trace_enabled) in place of refresh();
  telemetry/collector.py, telemetry/__init__.py   without the
                        NOMAD_TPU_TELEMETRY switch and enabled()
                        (telemetry_sample_interval_s=0 is the off arm);
                        default_device_fn(device) reads the port's
                        device accounting and the card's bytes in use,
                        and raises where the JAX package's swallows a
                        failure (the collector writes no row then);
                        each sample also publishes the device.* family
                        as nomad.device.* gauges; flatness() runs
                        telemetry/flatness.py, a copy of
                        nomad_tpu/bench/soak.py's flatness_verdict;
  client/fingerprint.py  metadata URLs as arguments, never from the
                        environment;
  client/executor.py    the tasks' cgroups under nomad_tpu_torch/, apart
                        from the JAX package's nomad_tpu/;
  client/drivers.py, client/docker_driver.py, client/exec_helper.py,
  client/executor_server.py, plugins/driver_client.py,
  plugins/launcher.py   the child processes run this package's modules;
                        the executor's token under this package's name;
                        the launcher without the CSI plugins;
  plugins/base.py       the handshake cookie under this package's name;
  plugins/device_client.py  fingerprint, reservation
                        (CUDA_VISIBLE_DEVICES, the cards' indices) and
                        memory stats (torch.cuda.mem_get_info /
                        memory_stats) of the CUDA cards;
  server/event_sink.py  the manager keeps every watcher and writer it
                        stopped until join() waits for them (the
                        server's shutdown), and a watcher's sleep ends
                        when the manager is disabled;
  server/replication.py  its long-polls on http.client connections that
                        stop() shuts down, and join() waits for the
                        threads (the server's shutdown and a revoked
                        leadership's);
  api/http.py           alloc_dir_bases,
                        where given, are the only alloc dirs it reads
                        (no temporary-directory base beside them);
                        shutdown closes the listening socket;
  cli/main.py           `agent` split into start_agent(args), which
                        builds and starts the Server on `-device` (the
                        card unless `-device cpu`; no probe of the
                        accelerator and no fallback to the CPU), its
                        RpcServer and the HTTP API and returns them as
                        an Agent with its local clients (the HTTP API
                        reads their alloc dirs, and none without them),
                        and the signal loop; `-heartbeat-ttl`;
                        `dev chaos` takes `-device` (the card unless
                        `cpu`); `dev lint` exits 1 (analysis/ is not
                        carried); the environment it
                        reads is NOMAD_TOKEN, NOMAD_REGION and
                        NOMAD_VAR_* only; `operator trace` / `operator
                        top` name the port's off settings;
  cli/example_job.py, cli/__main__.py   the module named in a comment;
  rpc/codec.py          FrameCodec on python-msgpack only (no native
                        codec slot), its reads linear in a frame's size;
  rpc/client.py, rpc/__init__.py   verbatim;
  rpc/server.py         shutdown closes the live connections and joins
                        the listener;
  server/plan_applier.py  without the NOMAD_TPU_PLAN_GROUP switch and
                        the process-wide
                        GROUP_STATS (the flight-recorder spans, the
                        conflict window, shrink_group_bound and
                        effective_group_bound, the committer thread, the
                        overlay of submitted but unapplied plans,
                        apply_sync and fail_futures as in the JAX
                        package);
  server/raft.py        append_entry encodes
                        before it takes the lock; a new leader
                        establishes leadership only after its term's
                        no-op is applied (the Barrier of nomad/leader.go);
                        no election while a snapshot installs; the
                        election timeout scales with raft_multiplier;
                        stop() joins the ticker and the FSM applier;
                        replication counters (`stats`); the
                        raft.election chaos hook asked CHAOS_HOLD_S
                        (two heartbeats) before the election deadline,
                        not at it (in the JAX package a follower_fence
                        victim whose deadline lapses just as its lag
                        heals campaigns before the leader's first
                        heartbeat, and can depose it);
  server/swim.py        stop() joins its thread;
  server/blocked_evals.py  with unblock_failed (blocked_evals.go
                        UnblockFailed), which the leader runs on a timer;
  server/eval_broker.py  its timer threads named (eval-broker-nack,
                        -wait, -delay); flush() joins the timers it
                        cancels, so set_enabled(False) leaves none behind;
  chaos/invariants.py   race_baseline() None and race_clean() a pass with
                        race "off" and findings 0: the race sanitizer
                        (analysis/) is not carried;
  chaos/matrix.py       run_cell(..., device) and run_matrix(..., device)
                        carry the device into Cell, whose server() builds
                        Server(ServerConfig(...), device): the card unless
                        the caller passes "cpu", resolved before a cell
                        starts (a missing card raises); the flatness
                        verdict from telemetry/flatness.py; the matrix's
                        race report is always "off"; each cell's result
                        also has `placed` (placed_allocs: each job's live
                        allocs by node, read before teardown), and
                        placement_shape() drops its node ids;
  chaos/__main__.py     `-device` (the card unless `cpu`), without the JAX
                        package's CPU-platform block;
  server/follower_sched.py  without the NOMAD_TPU_FOLLOWER_SCHED switch;
                        Eval.Dequeue answers with a
                        wait index (nomad/eval_endpoint.go getWaitIndex)
                        that the follower's worker fences on;
  server/ingest.py      without the NOMAD_TPU_INGEST_BATCH switch and the
                        process-wide INGEST_STATS;
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

Written for the port:
  ops/select.py         the kernel layer, rewritten for torch, with the
                        batched select_many arm, partition_lanes, the
                        DispatchCostModel and calibrate_cost_model, and a
                        measured CUDA round trip (cuda_roundtrip_s) in
                        place of the accelerator round trip; the mesh is
                        switched by set_mesh(mesh) / set_mesh(None), not by
                        NOMAD_TPU_MESH, and never engages by itself;
                        without the host routing (_pick_device); the
                        device accounting (DEVICE_STATS,
                        DEVICE_ARM_STATS, device_stats_snapshot) and the
                        kernel span of the JAX package, a dispatch's
                        `compiled` being a launch that built or loaded
                        the library, the node-sharded arms reported as
                        "<arm>_sharded"; device_hbm_bytes(device) reads
                        the caching allocator (0.0 on the CPU, raises on
                        a CUDA error); kernel_cache_stats counts the
                        loaded library and the sharded kernels' route
                        memos (ops/kernels.py cache_entries) and
                        clear_kernel_caches drops the memos; _to_host
                        reports the d2h stage; batched lanes are not
                        padded to a power of two;
  server/worker.py      BatchGateway, MicroBatchGateway, EvalLane(device),
                        Worker (its SelectKernel on the server's device,
                        a gateway on another device raises, its eval
                        latencies and gated drains kept, always
                        pipelined through its finisher thread),
                        process_eval and process_eval_batch, with the
                        flight-recorder spans and the governor's latency
                        reservoir and backpressure, and the chaos hooks
                        (worker.plan_committed, WorkerKilled nacked);
                        without the worker_pipeline setting and the JAX
                        package's NOMAD_TPU_EVAL_BATCH /
                        NOMAD_TPU_MICROBATCH switches; BatchGateway gains
                        `partition` and
                        `stats`; the Worker's seams for the follower plane
                        (_make_lane, _note_fence, _effective_batch_size),
                        its snapshot fence also waiting for a remote
                        dequeue's wait index;
  server/core.py        ServerConfig (the fields the ported modules, tests
                        and chip_smoke.py set, the governor_*, trace_*
                        and telemetry_* fields among them, with
                        trace_enabled in place of NOMAD_TPU_TRACE;
                        without chaos_seed / chaos_visibility_bound_s,
                        which are chaos/faults.py's DEFAULTS (set there
                        with configure()), worker_pipeline and
                        reconcile_index_max_jobs / _delta_max, which are
                        the constants they default to; with
                        raft_multiplier,
                        which also scales SWIM's timers), Server(config,
                        device) with start / shutdown (which joins every
                        thread it started, the raft and scheduler-plane
                        threads first, then flushes and closes the WAL
                        and saves the cost model, raising a failure there
                        after the rest of the teardown) /
                        establish_leadership / revoke_leadership (which
                        stops the heartbeat timers' thread), attach_raft,
                        raft_apply / raft_apply_async (the nested-apply
                        path), apply_replicated, install_snapshot (the
                        node table primed and its mirror uploaded to the
                        server's device), the membership endpoints,
                        autopilot and scheduler_plane_status,
                        register_jobs_bulk and the ingest appliers, the
                        reaper and the GC ticker idling while not leader,
                        raft_apply on the inline dev path with the WAL's
                        record / commit_barrier / maybe_snapshot, the
                        restore at construction (the
                        mirror's prefetch a PrefetchThread joined before
                        the constructor returns), _replay_entries(entries,
                        highest, batch=True) in place of the
                        NOMAD_TPU_WAL_REPLAY_BATCH switch, the FSM
                        appliers, the connect and expose-check admission
                        hooks, and the job, node, alloc, eval, deployment,
                        namespace, service-catalog and CSI endpoints with
                        the volume watcher (its pass a second, ended at
                        once by shutdown's event),
                        the ACL endpoints and resolve_token, the event-sink
                        endpoints (the manager enabled with leadership,
                        stopped and joined first at shutdown), replication
                        started by a non-authoritative leader, and
                        federation (multiregion register and
                        deregister_job_global), the Vault token
                        authority with the volume watcher's reap, and
                        heartbeat(node_id, stats) (its chaos hook
                        server.heartbeat) with cluster_stats, and
                        the governor (every gauge of the JAX package's
                        but the lock.* ones, which read the race
                        sanitizer; `lint.recompiles` counts fresh
                        launches), the flight recorder's wiring (only
                        this server's closures detached at shutdown),
                        the telemetry collector and the stats ticker,
                        all joined at shutdown;
  server/heartbeat.py   HeartbeatTimers: every node's heartbeat TTL on one
                        thread (a heap of deadlines), where the JAX package
                        arms a threading.Timer thread per node;
  ops/device_table.py   the resident node table on torch tensors, without
                        the NOMAD_TPU_TABLE_DELTA switch, the sanitizer
                        calls, the row-bucket padding and the mesh's row
                        journal switch; kernel failures propagate;
  ops/kernels.py        kernel wrappers, plain versions, launch counts,
                        and the route memos' accounting (cache_entries,
                        clear_route_memos);
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
  telemetry/flatness.py  flatness_verdict, copied from the JAX package's
                        soak harness (nomad_tpu/bench/soak.py);
  state/carry.py        state carried across from the JAX package.
"""

__version__ = "0.1.0"
