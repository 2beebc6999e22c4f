"""The server in dev mode: state store + FSM apply + broker + plan
pipeline + workers, as one process and one leader with no raft.

Reference semantics: nomad/server.go (NewServer:295, setupWorkers:1438),
nomad/fsm.go (the ~45 log-type dispatch collapses to the raft_apply
switch here), nomad/leader.go (establishLeadership:222 — broker/blocked/
plan-queue enablement, restoreEvals:496, reapFailedEvaluations:766),
nomad/heartbeat.go (TTL timers -> node down -> createNodeEvals,
node_endpoint.go:1318; every node's TTL on one thread, server/heartbeat.py,
where the JAX package starts a thread per node).

`Server(config, device=None)` schedules on the CUDA card; `device="cpu"`
runs the kernels' plain versions. The device reaches every kernel the
server owns: each Worker's SelectKernel, each EvalLane (the schedulers
build their PlacementEngine on the lane's device), the server-wide
MicroBatchGateway and the start-up cost-model calibration.

With `ServerConfig(data_dir=...)` the server is durable
(server/persistence.py): every applied entry goes to a write-ahead log
before the FSM applies it, snapshots drop the log's covered prefix, and
construction restores from the directory — the snapshot (columnar or
legacy), the resident node table primed at the restored index, the
device mirror uploaded on a PrefetchThread while the WAL tail replays,
and the dispatch cost model saved beside the log.

With `attach_raft(rpc_server, peers)` the server joins a cluster of
servers over rpc/ (server/raft.py): the leader appends every write to a
replicated log and the FSM applies an entry once a majority holds it, on
leader and followers alike (apply_replicated); a lagging follower is
reseeded by snapshot (install_snapshot, which primes its resident node
table and uploads the mirror to its device); membership rides the log
(join_member / leave_member, autopilot, SWIM failure reports); and each
follower schedules remotely (server/follower_sched.py): its workers
dequeue from the leader's broker over RPC, select on its own device
against its own replicated store, and submit plans to the leader's
applier. Writes that arrive while an apply is in flight coalesce into
one entry (server/ingest.py, register_jobs_bulk).

ACLs (nomad/acl_endpoint.go): with `acl_enabled` every request resolves
its token to a compiled ACL (resolve_token); bootstrap, policies and
tokens are raft writes. The leader runs the event-sink manager
(server/event_sink.py: one webhook writer a sink, progress committed
through raft) and, in a region that is not the authoritative one, ACL
and namespace replication from it (server/replication.py). Federation:
a multiregion job fans out one localized copy a region through the
peers' HTTP APIs, and deregister_job_global stops it in every region.

Vault (nomad/vault.go): the embedded token authority derives a TTL'd
token per task of an alloc (derive_vault_token), renews and revokes the
leases it tracks in the replicated store, and the volume watcher's pass
reaps the leases of terminal allocs. A client's heartbeat may carry its
host-stats payload, which cluster_stats folds into the fleet's
used-against-allocated rollup.

Observability and steady-state control, as in the JAX package: the
governor (governor/: every long-lived structure's gauge with watermarks,
targeted reclaims, backpressure on the broker and the drain width, drift
findings), the flight recorder (trace/: one span tree per eval over the
worker, gateway, applier and committer tracks, tail exemplars, stage
percentiles; the recorder is process-wide and this server configures it
and wires its governor in) and the telemetry collector (telemetry/: the
history ring behind /v1/operator/telemetry and /v1/operator/flatness).
All three are on by default; `governor_enabled=False`,
`trace_enabled=False` and `telemetry_sample_interval_s=0` turn them off
(no environment switch). Shutdown stops and joins the governor's, the
collector's and the stats ticker's threads, and detaches only this
server's closures from the recorder. Not carried: the `lock.*` gauges
and the `locks` status block, which read the race sanitizer
(analysis/).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..models import (
    Allocation, Evaluation, Job, Node,
    EVAL_STATUS_FAILED, EVAL_STATUS_PENDING,
    JOB_TYPE_CORE, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM,
    NODE_STATUS_DOWN, NODE_STATUS_READY,
    TRIGGER_JOB_DEREGISTER, TRIGGER_JOB_REGISTER, TRIGGER_NODE_UPDATE,
)
from ..models.evaluation import (
    CORE_JOB_DEPLOYMENT_GC, CORE_JOB_EVAL_GC, CORE_JOB_FORCE_GC,
    CORE_JOB_JOB_GC, CORE_JOB_NODE_GC, TRIGGER_SCHEDULED,
)
from ..ops.select import SelectKernel, resolve_device
from ..state import StateStore
from ..utils import metrics
from ..utils.locks import make_lock, make_rlock
from ..utils.timetable import TimeTable
from .blocked_evals import BlockedEvals
from .deployment_watcher import (
    DeploymentsWatcher, fail_deployment, pause_deployment,
    promote_deployment,
)
from .drainer import NodeDrainer, drain_allocs
from .eval_broker import EvalBroker, FAILED_QUEUE
from .event_broker import EventBroker, events_from_apply
from .event_sink import EventSinkManager
from .follower_sched import EvalLeaseTable
from .heartbeat import HeartbeatTimers
from .ingest import IngestGateway
from .periodic import PeriodicDispatch
from .plan_applier import PlanApplier
from .plan_queue import PlanQueue
from .worker import MicroBatchGateway, Worker

CORE_JOB_PRIORITY = 200  # structs.go CoreJobPriority = 2 * JobMaxPriority

LOG = logging.getLogger("nomad_tpu.server")

# how long shutdown waits for each of the server's own threads
JOIN_S = 10.0


@dataclass
class ServerConfig:
    num_schedulers: int = 2
    enabled_schedulers: tuple = ("service", "batch", "system")
    # this server's federation region (nomad/config.go Region); requests
    # stamped with a foreign region forward to that region's agent
    region: str = "global"
    # federation peers: region name -> that region's agent HTTP address
    # (the reference discovers via WAN serf; here configured)
    region_peers: dict = field(default_factory=dict)
    # ACL/namespace replication source (nomad/config.go
    # AuthoritativeRegion + ReplicationToken): non-authoritative
    # leaders replicate policies, GLOBAL tokens, and namespaces from it
    authoritative_region: str = ""
    replication_token: str = ""
    # max READY evals one worker drains into concurrent lanes (1
    # disables batching)
    eval_batch_size: int = 1
    # driver/config for injected connect proxy tasks (the reference
    # hardcodes docker+envoy, job_endpoint_hook_connect.go:23)
    connect_sidecar_driver: str = "docker"
    connect_sidecar_config: Optional[dict] = None
    # GC safepoints (server/worker.py): disable automatic CPython
    # collection and collect young gens between evals, keeping
    # collector pauses out of scheduling latency. Process-wide side
    # effect, so off by default.
    gc_safepoints: bool = False
    heartbeat_ttl_s: float = 10.0
    # cluster rollup staleness: a node whose heartbeat host-stats
    # payload is older than this counts as a stale heartbeat in
    # cluster_stats and drops out of the fleet used-vs-allocated
    # economics (its capacity still counts)
    stats_stale_after_s: float = 30.0
    # lease TTL for derived vault tokens (vault.go ttl on CreateToken);
    # clients renew at ttl/2 via Node.RenewVaultToken
    vault_token_ttl_s: float = 3600.0
    # how long a failed eval's work waits to run again: the reaper's
    # follow-up delay for an eval past the broker's delivery limit, and
    # the leader's interval for requeueing evals blocked on exhausted
    # plan attempts (nomad/leader.go: both 1 minute)
    failed_eval_unblock_delay_s: float = 60.0
    data_dir: str = ""              # empty == in-memory only
    snapshot_every: int = 1024      # WAL entries between snapshots
    # write format-2 columnar snapshots (state/columnar.py) instead of
    # the legacy per-object dump; restore reads both formats, so
    # flipping this is always safe
    snapshot_columnar: bool = True
    # serialize snapshots on a background thread off an O(1) MVCC
    # store snapshot, so the applier never blocks on a dump
    snapshot_background: bool = True
    # WAL durability: fsync appends at all, and whether a committed
    # entry batch pays ONE fsync (group) or one per frame
    wal_fsync: bool = False
    wal_group_fsync: bool = True
    # GC cadence + retention (nomad/config.go *GCInterval/*GCThreshold)
    gc_interval_s: float = 60.0
    eval_gc_threshold_s: float = 3600.0
    job_gc_threshold_s: float = 4 * 3600.0
    node_gc_threshold_s: float = 24 * 3600.0
    deployment_gc_threshold_s: float = 3600.0
    # ACL subsystem (nomad/config.go ACLEnabled)
    acl_enabled: bool = False
    # group-commit plan applier (plan_applier.py): max queued plans
    # drained into ONE overlay-aware verify pass + ONE raft entry +
    # ONE state-store transaction + ONE event flush. 1 restores the
    # one-entry-per-plan pipeline
    plan_group_max: int = 32
    # adaptive micro-batch eval dispatch (server/worker.py
    # MicroBatchGateway): concurrent evals' kernel requests accumulate
    # for up to this window and ship as ONE batched launch. The live
    # window adapts off the arrival-rate EWMA (idle lanes dispatch
    # immediately) and queue depth; on the card the base widens to half
    # the measured host <-> card round trip. 0 builds no gateway at all
    # (workers with eval_batch_size > 1 then rendezvous per drain in a
    # BatchGateway)
    gateway_window_us: int = 2000
    # occupancy trigger: a lane holding this many parked requests
    # fires without waiting out the window
    gateway_min_batch: int = 4
    # broker READY depth above which the gateway widens its window
    # (occupancy over per-eval latency while a backlog exists; decays
    # back once the queue drains). The governor's READY-depth watermark
    # reclaim also widens it directly
    governor_gateway_depth_high: int = 512
    # startup calibration probe (ops/select.calibrate_cost_model):
    # measure the solo + batched dispatch arms at the store's table
    # shape and seed the dispatch cost model before traffic. Pays the
    # kernels' build at start, so off by default
    dispatch_calibration: bool = False
    # autopilot dead-server cleanup (nomad/autopilot.go): a voter with
    # no replication contact for this long is removed from the member
    # set; 0 disables
    dead_server_cleanup_s: float = 60.0
    # scales the cluster's failure timers (nomad/config.go
    # RaftMultiplier): raft's election timeout and SWIM's probe timeout
    # and suspicion. 1 keeps the reference's timings; servers that share
    # one process (and its interpreter lock) under load need more, or a
    # busy peer reads as a dead one
    raft_multiplier: float = 1.0
    # distributed scheduler plane (server/follower_sched.py): when
    # clustered, followers run worker pools against their LOCAL
    # replicated store, dequeuing evals from the leader's broker over
    # RPC and submitting plans back for leader-only verify/commit.
    # Off = the leader schedules alone
    follower_sched: bool = True
    # leader-side lease on a remotely dequeued eval: a dead follower's
    # evals return to READY after this long (with zero re-enqueue
    # delay — the follower failed, not the eval), instead of waiting
    # out the broker's full 60 s unack timer
    follower_lease_s: float = 30.0
    # follower-side snapshot fence budget: how long a follower worker
    # waits for local raft catch-up to reach the eval's modify index
    # before NACKing it back (a lagging replica must not schedule from
    # the past, and must not silently drop the eval either)
    follower_fence_timeout_s: float = 5.0
    # remote worker pool size per follower
    follower_max_remote: int = 2
    # batched write ingest (server/ingest.py): job registers, client
    # alloc-status updates and desired-transition writes that arrive
    # while a raft apply is in flight park and land as ONE
    # `ingest_batch` entry / store transaction / event flush. Entries
    # per batch cap:
    ingest_batch_max: int = 64
    # coalescing window (microseconds) a lone streaming write waits for
    # companions. <0 builds no gateway at all (the one-entry-per-write
    # path)
    ingest_window_us: float = 200.0
    # queued-write depth at which check_admission sheds new writes (the
    # byte watermark derives from this: depth x 64 KiB)
    ingest_queue_high: int = 256
    # governor watermark on ingest.queue_depth that fires the
    # shrink_window reclaim (distinct from the shed watermark above —
    # the governor reclaims well before the edge starts refusing)
    governor_ingest_queue_high: int = 64
    # steady-state governor (governor/): accounting cadence, watermark
    # levels for the pressure gauges, and structure bounds. Levels are
    # deliberately high — backpressure is an overload valve, not a
    # scheduler tune
    governor_enabled: bool = True
    governor_interval_s: float = 1.0
    governor_broker_depth_high: int = 8192
    governor_plan_depth_high: int = 256
    governor_p99_high_ms: float = 1000.0
    # the p99 watermark needs a WARM, populated latency reservoir before
    # it means anything — a fresh server's first evals carry the
    # kernels' build and the table's first upload. Gates on observed
    # latencies, not uptime, and MUST exceed Governor.P99_WINDOW (512):
    # the gauge reads the most recent 512 samples
    governor_p99_min_samples: int = 640
    governor_version_debt_high: int = 100_000
    # byte watermark for early event-history shedding; the ring's own
    # count/byte caps are the hard bound, this is the soft one (0 =
    # disabled: never truncate below the ring's own caps)
    governor_event_bytes_high: int = 12 << 20
    # kernel_cache.entries watermark; 0 = derive it from the JAX
    # package's shape-LRU bound (2 x KERNEL_CACHE_MAX + 512)
    governor_kernel_cache_high: int = 0
    # device-resident node table (ops/device_table.py): scattered-row
    # debt that triggers the fold reclaim (one contiguous re-upload
    # replacing the scatter history)
    governor_table_delta_debt_high: int = 200_000
    # backpressure escalation: when the broker's delayed/requeue heap
    # crosses this depth, the HTTP job-register path returns 429 +
    # Retry-After (0 disables)
    governor_broker_delayed_high: int = 16384
    # intra-group conflict demotions in the applier's 10 s window above
    # this shrink the group bound (reclaim halves it; a clean streak
    # re-widens) instead of letting demoted plans thrash verify-retry
    # round trips
    governor_plan_group_conflict_high: int = 64
    # total pending columnar-index delta debt across jobs: crossing it
    # folds the index back to dense rebuild
    governor_reconcile_index_debt_high: int = 65536
    # watermark on live victim-memo entries; crossing it drops the memo
    governor_preempt_cache_high: int = 150_000
    # watermark on live feasibility mask-cache entries; crossing it
    # drops cached masks but KEEPS the intern tables
    governor_feas_mask_cache_high: int = 192
    # watermark on accumulated residue-scatter rows atop the parked
    # device masks; crossing it folds the FeasMaskStore
    governor_feas_residue_high: int = 262_144
    # scattered-row debt on the mesh-resident table that triggers its
    # fold reclaim (one contiguous sharded re-upload)
    mesh_reshard_debt_high: int = 500_000
    # eval flight recorder (trace/): per-eval span tracing — enqueue ->
    # gateway -> kernel -> group commit -> ack — with a byte-bounded
    # ring of completed traces, pinned tail exemplars and per-stage
    # percentile reservoirs, served at /v1/operator/trace. False
    # disarms the process-wide recorder
    trace_enabled: bool = True
    trace_ring_bytes: int = 4 << 20
    # exemplar slots: evals whose full enqueue->ack latency clears the
    # adaptive threshold keep their whole span tree plus a governor
    # gauge snapshot (worst-K retention; drift findings auto-pin)
    trace_exemplar_slots: int = 8
    # promotion threshold as a percent of the governor-tracked
    # full-latency p99 (100 = promote anything at/above p99)
    trace_exemplar_threshold_pct: float = 100.0
    # retained telemetry collector (telemetry/): sampling cadence of the
    # history ring behind /v1/operator/telemetry, /v1/operator/flatness
    # and `operator top`. 0 builds no collector (snapshot-only
    # /v1/metrics, the routes report disabled)
    telemetry_sample_interval_s: float = 1.0
    # history ring depth: slots per series (with the 256-series cap the
    # ring's byte ceiling is slots x 256 x 8 bytes, 1 MiB at 512)
    telemetry_ring_slots: int = 512


class Server:
    def __init__(self, config: Optional[ServerConfig] = None,
                 device=None):
        self.config = config or ServerConfig()
        # where every kernel of this server runs: the card unless the
        # caller asks for the CPU
        self.device = resolve_device(device)
        self.store = StateStore()
        # RLock: FSM appliers can nest (e.g. a node-register unblocking a
        # blocked eval re-enters raft_apply on the same thread)
        self._raft_l = make_rlock()
        self._raft_index = 10
        self.eval_broker = EvalBroker()
        # backpressure escalation threshold lives on the broker even
        # with the governor off — the HTTP register path reads it
        self.eval_broker.delayed_depth_high = \
            self.config.governor_broker_delayed_high
        self.blocked_evals = BlockedEvals(self._unblock_enqueue)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(self.plan_queue, self)
        # distributed scheduler plane: the lease table is the
        # leader-side half (remote-dequeue leases + counters, empty on
        # non-leaders); the follower half is built in attach_raft — a
        # dev-mode server never constructs one
        self.eval_leases = EvalLeaseTable(self)
        self.follower_sched = None
        self.time_table = TimeTable()
        self.periodic = PeriodicDispatch(self)
        self.deployments_watcher = DeploymentsWatcher(self)
        self.node_drainer = NodeDrainer(self)
        self.events = EventBroker()
        # durable webhook sinks, run by the leader
        self.event_sinks = EventSinkManager(self)
        # ACL/namespace replication from the authoritative region, run
        # by a non-authoritative leader
        self._replication = None
        self._retired_replication: list = []
        # adaptive micro-batch eval dispatch: one gateway per server —
        # every worker's (and every lane thread's) kernel dispatches
        # coalesce here, on a kernel on the server's device. window=0
        # means NO gateway object
        self.gateway = None
        if self.config.gateway_window_us > 0:
            self.gateway = MicroBatchGateway(
                kernel=SelectKernel(self.device),
                window_us=self.config.gateway_window_us,
                min_batch=self.config.gateway_min_batch,
                depth_fn=lambda: self.eval_broker.stats.total_ready,
                depth_high=self.config.governor_gateway_depth_high)
        # batched write ingest: the write-side twin of the gateway
        # above — no object under ingest_window_us < 0, so every write
        # takes the one-raft-entry-per-object path
        self.ingest = None
        if self.config.ingest_window_us >= 0:
            self.ingest = IngestGateway(
                self,
                batch_max=self.config.ingest_batch_max,
                window_us=self.config.ingest_window_us,
                queue_high=self.config.ingest_queue_high)
        self.governor = None
        self.tracer = None
        self._tracer_fns = None
        self.telemetry = None
        self._observability()
        self.workers: List[Worker] = []
        # the latest host-stats payload of each node's heartbeat, which
        # cluster_stats folds
        self._node_stats: Dict[str, dict] = {}
        self._node_stats_l = make_lock()
        # every node's heartbeat TTL on one thread (server/heartbeat.py)
        self._heartbeats = HeartbeatTimers(self.config.heartbeat_ttl_s,
                                           self._invalidate_heartbeat)
        # timers a revoked leadership stopped without waiting; shutdown
        # joins them
        self._retired_heartbeats: List[HeartbeatTimers] = []
        self._leader = False
        self._member_l = make_lock()   # join/leave RMW serialization
        self.raft = None                # multi-server consensus (raft.py)
        self.swim = None                # peer failure detection (swim.py)
        # thread-local: set on the FSM applier thread while an applier
        # runs, so nested raft_apply side effects are detected per
        # thread — an instance-wide flag would make a concurrent client
        # write on another thread look nested and silently drop it
        self._apply_tl = threading.local()
        # serializes enforced (-check-index) registrations: the CAS
        # check and the apply must not interleave across threads
        self._register_l = make_lock()
        self._acl_cache: Dict = {}      # (policies, index) -> compiled ACL
        self._shutdown_ev = threading.Event()
        self._threads: List[threading.Thread] = []
        # restore persisted state after every subsystem exists: WAL
        # replay drives the same FSM appliers (broker and blocked evals
        # stay disabled until leadership, so replay schedules nothing,
        # and it publishes no change events: replay is not new history)
        self.persistence = None
        self.cold_start_stats: Dict[str, float] = {}
        if self.config.data_dir:
            try:
                self._restore_from_disk()
            except BaseException:
                if self.persistence is not None:
                    self.persistence.log.close()
                raise
        # event history starts HERE: restore and replay publish no
        # events, so history at or below this floor has a proven gap
        self.events.epoch_floor = self._raft_index
        if self.persistence is not None:
            # measured per-(arm, n_pad) dispatch costs persist beside the
            # WAL: a restarted server batches off its last life's
            # measurements (the first live sample per restored shape is
            # dropped, since it may pay this process's kernel build)
            from ..ops.select import cost_model
            seeds = self.persistence.load_cost_model()
            if seeds:
                loaded = cost_model.load_snapshot(seeds)
                LOG.info("cost model restored: %d measured shapes",
                         loaded)
            self.persistence.cost_model_provider = cost_model.snapshot
            if self.governor is not None:
                self._register_persistence_gauges()

    def _observability(self) -> None:
        """Build the governor (with every structure's gauge), configure
        the process-wide flight recorder from this server's knobs and
        wire it to the governor — the exemplar threshold tracks the
        FULL-latency p99, each promoted exemplar snapshots the gauge
        rows, and a drift finding that names a suspect structure pins
        the current exemplar set — and build the telemetry collector."""
        from ..governor import Governor
        from ..telemetry import TelemetryCollector, default_device_fn
        from ..trace import tracer as flight
        cfg = self.config
        if cfg.governor_enabled:
            self.governor = Governor(interval_s=cfg.governor_interval_s)
            self._register_governor_gauges()
        self.tracer = flight
        flight.configure(ring_bytes=cfg.trace_ring_bytes,
                         exemplar_slots=cfg.trace_exemplar_slots,
                         threshold_pct=cfg.trace_exemplar_threshold_pct,
                         enabled=cfg.trace_enabled)
        # one gauge-snapshot closure serves BOTH the recorder's exemplar
        # snapshots and the collector's per-slot sampling, so the two
        # never diverge on how gauge rows are read
        gauge_snapshot_fn = None
        gov = self.governor
        if gov is not None:
            gauge_snapshot_fn = lambda g=gov: {  # noqa: E731
                r["name"]: r["value"] for r in g.registry.rows()}
            flight.threshold_fn = \
                lambda g=gov: g.latency_percentile_ms(99)
            flight.gauge_fn = gauge_snapshot_fn
            # remembered so shutdown detaches THESE closures (and only
            # these — a newer server may have rebound them): the
            # process-wide recorder outlives this server, and the
            # closures would otherwise pin the dead governor's graph
            self._tracer_fns = (flight.threshold_fn, flight.gauge_fn)
            gov.drift_hooks.append(self._auto_pin_exemplars)
        if cfg.telemetry_sample_interval_s > 0:
            dev = self.device
            self.telemetry = TelemetryCollector(
                interval_s=cfg.telemetry_sample_interval_s,
                slots=cfg.telemetry_ring_slots,
                gauges_fn=gauge_snapshot_fn,
                latency_fn=(None if gov is None
                            else gov.latency_percentile_ms),
                stage_fn=flight.stage_percentiles,
                device_fn=lambda: default_device_fn(dev),
                # device-mirror residency + the cluster.* rollup read
                # through self (the table cache is replaced on restore)
                extra_fn=self._telemetry_extra)

    def _register_governor_gauges(self) -> None:
        """Wire every long-lived structure into the governor's
        accounting registry, with watermark policies and targeted
        reclamation where a bound exists (the reference keeps these
        flat via core_sched GC + EmitStats). The JAX package's `lock.*`
        gauges read the race sanitizer, which the port does not carry."""
        from ..governor import WatermarkPolicy
        from ..ops.select import (KERNEL_CACHE_MAX, clear_kernel_caches,
                                  device_stats_snapshot,
                                  kernel_cache_entries, mesh_stats_snapshot)
        from ..ops.tables import BUILD_STATS, resource_memo_len
        from ..ops import spread as _spread_mod
        from ..scheduler import feasible_compiler as _feas_mod
        from ..scheduler.preemption import PREEMPT_STATS as _ps
        from ..scheduler.stack import (engine_cache_entries,
                                       tasks_updated_hit_rate)
        from ..trace import tracer as flight
        cfg = self.config
        gov = self.governor
        broker = self.eval_broker   # .stats is REPLACED on flush —
        # gauges must read through the broker, never a captured stats

        # broker queues: READY depth is the admission signal
        # (backpressure sheds enqueues, workers shrink lanes); with the
        # micro-batch gateway live its reclaim WIDENS the dispatch
        # window — under a backlog, occupancy beats per-eval latency
        gov.register("broker.ready", lambda: broker.stats.total_ready,
                     WatermarkPolicy(cfg.governor_broker_depth_high,
                                     pressure=True),
                     reclaim=(self.gateway.widen_window
                              if self.gateway is not None else None))
        gov.register("broker.unacked",
                     lambda: broker.stats.total_unacked)
        gov.register("broker.waiting",
                     lambda: broker.stats.total_waiting)
        gov.register("broker.shed", lambda: broker.stats.total_shed,
                     suspect=False)  # monotone counter, not a structure
        gov.register("blocked_evals.blocked",
                     self.blocked_evals.blocked_count)
        gov.register("plan_queue.depth", self.plan_queue.depth,
                     WatermarkPolicy(cfg.governor_plan_depth_high,
                                     pressure=True))

        # sampled service p99 from the workers' latency reservoir: the
        # primary backpressure gauge. It reports 0 until the reservoir
        # holds enough REAL latencies — gating on observed evals, not
        # sampler uptime, so a cold start's first launches can't trip it
        def p99_gauge():
            if gov.latency_samples() < cfg.governor_p99_min_samples:
                return 0.0
            # recent_: a reservoir with no fresh latencies reads 0, so
            # an engaged-backpressure idle period can't latch the
            # watermark shut on frozen samples
            return gov.recent_p99_ms()
        # suspect=False: this IS the perf signal, not a structure whose
        # growth could explain it
        gov.register("service.p99_ms", p99_gauge,
                     WatermarkPolicy(cfg.governor_p99_high_ms,
                                     pressure=True),
                     unit="ms", suspect=False)

        # event broker: the ring enforces its own count+byte caps on
        # publish (the hard bound); the watermark is the SOFT byte bound
        gov.register("event_broker.events", self.events.buffered_events)
        if cfg.governor_event_bytes_high > 0:
            gov.register("event_broker.bytes",
                         self.events.buffered_bytes,
                         WatermarkPolicy(cfg.governor_event_bytes_high),
                         reclaim=lambda: self.events.truncate(0.5),
                         unit="bytes")
        else:
            gov.register("event_broker.bytes",
                         self.events.buffered_bytes, unit="bytes")

        # state store: uncompacted layer-overlay debt with fold
        # compaction as the reclaim (force: crossing the watermark IS
        # the escalation); the changelog is already bounded
        gov.register("state.version_debt", self.store.version_debt,
                     WatermarkPolicy(cfg.governor_version_debt_high),
                     reclaim=lambda: self.store.compact(min_tip=1024,
                                                        force=True))
        gov.register("state.changelog", self.store.changelog_len)
        gov.register("state.allocs",
                     lambda: len(self.store._root.table("allocs")))
        gov.register("state.evals",
                     lambda: len(self.store._root.table("evals")))

        # what the kernel layer keeps per kernel or per shape (the
        # library, the sharded kernels' route memos); the reclaim drops
        # what the next launch rebuilds
        kc_high = cfg.governor_kernel_cache_high or \
            (2 * KERNEL_CACHE_MAX + 512)
        gov.register("kernel_cache.entries", kernel_cache_entries,
                     WatermarkPolicy(kc_high),
                     reclaim=clear_kernel_caches)

        # resident-table identity memos (ops/tables.py): FIFO-bounded,
        # but accounted — every entry pins a resources graph
        gov.register("node_table.resource_memo", resource_memo_len)

        # device-resident node table: scattered-row debt with the fold
        # as the reclaim (one contiguous re-upload of the mirror on the
        # card replaces the scatter history). Gauges read through
        # self.store: the table cache is REPLACED on snapshot restore
        gov.register("node_table.delta_debt",
                     lambda: self.store.table_cache.device_delta_debt(),
                     WatermarkPolicy(cfg.governor_table_delta_debt_high),
                     reclaim=lambda: self.store.table_cache.fold_device())
        gov.register("node_table.delta_log",
                     lambda: self.store.table_cache.device_delta_log_len())
        gov.register("node_table.full_builds",
                     lambda: BUILD_STATS["full_builds"], suspect=False)
        gov.register("node_table.delta_refreshes",
                     lambda: BUILD_STATS["delta_refreshes"],
                     suspect=False)

        # the mesh-resident node table (set_mesh): device count,
        # resident footprint, the reshard / delta-scatter traffic split,
        # and the scattered-row debt whose reclaim is a contiguous
        # re-upload. All read through the process-wide snapshot (empty
        # -> 0 while no mesh is set)
        def _mesh(key):
            return lambda: float(mesh_stats_snapshot().get(key, 0) or 0)

        gov.register("mesh.devices", _mesh("devices"), suspect=False)
        gov.register("mesh.resident_bytes_per_device",
                     _mesh("resident_bytes_per_device"))
        gov.register("mesh.reshard_uploads", _mesh("reshard_uploads"),
                     suspect=False)
        gov.register("mesh.delta_scatters", _mesh("delta_scatters"),
                     suspect=False)
        gov.register("mesh.resident_hits", _mesh("resident_hits"),
                     suspect=False)
        gov.register("mesh.reshard_debt",
                     lambda: self.store.table_cache.mesh_reshard_debt(),
                     WatermarkPolicy(cfg.mesh_reshard_debt_high),
                     reclaim=lambda: self.store.table_cache.fold_mesh())

        # backpressure escalation: the delayed/requeue heap depth — when
        # admission deferral itself backs up, the HTTP register path
        # sheds with 429s
        gov.register("broker.delayed_depth", broker.delayed_depth)

        # group-commit plan applier: group sizing and intra-group
        # conflict visibility. The conflict gauge reads a sliding 10 s
        # window; its reclaim SHRINKS the group bound, and the applier
        # re-widens after a clean streak
        applier = self.plan_applier
        gov.register("plan_group.size", applier.mean_group_size,
                     suspect=False)
        gov.register("plan_group.conflict_retries",
                     applier.conflict_pressure,
                     WatermarkPolicy(
                         cfg.governor_plan_group_conflict_high),
                     reclaim=applier.shrink_group_bound, suspect=False)
        gov.register("plan_group.singleton_fallbacks",
                     lambda: applier.stats["singleton_fallbacks"],
                     suspect=False)

        # cross-eval engine host-phase reuse (scheduler/stack.py)
        gov.register("engine_cache.entries", engine_cache_entries)

        # columnar reconcile engine (state/alloc_index.py): index
        # sizing, dense rebuilds, the tasks_updated memo hit rate, and
        # pending delta debt with fold-to-rebuild as the reclaim
        gov.register("reconcile.index_rows",
                     lambda: self.store.alloc_index.rows())
        gov.register("reconcile.index_rebuilds",
                     lambda: self.store.alloc_index.stats["rebuilds"],
                     suspect=False)
        gov.register("reconcile.tasks_updated_hit_rate",
                     tasks_updated_hit_rate, unit="ratio",
                     suspect=False)
        gov.register("reconcile.index_debt",
                     lambda: self.store.alloc_index.debt(),
                     WatermarkPolicy(
                         cfg.governor_reconcile_index_debt_high),
                     reclaim=lambda: self.store.alloc_index.fold())

        # batched columnar preemption: candidate-matrix volume, victim
        # memo traffic, invalidations (monotone); the memo SIZE carries
        # the watermark, read through self.store
        gov.register("preemption.candidate_rows",
                     lambda: _ps["candidate_rows"], suspect=False)
        gov.register("preemption.victim_cache_hits",
                     lambda: _ps["cache_hits"], suspect=False)
        gov.register("preemption.cache_invalidations",
                     lambda: _ps["invalidations"], suspect=False)
        gov.register("preemption.victim_cache_entries",
                     lambda: self.store.table_cache.preempt_cache_len(),
                     WatermarkPolicy(cfg.governor_preempt_cache_high),
                     reclaim=lambda:
                     self.store.table_cache.clear_preempt_cache())

        # compiled feasibility: intern-table volume, cached masks and
        # the hit rate; the mask gauge carries the watermark and its
        # reclaim drops MASKS only (intern tables survive)
        gov.register("feas.intern_values",
                     lambda: self.store.attr_index.gauge_stats()
                     ["intern_values"], suspect=False)
        gov.register("feas.mask_cache_entries",
                     lambda: self.store.attr_index.gauge_stats()
                     ["mask_cache_entries"],
                     WatermarkPolicy(cfg.governor_feas_mask_cache_high),
                     reclaim=lambda: self.store.attr_index.drop_masks())
        gov.register("feas.mask_cache_hit_rate", _feas_mod.hit_rate,
                     unit="ratio", suspect=False)
        gov.register("feas.recompiles",
                     lambda: _feas_mod.stats()["recompiles"],
                     suspect=False)

        # residue-compiled feasibility: token survival vs invalidation
        # counts; the residue-rows gauge carries the watermark and its
        # reclaim FOLDS the FeasMaskStore (parked entries drop)
        gov.register("feas.token_survivals",
                     lambda: _feas_mod.stats()["token_survivals"],
                     suspect=False)
        gov.register("feas.token_invalidations",
                     lambda: _feas_mod.stats()["token_invalidations"],
                     suspect=False)
        gov.register("feas.residue_rows",
                     lambda: self.store.table_cache.device.feas.debt(),
                     WatermarkPolicy(cfg.governor_feas_residue_high),
                     reclaim=lambda:
                     self.store.table_cache.device.feas.fold())
        gov.register("feas.spread_score_evals",
                     lambda: _spread_mod.stats()["spread_score_evals"],
                     suspect=False)

        # micro-batch gateway: live window, mean lanes per fire, and the
        # trigger split (monotone or performance gauges)
        if self.gateway is not None:
            gw = self.gateway
            gov.register("gateway.window_us", gw.window_us, unit="us",
                         suspect=False)
            gov.register("gateway.batch_occupancy", gw.occupancy_mean,
                         unit="ratio", suspect=False)
            gov.register("gateway.immediate_dispatches",
                         lambda: gw.stats["immediate_dispatches"],
                         suspect=False)
            gov.register("gateway.deadline_dispatches",
                         lambda: gw.stats["deadline_dispatches"],
                         suspect=False)

        # batched write ingest: queue depth carries the watermark whose
        # reclaim HALVES the window (a deep queue means the committer is
        # saturated — waiting for companions only adds latency)
        if self.ingest is not None:
            ing = self.ingest
            gov.register("ingest.queue_depth", ing.queue_depth,
                         WatermarkPolicy(cfg.governor_ingest_queue_high,
                                         pressure=True),
                         reclaim=ing.shrink_window)
            gov.register("ingest.queue_bytes", ing.queue_bytes,
                         suspect=False)
            gov.register("ingest.window_us", ing.window_us, unit="us",
                         suspect=False)
            gov.register("ingest.batch_size", ing.mean_batch_size,
                         suspect=False)
            gov.register("ingest.coalesced_writes",
                         lambda: ing.stats["coalesced_writes"],
                         suspect=False)
            gov.register("ingest.shed", lambda: ing.stats["shed"],
                         suspect=False)
            gov.register("ingest.write_p99_ms", ing.write_p99_ms,
                         unit="ms", suspect=False)

        # fresh launches: dispatches that built or loaded the kernels'
        # library, summed over the arms (the JAX package counts distinct
        # compiled trace signatures here). Monotone, never a suspect
        gov.register("lint.recompiles",
                     lambda: sum(device_stats_snapshot()
                                 ["compiles"].values()),
                     suspect=False)

        # flight-recorder visibility: ring occupancy and exemplar count
        # (both bounded by construction)
        gov.register("trace.ring_traces", flight.ring_len,
                     suspect=False)
        gov.register("trace.exemplars", flight.exemplar_count,
                     suspect=False)

        # distributed scheduler plane: leader-side lease counters, and
        # the follower-side fence-wait p99 (follower_sched is built by
        # attach_raft, after these closures are registered)
        leases = self.eval_leases
        gov.register("cluster_sched.remote_dequeues",
                     lambda: leases.stats["remote_dequeues"],
                     suspect=False)
        gov.register("cluster_sched.remote_demotions",
                     lambda: leases.stats["remote_demotions"],
                     suspect=False)
        gov.register("cluster_sched.leases_outstanding",
                     leases.outstanding)
        gov.register("cluster_sched.lease_expiries",
                     lambda: leases.stats["expired"], suspect=False)
        gov.register("cluster_sched.fence_wait_p99_ms",
                     lambda: (self.follower_sched.fence_wait_p99_ms()
                              if self.follower_sched is not None
                              else 0.0),
                     unit="ms", suspect=False)

        # admission control: the broker sheds fresh enqueues while any
        # pressure gauge is over
        self.eval_broker.pressure_fn = gov.backpressure

    def _auto_pin_exemplars(self, finding: dict) -> None:
        """Drift hook: a drift finding that names a suspect structure
        pins the flight recorder's CURRENT exemplar set — the worst span
        trees recorded while the drift was building are the capture an
        operator would have wanted `operator debug` to take."""
        suspect = finding.get("suspect_structure")
        if not suspect:
            return
        reason = (f"drift:{finding.get('metric', '?')}"
                  f"->{suspect}")
        pinned = self.tracer.pin_exemplars(reason=reason)
        if pinned and self.governor is not None:
            self.governor.emit({"kind": "trace_pin",
                                "exemplars": pinned,
                                "suspect": suspect,
                                "metric": finding.get("metric")})

    def _register_persistence_gauges(self) -> None:
        """Snapshot cadence, off-thread serialization time and skipped
        triggers — a snapshot that keeps getting skipped in flight means
        the store outgrew the writer and the WAL tail is ballooning.
        Registered apart from _register_governor_gauges because
        Persistence is built after the governor. Monotone/perf gauges,
        never drift suspects."""
        p = self.persistence
        gov = self.governor
        gov.register("persistence.snapshots",
                     lambda: p.stats["snapshots"], suspect=False)
        gov.register("persistence.snapshot_skipped_inflight",
                     lambda: p.stats["snapshot_skipped_inflight"],
                     suspect=False)
        gov.register("persistence.last_snapshot_s",
                     lambda: p.stats["last_snapshot_s"], unit="s",
                     suspect=False)
        gov.register("persistence.snapshot_errors",
                     lambda: p.stats["snapshot_errors"], suspect=False)

    def _emit_stats(self) -> None:
        """Periodic gauge emission (eval_broker.go:825 EmitStats,
        blocked_evals stats, worker counters), once a second until
        shutdown."""
        while not self._shutdown_ev.wait(1.0):
            bs = self.eval_broker.stats
            metrics.set_gauge("nomad.broker.total_ready", bs.total_ready)
            metrics.set_gauge("nomad.broker.total_unacked",
                              bs.total_unacked)
            metrics.set_gauge("nomad.broker.total_blocked",
                              bs.total_blocked)
            metrics.set_gauge("nomad.broker.total_waiting",
                              bs.total_waiting)
            metrics.set_gauge("nomad.blocked_evals.total_blocked",
                              self.blocked_evals.blocked_count())
            metrics.set_gauge(
                "nomad.worker.total_processed",
                sum(w.stats["processed"] for w in self.workers))
            metrics.set_gauge(
                "nomad.worker.total_failed",
                sum(w.stats["failed"] for w in self.workers))
            metrics.set_gauge("nomad.state.latest_index",
                              self.store.latest_index())

    def _restore_from_disk(self) -> None:
        """The cold start: load the snapshot, prime the resident node
        table ONCE at the restored index (from the snapshot's decoded
        columns when the format has them), upload the device mirror on
        a PrefetchThread while the WAL tail replays, then join it. The
        first eval after the restart takes the table's delta path from
        the snapshot's index to the replayed one, which scatters the
        rows the replayed plans changed onto the mirror. On the CPU
        route the prefetch builds the same mirror as CPU tensors. A
        failed or refused upload raises from here."""
        from ..ops.tables import PrefetchThread
        from .persistence import Persistence
        self.persistence = Persistence(
            self.config.data_dir, self.config.snapshot_every,
            columnar=self.config.snapshot_columnar,
            background=self.config.snapshot_background,
            wal_fsync=self.config.wal_fsync,
            wal_group_fsync=self.config.wal_group_fsync)
        self.persistence.extra_provider = lambda: {
            "time_table": self.time_table.dump()}
        t0 = time.perf_counter()
        highest, entries = self.persistence.restore_into(self.store)
        restore_s = time.perf_counter() - t0
        self.time_table.restore(
            self.persistence.restored_extra.get("time_table", []))
        self._raft_index = max(self._raft_index, highest)
        table_build_s = 0.0
        prefetch = None
        if highest > 0:
            t0 = time.perf_counter()
            self.store.table_cache.prime(self.store.snapshot(),
                                         self.store.pop_cold_columns())
            table_build_s = time.perf_counter() - t0
            prefetch = PrefetchThread(self.store.table_cache, self.device)
            prefetch.start()
        t0 = time.perf_counter()
        try:
            replayed = self._replay_entries(entries, highest)
        finally:
            wal_replay_s = time.perf_counter() - t0
            # joined before any worker exists: no eval can reach the
            # table cache while the upload holds its lock
            t0 = time.perf_counter()
            if prefetch is not None:
                prefetch.join()
            prefetch_join_s = time.perf_counter() - t0
        self.cold_start_stats = {
            "restore_s": restore_s,
            "table_build_s": table_build_s,
            "wal_replay_s": wal_replay_s,
            "wal_entries_replayed": float(replayed),
            "snapshot_format": float(
                self.persistence.stats["restore_format"]),
            "prefetch_join_s": prefetch_join_s,
        }

    # -- lifecycle -----------------------------------------------------
    def attach_raft(self, rpc_server, peers, self_addr: str = "") -> None:
        """Join a multi-server cluster: the raft node drives leadership
        (nomad/server.go setupRaft + leader.go monitorLeadership)."""
        from .follower_sched import FollowerScheduler, rpc_handlers
        from .raft import RaftNode
        from .swim import PROBE_TIMEOUT_S, SUSPICION_S, SwimDetector
        self.raft = RaftNode(self, self_addr or rpc_server.addr,
                             list(peers), data_dir=self.config.data_dir,
                             multiplier=self.config.raft_multiplier)
        rpc_server.methods.update(self.raft.rpc_methods())
        rpc_server.raft = self.raft
        # reconcile REPLICATED membership over the static boot config:
        # a restarted server must adopt the grown/shrunk voter set its
        # WAL/snapshot recorded (and an evicted server must come back
        # inert), or its quorum math is wrong from the first election
        members = self.store.server_members()
        if members:
            self.raft.update_members(members)
        # peer-to-peer failure detection (SWIM; nomad/serf.go): every
        # member probes, not just the leader's replication threads
        m = max(float(self.config.raft_multiplier), 1.0)
        self.swim = SwimDetector(self, probe_timeout_s=m * PROBE_TIMEOUT_S,
                                 suspicion_s=m * SUSPICION_S)
        # distributed scheduler plane: the remote-dequeue verb surface
        # rides the same RPC transport raft does, and the follower
        # worker pool is built here — started by start(), inert
        # whenever this server is (or becomes) the leader
        rpc_server.methods.update(rpc_handlers(self))
        self.follower_sched = FollowerScheduler(self)

    def start(self) -> None:
        if self.raft is None:
            self.establish_leadership()
        else:
            self.raft.start()
            self.swim.start()
            self.follower_sched.start()
        self.plan_applier.start()
        if self.ingest is not None:
            self.ingest.start()
        for i in range(self.config.num_schedulers):
            w = Worker(self, list(self.config.enabled_schedulers)
                       + [JOB_TYPE_CORE], wid=i)
            self.workers.append(w)
            w.start()
        for target, name in ((self._reap_failed_evals, "eval-reaper"),
                             (self._schedule_periodic_gc, "gc-ticker"),
                             (self._emit_stats, "stats-ticker"),
                             (self._watch_volumes, "volume-watcher")):
            t = threading.Thread(target=target, daemon=True, name=name)
            self._threads.append(t)
            t.start()
        if self.governor is not None:
            self.governor.start()
        if self.telemetry is not None:
            self.telemetry.start()
        if self.config.dispatch_calibration:
            # seed the dispatch cost model at the store's table shape
            # BEFORE traffic (no nodes yet == nothing to calibrate;
            # callers that seed nodes programmatically call
            # calibrate_cost_model themselves after seeding)
            n = self.store.node_count()
            if n >= 8:
                from ..ops.select import calibrate_cost_model
                calibrate_cost_model(
                    n, lanes=self.config.gateway_min_batch,
                    kernel=SelectKernel(self.device))

    def shutdown(self) -> None:
        """Stop every service and join every thread this server
        started: the scheduler plane first (the follower workers and
        the lease sweeper talk to remote transports), the telemetry
        collector's and the governor's samplers (and this server's
        closures off the process-wide flight recorder), then the raft node
        (its ticker and FSM applier, so no entry reaches the WAL past
        this point) and SWIM, then the workers (and their finishers),
        the applier and its committer, the ingest gateway, the reaper,
        the GC ticker, the stats ticker, the volume watcher, the autopilot, the periodic
        dispatcher, the deployments watcher, the drainer and the
        heartbeat timers' thread; the event-sink writers and the
        replication threads go before raft. With a data directory it then waits
        out an in-flight snapshot writer, flushes the WAL's fsync-pending
        bytes, closes the log and saves the cost model; a failure there
        raises once the rest of the teardown is done."""
        self._shutdown_ev.set()
        if self.follower_sched is not None:
            self.follower_sched.stop()
        self.eval_leases.stop()
        # the samplers first: nothing they read may be torn down under
        # a sample in flight
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.governor is not None:
            self.governor.stop()
        # detach the flight recorder from this server's governor — but
        # only if a newer server hasn't already rebound the hooks (the
        # recorder is process-wide; holding our closures past shutdown
        # would keep the dead governor graph reachable)
        if self._tracer_fns is not None:
            if self.tracer.threshold_fn is self._tracer_fns[0]:
                self.tracer.threshold_fn = None
            if self.tracer.gauge_fn is self._tracer_fns[1]:
                self.tracer.gauge_fn = None
        # the sink writers commit their last progress on the way out,
        # through raft while it still runs
        self.event_sinks.set_enabled(False)
        self.event_sinks.join(JOIN_S)
        self._stop_replication(timeout_s=JOIN_S)
        # raft first: a SWIM tick blocked on a membership write (a
        # removal awaiting quorum) then fails fast as refused
        if self.raft is not None:
            self.raft.stop()
        if self.swim is not None:
            self.swim.stop()
        self._leader = False
        self.deployments_watcher.set_enabled(False)
        self.node_drainer.set_enabled(False)
        self.periodic.stop()
        for w in self.workers:
            w.request_stop()
        for w in self.workers:
            w.stop()
        self.plan_applier.stop()
        if self.ingest is not None:
            self.ingest.stop()
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)
        for timers in self._retired_heartbeats + [self._heartbeats]:
            timers.stop(JOIN_S)
        self._retired_heartbeats = []
        for t in self._threads + [
                self.deployments_watcher._thread,
                self.node_drainer._thread, self.periodic._thread]:
            if t is not None and t is not threading.current_thread():
                t.join(timeout=JOIN_S)
        self._threads = []
        if self.persistence is not None:
            # after the applier and workers stopped: nothing appends
            # to the log any more, and the cost model holds every sample
            self.persistence.wait_idle()
            try:
                self.persistence.commit_barrier()
            finally:
                self.persistence.log.close()
            self.persistence.save_cost_model()

    def establish_leadership(self) -> None:
        """leader.go establishLeadership:222."""
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.plan_queue.set_enabled(True)
        self._leader = True
        self._restore_evals()
        # restored nodes need TTL timers or a dead node stays ready
        # forever (heartbeat.go initializeHeartbeatTimers)
        for node in self.store.nodes():
            if not node.terminal_status():
                self.reset_heartbeat_timer(node.id)
        # leader.go restorePeriodicDispatcher:222 — re-track periodic jobs
        self.periodic.set_enabled(True)
        for job in self.store.jobs():
            if job.is_periodic():
                self.periodic.add(job)
        self.deployments_watcher.set_enabled(True)
        self.node_drainer.set_enabled(True)
        # durable event sinks are a leader duty: writers resume from
        # each sink's raft-committed progress (event_sink_manager.go)
        self.event_sinks.set_enabled(True)
        # non-authoritative regions replicate ACL policies, global
        # tokens, and namespaces from the authoritative region
        # (leader.go:327-331)
        if self.config.authoritative_region and \
                self.config.authoritative_region != self.config.region:
            from .replication import ReplicationManager
            self._replication = ReplicationManager(self)
            self._replication.start()
        if self.raft is not None:
            # seed the replicated member set from static boot config on
            # first leadership (later joins/leaves mutate it), then run
            # the autopilot reaper. Threaded: establish_leadership runs
            # under the raft lock (same reason the election no-op is)
            def _seed():
                try:
                    if not self.store.server_members():
                        self.raft_apply(
                            "server_membership",
                            dict(members=[self.raft.self_addr]
                                 + list(self.raft.peers)))
                except Exception:
                    LOG.exception("membership seed failed")
            threading.Thread(target=_seed, daemon=True,
                             name="member-seed").start()
            # always spawned: the loop idles when the threshold is 0,
            # so the cleanup can be enabled on a live leader
            t = threading.Thread(target=self._autopilot_loop,
                                 daemon=True, name="autopilot")
            self._threads.append(t)
            t.start()

    def revoke_leadership(self) -> None:
        """leader.go revokeLeadership:1038 — disable leader-only
        services; workers stay up, parked on the disabled broker. The
        heartbeat timers' thread stops (without waiting: this runs
        under the raft lock, which an expiring node's status write
        needs) and a fresh, unstarted set takes its place, so a
        re-elected leader runs exactly one timers thread again."""
        self._leader = False
        self._stop_replication(timeout_s=0)
        # remote-dequeue leases are leader state: the broker flush
        # below cancels every unack they covered, and the NEW leader
        # re-enqueues non-terminal evals from the store — stale leases
        # here would only nack evals we no longer own
        self.eval_leases.flush()
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_queue.set_enabled(False)
        self.periodic.set_enabled(False)
        self.deployments_watcher.set_enabled(False)
        self.node_drainer.set_enabled(False)
        self.event_sinks.set_enabled(False)
        old = self._heartbeats
        self._heartbeats = HeartbeatTimers(self.config.heartbeat_ttl_s,
                                           self._invalidate_heartbeat)
        old.stop(timeout_s=0)
        self._retired_heartbeats.append(old)

    def _stop_replication(self, timeout_s: float) -> None:
        """Stop the replication threads and keep them until shutdown
        joins them (revoke runs under the raft lock: no wait there)."""
        rep = self._replication
        self._replication = None
        if rep is not None:
            rep.stop()
            self._retired_replication.append(rep)
        if timeout_s > 0:
            for r in self._retired_replication:
                r.join(timeout_s)
            self._retired_replication = []

    def scheduler_plane_status(self) -> dict:
        """Per-member scheduler-plane status (`nomad server members`):
        raft role + applied index per member, fence lag (the leader's
        last log index minus the member's applied index — exactly the
        gap a follower's snapshot fence would wait out), leased evals
        per follower from the leader's lease table, and this server's
        own plane counters."""
        raft = self.raft
        status = {
            "enabled": bool(self.config.follower_sched),
            "leases": self.eval_leases.snapshot_stats(),
            "follower": (self.follower_sched.snapshot_stats()
                         if self.follower_sched is not None else None),
            "members": [],
        }
        if raft is None:
            return status
        leased = self.eval_leases.by_follower()
        rows = {raft.self_addr: raft._handle_status({})}
        from ..rpc.client import RpcClient
        for addr in (self.store.server_members() or []):
            if addr in rows:
                continue
            try:
                c = RpcClient(addr, dial_timeout_s=0.5)
                try:
                    rows[addr] = c.call("Raft.Status", {}, timeout_s=1.0)
                finally:
                    c.close()
            except Exception:
                rows[addr] = None
        leader_last = 0
        for st in rows.values():
            if st and st.get("role") == "leader":
                leader_last = int(st.get("last_log_index") or 0)
        for addr in sorted(rows):
            st = rows[addr]
            if st is None:
                status["members"].append(
                    {"addr": addr, "role": "unreachable",
                     "applied_index": None, "fence_lag": None,
                     "leased_evals": leased.get(addr, 0)})
                continue
            applied = int(st.get("applied_index") or 0)
            status["members"].append(
                {"addr": addr, "role": st.get("role"),
                 "applied_index": applied,
                 "fence_lag": (max(0, leader_last - applied)
                               if leader_last else 0),
                 "leased_evals": leased.get(addr, 0)})
        return status

    def apply_replicated(self, index: int, msg_type: str,
                         enc_payload: dict) -> None:
        """Apply a COMMITTED log entry — leaders and followers share
        this path (raft.py _fsm_loop calls it in log order once the
        commit index covers the entry, so the WAL records entries in
        index order, as raft_apply does in dev mode). Nested raft_apply
        calls from FSM side effects append their own log entries on the
        leader and are suppressed on followers — either way the effect
        arrives as its own committed entry, so replicas converge.
        Change events publish here, i.e. only for committed writes."""
        from .persistence import decode_payload
        payload = decode_payload(msg_type, enc_payload)
        tl = self._apply_tl
        with self._raft_l:
            if index <= self._raft_index:
                return              # duplicate delivery (batch overlap)
            tl.in_fsm_apply = True
            try:
                self._raft_index = index
                if self.persistence is not None:
                    self.persistence.record(index, msg_type, payload)
                fn = getattr(self, f"_apply_{msg_type}")
                fn(index, payload)
                self.time_table.witness(index)
                if self.persistence is not None:
                    self.persistence.maybe_snapshot(self.store)
            finally:
                tl.in_fsm_apply = False
            try:
                self.events.publish(events_from_apply(msg_type, payload,
                                                      index))
            except Exception:
                LOG.exception("event publish for %s", msg_type)

    def install_snapshot(self, data: dict,
                         base_index: Optional[int] = None) -> None:
        """Full-state reseed from the leader (fsm.go Restore:1374). The
        snapshot's raft base index is authoritative for the applied
        index: store.latest_index() undercounts whenever the tail holds
        entries that touch no table (election no-ops), and an applied
        index below the log base would let this node reissue
        already-used log indexes after winning an election.

        The restore replaces the store's resident node table cache
        (with its device mirror) wholesale, so no row from before the
        snapshot is served; the new table is primed at the restored
        index and its mirror uploaded to this server's device before
        the lock is released, as the restore at construction does, so
        the next eval takes the delta path instead of a full build."""
        with self._raft_l:
            self.store.restore(data)
            floor = self.store.latest_index() if base_index is None \
                else base_index
            self._raft_index = max(floor, self.store.latest_index())
            self.store.table_cache.prime(self.store.snapshot(),
                                         self.store.pop_cold_columns())
            self.store.table_cache.prefetch_device(self.device)
            # snapshot-covered indexes were never published as events
            # on this node: raise the sink gap floor accordingly
            self.events.epoch_floor = max(self.events.epoch_floor,
                                          self._raft_index)
            if self.persistence is not None:
                self.persistence.snapshot(self.store)
        # adopt the snapshot's replicated membership
        if self.raft is not None:
            members = self.store.server_members()
            if members:
                self.raft.update_members(members)

    def _reap_failed_evals(self) -> None:
        """Drain the broker's failed queue: mark the eval failed and
        create a delayed failed-follow-up so the work retries after the
        storm passes (leader.go reapFailedEvaluations:766); and every
        `failed_eval_unblock_delay_s` requeue the evals blocked because
        plan conflicts exhausted their scheduler's attempts, which
        nothing else wakes while the cluster's capacity stands still
        (leader.go periodicUnblockFailedEvals). Runs from start() to
        shutdown and idles while this server is not the leader, so a
        server that wins an election later reaps too."""
        next_unblock = time.monotonic()
        while not self._shutdown_ev.is_set():
            if not self._leader:
                self._shutdown_ev.wait(0.5)
                continue
            if time.monotonic() >= next_unblock:
                next_unblock = time.monotonic() + \
                    self.config.failed_eval_unblock_delay_s
                try:
                    self.blocked_evals.unblock_failed()
                except RuntimeError as e:   # leadership moved mid-write
                    LOG.warning("failed-eval unblock: %s", e)
            ev, token = self.eval_broker.dequeue([FAILED_QUEUE],
                                                 timeout_s=0.5)
            if ev is None:
                continue
            if ev.type == JOB_TYPE_CORE:
                # core evals are in-memory only — drop, never persist;
                # the GC ticker will enqueue a fresh one next interval
                self.eval_broker.ack(ev.id, token)
                continue
            failed = ev.copy()
            failed.status = EVAL_STATUS_FAILED
            follow_up = ev.create_failed_follow_up_eval(
                self.config.failed_eval_unblock_delay_s)
            failed.next_eval = follow_up.id
            try:
                self.raft_apply("eval_update",
                                dict(evals=[failed, follow_up]))
                self.eval_broker.ack(ev.id, token)
            except Exception:
                LOG.exception("failed-eval reap for %s", ev.id)

    def _schedule_periodic_gc(self) -> None:
        """leader.go schedulePeriodic:689 — enqueue `_core` GC evals on a
        ticker. These evals are in-memory only (never raft-applied).
        Idles while this server is not the leader, like the reaper."""
        last = time.monotonic()
        while not self._shutdown_ev.wait(
                min(self.config.gc_interval_s / 4.0, 0.5)):
            if not self._leader:
                last = time.monotonic()
                continue
            if time.monotonic() - last < self.config.gc_interval_s:
                continue
            last = time.monotonic()
            for core_job in (CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC,
                             CORE_JOB_NODE_GC, CORE_JOB_DEPLOYMENT_GC):
                self.eval_broker.enqueue(self._core_eval(core_job))

    def _core_eval(self, core_job: str) -> Evaluation:
        return Evaluation(
            priority=CORE_JOB_PRIORITY, type=JOB_TYPE_CORE,
            triggered_by=TRIGGER_SCHEDULED, job_id=core_job,
            status=EVAL_STATUS_PENDING,
            modify_index=self._raft_index)

    def force_gc(self) -> None:
        """`nomad system gc` (system_endpoint.go): a forced full GC pass."""
        self.eval_broker.enqueue(self._core_eval(CORE_JOB_FORCE_GC))

    def _restore_evals(self) -> None:
        """Re-enqueue non-terminal evals after leadership (leader.go:496)."""
        for ev in self.store.evals():
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    # -- WAL replay (cold start) ----------------------------------------
    # entry types whose replay batches through the store's bulk paths;
    # a batch flushes when the incoming entry shares a (namespace, job)
    # with one already pending, so the grouped transaction is EXACTLY
    # state-equivalent to sequential per-entry replay (the per-entry
    # side-effect loops only ever read/write their own job's rows)
    _REPLAY_BATCH_TYPES = ("eval_update", "alloc_client_update")

    def _replay_entries(self, entries, highest: int,
                        batch: bool = True) -> int:
        """Replay the WAL tail into the FSM. Event publication is
        suppressed throughout (replay is not new history — the epoch
        floor is raised after), and with `batch` runs of eval and
        alloc-update entries group into single store transactions
        (`batch=False` replays entry by entry, for bisection)."""
        from ..utils import stages
        t0 = time.perf_counter() if stages.enabled else 0.0
        pending: List = []          # one same-type run
        pending_jobs: set = set()
        applied = 0

        def job_keys(msg_type: str, p: dict) -> set:
            keys = {(e.namespace, e.job_id) for e in p.get("evals", [])}
            if msg_type == "alloc_client_update":
                keys |= {(a.namespace, a.job_id)
                         for a in p.get("allocs", [])}
            return keys

        def flush() -> None:
            if not pending:
                return
            if len(pending) == 1:
                self._replay_one(*pending[0])
            else:
                try:
                    if pending[0][1] == "eval_update":
                        self._replay_eval_updates(pending)
                    else:
                        self._replay_alloc_client_updates(pending)
                    for index, _mt, _p, ts in pending:
                        self._raft_index = max(self._raft_index, index)
                        if ts:
                            self.time_table.witness(index, ts)
                except Exception:
                    LOG.exception("batched WAL replay failed "
                                  "(%d %s entries)", len(pending),
                                  pending[0][1])
            pending.clear()
            pending_jobs.clear()

        for index, msg_type, payload, ts in entries:
            if index <= highest:
                continue
            applied += 1
            if batch and msg_type in self._REPLAY_BATCH_TYPES:
                keys = job_keys(msg_type, payload)
                if pending and (pending[0][1] != msg_type
                                or keys & pending_jobs):
                    flush()
                pending.append((index, msg_type, payload, ts))
                pending_jobs.update(keys)
                continue
            flush()
            self._replay_one(index, msg_type, payload, ts)
        flush()
        if stages.enabled:
            stages.add("wal_replay", time.perf_counter() - t0)
        return applied

    def _replay_one(self, index: int, msg_type: str, payload: dict,
                    ts: float) -> None:
        try:
            getattr(self, f"_apply_{msg_type}")(index, payload)
            self._raft_index = max(self._raft_index, index)
            if ts:
                self.time_table.witness(index, ts)
        except Exception:
            LOG.exception("WAL replay failed at %d/%s", index, msg_type)

    def _replay_eval_updates(self, pending: List) -> None:
        """N job-disjoint eval_update entries as ONE store transaction;
        the per-eval side effects run per entry exactly as
        _apply_eval_update would (broker/blocked are disabled during
        replay, so enqueue is a no-op; reconcile writes are real)."""
        self.store.upsert_evals_batch(
            [(index, p["evals"]) for index, _mt, p, _ts in pending])
        for index, _mt, p, _ts in pending:
            for ev in p["evals"]:
                self.enqueue_eval(ev)
                if ev.job_id and ev.type != JOB_TYPE_CORE:
                    self.store.reconcile_job_status(index, ev.namespace,
                                                    ev.job_id)

    def _replay_alloc_client_updates(self, pending: List) -> None:
        """N job-disjoint alloc_client_update entries: one batched
        store transaction for the alloc merges, then each entry's
        unblock/eval/status side effects in order (job-disjointness
        makes this exactly sequential-equivalent)."""
        self.store.update_allocs_from_client_batch(
            [(index, p["allocs"]) for index, _mt, p, _ts in pending])
        for index, _mt, p, _ts in pending:
            for stub in p["allocs"]:
                alloc = self.store.alloc_by_id(stub.id)
                if alloc is None or not alloc.client_terminal_status():
                    continue
                node = self.store.node_by_id(alloc.node_id)
                if node is not None:
                    self.blocked_evals.unblock(node.computed_class,
                                               index)
            for ev in p.get("evals", []):
                self.store.upsert_evals(index, [ev])
                self.enqueue_eval(ev)
            self._reconcile_job_statuses(index,
                                         {"allocs_placed": p["allocs"]})

    # -- the FSM -------------------------------------------------------
    def raft_apply(self, msg_type: str, payload: dict) -> int:
        """Serialized FSM apply (fsm.go Apply:210-300). Returns the
        index. Dev mode (no raft): record, apply and snapshot run inline
        under the raft lock, so WAL order == apply order; WAL replay
        bypasses raft_apply, so a restore does not replay the event
        history. Clustered: the leader appends the entry to the
        replication log and blocks until a majority holds it AND the
        local FSM has applied it (apply-at-commit — hashicorp/raft runs
        the FSM only up to the commit index, nomad/server.go:1214);
        non-leaders forward the write to the leader (rpc.go
        forward())."""
        index, waiter = self.raft_apply_async(msg_type, payload)
        if waiter is not None:
            waiter()
        return index

    def raft_apply_async(self, msg_type: str, payload: dict):
        """The non-blocking half of raft_apply: log append now, commit
        + FSM apply deferred. Returns (index, waiter) where waiter is
        None (nested/forwarded/no-raft: nothing to wait for at this
        frame) or a callable that blocks until the entry is
        majority-replicated in the term it was stamped with and applied
        locally, raising otherwise (after `timeout_s`, 10 s unless the
        caller passes another; None waits while this node leads). The plan applier uses this to
        overlap plan N's replication with plan N+1's verification
        (plan_apply.go:44-70 pipelining). On a clustered leader NOTHING
        is applied at this point — a caller that needs to read its own
        write must invoke the waiter (raft_apply does); this is what
        closes the uncommitted-read window on a partitioned leader."""
        if self.raft is not None:
            if getattr(self._apply_tl, "in_fsm_apply", False):
                # nested FSM side effect during a committed apply: on
                # the leader it becomes its own log entry (applied when
                # it commits); on a follower the leader's equivalent
                # entry arrives via the log — suppress. Narrow window:
                # if leadership changes between an entry's commit and
                # its apply, NO node re-emits the nested write (every
                # replica applies it as a non-leader). The only such
                # write is the blocked-eval wake (_unblock_enqueue),
                # and the woken eval stays in state as blocked — the
                # new leader re-tracks it on establish_leadership, the
                # same stall-until-next-capacity-change the reference
                # accepts across failovers (blocked_evals.go:316).
                if self.raft.is_leader():
                    try:
                        idx, _term = self.raft.append_entry(
                            msg_type, payload)
                        return idx, None
                    except RuntimeError:
                        LOG.warning(
                            "nested %s write dropped: deposed during "
                            "FSM apply; state-derived recovery applies",
                            msg_type)
                        return self._raft_index, None
                return self._raft_index, None
            if not self.raft.is_leader():
                return self.raft.forward_apply(msg_type, payload), None
            # raises "not the leader" on a deposed leader — nothing
            # recorded, nothing applied
            index, term = self.raft.append_entry(msg_type, payload)
            raft = self.raft
            return index, lambda timeout_s=10.0: raft.wait_for_applied(
                index, term, timeout_s=timeout_s)
        with self._raft_l:
            index = self._raft_index + 1
            self._raft_index = index
            if self.persistence is not None:
                self.persistence.record(index, msg_type, payload)
            fn = getattr(self, f"_apply_{msg_type}")
            fn(index, payload)
            self.time_table.witness(index)
            if self.persistence is not None:
                # the entry IS the commit unit: the group-fsync barrier
                # sits right here
                self.persistence.commit_barrier()
                self.persistence.maybe_snapshot(self.store)
            try:
                self.events.publish(events_from_apply(
                    msg_type, payload, index))
            except Exception:
                LOG.exception("event publish for %s", msg_type)
        return index, None

    def _apply_noop(self, index: int, p: dict) -> None:
        """Leadership no-op (hashicorp/raft LogNoop): commits the new
        term without mutating state."""

    # -- FSM appliers --------------------------------------------------
    def _apply_job_register(self, index: int, p: dict) -> None:
        job: Job = p["job"]
        self.store.upsert_job(index, job)
        self.blocked_evals.untrack(job.namespace, job.id)
        self.store.reconcile_job_status(index, job.namespace, job.id)
        self.periodic.add(self.store.job_by_id(job.namespace, job.id) or job)
        for ev in p.get("evals", []):
            if not ev.job_modify_index:
                # ingest-embedded eval: the register and its eval share
                # one entry, so the fence is stamped at apply time —
                # deterministic on WAL replay too
                ev.job_modify_index = index
            self.store.upsert_evals(index, [ev])
            self.enqueue_eval(ev)

    def _apply_job_deregister(self, index: int, p: dict) -> None:
        namespace, job_id = p["namespace"], p["job_id"]
        if p.get("purge"):
            self.store.delete_job(index, namespace, job_id)
            self.periodic.remove(namespace, job_id)
        else:
            job = self.store.job_by_id(namespace, job_id)
            if job is not None:
                stopped = job.copy()
                stopped.stop = True
                self.store.upsert_job(index, stopped)
                self.store.reconcile_job_status(index, namespace, job_id)
                self.periodic.add(stopped)  # untracks a stopped periodic
        for ev in p.get("evals", []):
            self.store.upsert_evals(index, [ev])
            self.enqueue_eval(ev)

    def _apply_eval_update(self, index: int, p: dict) -> None:
        evals: List[Evaluation] = p["evals"]
        self.store.upsert_evals(index, evals)
        for ev in evals:
            self.enqueue_eval(ev)
            if ev.job_id and ev.type != JOB_TYPE_CORE:
                self.store.reconcile_job_status(index, ev.namespace,
                                                ev.job_id)

    def _apply_eval_delete(self, index: int, p: dict) -> None:
        self.store.delete_evals(index, p["eval_ids"], p.get("alloc_ids"))

    def _apply_node_register(self, index: int, p: dict) -> None:
        node: Node = p["node"]
        self.store.upsert_node(index, node)
        stored = self.store.node_by_id(node.id)
        if stored is not None and stored.ready():
            self.blocked_evals.unblock(stored.computed_class, index)

    def _apply_node_deregister(self, index: int, p: dict) -> None:
        self.store.delete_node(index, p["node_ids"])

    def _apply_node_status_update(self, index: int, p: dict) -> None:
        node_id, status = p["node_id"], p["status"]
        self.store.update_node_status(index, node_id, status,
                                      int(time.time()))
        node = self.store.node_by_id(node_id)
        if node is None:
            return
        if status == NODE_STATUS_READY:
            self.blocked_evals.unblock(node.computed_class, index)
        evals = p.get("evals", [])
        if evals:
            self.store.upsert_evals(index, evals)
            for ev in evals:
                self.enqueue_eval(ev)

    def _apply_node_eligibility_update(self, index: int, p: dict) -> None:
        self.store.update_node_eligibility(index, p["node_id"],
                                           p["eligibility"])
        node = self.store.node_by_id(p["node_id"])
        if node is not None and node.ready():
            self.blocked_evals.unblock(node.computed_class, index)

    def _apply_node_drain_update(self, index: int, p: dict) -> None:
        self.store.update_node_drain(index, p["node_id"],
                                     p["drain_strategy"],
                                     p.get("mark_eligible", False))

    def _apply_alloc_desired_transition(self, index: int, p: dict) -> None:
        self.store.update_alloc_desired_transitions(
            index, p["alloc_ids"], p["transition"], p.get("evals"))
        for ev in p.get("evals", []):
            self.enqueue_eval(ev)

    def _apply_alloc_client_update(self, index: int, p: dict) -> None:
        allocs: List[Allocation] = p["allocs"]
        self.store.update_allocs_from_client(index, allocs)
        # failed/stopped allocs free capacity -> unblock by node class
        for stub in allocs:
            alloc = self.store.alloc_by_id(stub.id)
            if alloc is None or not alloc.client_terminal_status():
                continue
            node = self.store.node_by_id(alloc.node_id)
            if node is not None:
                self.blocked_evals.unblock(node.computed_class, index)
        for ev in p.get("evals", []):
            self.store.upsert_evals(index, [ev])
            self.enqueue_eval(ev)
        self._reconcile_job_statuses(index, {"allocs_placed": allocs})

    def _apply_plan_results(self, index: int, p: dict) -> None:
        self.store.upsert_plan_results(
            index,
            allocs_stopped=p["allocs_stopped"],
            allocs_placed=p["allocs_placed"],
            allocs_preempted=p["allocs_preempted"],
            deployment=p.get("deployment"),
            deployment_updates=p.get("deployment_updates"),
            evals=p.get("evals"),
        )
        self._reconcile_job_statuses(index, p)

    def _apply_plan_group_results(self, index: int, p: dict) -> None:
        """One committed entry carrying a whole plan GROUP (the
        group-commit applier): N verified plans land as ONE state-store
        transaction — a single layer push instead of N — and publish
        their change events in one flush."""
        self.store.upsert_plan_group_results(index, p["groups"])
        for g in p["groups"]:
            self._reconcile_job_statuses(index, g)

    def _apply_ingest_batch(self, index: int, p: dict) -> None:
        """One committed entry carrying a whole ingest GROUP
        (server/ingest.py): coalesced registers / client alloc updates /
        desired transitions land in submission order, with each
        consecutive same-kind run collapsed to ONE store transaction
        (upsert_jobs_batch / update_allocs_from_client_batch). Per-kind
        side effects run per entry exactly as the singleton appliers
        would, so the final state is sequential-equivalent by
        construction."""
        entries = p["entries"]
        i = 0
        while i < len(entries):
            kind = entries[i]["kind"]
            j = i
            while j < len(entries) and entries[j]["kind"] == kind:
                j += 1
            run = entries[i:j]
            if kind == "job_register":
                self._ingest_apply_registers(index, run)
            elif kind == "alloc_client_update":
                self._ingest_apply_client_updates(index, run)
            else:
                for e in run:
                    self._apply_alloc_desired_transition(index, e)
            i = j

    def _ingest_apply_registers(self, index: int, run: List[dict]) -> None:
        # one store transaction for the run's jobs (in order, so a
        # same-job re-register in one batch still sees the version
        # bump), then the singleton applier's side-effect tail per job
        self.store.upsert_jobs_batch(index, [e["job"] for e in run])
        evals: List[Evaluation] = []
        for e in run:
            job: Job = e["job"]
            self.blocked_evals.untrack(job.namespace, job.id)
            self.store.reconcile_job_status(index, job.namespace, job.id)
            self.periodic.add(
                self.store.job_by_id(job.namespace, job.id) or job)
            for ev in e.get("evals", []):
                if not ev.job_modify_index:
                    ev.job_modify_index = index
                evals.append(ev)
        if evals:
            self.store.upsert_evals_batch([(index, evals)])
            for ev in evals:
                self.enqueue_eval(ev)

    def _ingest_apply_client_updates(self, index: int,
                                     run: List[dict]) -> None:
        # the WAL-replay batch promoted to the live path: one store
        # transaction for the alloc merges, then each entry's
        # unblock/eval/status side effects in submission order
        self.store.update_allocs_from_client_batch(
            [(index, e["allocs"]) for e in run])
        for e in run:
            for stub in e["allocs"]:
                alloc = self.store.alloc_by_id(stub.id)
                if alloc is None or not alloc.client_terminal_status():
                    continue
                node = self.store.node_by_id(alloc.node_id)
                if node is not None:
                    self.blocked_evals.unblock(node.computed_class,
                                               index)
            for ev in e.get("evals", []):
                self.store.upsert_evals(index, [ev])
                self.enqueue_eval(ev)
            self._reconcile_job_statuses(index,
                                         {"allocs_placed": e["allocs"]})

    def _apply_scheduler_config(self, index: int, p: dict) -> None:
        self.store.set_scheduler_config(index, p["config"])

    # ACL appliers (fsm.go applyACL*): the records only, no resolution
    def _apply_acl_policy_upsert(self, index: int, p: dict) -> None:
        self.store.upsert_acl_policies(index, p["policies"])

    def _apply_acl_policy_delete(self, index: int, p: dict) -> None:
        self.store.delete_acl_policies(index, p["names"])

    def _apply_acl_token_upsert(self, index: int, p: dict) -> None:
        self.store.upsert_acl_tokens(index, p["tokens"])

    def _apply_acl_token_delete(self, index: int, p: dict) -> None:
        self.store.delete_acl_tokens(index, p["accessor_ids"])

    # namespace appliers (fsm.go applyNamespace*)
    def _apply_namespace_upsert(self, index: int, p: dict) -> None:
        self.store.upsert_namespaces(index, p["namespaces"])

    def _apply_namespace_delete(self, index: int, p: dict) -> None:
        self.store.delete_namespaces(index, p["names"])

    # service registry appliers (built-in catalog; the reference sends
    # these to Consul, command/agent/consul/service_client.go)
    def _apply_service_registration_upsert(self, index: int,
                                           p: dict) -> None:
        self.store.upsert_service_registrations(index, p["services"])

    def _apply_service_registration_delete(self, index: int,
                                           p: dict) -> None:
        self.store.delete_service_registrations(
            index, ids=p.get("ids"), alloc_ids=p.get("alloc_ids"))

    # CSI volume appliers (fsm.go applyCSIVolume*)
    def _apply_csi_volume_register(self, index: int, p: dict) -> None:
        self.store.upsert_csi_volumes(index, p["volumes"])

    def _apply_csi_volume_deregister(self, index: int, p: dict) -> None:
        self.store.delete_csi_volume(index, p["namespace"], p["volume_id"])

    def _apply_csi_volume_claim(self, index: int, p: dict) -> None:
        self.store.csi_volume_claim(index, p["namespace"], p["volume_id"],
                                    p["alloc_id"], p["node_id"],
                                    p["read_only"])

    def _apply_csi_volume_release(self, index: int, p: dict) -> None:
        self.store.csi_volume_release(index, p["namespace"],
                                      p["volume_id"], p["alloc_id"])

    def _apply_vault_accessor_upsert(self, index: int, p: dict) -> None:
        from ..server.vault import VaultAccessor
        from ..utils.codec import from_wire
        self.store.upsert_vault_accessors(
            index, [from_wire(VaultAccessor, w) for w in p["accessors"]])

    def _apply_vault_accessor_renew(self, index: int, p: dict) -> None:
        a = self.store.vault_accessor(p["accessor"])
        if a is not None:
            from dataclasses import replace
            self.store.upsert_vault_accessors(
                index, [replace(a, expire_time=p["expire_time"])])

    def _apply_vault_accessor_delete(self, index: int, p: dict) -> None:
        self.store.delete_vault_accessors(index, list(p["accessors"]))

    def _apply_periodic_launch(self, index: int, p: dict) -> None:
        self.store.upsert_periodic_launch(index, p["namespace"],
                                          p["job_id"], p["launch_time"])

    def _apply_deployment_delete(self, index: int, p: dict) -> None:
        self.store.delete_deployments(index, p["deployment_ids"])

    def _apply_deployment_status_update(self, index: int, p: dict) -> None:
        self.store.update_deployment_status(
            index, p["update"], p.get("job"), p.get("evals"))
        st = p.get("stability")
        if st:
            # same raft entry as the status change: success + stable marker
            # commit or replay together
            self.store.update_job_stability(
                index, st["namespace"], st["job_id"], st["version"],
                st["stable"])
        for ev in p.get("evals", []):
            self.enqueue_eval(ev)

    def _apply_deployment_promotion(self, index: int, p: dict) -> None:
        self.store.update_deployment_promotion(
            index, p["deployment_id"], p.get("groups"), p.get("evals"))
        for ev in p.get("evals", []):
            self.enqueue_eval(ev)

    def _apply_job_stability(self, index: int, p: dict) -> None:
        self.store.update_job_stability(
            index, p["namespace"], p["job_id"], p["version"], p["stable"])

    def upsert_event_sink(self, sink) -> int:
        return self.raft_apply("event_sink_upsert", dict(sink=sink))

    def delete_event_sink(self, sink_id: str) -> int:
        return self.raft_apply("event_sink_delete", dict(sink_id=sink_id))

    def _apply_event_sink_upsert(self, index: int, p: dict) -> None:
        self.store.upsert_event_sink(index, p["sink"])

    def _apply_event_sink_delete(self, index: int, p: dict) -> None:
        self.store.delete_event_sink(index, p["sink_id"])

    def _apply_event_sink_progress(self, index: int, p: dict) -> None:
        self.store.update_event_sink_progress(index, p["sink_id"],
                                              int(p["index"]))

    def _apply_scaling_event(self, index: int, p: dict) -> None:
        self.store.add_scaling_event(index, p["namespace"], p["job_id"],
                                     p["event"])

    def _reconcile_job_statuses(self, index: int, p: dict) -> None:
        """Derive job status from alloc states (fsm setJobStatus analog)."""
        seen = set()
        for stub in (p.get("allocs_placed", []) + p.get("allocs_stopped", [])
                     + p.get("allocs_preempted", [])):
            a = self.store.alloc_by_id(stub.id) or stub
            key = (a.namespace, a.job_id)
            if key in seen or not key[1]:
                continue
            seen.add(key)
            self.store.reconcile_job_status(index, *key)

    # -- eval routing --------------------------------------------------
    def enqueue_eval(self, ev: Evaluation) -> None:
        if ev.should_enqueue():
            self.eval_broker.enqueue(ev)
        elif ev.should_block():
            self.blocked_evals.block(ev)

    def _unblock_enqueue(self, ev: Evaluation) -> None:
        """Blocked eval woken: back to pending + broker."""
        woke = ev.copy()
        woke.status = EVAL_STATUS_PENDING
        self.raft_apply("eval_update", dict(evals=[woke]))

    # -- north-bound API (the RPC endpoint surface) --------------------
    def register_job(self, job: Job,
                     triggered_by: str = TRIGGER_JOB_REGISTER,
                     enforce_index: bool = False,
                     job_modify_index: int = 0
                     ) -> Optional[Evaluation]:
        """Job.Register (nomad/job_endpoint.go:79): the admission
        pipeline — canonicalize, implied constraints, validate — then
        upsert and create an eval. Periodic and parameterized jobs
        get no eval — the dispatcher / Job.Dispatch creates child jobs
        which do (job_endpoint.go:236-247). With `enforce_index`, the
        register is a compare-and-set against the job's current modify
        index (`job run -check-index`; job_endpoint.go:175
        RegisterEnforceIndexErrPrefix): 0 means "must not exist"."""
        if enforce_index:
            # check-and-apply must be atomic w.r.t. sibling enforced
            # registrations (two threads both reading index 7 and both
            # winning would be the lost update CAS exists to stop)
            with self._register_l:
                current = self.store.job_by_id(job.namespace, job.id)
                cur_idx = current.job_modify_index \
                    if current is not None else 0
                if current is None and job_modify_index != 0:
                    raise ValueError(
                        "Enforcing job modify index "
                        f"{job_modify_index}: job does not exist")
                if current is not None and \
                        job_modify_index != cur_idx:
                    raise ValueError(
                        "Enforcing job modify index "
                        f"{job_modify_index}: job exists with "
                        f"conflicting job modify index: {cur_idx}")
                return self._register_job_validated(job, triggered_by)
        return self._register_job_validated(job, triggered_by)

    def _register_job_validated(self, job: Job,
                                triggered_by: str
                                ) -> Optional[Evaluation]:
        job.canonicalize()
        # multiregion fan-out (job_endpoint.go:328 multiregionRegister
        # — enterprise in the reference, implemented here over the
        # federation peers): an unpinned multiregion job localizes one
        # copy per region entry; copies are region-pinned so they never
        # re-fan when they arrive at the peer
        if job.multiregion is not None and \
                job.region in ("", "global"):
            return self._multiregion_register(job, triggered_by)
        self._validate_register(job)
        return self._commit_register(job, triggered_by)

    def _validate_register(self, job: Job) -> None:
        """Post-canonicalize admission checks for one register —
        namespace existence, connect/expose hooks, implied constraints,
        spec validation. Raises ValueError."""
        # the requested namespace must exist (job_endpoint.go Register:
        # "non-existent namespace"); "default" exists implicitly
        if self.store.namespace_by_name(job.namespace) is None:
            raise ValueError(
                f"job {job.id!r} is in nonexistent namespace "
                f"{job.namespace!r}")
        # connect + expose-check hooks (job_endpoint_hook_connect.go,
        # job_endpoint_hook_expose_check.go): inject sidecar/gateway
        # proxy tasks and check expose paths before implied
        # constraints and validation
        from .connect_hook import (connect_mutate, connect_validate,
                                   expose_check_mutate,
                                   expose_check_validate)
        connect_mutate(job, self.config.connect_sidecar_driver,
                       self.config.connect_sidecar_config)
        errs = expose_check_validate(job)
        if not errs:
            expose_check_mutate(job)
        self._implied_constraints(job)
        errs = errs + connect_validate(job) + job.validate()
        if errs:
            raise ValueError("; ".join(errs))

    def _commit_register(self, job: Job,
                         triggered_by: str) -> Optional[Evaluation]:
        """Land one fully validated register. Through the ingest
        gateway the job and its eval ride ONE coalesced entry — the
        eval's job-modify fence is stamped at apply time so
        WAL replay stays deterministic; without a gateway the unchanged
        two-entry path runs."""
        ev = None
        if not (job.is_periodic() or job.is_parameterized()):
            ev = Evaluation(
                namespace=job.namespace, priority=job.priority,
                type=job.type, triggered_by=triggered_by, job_id=job.id,
                status=EVAL_STATUS_PENDING)
        if self.ingest is not None:
            index = self.ingest.submit(
                "job_register",
                dict(job=job, evals=[ev] if ev is not None else []))
            if ev is None:
                return None
            ev.job_modify_index = index
            ev.modify_index = index
            return ev
        index = self.raft_apply("job_register", dict(job=job, evals=[]))
        if ev is None:
            return None
        ev.job_modify_index = index
        ev.modify_index = index
        self.raft_apply("eval_update", dict(evals=[ev]))
        return ev

    def register_jobs_bulk(self, jobs: List[Job],
                           triggered_by: str = TRIGGER_JOB_REGISTER
                           ) -> List:
        """Array-body bulk register (`PUT /v1/jobs` with a list):
        validate each job in the caller's thread, park every
        admitted one on the gateway, then gather — one raft entry /
        store transaction for the whole admitted run. Returns one
        result PER INPUT in order: an Evaluation (or None for
        periodic/parameterized jobs) on success, the Exception
        otherwise — a validation failure fails ONLY its own slot, a
        batch-commit failure fails every parked slot."""
        if self.ingest is None:
            out = []
            for job in jobs:
                try:
                    out.append(self.register_job(job, triggered_by))
                except Exception as e:
                    out.append(e)
            return out
        slots = []              # (future | None, ev | result, err | None)
        for job in jobs:
            try:
                job.canonicalize()
                if job.multiregion is not None and \
                        job.region in ("", "global"):
                    # multiregion fans out over federation peers —
                    # inherently per-job, never coalesced
                    slots.append((None, self._multiregion_register(
                        job, triggered_by), None))
                    continue
                self._validate_register(job)
                ev = None
                if not (job.is_periodic() or job.is_parameterized()):
                    ev = Evaluation(
                        namespace=job.namespace, priority=job.priority,
                        type=job.type, triggered_by=triggered_by,
                        job_id=job.id, status=EVAL_STATUS_PENDING)
                fut = self.ingest.submit_async(
                    "job_register",
                    dict(job=job, evals=[ev] if ev is not None else []))
                slots.append((fut, ev, None))
            except Exception as e:
                slots.append((None, None, e))
        out = []
        for fut, ev, err in slots:
            if err is not None:
                out.append(err)
                continue
            if fut is None:
                out.append(ev)      # multiregion result, already final
                continue
            try:
                index = fut.result()
                if ev is not None:
                    ev.job_modify_index = index
                    ev.modify_index = index
                out.append(ev)
            except Exception as e:
                out.append(e)
        return out

    def deregister_job_global(self, namespace: str, job_id: str,
                              purge: bool = False):
        """Multiregion stop (job_endpoint_oss.go multiregionStop):
        fan the deregister to every region in the stored job's
        multiregion block, then stop locally."""
        job = self.store.job_by_id(namespace, job_id)
        failed = []
        if job is not None and job.multiregion is not None:
            for entry in job.multiregion.regions:
                if entry.name == self.config.region:
                    continue
                peer = self.config.region_peers.get(entry.name)
                if not peer:
                    failed.append(f"{entry.name} (no federation peer)")
                    continue
                req = urllib.request.Request(
                    f"http://{peer}/v1/job/{job_id}?region={entry.name}"
                    f"&purge={str(purge).lower()}"
                    f"&namespace={namespace}",
                    method="DELETE")
                if self.config.replication_token:
                    req.add_header("X-Nomad-Token",
                                   self.config.replication_token)
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        r.read()
                except Exception as e:
                    LOG.exception("multiregion stop in %s failed",
                                  entry.name)
                    failed.append(f"{entry.name} ({e})")
        ev = self.deregister_job(namespace, job_id, purge=purge)
        if failed:
            # the local stop stuck, but the operator must hear that
            # other regions did NOT stop
            raise RuntimeError(
                f"job stopped in {self.config.region!r} but deregister "
                f"failed in: {', '.join(failed)}")
        return ev

    def _multiregion_register(self, job: Job, triggered_by: str):
        """Localize one copy per multiregion region entry and land it
        in that region: the local region registers directly, remote
        regions get an HTTP push through their federation peer. Region
        entries override datacenters, fill zero group counts, and merge
        meta (the documented enterprise semantics). Cross-region
        deployment pacing (max_parallel/on_failure) is not enforced —
        regions roll independently."""
        import copy
        errs = job.validate()
        if errs:
            raise ValueError("; ".join(errs))
        mr = job.multiregion
        missing = [r.name for r in mr.regions
                   if r.name != self.config.region
                   and r.name not in self.config.region_peers]
        if missing:
            raise ValueError(
                f"no federation peer for multiregion regions {missing}")
        local_eval = None
        for entry in mr.regions:
            local = copy.deepcopy(job)
            local.region = entry.name
            if entry.datacenters:
                local.datacenters = list(entry.datacenters)
            if entry.meta:
                local.meta = {**local.meta, **entry.meta}
            if entry.count > 0:
                for tg in local.task_groups:
                    if tg.count == 0:
                        tg.count = entry.count
            if entry.name == self.config.region:
                local_eval = self.register_job(local, triggered_by)
            else:
                self._push_job_to_region(entry.name, local)
        return local_eval

    def _push_job_to_region(self, region: str, job: Job) -> None:
        from ..utils.codec import to_wire
        peer = self.config.region_peers[region]
        body = json.dumps({"Job": to_wire(job)}).encode()
        headers = {"Content-Type": "application/json"}
        if self.config.replication_token:
            headers["X-Nomad-Token"] = self.config.replication_token
        req = urllib.request.Request(
            f"http://{peer}/v1/jobs?region={region}", data=body,
            method="PUT", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:
                msg = str(e)
            raise ValueError(f"multiregion register in {region!r} "
                             f"failed: {msg}")
        except urllib.error.URLError as e:
            raise RuntimeError(f"multiregion register: no route to "
                               f"region {region!r}: {e.reason}")

    def evaluate_job(self, namespace: str, job_id: str) -> Evaluation:
        """Force a fresh evaluation of a job (job_endpoint.go
        Evaluate) — `nomad job eval`."""
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id} not found")
        ev = Evaluation(
            namespace=namespace, priority=job.priority, type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=job_id,
            status=EVAL_STATUS_PENDING)
        self.raft_apply("eval_update", dict(evals=[ev]))
        return ev

    def stop_alloc(self, alloc_id: str) -> Evaluation:
        """Stop one allocation and evaluate its job for a replacement
        (alloc_endpoint.go Stop: a desired transition plus an eval)."""
        from ..models.alloc import DesiredTransition
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id[:8]} not found")
        job = alloc.job or self.store.job_by_id(alloc.namespace,
                                                alloc.job_id)
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else "service",
            triggered_by="alloc-stop", job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING)
        payload = dict(alloc_ids=[alloc_id],
                       transition=DesiredTransition(migrate=True),
                       evals=[ev])
        if self.ingest is not None:
            self.ingest.submit("alloc_desired_transition", payload)
        else:
            self.raft_apply("alloc_desired_transition", payload)
        return ev

    def dispatch_job(self, namespace: str, job_id: str,
                     payload: bytes = b"",
                     meta: Optional[Dict[str, str]] = None) -> Evaluation:
        """Job.Dispatch (nomad/job_endpoint.go Dispatch): instantiate a
        parameterized job as a one-shot child with the given payload and
        meta. Child ID is `<parent>/dispatch-<unix>-<rand>`."""
        import os
        meta = dict(meta or {})
        parent = self.store.job_by_id(namespace, job_id)
        if parent is None:
            raise KeyError(f"job {job_id} not found")
        if not parent.is_parameterized():
            raise ValueError(f"job {job_id} is not parameterized")
        if parent.stopped():
            raise ValueError(f"job {job_id} is stopped")
        cfg = parent.parameterized_job
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload forbidden by the parameterized job")
        if cfg.payload == "required" and not payload:
            raise ValueError("payload required by the parameterized job")
        if len(payload) > 16 * 1024:
            raise ValueError("payload exceeds the 16KiB maximum")
        required = set(cfg.meta_required)
        allowed = required | set(cfg.meta_optional)
        missing = required - set(meta)
        if missing:
            raise ValueError(f"missing required meta keys: {sorted(missing)}")
        unexpected = set(meta) - allowed
        if unexpected:
            raise ValueError(f"unpermitted meta keys: {sorted(unexpected)}")

        child = parent.copy()
        child.id = (f"{parent.id}/dispatch-{int(time.time())}-"
                    f"{os.urandom(4).hex()}")
        child.parent_id = parent.id
        child.dispatched = True
        child.payload = payload
        child.meta = {**parent.meta, **meta}
        child.status = ""
        child.stable = False
        child.version = 0
        ev = self.register_job(child)
        assert ev is not None
        return ev

    def deregister_job(self, namespace: str, job_id: str,
                       purge: bool = False) -> Evaluation:
        job = self.store.job_by_id(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by=TRIGGER_JOB_DEREGISTER, job_id=job_id,
            status=EVAL_STATUS_PENDING)
        self.raft_apply("job_deregister",
                        dict(namespace=namespace, job_id=job_id, purge=purge,
                             evals=[ev]))
        return ev

    def plan_job(self, job: Job, diff: bool = True) -> dict:
        """Job.Plan (nomad/job_endpoint.go Plan:600): dry-run the
        scheduler against a copy of current state on this server's
        device; nothing is committed. Returns the annotated plan, failed
        placements, and the job diff."""
        from ..models.diff import job_diff
        from ..scheduler.harness import Harness
        job = job.copy()
        job.canonicalize()
        errs = job.validate()
        if errs:
            raise ValueError("; ".join(errs))
        old_job = self.store.job_by_id(job.namespace, job.id)

        shadow = StateStore()
        shadow.restore(self.store.dump())
        h = Harness(shadow, device=self.device)
        index = self.store.latest_index() + 1
        shadow.upsert_job(index, job)
        ev = Evaluation(
            namespace=job.namespace, priority=job.priority, type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
            status=EVAL_STATUS_PENDING, annotate_plan=True)
        ev.job_modify_index = index
        h.process(job.type if job.type in self.config.enabled_schedulers
                  else JOB_TYPE_SERVICE, ev)
        plan = h.plans[-1] if h.plans else None
        from ..utils.codec import to_wire
        annotations = (to_wire(plan.annotations)
                       if plan is not None and plan.annotations else None)
        final_eval = h.evals[-1] if h.evals else ev
        the_diff = None
        if diff:
            # the diff carries human-readable annotations (update
            # counts, forces-* markers — scheduler/annotate.go)
            from ..scheduler.annotate import annotate
            the_diff = annotate(
                job_diff(old_job, job),
                {"DesiredTGUpdates": annotations["desired_tg_updates"]}
                if annotations else None)
        return {
            "annotations": annotations,
            "failed_tg_allocs": {tg: to_wire(m) for tg, m in
                                 (final_eval.failed_tg_allocs or {}).items()},
            "diff": the_diff,
            "job_modify_index": old_job.job_modify_index if old_job else 0,
            "next_version": (old_job.version + 1
                             if old_job is not None
                             and old_job.specchanged(job) else
                             old_job.version if old_job else 0),
        }

    def scale_job(self, namespace: str, job_id: str, group: str,
                  count: Optional[int] = None, message: str = "",
                  error: bool = False) -> Optional[Evaluation]:
        """Job.Scale (nomad/job_endpoint.go Scale:969): adjust one task
        group's count within its scaling policy bounds; always records a
        scaling event (the autoscaler's audit trail)."""
        from ..models.evaluation import TRIGGER_JOB_SCALE
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job {job_id} not found")
        if job.stopped():
            raise ValueError(f"job {job_id} is stopped")
        job = job.copy()
        tg = job.lookup_task_group(group)
        if tg is None:
            raise KeyError(f"task group {group!r} not found in {job_id}")
        ev = None
        if count is not None and not error:
            if tg.scaling is not None:
                if count < tg.scaling.min:
                    raise ValueError(
                        f"count {count} below scaling policy minimum "
                        f"{tg.scaling.min}")
                if tg.scaling.max and count > tg.scaling.max:
                    raise ValueError(
                        f"count {count} above scaling policy maximum "
                        f"{tg.scaling.max}")
            prev = tg.count
            tg.count = count
            ev = self.register_job(job, triggered_by=TRIGGER_JOB_SCALE)
            message = message or f"scaled from {prev} to {count}"
        self.raft_apply("scaling_event", dict(
            namespace=namespace, job_id=job_id,
            event=dict(task_group=group, count=count, message=message,
                       error=error, eval_id=ev.id if ev else "",
                       time=int(time.time()))))
        return ev

    def revert_job(self, namespace: str, job_id: str,
                   version: int) -> Optional[Evaluation]:
        """Job.Revert (nomad/job_endpoint.go Revert): re-register an
        older version's spec as a new version."""
        target = self.store.job_by_id_and_version(namespace, job_id,
                                                  version)
        if target is None:
            raise KeyError(f"job {job_id} version {version} not found")
        current = self.store.job_by_id(namespace, job_id)
        if current is not None and current.version == version:
            raise ValueError(
                f"job {job_id} is already at version {version}")
        rolled = target.copy()
        rolled.stable = False
        rolled.version = 0          # reassigned by upsert_job
        return self.register_job(rolled)

    # -- deployment endpoints (nomad/deployment_endpoint.go) -----------
    def promote_deployment(self, deployment_id: str,
                           groups: Optional[List[str]] = None) -> Evaluation:
        return promote_deployment(self, deployment_id, groups)

    def fail_deployment(self, deployment_id: str,
                        **kw) -> Optional[Evaluation]:
        return fail_deployment(self, deployment_id, **kw)

    def pause_deployment(self, deployment_id: str, pause: bool) -> None:
        pause_deployment(self, deployment_id, pause)

    # -- node drain (nomad/node_endpoint.go UpdateDrain) ---------------
    def update_node_drain(self, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> None:
        """Start or clear a drain. Stamps the force deadline from the
        spec's relative deadline (structs.go DrainStrategy.DeadlineTime)."""
        if drain_strategy is not None \
                and drain_strategy.drain_spec.deadline_s > 0 \
                and drain_strategy.force_deadline == 0:
            drain_strategy.force_deadline = (
                time.time() + drain_strategy.drain_spec.deadline_s)
        self.raft_apply("node_drain_update",
                        dict(node_id=node_id, drain_strategy=drain_strategy,
                             mark_eligible=mark_eligible))

    def drain_allocs(self, allocs, jobs) -> None:
        drain_allocs(self, allocs, jobs)

    # -- nodes and allocs (nomad/node_endpoint.go) ---------------------
    def register_node(self, node: Node) -> None:
        node.canonicalize()
        if not node.computed_class:
            node.compute_class()
        self.raft_apply("node_register", dict(node=node))
        self.reset_heartbeat_timer(node.id)

    def update_node_status(self, node_id: str, status: str) -> None:
        evals = []
        if status == NODE_STATUS_DOWN:
            evals = self._node_evals(node_id)
        self.raft_apply("node_status_update",
                        dict(node_id=node_id, status=status, evals=evals))

    def update_alloc_status_from_client(self,
                                        allocs: List[Allocation]) -> None:
        """Node.UpdateAlloc: client pushes task states; failed allocs
        trigger alloc-failure evals (node_endpoint.go:1065)."""
        evals = self._client_update_evals(allocs)
        payload = dict(allocs=allocs, evals=evals)
        if self.ingest is not None:
            self.ingest.submit("alloc_client_update", payload)
        else:
            self.raft_apply("alloc_client_update", payload)
        self._revoke_terminal_accessors(allocs)

    def update_alloc_status_from_client_batch(
            self, groups: List[List[Allocation]]) -> None:
        """Node.UpdateAllocBatch: N clients' update pushes
        in one verb. Each group keeps its own gateway entry (its evals
        are derived from pre-batch state exactly as N concurrent
        Node.UpdateAlloc calls would be), but all of them park together
        and land as one coalesced raft entry / store transaction."""
        if self.ingest is None:
            for g in groups:
                self.update_alloc_status_from_client(g)
            return
        futures = []
        for g in groups:
            evals = self._client_update_evals(g)
            futures.append(self.ingest.submit_async(
                "alloc_client_update", dict(allocs=g, evals=evals)))
        err = None
        for f in futures:
            try:
                f.result()
            except Exception as e:
                err = e
        for g in groups:
            self._revoke_terminal_accessors(g)
        if err is not None:
            raise err

    def _client_update_evals(self, allocs: List[Allocation]
                             ) -> List[Evaluation]:
        evals = []
        seen = set()
        for stub in allocs:
            existing = self.store.alloc_by_id(stub.id)
            if existing is None:
                continue
            if stub.client_status == "failed" and (existing.namespace,
                                                   existing.job_id) not in seen:
                job = self.store.job_by_id(existing.namespace,
                                           existing.job_id)
                if job is not None and not job.stopped():
                    seen.add((existing.namespace, existing.job_id))
                    evals.append(Evaluation(
                        namespace=existing.namespace, priority=job.priority,
                        type=job.type, triggered_by="alloc-failure",
                        job_id=existing.job_id, status=EVAL_STATUS_PENDING))
        return evals

    def _revoke_terminal_accessors(self, allocs: List[Allocation]) -> None:
        # drop the vault leases of allocs the client just reported
        # terminal (node_endpoint.go UpdateAlloc -> revokeVaultAccessors)
        terminal = {a.id for a in allocs
                    if a.client_status in ("complete", "failed", "lost")}
        if terminal:
            doomed = [va.accessor for aid in terminal
                      for va in self.store.vault_accessors_by_alloc(aid)]
            self.revoke_vault_accessors(doomed)

    def revoke_vault_accessors(self, accessors: List[str]) -> None:
        """vault.go RevokeTokens: the embedded backend simply drops the
        lease rows — a dropped row IS an invalid token here."""
        if accessors:
            metrics.incr_counter("nomad.vault.revoked", len(accessors))
            self.raft_apply("vault_accessor_delete",
                            dict(accessors=list(accessors)))

    def _node_evals(self, node_id: str) -> List[Evaluation]:
        """One eval per job with allocs on the node + each system job
        (node_endpoint.go createNodeEvals:1318)."""
        evals = []
        jobs = set()
        for alloc in self.store.allocs_by_node(node_id):
            key = (alloc.namespace, alloc.job_id)
            if key in jobs:
                continue
            jobs.add(key)
            job = alloc.job or self.store.job_by_id(*key)
            if job is None:
                continue
            evals.append(Evaluation(
                namespace=key[0], priority=job.priority, type=job.type,
                triggered_by=TRIGGER_NODE_UPDATE, job_id=key[1],
                node_id=node_id, status=EVAL_STATUS_PENDING))
        for job in self.store.jobs():
            if job.type == JOB_TYPE_SYSTEM and \
                    job.namespaced_id() not in jobs and not job.stopped():
                evals.append(Evaluation(
                    namespace=job.namespace, priority=job.priority,
                    type=job.type, triggered_by=TRIGGER_NODE_UPDATE,
                    job_id=job.id, node_id=node_id,
                    status=EVAL_STATUS_PENDING))
        return evals

    def bootstrap_acl(self):
        """One-time management-token mint (acl_endpoint.go Bootstrap).
        Raises if the cluster already has tokens."""
        from ..acl import new_token
        if self.store.acl_tokens():
            raise PermissionError("ACL bootstrap already done")
        token = new_token(name="Bootstrap Token", type_="management",
                          global_=True)
        self.raft_apply("acl_token_upsert", dict(tokens=[token]))
        return token

    def upsert_acl_policies(self, policies) -> int:
        from ..acl import parse_policy_rules
        for p in policies:
            if not p.name:
                raise ValueError("policy name required")
            parse_policy_rules(p.rules)        # validate
        return self.raft_apply("acl_policy_upsert", dict(policies=policies))

    def delete_acl_policies(self, names) -> int:
        return self.raft_apply("acl_policy_delete", dict(names=names))

    def create_acl_token(self, name: str = "", type_: str = "client",
                         policies=None, global_: bool = False):
        from ..acl import new_token
        if type_ not in ("client", "management"):
            raise ValueError(f"invalid token type {type_!r}")
        if type_ == "client" and not policies:
            raise ValueError("client token requires policies")
        token = new_token(name=name, type_=type_, policies=policies,
                          global_=global_)
        self.raft_apply("acl_token_upsert", dict(tokens=[token]))
        return token

    def delete_acl_tokens(self, accessor_ids) -> int:
        return self.raft_apply("acl_token_delete",
                               dict(accessor_ids=accessor_ids))

    def resolve_token(self, secret_id):
        """secret -> compiled ACL (nomad/acl.go ResolveToken). With ACLs
        disabled everything is management; with no token the anonymous
        deny-all ACL applies; unknown secrets are rejected."""
        from ..acl import ACL_MANAGEMENT, compile_acl
        from ..acl.acl import ACL_DENY_ALL
        if not self.config.acl_enabled:
            return ACL_MANAGEMENT
        if not secret_id:
            return ACL_DENY_ALL
        token = self.store.acl_token_by_secret(secret_id)
        if token is None:
            raise PermissionError("ACL token not found")
        if token.type == "management":
            return ACL_MANAGEMENT
        key = (tuple(sorted(token.policies)),
               self.store._root.indexes.get("acl_policies") or 0)
        cached = self._acl_cache.get(key)
        if cached is not None:
            return cached
        policies = [p for name in token.policies
                    if (p := self.store.acl_policy(name)) is not None]
        acl = compile_acl(policies)
        if len(self._acl_cache) > 256:
            self._acl_cache.clear()
        self._acl_cache[key] = acl
        return acl

    @staticmethod
    def _implied_constraints(job: Job) -> None:
        """jobImpliedConstraints (job_endpoint_hooks.go:114): auto-add
        group constraints implied by feature use — vault stanzas need a
        vault-capable node, signal-based change modes need nodes
        advertising those signals."""
        from ..models import Constraint
        for tg in job.task_groups:
            wants_vault = any(t.vault is not None for t in tg.tasks)
            signals = set()
            for t in tg.tasks:
                if t.kill_signal:
                    signals.add(t.kill_signal)
                if t.vault is not None and t.vault.change_signal:
                    signals.add(t.vault.change_signal)
                for tmpl in t.templates:
                    if tmpl.change_signal:
                        signals.add(tmpl.change_signal)
            have = {(c.ltarget, c.operand) for c in tg.constraints}
            if wants_vault and \
                    ("${attr.vault.version}", "is_set") not in have:
                tg.constraints.append(Constraint(
                    ltarget="${attr.vault.version}", rtarget="",
                    operand="is_set"))
            if signals and ("${attr.os.signals}",
                            "set_contains") not in have:
                tg.constraints.append(Constraint(
                    ltarget="${attr.os.signals}",
                    rtarget=",".join(sorted(signals)),
                    operand="set_contains"))

    # -- dynamic membership (nomad/serf.go + nomad/autopilot.go) -------
    def _apply_server_membership(self, index: int, p: dict) -> None:
        members = list(p.get("members") or [])
        self.store.set_server_members(index, members)
        if self.raft is not None:
            self.raft.update_members(members)

    def join_member(self, addr: str) -> List[str]:
        """Add a server to the voter set (Server.Join; the joiner calls
        this through any member — writes forward to the leader).
        Returns the post-join member list. The read-modify-write of
        the full list is serialized per leader so concurrent joins
        cannot overwrite each other's membership."""
        if self.raft is None:
            raise RuntimeError("not a clustered server")
        with self._member_l:
            current = self.store.server_members() or \
                [self.raft.self_addr] + list(self.raft.peers)
            if addr not in current:
                self.raft_apply("server_membership",
                                dict(members=current + [addr]))
        return self.store.server_members()

    def leave_member(self, addr: str) -> List[str]:
        """Remove a server from the voter set (operator leave or
        autopilot dead-server cleanup)."""
        if self.raft is None:
            raise RuntimeError("not a clustered server")
        with self._member_l:
            current = self.store.server_members() or \
                [self.raft.self_addr] + list(self.raft.peers)
            if addr in current:
                self.raft_apply(
                    "server_membership",
                    dict(members=[m for m in current if m != addr]))
        return self.store.server_members()

    def join_cluster(self, via_addr: str) -> None:
        """Joiner side: ask an existing member to add us, then adopt
        the returned member list (the serf-join analog)."""
        if self.raft is None:
            raise RuntimeError("attach_raft first")
        from ..rpc.client import RpcClient
        c = RpcClient(via_addr, dial_timeout_s=3.0)
        try:
            res = c.call("Server.Join",
                         {"addr": self.raft.self_addr}, timeout_s=30.0)
        finally:
            c.close()
        members = list(res.get("members") or [])
        if members:
            self.raft.update_members(members)

    def handle_peer_failure_report(self, addr: str,
                                   reporter: str = "") -> bool:
        """A peer's SWIM verdict arrived (Server.ReportFailed). Leader
        only: verify the target is unreachable from HERE too (implicit
        refutation — a live server answers and the report is dropped),
        then remove it under the same quorum guard autopilot uses.
        Returns True when the member was removed."""
        raft = self.raft
        if raft is None or not raft.is_leader():
            from ..rpc.codec import RpcRefused
            raise RpcRefused("not the leader")
        if addr == raft.self_addr:
            return False
        members = self.store.server_members() or \
            [raft.self_addr] + list(raft.peers)
        if addr not in members:
            return False                # already gone
        if self.swim is not None and self.swim.probe_for_peer(addr):
            LOG.info("swim report for %s from %s refuted by leader "
                     "probe", addr, reporter)
            return False
        alive = len(members) - 1
        if alive * 2 <= len(members):
            LOG.warning("swim: not removing %s — quorum guard", addr)
            return False
        LOG.warning("swim: removing failed server %s (reported by %s)",
                    addr, reporter)
        self.leave_member(addr)
        return True

    def _autopilot_loop(self) -> None:
        """Leader-side dead-server cleanup (nomad/autopilot.go): a
        voter with no successful replication contact past the cleanup
        threshold is removed from the member set, as long as a quorum
        of the REMAINING members is intact."""
        while self._leader and not self._shutdown_ev.is_set():
            # re-read per tick: the threshold may change at runtime (0
            # disables without killing the loop, so re-enabling works
            # too)
            threshold = self.config.dead_server_cleanup_s
            if self._shutdown_ev.wait(max(min(threshold / 4.0, 2.0), 0.5)
                                      if threshold > 0 else 1.0):
                return
            raft = self.raft
            if raft is None or not raft.is_leader() or threshold <= 0:
                continue
            now = time.monotonic()
            peers = list(raft.peers)
            dead = [p for p in peers
                    if now - raft.last_contact.get(p, now) > threshold]
            if not dead:
                continue
            alive = len(peers) - len(dead) + 1
            for p in dead:
                # quorum guard: committing the removal itself needs a
                # majority of the CURRENT cluster — without it the
                # leave write just times out and blocks join/leave
                if alive * 2 <= len(peers) + 1:
                    break
                try:
                    LOG.warning("autopilot: removing dead server %s "
                                "(no contact for %.0fs)", p,
                                now - raft.last_contact.get(p, now))
                    self.leave_member(p)
                except Exception:
                    LOG.exception("autopilot cleanup of %s failed", p)

    # -- namespaces (nomad/namespace_endpoint.go) ----------------------
    def upsert_namespaces(self, namespaces: list) -> int:
        errs = []
        for ns in namespaces:
            errs.extend(ns.validate())
        if errs:
            raise ValueError("; ".join(errs))
        return self.raft_apply("namespace_upsert",
                               dict(namespaces=list(namespaces)))

    def delete_namespaces(self, names: list) -> int:
        """DeleteNamespaces:66 — "default" is undeletable and occupied
        namespaces (non-terminal jobs) refuse deletion."""
        from ..models.namespace import DEFAULT_NAMESPACE
        for name in names:
            if name == DEFAULT_NAMESPACE:
                raise ValueError("default namespace can not be deleted")
            if self.store.namespace_by_name(name) is None:
                raise KeyError(f"namespace {name} not found")
            occupied = [j.id for j in self.store.jobs()
                        if j.namespace == name
                        and j.status != "dead"]
            if occupied:
                raise ValueError(
                    f"namespace {name!r} has non-terminal jobs: "
                    f"{sorted(occupied)[:5]}")
        return self.raft_apply("namespace_delete", dict(names=names))

    # -- service registry (built-in catalog) ---------------------------
    def update_service_registrations(self, upserts=None,
                                     delete_alloc_ids=None,
                                     delete_ids=None) -> int:
        """Client-driven catalog sync: register live services, drop the
        rows of stopped allocs (the reference's Consul sync loop,
        command/agent/consul/service_client.go sync)."""
        index = 0
        if upserts:
            index = self.raft_apply("service_registration_upsert",
                                    dict(services=list(upserts)))
        if delete_alloc_ids or delete_ids:
            index = self.raft_apply(
                "service_registration_delete",
                dict(ids=list(delete_ids or []),
                     alloc_ids=list(delete_alloc_ids or [])))
        return index

    def list_services(self, namespace: str = "default") -> list:
        """Per-service summary (nomad service list analog): name, tags,
        live instance count."""
        summary: Dict[str, dict] = {}
        for s in self.store.service_registrations(namespace):
            row = summary.setdefault(
                s.service_name,
                {"ServiceName": s.service_name, "Namespace": s.namespace,
                 "Tags": set(), "Instances": 0})
            row["Tags"].update(s.tags)
            row["Instances"] += 1
        out = []
        for name in sorted(summary):
            row = summary[name]
            row["Tags"] = sorted(row["Tags"])
            out.append(row)
        return out

    def get_service(self, namespace: str, name: str) -> list:
        return self.store.service_by_name(namespace, name)

    # -- CSI volumes (nomad/csi_endpoint.go; volumewatcher/) -----------
    def register_csi_volume(self, volume) -> int:
        if not volume.id or not volume.plugin_id:
            raise ValueError("volume requires id and plugin_id")
        return self.raft_apply("csi_volume_register",
                               dict(volumes=[volume]))

    def deregister_csi_volume(self, namespace: str, volume_id: str,
                              force: bool = False) -> int:
        v = self.store.csi_volume(namespace, volume_id)
        if v is None:
            raise KeyError(f"volume {volume_id} not found")
        if not force and (v.read_allocs or v.write_allocs):
            raise ValueError(
                f"volume {volume_id} has active claims (use force)")
        return self.raft_apply("csi_volume_deregister",
                               dict(namespace=namespace,
                                    volume_id=volume_id))

    def _watch_volumes(self) -> None:
        """Volume watcher (nomad/volumewatcher): release claims held by
        terminal allocations so volumes become schedulable again. One
        pass a second; shutdown's event ends the wait at once."""
        while not self._shutdown_ev.wait(1.0):
            if not self._leader:
                continue
            try:
                for v in self.store.csi_volumes():
                    for aid in (list(v.read_allocs)
                                + list(v.write_allocs)):
                        alloc = self.store.alloc_by_id(aid)
                        if alloc is None or alloc.terminal_status():
                            self.raft_apply(
                                "csi_volume_release",
                                dict(namespace=v.namespace,
                                     volume_id=v.id, alloc_id=aid))
            except Exception:     # pragma: no cover — best effort
                LOG.exception("volume watcher pass failed")
            try:
                self._reap_vault_accessors()
            except Exception:     # pragma: no cover — best effort
                LOG.exception("vault accessor reap failed")

    # -- Vault integration (nomad/vault.go:176 vaultClient) ------------
    def derive_vault_token(self, alloc_id: str, tasks) -> Dict[str, dict]:
        """Token derivation for tasks with a vault stanza
        (node_endpoint.go DeriveVaultToken + vault.go CreateToken).
        The embedded authority mints a TTL'd token + accessor per task
        and tracks the lease in the replicated store, so revocation and
        renewal survive leader failover (see server/vault.py). Returns
        {task: {token, accessor, ttl_s}}."""
        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id} not found")
        if alloc.terminal_status():
            raise ValueError(f"alloc {alloc_id} is terminal")
        from ..server.vault import VaultAccessor
        from ..utils.codec import to_wire
        from ..utils.ids import generate_uuid
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        policies: Dict[str, list] = {}
        if tg is not None:
            for t in tg.tasks:
                if t.vault is not None:
                    policies[t.name] = list(t.vault.policies)
        now = time.time()
        ttl = self.config.vault_token_ttl_s
        accessors, out = [], {}
        # node_endpoint.go DeriveVaultToken: reject tasks that don't
        # exist in the alloc's group or carry no vault stanza — a
        # client must not be able to mint tokens for arbitrary names
        unknown = [t for t in tasks if t not in policies]
        if unknown:
            raise ValueError(
                f"tasks {unknown} do not exist in alloc {alloc_id} "
                "or have no vault stanza")
        for task in tasks:
            tok = f"s.{generate_uuid()[:24]}"
            acc = generate_uuid()
            accessors.append(VaultAccessor(
                accessor=acc, token=tok, alloc_id=alloc_id, task=task,
                node_id=alloc.node_id, policies=policies.get(task, []),
                ttl_s=ttl, create_time=now, expire_time=now + ttl))
            out[task] = {"token": tok, "accessor": acc, "ttl_s": ttl}
        self.raft_apply("vault_accessor_upsert",
                        dict(accessors=[to_wire(a) for a in accessors]))
        return out

    def renew_vault_token(self, accessor: str, token: str) -> float:
        """Extend a lease (vault.go RenewToken / client-side renewal
        loop target). Raises on unknown/revoked/expired leases — the
        client must re-derive then."""
        a = self.store.vault_accessor(accessor)
        if a is None or a.token != token:
            raise KeyError("unknown vault accessor")
        now = time.time()
        if a.expired(now):
            # reap lazily; the renewal failure tells the client to
            # re-derive (vaultclient.go renewal error path)
            self.raft_apply("vault_accessor_delete",
                            dict(accessors=[accessor]))
            raise ValueError("vault token lease expired")
        self.raft_apply("vault_accessor_renew",
                        dict(accessor=accessor,
                             expire_time=now + a.ttl_s))
        return a.ttl_s

    def lookup_vault_token(self, token: str) -> bool:
        """Is this token currently valid? (vault TokenLookup analog,
        used by tests and operator introspection)."""
        a = self.store.vault_accessor_by_token(token)
        return a is not None and not a.expired()

    def _reap_vault_accessors(self) -> None:
        """Leader-side revocation daemon (vault.go revokeDaemon +
        nomad/node_endpoint.go revoking accessors of terminal allocs):
        drop leases whose alloc is gone/terminal or whose TTL lapsed
        without renewal."""
        now = time.time()
        doomed = []
        for a in self.store.vault_accessors():
            alloc = self.store.alloc_by_id(a.alloc_id)
            if alloc is None or alloc.terminal_status() or a.expired(now):
                doomed.append(a.accessor)
        self.revoke_vault_accessors(doomed)

    # -- heartbeats (nomad/heartbeat.go) -------------------------------
    def reset_heartbeat_timer(self, node_id: str) -> None:
        if self._shutdown_ev.is_set():
            return
        if self.raft is not None and not self._leader:
            return              # TTL timers are leader-only (heartbeat.go)
        self._heartbeats.reset(node_id)

    def _invalidate_heartbeat(self, node_id: str) -> None:
        node = self.store.node_by_id(node_id)
        if node is None or node.status == NODE_STATUS_DOWN:
            return
        LOG.warning("node %s missed heartbeat, marking down", node_id[:8])
        self.update_node_status(node_id, NODE_STATUS_DOWN)

    def heartbeat(self, node_id: str,
                  stats: Optional[dict] = None) -> float:
        """Client TTL renewal; returns the TTL. `stats` is the compact
        host-stats summary the client sampler attaches — kept per node
        for cluster_stats() to fold; O(1) per beat."""
        node = self.store.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node {node_id} not registered")
        from ..chaos import faults as chaos_faults
        if chaos_faults.ACTIVE and \
                chaos_faults.fire("server.heartbeat", node_id=node_id):
            # chaos hook: the beat is dropped in transit — the client
            # believes it renewed, but the TTL timer keeps running toward
            # node-down and the stale-stats clock ages the last payload
            # toward `stale_heartbeats`
            return self.config.heartbeat_ttl_s
        if stats:
            with self._node_stats_l:
                self._node_stats[node_id] = {
                    **stats, "received_at": time.time()}
        if node.status != NODE_STATUS_READY:
            self.update_node_status(node_id, NODE_STATUS_READY)
        self.reset_heartbeat_timer(node_id)
        return self.config.heartbeat_ttl_s

    # -- cluster rollup ------------------------------------------------
    def _telemetry_extra(self) -> Dict[str, float]:
        """The telemetry collector's extra_fn: device-mirror residency
        plus the cluster.* family, so fleet economics land in the
        retained ring every sample."""
        out: Dict[str, float] = {
            "device.mirror_bytes":
            self.store.table_cache.device_mirror_bytes()}
        for k, v in self.cluster_stats().items():
            out[f"cluster.{k}"] = v
        return out

    def cluster_stats(self) -> Dict[str, float]:
        """Fold per-node heartbeat host-stats into fleet economics:
        nodes up/down, capacity vs ALLOCATED (bin-packed, from the
        resident columnar node table) vs actually USED (host truth,
        from the heartbeat payloads), per-node utilization p50/p99,
        stale-heartbeat count. Pure host reads — O(nodes) numpy sums;
        also mirrors the family into the metrics registry so
        /v1/metrics?format=prometheus exposes nomad.cluster.*."""
        snap = self.store.snapshot()
        nodes = snap.nodes()
        now = time.time()
        with self._node_stats_l:
            # prune payloads for nodes the store no longer knows
            known = {n.id for n in nodes}
            for nid in list(self._node_stats):
                if nid not in known:
                    del self._node_stats[nid]
            stats = dict(self._node_stats)
        out: Dict[str, float] = {
            "nodes_total": float(len(nodes)),
            "nodes_ready": float(sum(1 for n in nodes if n.ready())),
            "nodes_down": float(sum(
                1 for n in nodes if n.status == NODE_STATUS_DOWN)),
            "nodes_reporting": 0.0,
            "stale_heartbeats": 0.0,
        }
        cap_cpu = cap_mem = 0.0
        for n in nodes:
            res = n.comparable_resources()
            cap_cpu += res.cpu_shares
            cap_mem += res.memory_mb
        out["fleet_cpu_capacity_mhz"] = cap_cpu
        out["fleet_mem_capacity_mb"] = cap_mem
        # allocated: the resident node table's live-alloc usage sums
        # (delta-maintained — no per-sample alloc scan). build=False:
        # a rollup must never trigger a cold table build; before the
        # first eval the allocated half reads 0 and catches up with
        # the first scheduled table
        alloc_cpu = alloc_mem = 0.0
        table = snap.node_table(build=False)
        if table is not None and table.n > 0:
            alloc_cpu = float(table.base_used[:, 0].sum())
            alloc_mem = float(table.base_used[:, 1].sum())
        out["fleet_cpu_allocated_mhz"] = alloc_cpu
        out["fleet_mem_allocated_mb"] = alloc_mem
        out["fleet_cpu_allocated_ratio"] = \
            round(alloc_cpu / cap_cpu, 4) if cap_cpu > 0 else 0.0
        out["fleet_mem_allocated_ratio"] = \
            round(alloc_mem / cap_mem, 4) if cap_mem > 0 else 0.0
        # used: host truth from the heartbeat payloads — a node's
        # host-level utilization FRACTION (cpu percent, mem
        # used/total) scaled by its configured capacity, so both used
        # sums stay commensurate with the capacity denominator and a
        # host busier than its schedulable share can't push a fleet
        # ratio past 1.0. Stale payloads drop out of the used sums
        # (their capacity still counts: unreported usage is unknown,
        # not 0)
        used_cpu = used_mem = 0.0
        cpu_pcts: List[float] = []
        mem_ratios: List[float] = []
        stale_after = self.config.stats_stale_after_s
        by_id = {n.id: n for n in nodes}
        for nid, st in stats.items():
            if now - st.get("received_at", 0.0) > stale_after:
                out["stale_heartbeats"] += 1.0
                continue
            node = by_id.get(nid)
            if node is None:
                continue
            out["nodes_reporting"] += 1.0
            res = node.comparable_resources()
            pct = float(st.get("cpu_pct", 0.0))
            used_cpu += pct / 100.0 * res.cpu_shares
            cpu_pcts.append(pct)
            total = float(st.get("mem_total_mb", 0.0))
            if total > 0:
                ratio = min(
                    float(st.get("mem_used_mb", 0.0)) / total, 1.0)
                used_mem += ratio * res.memory_mb
                mem_ratios.append(ratio)
        out["fleet_cpu_used_mhz"] = round(used_cpu, 1)
        out["fleet_mem_used_mb"] = round(used_mem, 1)
        out["fleet_cpu_used_ratio"] = \
            round(used_cpu / cap_cpu, 4) if cap_cpu > 0 else 0.0
        out["fleet_mem_used_ratio"] = \
            round(used_mem / cap_mem, 4) if cap_mem > 0 else 0.0
        if cpu_pcts:
            arr = np.asarray(cpu_pcts)
            out["node_cpu_pct_p50"] = round(
                float(np.percentile(arr, 50)), 3)
            out["node_cpu_pct_p99"] = round(
                float(np.percentile(arr, 99)), 3)
        if mem_ratios:
            arr = np.asarray(mem_ratios)
            out["node_mem_ratio_p50"] = round(
                float(np.percentile(arr, 50)), 4)
            out["node_mem_ratio_p99"] = round(
                float(np.percentile(arr, 99)), 4)
        for k in ("nodes_total", "nodes_ready", "nodes_down",
                  "nodes_reporting", "stale_heartbeats",
                  "fleet_cpu_used_ratio", "fleet_mem_used_ratio",
                  "fleet_cpu_allocated_ratio",
                  "fleet_mem_allocated_ratio"):
            metrics.set_gauge(f"nomad.cluster.{k}", out[k])
        return out
