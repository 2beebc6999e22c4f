"""The scenario matrix's cells: everything the reference's scheduler
surface covers that a throughput benchmark doesn't, each run under an
injected fault with invariant checks. Every server a cell builds runs
its kernels on the cell's device (the CUDA card unless the caller
passes "cpu").

Cells (chaos/matrix.py runs them; `nomad dev chaos -cell NAME` runs
one):

  system_fanout          system job fanned to every feasible node,
                         cross-checked against the SystemScheduler
                         placement contract, under dropped heartbeats
  spread_antiaffinity    spread/rack-anti-affinity multi-DC topology
                         with a forced governor reclaim mid-wave
  batch_backfill         batch backfill behind service traffic with a
                         worker killed mid-commit (plan committed,
                         ack withheld) — the no-double-commit cell
  drain_storm            node-drain storm + rolling upgrade: drain
                         wave, clean shutdown, WAL tail corrupted,
                         reboot — recovery must reconcile to intent
  client_failure_burst   mass client failure -> reschedule burst onto
                         the surviving fleet
  blocked_herd           blocked-eval thundering herd: overload, then
                         a capacity burst wakes every blocked eval
  swim_partition         (cluster cell, excluded from quick sets) a
                         3-server raft cluster with one follower
                         partitioned at the SWIM layer
  follower_fence         (cluster) the distributed scheduler plane
                         under replication lag: the sole
                         scheduling follower's fence blocks, stale
                         plans demote at leader verify, heal recovers
  leader_failover_commit (cluster) leader killed the instant a remote
                         plan's group-commit entry is dispatched; the
                         new leader restores the broker and the
                         intent settles exactly once

Workload generators draw every mock id through the promoted
`mock.seeded_mock_ids` context, so a cell's content is a pure
function of its seed.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import invariants
from .matrix import Cell, Scenario

LOG = logging.getLogger("nomad_tpu.chaos")


# -- workload helpers -------------------------------------------------

def _mk_nodes(cell: Cell, n: int, dcs: int = 1, racks: int = 8):
    """n seeded mock nodes registered THROUGH the server (raft apply +
    TTL timer), spread over datacenters and racks."""
    from ..mock import fixtures as mock
    from ..mock import seeded_mock_ids
    nodes = []
    with seeded_mock_ids(cell.seed):
        for i in range(n):
            node = mock.node()
            node.name = f"cnode-{i}"
            node.datacenter = f"dc{(i % dcs) + 1}"
            node.meta["rack"] = f"r{i % racks}"
            node.compute_class()
            nodes.append(node)
    return nodes


def _register_nodes(srv, nodes) -> None:
    for node in nodes:
        srv.register_node(node)


def _svc_job(cell: Cell, jid: str, count: int, priority: int = 50,
             cpu: int = 300, mem: int = 128, dcs: int = 1,
             job_type: str = "service"):
    """A seeded service/batch job with the port ask stripped (cells
    measure scheduling + recovery semantics, not port bookkeeping)."""
    from ..mock import fixtures as mock
    from ..mock import seeded_mock_ids
    with seeded_mock_ids(cell.seed):
        job = mock.job() if job_type == "service" else mock.batch_job()
    job.id = jid
    job.name = jid
    job.type = job_type
    job.priority = priority
    job.datacenters = [f"dc{d + 1}" for d in range(dcs)]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.cpu = cpu
        t.resources.memory_mb = mem
    job.canonicalize()
    return job


def _live(store, job) -> list:
    return [a for a in store.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]


def _settle(cell: Cell, srv, job, timeout_s: float = 25.0) -> bool:
    """Register the job and wait until its full count is live with
    distinct names; the settle latency is the cell's workload metric
    (placements/s, p50/p99) and the flatness window sample."""
    count = sum(tg.count for tg in job.task_groups)
    t0 = time.perf_counter()
    srv.register_job(job)
    ok = cell.wait_for(
        lambda: len({a.name for a in _live(srv.store, job)}) >= count,
        timeout_s=timeout_s)
    cell.note_latency(time.perf_counter() - t0,
                      placements=count if ok else 0)
    return ok


def _intent(jobs) -> Dict[Tuple[str, str], int]:
    return {(j.namespace, j.id): sum(tg.count for tg in j.task_groups)
            for j in jobs}


class _Beater:
    """Fake client heartbeats for store-registered mock nodes: renews
    every node's TTL on a cadence, attaching a host-stats payload
    (low cpu/mem use — these nodes execute nothing, which is exactly
    what the used-vs-allocated divergence invariant should see). Beats
    route through Server.heartbeat, so the chaos drop-heartbeat hook
    interposes them like real ones."""

    def __init__(self, srv, node_ids: List[str],
                 interval_s: float = 0.3):
        self.srv = srv
        self.node_ids = list(node_ids)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-beater")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            for nid in self.node_ids:
                try:
                    self.srv.heartbeat(nid, stats={
                        "cpu_pct": 2.0, "mem_used_mb": 128.0,
                        "mem_total_mb": 8192.0, "disk_used_mb": 1.0,
                        "disk_total_mb": 102400.0})
                except Exception:
                    pass            # node gone / server stopping

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


class _SimClients:
    """The minimal client behavior chaos cells need without real
    agents: acknowledge desired-stop/evict allocs as client-complete
    (a drain can't finish while the server waits on a kill ack that
    no client will ever send)."""

    def __init__(self, srv, interval_s: float = 0.1):
        self.srv = srv
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-simclients")
        self._thread.start()

    def _run(self) -> None:
        from dataclasses import replace
        while not self._stop.wait(self.interval_s):
            try:
                acks = []
                for a in self.srv.store.allocs():
                    if a.server_terminal_status() and \
                            not a.client_terminal_status():
                        acks.append(replace(a, client_status="complete"))
                if acks:
                    self.srv.update_alloc_status_from_client(acks)
            except Exception:
                pass                # server stopping mid-scan

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


# -- cell 1: system-job fan-out under dropped heartbeats --------------

def _run_system_fanout(cell: Cell) -> None:
    from ..mock import fixtures as mock
    from ..mock import seeded_mock_ids
    n_dc1 = 18 if cell.quick else 72
    n_dc2 = 6 if cell.quick else 24
    srv = cell.server(heartbeat_ttl_s=1.2, stats_stale_after_s=2.0)
    nodes = _mk_nodes(cell, n_dc1 + n_dc2, dcs=1)
    for node in nodes[n_dc1:]:
        node.datacenter = "dc2"
        node.compute_class()
    _register_nodes(srv, nodes)
    beater = _Beater(srv, [n.id for n in nodes])
    cell.track(beater)

    with seeded_mock_ids(cell.seed):
        job = mock.system_job()
    job.id = "chaos-system"
    for t in job.task_groups[0].tasks:
        t.resources.networks = []
    job.task_groups[0].networks = []
    job.canonicalize()

    dc1_ids = [n.id for n in nodes[:n_dc1]]
    with cell.window():
        t0 = time.perf_counter()
        srv.register_job(job)
        ok = cell.wait_for(
            lambda: len(_live(srv.store, job)) >= n_dc1, timeout_s=25)
        cell.note_latency(time.perf_counter() - t0,
                          placements=n_dc1 if ok else 0)
    # the SystemScheduler contract: one alloc on every feasible node
    # (dc1, ready), none on dc2
    cell.check(invariants.system_fanout(srv.store, job, dc1_ids))

    # the fleet must be REPORTING before the fault: a node that never
    # landed a stats payload can't age into stale_heartbeats (fast
    # settles beat the first 0.3s heartbeat tick)
    cell.wait_for(lambda: srv.cluster_stats()["nodes_reporting"]
                  >= len(nodes), timeout_s=10)
    # fault: the network eats a victim set's heartbeats — TTL expiry
    # must mark them down, their stats payloads must age into
    # stale_heartbeats, and the system job's allocs there must die
    victims = dc1_ids[:4]
    cell.injector.drop_heartbeats(victims)
    with cell.window():
        cell.check(invariants.failure_visibility(
            srv, expected_down=len(victims),
            expected_stale=len(victims)))
        live_ids = [n for n in dc1_ids if n not in victims]
        t0 = time.perf_counter()
        ok = cell.wait_for(
            lambda: {a.node_id for a in _live(srv.store, job)}
            == set(live_ids), timeout_s=20)
        cell.note_latency(time.perf_counter() - t0)
    cell.check(invariants.system_fanout(srv.store, job, live_ids))
    cell.check(invariants.used_vs_allocated(srv,
                                            expect_divergence=True))
    cell.metrics["nodes"] = len(nodes)
    cell.metrics["nodes_failed"] = len(victims)


# -- cell 2: spread/anti-affinity topology under governor pressure ----

def _run_spread_antiaffinity(cell: Cell) -> None:
    from ..models import Affinity, Spread, SpreadTarget
    n_nodes = 32 if cell.quick else 96
    waves, jobs_per_wave, count = (4, 2, 8) if cell.quick else (5, 4, 16)
    srv = cell.server()
    nodes = _mk_nodes(cell, n_nodes, dcs=4, racks=8)
    _register_nodes(srv, nodes)

    jobs = []
    for w in range(waves):
        with cell.window():
            for j in range(jobs_per_wave):
                job = _svc_job(cell, f"chaos-spread-{w}-{j}", count,
                               cpu=200, mem=96, dcs=4)
                tg = job.task_groups[0]
                tg.spreads = [
                    Spread(attribute="${node.datacenter}", weight=50,
                           spread_target=[SpreadTarget("dc1", 40),
                                          SpreadTarget("dc2", 30)]),
                    Spread(attribute="${meta.rack}", weight=30)]
                # rack anti-affinity: repel one rack, so feasibility
                # and ranking both carry attribute pressure
                tg.affinities = [Affinity(ltarget="${meta.rack}",
                                          rtarget="r0", operand="=",
                                          weight=-50)]
                jobs.append(job)
                if not _settle(cell, srv, job):
                    cell.check(invariants.check(
                        "wave_settled", False, job=job.id, wave=w))
        if w == 1:
            # the governor-pressure fault: every registered reclaim
            # (engine caches, victim memos, columnar index folds,
            # table-delta folds) fires MID-WAVE; later waves must
            # still place correctly on the reclaimed structures
            fired = cell.injector.force_governor_reclaim(srv)
            cell.metrics["reclaims_forced"] = len(fired)
    forced = [e for e in srv.governor.events()
              if e.get("kind") == "reclaim" and e.get("forced")]
    cell.check(invariants.check(
        "governor_reclaim_recorded", len(forced) > 0,
        forced_reclaims=len(forced)))
    cell.check(invariants.alloc_intent(srv.store, _intent(jobs)))
    cell.check(invariants.per_node_saturation(srv.store, _intent(jobs)))
    # each job's 8 allocs must fan across the racks and DCs its
    # spread stanzas name (count==8 over 8 racks -> all distinct)
    cell.check(invariants.spread_coverage(
        srv.store, _intent(jobs), lambda n: n.meta.get("rack"),
        min_distinct=min(count, 8) - 1, attr="rack"))
    cell.check(invariants.spread_coverage(
        srv.store, _intent(jobs), lambda n: n.datacenter,
        min_distinct=4, attr="datacenter"))


# -- cell 3: batch backfill + worker killed mid-commit ----------------

def _run_batch_backfill(cell: Cell) -> None:
    srv = cell.server()
    nodes = _mk_nodes(cell, 16 if cell.quick else 48)
    _register_nodes(srv, nodes)

    service = [_svc_job(cell, f"chaos-svc-{i}", 8, priority=70,
                        cpu=600) for i in range(2)]
    with cell.window():
        for job in service:
            if not _settle(cell, srv, job):
                cell.check(invariants.check("service_settled", False,
                                            job=job.id))

    # arm AFTER the service wave settles: the next plan to commit is a
    # batch backfill plan, and its worker dies between commit and ack
    cell.injector.kill_worker_on_commit(nth=1)
    batch = [_svc_job(cell, f"chaos-batch-{i}", 8, priority=30,
                      cpu=300, job_type="batch") for i in range(3)]
    with cell.window():
        for job in batch:
            # the killed eval redelivers after the broker's nack
            # delay; settle must absorb it
            if not _settle(cell, srv, job, timeout_s=40):
                cell.check(invariants.check("backfill_settled", False,
                                            job=job.id))
    all_jobs = service + batch
    cell.check(invariants.no_plan_committed_twice(
        srv.store, _intent(all_jobs), cell.injector))
    cell.check(invariants.alloc_intent(srv.store, _intent(all_jobs)))
    cell.check(invariants.blocked_evals_drained(srv))
    cell.metrics["workers_killed"] = len(cell.injector.killed_evals)


# -- cell 4: drain storm + rolling upgrade over a corrupted WAL -------

def _run_drain_storm(cell: Cell) -> None:
    from ..models.node import DrainSpec, DrainStrategy
    from ..models.job import MigrateStrategy
    from . import faults as chaos_faults
    data_dir = tempfile.mkdtemp(prefix="chaos-wal-")
    try:
        srv = cell.server(data_dir=data_dir, snapshot_every=10**6)
        nodes = _mk_nodes(cell, 12 if cell.quick else 32)
        _register_nodes(srv, nodes)
        sim = _SimClients(srv)

        jobs = []
        for i in range(2):
            job = _svc_job(cell, f"chaos-drain-{i}", 8, cpu=300)
            job.task_groups[0].migrate = MigrateStrategy(max_parallel=4)
            job.canonicalize()
            jobs.append(job)
        with cell.window():
            for job in jobs:
                if not _settle(cell, srv, job):
                    cell.check(invariants.check(
                        "drain_wave_settled", False, job=job.id))

        # drain storm: a third of the fleet drains at once
        drained = [n.id for n in nodes[:4 if cell.quick else 10]]
        with cell.window():
            t0 = time.perf_counter()
            for nid in drained:
                srv.update_node_drain(nid, DrainStrategy(
                    drain_spec=DrainSpec(deadline_s=60.0)))
            ok = cell.wait_for(
                lambda: all(
                    srv.store.node_by_id(nid).drain_strategy is None
                    for nid in drained)
                and all(len({a.name for a in _live(srv.store, j)})
                        >= j.task_groups[0].count for j in jobs),
                timeout_s=40)
            cell.note_latency(time.perf_counter() - t0)
            cell.check(invariants.check("drain_storm_completed", ok))
        cell.check(invariants.drained_nodes_empty(srv.store, drained))

        # rolling upgrade: clean shutdown, then the disk corrupts the
        # WAL tail before the new binary boots — replay must stop at
        # the first bad frame and the scheduler re-derives the lost
        # tail from intent
        sim.shutdown()
        srv.shutdown()
        cell.release(srv)
        detail = chaos_faults.corrupt_wal_tail(
            data_dir, span=96, seed=cell.seed)
        cell.injector.record("wal_corruption", **detail)
        cell.metrics["wal_corrupted_bytes"] = detail["corrupted_bytes"]

        srv2 = cell.server(data_dir=data_dir, snapshot_every=10**6)
        cell.track(_SimClients(srv2))
        for k, v in srv2.cold_start_stats.items():
            cell.metrics[f"recovery_{k}"] = round(float(v), 4)
        with cell.window():
            t0 = time.perf_counter()
            # re-assert intent on the upgraded server (idempotent
            # re-register, the operator's post-upgrade step): the
            # reconciler places whatever the lost tail dropped
            for job in jobs:
                srv2.register_job(job)
            ok = cell.wait_for(
                lambda: all(len({a.name for a in _live(srv2.store, j)})
                            >= j.task_groups[0].count for j in jobs),
                timeout_s=40)
            cell.note_latency(time.perf_counter() - t0)
            cell.check(invariants.check("recovered_after_corruption",
                                        ok))
        cell.check(invariants.alloc_intent(srv2.store, _intent(jobs)))
        cell.check(invariants.drained_nodes_empty(srv2.store, drained))
    finally:
        # tear the tracked servers down BEFORE the data dir goes away
        # (a shutdown snapshot/cost-model write into a removed dir is
        # just noise); run_cell's teardown then finds an empty list
        cell.teardown()
        shutil.rmtree(data_dir, ignore_errors=True)


# -- cell 5: mass client failure -> reschedule burst ------------------

def _run_client_failure_burst(cell: Cell) -> None:
    srv = cell.server(heartbeat_ttl_s=1.2, stats_stale_after_s=2.5)
    nodes = _mk_nodes(cell, 16 if cell.quick else 48)
    _register_nodes(srv, nodes)
    beater = _Beater(srv, [n.id for n in nodes])
    cell.track(beater)

    jobs = [_svc_job(cell, f"chaos-burst-{i}", 8, cpu=300)
            for i in range(3)]
    with cell.window():
        for job in jobs:
            if not _settle(cell, srv, job):
                cell.check(invariants.check("burst_wave_settled",
                                            False, job=job.id))

    # the fleet must be reporting before the fault (same reason as
    # the system_fanout cell: no payload, no staleness to observe)
    cell.wait_for(lambda: srv.cluster_stats()["nodes_reporting"]
                  >= len(nodes), timeout_s=10)
    # mass failure: the most-loaded third of the fleet stops beating
    by_load = sorted(nodes, key=lambda n: -len([
        a for a in srv.store.allocs_by_node(n.id)
        if not a.terminal_status()]))
    victims = [n.id for n in by_load[:len(nodes) // 3]]
    cell.injector.drop_heartbeats(victims)
    with cell.window():
        cell.check(invariants.failure_visibility(
            srv, expected_down=len(victims),
            expected_stale=len(victims)))
        t0 = time.perf_counter()
        ok = cell.wait_for(
            lambda: all(
                len({a.name for a in _live(srv.store, j)})
                >= j.task_groups[0].count
                and not any(a.node_id in set(victims)
                            for a in _live(srv.store, j))
                for j in jobs),
            timeout_s=30)
        cell.note_latency(time.perf_counter() - t0)
        cell.check(invariants.check("reschedule_burst_settled", ok))
    cell.check(invariants.alloc_intent(srv.store, _intent(jobs)))
    cell.check(invariants.allocs_on_live_nodes(srv.store,
                                               _intent(jobs), victims))
    cell.check(invariants.used_vs_allocated(srv,
                                            expect_divergence=True))
    cell.metrics["nodes_failed"] = len(victims)


# -- cell 6: blocked-eval thundering herd -----------------------------

def _run_blocked_herd(cell: Cell) -> None:
    srv = cell.server()
    small = _mk_nodes(cell, 4 if cell.quick else 8)
    _register_nodes(srv, small)

    n_jobs = 12 if cell.quick else 32
    jobs = [_svc_job(cell, f"chaos-herd-{i}", 4, cpu=1200, mem=512)
            for i in range(n_jobs)]
    with cell.window():
        t0 = time.perf_counter()
        for job in jobs:
            srv.register_job(job)
        # overload: capacity holds ~a quarter of the demand, the rest
        # must park as blocked evals
        herd = cell.wait_for(
            lambda: (srv.blocked_evals.stats.total_blocked
                     + srv.blocked_evals.stats.total_escaped)
            >= n_jobs // 2, timeout_s=25)
        cell.note_latency(time.perf_counter() - t0)
        cell.metrics["herd_blocked_peak"] = (
            srv.blocked_evals.stats.total_blocked
            + srv.blocked_evals.stats.total_escaped)
        cell.check(invariants.check("herd_built", herd,
                                    blocked=cell.metrics[
                                        "herd_blocked_peak"]))

    # capacity burst: every blocked eval wakes at once and the herd
    # must drain to exactly-once placements
    burst = _mk_nodes(cell, 16 if cell.quick else 44)
    with cell.window():
        t0 = time.perf_counter()
        _register_nodes(srv, burst)
        total = sum(j.task_groups[0].count for j in jobs)
        ok = cell.wait_for(
            lambda: sum(len({a.name for a in _live(srv.store, j)})
                        for j in jobs) >= total, timeout_s=40)
        cell.note_latency(time.perf_counter() - t0,
                          placements=total if ok else 0)
        cell.check(invariants.check("herd_drained_to_placements", ok))
    cell.wait_for(lambda: srv.eval_broker.stats.as_dict()["unacked"]
                  == 0, timeout_s=10)
    cell.check(invariants.alloc_intent(srv.store, _intent(jobs)))
    cell.check(invariants.blocked_evals_drained(srv))


# -- cell 7 (cluster): SWIM-layer partition ---------------------------

def _run_swim_partition(cell: Cell) -> None:
    from ..mock import fixtures as mock
    from ..rpc import RpcServer
    servers, rpcs = [], []
    for _ in range(3):
        srv = cell.server(start=False, num_schedulers=0,
                          dead_server_cleanup_s=0.0)
        rpc = RpcServer(srv, port=0)
        servers.append(srv)
        rpcs.append(rpc)
        cell.track(rpc)
    addrs = [r.addr for r in rpcs]
    for srv, rpc in zip(servers, rpcs):
        srv.attach_raft(rpc, addrs)
        rpc.start()
        srv.start()

    def leader():
        live = [s for s in servers if s.raft.is_leader()]
        return live[0] if len(live) == 1 else None

    ok = cell.wait_for(lambda: leader() is not None
                       and len(leader().store.server_members() or [])
                       == 3, timeout_s=30)
    cell.check(invariants.check("cluster_formed", ok))
    lead = leader()
    victim_addr = next(a for a in addrs if a != lead.raft.self_addr)

    def quorum_write() -> bool:
        """One flatness sample: a write commits and is visible on a
        majority of the non-victim members — the SAME operation in
        every window, so p99 drift across the partition is a real
        claim (writes must not degrade when a follower partitions)."""
        lead_now = leader()
        if lead_now is None:
            return False
        node = mock.node()
        t0 = time.perf_counter()
        try:
            lead_now.register_node(node)
            ok = cell.wait_for(
                lambda: sum(1 for s in servers
                            if s.raft.self_addr != victim_addr
                            and s.store.node_by_id(node.id)
                            is not None) >= 2, timeout_s=20)
        except Exception:
            ok = False
        cell.note_latency(time.perf_counter() - t0,
                          placements=1 if ok else 0)
        return ok

    with cell.window():                     # healthy baseline
        cell.check(invariants.check("quorum_write_healthy",
                                    quorum_write()))

    # the partition: SWIM probes (direct, indirect, and the leader's
    # verification) to the victim fail; the victim's process stays up
    cell.injector.partition({victim_addr})
    t0 = time.perf_counter()
    with cell.window():                     # partitioned, pre-removal:
        wrote_during = quorum_write()       # 2 of 3 is still a quorum
    removed = cell.wait_for(
        lambda: victim_addr not in (leader().store.server_members()
                                    if leader() else [victim_addr]),
        timeout_s=45)
    cell.check(invariants.check(
        "partitioned_member_removed", removed,
        detect_s=round(time.perf_counter() - t0, 1)))
    with cell.window():                     # shrunken cluster
        wrote_after = quorum_write()
    cell.check(invariants.check("quorum_writes_survive",
                                wrote_during and wrote_after))

    # heal: the victim answers probes again (its process never died)
    cell.injector.heal_partition()
    lead_final = leader()
    alive = lead_final is not None and \
        lead_final.swim.probe_for_peer(victim_addr)
    cell.check(invariants.check("victim_process_survived_partition",
                                alive))


# -- cluster-cell helpers ---------------------------------------------

def _mk_ring(cell: Cell, n: int = 3, **cfg):
    """An n-server raft ring, on the cell's device, with the distributed
    scheduler plane on: no local workers anywhere (num_schedulers=0), so
    every placement must flow follower-dequeue -> local schedule ->
    Plan.Submit -> leader group-commit. Returns (servers, rpcs,
    addrs)."""
    from ..rpc import RpcServer
    servers, rpcs = [], []
    for _ in range(n):
        srv = cell.server(start=False, num_schedulers=0,
                          heartbeat_ttl_s=300.0,
                          dead_server_cleanup_s=0.0, **cfg)
        rpc = RpcServer(srv, port=0)
        servers.append(srv)
        rpcs.append(rpc)
        cell.track(rpc)
    addrs = [r.addr for r in rpcs]
    for srv, rpc in zip(servers, rpcs):
        srv.attach_raft(rpc, addrs)
        rpc.start()
        srv.start()
    return servers, rpcs, addrs


def _ring_leader(servers):
    live = [s for s in servers
            if not getattr(s, "_shutdown", False)
            and s.raft.is_leader()]
    return live[0] if len(live) == 1 else None


def _ring_formed(cell: Cell, servers) -> bool:
    return cell.wait_for(
        lambda: _ring_leader(servers) is not None
        and len(_ring_leader(servers).store.server_members() or [])
        == len(servers), timeout_s=30)


def _applied_index(srv) -> int:
    return srv.raft._handle_status({})["applied_index"]


def _extra_nodes(cell: Cell, n: int, salt: int, dc: str):
    """A LATER batch of seeded nodes with ids disjoint from every
    other batch: _mk_nodes replays the cell seed's id stream from the
    start, so calling it twice re-issues the same node ids — which
    re-registers (mutates) existing nodes instead of adding capacity."""
    from ..mock import fixtures as mock
    from ..mock import seeded_mock_ids
    out = []
    with seeded_mock_ids(cell.seed ^ salt):
        for i in range(n):
            node = mock.node()
            node.name = f"cnode-{dc}-{salt:x}-{i}"
            node.datacenter = dc
            node.compute_class()
            out.append(node)
    return out


# -- cell 8 (cluster): follower scheduling over a lagging fence -------

def _run_follower_fence(cell: Cell) -> None:
    """The snapshot-fence contract under replication lag. One follower
    (the victim) is the ONLY scheduler in the ring; its local MVCC
    store is the snapshot every plan is built on. Three phases:
    healthy baseline; replication lagged so a new eval's fence blocks
    (and unblocks on heal with a passing verify); and two evals
    admitted BEFORE the lag planned against the frozen snapshot, whose
    conflicting placements the leader's group-commit verify must
    demote — never commit — with full recovery after the heal."""
    servers, rpcs, addrs = _mk_ring(
        cell, follower_fence_timeout_s=8.0, follower_max_remote=2)
    cell.check(invariants.check("cluster_formed",
                                _ring_formed(cell, servers)))
    lead = _ring_leader(servers)
    followers = [s for s in servers if s is not lead]
    victim, other = followers[0], followers[1]
    victim_addr = victim.raft.self_addr
    # the victim must be the sole scheduler: park the other follower's
    # remote workers and let any in-flight remote dequeue poll drain
    other.follower_sched.set_pause(True)
    time.sleep(3.0)

    nodes = _mk_nodes(cell, 8)
    _register_nodes(lead, nodes)

    # phase 1: healthy baseline through the remote plane
    job_a = _svc_job(cell, "chaos-fence-a", 8, cpu=300)
    with cell.window():
        if not _settle(cell, lead, job_a):
            cell.check(invariants.check("fence_baseline_settled",
                                        False, job=job_a.id))
    cell.check(invariants.check(
        "placements_flowed_remote",
        lead.eval_leases.stats["remote_plans"] >= 1,
        **lead.eval_leases.snapshot_stats()))

    # phase 2: lag the victim's replication; a NEW eval's
    # modify_index now sits past the victim's applied index, so its
    # fence must BLOCK (lease held, nothing placed), then pass verify
    # once the heal lets the store catch up
    cell.injector.lag_replication({victim_addr})
    job_d = _svc_job(cell, "chaos-fence-d", 4, cpu=300)
    lead.register_job(job_d)
    leased = cell.wait_for(
        lambda: lead.eval_leases.outstanding() >= 1, timeout_s=10)
    blocked = len(_live(lead.store, job_d)) == 0
    cell.check(invariants.check("fence_blocked_while_lagged",
                                leased and blocked, leased=leased,
                                placed_while_lagged=not blocked))
    time.sleep(0.8)          # hold the fence long enough to measure
    cell.injector.heal_replication()
    with cell.window():
        t0 = time.perf_counter()
        ok = cell.wait_for(
            lambda: len({a.name for a in _live(lead.store, job_d)})
            >= 4, timeout_s=20)
        cell.note_latency(time.perf_counter() - t0,
                          placements=4 if ok else 0)
    cell.check(invariants.check("fence_released_on_heal", ok))
    cell.check(invariants.check(
        "fence_wait_observed",
        victim.follower_sched.fence_wait_p99_ms() >= 50.0,
        fence_wait_p99_ms=victim.follower_sched.fence_wait_p99_ms()))

    # phase 3: stale-plan demotion. Two evals are admitted while the
    # victim's workers are parked, the victim catches up PAST both,
    # then replication lags — both fences pass against the frozen
    # snapshot, both plans are built blind to each other on an
    # exactly-8-slot capacity domain (2 nodes x 4 asks), and the
    # leader's verify must demote the conflicting placements
    dc2 = _extra_nodes(cell, 2, 0x9E37, "dc2")
    _register_nodes(lead, dc2)
    victim.follower_sched.set_pause(True)
    time.sleep(3.0)
    job_c = _svc_job(cell, "chaos-fence-c", 4, cpu=900, dcs=1)
    job_b = _svc_job(cell, "chaos-fence-b", 8, cpu=900, dcs=1)
    for j in (job_c, job_b):
        j.datacenters = ["dc2"]
        j.canonicalize()
        lead.register_job(j)
    caught_up = cell.wait_for(
        lambda: _applied_index(victim) >= _applied_index(lead),
        timeout_s=15)
    cell.check(invariants.check("victim_caught_up_before_lag",
                                caught_up))
    cell.injector.lag_replication({victim_addr})
    victim.follower_sched.set_pause(False)
    demoted = cell.wait_for(
        lambda: lead.eval_leases.stats["remote_demotions"] >= 1,
        timeout_s=20, interval_s=0.02)
    cell.injector.heal_replication()
    cell.check(invariants.check(
        "stale_plan_demoted_not_committed", demoted,
        remote_demotions=lead.eval_leases.stats["remote_demotions"]))
    # post-heal recovery: extra capacity wakes whatever the demotion
    # reblocked; every slot must settle exactly once
    more = _extra_nodes(cell, 2, 0x51ED, "dc2")
    _register_nodes(lead, more)
    jobs = [job_a, job_d, job_c, job_b]
    with cell.window():
        t0 = time.perf_counter()
        ok = cell.wait_for(
            lambda: all(
                len({a.name for a in _live(lead.store, j)})
                >= sum(tg.count for tg in j.task_groups)
                for j in jobs), timeout_s=40)
        cell.note_latency(time.perf_counter() - t0,
                          placements=12 if ok else 0)
    cell.check(invariants.check("recovered_after_heal", ok))
    cell.check(invariants.alloc_intent(lead.store, _intent(jobs)))
    # the last remote ack races the settle; drain before the check
    cell.wait_for(lambda: lead.eval_broker.stats.as_dict()["unacked"]
                  == 0, timeout_s=10)
    cell.check(invariants.blocked_evals_drained(lead))
    cell.metrics["remote_demotions"] = \
        lead.eval_leases.stats["remote_demotions"]
    cell.metrics["fence_wait_p99_ms"] = \
        victim.follower_sched.fence_wait_p99_ms()


# -- cell 9 (cluster): leader killed mid-group-commit -----------------

def _run_leader_failover_commit(cell: Cell) -> None:
    """Leadership transfer at the worst instant: the leader dies right
    after dispatching a remote plan's group-commit raft entry —
    before the quorum ack, before the eval ack, with the follower's
    Plan.Submit RPC still in flight. Both races must converge: if the
    entry reached a majority the new leader carries the placements and
    the restored eval's replan is a no-op; if it was lost, the replan
    places from scratch. Either way the intent holds with no lost or
    duplicated alloc, and no plan commits twice."""
    servers, rpcs, addrs = _mk_ring(cell, follower_max_remote=2)
    cell.check(invariants.check("cluster_formed",
                                _ring_formed(cell, servers)))
    lead = _ring_leader(servers)
    nodes = _mk_nodes(cell, 12)
    _register_nodes(lead, nodes)

    job_a = _svc_job(cell, "chaos-failover-a", 8, cpu=300)
    with cell.window():
        if not _settle(cell, lead, job_a):
            cell.check(invariants.check("failover_baseline_settled",
                                        False, job=job_a.id))

    # arm the tripwire, then drive one more remote plan through the
    # applier; the hook fires on the applier thread the instant the
    # group's raft entry is dispatched, and THIS thread does the kill
    cell.injector.trip_on_group_commit(nth=1)
    job_b = _svc_job(cell, "chaos-failover-b", 8, cpu=300)
    t0 = time.perf_counter()
    lead.register_job(job_b)
    tripped = cell.injector.group_commit_tripped.wait(timeout=25)
    cell.check(invariants.check(
        "group_commit_tripped", tripped,
        tripped_index=cell.injector.tripped_group_index))
    old = lead
    old_rpc = rpcs[servers.index(old)]
    old_rpc.shutdown()
    old.shutdown()
    cell.release(old_rpc)
    cell.injector.record("leader_killed", addr=old.raft.self_addr,
                         at_group_index=cell.injector.
                         tripped_group_index)

    survivors = [s for s in servers if s is not old]
    elected = cell.wait_for(
        lambda: _ring_leader(survivors) is not None, timeout_s=30)
    cell.check(invariants.check("new_leader_elected", elected))
    new_lead = _ring_leader(survivors)
    with cell.window():
        ok = cell.wait_for(
            lambda: len({a.name
                         for a in _live(new_lead.store, job_b)})
            >= 8, timeout_s=60)
        cell.note_latency(time.perf_counter() - t0,
                          placements=8 if ok else 0)
    cell.check(invariants.check("workload_settled_after_failover",
                                ok))
    cell.check(invariants.alloc_intent(new_lead.store,
                                       _intent([job_a, job_b])))
    # did the in-flight entry survive the kill? Both outcomes are
    # legal; record which race this run exercised
    cell.metrics["tripped_group_index"] = \
        cell.injector.tripped_group_index
    cell.metrics["inflight_entry_survived"] = int(
        _applied_index(new_lead) >= cell.injector.tripped_group_index
        > 0)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in [
    Scenario(
        name="system_fanout",
        title="System-job fan-out under dropped heartbeats",
        description="system job on every feasible node, cross-checked "
                    "against the SystemScheduler contract; a victim "
                    "set's heartbeats are dropped in transit",
        run=_run_system_fanout),
    Scenario(
        name="spread_antiaffinity",
        title="Spread/rack-anti-affinity multi-DC topology",
        description="4-DC, 8-rack fleet; spread + anti-affinity "
                    "waves with a forced governor reclaim mid-wave; "
                    "per-node p99 hot-spot bound",
        run=_run_spread_antiaffinity),
    Scenario(
        name="batch_backfill",
        title="Batch backfill behind service traffic, worker killed "
              "mid-commit",
        description="service wave, then batch backfill; one worker "
                    "dies after its plan committed but before the "
                    "eval ack — no plan may commit twice",
        run=_run_batch_backfill),
    Scenario(
        name="drain_storm",
        title="Node-drain storm + rolling upgrade over a corrupted "
              "WAL tail",
        description="a third of the fleet drains, the server "
                    "restarts over a corrupted WAL tail, recovery "
                    "reconciles to intent",
        run=_run_drain_storm),
    Scenario(
        name="client_failure_burst",
        title="Mass client failure -> reschedule burst",
        description="the most-loaded third of the fleet stops "
                    "heartbeating at once; every alloc must land "
                    "exactly once on the survivors",
        run=_run_client_failure_burst),
    Scenario(
        name="blocked_herd",
        title="Blocked-eval thundering herd",
        description="4x overload parks a herd of blocked evals; a "
                    "capacity burst wakes them all at once",
        run=_run_blocked_herd),
    Scenario(
        name="swim_partition",
        title="SWIM-layer partition of a raft follower",
        description="3-server cluster; probes to a victim fail at "
                    "the SWIM layer while its process stays up — "
                    "detection, removal, quorum writes, heal",
        run=_run_swim_partition, quick=False, cluster=True),
    Scenario(
        name="follower_fence",
        title="Follower scheduling over a lagging snapshot fence",
        description="3-server ring, one follower is the sole "
                    "scheduler; its replication lags — new evals "
                    "fence-block until heal, stale plans are demoted "
                    "by leader verify, never committed",
        run=_run_follower_fence, quick=False, cluster=True),
    Scenario(
        name="leader_failover_commit",
        title="Leader killed mid-group-commit",
        description="the leader dies the instant a remote plan's "
                    "group raft entry is dispatched; the new leader "
                    "restores the broker from the store and the "
                    "intent settles with no lost or duplicated alloc",
        run=_run_leader_failover_commit, quick=False, cluster=True),
]}
