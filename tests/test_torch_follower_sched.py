"""The reference's distributed scheduler plane suite
(tests/test_follower_sched.py): followers dequeue evals from the
leader's broker over RPC, schedule against fenced local MVCC snapshots
on their own device, and stream plans back through Plan.Submit into the
leader's group-commit applier — against the port's Server on the CPU,
assertions unchanged: remote_flow, scheduler_plane_status and
parity_quick, with parity_200_seeds `slow` as in the reference.

Through the port's fault injector (chaos/), on the CPU: the two fence
tests (a replication-lagged follower blocks then heals; a fence timeout
nacks) and the two chaos cells (leader failover mid-commit, the lagging
follower; `slow` as in the reference). The port's own
test_every_ring_hook_point_fires checks that the ring's chaos hook
points fire.

The ring fixture also asserts CLEAN teardown: no ERROR-level log
records (tracebacks) may be produced by the plane across the module —
staggered shutdown must ride the RpcRefused / quiet-nack paths, not
LOG.exception. SWIM SUSPECT chatter is WARNING-level and allowed.
"""

import logging
import random
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from nomad_tpu_torch.mock import fixtures as mf
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.rpc.codec import RpcError
from nomad_tpu_torch.server import Server as _Server, ServerConfig


def Server(config=None):
    """The port's Server on the CPU."""
    return _Server(config, device="cpu")


def _wait(pred, timeout=30.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _node(name, dc="dc1"):
    node = mf.node()
    node.name = name
    node.datacenter = dc
    node.compute_class()
    return node


def _job(job_id, count=2, cpu=100):
    job = mf.job()
    job.id = job_id
    job.datacenters = ["dc1"]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.cpu = cpu
        t.resources.memory_mb = 32
    return job


def _live_names(store, job_id, ns="default"):
    return sorted(a.name for a in store.allocs_by_job(ns, job_id)
                  if not a.terminal_status())


class _ErrorTrap(logging.Handler):
    """Collects ERROR+ records for the teardown-cleanliness assert."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))


class Ring:
    def __init__(self):
        self.servers = []
        self.rpcs = []
        for _ in range(3):
            s = Server(ServerConfig(num_schedulers=1,
                                    heartbeat_ttl_s=300.0,
                                    dead_server_cleanup_s=0.0,
                                    follower_max_remote=2))
            r = RpcServer(s, port=0)
            self.servers.append(s)
            self.rpcs.append(r)
        addrs = [r.addr for r in self.rpcs]
        for s, r in zip(self.servers, self.rpcs):
            s.attach_raft(r, addrs)
            r.start()
            s.start()
        assert _wait(lambda: sum(
            s.raft.is_leader() for s in self.servers) == 1), \
            "ring never elected a leader"
        assert _wait(lambda: len(
            self.leader().store.server_members()) == 3), \
            "membership never converged"

    def leader(self):
        # tolerate a mid-run election (1-core CI can starve heartbeats
        # long enough to trigger one): wait for the new leader
        assert _wait(lambda: any(
            s.raft.is_leader() for s in self.servers), 15.0), \
            "ring has no leader"
        return next(s for s in self.servers if s.raft.is_leader())

    def register(self, job):
        """Register through the current leader, rehoming on a
        leadership move — what any real client does."""
        deadline = time.monotonic() + 30.0
        while True:
            try:
                self.leader().register_job(job)
                return
            except (RuntimeError, RpcError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def followers(self):
        return [s for s in self.servers if not s.raft.is_leader()]

    def pause(self, paused):
        for s in self.servers:
            for w in s.workers:
                w.set_pause(paused)
            if s.follower_sched is not None:
                s.follower_sched.set_pause(paused)
        if paused:
            # parked remote dequeues poll-bound out before the next
            # wave registers, so no worker holds a pre-pause lease
            time.sleep(1.2)

    def settle(self, jobs, timeout=60.0):
        # re-resolve the leader inside the predicate: a mid-settle
        # election must not pin reads to the deposed server
        if _wait(lambda: all(
                len(_live_names(self.leader().store, j.id)) ==
                j.task_groups[0].count for j in jobs), timeout):
            return
        lead = self.leader()
        lines = ["workload never fully placed"]
        for j in jobs:
            lines.append(f"  job {j.id} count {j.task_groups[0].count} "
                         f"live {_live_names(lead.store, j.id)}")
        lines.append(f"  broker {lead.eval_broker.stats.as_dict()}")
        lines.append(f"  leases {lead.eval_leases.snapshot_stats()}")
        for e in lead.store.evals():
            if e.job_id in {j.id for j in jobs}:
                lines.append(f"  eval {e.id[:8]} {e.job_id} {e.status} "
                             f"{e.triggered_by}")
        raise AssertionError("\n".join(lines))

    def teardown(self):
        for s, r in zip(self.servers, self.rpcs):
            try:
                r.shutdown()
                s.shutdown()
            except Exception:
                pass


@pytest.fixture(scope="module")
def trap():
    handler = _ErrorTrap()
    logging.getLogger("nomad_tpu").addHandler(handler)
    try:
        yield handler
    finally:
        logging.getLogger("nomad_tpu").removeHandler(handler)
        assert not handler.records, (
            "scheduler plane produced ERROR-level records "
            "(teardown must be traceback-clean):\n"
            + "\n".join(handler.records[:10]))


@pytest.fixture(scope="module")
def ring(trap):
    r = Ring()
    lead = r.leader()
    for i in range(8):
        lead.register_node(_node(f"fsn-{i}"))
    try:
        yield r
    finally:
        r.teardown()
        # teardown noise surfaces via the module-scoped trap above


def test_remote_flow_places_and_drains(ring):
    lead = ring.leader()
    base = dict(lead.eval_leases.snapshot_stats())
    ring.pause(True)
    jobs = [_job(f"flow-{i}", count=2, cpu=50) for i in range(6)]
    for j in jobs:
        ring.register(j)
    ring.pause(False)
    ring.settle(jobs)
    stats = lead.eval_leases.snapshot_stats()
    assert stats["remote_dequeues"] > base["remote_dequeues"], \
        "followers never dequeued remotely"
    assert stats["remote_plans"] > base["remote_plans"], \
        "followers never submitted a plan"
    # every lease returns: the broker drains to zero unacked
    assert _wait(lambda: lead.eval_broker.stats.as_dict()["unacked"]
                 == 0, 15.0), "broker never drained"
    assert _wait(lambda: lead.eval_leases.outstanding() == 0, 15.0), \
        "leases never released"


def test_scheduler_plane_status_members(ring):
    lead = ring.leader()
    status = lead.scheduler_plane_status()
    assert status["enabled"] is True
    rows = status["members"]
    assert len(rows) == 3
    roles = sorted(r["role"] for r in rows)
    assert roles == ["follower", "follower", "leader"]
    for r in rows:
        assert isinstance(r["applied_index"], int)
        assert isinstance(r["fence_lag"], int)
        assert r["leased_evals"] >= 0
    # a follower reports its own plane counters too
    fol = ring.followers()[0]
    fstat = fol.scheduler_plane_status()
    assert fstat["follower"] is not None
    assert "fence_wait_p99_ms" in fstat["follower"]


def test_fence_blocks_lagged_follower_then_heals(ring):
    from nomad_tpu_torch.chaos.faults import FaultInjector
    lead = ring.leader()
    victim = ring.followers()[0]
    other = ring.followers()[1]
    vaddr = victim.raft.self_addr
    # only the victim may schedule: leader + other follower paused
    for w in lead.workers:
        w.set_pause(True)
    other.follower_sched.set_pause(True)
    time.sleep(1.2)     # their parked dequeues poll-bound out
    try:
        with FaultInjector(seed=3) as inj:
            inj.lag_replication({vaddr})
            job = _job("fence-heal", count=2)
            ring.register(job)
            # the victim dequeues but its snapshot fence cannot pass:
            # nothing places while the lag holds
            assert _wait(lambda: lead.eval_leases.outstanding() >= 1,
                         10.0), "victim never leased the eval"
            time.sleep(0.6)
            assert _live_names(lead.store, job.id) == [], \
                "fence let a lagging snapshot schedule"
            inj.heal_replication()
            ring.settle([job], timeout=30.0)
        # the plan came from the victim and passed leader verify
        assert victim.follower_sched.snapshot_stats()[
            "remote_plans"] >= 1
    finally:
        for w in lead.workers:
            w.set_pause(False)
        other.follower_sched.set_pause(False)


def test_fence_timeout_nacks_not_drops(ring):
    from nomad_tpu_torch.chaos.faults import FaultInjector
    lead = ring.leader()
    victim = ring.followers()[0]
    other = ring.followers()[1]
    vaddr = victim.raft.self_addr
    for w in lead.workers:
        w.set_pause(True)
    other.follower_sched.set_pause(True)
    time.sleep(1.2)
    saved = [w.fence_timeout_s for w in victim.follower_sched.workers]
    for w in victim.follower_sched.workers:
        w.fence_timeout_s = 0.3
    base_timeouts = sum(w.stats["fence_timeouts"]
                        for w in victim.follower_sched.workers)
    try:
        with FaultInjector(seed=4) as inj:
            inj.lag_replication({vaddr})
            job = _job("fence-timeout", count=2)
            ring.register(job)
            # the fence times out and the eval is NACKED back to the
            # broker — counted, not dropped
            assert _wait(lambda: sum(
                w.stats["fence_timeouts"]
                for w in victim.follower_sched.workers)
                > base_timeouts, 15.0), "fence timeout never fired"
            inj.heal_replication()
            # the nacked eval is redelivered and lands post-heal
            ring.settle([job], timeout=30.0)
    finally:
        for w, s in zip(victim.follower_sched.workers, saved):
            w.fence_timeout_s = s
        for w in lead.workers:
            w.set_pause(False)
        other.follower_sched.set_pause(False)


def test_every_ring_hook_point_fires(ring):
    """The chaos hook points of the ring's path fire in the port: with
    a follower's replication lagged, raft.replicate drops its round
    trips and raft.election suppresses its campaign; a remote plan's
    commit fires worker.plan_committed (the remote lane) and the
    leader's applier plan.group_commit; SWIM's probes fire swim.probe
    and a beat fires server.heartbeat. Interposers that return None
    change nothing."""
    from collections import Counter
    from nomad_tpu_torch.chaos.faults import FaultInjector
    lead = ring.leader()
    victim, other = ring.followers()
    vaddr = victim.raft.self_addr
    calls = Counter()

    def counting(point):
        def note(**_kw):
            calls[point] += 1
        return note

    for w in lead.workers:
        w.set_pause(True)
    victim.follower_sched.set_pause(True)
    time.sleep(1.2)
    try:
        with FaultInjector(seed=6) as inj:
            for point in ("worker.plan_committed", "plan.group_commit",
                          "swim.probe", "server.heartbeat"):
                inj._interposers[point] = counting(point)
            inj.lag_replication({vaddr})
            job = _job("hooks-remote", count=2)
            ring.register(job)
            ring.settle([job], timeout=30.0)
            node = lead.store.nodes()[0]
            lead.heartbeat(node.id)
            assert _wait(lambda: any(
                e["kind"] == "election_suppressed" and e["addr"] == vaddr
                for e in inj.events), 20.0), "raft.election never fired"
            assert _wait(lambda: calls["swim.probe"] > 0, 10.0)
            inj.heal_replication()
        assert inj.dropped_replications > 0
        assert calls["worker.plan_committed"] >= 1, calls
        assert calls["plan.group_commit"] >= 1, calls
        assert calls["server.heartbeat"] == 1, calls
        assert other.follower_sched.snapshot_stats()["remote_plans"] >= 1
        # the healed victim catches up: nothing was lost, only delayed
        assert _wait(lambda: victim.store.job_by_id("default", job.id)
                     is not None, 15.0)
    finally:
        for w in lead.workers:
            w.set_pause(False)
        victim.follower_sched.set_pause(False)


def test_healed_victim_hears_the_leader_before_its_deadline(ring):
    """raft.election is asked CHAOS_HOLD_S before a lagged victim's
    election deadline, not at it: a deadline that would lapse between
    the heal and the leader's next heartbeat is pushed a full timeout out
    while the lag lasts, so the healed victim does not campaign and the
    leader keeps its term."""
    from nomad_tpu_torch.chaos.faults import FaultInjector
    from nomad_tpu_torch.server.raft import CHAOS_HOLD_S, HEARTBEAT_S
    lead = ring.leader()
    victim, _other = ring.followers()
    term = lead.raft.term
    with FaultInjector(seed=7) as inj:
        inj.lag_replication({victim.raft.self_addr})
        time.sleep(3 * HEARTBEAT_S)
        # a deadline 0.9 CHAOS_HOLD_S away, and three ticks before it:
        # the hook pushes it out before it lapses
        victim.raft._election_deadline = (time.monotonic()
                                          + 0.9 * CHAOS_HOLD_S)
        time.sleep(0.75 * CHAOS_HOLD_S)
        assert victim.raft._election_deadline \
            > time.monotonic() + CHAOS_HOLD_S
        inj.heal_replication()
        assert any(e["kind"] == "election_suppressed" for e in inj.events)
    time.sleep(1.5)
    assert ring.leader() is lead and lead.raft.term == term
    assert victim.raft.term == term


# -- scheduler parity: 3-server plane vs single dev server ------------

def _seeded_jobs(seed, prefix):
    rng = random.Random(0x5EED ^ seed)
    jobs = []
    for i in range(rng.randint(2, 4)):
        jobs.append(_job(f"{prefix}-{i}",
                         count=rng.randint(1, 3),
                         cpu=rng.choice([50, 100])))
    return jobs


def _manifest(store, prefix):
    return {k: v for k, v in store.scheduler_parity_manifest().items()
            if k.startswith(f"default/{prefix}")}


def _run_parity(ring, single, seeds, tag):
    for seed in seeds:
        prefix = f"par{tag}-{seed}"
        jobs = _seeded_jobs(seed, prefix)
        for j in jobs:
            ring.register(j)
        for j in _seeded_jobs(seed, prefix):
            single.register_job(j)
        ring.settle(jobs)
        assert _wait(lambda: all(
            len(_live_names(single.store, j.id)) ==
            j.task_groups[0].count for j in jobs), 60.0), \
            f"single-server arm stuck on seed {seed}"
        got = _manifest(ring.leader().store, prefix)
        want = _manifest(single.store, prefix)
        assert got == want, (
            f"parity diverged on seed {seed}:\n"
            f"  plane : {got}\n  single: {want}")


@pytest.fixture(scope="module")
def single():
    srv = Server(ServerConfig(num_schedulers=1,
                              heartbeat_ttl_s=300.0))
    srv.start()
    for i in range(100):
        srv.register_node(_node(f"psn-{i}"))
    try:
        yield srv
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def parity_nodes(ring):
    lead = ring.leader()
    for i in range(100):
        lead.register_node(_node(f"prn-{i}"))
    return ring


def test_parity_quick(parity_nodes, single):
    _run_parity(parity_nodes, single, range(5), "q")


@pytest.mark.slow
def test_parity_200_seeds(parity_nodes, single):
    _run_parity(parity_nodes, single, range(5, 205), "s")


# -- the port's own -------------------------------------------------------

def test_remote_dequeue_names_the_jobs_latest_alloc_index():
    """Eval.Dequeue answers with a wait index (nomad/eval_endpoint.go
    getWaitIndex): the eval's modify index, or the highest modify index
    of its job's allocs when that is later — a re-delivered eval's job
    may hold allocs committed after the eval, which a lagging follower
    must read before it schedules."""
    from nomad_tpu_torch.models import Evaluation
    from nomad_tpu_torch.server.follower_sched import rpc_handlers

    srv = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=300.0))
    try:
        srv.establish_leadership()
        job = _job("wait-idx", count=2)
        srv.register_job(job)
        ev = srv.store.evals_by_job("default", job.id)[0]
        alloc = mf.alloc()
        alloc.job = srv.store.job_by_id("default", job.id)
        alloc.job_id = job.id
        srv.store.upsert_allocs(srv.store.latest_index() + 5, [alloc])
        later = srv.store.alloc_by_id(alloc.id).modify_index
        assert later > ev.modify_index
        res = rpc_handlers(srv)["Eval.Dequeue"](
            {"schedulers": ["service"], "timeout_s": 1.0,
             "follower": "f:1"})
        assert res["eval"]["id"] == ev.id
        assert res["wait_index"] == later
        # an eval whose job has no later alloc waits for itself
        other = Evaluation(namespace="default", job_id="no-allocs",
                           type="service", priority=50)
        other.modify_index = 7
        from nomad_tpu_torch.server.follower_sched import wait_index
        assert wait_index(srv.store, other) == 7
    finally:
        srv.shutdown()


def test_worker_fences_on_the_remote_wait_index():
    """A worker whose store is behind the dequeue's wait index waits for
    it and, at its fence timeout, nacks the eval (never schedules from
    the past, never drops the eval)."""
    from nomad_tpu_torch.models import Evaluation
    from nomad_tpu_torch.server.worker import Worker

    srv = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=300.0))
    nacked = []

    class _Broker:
        def ack(self, eval_id, token):
            raise AssertionError("acked an eval read from the past")

        def nack(self, eval_id, token):
            nacked.append(eval_id)

    try:
        w = Worker(srv, ["service"], wid=0)
        w.broker = _Broker()
        w.fence_timeout_s = 0.2
        ev = Evaluation(namespace="default", job_id="fence", type="service",
                        priority=50)
        ev.modify_index = 1
        ev.wait_index = srv.store.latest_index() + 50
        w.process_eval(ev, "token")
        assert w.stats["fence_timeouts"] == 1
        assert nacked == [ev.id]
    finally:
        srv.shutdown()


def test_a_lease_does_not_expire_while_its_plan_is_in_flight():
    """Plan.Submit pauses the eval's lease (Nomad's PauseNackTimeout): a
    lease past its deadline is not swept while the plan is applying,
    and runs a full term again once the plan's outcome is known."""
    from nomad_tpu_torch.server.follower_sched import EvalLeaseTable

    nacked = []

    class _Broker:
        def nack(self, eval_id, token, delay_s=None):
            nacked.append(eval_id)

    class _Srv:
        eval_broker = _Broker()

    leases = EvalLeaseTable(_Srv())
    try:
        leases.grant("e1", "t1", follower="f:1", lease_s=0.5)
        leases.grant("e2", "t2", follower="f:1", lease_s=0.5)
        leases.pause("e1", "t1")
        leases.pause("e2", "stale-token")       # not this delivery's
        time.sleep(1.2)                          # both past deadline
        assert nacked == ["e2"]
        assert leases.outstanding() == 1
        leases.resume("e1", "t1", lease_s=0.5)
        assert _wait(lambda: nacked == ["e2", "e1"], 5.0)
        assert leases.snapshot_stats()["expired"] == 2
    finally:
        leases.stop()


# -- the chaos cells (slow: each builds its own ring) -----------------

@pytest.mark.slow
def test_chaos_cell_leader_failover_commit(trap):
    from nomad_tpu_torch.chaos.matrix import run_cell
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    base = len(trap.records)
    cell = run_cell(SCENARIOS["leader_failover_commit"], quick=True,
                    device="cpu")
    # a killed leader mid-commit legitimately logs; the teardown trap
    # judges the plane's OWN ring, not a chaos cell's murdered one
    del trap.records[base:]
    assert cell["pass"], cell.get("invariants_failed") or cell
    by_name = {c["name"]: c for c in cell["invariants"]}
    assert by_name["group_commit_tripped"]["pass"]
    assert by_name["new_leader_elected"]["pass"]
    assert by_name["workload_settled_after_failover"]["pass"]
    assert by_name["no_lost_or_duplicated_alloc"]["pass"]
    # both races are legal; the run must record which one it was
    assert cell["tripped_group_index"] > 0
    assert cell["inflight_entry_survived"] in (0, 1)


@pytest.mark.slow
def test_chaos_cell_follower_fence(trap):
    from nomad_tpu_torch.chaos.matrix import run_cell
    from nomad_tpu_torch.chaos.scenarios import SCENARIOS
    base = len(trap.records)
    cell = run_cell(SCENARIOS["follower_fence"], quick=True,
                    device="cpu")
    del trap.records[base:]
    assert cell["pass"], cell.get("invariants_failed") or cell
    by_name = {c["name"]: c for c in cell["invariants"]}
    assert by_name["fence_blocked_while_lagged"]["pass"]
    assert by_name["stale_plan_demoted_not_committed"]["pass"]
    assert by_name["recovered_after_heal"]["pass"]
    assert by_name["no_lost_or_duplicated_alloc"]["pass"]
    assert cell["remote_demotions"] >= 1
    assert cell["fence_wait_p99_ms"] >= 50.0
