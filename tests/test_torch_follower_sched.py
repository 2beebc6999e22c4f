"""The reference's distributed scheduler plane suite
(tests/test_follower_sched.py): followers dequeue evals from the
leader's broker over RPC, schedule against fenced local MVCC snapshots
on their own device, and stream plans back through Plan.Submit into the
leader's group-commit applier — against the port's Server on the CPU,
assertions unchanged: remote_flow, scheduler_plane_status and
parity_quick, with parity_200_seeds `slow` as in the reference.

Left out, waiting for the fault injector (chaos/): the two fence tests
(a replication-lagged follower blocks then heals; a fence timeout nacks)
and the two chaos cells (leader failover mid-commit, the lagging
follower).

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
