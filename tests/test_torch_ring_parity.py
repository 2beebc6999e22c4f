"""The port's multi-server plane against the JAX package's, on the CPU.

- Scheduling: the port's 3-server ring (raft, remote dequeues, follower
  plans through Plan.Submit, the leader's group-commit applier) at 100
  nodes lands the same `scheduler_parity_manifest()` (per job, the live
  alloc names) as the JAX package's single dev server on the same seeded
  jobs, seeds 0-4, as tests/test_follower_sched.py's `_seeded_jobs` makes
  them. The leader's own worker is paused while the jobs register, so
  the followers schedule them.
- The wire: a port RpcClient calls the JAX package's RpcServer and the
  JAX package's RpcClient calls the port's (`Status.Ping`,
  `Node.Register`), and the two packages' frame codecs write
  byte-identical frames for the same seeded messages.
- The log: a port follower's `Raft.AppendEntries` handler, called over
  the wire by the JAX package's RpcClient, takes the entries the JAX
  package's leader logged (its registers, ingest batches, eval updates
  and plan groups), and its FSM applier reaches a store equal to that
  leader's: jobs, allocs by id with their node and statuses, eval
  statuses, and the index.

The JAX servers run as the JAX package's own tests run them
(JAX_PLATFORMS=cpu); the port's with device="cpu".
"""

import random
import socket
import threading
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)


def _wait(pred, timeout=60.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _node(mf, name, dc="dc1"):
    node = mf.node()
    node.name = name
    node.datacenter = dc
    node.compute_class()
    return node


def _job(mf, job_id, count=2, cpu=100):
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


def _seeded_jobs(mf, seed, prefix):
    rng = random.Random(0x5EED ^ seed)
    jobs = []
    for i in range(rng.randint(2, 4)):
        jobs.append(_job(mf, f"{prefix}-{i}",
                         count=rng.randint(1, 3),
                         cpu=rng.choice([50, 100])))
    return jobs


def _live(store, job_id):
    return [a for a in store.allocs_by_job("default", job_id)
            if not a.terminal_status()]


def _jax():
    from nomad_tpu.mock import fixtures as jmf
    from nomad_tpu.rpc import RpcClient, RpcServer
    from nomad_tpu.server import Server, ServerConfig
    return jmf, RpcClient, RpcServer, Server, ServerConfig


def _jax_server(**kw):
    _jmf, _C, _R, Server, ServerConfig = _jax()
    return Server(ServerConfig(heartbeat_ttl_s=300.0,
                               telemetry_sample_interval_s=0,
                               governor_interval_s=3600.0, **kw))


# -- scheduling: the port's ring against the JAX package's dev server --
def test_port_ring_lands_the_jax_single_servers_manifest(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from nomad_tpu_torch.mock import fixtures as mf
    from nomad_tpu_torch.rpc import RpcServer
    from nomad_tpu_torch.server import Server, ServerConfig
    jmf = _jax()[0]
    single = _jax_server(num_schedulers=1)
    single.start()
    servers, rpcs = [], []
    try:
        for i in range(100):
            single.register_node(_node(jmf, f"psn-{i}"))
        for _ in range(3):
            s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl_s=300.0,
                                    dead_server_cleanup_s=0.0,
                                    follower_max_remote=2), device="cpu")
            servers.append(s)
            rpcs.append(RpcServer(s, port=0))
        addrs = [r.addr for r in rpcs]
        for s, r in zip(servers, rpcs):
            s.attach_raft(r, addrs)
            r.start()
            s.start()

        def leader():
            assert _wait(lambda: sum(s.raft.is_leader()
                                     for s in servers) == 1, 15.0)
            return next(s for s in servers if s.raft.is_leader())

        for i in range(100):
            leader().register_node(_node(mf, f"prn-{i}"))
        assert _wait(lambda: all(len(s.store.nodes()) == 100
                                 for s in servers))
        for seed in range(5):
            prefix = f"ring-{seed}"
            jobs = _seeded_jobs(mf, seed, prefix)
            lead = leader()
            for w in lead.workers:
                w.set_pause(True)
            try:
                for j in jobs:
                    lead.register_job(j)
                assert _wait(lambda: all(
                    len(_live(leader().store, j.id)) ==
                    j.task_groups[0].count for j in jobs)), \
                    f"ring stuck on seed {seed}"
            finally:
                for w in lead.workers:
                    w.set_pause(False)
            for j in _seeded_jobs(jmf, seed, prefix):
                single.register_job(j)
            assert _wait(lambda: all(
                len(_live(single.store, j.id)) == j.task_groups[0].count
                for j in jobs)), f"single server stuck on seed {seed}"
            got = {k: v for k, v in
                   leader().store.scheduler_parity_manifest().items()
                   if k.startswith(f"default/{prefix}")}
            want = {k: v for k, v in
                    single.store.scheduler_parity_manifest().items()
                    if k.startswith(f"default/{prefix}")}
            assert got == want, seed
            assert len(got) == len(jobs)
        plans = sum(s.follower_sched.snapshot_stats()["remote_plans"]
                    for s in servers)
        assert plans >= 1, "no follower scheduled"
    finally:
        for s, r in zip(servers, rpcs):
            r.shutdown()
            s.shutdown()
        single.shutdown()


# -- the wire -----------------------------------------------------------
def _frame_bytes(codec_cls, payload):
    a, b = socket.socketpair()
    try:
        codec_cls(a).write_frame(payload)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_frames_are_byte_identical_across_packages(monkeypatch, seed):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from nomad_tpu import mock as jmock
    from nomad_tpu.rpc.codec import FrameCodec as JaxCodec
    from nomad_tpu.utils.codec import to_wire as jax_wire
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.rpc.codec import FrameCodec
    from nomad_tpu_torch.utils.codec import to_wire

    def messages(m, wire):
        with m.seeded_mock_ids(seed):
            node, job, alloc = m.node(), m.job(), m.alloc()
        return [[seed, "Node.Register", {"node": wire(node)}],
                [seed + 1, None, {"heartbeat_ttl_s": 10.0}],
                [seed + 2, "Node.UpdateAlloc", {"allocs": [wire(alloc)]}],
                [seed + 3, "Job.Register", {"job": wire(job)}]]

    for got, want in zip(messages(mock, to_wire),
                         messages(jmock, jax_wire)):
        mine = _frame_bytes(FrameCodec, got)
        theirs = _frame_bytes(JaxCodec, want)
        assert mine == theirs
        assert FrameCodec(_Reader(theirs)).read_frame() == got


class _Reader:
    """A socket stand-in that reads from bytes."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def test_port_client_calls_the_jax_rpc_server(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    _jmf, _C, JaxRpcServer, _S, _SC = _jax()
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.rpc import RemoteTransport, RpcClient
    srv = _jax_server(num_schedulers=0)
    srv.start()
    rpc = JaxRpcServer(srv, port=0)
    rpc.start()
    try:
        c = RpcClient(rpc.addr)
        try:
            assert c.call("Status.Ping")["status"] == "ok"
        finally:
            c.close()
        t = RemoteTransport(rpc.addr)
        try:
            with mock.seeded_mock_ids(7):
                node = mock.node()
            assert t.register_node(node) > 0
            stored = srv.store.node_by_id(node.id)
            assert stored is not None
            assert (stored.name, stored.datacenter) == \
                (node.name, node.datacenter)
            assert stored.node_resources.cpu.cpu_shares == \
                node.node_resources.cpu.cpu_shares
        finally:
            t.close()
    finally:
        rpc.shutdown()
        srv.shutdown()


def test_jax_client_calls_the_port_rpc_server(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    from nomad_tpu import mock as jmock
    from nomad_tpu.rpc import RemoteTransport as JaxTransport
    from nomad_tpu_torch.rpc import RpcServer
    from nomad_tpu_torch.server import Server, ServerConfig
    JaxRpcClient = _jax()[1]
    srv = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=300.0),
                 device="cpu")
    srv.start()
    rpc = RpcServer(srv, port=0)
    rpc.start()
    try:
        c = JaxRpcClient(rpc.addr)
        try:
            assert c.call("Status.Ping")["status"] == "ok"
        finally:
            c.close()
        t = JaxTransport(rpc.addr)
        try:
            with jmock.seeded_mock_ids(7):
                node = jmock.node()
            assert t.register_node(node) == 300.0
            stored = srv.store.node_by_id(node.id)
            assert stored is not None
            assert (stored.name, stored.datacenter) == \
                (node.name, node.datacenter)
            assert stored.node_resources.cpu.cpu_shares == \
                node.node_resources.cpu.cpu_shares
            assert t.heartbeat(node.id) == 300.0
        finally:
            t.close()
    finally:
        rpc.shutdown()
        srv.shutdown()


# -- the log ------------------------------------------------------------
def _state(s):
    names = {n.id: n.name for n in s.store.nodes()}
    return dict(
        jobs=sorted((j.id, j.version, j.status, j.stop)
                    for j in s.store.jobs()),
        allocs=sorted((a.id, a.name, names.get(a.node_id), a.client_status,
                       a.desired_status) for a in s.store.allocs()),
        evals=sorted((e.id, e.job_id, e.status) for e in s.store.evals()),
        index=s.store.latest_index())


def test_port_follower_applies_the_jax_leaders_log(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    jmf, JaxRpcClient, JaxRpcServer, _S, _SC = _jax()
    from nomad_tpu_torch.rpc import RpcServer
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.server.raft import MAX_BATCH, RaftNode

    # the JAX package's leader: a one-server raft cluster (every entry
    # commits at append) scheduling seeded jobs over 20 nodes
    lead = _jax_server(num_schedulers=1, follower_max_remote=0)
    lrpc = JaxRpcServer(lead, port=0)
    lead.attach_raft(lrpc, [lrpc.addr])
    lrpc.start()
    lead.start()
    follower = Server(ServerConfig(num_schedulers=0,
                                   heartbeat_ttl_s=300.0), device="cpu")
    frpc = RpcServer(follower, port=0)
    raft = RaftNode(follower, frpc.addr, [frpc.addr, lrpc.addr])
    follower.raft = raft
    frpc.methods.update(raft.rpc_methods())
    frpc.raft = raft
    frpc.start()
    # the follower's applier alone: no ticker, so it never campaigns
    fsm = threading.Thread(target=raft._fsm_loop, daemon=True)
    fsm.start()
    client = JaxRpcClient(frpc.addr)
    try:
        assert _wait(lambda: lead.raft.is_leader(), 15.0)
        for i in range(20):
            lead.register_node(_node(jmf, f"log-{i}"))
        jobs = [j for seed in range(3)
                for j in _seeded_jobs(jmf, seed, f"log-{seed}")]
        batch = jmf.batch_job()
        batch.id = "log-batch"
        batch.task_groups[0].count = 12
        jobs.append(batch)
        lead.register_jobs_bulk(jobs)
        assert _wait(lambda: all(
            len(_live(lead.store, j.id)) == j.task_groups[0].count
            for j in jobs))
        assert _wait(lambda: lead.eval_broker.stats.total_ready == 0
                     and lead.eval_broker.stats.total_unacked == 0)
        with lead.raft._lock:
            entries = list(lead.raft.log)
            base, base_term = lead.raft.base_index, lead.raft.base_term
            commit = lead.raft.commit_index
            term = lead.raft.term
        assert base == follower._raft_index
        kinds = {e[2] for e in entries}
        assert {"node_register", "plan_results", "eval_update"} <= kinds \
            or {"node_register", "plan_group_results"} <= kinds, kinds
        prev_index, prev_term = base, base_term
        for i in range(0, len(entries), MAX_BATCH):
            chunk = entries[i:i + MAX_BATCH]
            res = client.call("Raft.AppendEntries", {
                "term": term, "leader": lrpc.addr,
                "prev_index": prev_index, "prev_term": prev_term,
                "entries": [list(e) for e in chunk],
                "leader_commit": commit}, timeout_s=30.0)
            assert res["success"], res
            prev_index, prev_term = chunk[-1][0], chunk[-1][1]
        last = entries[-1][0]
        assert _wait(lambda: follower._raft_index == last, 30.0), \
            (follower._raft_index, last)
        assert _state(follower) == _state(lead)
        assert follower._raft_index == lead._raft_index
    finally:
        client.close()
        raft._stop.set()
        fsm.join(timeout=10)
        frpc.shutdown()
        follower.shutdown()
        lrpc.shutdown()
        lead.shutdown()
