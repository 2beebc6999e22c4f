"""The reference's dynamic membership suite (tests/test_membership.py:
join and leave reshape the server set, autopilot removes a dead server
under the quorum guard; reference nomad/serf.go, nomad/server.go:1381
setupSerf, nomad/autopilot.go) against the port's Server on the CPU, all
3 tests with their assertions unchanged and the reference's `slow`
marks kept. Membership rides the replicated log (a full-member-list
apply) and liveness is the leader's replication contact clock.
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.server import Server as _Server, ServerConfig


def Server(config=None):
    """The port's Server on the CPU."""
    return _Server(config, device="cpu")


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _mk(n=3, **cfg):
    servers, rpcs = [], []
    for _ in range(n):
        s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0,
                                **cfg))
        r = RpcServer(s, port=0)
        servers.append(s)
        rpcs.append(r)
    addrs = [r.addr for r in rpcs]
    for s, r in zip(servers, rpcs):
        s.attach_raft(r, addrs)
        r.start()
        s.start()
    return servers, rpcs, addrs


def _teardown(servers, rpcs):
    for s, r in zip(servers, rpcs):
        try:
            r.shutdown()
            s.shutdown()
        except Exception:
            pass


def _leader(servers):
    assert _wait(lambda: sum(s.raft.is_leader() for s in servers) == 1)
    return next(s for s in servers if s.raft.is_leader())


def _on_leader(servers, fn, timeout=20.0):
    """Run fn(leader), re-resolving the leader on stepdown — under
    full-suite load an election timeout can fire between resolving the
    leader and issuing the call."""
    deadline = time.time() + timeout
    while True:
        try:
            return fn(_leader(servers))
        except (RuntimeError, StopIteration):
            if time.time() > deadline:
                raise
            time.sleep(0.1)


@pytest.mark.slow
def test_server_joins_live_cluster_and_replicates():
    servers, rpcs, addrs = _mk(3)
    extra = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    extra_rpc = RpcServer(extra, port=0)
    try:
        leader = _leader(servers)
        # membership seeded from boot config
        assert _wait(lambda: set(leader.store.server_members())
                     == set(addrs))
        node = mock.node()
        leader.register_node(node)

        # the new server starts EMPTY and joins through a FOLLOWER
        # (writes forward to the leader)
        extra.attach_raft(extra_rpc, [extra_rpc.addr])
        extra_rpc.start()
        extra.start()
        follower = next(s for s in servers if not s.raft.is_leader())
        extra.join_cluster(
            follower.rpc_addr if hasattr(follower, "rpc_addr")
            else rpcs[servers.index(follower)].addr)

        # every member adopts the 4-server view
        assert _wait(lambda: all(
            len(s.store.server_members()) == 4
            for s in servers + [extra])), [
                s.store.server_members() for s in servers + [extra]]
        assert _wait(lambda: extra.raft.cluster_size == 4)
        # the joiner catches up on replicated state (snapshot install)
        assert _wait(lambda: extra.store.node_by_id(node.id) is not None)
        # and participates in replication of NEW writes
        job = mock.batch_job()
        leader.register_job(job)
        assert _wait(lambda: extra.store.job_by_id("default", job.id)
                     is not None)
    finally:
        _teardown(servers + [extra], rpcs + [extra_rpc])


@pytest.mark.slow
def test_operator_leave_shrinks_the_voter_set():
    servers, rpcs, addrs = _mk(3)
    try:
        leader = _leader(servers)
        assert _wait(lambda: set(leader.store.server_members())
                     == set(addrs))
        victim = next(s for s in servers if not s.raft.is_leader())
        vaddr = rpcs[servers.index(victim)].addr
        _on_leader(servers, lambda l: l.leave_member(vaddr))
        rest = [s for s in servers if s is not victim]
        assert _wait(lambda: all(
            vaddr not in s.store.server_members() for s in rest))
        assert _wait(lambda: all(s.raft.cluster_size == 2 for s in rest))
        # the removed server isolates itself
        assert _wait(lambda: victim.raft.cluster_size == 1)
        # writes still commit on the 2-server quorum
        node = mock.node()
        _on_leader(rest, lambda l: l.register_node(node))
        assert _wait(lambda: all(
            s.store.node_by_id(node.id) is not None for s in rest))
    finally:
        _teardown(servers, rpcs)


@pytest.mark.slow
def test_autopilot_removes_dead_server():
    servers, rpcs, addrs = _mk(4, dead_server_cleanup_s=3.0)
    try:
        leader = _leader(servers)
        assert _wait(lambda: len(leader.store.server_members()) == 4)
        dead = next(s for s in servers if not s.raft.is_leader())
        di = servers.index(dead)
        rpcs[di].shutdown()
        dead.shutdown()
        rest = [s for s in servers if s is not dead]
        # autopilot reaps it after the contact threshold
        assert _wait(lambda: len(_leader(rest).store.server_members())
                     == 3, timeout=30), \
            _leader(rest).store.server_members()
        assert _wait(lambda: all(
            s.raft.cluster_size == 3 for s in rest
            if s.raft.is_leader()))
        # the shrunken cluster still serves quorum writes
        node = mock.node()
        _leader(rest).register_node(node)
        assert _wait(lambda: sum(
            1 for s in rest if s.store.node_by_id(node.id)) >= 2)
    finally:
        _teardown(servers, rpcs)
