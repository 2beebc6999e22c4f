"""The reference's multi-server consensus suite (tests/test_raft.py:
election, replication, write forwarding, failover, snapshot reseed;
reference nomad/server.go setupRaft, leader.go, fsm.go Snapshot/Restore)
against the port's raft.py and Server on the CPU, all 9 tests with their
assertions unchanged and the reference's `slow` marks kept.

Besides: a reseeded follower's resident node table is primed at the
snapshot's index, its device mirror equal to its host table row for
row, so no eval reads a row from before the snapshot; the port's RaftNode
joins its ticker and FSM applier on stop; a ring's teardown joins every
raft, SWIM and scheduler-plane thread it started; and a server that
loses leadership stops its heartbeat timers' thread, while the new
leader runs exactly one.
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


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _make_cluster(n=3, num_schedulers=1):
    servers = []
    rpcs = []
    for _ in range(n):
        s = Server(ServerConfig(num_schedulers=num_schedulers,
                                heartbeat_ttl_s=30.0))
        r = RpcServer(s, port=0)
        servers.append(s)
        rpcs.append(r)
    addrs = [r.addr for r in rpcs]
    for s, r in zip(servers, rpcs):
        s.attach_raft(r, addrs)
        r.start()
        s.start()
    return servers, rpcs, addrs


def _leaders(servers):
    return [s for s in servers if s.raft.is_leader()]


@pytest.fixture
def cluster():
    servers, rpcs, addrs = _make_cluster()
    yield servers, rpcs, addrs
    for s, r in zip(servers, rpcs):
        try:
            r.shutdown()
            s.shutdown()
        except Exception:
            pass


@pytest.mark.slow
def test_single_leader_elected(cluster):
    servers, _rpcs, _addrs = cluster
    assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10), \
        [s.raft.role for s in servers]
    leader = _leaders(servers)[0]
    # followers agree on the leader address
    assert _wait_for(lambda: all(
        s.raft.leader_addr == leader.raft.self_addr for s in servers))


@pytest.mark.slow
def test_replication_and_follower_forwarding(cluster):
    servers, _rpcs, _addrs = cluster
    assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
    leader = _leaders(servers)[0]
    followers = [s for s in servers if s is not leader]

    # write through the leader: replicates everywhere
    node = mock.node()
    leader.register_node(node)
    assert _wait_for(lambda: all(
        s.store.node_by_id(node.id) is not None for s in servers)), \
        "node did not replicate"

    # write through a FOLLOWER: forwarded to the leader, then replicated
    job = mock.batch_job()
    job.task_groups[0].count = 1
    followers[0].register_job(job)
    assert _wait_for(lambda: all(
        s.store.job_by_id("default", job.id) is not None
        for s in servers)), "forwarded write did not replicate"

    # the leader scheduled it (broker enabled only there)
    assert _wait_for(lambda: len(
        leader.store.allocs_by_job("default", job.id)) == 1)
    assert _wait_for(lambda: all(len(
        s.store.allocs_by_job("default", job.id)) == 1 for s in servers)), \
        "allocs did not replicate"


@pytest.mark.slow
def test_failover_elects_new_leader_and_serves_writes(cluster):
    servers, rpcs, _addrs = cluster
    assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
    leader = _leaders(servers)[0]
    li = servers.index(leader)

    # seed state pre-failover
    node = mock.node()
    leader.register_node(node)
    assert _wait_for(lambda: all(
        s.store.node_by_id(node.id) is not None for s in servers))

    rpcs[li].shutdown()
    leader.shutdown()
    rest = [s for s in servers if s is not leader]
    assert _wait_for(lambda: len(_leaders(rest)) == 1, timeout=10), \
        [s.raft.role for s in rest]
    new_leader = _leaders(rest)[0]
    assert new_leader is not leader

    # pre-failover state survived and new writes land
    assert new_leader.store.node_by_id(node.id) is not None
    job = mock.batch_job()
    new_leader.register_job(job)
    assert _wait_for(lambda: all(
        s.store.job_by_id("default", job.id) is not None for s in rest))


@pytest.mark.slow
def test_acked_write_survives_immediate_leader_kill(cluster):
    """Quorum commit: raft_apply acks only after a majority holds the
    entry, so a write acked just before the leader dies MUST survive
    failover (Raft §5.4; the round-2 primary/backup semantics lost
    exactly this tail)."""
    servers, rpcs, _addrs = cluster
    assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
    leader = _leaders(servers)[0]
    li = servers.index(leader)

    node = mock.node()
    leader.register_node(node)          # returns only after quorum ack
    rpcs[li].shutdown()                 # kill immediately after the ack
    leader.shutdown()

    rest = [s for s in servers if s is not leader]
    assert _wait_for(lambda: len(_leaders(rest)) == 1, timeout=10), \
        [s.raft.role for s in rest]
    new_leader = _leaders(rest)[0]
    assert new_leader.store.node_by_id(node.id) is not None, \
        "acked write lost on failover"


@pytest.mark.slow
def test_dead_peer_does_not_destabilize_leader(cluster):
    """Per-peer replication threads: one unreachable peer must not
    starve heartbeats to the healthy follower (which would trigger
    continual elections). Writes keep committing on the 2/3 quorum."""
    servers, rpcs, _addrs = cluster
    assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
    leader = _leaders(servers)[0]
    followers = [s for s in servers if s is not leader]
    dead = followers[0]
    di = servers.index(dead)
    rpcs[di].shutdown()
    dead.shutdown()

    term_before = leader.raft.term
    # writes must still ack via leader + surviving follower
    for i in range(3):
        node = mock.node()
        node.name = f"alive-{i}"
        leader.register_node(node)
        time.sleep(0.3)
    assert leader.raft.is_leader(), "leader lost leadership"
    assert leader.raft.term == term_before, \
        "election churn while a peer was down"
    assert len([n for n in followers[1].store.nodes()
                if n.name.startswith("alive-")]) == 3


def test_deposed_leader_refuses_append_and_term_pins_waits():
    """append_entry on a non-leader must raise (a deposed leader
    appending with the new term would make the real leader's entry at
    that index look already-present on a follower), and wait_for_applied
    pinned to a term must fail once the term moves — the entry may have
    been erased by a truncation in between."""
    from nomad_tpu_torch.server.raft import FOLLOWER, LEADER, RaftNode

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    node = RaftNode(s, "127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:2"])
    node.role = FOLLOWER
    with pytest.raises(RuntimeError, match="not the leader"):
        node.append_entry("noop", {})
    assert node.log == []

    node.role = LEADER
    node.term = 3
    index, term = node.append_entry("noop", {})
    assert term == 3
    assert index == node.base_index + 1
    node.term = 4                       # deposed + re-elected elsewhere
    with pytest.raises(RuntimeError, match="term moved"):
        node.wait_for_applied(index, term=3, timeout_s=0.5)
    s.shutdown()


def test_uncommitted_entries_are_not_applied():
    """Apply-at-commit: a leader that cannot reach a quorum appends to
    its log but must NOT run the FSM — a blocking query against its
    store can never observe the unacked write (r3 verdict item 6; the
    reference applies at commit via hashicorp/raft)."""
    from nomad_tpu_torch.server.raft import LEADER, RaftNode

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    # two unreachable peers: no quorum is possible
    node = RaftNode(s, "127.0.0.1:1",
                    ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"])
    s.raft = node
    node.role = LEADER
    node.term = 2
    n = mock.node()
    before = len(s.store.nodes())
    with pytest.raises(RuntimeError, match="no quorum"):
        # the raft_apply path: append + wait for commit (times out)
        _apply_with_timeout(s, "node_register", dict(node=n))
    # the unacked write is invisible to reads on the partitioned leader
    assert len(s.store.nodes()) == before
    assert s.store.node_by_id(n.id) is None
    # ...but it IS in the log, awaiting commit or truncation
    assert any(e[2] == "node_register" for e in node.log)
    s.shutdown()


def _apply_with_timeout(server, msg_type, payload, timeout_s=0.5):
    index, waiter = server.raft_apply_async(msg_type, payload)
    server.raft.wait_for_applied(index, timeout_s=timeout_s)


def test_install_snapshot_pins_applied_index_above_table_indexes():
    """The r3 advisor's high finding: a reseeded follower whose
    snapshot base sits above store.latest_index() (no-op entries touch
    no table) must adopt the BASE as its applied index, or it would
    reissue already-used log indexes after winning an election."""
    from nomad_tpu_torch.server.raft import RaftNode

    donor = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    donor.establish_leadership()
    donor.register_node(mock.node())
    snap = donor.store.snapshot().dump()
    table_max = donor.store.latest_index()

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    node = RaftNode(s, "127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:2"])
    s.raft = node
    # the leader's applied index ran past the last table write because
    # of election no-ops
    base = table_max + 7
    node._handle_install_snapshot(
        {"term": 5, "leader": "127.0.0.1:2", "snapshot": snap,
         "base_index": base, "base_term": 5})
    assert s._raft_index == base
    assert node.base_index == base
    assert node.commit_index == base
    donor.shutdown()
    s.shutdown()


@pytest.mark.slow
def test_snapshot_reseed_of_fresh_follower():
    """A server joining with empty state catches up via snapshot
    install when the leader's log has been compacted past its needs."""
    servers, rpcs, addrs = _make_cluster(n=3)
    try:
        assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
        leader = _leaders(servers)[0]
        for i in range(5):
            node = mock.node()
            node.name = f"n{i}"
            leader.register_node(node)
        # compact the leader's log to force snapshot path for laggards
        leader.raft.compact(keep=0)
        # wipe a follower's raft progress by simulating a fresh joiner:
        follower = [s for s in servers if s is not leader][0]
        follower.raft.needs_snapshot = True
        assert _wait_for(
            lambda: len(list(follower.store.nodes())) >= 5, timeout=10), \
            len(list(follower.store.nodes()))
    finally:
        for s, r in zip(servers, rpcs):
            try:
                r.shutdown()
                s.shutdown()
            except Exception:
                pass


# -- the port's own -----------------------------------------------------
def _mirror_matches_host(store):
    """The mirror that serves the store's latest table equals the host
    table row for row (capacity, used, free ports)."""
    import torch
    t = store.snapshot().node_table()
    mirror = store.table_cache.device
    st = t.device_mirror.arrays_for(t, mirror.device)
    assert st is not None, "the mirror does not serve the latest table"
    for col, host in ((st.capacity, t.capacity), (st.used, t.base_used),
                      (st.free_ports, t.free_ports)):
        assert torch.equal(col[:t.n].cpu(), torch.from_numpy(host))
    return t


def test_install_snapshot_primes_the_table_and_its_mirror():
    """A follower that served a table before the reseed serves none of
    its rows after: the restore replaces the table cache, primes it at
    the snapshot's index and uploads the mirror to the server's device,
    so the next eval takes the delta path (no full build) over the
    snapshot's nodes and allocs."""
    from nomad_tpu_torch.models import Plan
    from nomad_tpu_torch.server.raft import RaftNode

    donor = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    donor.establish_leadership()
    nodes = [mock.node() for _ in range(6)]
    for n in nodes:
        donor.register_node(n)
    job = mock.job()
    job.task_groups[0].count = 3
    donor.register_job(job)
    alloc = mock.alloc()
    alloc.job = donor.store.job_by_id(job.namespace, job.id)
    alloc.job_id = job.id
    alloc.node_id = nodes[2].id
    plan = Plan(priority=50, job=alloc.job)
    plan.node_allocation = {nodes[2].id: [alloc]}
    plan.snapshot_index = donor.store.latest_index()
    assert donor.plan_applier.apply_sync(plan).node_allocation
    snap = donor.store.snapshot().dump()

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    try:
        # the follower's own, pre-snapshot state, served once
        stale = mock.node()
        s.store.upsert_node(s._raft_index + 1, stale)
        s.store.snapshot().node_table()
        node = RaftNode(s, "127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:2"])
        s.raft = node
        base = donor.store.latest_index() + 3
        node._handle_install_snapshot(
            {"term": 2, "leader": "127.0.0.1:2", "snapshot": snap,
             "base_index": base, "base_term": 2})
        cache = s.store.table_cache
        assert cache.stats == {"full_builds": 0, "delta_refreshes": 0,
                               "primes": 1}
        assert cache.device.stats["uploads"] == 1
        t = _mirror_matches_host(s.store)
        assert cache.stats["full_builds"] == 0
        assert sorted(t.ids) == sorted(n.id for n in nodes)
        assert stale.id not in t.ids
        row = t.id_to_idx[nodes[2].id]
        want = donor.store.snapshot().node_table()
        assert (t.base_used[row] == want.base_used[
            want.id_to_idx[nodes[2].id]]).all()
        assert t.base_used[row].any()
        assert s._raft_index == base
    finally:
        donor.shutdown()
        s.shutdown()


def test_raft_stop_joins_its_ticker_and_fsm_applier():
    from nomad_tpu_torch.server.raft import RaftNode

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    node = RaftNode(s, "127.0.0.1:1", ["127.0.0.1:1", "127.0.0.1:2"])
    node.start()
    threads = list(node._threads)
    assert [t.name for t in threads] == ["raft-ticker", "raft-fsm"]
    assert all(t.is_alive() for t in threads)
    node.stop()
    assert not any(t.is_alive() for t in threads)
    s.shutdown()


def test_leadership_moves_keep_one_heartbeat_thread_and_teardown_joins():
    """Only the leader keeps TTL timers, on one thread however many
    nodes it tracks; a server that loses leadership stops that thread,
    the new leader runs exactly one; shutdown joins every raft, SWIM
    and scheduler-plane thread the ring started."""
    servers, rpcs, _addrs = _make_cluster(n=3, num_schedulers=0)
    try:
        assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
        leader = _leaders(servers)[0]
        for i in range(40):
            n = mock.node()
            n.name = f"hb-{i}"
            leader.register_node(n)
        assert _wait_for(lambda: all(
            len(s.store.nodes()) == 40 for s in servers))

        def timer_threads():
            return {id(s): s._heartbeats._thread for s in servers}
        threads = timer_threads()
        assert threads[id(leader)] is not None and \
            threads[id(leader)].is_alive()
        assert all(t is None for k, t in threads.items()
                   if k != id(leader))
        assert len(leader._heartbeats._deadline) == 40

        li = servers.index(leader)
        old_timer = leader._heartbeats
        # the old leader steps down when it meets a higher term
        with leader.raft._lock:
            leader.raft._become_follower(leader.raft.term + 1, None)
        assert not leader._leader
        assert old_timer._stopped
        assert _wait_for(lambda: not old_timer._thread.is_alive(), 5)
        assert _wait_for(lambda: len(_leaders(servers)) == 1, timeout=10)
        new = _leaders(servers)[0]
        assert _wait_for(lambda: new._heartbeats._thread is not None
                         and new._heartbeats._thread.is_alive(), 5)
        alive = [s for s in servers
                 if s._heartbeats._thread is not None
                 and s._heartbeats._thread.is_alive()]
        assert alive == [new]
        assert len(new._heartbeats._deadline) == 40
        del li
    finally:
        plane = []
        for s in servers:
            plane += list(s.raft._threads)
            plane.append(s.swim._thread)
            plane += [w._thread for w in s.follower_sched.workers]
            plane.append(s._heartbeats._thread)
        for s, r in zip(servers, rpcs):
            r.shutdown()
            s.shutdown()
    assert not [t.name for t in plane if t is not None and t.is_alive()]


def test_leadership_is_established_after_the_barrier():
    """A new leader enables its broker (and restores evals from the
    store) only once its term's no-op is committed and applied: every
    entry of an earlier term it holds is in the store first
    (nomad/leader.go: a raft Barrier before establishLeadership)."""
    import threading
    from nomad_tpu_torch.server.raft import RaftNode

    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0))
    node = RaftNode(s, "127.0.0.1:1",
                    ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"])
    s.raft = node
    fsm = threading.Thread(target=node._fsm_loop, daemon=True)
    fsm.start()
    try:
        with node._lock:
            node.term = 3
            node._become_leader()
        assert node.is_leader()
        # the no-op waits for a quorum the unreachable peers never give
        assert _wait_for(lambda: any(e[2] == "noop" for e in node.log), 5)
        time.sleep(0.3)
        assert not s._leader
        assert not s.eval_broker.enabled()
        noop = next(e[0] for e in node.log if e[2] == "noop")
        # one peer acknowledges: the no-op commits and applies
        with node._lock:
            node._match_index["127.0.0.1:2"] = noop
            node._advance_commit()
        assert _wait_for(lambda: s._leader, 5)
        assert s.eval_broker.enabled()
        assert s._raft_index >= noop
    finally:
        node._stop.set()
        fsm.join(timeout=10)
        s.shutdown()
