"""The reference's SWIM peer failure detection suite (tests/test_swim.py;
nomad/serf.go analog) against the port's swim.py and Server on the CPU:
its three ring tests, assertions unchanged and `slow` as in the
reference — a 5-server ring detects a stopped follower through peer
probes alone (dead_server_cleanup_s=0), a report for a live server is
refuted, and the quorum guard blocks a mass removal.

Its three partition tests drive one detector through the port's
FaultInjector (chaos/faults.py) and its SWIM interposition, against a
real port Server's listener on the CPU. The port's own tests drive one
detector against real listeners without it: a stopped target turns
SUSPECT, then FAILED and is reported; an indirect ack through a relay
keeps a target ALIVE.
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


def _wait(pred, timeout=25.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _mk(n, **cfg):
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


@pytest.mark.slow
def test_partitioned_follower_detected_by_peers():
    """5 servers, replication-based cleanup DISABLED: when one follower
    partitions away, peer probes turn it SUSPECT -> FAILED, a report
    reaches the leader, the leader's verification probe fails too, and
    the member is removed — failure detection with no dependence on
    the leader's replication threads."""
    servers, rpcs, addrs = _mk(5, dead_server_cleanup_s=0.0)
    try:
        leader = _leader(servers)
        assert _wait(lambda: len(leader.store.server_members()) == 5)
        victim = next(s for s in servers if not s.raft.is_leader())
        vi = servers.index(victim)
        victim_addr = addrs[vi]

        # partition: the victim stops answering its RPC listener (and
        # stops probing, as a partitioned node effectively would)
        victim.swim.stop()
        rpcs[vi].shutdown()
        victim.shutdown()

        rest = [s for s in servers if s is not victim]
        assert _wait(lambda: victim_addr not in
                     (_leader(rest).store.server_members() or
                      [victim_addr]), timeout=30), \
            _leader(rest).store.server_members()
        # detection came from SWIM: some member reported it
        assert any(s.swim.stats["reported"] > 0 for s in rest)
        # the shrunken cluster still serves quorum writes
        node = mock.node()
        _leader(rest).register_node(node)
        assert _wait(lambda: sum(
            1 for s in rest if s.store.node_by_id(node.id)) >= 3)
    finally:
        _teardown(servers, rpcs)


@pytest.mark.slow
def test_report_for_live_server_is_refuted():
    """A (bogus) failure report for a reachable member is refuted by
    the leader's verification probe — implicit SWIM refutation."""
    servers, rpcs, addrs = _mk(3, dead_server_cleanup_s=0.0)
    try:
        leader = _leader(servers)
        assert _wait(lambda: len(leader.store.server_members()) == 3)
        follower_addr = next(a for a, s in zip(addrs, servers)
                             if not s.raft.is_leader())
        removed = leader.handle_peer_failure_report(
            follower_addr, reporter="test")
        assert removed is False
        assert len(leader.store.server_members()) == 3
    finally:
        _teardown(servers, rpcs)


@pytest.mark.slow
def test_quorum_guard_blocks_mass_removal():
    """With 2 of 3 members reported failed, only the removal that
    keeps a quorum of the remainder goes through."""
    servers, rpcs, addrs = _mk(3, dead_server_cleanup_s=0.0)
    try:
        leader = _leader(servers)
        assert _wait(lambda: len(leader.store.server_members()) == 3)
        followers = [(i, s) for i, s in enumerate(servers)
                     if not s.raft.is_leader()]
        # kill both followers; leadership holds (no election possible),
        # and removing BOTH would leave a 1-node "cluster" — the guard
        # must stop at one removal (2 members, quorum 2, leader alone
        # can't commit further removals anyway)
        for i, s in followers:
            s.swim.stop()
            rpcs[i].shutdown()
            s.shutdown()
        # removing one of three needs the other two alive to commit —
        # with both followers dead the write can't reach quorum, so
        # the guard or the commit must refuse (raise); either way
        # membership never drops below a quorum-capable size
        try:
            first = leader.handle_peer_failure_report(
                addrs[followers[0][0]], reporter="test")
        except Exception:
            first = False
        assert first is False or \
            len(leader.store.server_members()) >= 2
    finally:
        _teardown(servers, rpcs)


# -- the port's own: one detector against real listeners ---------------
from nomad_tpu_torch.chaos.faults import FaultInjector  # noqa: E402
from nomad_tpu_torch.server.swim import (  # noqa: E402
    STATE_ALIVE, STATE_FAILED, STATE_SUSPECT, SwimDetector,
)


class _FakeRaft:
    def __init__(self, self_addr, peers, leader=True):
        self.self_addr = self_addr
        self.peers = list(peers)
        self.leader_addr = self_addr
        self._leader = leader

    def is_leader(self):
        return self._leader


class _FakeServer:
    """Just enough server for a SwimDetector: a raft identity, a
    member list, and the leader report sink."""

    def __init__(self, self_addr, members):
        self.raft = _FakeRaft(self_addr, [m for m in members
                                          if m != self_addr])
        self._members = list(members)
        self.reports = []

    class _Store:
        def __init__(self, outer):
            self.outer = outer

        def server_members(self):
            return list(self.outer._members)

    @property
    def store(self):
        return self._Store(self)

    def handle_peer_failure_report(self, addr, reporter=""):
        self.reports.append((addr, reporter))
        return True


def _listener(methods):
    rpc = RpcServer(methods=methods, port=0)
    rpc.start()
    return rpc


def test_stopped_target_turns_suspect_then_failed_and_is_reported():
    target = _listener({"Status.Ping": lambda _a: {"status": "ok"}})
    fake = _FakeServer("fake-self:0", ["fake-self:0", target.addr])
    det = SwimDetector(fake, probe_timeout_s=0.3, suspicion_s=0.0)
    try:
        det._tick()
        assert det.states[target.addr]["state"] == STATE_ALIVE
        assert det.live_members() == [target.addr]
        target.shutdown()
        det._tick()
        assert det.states[target.addr]["state"] == STATE_SUSPECT
        assert fake.reports == []
        det._tick()
        assert det.states[target.addr]["state"] == STATE_FAILED
        assert fake.reports == [(target.addr, "fake-self:0")]
        assert det.live_members() == []
        assert det.stats["probes"] == 3
        assert det.stats["reported"] == 1
    finally:
        target.shutdown()


def test_indirect_ack_keeps_an_unreachable_target_alive():
    """The direct probe fails (nothing listens at the target), but a
    relay answers the ping-req for it: the target stays ALIVE and no
    report goes out (SWIM's indirect probe)."""
    gone = _listener({})
    gone_addr = gone.addr
    gone.shutdown()
    relayed = []

    def indirect(args):
        relayed.append(args["target"])
        return {"ok": True}

    relay = _listener({"Server.IndirectPing": indirect,
                       "Status.Ping": lambda _a: {"status": "ok"}})
    fake = _FakeServer("fake-self:0",
                       ["fake-self:0", gone_addr, relay.addr])
    det = SwimDetector(fake, probe_timeout_s=0.3, suspicion_s=0.0)
    det._probe_order = [relay.addr, gone_addr]   # pops the target first
    try:
        det._tick()
        assert relayed == [gone_addr]
        assert det.states[gone_addr]["state"] == STATE_ALIVE
        assert det.stats["indirect"] == 1
        assert fake.reports == []
    finally:
        relay.shutdown()


# -- the reference's partition tests, through the port's injector ------

@pytest.fixture
def victim_rpc():
    """A real RPC listener as the probe target, so un-interposed
    pings genuinely succeed (the heal half of the test has teeth)."""
    srv = Server(ServerConfig(num_schedulers=0, governor_enabled=False,
                              telemetry_sample_interval_s=0))
    rpc = RpcServer(srv, port=0)
    rpc.start()
    yield rpc
    rpc.shutdown()
    srv.shutdown()


def test_partition_victim_suspect_failed_report_then_rejoin(victim_rpc):
    victim = victim_rpc.addr
    fake = _FakeServer("fake-self:0", ["fake-self:0", victim])
    det = SwimDetector(fake, suspicion_s=0.05)

    # healthy baseline: the real listener answers the probe
    det._tick()
    assert det.states[victim]["state"] == STATE_ALIVE

    inj = FaultInjector(seed=9)
    with inj:
        inj.partition({victim})
        det._tick()                         # probe fails -> SUSPECT
        assert det.states[victim]["state"] == STATE_SUSPECT
        assert not fake.reports             # suspicion, not verdict
        time.sleep(0.06)                    # suspicion window lapses
        det._tick()                         # -> FAILED + report
        assert det.states[victim]["state"] == STATE_FAILED
        assert fake.reports and fake.reports[0][0] == victim
        # the verdict repeats every cycle until membership changes
        det._tick()
        assert len(fake.reports) >= 2

        # recovery INSIDE the partition can't happen: still failed
        time.sleep(0.02)
        det._tick()
        assert det.states[victim]["state"] == STATE_FAILED
    # heal: the next probe reaches the live listener and the member
    # rejoins ALIVE (implicit SWIM refutation)
    det._tick()
    assert det.states[victim]["state"] == STATE_ALIVE


def test_partition_blocks_indirect_probes_too(victim_rpc):
    victim = victim_rpc.addr
    fake = _FakeServer("fake-self:0",
                       ["fake-self:0", victim, "relay:1"])
    det = SwimDetector(fake)
    inj = FaultInjector(seed=10)
    with inj:
        inj.partition({victim})
        # the ping-req's last hop crosses the same cut: no dial is
        # attempted (the injector records the drop for the relay leg)
        assert det._indirect_ping("relay:1", victim) is False
        assert any(e["kind"] == "probe_dropped" and
                   e.get("target") == victim for e in inj.events)
        # probes to a NON-victim pass the interposer (and then fail
        # only because nothing listens at the bogus relay address)
        assert not any(e.get("target") == "relay:1"
                       for e in inj.events
                       if e["kind"] == "probe_dropped")


def test_probe_for_peer_respects_partition(victim_rpc):
    """The leader's verification probe (handle_peer_failure_report ->
    probe_for_peer) sees the same cut: a partitioned member can't be
    refuted alive by the leader."""
    victim = victim_rpc.addr
    fake = _FakeServer("fake-self:0", ["fake-self:0", victim])
    det = SwimDetector(fake)
    assert det.probe_for_peer(victim) is True
    inj = FaultInjector(seed=11)
    with inj:
        inj.partition({victim})
        assert det.probe_for_peer(victim) is False
        inj.heal_partition()
        assert det.probe_for_peer(victim) is True
