"""The port's durable server: server/persistence.py and the restore half of
server/core.py, on the CPU.

The reference's tests of the WAL, snapshots and cold start that need a
Server, Persistence or RaftLog, their assertions unchanged, every server
built with device="cpu" and shut down in a `finally`:
tests/test_persistence.py (test_wal_replay_and_torn_write,
test_snapshot_truncates_wal, and at the end, beside the port's Client,
test_server_restart_recovers_state and test_blocked_eval_survives_restart)
and the server
halves of tests/test_cold_start.py (batched replay, the background
snapshot writer, a crash mid-snapshot, group fsync and restore_into's
contract). The sequential replay that the JAX package selects with
NOMAD_TPU_WAL_REPLAY_BATCH=0 is `_replay_entries(..., batch=False)`
here.

Then the port's own: the endpoints' entries (namespaces, the service
catalog, CSI volumes) through the WAL and a restart, the WAL settings of
ServerConfig, the cold-start stats, the prefetch joined at construction
(a failed upload raises from it), and shutdown's teardown of the log and
the cost model's file.
"""

import json
import os
import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import CSIVolume, ServiceRegistration
from nomad_tpu_torch.models.namespace import Namespace
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.persistence import Persistence, RaftLog
from nomad_tpu_torch.state import StateStore

import test_torch_select  # noqa: F401  (torch's thread cap)


def _canon(d) -> str:
    return json.dumps(d, sort_keys=True, default=str)


def _server(**kw) -> Server:
    return Server(ServerConfig(**kw), device="cpu")


# -- tests/test_persistence.py ------------------------------------------

def test_wal_replay_and_torn_write(tmp_path):
    log = RaftLog(str(tmp_path / "raft.log"))
    log.open()
    log.append(1, "node_register", {"node": mock.node()})
    log.append(2, "eval_update", {"evals": [mock.evaluation()]})
    log.close()
    # simulate a torn final frame
    with open(str(tmp_path / "raft.log"), "ab") as f:
        f.write(b"\xff\x00\x00\x00partial")
    entries = log.replay()
    assert len(entries) == 2
    assert entries[0][1] == "node_register"
    assert entries[0][2]["node"].name == "foobar"
    assert entries[1][2]["evals"][0].status == "pending"


def test_snapshot_truncates_wal(tmp_path):
    data_dir = str(tmp_path / "snap")
    server = _server(num_schedulers=0, data_dir=data_dir,
                     snapshot_every=5)
    server.start()
    try:
        for i in range(12):
            server.raft_apply("node_register", dict(node=mock.node()))
    finally:
        server.shutdown()
    # WAL should have been truncated at least twice; snapshot exists
    assert os.path.exists(os.path.join(data_dir, "state.snap"))
    wal_entries = RaftLog(os.path.join(data_dir, "raft.log")).replay()
    assert len(wal_entries) < 12

    server2 = _server(num_schedulers=0, data_dir=data_dir)
    try:
        assert len(server2.store.nodes()) == 12
    finally:
        server2.shutdown()


# -- tests/test_cold_start.py, the Server / Persistence / RaftLog half ----

def _replay_stream(server, jobs):
    """A WAL-shaped entry stream with deliberate same-job runs (forces
    batch flush partitioning) and interleaved types."""
    for k in range(6):
        for job in jobs:
            ev = mock.evaluation()
            ev.job_id = job.id
            server.raft_apply("eval_update", dict(evals=[ev]))
        # same-job pair back to back: the batcher must flush between
        ev1, ev2 = mock.evaluation(), mock.evaluation()
        ev1.job_id = ev2.job_id = jobs[0].id
        server.raft_apply("eval_update", dict(evals=[ev1]))
        server.raft_apply("eval_update", dict(evals=[ev2]))
        server.raft_apply("node_register", dict(node=mock.node()))


class TestBatchedWalReplay:
    def test_batched_equals_sequential(self, tmp_path, monkeypatch):
        """Replaying the same WAL with batching on vs off yields
        byte-identical store state (randomized streams incl. same-job
        conflict runs and alloc client updates)."""
        from dataclasses import replace
        data_dir = str(tmp_path / "replay")
        srv = _server(num_schedulers=0, data_dir=data_dir,
                      snapshot_every=10_000)
        try:
            jobs = []
            for j in range(4):
                job = mock.batch_job()
                job.id = f"wal-job-{j}"
                srv.raft_apply("job_register", dict(job=job))
                jobs.append(job)
            node = mock.node()
            srv.raft_apply("node_register", dict(node=node))
            allocs = []
            for j, job in enumerate(jobs):
                a = mock.alloc()
                a.id = f"wal-alloc-{j}"
                a.job_id = job.id
                a.node_id = node.id
                allocs.append(a)
                srv.raft_apply("plan_results", dict(
                    allocs_stopped=[], allocs_placed=[a],
                    allocs_preempted=[]))
            _replay_stream(srv, jobs)
            # alloc client updates, including a same-job run
            for j, a in enumerate(allocs):
                srv.raft_apply("alloc_client_update", dict(
                    allocs=[replace(a, client_status="running")],
                    evals=[]))
            srv.raft_apply("alloc_client_update", dict(
                allocs=[replace(allocs[0], client_status="complete")],
                evals=[]))
            srv.raft_apply("alloc_client_update", dict(
                allocs=[replace(allocs[0], client_status="failed")],
                evals=[]))
        finally:
            srv.shutdown()
        # no snapshot was written (snapshot_every huge): everything
        # replays from the WAL on both boots
        assert not os.path.exists(os.path.join(data_dir, "state.snap"))

        real_replay = Server._replay_entries
        monkeypatch.setattr(
            Server, "_replay_entries",
            lambda self, entries, highest: real_replay(
                self, entries, highest, batch=False))
        seq = _server(num_schedulers=0, data_dir=data_dir,
                      snapshot_every=10_000)
        try:
            seq_dump = seq.store.dump()
            seq_index = seq._raft_index
        finally:
            seq.shutdown()
        monkeypatch.setattr(Server, "_replay_entries", real_replay)
        bat = _server(num_schedulers=0, data_dir=data_dir,
                      snapshot_every=10_000)
        try:
            assert _canon(bat.store.dump()) == _canon(seq_dump)
            assert bat._raft_index == seq_index
        finally:
            bat.shutdown()


class TestBackgroundSnapshot:
    def test_applier_commits_while_snapshot_in_flight(self, tmp_path):
        """The acceptance test: with serialization gated open on an
        event, raft applies keep committing; entries applied during
        the in-flight snapshot survive the next restart (WAL prefix
        truncation keeps the tail)."""
        data_dir = str(tmp_path / "bg")
        srv = _server(num_schedulers=0, data_dir=data_dir,
                      snapshot_every=5)
        gate = threading.Event()
        entered = threading.Event()
        from nomad_tpu_torch.state.store import StateSnapshot
        real_dump = StateSnapshot.dump_columnar

        def gated_dump(self):
            entered.set()
            assert gate.wait(10), "snapshot writer never released"
            return real_dump(self)

        StateSnapshot.dump_columnar = gated_dump
        try:
            for _ in range(5):      # crosses snapshot_every => trigger
                srv.raft_apply("node_register", dict(node=mock.node()))
            assert entered.wait(10), "background snapshot never started"
            # the applier must NOT be blocked by the in-flight writer
            t0 = time.perf_counter()
            for _ in range(7):
                srv.raft_apply("node_register", dict(node=mock.node()))
            applied_during_flight = time.perf_counter() - t0
            assert len(srv.store.nodes()) == 12
            assert applied_during_flight < 5.0
        finally:
            gate.set()
            StateSnapshot.dump_columnar = real_dump
            try:
                srv.persistence.wait_idle()
                assert srv.persistence.stats["snapshots"] >= 1
            finally:
                srv.shutdown()
        srv2 = _server(num_schedulers=0, data_dir=data_dir)
        try:
            # snapshot covered 5 nodes; the 7 applied mid-flight came
            # back off the preserved WAL tail
            assert len(srv2.store.nodes()) == 12
        finally:
            srv2.shutdown()

    def test_stale_capture_never_replaces_newer_snapshot(self, tmp_path):
        """Racing snapshot writers: the one holding the OLDER capture
        must neither replace the newer snapshot file nor re-truncate
        the WAL at a stale offset (absolute marks + the monotone
        publish guard)."""
        s = StateStore()
        p = Persistence(str(tmp_path / "race"), background=False)
        p.log.open()
        s.upsert_node(11, mock.node())
        snap_old = s.snapshot()
        mark_old = p.log.size()
        p.log.append(12, "noop", {})
        s.upsert_node(12, mock.node())
        snap_new = s.snapshot()
        mark_new = p.log.size()
        assert mark_new > mark_old
        p._write_snapshot(snap_new, None, mark_new)  # newer lands first
        p._write_snapshot(snap_old, None, mark_old)  # stale: must no-op
        p.log.close()
        s2 = StateStore()
        p2 = Persistence(str(tmp_path / "race"))
        _highest, entries = p2.restore_into(s2)
        p2.log.close()
        assert len(s2.nodes()) == 2     # the newer snapshot survived
        assert entries == []            # and the WAL was not re-cut

    def test_crash_mid_snapshot_recovers(self, tmp_path):
        """A leftover state.snap.tmp from a crash mid-write is ignored
        and cleaned; the prior snapshot + WAL restore cleanly."""
        data_dir = str(tmp_path / "crash")
        srv = _server(num_schedulers=0, data_dir=data_dir,
                      snapshot_background=False)
        try:
            for _ in range(4):
                srv.raft_apply("node_register", dict(node=mock.node()))
            srv.persistence.snapshot(srv.store)
            srv.raft_apply("node_register", dict(node=mock.node()))
        finally:
            srv.shutdown()
        tmp = os.path.join(data_dir, "state.snap.tmp")
        with open(tmp, "wb") as f:
            f.write(b"\x00garbage half-written snapshot")
        srv2 = _server(num_schedulers=0, data_dir=data_dir)
        try:
            assert len(srv2.store.nodes()) == 5
            assert not os.path.exists(tmp)
        finally:
            srv2.shutdown()


class TestGroupFsync:
    def _write_wal(self, tmp_path, name, group, entries, monkeypatch):
        """Record one committed BATCH of entries (the raft FSM batch
        shape — apply_replicated records per entry, the batch boundary
        calls commit_barrier once) and count fsyncs."""
        import nomad_tpu_torch.server.persistence as pmod
        count = [0]
        real_fsync = os.fsync

        def counting_fsync(fd):
            count[0] += 1
            return real_fsync(fd)

        monkeypatch.setattr(pmod.os, "fsync", counting_fsync)
        try:
            p = Persistence(str(tmp_path / name), wal_fsync=True,
                            wal_group_fsync=group)
            p.log.open()
            for index, msg_type, payload in entries:
                p.record(index, msg_type, payload)
            p.commit_barrier()
            p.log.close()
        finally:
            monkeypatch.setattr(pmod.os, "fsync", real_fsync)
        return str(tmp_path / name), count[0]

    def test_group_fsync_equivalent_state_fewer_syncs(self, tmp_path,
                                                      monkeypatch):
        """Group-fsync ≡ per-entry fsync on replayed store state; the
        group path pays ONE fsync per committed batch instead of one
        per entry."""
        nodes = [mock.node() for _ in range(10)]
        entries = [(100 + i, "node_register", dict(node=n))
                   for i, n in enumerate(nodes)]
        d_entry, n_entry = self._write_wal(tmp_path, "entry", False,
                                           entries, monkeypatch)
        d_group, n_group = self._write_wal(tmp_path, "group", True,
                                           entries, monkeypatch)
        assert n_entry == 10        # one fsync per record
        assert n_group == 1         # one fsync per committed batch

        def replay_into_store(data_dir):
            s = StateStore()
            for idx, mt, payload, _ts in RaftLog(
                    os.path.join(data_dir, "raft.log")).replay():
                s.upsert_node(idx, payload["node"])
            return s

        s1 = replay_into_store(d_entry)
        s2 = replay_into_store(d_group)
        assert _canon(s1.dump()) == _canon(s2.dump())
        assert len(s1.nodes()) == 10


class TestRestoreIntoContract:
    def test_returns_tuple(self, tmp_path):
        """The documented contract matches the implementation: the
        docstring names the tuple it returns."""
        p = Persistence(str(tmp_path / "c"))
        out = p.restore_into(StateStore())
        p.log.close()
        assert isinstance(out, tuple) and len(out) == 2
        highest, entries = out
        assert highest == 0 and entries == []
        assert "(highest, entries)" in Persistence.restore_into.__doc__


# -- the port's own -------------------------------------------------------

def test_endpoint_entries_survive_the_wal_and_a_snapshot(tmp_path):
    """Namespaces, service registrations and CSI volumes written through
    the server's endpoints come back after a restart, from the WAL tail
    alone and from a snapshot plus tail; deletions replay too."""
    data_dir = str(tmp_path / "endpoints")
    srv = _server(num_schedulers=0, data_dir=data_dir,
                  snapshot_background=False)
    try:
        srv.upsert_namespaces([Namespace(name="prod", description="p"),
                               Namespace(name="gone")])
        srv.delete_namespaces(["gone"])
        with pytest.raises(ValueError, match="can not be deleted"):
            srv.delete_namespaces(["default"])
        srv.update_service_registrations(upserts=[
            ServiceRegistration(id="svc-1", service_name="web",
                                namespace="default", node_id="n1",
                                alloc_id="a1", tags=["b", "a"]),
            ServiceRegistration(id="svc-2", service_name="web",
                                namespace="default", node_id="n2",
                                alloc_id="a2", tags=["c"]),
            ServiceRegistration(id="svc-3", service_name="db",
                                namespace="default", node_id="n2",
                                alloc_id="a3")])
        srv.register_csi_volume(CSIVolume(id="v1", plugin_id="p1"))
        srv.persistence.snapshot(srv.store)
        srv.update_service_registrations(delete_alloc_ids=["a3"])
        srv.register_csi_volume(CSIVolume(id="v2", plugin_id="p1"))
        srv.deregister_csi_volume("default", "v1")
        want = _canon(srv.store.dump())
        want_services = srv.list_services()
    finally:
        srv.shutdown()
    srv2 = _server(num_schedulers=0, data_dir=data_dir)
    try:
        assert srv2.cold_start_stats["wal_entries_replayed"] == 3
        assert _canon(srv2.store.dump()) == want
        assert srv2.store.namespace_by_name("prod") is not None
        assert srv2.store.namespace_by_name("gone") is None
        assert srv2.list_services() == want_services == [
            {"ServiceName": "web", "Namespace": "default",
             "Tags": ["a", "b", "c"], "Instances": 2}]
        assert {s.id for s in srv2.get_service("default", "web")} == {
            "svc-1", "svc-2"}
        assert [v.id for v in srv2.store.csi_volumes()] == ["v2"]
    finally:
        srv2.shutdown()


def test_wal_settings_reach_the_log(tmp_path, monkeypatch):
    """ServerConfig's wal_fsync / wal_group_fsync: in dev mode each
    applied entry is its own commit, so both settings fsync once an
    entry, and without wal_fsync nothing is fsynced."""
    import nomad_tpu_torch.server.persistence as pmod
    real_fsync = os.fsync
    counts = {}
    for fsync, group in ((False, True), (True, True), (True, False)):
        n = [0]

        def counting_fsync(fd, n=n):
            n[0] += 1
            return real_fsync(fd)

        monkeypatch.setattr(pmod.os, "fsync", counting_fsync)
        srv = _server(num_schedulers=0, snapshot_every=10_000,
                      data_dir=str(tmp_path / f"{fsync}-{group}"),
                      wal_fsync=fsync, wal_group_fsync=group)
        try:
            for _ in range(6):
                srv.raft_apply("node_register", dict(node=mock.node()))
        finally:
            srv.shutdown()
        counts[(fsync, group)] = n[0]
        monkeypatch.setattr(pmod.os, "fsync", real_fsync)
    assert counts == {(False, True): 0, (True, True): 6, (True, False): 6}


def test_cold_start_stats_and_the_primed_table(tmp_path):
    """A restart from a snapshot plus a tail reports every stage, joins
    the prefetch at construction (the mirror holds the primed table) and
    serves its first read of the node table by the delta path."""
    data_dir = str(tmp_path / "stats")
    srv = _server(num_schedulers=0, data_dir=data_dir,
                  snapshot_background=False)
    try:
        nodes = [mock.node() for _ in range(6)]
        for n in nodes:
            srv.raft_apply("node_register", dict(node=n))
        srv.persistence.snapshot(srv.store)
        job = mock.job()
        srv.raft_apply("job_register", dict(job=job))
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = nodes[0].id
        srv.raft_apply("plan_results", dict(
            allocs_stopped=[], allocs_placed=[a], allocs_preempted=[]))
    finally:
        srv.shutdown()
    srv2 = _server(num_schedulers=0, data_dir=data_dir)
    try:
        st = srv2.cold_start_stats
        assert set(st) == {"restore_s", "table_build_s", "wal_replay_s",
                           "wal_entries_replayed", "snapshot_format",
                           "prefetch_join_s"}
        assert st["snapshot_format"] == 2.0
        assert st["wal_entries_replayed"] == 2.0
        cache = srv2.store.table_cache
        assert cache.stats["primes"] == 1
        assert cache.device.device_bytes() > 0     # uploaded at start
        t = srv2.store.snapshot().node_table()
        assert cache.stats["full_builds"] == 0
        assert cache.stats["delta_refreshes"] == 1
        assert t.device_version == cache.device.version
        assert not any(th.name == "node-table-prefetch" and th.is_alive()
                       for th in threading.enumerate())
    finally:
        srv2.shutdown()


def test_failed_prefetch_fails_the_construction(tmp_path, monkeypatch):
    from nomad_tpu_torch.ops.tables import NodeTableCache
    data_dir = str(tmp_path / "fail")
    srv = _server(num_schedulers=0, data_dir=data_dir,
                  snapshot_background=False)
    try:
        srv.raft_apply("node_register", dict(node=mock.node()))
        srv.persistence.snapshot(srv.store)
    finally:
        srv.shutdown()

    def refuse(self, device):
        raise RuntimeError("prefetch: upload refused")

    monkeypatch.setattr(NodeTableCache, "prefetch_device", refuse)
    opened = []
    real_open = RaftLog.open

    def tracked_open(self):
        real_open(self)
        opened.append(self)

    monkeypatch.setattr(RaftLog, "open", tracked_open)
    with pytest.raises(RuntimeError, match="upload refused"):
        _server(num_schedulers=0, data_dir=data_dir)
    # the failed construction leaves no log file open
    assert opened and all(log._f is None for log in opened)


def test_shutdown_closes_the_log_and_raises_a_failed_save(tmp_path):
    """Shutdown closes the WAL after its last fsync; a cost model that
    cannot be saved raises once every thread is joined."""
    data_dir = str(tmp_path / "save")
    srv = _server(num_schedulers=1, data_dir=data_dir,
                  heartbeat_ttl_s=3600.0)
    srv.start()

    def broken():
        raise OSError("disk full")

    srv.persistence.cost_model_provider = broken
    threads = list(srv._threads) + [w._thread for w in srv.workers]
    assert {t.name for t in srv._threads} == {
        "eval-reaper", "gc-ticker", "volume-watcher"}
    with pytest.raises(OSError, match="disk full"):
        srv.shutdown()
    assert srv.persistence.log._f is None
    assert not any(t.is_alive() for t in threads)


# -- tests/test_persistence.py: restarts beside a Client ---------------
def _wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_server_restart_recovers_state(tmp_path):
    data_dir = str(tmp_path / "data")
    server = Server(ServerConfig(num_schedulers=2, data_dir=data_dir,
                                 heartbeat_ttl_s=60.0), device="cpu")
    server.start()
    client = Client(server, ClientConfig(node_name="persist-client"))
    client.start()
    job = mock.batch_job()
    job.type = "service"
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {"run_for": "60s"}
    job.canonicalize()
    server.register_job(job)
    assert _wait_for(lambda: len(
        server.store.allocs_by_job("default", job.id)) == 2)
    node_id = client.node.id
    client.shutdown()
    server.shutdown()

    # "restart" the server from the same data dir
    server2 = Server(ServerConfig(num_schedulers=2, data_dir=data_dir,
                                  heartbeat_ttl_s=60.0), device="cpu")
    assert server2.store.job_by_id("default", job.id) is not None
    assert len(server2.store.allocs_by_job("default", job.id)) == 2
    assert server2.store.node_by_id(node_id) is not None
    assert server2._raft_index >= server.store.latest_index()
    server2.start()
    server2.shutdown()


def test_blocked_eval_survives_restart(tmp_path):
    data_dir = str(tmp_path / "blocked")
    server = Server(ServerConfig(num_schedulers=2, data_dir=data_dir,
                                 heartbeat_ttl_s=60.0), device="cpu")
    server.start()
    client = Client(server, ClientConfig(node_name="c1"))
    client.start()
    job = mock.batch_job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = 9000   # cannot place
    server.register_job(job)
    assert _wait_for(lambda: server.blocked_evals.blocked_count() == 1)
    client.shutdown()
    server.shutdown()

    server2 = Server(ServerConfig(num_schedulers=2, data_dir=data_dir,
                                  heartbeat_ttl_s=60.0), device="cpu")
    server2.start()   # restore_evals re-blocks it
    assert server2.blocked_evals.blocked_count() == 1
    # a big node joining unblocks and places
    big = Client(server2, ClientConfig(node_name="big", cpu_shares=16000))
    big.start()
    try:
        assert _wait_for(lambda: len(
            server2.store.allocs_by_job("default", job.id)) == 1, timeout=15)
    finally:
        big.shutdown()
        server2.shutdown()
