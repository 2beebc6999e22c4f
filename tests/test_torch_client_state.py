"""The reference's client_state suite (tests/test_client_state.py) against the port's
client/state_db.py and the Client's restore, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Client durability: state DB persistence, restore on restart,
re-attach to live tasks (reference: client/state/state_database.go,
client.go restoreState:1055, task_runner.go RestoreState:996).
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)
from torch_client_helpers import reap_detached

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.client.drivers import MockDriver, RawExecDriver
from nomad_tpu_torch.client.state_db import ClientStateDB
from nomad_tpu_torch.models import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_RUNNING,
                              TaskState)
from nomad_tpu_torch.models.alloc import TASK_STATE_RUNNING
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# -- state db ----------------------------------------------------------
def test_state_db_roundtrip_and_journal_replay(tmp_path):
    d = str(tmp_path / "client")
    db = ClientStateDB(d)
    a = mock.alloc()
    db.put_alloc(a)
    db.put_task(a.id, "web", TaskState(state=TASK_STATE_RUNNING),
                {"id": "h1", "driver": "mock_driver", "task_name": "web",
                 "config": {}, "pid": None, "started_at": 1.0})
    db.close()

    db2 = ClientStateDB(d)
    rec = db2.state[a.id]
    assert rec["alloc"]["id"] == a.id
    assert rec["tasks"]["web"]["state"]["state"] == TASK_STATE_RUNNING
    assert rec["tasks"]["web"]["handle"]["id"] == "h1"
    db2.delete_alloc(a.id)
    db2.close()
    db3 = ClientStateDB(d)
    assert a.id not in db3.state


def test_state_db_compaction(tmp_path):
    from nomad_tpu_torch.client import state_db as sdb
    d = str(tmp_path / "client")
    db = ClientStateDB(d)
    old = sdb.COMPACT_EVERY
    sdb.COMPACT_EVERY = 10
    try:
        a = mock.alloc()
        for i in range(25):
            db.put_task(a.id, "web", TaskState(state=TASK_STATE_RUNNING),
                        {"id": f"h{i}", "driver": "mock_driver",
                         "task_name": "web", "config": {},
                         "pid": None, "started_at": 1.0})
        assert db._journal_len < 10
    finally:
        sdb.COMPACT_EVERY = old
        db.close()
    db2 = ClientStateDB(d)
    assert db2.state[a.id]["tasks"]["web"]["handle"]["id"] == "h24"


def test_state_db_tolerates_torn_journal_tail(tmp_path):
    d = str(tmp_path / "client")
    db = ClientStateDB(d)
    a = mock.alloc()
    db.put_alloc(a)
    db.close()
    with open(db._journal_path, "a") as f:
        f.write('{"op": "del_alloc", "alloc_')    # torn write
    db2 = ClientStateDB(d)
    assert a.id in db2.state


def test_identity_persists(tmp_path):
    d = str(tmp_path / "client")
    db = ClientStateDB(d)
    db.save_identity("node-1", "secret-1")
    db.close()
    assert ClientStateDB(d).load_identity() == {
        "node_id": "node-1", "secret_id": "secret-1"}


# -- driver recovery ---------------------------------------------------
def test_mock_driver_recover_running_and_finished():
    drv = MockDriver()
    h = drv.start_task("t", {"run_for": "10s"}, {})
    st = h.recoverable_state()
    h2 = drv.recover_task(st)
    assert h2 is not None and not h2.done()
    drv.stop_task(h2, 1.0)
    drv.stop_task(h, 1.0)
    # a task past its run_for completes immediately on recovery
    st_old = dict(st)
    st_old["started_at"] = time.time() - 100
    h3 = drv.recover_task({**st_old, "config": {"run_for": "1s"}})
    assert h3.wait(1.0) and h3.exit_code == 0
    # recovery failure knob
    assert drv.recover_task(
        {**st, "config": {"recover_error": "boom"}}) is None


def test_raw_exec_recover_by_pid():
    import subprocess
    import sys
    drv = RawExecDriver()
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        st = {"id": "x", "task_name": "t", "driver": "raw_exec",
              "config": {}, "pid": proc.pid, "started_at": time.time()}
        h = drv.recover_task(st)
        assert h is not None and not h.done()
        drv.stop_task(h, 2.0)
        assert h.done()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    # dead pid -> no recovery
    assert drv.recover_task({"id": "y", "task_name": "t",
                             "driver": "raw_exec", "config": {},
                             "pid": proc.pid,
                             "started_at": time.time()}) is None


# -- restart-without-kill e2e ------------------------------------------
def test_client_restart_reattaches_running_tasks(tmp_path):
    state_dir = str(tmp_path / "client-state")
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    c1 = Client(server, ClientConfig(node_name="durable",
                                     state_dir=state_dir))
    c1.start()
    try:
        job = mock.batch_job()
        job.type = "service"
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].config = {"run_for": "60s"}
        job.canonicalize()
        server.register_job(job)
        assert _wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 2
            and all(a.client_status == ALLOC_CLIENT_RUNNING
                    for a in server.store.allocs_by_job("default", job.id)))

        # "crash": detach without killing tasks
        c1.shutdown(kill_tasks=False)

        # restart from the same state dir
        c2 = Client(server, ClientConfig(node_name="durable",
                                         state_dir=state_dir))
        assert c2.node.id == c1.node.id, "node identity must be stable"
        c2.start()
        try:
            assert len(c2.runners) == 2, "runners restored from state db"
            # restored tasks are RUNNING without having been restarted
            def all_running_no_restart():
                allocs = server.store.allocs_by_job("default", job.id)
                return all(
                    a.client_status == ALLOC_CLIENT_RUNNING and
                    all(ts.restarts == 0
                        for ts in (a.task_states or {}).values())
                    for a in allocs)
            assert _wait_for(all_running_no_restart, timeout=5)
            for runner in c2.runners.values():
                for tr in runner.task_runners:
                    assert tr.state.state == TASK_STATE_RUNNING
        finally:
            c2.shutdown()
    finally:
        reap_detached(c1)
        server.shutdown()


def test_client_restart_completes_short_task(tmp_path):
    """An alloc whose task finished while the client was down completes
    (recovery reconstructs the elapsed runtime)."""
    state_dir = str(tmp_path / "client-state")
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    c1 = Client(server, ClientConfig(node_name="durable2",
                                     state_dir=state_dir))
    c1.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].config = {"run_for": "400ms"}
        server.register_job(job)
        assert _wait_for(lambda: any(
            a.client_status == ALLOC_CLIENT_RUNNING
            for a in server.store.allocs_by_job("default", job.id)))
        c1.shutdown(kill_tasks=False)
        time.sleep(0.6)               # task 'finishes' while down

        c2 = Client(server, ClientConfig(node_name="durable2",
                                         state_dir=state_dir))
        c2.start()
        try:
            assert _wait_for(lambda: all(
                a.client_status == ALLOC_CLIENT_COMPLETE
                for a in server.store.allocs_by_job("default", job.id)))
        finally:
            c2.shutdown()
    finally:
        reap_detached(c1)
        server.shutdown()


def test_heartbeatstop_stops_marked_allocs():
    """heartbeatstop.go: allocs with stop_after_client_disconnect stop
    once the client has been server-less past the TTL + duration;
    unmarked allocs keep running."""
    from nomad_tpu_torch.models import ALLOC_CLIENT_RUNNING
    from nomad_tpu_torch.rpc.transport import InProcTransport

    class FlakyTransport(InProcTransport):
        fail = False

        def heartbeat(self, node_id, stats=None):
            if self.fail:
                raise ConnectionError("servers unreachable")
            return 0.2    # tiny TTL so the test is fast

    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    transport = FlakyTransport(server)
    client = Client(transport,
                    ClientConfig(node_name="hb-stop",
                                 heartbeat_interval_s=0.1))
    client.start()
    try:
        job = mock.batch_job()
        job.type = "service"
        job.id = "stops"
        tg = job.task_groups[0]
        tg.count = 1
        tg.stop_after_client_disconnect_s = 0.3
        tg.tasks[0].config = {"run_for": "60s"}
        job.canonicalize()
        server.register_job(job)

        job2 = mock.batch_job()
        job2.type = "service"
        job2.id = "stays"
        job2.task_groups[0].count = 1
        job2.task_groups[0].tasks[0].config = {"run_for": "60s"}
        job2.canonicalize()
        server.register_job(job2)

        assert _wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_RUNNING
            for j in ("stops", "stays")
            for a in server.store.allocs_by_job("default", j))
            and server.store.allocs_by_job("default", "stops")
            and server.store.allocs_by_job("default", "stays"))

        transport.fail = True
        stop_alloc = server.store.allocs_by_job("default", "stops")[0]
        stay_alloc = server.store.allocs_by_job("default", "stays")[0]

        def _stopped():
            # the runner may already be GC'd out of the dict once
            # destroyed — both count as stopped
            r = client.runners.get(stop_alloc.id)
            return r is None or r.destroyed
        assert _wait_for(_stopped, timeout=10)
        stay = client.runners.get(stay_alloc.id)
        assert stay is not None and not stay.destroyed
    finally:
        client.shutdown()
        server.shutdown()
