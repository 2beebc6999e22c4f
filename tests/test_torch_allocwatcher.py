"""The reference's allocwatcher suite (tests/test_allocwatcher.py) against the port's
client/allocwatcher.py, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Previous-allocation watcher: ephemeral disk migration, local and
remote (reference: client/allocwatcher/alloc_watcher.go — replacement
allocs wait on their predecessor and pull its disk when the group sets
ephemeral_disk {migrate = true}; remote pulls ride the owning client's
fs API, migrateRemoteAllocDir)."""

import os
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import Constraint
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.rpc.transport import RemoteTransport
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait(pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _disk_job(job_id, write_marker):
    """A raw_exec job that writes a marker into its shared data dir
    then sleeps; ephemeral_disk.migrate on."""
    job = mock.batch_job()
    job.id = job_id
    tg = job.task_groups[0]
    tg.count = 1
    tg.ephemeral_disk.migrate = True
    tg.ephemeral_disk.sticky = True
    tg.tasks[0].driver = "raw_exec"
    tg.tasks[0].config = {
        "command": "sh",
        "args": ["-c",
                 f"if [ ! -f ${{NOMAD_ALLOC_DIR}}/data/marker ]; then "
                 f"echo {write_marker} > ${{NOMAD_ALLOC_DIR}}/data/marker; "
                 f"fi; sleep 120"]}
    tg.tasks[0].resources.networks = []
    tg.networks = []
    return job


@pytest.mark.slow
def test_remote_disk_migration_between_clients(tmp_path):
    """The predecessor runs on client A; a node-constraint update
    forces the replacement onto client B, which pulls the data dir
    over A's client RPC before starting tasks."""
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    rpc = RpcServer(server, port=0)
    rpc.start()
    server.start()
    ca = Client(RemoteTransport(rpc.addr),
                ClientConfig(node_name="disk-a",
                             alloc_dir=str(tmp_path / "a"),
                             meta={"side": "a"}))
    cb = Client(RemoteTransport(rpc.addr),
                ClientConfig(node_name="disk-b",
                             alloc_dir=str(tmp_path / "b"),
                             meta={"side": "b"}))
    ca.start()
    cb.start()
    try:
        job = _disk_job("diskmig", "precious-bytes")
        job.task_groups[0].constraints = [
            Constraint(ltarget="${meta.side}", rtarget="a", operand="=")]
        server.register_job(job)
        assert _wait(lambda: any(
            a.client_status == "running" and a.node_id == ca.node.id
            for a in server.store.allocs_by_job("default", "diskmig")))
        a0 = server.store.allocs_by_job("default", "diskmig")[0]
        marker_a = os.path.join(str(tmp_path / "a"), a0.id,
                                "alloc", "data", "marker")
        assert _wait(lambda: os.path.isfile(marker_a))

        # move the job to client B: destructive update via constraint
        job2 = _disk_job("diskmig", "should-not-overwrite")
        job2.task_groups[0].constraints = [
            Constraint(ltarget="${meta.side}", rtarget="b", operand="=")]
        server.register_job(job2)

        def replacement():
            return [a for a in server.store.allocs_by_job(
                "default", "diskmig")
                if a.node_id == cb.node.id
                and not a.terminal_status()]
        assert _wait(lambda: any(
            a.client_status == "running" for a in replacement()),
            timeout=90), [
                (a.client_status, a.node_id[:8]) for a in
                server.store.allocs_by_job("default", "diskmig")]
        a1 = replacement()[0]
        assert a1.previous_allocation == a0.id
        marker_b = os.path.join(str(tmp_path / "b"), a1.id,
                                "alloc", "data", "marker")
        assert _wait(lambda: os.path.isfile(marker_b), timeout=30)
        # the MIGRATED bytes, not a fresh write
        assert open(marker_b).read().strip() == "precious-bytes"
    finally:
        ca.shutdown()
        cb.shutdown()
        server.shutdown()
        rpc.shutdown()


def test_local_disk_migration_same_node(tmp_path):
    """Reschedule on the SAME node copies the disk locally."""
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    server.start()
    c = Client(server, ClientConfig(node_name="disk-local",
                                    alloc_dir=str(tmp_path / "l")))
    c.start()
    try:
        job = _disk_job("disklocal", "local-bytes")
        server.register_job(job)
        assert _wait(lambda: any(
            a.client_status == "running"
            for a in server.store.allocs_by_job("default", "disklocal")))
        a0 = server.store.allocs_by_job("default", "disklocal")[0]
        assert _wait(lambda: os.path.isfile(os.path.join(
            str(tmp_path / "l"), a0.id, "alloc", "data", "marker")))

        # destructive update (command change) replaces the alloc
        job2 = _disk_job("disklocal", "fresh-bytes")
        job2.task_groups[0].tasks[0].config["args"] = [
            "-c",
            "if [ ! -f ${NOMAD_ALLOC_DIR}/data/marker ]; then "
            "echo fresh-bytes > ${NOMAD_ALLOC_DIR}/data/marker; fi; "
            "sleep 60"]
        server.register_job(job2)

        def repl():
            return [a for a in server.store.allocs_by_job(
                "default", "disklocal")
                if a.id != a0.id and not a.terminal_status()]
        assert _wait(lambda: any(a.client_status == "running"
                                 for a in repl()), timeout=60)
        a1 = repl()[0]
        marker = os.path.join(str(tmp_path / "l"), a1.id,
                              "alloc", "data", "marker")
        assert _wait(lambda: os.path.isfile(marker))
        assert open(marker).read().strip() == "local-bytes"
    finally:
        c.shutdown()
        server.shutdown()


def test_watcher_tolerates_gcd_previous(tmp_path):
    """A replacement whose predecessor is gone (GC) starts with a
    fresh disk instead of blocking; one that never terminates reports
    timeout so the caller skips the torn-copy hazard."""
    from nomad_tpu_torch.client.allocwatcher import wait_for_previous
    assert wait_for_previous(lambda _id: None, "gone",
                             timeout_s=5) == ("gone", None)
    live = {"alloc": {"client_status": "running",
                      "desired_status": "run"}}
    status, _ = wait_for_previous(lambda _id: live, "busy", timeout_s=1)
    assert status == "timeout"
