"""The reference's alloc_exec suite (tests/test_alloc_exec.py) against the port's
client/fs_service.py, client/remote.py and the HTTP API's forwarding, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Alloc exec + framed log/fs streaming + server->client forwarding.

Reference scenarios: client/alloc_endpoint.go:163 (Allocations.Exec
round-trips stdin/stdout against a task), client/lib/streamframer/
framer.go (File/Offset/Data frames, heartbeat when idle),
nomad/client_fs_endpoint.go (servers forward fs/logs to the owning
client when the request lands elsewhere).
"""

import os
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import ApiClient, HTTPApiServer
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.client import fs_service
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.rpc.transport import RemoteTransport
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# -- fs_service units --------------------------------------------------

def test_stream_frames_offsets_heartbeat_and_truncation(tmp_path):
    base = tmp_path / "alloc1"
    (base / "t").mkdir(parents=True)
    f = base / "t" / "out.txt"
    f.write_bytes(b"hello world")

    frames = fs_service.stream_frames(str(base), "t/out.txt", 0)
    assert frames[0]["Data"] == b"hello world"
    assert frames[0]["Offset"] == 0

    # resume from offset
    frames = fs_service.stream_frames(str(base), "t/out.txt", 6)
    assert frames[0]["Data"] == b"world"
    assert frames[0]["Offset"] == 6

    # idle source -> heartbeat frame with the current offset
    frames = fs_service.stream_frames(str(base), "t/out.txt", 11)
    assert frames[0].get("Heartbeat") is True
    assert frames[0]["Offset"] == 11 and frames[0]["Data"] == b""

    # truncation -> FileEvent so consumers restart from 0
    f.write_bytes(b"x")
    frames = fs_service.stream_frames(str(base), "t/out.txt", 11)
    assert frames[0].get("FileEvent") == "truncated"
    assert frames[0]["Offset"] == 0

    # big files split into bounded frames with running offsets
    f.write_bytes(b"a" * (fs_service.MAX_FRAME_BYTES + 7))
    frames = fs_service.stream_frames(str(base), "t/out.txt", 0)
    assert len(frames) == 2
    assert frames[1]["Offset"] == fs_service.MAX_FRAME_BYTES
    assert len(frames[1]["Data"]) == 7


def test_stream_frames_rejects_path_escape(tmp_path):
    base = tmp_path / "alloc2"
    base.mkdir()
    with pytest.raises(fs_service.PathEscapeError):
        fs_service.stream_frames(str(base), "../../etc/passwd", 0)


def test_exec_session_round_trips_stdin(tmp_path):
    sess = fs_service.ExecSession(["cat"], cwd=str(tmp_path), env=None)
    sess.write_stdin(b"ping pong\n", close=True)
    out = b""
    deadline = time.time() + 10
    while time.time() < deadline:
        r = sess.poll(wait_s=0.5)
        out += r["stdout"]
        if r["exited"]:
            assert r["exit_code"] == 0
            break
    assert out == b"ping pong\n"


# -- end to end through the cluster ------------------------------------

@pytest.fixture
def cluster(tmp_path):
    """Server + wire-RPC client with a PRIVATE alloc dir the HTTP agent
    cannot see — every fs/logs/exec request must forward over RPC to
    the owning client (the two-process topology's request path)."""
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    rpc = RpcServer(server, port=0)
    rpc.start()
    server.start()
    client = Client(RemoteTransport(rpc.addr),
                    ClientConfig(node_name="exec-client",
                                 alloc_dir=str(tmp_path / "private")))
    client.start()
    api = HTTPApiServer(server, port=0,
                        alloc_dir_bases=[str(tmp_path / "elsewhere")])
    api.start()
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    yield server, client, c
    api.shutdown()
    client.shutdown()
    server.shutdown()
    rpc.shutdown()


def _run_job(server, job_id, driver, config, count=1):
    job = mock.batch_job()
    job.id = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].driver = driver
    tg.tasks[0].config = config
    tg.tasks[0].resources.networks = []
    tg.networks = []
    server.register_job(job)
    return job


@pytest.mark.slow
def test_alloc_exec_round_trip_against_exec_driver(cluster):
    server, client, c = cluster
    _run_job(server, "execjob", "raw_exec",
             {"command": "sh", "args": ["-c", "sleep 60"]})
    assert _wait(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "execjob")))
    alloc = server.store.allocs_by_job("default", "execjob")[0]

    sid = c.alloc_exec_start(alloc.id, ["cat"])
    out = b""
    r = c.alloc_exec_io(alloc.id, sid, stdin=b"over the wire\n",
                        close_stdin=True, wait_s=2.0)
    out += r["stdout"]
    deadline = time.time() + 15
    while not r["exited"] and time.time() < deadline:
        r = c.alloc_exec_io(alloc.id, sid, wait_s=1.0)
        out += r["stdout"]
    assert r["exited"] and r["exit_code"] == 0
    assert out == b"over the wire\n"

    # command output from inside the task dir
    sid = c.alloc_exec_start(alloc.id, ["pwd"])
    r = c.alloc_exec_io(alloc.id, sid, close_stdin=True, wait_s=2.0)
    out = r["stdout"]
    deadline = time.time() + 15
    while not r["exited"] and time.time() < deadline:
        r = c.alloc_exec_io(alloc.id, sid, wait_s=1.0)
        out += r["stdout"]
    assert alloc.id in out.decode(), out


@pytest.mark.slow
def test_alloc_exec_against_mock_driver(cluster):
    server, client, c = cluster
    _run_job(server, "mockjob", "mock_driver", {"run_for": "60s"})
    assert _wait(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "mockjob")))
    alloc = server.store.allocs_by_job("default", "mockjob")[0]
    sid = c.alloc_exec_start(alloc.id, ["echo", "hi"])
    r = c.alloc_exec_io(alloc.id, sid, stdin=b"mock stdin",
                        close_stdin=True, wait_s=1.0)
    got = r["stdout"]
    while not r["exited"]:
        r = c.alloc_exec_io(alloc.id, sid, wait_s=0.5)
        got += r["stdout"]
    assert b"echo hi" in got and b"mock stdin" in got


@pytest.mark.slow
def test_fs_and_logs_forwarded_to_owning_client(cluster):
    server, client, c = cluster
    _run_job(server, "logjob", "raw_exec",
             {"command": "sh",
              "args": ["-c", "echo forwarded-hello; "
                             "echo data > ${NOMAD_TASK_DIR}/file.txt; "
                             "sleep 60"]})
    assert _wait(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "logjob")))
    alloc = server.store.allocs_by_job("default", "logjob")[0]
    # the HTTP agent has NO local copy: this must forward over RPC
    assert _wait(lambda: "forwarded-hello" in (c._request(
        "GET", f"/v1/client/fs/logs/{alloc.id}",
        params={"task": alloc.task_group}) or {}).get("Data", ""))

    # framed log streaming with offset resume + heartbeat
    frames = c.alloc_fs_stream(alloc.id, task=alloc.task_group,
                               log_type="stdout")
    data = b"".join(f["Data"] for f in frames)
    assert b"forwarded-hello" in data
    next_off = frames[-1]["Offset"] + len(frames[-1]["Data"])
    hb = c.alloc_fs_stream(alloc.id, task=alloc.task_group,
                           log_type="stdout", offset=next_off)
    assert hb[-1].get("Heartbeat") is True

    # fs ls/cat forwarded
    assert _wait(lambda: any(
        e["Name"] == "file.txt" for e in (c._request(
            "GET", f"/v1/client/fs/ls/{alloc.id}",
            params={"path": f"{alloc.task_group}"}) or [])))
    out = c._request("GET", f"/v1/client/fs/cat/{alloc.id}",
                     params={"path": f"{alloc.task_group}/file.txt"})
    assert out["Data"].strip() == "data"
