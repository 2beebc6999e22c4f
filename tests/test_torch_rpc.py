"""The reference's wire RPC suite (tests/test_rpc.py: msgpack frames over
TCP between a server and its clients; reference nomad/rpc.go,
node_endpoint.go:926 long-poll) against the port's rpc/ and Server on
the CPU, assertions unchanged: its four raw RpcServer / RpcClient tests.

Then the two that need a client agent: test_client_agent_runs_job_over_wire
(the port's Client over RemoteTransport) and
test_server_and_client_subprocesses (`agent -server` and `agent -client`
as subprocesses on the CPU, on free ports).

Besides: the Vault verbs refuse what the authority does not know (an
alloc, an accessor), a frame past MAX_FRAME is refused, and a stopped
RpcServer closes the connections it was serving."""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import ALLOC_CLIENT_COMPLETE
from nomad_tpu_torch.rpc import RemoteTransport, RpcClient, RpcError, RpcServer
from nomad_tpu_torch.rpc.codec import MAX_FRAME, FrameCodec
from nomad_tpu_torch.server import Server, ServerConfig


@pytest.fixture
def rpc_cluster():
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0),
                    device="cpu")
    server.start()
    rpc = RpcServer(server, port=0)
    rpc.start()
    yield server, rpc
    rpc.shutdown()
    server.shutdown()


# -- tests/test_rpc.py, tier 1: raw rpc ---------------------------------
def test_ping_and_unknown_method(rpc_cluster):
    _server, rpc = rpc_cluster
    c = RpcClient(rpc.addr)
    assert c.call("Status.Ping")["status"] == "ok"
    with pytest.raises(RpcError, match="unknown rpc method"):
        c.call("No.Such.Method")
    c.close()


def test_node_register_and_heartbeat_over_wire(rpc_cluster):
    server, rpc = rpc_cluster
    t = RemoteTransport(rpc.addr)
    node = mock.node()
    ttl = t.register_node(node)
    assert ttl > 0
    assert server.store.node_by_id(node.id) is not None
    assert t.heartbeat(node.id) > 0
    with pytest.raises(RpcError):
        t.heartbeat("nonexistent-node")
    t.close()


def test_get_client_allocs_blocks_until_index(rpc_cluster):
    server, rpc = rpc_cluster
    t = RemoteTransport(rpc.addr)
    node = mock.node()
    t.register_node(node)
    allocs, index = t.get_client_allocs(node.id, 0, 1.0)
    assert allocs == []
    # a long-poll past the current index should block ~max_wait
    t0 = time.time()
    _allocs, index2 = t.get_client_allocs(node.id, index, 0.5)
    elapsed = time.time() - t0
    assert elapsed >= 0.3
    assert index2 >= index
    t.close()


def test_concurrent_calls_one_connection(rpc_cluster):
    """A slow long-poll must not block other calls on the same
    connection (the yamux-multiplexing property)."""
    server, rpc = rpc_cluster
    t = RemoteTransport(rpc.addr)
    node = mock.node()
    t.register_node(node)
    _, index = t.get_client_allocs(node.id, 0, 1.0)

    done = []

    def long_poll():
        t.get_client_allocs(node.id, index, 3.0)
        done.append("poll")

    th = threading.Thread(target=long_poll, daemon=True)
    th.start()
    time.sleep(0.1)
    t0 = time.time()
    t.heartbeat(node.id)          # same TCP connection, should not wait
    assert time.time() - t0 < 1.0
    th.join(timeout=10)
    assert done == ["poll"]
    t.close()


# -- the port's own -----------------------------------------------------
@pytest.mark.parametrize("method", ["Node.DeriveVaultToken",
                                    "Node.RenewVaultToken"])
def test_vault_verbs_refuse_without_an_authority(rpc_cluster, method):
    """The authority answers the verbs, and refuses an alloc or an
    accessor it has no lease for."""
    _server, rpc = rpc_cluster
    c = RpcClient(rpc.addr)
    try:
        with pytest.raises(RpcError, match="alloc a not found|unknown "
                                           "vault accessor"):
            c.call(method, {"alloc_id": "a", "tasks": ["t"],
                            "accessor": "x", "token": "y"})
    finally:
        c.close()


def test_frame_past_max_frame_is_refused():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(RpcError, match="frame too large"):
            FrameCodec(b).read_frame()
        FrameCodec(a).write_frame([1, "Status.Ping", {}])
        assert FrameCodec(b).read_frame() == [1, "Status.Ping", {}]
    finally:
        a.close()
        b.close()


def test_shutdown_closes_live_connections(rpc_cluster):
    """A stopped endpoint stops answering on connections opened before
    it stopped: the next call on them fails instead of reaching the
    server."""
    _server, rpc = rpc_cluster
    c = RpcClient(rpc.addr, dial_timeout_s=0.5)
    assert c.call("Status.Ping")["status"] == "ok"
    rpc.shutdown()
    # the dropped connection fails the call, or a redial is refused
    with pytest.raises((RpcError, OSError)):
        c.call("Status.Ping", timeout_s=2.0)
    c.close()


# -- tests/test_rpc.py: a client agent over the wire --------------------
REPO = Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def test_client_agent_runs_job_over_wire(rpc_cluster):
    server, rpc = rpc_cluster
    client = Client(RemoteTransport(rpc.addr),
                    ClientConfig(node_name="wire-client"))
    client.start()
    try:
        assert _wait_for(lambda: server.store.node_by_id(client.node.id)
                         is not None)
        job = mock.batch_job()
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].config = {"run_for": "100ms"}
        server.register_job(job)
        assert _wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 2), \
            "allocs never placed"
        assert _wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id))), \
            [a.client_status
             for a in server.store.allocs_by_job("default", job.id)]
    finally:
        client.shutdown()


@pytest.mark.slow
def test_server_and_client_subprocesses(tmp_path):
    import json
    import urllib.request

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env["PYTHONUNBUFFERED"] = "1"
    http_port, rpc_port = _free_port(), _free_port()

    srv = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-server",
         "-http-port", str(http_port), "-rpc-port", str(rpc_port),
         "-device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=REPO, text=True)
    cli = None
    try:
        def http(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}{path}", timeout=2) as r:
                return json.loads(r.read())

        def server_up():
            try:
                http("/v1/nodes")
                return True
            except Exception:
                return False

        assert _wait_for(server_up, timeout=60), "server never came up"

        cli = subprocess.Popen(
            [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-client",
             "-servers", f"127.0.0.1:{rpc_port}",
             "-node-name", "subproc-client"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO, text=True)

        assert _wait_for(
            lambda: any(n.get("name") == "subproc-client"
                        for n in http("/v1/nodes")), timeout=30), \
            "client node never registered"

        # submit a job through the HTTP API
        from nomad_tpu_torch.api.client import ApiClient
        from nomad_tpu_torch.utils.codec import to_wire
        job = mock.batch_job()
        job.task_groups[0].count = 1
        job.task_groups[0].tasks[0].config = {"run_for": "200ms"}
        api = ApiClient(f"http://127.0.0.1:{http_port}")
        api.register_job(to_wire(job))

        def alloc_complete():
            allocs = http(f"/v1/job/{job.id}/allocations")
            return allocs and all(
                a.get("client_status") == "complete" for a in allocs)

        assert _wait_for(alloc_complete, timeout=60), \
            http(f"/v1/job/{job.id}/allocations")
    finally:
        for p in (cli, srv):
            if p is not None:
                p.send_signal(signal.SIGTERM)
        for p in (cli, srv):
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
