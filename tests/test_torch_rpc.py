"""The reference's wire RPC suite (tests/test_rpc.py: msgpack frames over
TCP between a server and its clients; reference nomad/rpc.go,
node_endpoint.go:926 long-poll) against the port's rpc/ and Server on
the CPU, assertions unchanged: its four raw RpcServer / RpcClient tests.

Left out, with what they wait for: test_client_agent_runs_job_over_wire
(a `Client` agent) and test_server_and_client_subprocesses (`agent
-server` / `agent -client` and the HTTP API).

Besides: the Vault verbs refuse (the port has no Vault token authority),
a frame past MAX_FRAME is refused, and a stopped RpcServer closes the
connections it was serving."""

import socket
import struct
import threading
import time

import pytest

from nomad_tpu_torch import mock
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
    _server, rpc = rpc_cluster
    c = RpcClient(rpc.addr)
    try:
        with pytest.raises(RpcError, match="Vault token authority is not "
                                           "ported"):
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
