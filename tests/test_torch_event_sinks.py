"""The reference's event-sink tests (tests/test_event_sinks.py) against
the port's EventSinkManager (server/event_sink.py), servers on the CPU,
their assertions unchanged.

The reference's docstring:

Durable event sinks: webhook delivery with at-least-once semantics
and raft-committed progress that survives leader failover.

Reference scenarios: nomad/stream/sink.go (progress tracking),
webhook_sink.go (NDJSON POST), event_sink_manager.go (leader-managed
workers; a new leader resumes delivery from committed progress).
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.event_sink import EventSink

import test_torch_select  # noqa: F401  (torch's thread cap)


class _Receiver:
    """Collecting webhook endpoint; can be told to fail requests."""

    def __init__(self):
        self.events = []
        self.fail_next = 0
        self.requests = 0
        self._l = threading.Lock()
        rx = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                with rx._l:
                    rx.requests += 1
                    if rx.fail_next > 0:
                        rx.fail_next -= 1
                        self.send_response(500)
                        self.end_headers()
                        return
                    for line in body.decode().splitlines():
                        if line.strip():
                            rx.events.append(json.loads(line))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/hook"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def indexes(self):
        with self._l:
            return [e["index"] for e in self.events]

    def close(self):
        self.httpd.shutdown()


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_webhook_sink_delivers_and_commits_progress():
    rx = _Receiver()
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0),
               device="cpu")
    s.start()
    try:
        s.upsert_event_sink(EventSink(id="snk1", address=rx.url,
                                      topics={"Node": ["*"]}))
        n1 = mock.node()
        s.register_node(n1)
        assert _wait(lambda: any(
            e["type"] == "NodeRegistration" and e["key"] == n1.id
            for e in rx.events)), rx.events
        # progress reaches raft-committed state
        assert _wait(lambda: s.store.event_sink("snk1").latest_index > 0,
                     timeout=10)
        committed = s.store.event_sink("snk1").latest_index
        assert committed >= max(rx.indexes())
        # topic filter: job events must NOT arrive
        s.register_job(mock.batch_job())
        time.sleep(1.0)
        assert all(e["topic"] == "Node" for e in rx.events)
    finally:
        s.shutdown()
        rx.close()


def test_webhook_sink_retries_until_delivered():
    rx = _Receiver()
    rx.fail_next = 2                  # first two posts bounce
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0),
               device="cpu")
    s.start()
    try:
        s.upsert_event_sink(EventSink(id="snk2", address=rx.url))
        node = mock.node()
        s.register_node(node)
        assert _wait(lambda: any(
            e.get("key") == node.id for e in rx.events), timeout=20), \
            (rx.requests, rx.events)
        assert rx.requests >= 3       # two failures + the success
    finally:
        s.shutdown()
        rx.close()


def test_sink_delete_stops_delivery():
    rx = _Receiver()
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0),
               device="cpu")
    s.start()
    try:
        s.upsert_event_sink(EventSink(id="snk3", address=rx.url))
        s.register_node(mock.node())
        assert _wait(lambda: rx.events)
        s.delete_event_sink("snk3")
        time.sleep(1.5)               # manager reconciles at 1s cadence
        seen = len(rx.events)
        s.register_node(mock.node())
        time.sleep(1.5)
        assert len(rx.events) == seen
    finally:
        s.shutdown()
        rx.close()


@pytest.mark.slow
def test_sink_survives_leader_failover():
    """Events delivered before failover commit their progress; the NEW
    leader's manager resumes the sink and post-failover events arrive
    (redelivery of the tail is allowed, loss is not)."""
    rx = _Receiver()
    servers, rpcs = [], []
    for _ in range(3):
        s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=30.0),
                   device="cpu")
        r = RpcServer(s, port=0)
        servers.append(s)
        rpcs.append(r)
    addrs = [r.addr for r in rpcs]
    for s, r in zip(servers, rpcs):
        s.attach_raft(r, addrs)
        r.start()
        s.start()
    try:
        assert _wait(lambda: sum(s.raft.is_leader() for s in servers) == 1,
                     timeout=15)
        leader = next(s for s in servers if s.raft.is_leader())
        leader.upsert_event_sink(EventSink(id="ha-sink", address=rx.url,
                                           topics={"Node": ["*"]}))
        pre = mock.node()
        leader.register_node(pre)
        assert _wait(lambda: any(e.get("key") == pre.id
                                 for e in rx.events), timeout=20)
        # wait for the progress commit to replicate
        assert _wait(lambda: all(
            s.store.event_sink("ha-sink") is not None
            and s.store.event_sink("ha-sink").latest_index > 0
            for s in servers), timeout=15)

        li = servers.index(leader)
        rpcs[li].shutdown()
        leader.shutdown()
        rest = [s for s in servers if s is not leader]
        assert _wait(lambda: sum(s.raft.is_leader() for s in rest) == 1,
                     timeout=15)
        new_leader = next(s for s in rest if s.raft.is_leader())

        post = mock.node()
        new_leader.register_node(post)
        assert _wait(lambda: any(e.get("key") == post.id
                                 for e in rx.events), timeout=30), \
            "post-failover events were not delivered"
    finally:
        for s, r in zip(servers, rpcs):
            try:
                r.shutdown()
                s.shutdown()
            except Exception:
                pass
        rx.close()


def test_replay_gap_emits_events_lost_marker():
    """Progress below the broker's proven trim horizon must surface an
    EventsLost frame — loss can happen, silent loss cannot."""
    rx = _Receiver()
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0),
               device="cpu")
    s.start()
    try:
        # sink claims progress at 10, but the broker provably dropped
        # events through 50
        s.events.trimmed_through = 50
        s.upsert_event_sink(EventSink(id="gap", address=rx.url,
                                      latest_index=10))
        s.register_node(mock.node())
        assert _wait(lambda: any(e["type"] == "EventsLost"
                                 for e in rx.events), timeout=15), \
            rx.events
        assert any(e["type"] == "NodeRegistration" for e in rx.events)
    finally:
        s.shutdown()
        rx.close()


def test_sink_api_rejects_unknown_type():
    from nomad_tpu_torch.api import ApiClient, ApiError, HTTPApiServer
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=60.0),
               device="cpu")
    s.start()
    api = HTTPApiServer(s, port=0)
    api.start()
    try:
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        with pytest.raises(ApiError) as e:
            c.upsert_event_sink("http://x/hook", type_="kafka")
        assert e.value.status == 400
        with pytest.raises(ApiError):
            c._request("PUT", "/v1/event/sink", {"Type": "webhook"})
    finally:
        api.shutdown()
        s.shutdown()
