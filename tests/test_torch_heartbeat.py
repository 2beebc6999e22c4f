"""The port's node heartbeat TTLs (server/heartbeat.py): every node's
deadline on one thread, where the JAX package arms one threading.Timer
thread per node; and the server's heartbeat path over it (a node that
stops heartbeating is marked down, one that heartbeats stays ready)."""

import threading
import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.heartbeat import COMPACT_RATIO, HeartbeatTimers

import test_torch_select  # noqa: F401  (torch's thread cap)


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_deadlines_fire_once_and_resets_push_them_back():
    """A node that stops heartbeating fires once, its TTL after its last
    reset; one that keeps heartbeating fires only after it stops."""
    ttl = 0.5
    fired = []
    hb = HeartbeatTimers(ttl, lambda n: fired.append((n, time.monotonic())))
    try:
        t_a = time.monotonic()
        hb.reset("a")
        t_end = t_a + 2 * ttl
        while time.monotonic() < t_end:
            last_b = time.monotonic()
            hb.reset("b")       # b heartbeats, a does not
            time.sleep(0.02)
        assert _wait(lambda: len(fired) >= 2)
        time.sleep(ttl)
        assert [n for n, _t in fired] == ["a", "b"]
        assert fired[0][1] >= t_a + ttl * 0.99
        assert fired[1][1] >= last_b + ttl * 0.99
        assert not hb._deadline
    finally:
        hb.stop()


def _timer_threads():
    return [t for t in threading.enumerate()
            if t.name == "heartbeat-timers" and t.is_alive()]


def test_ten_thousand_nodes_take_one_thread_and_stop_joins_it():
    before = _timer_threads()
    fired = []
    hb = HeartbeatTimers(3600.0, fired.append)
    try:
        for i in range(10_000):
            hb.reset(f"node-{i}")
        assert _timer_threads() == before + [hb._thread]
        assert len(hb._deadline) == 10_000
        for _ in range(3):
            for i in range(10_000):
                hb.reset(f"node-{i}")
        # stale entries are compacted away
        assert len(hb._heap) <= COMPACT_RATIO * 10_000 + 64
    finally:
        hb.stop()
    assert not hb._thread.is_alive()
    assert _timer_threads() == before
    hb.reset("late")            # after stop: nothing arms
    assert not hb._deadline and not fired


def test_expiry_errors_do_not_stop_the_thread():
    seen = []

    def expire(node_id):
        seen.append(node_id)
        if node_id == "bad":
            raise RuntimeError("boom")

    hb = HeartbeatTimers(0.05, expire)
    try:
        hb.reset("bad")
        assert _wait(lambda: seen == ["bad"])
        hb.reset("good")
        assert _wait(lambda: seen == ["bad", "good"])
    finally:
        hb.stop()


def test_server_marks_a_silent_node_down_and_keeps_a_live_one():
    s = Server(ServerConfig(num_schedulers=0, heartbeat_ttl_s=0.5),
               device="cpu")
    s.start()
    try:
        silent, live = mock.node(), mock.node()
        s.register_node(silent)
        s.register_node(live)
        t0 = time.time()
        while time.time() - t0 < 1.2:
            s.heartbeat(live.id)
            time.sleep(0.05)
        assert _wait(lambda: s.store.node_by_id(silent.id).status
                     == "down")
        assert s.store.node_by_id(live.id).status == "ready"
    finally:
        s.shutdown()
    assert not s._heartbeats._thread.is_alive()


def test_concurrent_resets_lose_no_deadline():
    """Stress: more resetting threads than cores under a short switch
    interval, each re-arming its nodes far inside their TTL; once they
    stop, every node fires exactly once, not before its TTL from its last
    reset (a lost update would drop the last deadline, fire an older one
    early or fire twice)."""
    import os
    import sys
    ttl = 2.0
    n_threads = min((os.cpu_count() or 2) + 1, 12)
    fired = []
    fired_l = threading.Lock()
    last = {}

    def expire(node_id):
        with fired_l:
            fired.append((node_id, time.monotonic()))

    hb = HeartbeatTimers(ttl, expire)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def hammer(k):
            t_end = time.monotonic() + 0.3
            while time.monotonic() < t_end:
                for i in range(50):
                    node = f"n-{k}-{i}"
                    t = time.monotonic()
                    hb.reset(node)
                    last[node] = t

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    try:
        assert len(last) == n_threads * 50
        assert _wait(lambda: len(fired) >= len(last), timeout=10)
        time.sleep(0.5)
        with fired_l:
            got = list(fired)
        assert sorted(n for n, _t in got) == sorted(last)
        assert all(t >= last[n] + ttl * 0.99 for n, t in got)
    finally:
        hb.stop()
