"""The reference's cluster workload observability suite
(tests/test_client_stats.py: the client host/alloc stats sampler, the
/v1/client/stats + /v1/client/allocation/<id>/stats surface, direct and
server-proxied, the cluster.* rollup folded from heartbeat payloads,
Prometheus exposition, CLI rendering) against the port's client/stats.py,
Server and api/ on the CPU, assertions unchanged.

Mapped: MAX_SERIES is client/stats.py's own (the port carries no
telemetry/); the port reads no environment variable, so the kill switch
NOMAD_TPU_CLIENT_STATS=0 is `stats_sample_interval_s=0`, its off arm.

Left out, with what they wait for: test_cluster_rollup_ring_and_prometheus
and test_operator_top_renders_cluster_block read the server's telemetry
ring (ROADMAP queue 1 item 6); their rollup and Prometheus checks run here
as test_cluster_rollup_and_prometheus. test_stats_sampler_overhead_within_5pct
is load-sensitive under the test runner's workers (ROADMAP queue 3) and
times the JAX package's harness.
"""

import contextlib
import io
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import HTTPApiServer
from nomad_tpu_torch.api.client import ApiClient
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.client.stats import (MAX_SERIES, HostStatsCollector,
                                          read_disk_mb,
                                    read_proc_cpu, read_proc_meminfo,
                                    read_uptime_s)
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


# -- /proc readers ------------------------------------------------------

def test_proc_readers_sane():
    cpu = read_proc_cpu()
    assert cpu is not None           # CI runs on Linux
    total, idle = cpu
    assert total >= idle >= 0
    mem = read_proc_meminfo()
    assert mem["total_mb"] > 0
    assert 0 <= mem["available_mb"] <= mem["total_mb"]
    used, total_mb = read_disk_mb("/")
    assert total_mb > 0 and 0 <= used <= total_mb
    assert read_uptime_s() > 0


def test_host_sampler_row_and_shapes():
    hs = HostStatsCollector(client=None, interval_s=1.0, slots=32)
    hs.sample_once()
    time.sleep(0.05)
    hs.sample_once()
    hist = hs.history()
    assert "host.cpu_pct" in hist["series"]
    assert "host.mem_used_mb" in hist["series"]
    assert "host.disk_total_mb" in hist["series"]
    pcts = [v for v in hist["series"]["host.cpu_pct"] if v is not None]
    assert pcts and all(0.0 <= p <= 100.0 for p in pcts)
    wire = hs.host_stats()
    assert wire["Memory"]["Total"] > 0
    assert wire["Memory"]["Used"] <= wire["Memory"]["Total"]
    assert wire["DiskStats"][0]["Size"] > 0
    assert wire["Uptime"] > 0
    summ = hs.summary()
    assert summ["mem_total_mb"] > 0
    assert summ["mem_used_mb"] == pytest.approx(
        wire["Memory"]["Used"] / (1024.0 * 1024.0), rel=0.2)


# -- ring bounding under alloc churn ------------------------------------

class _FakeHandle:
    def done(self):
        return False


class _FakeDriver:
    def __init__(self):
        self.ns = 0

    def stats(self, handle):
        self.ns += 10_000_000
        return {"memory_bytes": 64 * 1024 * 1024,
                "cpu_total_ns": float(self.ns)}


class _FakeTR:
    def __init__(self, name, driver):
        class _T:
            pass
        self.task = _T()
        self.task.name = name
        self.handle = _FakeHandle()
        self.driver = driver


class _FakeRunner:
    def __init__(self, driver):
        self.task_runners = [_FakeTR("web", driver)]


class _FakeClient:
    def __init__(self):
        self.runners = {}


def test_ring_bounded_under_alloc_churn_dead_series_nan_cleared():
    """Alloc churn must not grow the ring (MAX_SERIES cap, drops
    counted), and an alloc that leaves the node reads None across the
    whole retained window — NaN on absence, so a
    wrapped-over stale sample can never masquerade as a live alloc."""
    fc = _FakeClient()
    driver = _FakeDriver()
    hs = HostStatsCollector(client=fc, interval_s=1.0, slots=16)
    first_id = "deadbeef-0000-4000-8000-000000000000"
    fc.runners[first_id] = _FakeRunner(driver)
    hs.sample_once()
    key = f"alloc.{first_id[:8]}.web.rss_mb"
    assert hs.history()["series"][key][-1] is not None
    # churn: hundreds of distinct allocs come and go
    for i in range(200):
        fc.runners.clear()
        aid = f"{i:08x}-1111-4000-8000-000000000000"
        fc.runners[aid] = _FakeRunner(driver)
        hs.sample_once()
    st = hs.status()
    assert st["series_count"] <= MAX_SERIES
    assert st["series_dropped"] > 0
    # the dead first alloc's series is NaN-cleared everywhere retained
    vals = hs.history()["series"].get(key)
    if vals is not None:
        assert all(v is None for v in vals)
    # cpu-delta anchors don't leak with churn either
    assert len(hs._prev_task_ns) <= 1


# -- live cluster: direct + proxied surface -----------------------------

@pytest.fixture(scope="module")
def stats_cluster():
    server = Server(ServerConfig(num_schedulers=2,
                                 heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="stats-node",
                                         heartbeat_interval_s=0.2,
                                         stats_sample_interval_s=0.1))
    client.start()
    api = HTTPApiServer(server, port=0)
    api.start()
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.networks = []
    for t in tg.tasks:
        t.driver = "raw_exec"
        t.config = {"command": "sleep", "args": ["60"]}
        t.resources.networks = []
    server.register_job(job)
    assert _wait_for(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", job.id)))
    alloc = server.store.allocs_by_job("default", job.id)[0]
    # two sampler passes so cpu deltas and the heartbeat payload exist
    assert _wait_for(lambda: client.host_stats.status()["samples"] >= 2)
    assert _wait_for(
        lambda: bool(client.host_stats.alloc_stats(alloc.id)))
    yield server, client, api, alloc
    api.shutdown()
    client.shutdown()
    server.shutdown()


def test_alloc_resource_usage_direct_and_proxied(stats_cluster):
    """Acceptance: live task-level ResourceUsage for a running alloc —
    read directly off the client sampler/RPC service AND through the
    server's /v1 proxy by node lookup."""
    server, client, api, alloc = stats_cluster
    # direct: the sampler's latest snapshot
    direct = client.host_stats.alloc_stats(alloc.id)
    assert direct is not None
    web = direct["Tasks"]["web"]["ResourceUsage"]
    assert web["MemoryStats"]["RSS"] > 0
    assert web["CpuStats"]["Percent"] >= 0.0
    # direct: the client RPC service verb servers dial
    rpc = client.rpc_service.stats_alloc({"alloc_id": alloc.id})
    assert rpc["enabled"] is True
    assert rpc["stats"]["Tasks"]["web"]["ResourceUsage"][
        "MemoryStats"]["RSS"] > 0
    # proxied: server HTTP route -> owning client's listener
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    out = c.alloc_stats(alloc.id)
    assert out["enabled"] is True
    usage = out["stats"]
    assert usage["Tasks"]["web"]["ResourceUsage"]["MemoryStats"][
        "RSS"] > 0
    assert usage["ResourceUsage"]["MemoryStats"]["RSS"] > 0
    # a prefix resolves like the other alloc routes
    assert c.alloc_stats(alloc.id[:8])["stats"]["Tasks"]
    # an alloc that isn't on this node is a routing error, distinct
    # from "running but not reporting usage" (which answers stats:
    # None)
    with pytest.raises(KeyError):
        client.rpc_service.stats_alloc({"alloc_id": "ffffffff"})


def test_host_stats_route_and_history(stats_cluster):
    server, client, api, alloc = stats_cluster
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    # single-node cluster: node_id optional
    hs = c.client_host_stats()
    assert hs["enabled"] is True
    assert hs["Memory"]["Total"] > 0
    assert hs["AllocsRunning"] >= 1
    assert hs["ring"]["samples"] >= 2
    # explicit node id + the client-side retained ring rides along
    hs2 = c.client_host_stats(client.node.id, history=True, last=4)
    assert "history" in hs2
    assert "host.cpu_pct" in hs2["history"]["series"]
    assert len(hs2["history"]["t"]) <= 4


def test_cluster_rollup_and_prometheus(stats_cluster):
    """Heartbeats carried the summary; cluster_stats folds fleet
    used-vs-allocated, and the family lands in the Prometheus
    exposition (cluster.* and host-stats families)."""
    import urllib.request
    server, client, api, alloc = stats_cluster
    assert _wait_for(
        lambda: server.cluster_stats()["nodes_reporting"] == 1)
    cs = server.cluster_stats()
    assert cs["nodes_total"] == 1 and cs["nodes_ready"] == 1
    assert cs["stale_heartbeats"] == 0
    assert cs["fleet_mem_used_ratio"] > 0          # host truth
    assert cs["fleet_cpu_allocated_ratio"] > 0     # bin-packing truth
    assert 0.0 <= cs["fleet_cpu_used_ratio"] <= 1.0
    assert cs["node_mem_ratio_p50"] > 0
    url = f"http://127.0.0.1:{api.port}/v1/metrics?format=prometheus"
    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    assert "nomad_cluster_fleet_mem_used_ratio" in text
    assert "nomad_cluster_nodes_ready 1" in text
    assert "nomad_client_host_cpu_pct" in text
    assert "nomad_client_host_mem_used_mb" in text


def test_stale_heartbeat_counting(stats_cluster):
    """A payload older than stats_stale_after_s counts stale and drops
    out of the used sums (capacity still counts)."""
    server, client, api, alloc = stats_cluster
    with server._node_stats_l:
        rec = server._node_stats[client.node.id]
        saved = rec["received_at"]
        rec["received_at"] = time.time() - 10_000.0
    try:
        cs = server.cluster_stats()
        assert cs["stale_heartbeats"] == 1
        assert cs["nodes_reporting"] == 0
        assert cs["fleet_mem_used_mb"] == 0.0
        assert cs["fleet_mem_capacity_mb"] > 0
    finally:
        with server._node_stats_l:
            server._node_stats[client.node.id]["received_at"] = saved


def test_cli_node_and_alloc_stats_rendering(stats_cluster):
    from nomad_tpu_torch.cli.main import main as cli_main
    server, client, api, alloc = stats_cluster
    addr = f"http://127.0.0.1:{api.port}"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-address", addr, "node", "status", "-stats",
                       client.node.id])
    assert rc == 0
    text = out.getvalue()
    assert "Host Resource Utilization" in text
    assert "Memory" in text and "Disk" in text and "Uptime" in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-address", addr, "alloc", "status", "-stats",
                       alloc.id])
    assert rc == 0
    text = out.getvalue()
    assert "Resource Utilization" in text
    assert "web" in text and "MiB" in text


# -- kill switch --------------------------------------------------------

def test_client_stats_kill_switch():
    """NOMAD_TPU_CLIENT_STATS=0 degenerates to the client without stats: no
    sampler object, heartbeats carry no stats payload, the stats
    routes report the node dark (enabled: False), and interval=0 is
    the config-level equivalent."""
    server = Server(ServerConfig(num_schedulers=0,
                                 heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="dark",
                                         heartbeat_interval_s=0.1,
                                         stats_sample_interval_s=0.0))
    client.start()
    api = HTTPApiServer(server, port=0)
    api.start()
    try:
        assert client.host_stats is None
        time.sleep(0.4)                 # a few heartbeats land
        assert server._node_stats == {}
        cs = server.cluster_stats()
        assert cs["nodes_reporting"] == 0
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        hs = c.client_host_stats()
        assert hs["enabled"] is False
    finally:
        api.shutdown()
        client.shutdown()
        server.shutdown()
    # config-level: interval 0 builds no sampler either
    server2 = Server(ServerConfig(num_schedulers=0))
    client2 = Client(server2, ClientConfig(
        node_name="dark2", stats_sample_interval_s=0.0))
    try:
        assert client2.host_stats is None
    finally:
        client2.shutdown()
        server2.shutdown()

