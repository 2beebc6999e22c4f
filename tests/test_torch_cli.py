"""The port's agent and command line (cli/main.py, api/), on the CPU.

- `python -m nomad_tpu_torch agent -dev -clients 0 -device cpu` starts
  in a subprocess with `jax` and `nomad_tpu` blocked, serves
  `/v1/status/leader`, places a job that `python -m nomad_tpu_torch job
  run` submits, and exits 0 on SIGTERM;
- local clients start (`agent -dev` with its default one, `-clients 2`,
  and `-client -servers` joined over RPC); without `-device cpu` the agent
  raises where no card is present; a start that fails (a port taken)
  stops what it started;
- the agent's flight recorder, governor and telemetry collector are live:
  `/v1/operator/trace` (JSON and `?format=chrome`, `operator trace`),
  `/v1/operator/governor`, `/v1/operator/telemetry` and
  `/v1/operator/flatness` answer from them (test_trace_route_answers_404
  and test_governor_telemetry_flatness_are_off keep their names from when
  the port had none); `dev lint` exits 1 (analysis/ is not carried);
  `dev chaos -list` lists the nine cells and `dev chaos -cell
  batch_backfill -device cpu -output f` runs one and writes its artifact;
- the environment rule of tests/test_torch_boundary.py accepts cli/
  main.py's three inputs and refuses any other read, and those inputs
  anywhere else;
- blocking queries wake on a write; the HTTP server, the event-sink
  writers and the replication threads are joined at shutdown;
- a multiregion job fans out to a second region's agent and stops
  everywhere with `-global` (federation in server/core.py).
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.api import ApiClient, ApiError, HTTPApiServer
from nomad_tpu_torch.cli.main import build_parser, main as cli, start_agent
from nomad_tpu_torch.server import Server, ServerConfig

import test_torch_select  # noqa: F401  (torch's thread cap)
from test_torch_boundary import ENV_INPUTS_FILE, environment_reads

REPO = Path(__file__).resolve().parent.parent

JOB_HCL = """
job "cli-job" {
  datacenters = ["dc1"]
  group "g" {
    count = 3
    task "t" {
      driver = "exec"
      config { command = "/bin/date" }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""

AGENT_WITHOUT_JAX = r"""
import runpy
import sys
sys.modules["jax"] = None
sys.modules["nomad_tpu"] = None
sys.argv = ["nomad_tpu_torch", "agent", "-dev", "-clients", "0",
            "-device", "cpu", "-http-port", "0", "-rpc-port", "0",
            "-heartbeat-ttl", "600"]
try:
    runpy.run_module("nomad_tpu_torch", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "jax" or m.startswith("jax.") or m == "nomad_tpu"
       or m.startswith("nomad_tpu."))]
print("imported", bad, flush=True)
sys.exit(rc if not bad else 3)
"""


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _run(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_agent_subprocess_without_jax_places_a_job(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", AGENT_WITHOUT_JAX],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("    Device:"):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            lines.append(line)
        fields = {ln.split(":", 1)[0].strip(): ln.split(":", 1)[1].strip()
                  for ln in lines if ln.startswith("    ")}
        assert fields["Device"].startswith("cpu")
        addr = fields["HTTP API"]
        c = ApiClient(addr)
        assert c._request("GET", "/v1/status/leader") == fields["RPC"]
        from nomad_tpu_torch.rpc.client import RpcClient
        from nomad_tpu_torch.utils.codec import to_wire
        rpc = RpcClient(fields["RPC"])
        try:
            for _ in range(4):
                rpc.call("Node.Register", {"node": to_wire(mock.node())})
        finally:
            rpc.close()
        jobfile = tmp_path / "cli-job.hcl"
        jobfile.write_text(JOB_HCL)
        run = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
             "job", "run", str(jobfile)], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stdout + run.stderr
        assert 'finished with status "complete"' in run.stdout
        assert len(c.job_allocations("cli-job")) == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
        assert "imported []" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("argv", [
    ["agent", "-dev", "-device", "cpu"],
    ["agent", "-dev", "-clients", "2", "-device", "cpu"],
    ["agent", "-client", "-servers", "127.0.0.1:4647", "-device", "cpu"],
])
def test_local_clients_exit_1_naming_the_client_item(argv):
    """Local clients start: `-dev` with its default one client, `-clients
    2`, and `-client -servers` (here the RPC address of a server agent
    of the test's own) over RemoteTransport; each client's node
    registers and turns ready."""
    server_agent = None
    if "-servers" in argv:
        server_agent = start_agent(build_parser().parse_args(
            ["agent", "-server", "-http-port", "0", "-rpc-port", "0",
             "-device", "cpu"]))
        argv = [server_agent.rpc.addr if a == "127.0.0.1:4647" else a
                for a in argv]
    agent = start_agent(build_parser().parse_args(
        argv + ["-http-port", "0", "-rpc-port", "0"]))
    try:
        want = 2 if "2" in argv else 1
        assert len(agent.clients) == want
        srv = (server_agent or agent).server
        assert _wait(lambda: sum(
            n.status == "ready" for n in srv.store.nodes()) == want)
        if server_agent is not None:
            assert agent.server is None and agent.api is None
    finally:
        agent.shutdown()
        if server_agent is not None:
            server_agent.shutdown()


def test_agent_without_device_needs_a_card():
    args = build_parser().parse_args(
        ["agent", "-dev", "-clients", "0", "-http-port", "0",
         "-rpc-port", "0"])
    if torch.cuda.is_available():
        agent = start_agent(args)
        try:
            assert agent.server.device.type == "cuda"
        finally:
            agent.shutdown()
    else:
        with pytest.raises(RuntimeError):
            start_agent(args)


@pytest.fixture
def agent():
    a = start_agent(build_parser().parse_args(
        ["agent", "-dev", "-clients", "0", "-num-schedulers", "1",
         "-http-port", "0", "-rpc-port", "0", "-device", "cpu"]))
    try:
        yield a, f"http://127.0.0.1:{a.api.port}"
    finally:
        a.shutdown()


def test_trace_route_answers_404(agent):
    """The route the port once answered with a 404 now serves the
    flight recorder, in both forms, and `operator trace` renders it."""
    _a, addr = agent
    c = ApiClient(addr)
    out = c.trace()
    assert out["enabled"] is True and "ring" in out and "recent" in out
    chrome = c.trace({"format": "chrome"})
    assert chrome["displayTimeUnit"] == "ms"
    rc, out, _err = _run("-address", addr, "operator", "trace")
    assert rc == 0 and "Traces" in out


@pytest.mark.parametrize("tool", ["lint"])
def test_dev_tooling_exits_1(tool):
    """`dev lint` waits for analysis/ (ROADMAP queue 1 item 3)."""
    rc, _out, err = _run("dev", tool)
    assert rc == 1 and "item 3" in err


def test_dev_chaos_lists_the_nine_cells():
    rc, out, _err = _run("dev", "chaos", "-list")
    assert rc == 0
    rows = [line.split()[0:2] for line in out.splitlines() if line]
    assert [r[0] for r in rows] == [
        "system_fanout", "spread_antiaffinity", "batch_backfill",
        "drain_storm", "client_failure_burst", "blocked_herd",
        "swim_partition", "follower_fence", "leader_failover_commit"]
    assert [r[1] for r in rows] == ["[quick", ] * 6 + ["[cluster]"] * 3


def test_dev_chaos_runs_a_cell_on_the_cpu(tmp_path):
    """`dev chaos -cell batch_backfill -device cpu -output f` runs the
    cell against a port Server on the CPU, exits 0 and writes the
    artifact."""
    path = tmp_path / "chaos.json"
    rc, out, _err = _run("dev", "chaos", "-cell", "batch_backfill",
                         "-device", "cpu", "-output", str(path))
    assert rc == 0, out
    assert "1/1 cells passed" in out and f"artifact: {path}" in out
    result = json.loads(path.read_text())
    assert result["schema"] == "nomad-tpu/chaos/1"
    assert result["race"] == "off"
    assert [c["name"] for c in result["cells"]] == ["batch_backfill"]
    assert result["cells"][0]["pass"] and result["cells"][0][
        "workers_killed"] == 1


def test_governor_telemetry_flatness_are_off(agent):
    """The routes that once answered `{"enabled": false}` serve the
    agent's live governor and telemetry ring."""
    a, addr = agent
    c = ApiClient(addr)
    gov = c.governor()
    assert gov["enabled"] is True and gov["gauges"]
    a.server.telemetry.sample_once()
    tel = c.telemetry()
    assert tel["enabled"] is True and tel["samples"] >= 1
    assert "device.hbm_bytes_in_use" in tel["series"]
    flat = c.flatness()
    assert flat["enabled"] is True and "windows_measured" in flat


def test_client_forwarding_without_a_client(agent):
    a, addr = agent
    node = mock.node()
    a.server.register_node(node)
    job = mock.job()
    job.task_groups[0].count = 1
    a.server.register_job(job)
    assert _wait(lambda: a.server.store.allocs_by_job(job.namespace,
                                                      job.id))
    alloc = a.server.store.allocs_by_job(job.namespace, job.id)[0]
    c = ApiClient(addr)
    for path in (f"/v1/client/fs/ls/{alloc.id}",
                 f"/v1/client/fs/logs/{alloc.id}?task=web",
                 f"/v1/client/allocation/{alloc.id}/stats"):
        with pytest.raises(ApiError) as ei:
            c._request("GET", path)
        assert "no reachable client RPC address" in str(ei.value), path


# -- the environment rule ----------------------------------------------
def test_env_rule_accepts_the_cli_inputs():
    src = (REPO / ENV_INPUTS_FILE).read_text()
    assert environment_reads(src, ENV_INPUTS_FILE) == []
    for name in ("NOMAD_TOKEN", "NOMAD_REGION", "NOMAD_VAR_"):
        assert name in src


@pytest.mark.parametrize("code,where", [
    # the inputs themselves, in any other file
    ('import os\nt = os.environ.get("NOMAD_TOKEN", "")\n',
     "nomad_tpu_torch/server/core.py"),
    ('import os\nfor k, v in os.environ.items():\n'
     '    if k.startswith("NOMAD_VAR_"):\n        print(k)\n',
     "nomad_tpu_torch/api/http.py"),
    # any other read in cli/main.py
    ('import os\nh = os.environ.get("HOME", "")\n', ENV_INPUTS_FILE),
    ('import os\nt = os.environ["NOMAD_TOKEN"]\n', ENV_INPUTS_FILE),
    ('import os\nt = os.getenv("NOMAD_TOKEN")\n', ENV_INPUTS_FILE),
    ('from os import environ\n', ENV_INPUTS_FILE),
    ('import os\nfor k, v in os.environ.items():\n    print(k)\n',
     ENV_INPUTS_FILE),
    ('import os\nfor k, v in os.environ.items():\n'
     '    if k.startswith("NOMAD_"):\n        print(k)\n', ENV_INPUTS_FILE),
    ('import os\nos.environ["NOMAD_TOKEN"] = "x"\n', ENV_INPUTS_FILE),
])
def test_env_rule_refuses_other_reads(code, where):
    assert environment_reads(code, where)


# -- blocking queries and teardown ---------------------------------------
def test_blocking_query_wakes_on_a_write(agent):
    a, addr = agent
    c = ApiClient(addr)
    index = a.server.store.latest_index()
    got = {}

    def block():
        t0 = time.perf_counter()
        c._request("GET", "/v1/nodes", params={"index": index,
                                               "wait": "30s"})
        got["s"] = time.perf_counter() - t0
    t = threading.Thread(target=block)
    t.start()
    time.sleep(0.3)
    assert "s" not in got              # still parked on the index
    a.server.register_node(mock.node())
    t.join(10)
    assert not t.is_alive() and 0.2 < got["s"] < 10


def test_shutdown_joins_the_front_door_threads():
    """The HTTP server's thread and socket, the sink manager's watcher
    and writers, and a replication thread parked in a long-poll are all
    gone once shutdown returns."""
    from nomad_tpu_torch.server.event_sink import EventSink

    def front_door_threads():
        return {t for t in threading.enumerate()
                if t.name.startswith(("event-sink", "replicate-"))}
    before = front_door_threads()
    east = Server(ServerConfig(num_schedulers=0, region="east"),
                  device="cpu")
    east.start()
    east_api = HTTPApiServer(east, port=0)
    east_api.start()
    west = Server(ServerConfig(
        num_schedulers=0, region="west", authoritative_region="east",
        region_peers={"east": f"127.0.0.1:{east_api.port}"}),
        device="cpu")
    west.start()
    try:
        west.upsert_event_sink(EventSink(id="s1",
                                         address="http://127.0.0.1:9/x"))
        assert _wait(lambda: any(t.name.startswith("event-sink-s1")
                                 for t in threading.enumerate()))
        assert _wait(lambda: west.store.namespace_by_name("default")
                     is not None)
        time.sleep(0.5)          # the replication threads long-poll now
        rep = west._replication
        threads = list(rep._threads)
        assert threads and all(t.is_alive() for t in threads)
        t0 = time.perf_counter()
        west.shutdown()
        assert time.perf_counter() - t0 < 10
        assert not any(t.is_alive() for t in threads)
    finally:
        east_api.shutdown()
        east.shutdown()
    left = [t.name for t in front_door_threads() - before]
    assert not left, left
    assert not east_api._thread.is_alive()
    assert east_api.httpd.socket.fileno() == -1


def test_multiregion_job_fans_out_and_stops_globally():
    """The reference's test_multiregion_job_fans_out without its
    Client: nodes registered on each region's server directly."""
    from nomad_tpu_torch.models.job import (Multiregion, MultiregionRegion,
                                            MultiregionStrategy)
    cfg = dict(num_schedulers=1, heartbeat_ttl_s=60.0)
    west = Server(ServerConfig(region="west", **cfg), device="cpu")
    west.start()
    west_api = HTTPApiServer(west, port=0)
    west_api.start()
    east = Server(ServerConfig(
        region="east", region_peers={"west": f"127.0.0.1:{west_api.port}"},
        **cfg), device="cpu")
    east.start()
    east_api = HTTPApiServer(east, port=0)
    east_api.start()
    try:
        for s in (east, west):
            s.register_node(mock.node())
        job = mock.job()
        job.id = job.name = "mr-job"
        job.task_groups[0].count = 0
        job.region = "global"
        job.datacenters = []
        job.multiregion = Multiregion(
            strategy=MultiregionStrategy(max_parallel=1),
            regions=[MultiregionRegion(name="east", count=1,
                                       datacenters=["dc1"],
                                       meta={"reg": "e"}),
                     MultiregionRegion(name="west", count=2,
                                       datacenters=["dc1"],
                                       meta={"reg": "w"})])
        east.register_job(job)
        je = east.store.job_by_id("default", "mr-job")
        jw = west.store.job_by_id("default", "mr-job")
        assert je.region == "east" and jw.region == "west"
        assert je.meta["reg"] == "e" and jw.meta["reg"] == "w"
        assert _wait(lambda: len(east.store.allocs_by_job(
            "default", "mr-job")) == 1)
        assert _wait(lambda: len(west.store.allocs_by_job(
            "default", "mr-job")) == 2)
        ApiClient(f"http://127.0.0.1:{east_api.port}")._request(
            "DELETE", "/v1/job/mr-job",
            params={"global": "true", "purge": "true"})
        assert _wait(lambda: east.store.job_by_id("default", "mr-job")
                     is None)
        assert _wait(lambda: west.store.job_by_id("default", "mr-job")
                     is None)
        # a region with no federation peer refuses the fan-out
        job2 = mock.job()
        job2.id = job2.name = "mr-lost"
        job2.multiregion = Multiregion(regions=[
            MultiregionRegion(name="east"), MultiregionRegion(name="mars")])
        with pytest.raises(ValueError, match="no federation peer"):
            east.register_job(job2)
    finally:
        for x in (east_api, west_api):
            x.shutdown()
        for x in (east, west):
            x.shutdown()


def test_module_entry_points_run_main():
    for mod in ("nomad_tpu_torch", "nomad_tpu_torch.cli"):
        res = subprocess.run([sys.executable, "-m", mod, "version"],
                             cwd=REPO, env=dict(os.environ,
                                                PYTHONPATH=str(REPO)),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert "nomad-tpu v" in res.stdout


def test_job_init_writes_the_port_example(tmp_path):
    path = tmp_path / "example.nomad"
    rc, out, _err = _run("job", "init", str(path))
    assert rc == 0 and "written" in out
    assert "python -m nomad_tpu_torch job run" in path.read_text()
    from nomad_tpu_torch.jobspec import parse_job_file
    assert parse_job_file(str(path)).id == "example"


def test_agent_start_failure_stops_what_started(monkeypatch):
    """An HTTP port already taken: start_agent raises, and the server
    and the RPC listener it had started are shut down."""
    import socket
    from nomad_tpu_torch.rpc import RpcServer
    stopped = []
    for cls in (Server, RpcServer):
        def shutdown(self, _orig=cls.shutdown):
            _orig(self)
            stopped.append(self)
        monkeypatch.setattr(cls, "shutdown", shutdown)
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    try:
        with pytest.raises(OSError):
            start_agent(build_parser().parse_args(
                ["agent", "-dev", "-clients", "0", "-device", "cpu",
                 "-http-port", str(taken.getsockname()[1]),
                 "-rpc-port", "0"]))
    finally:
        taken.close()
    assert sorted(type(x).__name__ for x in stopped) == \
        ["RpcServer", "Server"]
    server = next(x for x in stopped if isinstance(x, Server))
    assert server.workers and not any(
        w._thread.is_alive() for w in server.workers)
