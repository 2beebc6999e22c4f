"""The reference's api_cli suite (tests/test_api_cli.py) against the port's
api/ and cli/ beside a Client, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

HTTP API + CLI tests (reference patterns: command/agent/*_endpoint_test.go)."""

import json
import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import ApiClient, ApiError, HTTPApiServer
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.jobspec import job_to_spec
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def cluster():
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    server.start()
    client = Client(server, ClientConfig(node_name="api-test"))
    client.start()
    api = HTTPApiServer(server, port=0)   # ephemeral port
    api.start()
    c = ApiClient(f"http://127.0.0.1:{api.port}")
    yield server, client, c
    api.shutdown()
    client.shutdown()
    server.shutdown()


def test_node_endpoints(cluster):
    server, client, c = cluster
    nodes = c.list_nodes()
    assert len(nodes) == 1
    assert nodes[0]["name"] == "api-test"
    full = c.get_node(nodes[0]["id"][:8])   # prefix lookup
    assert full["node_resources"]["cpu"]["cpu_shares"] == 4000


def test_job_lifecycle_via_api(cluster):
    server, client, c = cluster
    job = mock.batch_job()
    job.type = "service"
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {"run_for": "60s"}
    job.canonicalize()
    resp = c.register_job(job_to_spec(job))
    assert "EvalID" in resp

    assert _wait_for(lambda: len(c.job_allocations(job.id)) == 2)
    assert _wait_for(lambda: all(
        a["client_status"] == "running" for a in c.job_allocations(job.id)))

    jobs = c.list_jobs()
    assert any(j["ID"] == job.id for j in jobs)
    got = c.get_job(job.id)
    assert got["type"] == "service"
    summ = c.job_summary(job.id)
    assert summ["summary"]["worker"]["running"] == 2

    evs = c.job_evaluations(job.id)
    assert evs and evs[0]["status"] == "complete"
    ev = c.get_evaluation(evs[0]["id"][:8])
    assert ev["job_id"] == job.id

    alloc_stub = c.job_allocations(job.id)[0]
    alloc = c.get_allocation(alloc_stub["id"][:8])
    assert alloc["metrics"]["nodes_evaluated"] >= 1

    c.deregister_job(job.id)
    assert _wait_for(lambda: all(
        a["desired_status"] == "stop" for a in c.job_allocations(job.id)))


def test_register_invalid_job_400(cluster):
    server, client, c = cluster
    job = mock.batch_job()
    job.datacenters = []
    with pytest.raises(ApiError) as e:
        c.register_job(job_to_spec(job))
    assert e.value.status == 400
    assert "datacenters" in str(e.value)


def test_unknown_routes_404(cluster):
    server, client, c = cluster
    with pytest.raises(ApiError) as e:
        c.get_job("nonexistent-job")
    assert e.value.status == 404
    with pytest.raises(ApiError):
        c._request("GET", "/v1/bogus")


def test_eligibility_endpoint(cluster):
    server, client, c = cluster
    node_id = c.list_nodes()[0]["id"]
    c.set_node_eligibility(node_id, False)
    assert c.get_node(node_id)["scheduling_eligibility"] == "ineligible"
    c.set_node_eligibility(node_id, True)
    assert c.get_node(node_id)["scheduling_eligibility"] == "eligible"


def test_scheduler_config_endpoint(cluster):
    server, client, c = cluster
    cfg = c.scheduler_config()
    assert cfg["SchedulerConfig"]["scheduler_algorithm"] == "binpack"


def test_blocking_query_wakes_on_write(cluster):
    server, client, c = cluster
    import threading
    idx = server.store.latest_index()
    results = {}

    def blocked():
        t0 = time.time()
        results["jobs"] = c._request("GET", "/v1/jobs",
                                     params={"index": idx, "wait": "5s"})
        results["elapsed"] = time.time() - t0

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    job = mock.batch_job()
    job.task_groups[0].tasks[0].config = {"run_for": "1s"}
    c.register_job(job_to_spec(job))
    t.join(timeout=6)
    assert "jobs" in results
    assert results["elapsed"] < 4.0   # woke before the 5s wait expired


def test_cli_flow(cluster, tmp_path, capsys):
    server, client, c = cluster
    from nomad_tpu_torch.cli.main import main
    addr = c.address

    # job init writes the example
    jobfile = tmp_path / "example.nomad"
    assert main(["job", "init", str(jobfile)]) == 0
    assert jobfile.exists()

    # job run (example uses mock_driver, runs long)
    rc = main(["-address", addr, "job", "run", str(jobfile)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Evaluation" in out and "complete" in out

    # job status renders the table
    assert main(["-address", addr, "job", "status", "example"]) == 0
    out = capsys.readouterr().out
    assert "running" in out
    assert "cache" in out

    # node status
    assert main(["-address", addr, "node", "status"]) == 0
    out = capsys.readouterr().out
    assert "api-test" in out

    # alloc status of the placed alloc
    alloc_id = c.job_allocations("example")[0]["id"]
    assert main(["-address", addr, "alloc", "status", alloc_id[:8]]) == 0
    out = capsys.readouterr().out
    assert "Placement Metrics" in out

    # stop it
    assert main(["-address", addr, "job", "stop", "-detach", "example"]) == 0


def test_cli_tranche_round4(cluster, tmp_path, capsys):
    """The round-4 command tranche against a live agent: job
    inspect/eval/dispatch wiring, alloc stop, eval list, scaling
    policy list, event sink CRUD, server members, metrics
    (command/{job_*,alloc_stop,eval_status,scaling,event,server_members,
    metrics}.go surfaces)."""
    import io
    import sys as _sys
    from nomad_tpu_torch.cli.main import main as cli_main
    from nomad_tpu_torch.models.job import Scaling

    server, client, c = cluster
    addr = c.address

    def run_cli(*argv):
        old = _sys.argv
        _sys.argv = ["nomad", "-address", addr, *argv]
        try:
            rc = cli_main()
        except SystemExit as e:
            rc = int(e.code or 0)
        finally:
            _sys.argv = old
        out = capsys.readouterr().out
        return rc, out

    job = mock.batch_job()
    job.id = "cli-tranche"
    tg = job.task_groups[0]
    tg.count = 1
    tg.scaling = Scaling(enabled=True, min=1, max=5)
    tg.tasks[0].config = {"run_for": "30s"}
    tg.tasks[0].resources.networks = []
    tg.networks = []
    server.register_job(job)
    assert _wait_for(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "cli-tranche")))

    rc, out = run_cli("job", "inspect", "cli-tranche")
    assert rc == 0 and '"cli-tranche"' in out

    rc, out = run_cli("job", "eval", "cli-tranche")
    assert rc == 0 and "Created eval" in out

    rc, out = run_cli("eval", "list")
    assert rc == 0 and "cli-tranche" in out

    rc, out = run_cli("scaling", "policy-list")
    assert rc == 0 and "cli-tranche" in out

    rc, out = run_cli("server", "members")
    assert rc == 0

    rc, out = run_cli("metrics")
    assert rc == 0 and "Counters" in out

    rc, out = run_cli("event", "sink-register", "http://127.0.0.1:1/x",
                      "-id", "cli-sink")
    assert rc == 0
    rc, out = run_cli("event", "sink-list")
    assert rc == 0 and "cli-sink" in out
    rc, out = run_cli("event", "sink-deregister", "cli-sink")
    assert rc == 0

    alloc = server.store.allocs_by_job("default", "cli-tranche")[0]
    rc, out = run_cli("alloc", "stop", alloc.id)
    assert rc == 0 and "Created eval" in out
    assert _wait_for(lambda: any(
        a.id != alloc.id
        for a in server.store.allocs_by_job("default", "cli-tranche")))


def test_alloc_restart_signal_task_variants(cluster, capsys):
    """Reference command surface (alloc_restart.go / alloc_signal.go):
    the task can be named by `-task <name>` flag or trailing positional
    — both route, and naming it both ways with different values is an
    error, not a silent pick."""
    from nomad_tpu_torch.cli.main import main

    server, client, c = cluster
    addr = c.address
    job = mock.batch_job()
    job.id = "cli-variants"
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].config = {"run_for": "60s"}
    tg.tasks[0].resources.networks = []
    tg.networks = []
    server.register_job(job)
    assert _wait_for(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "cli-variants")))
    alloc_id = server.store.allocs_by_job("default", "cli-variants")[0].id

    # -task flag variant
    rc = main(["-address", addr, "alloc", "restart",
               "-task", "worker", alloc_id])
    out = capsys.readouterr().out
    assert rc == 0 and "Restarted 1 task(s)" in out

    # positional variant still works
    assert _wait_for(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "cli-variants")))
    rc = main(["-address", addr, "alloc", "restart", alloc_id, "worker"])
    out = capsys.readouterr().out
    assert rc == 0 and "Restarted 1 task(s)" in out

    # flag and positional disagreeing is an error
    rc = main(["-address", addr, "alloc", "restart",
               "-task", "worker", alloc_id, "other"])
    err = capsys.readouterr().err
    assert rc == 1 and "both" in err

    # signal: -s and -task flags together
    assert _wait_for(lambda: any(
        a.client_status == "running"
        for a in server.store.allocs_by_job("default", "cli-variants")))
    rc = main(["-address", addr, "alloc", "signal", "-s", "SIGHUP",
               "-task", "worker", alloc_id])
    out = capsys.readouterr().out
    assert rc == 0 and "Signalled" in out

    # signal: conflicting task names error the same way
    rc = main(["-address", addr, "alloc", "signal", "-s", "SIGHUP",
               "-task", "worker", alloc_id, "other"])
    err = capsys.readouterr().err
    assert rc == 1 and "both" in err

    # unknown task surfaces the client error, nonzero exit
    rc = main(["-address", addr, "alloc", "restart",
               "-task", "nope", alloc_id])
    err = capsys.readouterr().err
    assert rc == 1 and "Error" in err

    server.deregister_job("default", "cli-variants")


def test_job_register_backpressure_429(cluster):
    """Backpressure escalation (ROADMAP open item): when the broker's
    delayed/requeue heap crosses its watermark, the job-register edge
    refuses with 429 + Retry-After instead of parking more work."""
    import time as _t
    import urllib.error
    import urllib.request

    from nomad_tpu_torch.models import Evaluation

    server, client, c = cluster
    broker = server.eval_broker
    # an existing job to exercise the evaluate edge against
    pre = mock.batch_job()
    pre.id = "bp-preexisting"
    pre.task_groups[0].tasks[0].config = {"run_for": "1s"}
    c.register_job(job_to_spec(pre))
    old_high = broker.delayed_depth_high
    try:
        broker.delayed_depth_high = 2
        # park fake deferred evals well in the future — the shed
        # valve's backlog, without racing the pop timer
        with broker._l:
            for i in range(2):
                broker._delayed.append(
                    (_t.time() + 300, i, Evaluation(job_id=f"bp{i}")))

        def expect_429(path, body_dict):
            body = json.dumps(body_dict).encode()
            req = urllib.request.Request(
                f"{c.address}{path}", data=body, method="PUT",
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == 429
            retry_after = e.value.headers.get("Retry-After")
            assert retry_after is not None and int(retry_after) >= 1
            assert "overloaded" in json.loads(e.value.read())["error"]

        expect_429("/v1/jobs", {"Job": job_to_spec(mock.batch_job())})
        # every edge that CREATES evals is valved, not just register
        expect_429("/v1/job/bp-preexisting/evaluate", {})
    finally:
        with broker._l:
            broker._delayed.clear()
        broker.delayed_depth_high = old_high
    # valve clear: the same register admits
    resp = c.register_job(job_to_spec(mock.batch_job()))
    assert "EvalID" in resp


def test_status_leader_and_pprof_cmdline(cluster):
    """Surface-drift ratchet (nomad_tpu_torch/analysis): every /v1 route
    needs a CLI or test reference — these two had neither."""
    server, client, c = cluster
    # dev (raft-less) agent: trivially its own leader, reports its RPC
    # address (status_endpoint.go Leader)
    leader = c._request("GET", "/v1/status/leader")
    assert isinstance(leader, str) and leader
    cmdline = c._request("GET", "/v1/agent/pprof/cmdline")
    assert cmdline["cmdline"]
