"""The reference's ui suite (tests/test_ui.py) against the port's
api/ui.py beside a Client, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Embedded web UI (vs the reference's ui/ Ember app served by the
agent): the page is served at / and /ui, and every endpoint+field the
page's JS consumes exists on the live API — the contract a browser
exercise would depend on (CI has no browser)."""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import ApiClient, HTTPApiServer
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import Service
from nomad_tpu_torch.models.networks import NetworkResource, Port
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture
def ui_cluster():
    srv = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=60.0))
    srv.start()
    cl = Client(srv, ClientConfig(node_name="ui-node"))
    cl.start()
    api = HTTPApiServer(srv, port=0)
    api.start()
    job = mock.job()
    job.id = "ui-job"
    job.update = None
    tg = job.task_groups[0]
    tg.count = 1
    tg.networks = [NetworkResource(dynamic_ports=[Port(label="http")])]
    tg.services = [Service(name="ui-svc", port_label="http")]
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": "120s"}
    tg.tasks[0].services = []
    tg.tasks[0].resources.networks = []
    srv.register_job(job)
    assert _wait(lambda: any(
        a.client_status == "running"
        for a in srv.store.allocs_by_job("default", "ui-job")))
    yield srv, api
    api.shutdown()
    cl.shutdown()
    srv.shutdown()


def test_ui_page_served(ui_cluster):
    import urllib.request
    _srv, api = ui_cluster
    for path in ("/", "/ui", "/ui/jobs"):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{api.port}{path}", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/html")
            assert "<title>nomad-tpu</title>" in body


def test_ui_data_contract(ui_cluster):
    """Every endpoint + key the UI's JS destructures."""
    srv, api = ui_cluster
    c = ApiClient(f"http://127.0.0.1:{api.port}")

    jobs = c.list_jobs()
    assert all(k in jobs[0] for k in ("ID", "Status", "Type",
                                      "Priority"))
    job = c.get_job("ui-job")
    for k in ("task_groups", "status", "namespace", "region",
              "datacenters", "version"):
        assert k in job
    g = job["task_groups"][0]
    assert "name" in g and "count" in g and "tasks" in g

    allocs = c._request("GET", "/v1/job/ui-job/allocations")
    for k in ("id", "task_group", "client_status", "desired_status",
              "node_id"):
        assert k in allocs[0]
    evals = c._request("GET", "/v1/job/ui-job/evaluations")
    assert all(k in evals[0] for k in ("id", "status", "triggered_by",
                                       "type"))

    nodes = c.list_nodes()
    for k in ("id", "name", "status", "datacenter",
              "scheduling_eligibility", "drain"):
        assert k in nodes[0]
    node = c._request("GET", f"/v1/node/{nodes[0]['id']}")
    assert "attributes" in node and "node_class" in node
    nallocs = c._request("GET",
                         f"/v1/node/{nodes[0]['id']}/allocations")
    assert "job_id" in nallocs[0]

    alloc = c._request("GET", f"/v1/allocation/{allocs[0]['id']}")
    assert "task_states" in alloc
    ts = list(alloc["task_states"].values())[0]
    assert "state" in ts and "restarts" in ts and "events" in ts

    svcs = c.list_services()
    assert svcs[0]["ServiceName"] == "ui-svc" and "Tags" in svcs[0]
    regs = c.get_service("ui-svc")
    for k in ("alloc_id", "address", "port", "status", "task_name"):
        assert k in regs[0]
