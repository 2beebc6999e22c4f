"""The reference's API-surface suite (tests/test_api_surface.py) against
the port's event broker, HTTP API, job diff engine and the port's Client
on its `cluster` fixture, servers on the CPU, assertions unchanged.

The reference's docstring:

Event stream, search, scaling API, and job plan (dry-run + diff).

Reference scenarios: nomad/stream/event_broker_test.go,
nomad/search_endpoint.go, nomad/job_endpoint.go Plan/Scale, and
structs/diff.go JobDiff tests.
"""

import json
import threading
import time
import urllib.request

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.server import ServerConfig
from nomad_tpu_torch.server.event_broker import (
    EventBroker, Event, TOPIC_JOB, TOPIC_NODE,
)


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


@pytest.fixture
def cluster():
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="api-client"))
    client.start()
    yield server, client
    client.shutdown()
    server.shutdown()


# -- event broker ------------------------------------------------------

def test_event_broker_topic_filtering():
    b = EventBroker()
    sub_all, _ = b.subscribe()
    sub_job, _ = b.subscribe({TOPIC_JOB: ["my-job"]})
    b.publish([Event(topic=TOPIC_JOB, type="JobRegistered", key="my-job",
                     index=5),
               Event(topic=TOPIC_JOB, type="JobRegistered", key="other",
                     index=6),
               Event(topic=TOPIC_NODE, type="NodeRegistration", key="n1",
                     index=7)])
    got_all = sub_all.next_events(timeout_s=1.0)
    assert len(got_all) == 3
    got_job = sub_job.next_events(timeout_s=1.0)
    assert [e.key for e in got_job] == ["my-job"]
    # replay: a late subscriber sees buffered events after from_index
    late, backlog = b.subscribe({TOPIC_JOB: ["*"]}, from_index=5)
    assert [e.key for e in backlog] == ["other"]
    late.unsubscribe()
    sub_all.unsubscribe()
    sub_job.unsubscribe()


def test_events_published_on_fsm_applies(cluster):
    server, client = cluster
    sub, _ = server.events.subscribe({TOPIC_JOB: ["*"]})
    job = mock.batch_job()
    job.task_groups[0].tasks[0].config = {"run_for": "50ms"}
    server.register_job(job)
    got = sub.next_events(timeout_s=5.0)
    assert any(e.type == "JobRegistered" and e.key == job.id for e in got)
    sub.unsubscribe()


def test_event_stream_http_endpoint(cluster):
    server, client = cluster
    from nomad_tpu_torch.api import HTTPApiServer
    api = HTTPApiServer(server, port=0)
    api.start()
    try:
        events = []

        def consume():
            url = (f"http://127.0.0.1:{api.port}/v1/event/stream"
                   f"?topic=Job:*")
            with urllib.request.urlopen(url, timeout=10) as resp:
                for line in resp:
                    line = line.strip()
                    if line and line != b"{}":
                        events.append(json.loads(line))
                        return

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)
        job = mock.batch_job()
        job.task_groups[0].tasks[0].config = {"run_for": "50ms"}
        server.register_job(job)
        t.join(timeout=10)
        assert events, "no event batch received over HTTP"
        batch = events[0]
        assert any(e["type"] == "JobRegistered"
                   for e in batch["Events"])
    finally:
        api.shutdown()


# -- search ------------------------------------------------------------

def test_search_endpoint(cluster):
    server, client = cluster
    from nomad_tpu_torch.api import HTTPApiServer
    from nomad_tpu_torch.api.client import ApiClient
    job = mock.batch_job()
    job.id = "search-target-job"
    job.task_groups[0].tasks[0].config = {"run_for": "50ms"}
    job.canonicalize()
    server.register_job(job)
    api = HTTPApiServer(server, port=0)
    api.start()
    try:
        c = ApiClient(f"http://127.0.0.1:{api.port}")
        res = c.search("search-", "jobs")
        assert res["Matches"]["jobs"] == ["search-target-job"]
        assert res["Truncations"]["jobs"] is False
        res = c.search("", "all")
        assert "nodes" in res["Matches"] and len(res["Matches"]["nodes"]) == 1
        with pytest.raises(Exception):
            c.search("x", "bogus-context")
    finally:
        api.shutdown()


# -- scaling -----------------------------------------------------------

def test_job_scale_up_and_policy_bounds(cluster):
    server, client = cluster
    from nomad_tpu_torch.models.job import Scaling
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": "60s"}
    tg.scaling = Scaling(min=1, max=3)
    job.constraints = []
    job.canonicalize()
    server.register_job(job)
    assert _wait_for(lambda: len(
        server.store.allocs_by_job(job.namespace, job.id)) == 1, timeout=30.0)

    ev = server.scale_job(job.namespace, job.id, "web", count=3)
    assert ev is not None
    assert _wait_for(lambda: len(
        server.store.allocs_by_job(job.namespace, job.id)) == 3, timeout=30.0)
    events = server.store.scaling_events(job.namespace, job.id)
    assert events and events[0]["count"] == 3

    with pytest.raises(ValueError, match="above scaling policy maximum"):
        server.scale_job(job.namespace, job.id, "web", count=5)
    with pytest.raises(ValueError, match="below scaling policy minimum"):
        server.scale_job(job.namespace, job.id, "web", count=0)
    with pytest.raises(KeyError):
        server.scale_job(job.namespace, job.id, "nope", count=2)


# -- job plan / diff ---------------------------------------------------

def test_job_diff_engine():
    from nomad_tpu_torch.models.diff import job_diff, DIFF_ADDED, DIFF_EDITED
    old = mock.job()
    new = old.copy()
    new.priority = 70
    new.task_groups[0].count = 12
    new.task_groups[0].tasks[0].env = {"FOO": "baz", "NEW": "1"}
    d = job_diff(old, new)
    assert d["Type"] == DIFF_EDITED
    assert any(f["Name"] == "priority" and f["Old"] == "50"
               and f["New"] == "70" for f in d["Fields"])
    tg = [g for g in d["TaskGroups"] if g["Name"] == "web"][0]
    assert any(f["Name"] == "count" and f["New"] == "12"
               for f in tg["Fields"])
    task = tg["Tasks"][0]
    env_obj = [o for o in task["Objects"] if o["Name"] == "env"][0]
    names = {f["Name"]: f for f in env_obj["Fields"]}
    assert names["env[FOO]"]["Old"] == "bar"
    assert names["env[NEW]"]["Type"] == DIFF_ADDED

    # new job is all Added; identical jobs are None
    assert job_diff(None, old)["Type"] == DIFF_ADDED
    assert job_diff(old, old.copy())["Type"] == "None"


def test_plan_job_dry_run_commits_nothing(cluster):
    server, client = cluster
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].driver = "mock_driver"
    job.task_groups[0].tasks[0].config = {"run_for": "60s"}
    job.constraints = []
    job.canonicalize()

    result = server.plan_job(job)
    assert result["diff"]["Type"] == "Added"
    assert not result["failed_tg_allocs"]
    ann = result["annotations"]["desired_tg_updates"]
    assert ann["web"]["place"] == 2
    # nothing committed: the job does not exist, no allocs placed
    assert server.store.job_by_id(job.namespace, job.id) is None
    assert server.store.allocs_by_job(job.namespace, job.id) == []

    # impossible ask -> failed placements reported, still uncommitted
    big = job.copy()
    big.task_groups[0].tasks[0].resources.cpu = 999999
    result = server.plan_job(big)
    assert "web" in result["failed_tg_allocs"]
