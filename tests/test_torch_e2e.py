"""The reference's e2e suite (tests/test_e2e.py) against the port's
Server and Client with the mock driver, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

End-to-end single-process slice: Server + Client + mock driver.

This is the BASELINE.json config #1 analog ("agent -dev" + job run):
register a job, watch the full pipeline — broker -> worker -> scheduler
kernel -> plan queue -> applier -> state -> client watch -> mock driver
-> status push — land the allocs in `running` / `complete`.
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_RUNNING, JOB_STATUS_RUNNING,
)
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait_for(pred, timeout=10.0, interval=0.05):
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
    client = Client(server, ClientConfig(node_name="test-client"))
    client.start()
    yield server, client
    client.shutdown()
    server.shutdown()


def test_batch_job_runs_to_completion(cluster):
    server, client = cluster
    job = mock.batch_job()
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].config = {"run_for": "100ms"}
    server.register_job(job)

    assert _wait_for(lambda: len(
        server.store.allocs_by_job("default", job.id)) == 3), \
        "allocs were never placed"
    assert _wait_for(lambda: all(
        a.client_status == ALLOC_CLIENT_COMPLETE
        for a in server.store.allocs_by_job("default", job.id))), \
        [a.client_status for a in server.store.allocs_by_job("default", job.id)]
    # job summary reflects completion
    summ = server.store.job_summary("default", job.id)
    assert summ.summary["worker"].get("complete") == 3


def test_service_job_stays_running_and_stops_on_deregister(cluster):
    server, client = cluster
    job = mock.batch_job()
    job.type = "service"
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {"run_for": "60s"}
    job.canonicalize()
    server.register_job(job)

    assert _wait_for(lambda: all(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_job("default", job.id))
        and len(server.store.allocs_by_job("default", job.id)) == 2)
    assert server.store.job_by_id("default", job.id).status == JOB_STATUS_RUNNING

    server.deregister_job("default", job.id)
    assert _wait_for(lambda: all(
        a.client_status in ("complete", "failed")
        or a.terminal_status()
        for a in server.store.allocs_by_job("default", job.id)))
    # client actually killed its runners
    assert _wait_for(lambda: all(
        r.destroyed for r in client.runners.values()))


def test_failed_task_triggers_reschedule_eval(cluster):
    server, client = cluster
    job = mock.batch_job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].config = {"run_for": "50ms", "exit_code": 1}
    job.task_groups[0].restart_policy.attempts = 0
    job.task_groups[0].reschedule_policy.attempts = 1
    job.task_groups[0].reschedule_policy.delay_s = 0.0
    job.task_groups[0].reschedule_policy.interval_s = 600.0
    server.register_job(job)

    # the failure should produce a replacement alloc (reschedule)
    assert _wait_for(lambda: len(
        server.store.allocs_by_job("default", job.id)) >= 2, timeout=15), \
        [a.client_status for a in server.store.allocs_by_job("default", job.id)]
    allocs = server.store.allocs_by_job("default", job.id)
    replacements = [a for a in allocs if a.previous_allocation]
    assert replacements


def test_blocked_eval_unblocks_when_node_joins(cluster):
    server, client = cluster
    # job too big for the default 4000MHz node
    job = mock.batch_job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = 6000
    server.register_job(job)

    assert _wait_for(lambda: server.blocked_evals.blocked_count() == 1)
    assert server.store.allocs_by_job("default", job.id) == []

    # a bigger node joins -> eval unblocks -> placement succeeds
    big = Client(server, ClientConfig(node_name="big", cpu_shares=8000))
    big.start()
    try:
        assert _wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 1, timeout=15)
        placed = server.store.allocs_by_job("default", job.id)[0]
        assert placed.node_id == big.node.id
    finally:
        big.shutdown()
