"""The reference's deployments suite (tests/test_deployments.py) against the port's
the deployment watcher and the Clients' alloc health, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Deployment lifecycle: health tracking, auto-promote, auto-revert,
progress deadlines, promote/fail/pause RPCs.

Reference scenarios: nomad/deploymentwatcher/deployments_watcher_test.go
(TestWatcher_*), scheduler/generic_sched_test.go canary flows, and
state_store_test.go UpdateDeploymentPromotion/JobStability.
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import ALLOC_CLIENT_RUNNING
from nomad_tpu_torch.models.deployment import (
    DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_SUCCESSFUL,
)
from nomad_tpu_torch.models.job import UpdateStrategy
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


def _service_job(count=2, canary=0, auto_revert=False, auto_promote=False,
                 progress_deadline_s=30.0):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": "120s"}
    tg.restart_policy.attempts = 0
    tg.restart_policy.mode = "fail"
    tg.update = UpdateStrategy(
        max_parallel=count, canary=canary,
        min_healthy_time_s=0.05, healthy_deadline_s=5.0,
        progress_deadline_s=progress_deadline_s,
        auto_revert=auto_revert, auto_promote=auto_promote)
    job.constraints = []
    job.canonicalize()
    return job


@pytest.fixture
def cluster():
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    client = Client(server, ClientConfig(node_name="deploy-client"))
    client.start()
    yield server, client
    client.shutdown()
    server.shutdown()


def _latest_deployment(server, job):
    return server.store.latest_deployment_by_job(job.namespace, job.id)


def _wait_successful(server, job, timeout=15.0, version=0):
    def done():
        d = _latest_deployment(server, job)
        return (d is not None and d.job_version == version
                and d.status == DEPLOYMENT_STATUS_SUCCESSFUL)
    assert _wait_for(done, timeout=timeout), \
        (d := _latest_deployment(server, job)) and (d.job_version, d.status,
                                                    d.status_description)
    return _latest_deployment(server, job)


def test_rolling_deployment_succeeds_and_marks_stable(cluster):
    server, client = cluster
    job = _service_job(count=2)
    server.register_job(job)

    d = _wait_successful(server, job)
    state = d.task_groups["web"]
    assert state.placed_allocs == 2
    assert state.healthy_allocs == 2
    # the completed version is flagged stable (the rollback target)
    stored = server.store.job_by_id(job.namespace, job.id)
    assert stored.stable is True


def test_failed_allocs_fail_deployment_and_auto_revert(cluster):
    server, client = cluster
    job = _service_job(count=2, auto_revert=True)
    server.register_job(job)
    _wait_successful(server, job)          # v0 becomes the stable target

    # v1: tasks exit non-zero immediately -> unhealthy -> fail + revert
    bad = server.store.job_by_id(job.namespace, job.id).copy()
    bad.task_groups[0].tasks[0].config = {"run_for": "30ms", "exit_code": "1"}
    bad.task_groups[0].update = job.task_groups[0].update
    server.register_job(bad)

    assert _wait_for(lambda: any(
        d.status == DEPLOYMENT_STATUS_FAILED and d.job_version == 1
        for d in server.store.deployments_by_job(job.namespace, job.id)))
    failed = [d for d in server.store.deployments_by_job(job.namespace, job.id)
              if d.job_version == 1][0]
    assert "rolling back to job version 0" in failed.status_description
    # the job spec is back to the stable (healthy) config as a NEW version
    assert _wait_for(lambda: server.store.job_by_id(
        job.namespace, job.id).version == 2)
    reverted = server.store.job_by_id(job.namespace, job.id)
    assert reverted.task_groups[0].tasks[0].config.get("exit_code") is None


def test_canary_manual_promotion_flow(cluster):
    server, client = cluster
    job = _service_job(count=3)
    server.register_job(job)
    _wait_successful(server, job)

    # v1 with one canary
    v1 = server.store.job_by_id(job.namespace, job.id).copy()
    v1.task_groups[0].tasks[0].env = {"VERSION": "2"}
    v1.task_groups[0].update = UpdateStrategy(
        max_parallel=3, canary=1, min_healthy_time_s=0.05,
        healthy_deadline_s=5.0, progress_deadline_s=30.0)
    server.register_job(v1)

    # one healthy canary placed; deployment awaits promotion
    def canary_ready():
        d = _latest_deployment(server, job)
        if d is None or d.job_version != 1:
            return False
        s = d.task_groups["web"]
        return len(s.placed_canaries) == 1 and s.healthy_allocs >= 1
    assert _wait_for(canary_ready)
    d = _latest_deployment(server, job)
    assert d.status == DEPLOYMENT_STATUS_RUNNING
    assert d.requires_promotion()

    ev = server.promote_deployment(d.id)
    assert ev is not None
    assert server.store.deployment_by_id(d.id).task_groups["web"].promoted

    d = _wait_successful(server, job, timeout=20.0, version=1)
    # all 3 replaced and healthy
    assert d.task_groups["web"].healthy_allocs >= 3


def test_canary_auto_promotion(cluster):
    server, client = cluster
    job = _service_job(count=2)
    server.register_job(job)
    _wait_successful(server, job)

    v1 = server.store.job_by_id(job.namespace, job.id).copy()
    v1.task_groups[0].tasks[0].env = {"VERSION": "2"}
    v1.task_groups[0].update = UpdateStrategy(
        max_parallel=2, canary=1, min_healthy_time_s=0.05,
        healthy_deadline_s=5.0, progress_deadline_s=30.0,
        auto_promote=True)
    server.register_job(v1)

    d = _wait_successful(server, job, timeout=20.0, version=1)
    assert d.task_groups["web"].promoted


def test_promotion_requires_healthy_canaries(cluster):
    server, client = cluster
    job = _service_job(count=2)
    server.register_job(job)
    _wait_successful(server, job)

    # v1 canary that can never reach healthy within the test window
    v1 = server.store.job_by_id(job.namespace, job.id).copy()
    v1.task_groups[0].tasks[0].env = {"VERSION": "2"}
    v1.task_groups[0].update = UpdateStrategy(
        max_parallel=2, canary=1, min_healthy_time_s=300.0,
        healthy_deadline_s=600.0, progress_deadline_s=900.0)
    server.register_job(v1)

    def placed():
        d = _latest_deployment(server, job)
        return (d is not None and d.job_version == 1
                and d.task_groups["web"].placed_canaries)
    assert _wait_for(placed)
    d = _latest_deployment(server, job)
    with pytest.raises(ValueError, match="healthy canaries"):
        server.promote_deployment(d.id)


def test_progress_deadline_fails_deployment(cluster):
    server, client = cluster
    # tasks stay pending-ish: run_for long but never become healthy
    # because min_healthy_time can't be met before the progress deadline.
    job = _service_job(count=1, progress_deadline_s=0.3)
    job.task_groups[0].update.min_healthy_time_s = 60.0
    server.register_job(job)

    assert _wait_for(lambda: (d := _latest_deployment(server, job)) is not None
                     and d.status == DEPLOYMENT_STATUS_FAILED, timeout=20.0)
    d = _latest_deployment(server, job)
    assert "progress deadline" in d.status_description.lower()


def test_pause_and_fail_rpcs(cluster):
    server, client = cluster
    job = _service_job(count=1, canary=1)  # canary gate keeps it running
    server.register_job(job)
    assert _wait_for(lambda: _latest_deployment(server, job) is not None)
    d = _latest_deployment(server, job)

    server.pause_deployment(d.id, True)
    assert server.store.deployment_by_id(d.id).status == \
        DEPLOYMENT_STATUS_PAUSED
    server.pause_deployment(d.id, False)
    assert server.store.deployment_by_id(d.id).status == \
        DEPLOYMENT_STATUS_RUNNING

    server.fail_deployment(d.id)
    assert server.store.deployment_by_id(d.id).status == \
        DEPLOYMENT_STATUS_FAILED
    # terminal deployments reject further transitions
    with pytest.raises(ValueError):
        server.pause_deployment(d.id, True)
    with pytest.raises(ValueError):
        server.promote_deployment(d.id)


def test_promotion_payload_survives_wal_roundtrip():
    """deployment_promotion evals must decode back into Evaluation objects
    on WAL replay (persistence.SCHEMAS coverage)."""
    from nomad_tpu_torch.models import Evaluation
    from nomad_tpu_torch.server.persistence import decode_payload, encode_payload
    ev = Evaluation(job_id="j", triggered_by="deployment-watcher")
    wire = encode_payload("deployment_promotion",
                          dict(deployment_id="d1", groups=None, evals=[ev]))
    back = decode_payload("deployment_promotion", wire)
    assert back["deployment_id"] == "d1"
    assert isinstance(back["evals"][0], Evaluation)
    assert back["evals"][0].id == ev.id


def test_revert_job_endpoint(cluster):
    server, client = cluster
    job = _service_job(count=1)
    server.register_job(job)
    _wait_successful(server, job)

    v1 = server.store.job_by_id(job.namespace, job.id).copy()
    v1.task_groups[0].tasks[0].env = {"VERSION": "2"}
    server.register_job(v1)
    assert _wait_for(lambda: server.store.job_by_id(
        job.namespace, job.id).version == 1)

    ev = server.revert_job(job.namespace, job.id, 0)
    assert ev is not None
    current = server.store.job_by_id(job.namespace, job.id)
    assert current.version == 2
    assert current.task_groups[0].tasks[0].env.get("VERSION") is None
    with pytest.raises(ValueError):
        server.revert_job(job.namespace, job.id, 2)
