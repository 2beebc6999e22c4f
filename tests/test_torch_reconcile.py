"""The port's run of tests/test_reconcile.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Reconciler unit tests (reference: scheduler/reconcile_test.go patterns)."""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING, ALLOC_DESIRED_RUN,
    Allocation, UpdateStrategy,
)
from nomad_tpu_torch.models.alloc import AllocDeploymentStatus
from nomad_tpu_torch.models.deployment import Deployment, DeploymentState
from nomad_tpu_torch.scheduler.reconcile import AllocReconciler
from nomad_tpu_torch.scheduler.reconcile_util import AllocNameIndex


def _ignore_update_fn(alloc, job, tg):
    return True, False, None


def _destructive_update_fn(alloc, job, tg):
    return False, True, None


def _inplace_update_fn(alloc, job, tg):
    return False, False, alloc


def _allocs_for(job, count, node_ids=None, client_status=ALLOC_CLIENT_RUNNING):
    out = []
    for i in range(count):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.task_group = "web"
        a.name = f"{job.id}.web[{i}]"
        a.client_status = client_status
        a.node_id = node_ids[i % len(node_ids)] if node_ids else f"node-{i}"
        out.append(a)
    return out


def test_place_all_when_empty():
    job = mock.job()
    r = AllocReconciler(_ignore_update_fn, False, job.id, job, None, [], {},
                        "eval-1")
    res = r.compute()
    assert len(res.place) == 10
    names = sorted(p.name for p in res.place)
    assert names == sorted(f"{job.id}.web[{i}]" for i in range(10))
    assert res.desired_tg_updates["web"].place == 10


def test_scale_up_places_missing_names():
    job = mock.job()
    allocs = _allocs_for(job, 4)
    job2 = job.copy()
    job2.task_groups[0].count = 6
    r = AllocReconciler(_ignore_update_fn, False, job.id, job2, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert len(res.place) == 2
    assert sorted(p.name for p in res.place) == [
        f"{job.id}.web[4]", f"{job.id}.web[5]"]


def test_scale_down_stops_highest():
    job = mock.job()
    allocs = _allocs_for(job, 10)
    job2 = job.copy()
    job2.task_groups[0].count = 7
    r = AllocReconciler(_ignore_update_fn, False, job.id, job2, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert len(res.stop) == 3
    stopped = sorted(s.alloc.index() for s in res.stop)
    assert stopped == [7, 8, 9]
    assert res.desired_tg_updates["web"].stop == 3


def test_destructive_updates_respect_max_parallel():
    job = mock.job()
    job.task_groups[0].update = UpdateStrategy(max_parallel=3)
    allocs = _allocs_for(job, 10)
    old = job.copy()
    for a in allocs:
        a.job = old
    job2 = job.copy()
    job2.version = 1
    job2.task_groups[0].update = UpdateStrategy(max_parallel=3)
    r = AllocReconciler(_destructive_update_fn, False, job.id, job2, None,
                        allocs, {}, "eval-1")
    res = r.compute()
    assert len(res.destructive_update) == 3
    assert res.desired_tg_updates["web"].destructive_update == 3
    assert res.desired_tg_updates["web"].ignore == 7
    # a deployment is created for the update
    assert res.deployment is not None
    assert res.deployment.task_groups["web"].desired_total == 10


def test_inplace_updates_unlimited():
    job = mock.job()
    allocs = _allocs_for(job, 10)
    r = AllocReconciler(_inplace_update_fn, False, job.id, job, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert len(res.inplace_update) == 10
    assert res.desired_tg_updates["web"].in_place_update == 10
    assert not res.place and not res.stop


def test_canaries_created_for_destructive_update():
    job = mock.job()
    strategy = UpdateStrategy(max_parallel=2, canary=2)
    job.task_groups[0].update = strategy
    allocs = _allocs_for(job, 10)
    r = AllocReconciler(_destructive_update_fn, False, job.id, job, None,
                        allocs, {}, "eval-1")
    res = r.compute()
    # canaries placed, no destructive updates yet (canary gate)
    canary_places = [p for p in res.place if p.canary]
    assert len(canary_places) == 2
    assert len(res.destructive_update) == 0
    assert res.desired_tg_updates["web"].canary == 2
    assert res.deployment is not None
    assert res.deployment.task_groups["web"].desired_canaries == 2


def test_promoted_canaries_allow_updates():
    job = mock.job()
    strategy = UpdateStrategy(max_parallel=2, canary=2)
    job.task_groups[0].update = strategy
    allocs = _allocs_for(job, 10)
    # deployment with promoted canaries
    d = Deployment.from_job(job)
    d.task_groups["web"] = DeploymentState(
        promoted=True, desired_canaries=2, desired_total=10,
        placed_canaries=[allocs[0].id, allocs[1].id])
    for a in allocs[:2]:
        a.deployment_id = d.id
        a.deployment_status = AllocDeploymentStatus(healthy=True, canary=True)
    r = AllocReconciler(_destructive_update_fn, False, job.id, job, d, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert len(res.destructive_update) > 0


def test_job_stopped_stops_everything():
    job = mock.job()
    allocs = _allocs_for(job, 5)
    job2 = job.copy()
    job2.stop = True
    r = AllocReconciler(_ignore_update_fn, False, job.id, job2, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert len(res.stop) == 5
    assert not res.place


def test_failed_alloc_rescheduled_now():
    import time
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].reschedule_policy.delay_s = 0.0
    allocs = _allocs_for(job, 2)
    from nomad_tpu_torch.models import TaskState
    from nomad_tpu_torch.models.alloc import TASK_STATE_DEAD
    allocs[0].client_status = ALLOC_CLIENT_FAILED
    allocs[0].task_states = {"web": TaskState(
        state=TASK_STATE_DEAD, failed=True, finished_at=time.time() - 30)}
    r = AllocReconciler(_ignore_update_fn, False, job.id, job, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    resched = [p for p in res.place if p.reschedule]
    assert len(resched) == 1
    assert resched[0].previous_alloc.id == allocs[0].id


def test_failed_alloc_delayed_reschedule_creates_followup():
    import time
    job = mock.job()
    job.task_groups[0].count = 1
    job.task_groups[0].reschedule_policy.delay_s = 300.0
    allocs = _allocs_for(job, 1)
    from nomad_tpu_torch.models import TaskState
    from nomad_tpu_torch.models.alloc import TASK_STATE_DEAD
    allocs[0].client_status = ALLOC_CLIENT_FAILED
    allocs[0].task_states = {"web": TaskState(
        state=TASK_STATE_DEAD, failed=True, finished_at=time.time())}
    r = AllocReconciler(_ignore_update_fn, False, job.id, job, None, allocs,
                        {}, "eval-1")
    res = r.compute()
    assert not [p for p in res.place if p.reschedule]
    evals = res.desired_followup_evals.get("web", [])
    assert len(evals) == 1
    assert evals[0].wait_until > time.time() + 200
    # alloc gets its followup eval id recorded
    assert allocs[0].id in res.attribute_updates
    assert res.attribute_updates[allocs[0].id].follow_up_eval_id == evals[0].id


def test_lost_allocs_replaced():
    job = mock.job()
    job.task_groups[0].count = 3
    allocs = _allocs_for(job, 3)
    # node of alloc 0 is down
    down = mock.node()
    down.status = "down"
    allocs[0].node_id = down.id
    r = AllocReconciler(_ignore_update_fn, False, job.id, job, None, allocs,
                        {down.id: down}, "eval-1")
    res = r.compute()
    assert len(res.stop) == 1
    assert res.stop[0].client_status == "lost"
    assert len(res.place) == 1
    assert res.place[0].name == allocs[0].name


def test_alloc_name_index():
    idx = AllocNameIndex("job", "web", 5, {})
    names = idx.next(3)
    assert names == ["job.web[0]", "job.web[1]", "job.web[2]"]
    more = idx.next(2)
    assert more == ["job.web[3]", "job.web[4]"]
    # overflow wraps
    over = idx.next(2)
    assert over == ["job.web[0]", "job.web[1]"]
