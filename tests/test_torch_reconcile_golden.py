"""The port's run of tests/test_reconcile_golden.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Golden reconciler scenarios ported from scheduler/reconcile_test.go.

Each test names its reference function (TestReconciler_*) and asserts
the same result expectation: place/destructive/inplace/stop counts,
deployment creation/updates, per-task-group DesiredUpdates, and the
alloc-name indexes chosen — the contract `nomad plan` and the
deployment watcher build on.
"""

import re

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING,
    ALLOC_DESIRED_STOP, UpdateStrategy,
)
from nomad_tpu_torch.models.alloc import AllocDeploymentStatus
from nomad_tpu_torch.models.deployment import (
    DEPLOYMENT_STATUS_CANCELLED, DEPLOYMENT_STATUS_FAILED,
    DEPLOYMENT_STATUS_PAUSED, DEPLOYMENT_STATUS_SUCCESSFUL,
    Deployment, DeploymentState,
)
from nomad_tpu_torch.scheduler.reconcile import AllocReconciler
from nomad_tpu_torch.utils.ids import generate_uuid

# reconcile_test.go:22-38
CANARY_UPDATE = UpdateStrategy(canary=2, max_parallel=2,
                               min_healthy_time_s=10.0,
                               healthy_deadline_s=600.0, stagger_s=31.0)
NO_CANARY_UPDATE = UpdateStrategy(max_parallel=4, min_healthy_time_s=10.0,
                                  healthy_deadline_s=600.0, stagger_s=31.0)


def fn_ignore(alloc, job, tg):
    return True, False, None


def fn_destructive(alloc, job, tg):
    return False, True, None


def fn_inplace(alloc, job, tg):
    return False, False, alloc


def fn_mock(handled, unhandled):
    """allocUpdateFnMock (reconcile_test.go:76)."""
    def fn(alloc, job, tg):
        h = handled.get(alloc.id)
        return h(alloc, job, tg) if h else unhandled(alloc, job, tg)
    return fn


def make_allocs(job, n, tg_name="web", start=0,
                client_status=ALLOC_CLIENT_RUNNING):
    out = []
    for i in range(start, start + n):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = generate_uuid()
        a.task_group = tg_name
        a.name = f"{job.id}.{tg_name}[{i}]"
        a.client_status = client_status
        out.append(a)
    return out


_IDX_RE = re.compile(r".+\[(\d+)\]$")


def _names_to_indexes(results):
    out = []
    for r in results:
        name = getattr(r, "name", None) or getattr(r, "place_name", None)
        if name is None:          # stop results carry the alloc
            name = r.alloc.name
        m = _IDX_RE.match(name)
        out.append(int(m.group(1)) if m else -1)
    return sorted(out)


def _stop_indexes(res):
    return sorted(int(_IDX_RE.match(s.alloc.name).group(1))
                  for s in res.stop)


def assert_results(res, *, place=0, destructive=0, inplace=0, stop=0,
                   create_deployment=None, n_deployment_updates=0,
                   desired=None):
    assert len(res.place) == place, \
        f"place {len(res.place)} != {place}"
    assert len(res.destructive_update) == destructive, \
        f"destructive {len(res.destructive_update)} != {destructive}"
    assert len(res.inplace_update) == inplace, \
        f"inplace {len(res.inplace_update)} != {inplace}"
    assert len(res.stop) == stop, f"stop {len(res.stop)} != {stop}"
    if create_deployment is False:
        assert res.deployment is None, "unexpected deployment created"
    elif create_deployment is True:
        assert res.deployment is not None, "expected deployment"
    assert len(res.deployment_updates) == n_deployment_updates, \
        [f"{u.deployment_id}:{u.status}" for u in res.deployment_updates]
    for tg, want in (desired or {}).items():
        got = res.desired_tg_updates.get(tg)
        assert got is not None, f"no DesiredUpdates for {tg}"
        for field_name, val in want.items():
            assert getattr(got, field_name) == val, \
                f"{tg}.{field_name}: {getattr(got, field_name)} != {val}"


def reconcile(fn, job, deployment, allocs, tainted=None, batch=False,
              job_id=None, now=None):
    r = AllocReconciler(fn, batch, job_id or (job.id if job else "missing"),
                        job, deployment, allocs, tainted or {}, "eval-1",
                        **({"now": now} if now is not None else {}))
    return r.compute()


# -- basic placement / scaling (reconcile_test.go:291-724) -------------
def test_place_no_existing():
    """TestReconciler_Place_NoExisting:291."""
    job = mock.job()
    res = reconcile(fn_ignore, job, None, [])
    assert_results(res, place=10, desired={"web": dict(place=10)})
    assert _names_to_indexes(res.place) == list(range(10))


def test_place_existing():
    """TestReconciler_Place_Existing:315."""
    job = mock.job()
    res = reconcile(fn_ignore, job, None, make_allocs(job, 5))
    assert_results(res, place=5, desired={"web": dict(place=5, ignore=5)})
    assert _names_to_indexes(res.place) == list(range(5, 10))


def test_scale_down_partial():
    """TestReconciler_ScaleDown_Partial:352 — 20 existing, count 10."""
    job = mock.job()
    allocs = make_allocs(job, 20)
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, stop=10, desired={"web": dict(ignore=10, stop=10)})
    assert _stop_indexes(res) == list(range(10, 20))


def test_scale_down_zero():
    """TestReconciler_ScaleDown_Zero:390."""
    job = mock.job()
    job.task_groups[0].count = 0
    allocs = make_allocs(job, 20)
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, stop=20, desired={"web": dict(stop=20)})
    assert _stop_indexes(res) == list(range(20))


def test_scale_down_zero_duplicate_names():
    """TestReconciler_ScaleDown_Zero_DuplicateNames:428."""
    job = mock.job()
    job.task_groups[0].count = 0
    allocs = []
    for i in range(20):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = generate_uuid()
        a.name = f"{job.id}.web[{i % 2}]"
        allocs.append(a)
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, stop=20, desired={"web": dict(stop=20)})


def test_inplace():
    """TestReconciler_Inplace:467."""
    job = mock.job()
    res = reconcile(fn_inplace, job, None, make_allocs(job, 10))
    assert_results(res, inplace=10,
                   desired={"web": dict(in_place_update=10)})


def test_inplace_scale_up():
    """TestReconciler_Inplace_ScaleUp:503."""
    job = mock.job()
    job.task_groups[0].count = 15
    res = reconcile(fn_inplace, job, None, make_allocs(job, 10))
    assert_results(res, place=5, inplace=10,
                   desired={"web": dict(place=5, in_place_update=10)})
    assert _names_to_indexes(res.place) == list(range(10, 15))


def test_inplace_scale_down():
    """TestReconciler_Inplace_ScaleDown:543."""
    job = mock.job()
    job.task_groups[0].count = 5
    res = reconcile(fn_inplace, job, None, make_allocs(job, 10))
    assert_results(res, inplace=5, stop=5,
                   desired={"web": dict(stop=5, in_place_update=5)})
    assert _stop_indexes(res) == list(range(5, 10))


def test_destructive():
    """TestReconciler_Destructive:582 — no update stanza: all at once."""
    job = mock.job()
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, destructive=10,
                   desired={"web": dict(destructive_update=10)})


def test_destructive_max_parallel_zero():
    """TestReconciler_DestructiveMaxParallel:615 — max_parallel=0 means
    no rolling deployment; all 10 update at once."""
    job = mock.job()
    job.task_groups[0].update = UpdateStrategy(max_parallel=0)
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, destructive=10,
                   desired={"web": dict(destructive_update=10)})


def test_destructive_scale_up():
    """TestReconciler_Destructive_ScaleUp:649."""
    job = mock.job()
    job.task_groups[0].count = 15
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, place=5, destructive=10,
                   desired={"web": dict(place=5, destructive_update=10)})
    assert _names_to_indexes(res.place) == list(range(10, 15))


def test_destructive_scale_down():
    """TestReconciler_Destructive_ScaleDown:688."""
    job = mock.job()
    job.task_groups[0].count = 5
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, destructive=5, stop=5,
                   desired={"web": dict(stop=5, destructive_update=5)})
    assert _stop_indexes(res) == list(range(5, 10))


# -- tainted nodes (reconcile_test.go:726-1028) ------------------------
def _taint(allocs, n, *, down=False, drain=False):
    tainted = {}
    for i in range(n):
        node = mock.node()
        node.id = allocs[i].node_id
        if down:
            node.status = "down"
        if drain:
            allocs[i].desired_transition.migrate = True
            node.drain = True
        tainted[node.id] = node
    return tainted


def test_lost_node():
    """TestReconciler_LostNode:726."""
    job = mock.job()
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 2, down=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, place=2, stop=2,
                   desired={"web": dict(place=2, stop=2, ignore=8)})
    assert _stop_indexes(res) == [0, 1]
    assert _names_to_indexes(res.place) == [0, 1]


def test_lost_node_scale_up():
    """TestReconciler_LostNode_ScaleUp:774."""
    job = mock.job()
    job.task_groups[0].count = 15
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 2, down=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, place=7, stop=2,
                   desired={"web": dict(place=7, stop=2, ignore=8)})
    assert _names_to_indexes(res.place) == [0, 1] + list(range(10, 15))


def test_lost_node_scale_down():
    """TestReconciler_LostNode_ScaleDown:824."""
    job = mock.job()
    job.task_groups[0].count = 5
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 2, down=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, stop=5, desired={"web": dict(stop=5, ignore=5)})


def test_drain_node():
    """TestReconciler_DrainNode:871 — drained allocs MIGRATE (placements
    carry previous_alloc, not reschedule)."""
    job = mock.job()
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 2, drain=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, place=2, stop=2,
                   desired={"web": dict(migrate=2, ignore=8)})
    assert sum(1 for p in res.place if p.previous_alloc is not None) == 2
    assert sum(1 for p in res.place if p.reschedule) == 0


def test_drain_node_scale_up():
    """TestReconciler_DrainNode_ScaleUp:922."""
    job = mock.job()
    job.task_groups[0].count = 15
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 2, drain=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, place=7, stop=2,
                   desired={"web": dict(place=5, migrate=2, ignore=8)})


def test_drain_node_scale_down():
    """TestReconciler_DrainNode_ScaleDown:976 — count 8, 3 draining:
    only 1 needs migrating, 2 simply stop."""
    job = mock.job()
    job.task_groups[0].count = 8
    allocs = make_allocs(job, 10)
    tainted = _taint(allocs, 3, drain=True)
    res = reconcile(fn_ignore, job, None, allocs, tainted)
    assert_results(res, place=1, stop=3,
                   desired={"web": dict(migrate=1, stop=2, ignore=7)})
    assert _stop_indexes(res) == [0, 1, 2]
    assert _names_to_indexes(res.place) == [0]


def test_removed_tg():
    """TestReconciler_RemovedTG:1029 — allocs of a renamed group stop,
    the new group fills fresh."""
    job = mock.job()
    allocs = make_allocs(job, 10)          # belong to "web"
    job.task_groups[0].name = "different"
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, place=10, stop=10,
                   desired={"web": dict(stop=10),
                            "different": dict(place=10)})


@pytest.mark.parametrize("use_job", [True, False],
                         ids=["stopped job", "nil job"])
def test_job_stopped(use_job):
    """TestReconciler_JobStopped:1072."""
    job = mock.job()
    job.stop = True
    the_job = job if use_job else None
    jid = job.id if use_job else "foo"
    tg = "web" if use_job else "bar"
    allocs = make_allocs(job, 10, tg_name=tg)
    res = reconcile(fn_ignore, the_job, None, allocs, job_id=jid)
    assert_results(res, stop=10, desired={tg: dict(stop=10)})


@pytest.mark.parametrize("use_job", [True, False],
                         ids=["stopped job", "nil job"])
def test_job_stopped_terminal_allocs(use_job):
    """TestReconciler_JobStopped_TerminalAllocs:1133 — terminal allocs
    are not stopped again."""
    job = mock.job()
    job.stop = True
    the_job = job if use_job else None
    jid = job.id if use_job else "foo"
    tg = "web" if use_job else "bar"
    allocs = make_allocs(job, 10, tg_name=tg)
    for i, a in enumerate(allocs):
        if i % 2 == 0:
            a.desired_status = ALLOC_DESIRED_STOP
        else:
            a.client_status = ALLOC_CLIENT_FAILED
    res = reconcile(fn_ignore, the_job, None, allocs, job_id=jid)
    assert_results(res, stop=0)


def test_multi_tg():
    """TestReconciler_MultiTG:1194."""
    job = mock.job()
    tg2 = job.copy().task_groups[0]
    tg2.name = "foo"
    job.task_groups.append(tg2)
    allocs = make_allocs(job, 2)
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, place=18,
                   desired={"web": dict(place=8, ignore=2),
                            "foo": dict(place=10)})


def test_multi_tg_single_update_stanza():
    """TestReconciler_MultiTG_SingleUpdateStanza:1237 — a satisfied
    deployment for one group leaves both groups untouched."""
    job = mock.job()
    tg2 = job.copy().task_groups[0]
    tg2.name = "foo"
    job.task_groups.append(tg2)
    job.task_groups[0].update = NO_CANARY_UPDATE
    allocs = (make_allocs(job, 10, tg_name="web")
              + make_allocs(job, 10, tg_name="foo"))
    d = Deployment.from_job(job)
    d.task_groups["web"] = DeploymentState(desired_total=10)
    res = reconcile(fn_ignore, job, d, allocs)
    assert_results(res, desired={"web": dict(ignore=10),
                                 "foo": dict(ignore=10)})


# -- batch rerun / terminal handling ------------------------------------
def test_batch_rerun():
    """TestReconciler_Batch_Rerun:4341 — complete batch allocs are not
    replaced when the job is unchanged."""
    job = mock.batch_job()
    job.task_groups[0].count = 10
    tg = job.task_groups[0].name
    allocs = make_allocs(job, 10, tg_name=tg,
                         client_status=ALLOC_CLIENT_COMPLETE)
    res = reconcile(fn_ignore, job, None, allocs, batch=True)
    assert_results(res, place=0, desired={tg: dict(ignore=10)})


def test_service_client_status_complete():
    """TestReconciler_Service_ClientStatusComplete:1627 — a service
    alloc that completed is replaced (no reschedule flag)."""
    job = mock.job()
    job.task_groups[0].count = 5
    allocs = make_allocs(job, 5)
    allocs[4].client_status = ALLOC_CLIENT_COMPLETE
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, place=1,
                   desired={"web": dict(place=1, ignore=4)})
    assert not res.place[0].reschedule


def test_service_desired_stop_client_status_complete():
    """TestReconciler_Service_DesiredStop_ClientStatusComplete:1681 —
    an alloc already desired-stopped + complete is replaced without
    being stopped again."""
    job = mock.job()
    job.task_groups[0].count = 5
    allocs = make_allocs(job, 5)
    allocs[4].client_status = ALLOC_CLIENT_FAILED
    allocs[4].desired_status = ALLOC_DESIRED_STOP
    res = reconcile(fn_ignore, job, None, allocs)
    assert_results(res, place=1, stop=0,
                   desired={"web": dict(place=1, ignore=4)})


# -- reschedule windows (reconcile_test.go:1285-1979, 4341-4880) -------
def _fail_with_tracker(alloc, events, finished_ago_s, now):
    from nomad_tpu_torch.models.alloc import (RescheduleEvent, RescheduleTracker,
                                              TaskState)
    alloc.client_status = ALLOC_CLIENT_FAILED
    if events:
        alloc.reschedule_tracker = RescheduleTracker(events=[
            RescheduleEvent(reschedule_time=t, prev_alloc_id=p)
            for t, p in events])
    alloc.task_states = {alloc.task_group: TaskState(
        state="start", started_at=now - 3600.0,
        finished_at=now - finished_ago_s)}


def test_reschedule_later_batch():
    """TestReconciler_RescheduleLater_Batch:1285 — a failed batch alloc
    inside its delay window is annotated with a follow-up eval instead
    of being replaced."""
    import time as _t
    now = _t.time()
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 4
    tgn = tg.name
    from nomad_tpu_torch.models.job import ReschedulePolicy
    tg.reschedule_policy = ReschedulePolicy(
        attempts=3, interval_s=24 * 3600.0, delay_s=15.0,
        delay_function="constant", unlimited=False)
    allocs = make_allocs(job, 6, tg_name=tgn)
    allocs[0].client_status = ALLOC_CLIENT_FAILED
    allocs[0].next_allocation = allocs[1].id
    _fail_with_tracker(allocs[1], [(now - 3600, allocs[0].id)], 3600, now)
    allocs[1].next_allocation = allocs[2].id
    _fail_with_tracker(allocs[2], [(now - 7200, allocs[0].id),
                                   (now - 3600, allocs[1].id)], 0, now)
    allocs[5].client_status = ALLOC_CLIENT_COMPLETE
    res = reconcile(fn_ignore, job, None, allocs, batch=True, now=now)
    evals = res.desired_followup_evals.get(tgn)
    assert evals and len(evals) == 1
    assert abs(evals[0].wait_until - (now + 15.0)) < 1.0
    assert_results(res, place=0, stop=0,
                   desired={tgn: dict(ignore=4)})
    assert len(res.attribute_updates) == 1
    annotated = next(iter(res.attribute_updates.values()))
    assert annotated.follow_up_eval_id == evals[0].id


def test_reschedule_later_batched_evals():
    """TestReconciler_RescheduleLaterWithBatchedEvals_Batch:1378 —
    failures close in time share one follow-up eval; a 10s-later
    failure batch gets its own."""
    import time as _t
    now = _t.time()
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 10
    tgn = tg.name
    from nomad_tpu_torch.models.job import ReschedulePolicy
    tg.reschedule_policy = ReschedulePolicy(
        attempts=3, interval_s=24 * 3600.0, delay_s=15.0,
        delay_function="constant", unlimited=False)
    allocs = make_allocs(job, 10, tg_name=tgn)
    for i in range(5):
        _fail_with_tracker(allocs[i], [], -0.05 * i, now)
    for i in range(5, 7):
        _fail_with_tracker(allocs[i], [], -10.0, now)
    res = reconcile(fn_ignore, job, None, allocs, batch=True, now=now)
    evals = res.desired_followup_evals.get(tgn)
    assert evals and len(evals) == 2
    assert abs(evals[0].wait_until - (now + 15.0)) < 1.0
    assert abs(evals[1].wait_until - (now + 25.0)) < 1.0
    assert len(res.attribute_updates) == 7
    assert_results(res, desired={tgn: dict(ignore=10)})


def test_reschedule_now_batch():
    """TestReconciler_RescheduleNow_Batch:1464 — a failure past its
    delay is replaced immediately with reschedule set."""
    import time as _t
    now = _t.time()
    job = mock.batch_job()
    tg = job.task_groups[0]
    tg.count = 4
    tgn = tg.name
    from nomad_tpu_torch.models.job import ReschedulePolicy
    tg.reschedule_policy = ReschedulePolicy(
        attempts=3, interval_s=24 * 3600.0, delay_s=5.0,
        delay_function="constant", unlimited=False)
    allocs = make_allocs(job, 6, tg_name=tgn)
    allocs[0].client_status = ALLOC_CLIENT_FAILED
    allocs[0].next_allocation = allocs[1].id
    _fail_with_tracker(allocs[1], [(now - 3600, allocs[0].id)], 3600, now)
    allocs[1].next_allocation = allocs[2].id
    _fail_with_tracker(allocs[2], [(now - 7200, allocs[0].id),
                                   (now - 3600, allocs[1].id)], 5.0, now)
    allocs[2].follow_up_eval_id = generate_uuid()
    allocs[5].client_status = ALLOC_CLIENT_COMPLETE
    res = reconcile(fn_ignore, job, None, allocs, batch=True, now=now)
    assert not res.desired_followup_evals.get(tgn)
    assert_results(res, place=1, stop=1,
                   desired={tgn: dict(place=1, stop=1, ignore=3)})
    assert res.place[0].previous_alloc is not None
    assert res.place[0].reschedule


def test_dont_reschedule_previously_rescheduled():
    """TestReconciler_DontReschedule_PreviouslyRescheduled:2339 — a
    failed alloc whose replacement already exists (next_allocation) is
    not rescheduled again; one fresh placement fills count=5."""
    import time as _t
    now = _t.time()
    job = mock.job()
    job.task_groups[0].count = 5
    from nomad_tpu_torch.models.job import ReschedulePolicy
    job.task_groups[0].reschedule_policy = ReschedulePolicy(
        attempts=5, interval_s=24 * 3600.0, unlimited=False)
    allocs = make_allocs(job, 7)
    allocs[0].client_status = ALLOC_CLIENT_FAILED
    allocs[0].id = allocs[1].id
    _fail_with_tracker(allocs[1], [(now - 3600, generate_uuid())],
                       3600, now)
    allocs[1].next_allocation = allocs[2].id
    allocs[4].desired_status = ALLOC_DESIRED_STOP
    res = reconcile(fn_ignore, job, None, allocs, now=now)
    assert_results(res, place=1, stop=0,
                   desired={"web": dict(place=1, ignore=4)})
    assert _names_to_indexes(res.place) == [0]


def test_force_reschedule_service():
    """TestReconciler_ForceReschedule_Service:4648 — the operator's
    force-reschedule transition replaces a failed alloc even with
    attempts exhausted."""
    import time as _t
    now = _t.time()
    job = mock.job()
    job.task_groups[0].count = 5
    from nomad_tpu_torch.models.job import ReschedulePolicy
    job.task_groups[0].reschedule_policy = ReschedulePolicy(
        attempts=1, interval_s=24 * 3600.0, unlimited=False)
    allocs = make_allocs(job, 5)
    _fail_with_tracker(allocs[0], [(now - 3600, generate_uuid())],
                       3600, now)
    allocs[0].desired_transition.force_reschedule = True
    res = reconcile(fn_ignore, job, None, allocs, now=now)
    assert_results(res, place=1, stop=1,
                   desired={"web": dict(place=1, stop=1, ignore=4)})
    assert res.place[0].previous_alloc is allocs[0]
    assert res.place[0].reschedule


def test_reschedule_not_service():
    """TestReconciler_RescheduleNot_Service:4723 —
    ReschedulePolicy{attempts:0, unlimited:false}: failed allocs are
    ignored (not replaced); one placement substitutes the explicitly
    stopped alloc."""
    import time as _t
    now = _t.time()
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 5
    from nomad_tpu_torch.models.job import ReschedulePolicy
    tg.reschedule_policy = ReschedulePolicy(
        attempts=0, interval_s=24 * 3600.0, delay_s=5.0,
        max_delay_s=3600.0, unlimited=False)
    tg.update = NO_CANARY_UPDATE
    allocs = make_allocs(job, 5)
    _fail_with_tracker(allocs[0], [(now - 3600, generate_uuid())],
                       3600, now)
    _fail_with_tracker(allocs[1], [], 10.0, now)
    allocs[4].desired_status = ALLOC_DESIRED_STOP
    res = reconcile(fn_ignore, job, None, allocs, now=now)
    assert not res.desired_followup_evals.get("web")
    assert_results(res, place=1, stop=0,
                   desired={"web": dict(place=1, ignore=4)})
    assert all(p.previous_alloc is None for p in res.place)
    assert all(not p.reschedule for p in res.place)


# -- canaries (reconcile_test.go:3099-3646) ----------------------------
def test_new_canaries():
    """TestReconciler_NewCanaries:3179."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, place=2, create_deployment=True,
                   desired={"web": dict(canary=2, ignore=10)})
    assert res.deployment.task_groups["web"].desired_canaries == 2
    assert res.deployment.task_groups["web"].desired_total == 10
    assert _names_to_indexes(res.place) == [0, 1]
    assert all(p.canary for p in res.place)


def test_new_canaries_count_greater():
    """TestReconciler_NewCanaries_CountGreater:3225 — canary count above
    group count fills extra names."""
    job = mock.job()
    job.task_groups[0].count = 3
    update = UpdateStrategy(canary=7, max_parallel=2,
                            min_healthy_time_s=10.0,
                            healthy_deadline_s=600.0, stagger_s=31.0)
    job.task_groups[0].update = update
    res = reconcile(fn_destructive, job, None, make_allocs(job, 3))
    assert_results(res, place=7, create_deployment=True,
                   desired={"web": dict(canary=7, ignore=3)})
    assert res.deployment.task_groups["web"].desired_canaries == 7
    assert _names_to_indexes(res.place) == list(range(7))


def test_new_canaries_multi_tg():
    """TestReconciler_NewCanaries_MultiTG:3274."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    tg2 = job.copy().task_groups[0]
    job.task_groups.append(tg2)
    job.task_groups[0].name = "tg2"
    allocs = (make_allocs(job, 10, tg_name="tg2")
              + make_allocs(job, 10, tg_name="web"))
    res = reconcile(fn_destructive, job, None, allocs)
    assert_results(res, place=4, create_deployment=True,
                   desired={"tg2": dict(canary=2, ignore=10),
                            "web": dict(canary=2, ignore=10)})


def test_new_canaries_scale_up():
    """TestReconciler_NewCanaries_ScaleUp:3329 — canaries first, scale
    up only after promotion."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    job.task_groups[0].count = 15
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, place=2, create_deployment=True,
                   desired={"web": dict(canary=2, ignore=10)})
    assert res.deployment.task_groups["web"].desired_total == 15


def test_new_canaries_scale_down():
    """TestReconciler_NewCanaries_ScaleDown:3377 — scale-down stops
    extras immediately, canaries still placed."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    job.task_groups[0].count = 5
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, place=2, stop=5, create_deployment=True,
                   desired={"web": dict(canary=2, stop=5, ignore=5)})
    assert _names_to_indexes(res.place) == [0, 1]
    assert _stop_indexes(res) == list(range(5, 10))


def test_stop_old_canaries():
    """TestReconciler_StopOldCanaries:3099 — a newer job version cancels
    the old deployment, stops its canaries, and places fresh ones."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    d = Deployment.from_job(job)
    state = DeploymentState(promoted=False, desired_total=10,
                            desired_canaries=2, placed_allocs=2)
    d.task_groups["web"] = state
    job.version += 10
    allocs = make_allocs(job, 10)
    for i in range(2):
        canary = mock.alloc()
        canary.job = job
        canary.job_id = job.id
        canary.node_id = generate_uuid()
        canary.name = f"{job.id}.web[{i}]"
        canary.deployment_id = d.id
        state.placed_canaries.append(canary.id)
        allocs.append(canary)
    res = reconcile(fn_destructive, job, d, allocs)
    assert_results(res, place=2, stop=2, create_deployment=True,
                   n_deployment_updates=1,
                   desired={"web": dict(canary=2, stop=2, ignore=10)})
    assert res.deployment_updates[0].status == DEPLOYMENT_STATUS_CANCELLED


def test_promote_canaries_unblock():
    """TestReconciler_PromoteCanaries_Unblock:3494 — promoted canaries
    free max_parallel capacity and replace old versions."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    d = Deployment.from_job(job)
    state = DeploymentState(promoted=True, desired_total=10,
                            desired_canaries=2, placed_allocs=2)
    d.task_groups["web"] = state
    allocs = make_allocs(job, 10)
    handled = {}
    for i in range(2):
        canary = mock.alloc()
        canary.job = job
        canary.job_id = job.id
        canary.node_id = generate_uuid()
        canary.name = f"{job.id}.web[{i}]"
        canary.deployment_id = d.id
        canary.deployment_status = AllocDeploymentStatus(healthy=True)
        state.placed_canaries.append(canary.id)
        allocs.append(canary)
        handled[canary.id] = fn_ignore
    res = reconcile(fn_mock(handled, fn_destructive), job, d, allocs)
    assert_results(res, destructive=2, stop=2,
                   desired={"web": dict(stop=2, destructive_update=2,
                                        ignore=8)})
    canary_ids = set(state.placed_canaries)
    assert not any(s.alloc.id in canary_ids for s in res.stop), \
        "promoted canaries must not be stopped"


def test_promote_canaries_equal_count():
    """TestReconciler_PromoteCanaries_CanariesEqualCount:3566 — when
    canaries == count, promotion completes the deployment and stops the
    old versions."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    job.task_groups[0].count = 2
    d = Deployment.from_job(job)
    state = DeploymentState(promoted=True, desired_total=2,
                            desired_canaries=2, placed_allocs=2,
                            healthy_allocs=2)
    d.task_groups["web"] = state
    allocs = make_allocs(job, 2)
    handled = {}
    for i in range(2):
        canary = mock.alloc()
        canary.job = job
        canary.job_id = job.id
        canary.node_id = generate_uuid()
        canary.name = f"{job.id}.web[{i}]"
        canary.deployment_id = d.id
        canary.deployment_status = AllocDeploymentStatus(healthy=True)
        state.placed_canaries.append(canary.id)
        allocs.append(canary)
        handled[canary.id] = fn_ignore
    res = reconcile(fn_mock(handled, fn_destructive), job, d, allocs)
    assert_results(res, stop=2, n_deployment_updates=1,
                   desired={"web": dict(stop=2, ignore=2)})
    assert res.deployment_updates[0].status == DEPLOYMENT_STATUS_SUCCESSFUL


@pytest.mark.parametrize("healthy", [0, 1, 2, 3, 4])
def test_deployment_limit_health_accounting(healthy):
    """TestReconciler_DeploymentLimit_HealthAccounting:3647 — the
    rolling-update limit equals the number of HEALTHY placed allocs
    (max_parallel=4 minus unhealthy in-flight)."""
    job = mock.job()
    job.task_groups[0].update = NO_CANARY_UPDATE
    d = Deployment.from_job(job)
    d.task_groups["web"] = DeploymentState(promoted=True,
                                           desired_total=10,
                                           placed_allocs=4)
    allocs = make_allocs(job, 6, start=4)
    handled = {}
    for i in range(4):
        new = mock.alloc()
        new.job = job
        new.job_id = job.id
        new.node_id = generate_uuid()
        new.name = f"{job.id}.web[{i}]"
        new.deployment_id = d.id
        if i < healthy:
            new.deployment_status = AllocDeploymentStatus(healthy=True)
        allocs.append(new)
        handled[new.id] = fn_ignore
    res = reconcile(fn_mock(handled, fn_destructive), job, d, allocs)
    assert_results(res, destructive=healthy,
                   desired={"web": dict(destructive_update=healthy,
                                        ignore=10 - healthy)})


# -- paused / failed deployments (reconcile_test.go:2736-2952) ---------
@pytest.mark.parametrize("status,stop", [
    (DEPLOYMENT_STATUS_PAUSED, 0),
    (DEPLOYMENT_STATUS_FAILED, 1),   # failed deployments stop their
                                     # non-promoted canaries
])
def test_paused_or_failed_deployment_no_more_canaries(status, stop):
    """TestReconciler_PausedOrFailedDeployment_NoMoreCanaries:2736."""
    job = mock.job()
    job.task_groups[0].update = CANARY_UPDATE
    d = Deployment.from_job(job)
    d.status = status
    d.task_groups["web"] = DeploymentState(promoted=False,
                                           desired_canaries=2,
                                           desired_total=10,
                                           placed_allocs=1)
    allocs = make_allocs(job, 10)
    canary = mock.alloc()
    canary.job = job
    canary.job_id = job.id
    canary.node_id = generate_uuid()
    canary.name = f"{job.id}.web[0]"
    canary.deployment_id = d.id
    d.task_groups["web"].placed_canaries = [canary.id]
    allocs.append(canary)
    handled = {canary.id: fn_ignore}
    res = reconcile(fn_mock(handled, fn_destructive), job, d, allocs)
    assert_results(res, place=0, stop=stop, create_deployment=False,
                   desired={"web": dict(ignore=11 - stop, stop=stop)})


@pytest.mark.parametrize("status", [DEPLOYMENT_STATUS_PAUSED,
                                    DEPLOYMENT_STATUS_FAILED])
def test_paused_or_failed_deployment_no_more_placements(status):
    """TestReconciler_PausedOrFailedDeployment_NoMorePlacements:2816 —
    scale-up placements wait for the deployment to unpause."""
    job = mock.job()
    job.task_groups[0].update = NO_CANARY_UPDATE
    job.task_groups[0].count = 15
    d = Deployment.from_job(job)
    d.status = status
    d.task_groups["web"] = DeploymentState(promoted=False,
                                           desired_total=15,
                                           placed_allocs=10)
    allocs = make_allocs(job, 10)
    res = reconcile(fn_ignore, job, d, allocs)
    assert_results(res, place=0, desired={"web": dict(ignore=10)})


@pytest.mark.parametrize("status", [DEPLOYMENT_STATUS_PAUSED,
                                    DEPLOYMENT_STATUS_FAILED])
def test_paused_or_failed_deployment_no_more_destructive(status):
    """TestReconciler_PausedOrFailedDeployment_NoMoreDestructiveUpdates
    :2880."""
    job = mock.job()
    job.task_groups[0].update = NO_CANARY_UPDATE
    d = Deployment.from_job(job)
    d.status = status
    d.task_groups["web"] = DeploymentState(promoted=False,
                                           desired_total=10,
                                           placed_allocs=1)
    allocs = make_allocs(job, 9, start=1)
    newa = mock.alloc()
    newa.job = job
    newa.job_id = job.id
    newa.node_id = generate_uuid()
    newa.name = f"{job.id}.web[0]"
    newa.deployment_id = d.id
    allocs.append(newa)
    handled = {newa.id: fn_ignore}
    res = reconcile(fn_mock(handled, fn_destructive), job, d, allocs)
    assert_results(res, destructive=0, desired={"web": dict(ignore=10)})


# -- deployment creation (reconcile_test.go:2570-2735) -----------------
def test_create_deployment_rolling_upgrade_destructive():
    """TestReconciler_CreateDeployment_RollingUpgrade_Destructive:2570."""
    job = mock.job()
    job.task_groups[0].update = NO_CANARY_UPDATE
    res = reconcile(fn_destructive, job, None, make_allocs(job, 10))
    assert_results(res, destructive=4, create_deployment=True,
                   desired={"web": dict(destructive_update=4, ignore=6)})
    assert res.deployment.task_groups["web"].desired_total == 10


def test_create_deployment_rolling_upgrade_inplace():
    """TestReconciler_CreateDeployment_RollingUpgrade_Inplace:2611 —
    in-place updates of an OLDER job version still create the tracking
    deployment (allocs carry jobOld, job.Version++)."""
    job_old = mock.job()
    job = job_old.copy()
    job.id = job_old.id
    job.version = job_old.version + 1
    job.task_groups[0].update = NO_CANARY_UPDATE
    allocs = make_allocs(job_old, 10)
    for a in allocs:
        a.job_id = job.id
    res = reconcile(fn_inplace, job, None, allocs)
    assert_results(res, inplace=10, create_deployment=True,
                   desired={"web": dict(in_place_update=10)})
    assert res.deployment.task_groups["web"].desired_total == 10


def test_dont_create_deployment_no_changes():
    """TestReconciler_DontCreateDeployment_NoChanges:2699."""
    job = mock.job()
    job.task_groups[0].update = NO_CANARY_UPDATE
    res = reconcile(fn_ignore, job, None, make_allocs(job, 10))
    assert_results(res, create_deployment=False,
                   desired={"web": dict(ignore=10)})


def test_cancel_deployment_job_stop():
    """TestReconciler_CancelDeployment_JobStop:2397 (running-deployment
    case) — stopping the job cancels its active deployment."""
    job = mock.job()
    job.stop = True
    d = Deployment.from_job(job)
    d.task_groups["web"] = DeploymentState(desired_total=10)
    allocs = make_allocs(job, 10)
    res = reconcile(fn_ignore, job, d, allocs)
    assert_results(res, stop=10, n_deployment_updates=1,
                   desired={"web": dict(stop=10)})
    assert res.deployment_updates[0].status == DEPLOYMENT_STATUS_CANCELLED


def test_cancel_deployment_job_update_newer_version():
    """TestReconciler_CancelDeployment_JobUpdate:2494 — a deployment for
    an older job version is cancelled."""
    job = mock.job()
    job.version = 10
    d = Deployment.from_job(job)
    d.job_version = 5                 # older than the current job
    d.task_groups["web"] = DeploymentState(desired_total=10)
    allocs = make_allocs(job, 10)
    res = reconcile(fn_ignore, job, d, allocs)
    assert_results(res, n_deployment_updates=1,
                   desired={"web": dict(ignore=10)})
    assert res.deployment_updates[0].status == DEPLOYMENT_STATUS_CANCELLED
