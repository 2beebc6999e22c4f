"""The port's run of tests/test_state_store.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

State store tests (reference patterns: nomad/state/state_store_test.go)."""

import threading
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING, ALLOC_DESIRED_STOP,
    NODE_SCHED_INELIGIBLE, NODE_STATUS_DOWN,
    Allocation, SchedulerConfiguration,
)
from nomad_tpu_torch.models.node import DrainStrategy
from nomad_tpu_torch.state import StateStore


def test_upsert_node_and_snapshot_isolation():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1000, n)
    snap = s.snapshot()
    assert snap.node_by_id(n.id).name == "foobar"
    # later write doesn't leak into the old snapshot
    s.update_node_status(1001, n.id, NODE_STATUS_DOWN)
    assert snap.node_by_id(n.id).status == "ready"
    assert s.node_by_id(n.id).status == "down"
    assert s.index("nodes") == 1001


def test_node_reregistration_preserves_operator_fields():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    s.update_node_eligibility(2, n.id, NODE_SCHED_INELIGIBLE)
    n2 = n.copy()
    s.upsert_node(3, n2)
    assert s.node_by_id(n.id).scheduling_eligibility == NODE_SCHED_INELIGIBLE
    assert s.node_by_id(n.id).create_index == 1


def test_upsert_job_version_bump():
    s = StateStore()
    j = mock.job()
    s.upsert_job(10, j)
    assert s.job_by_id("default", j.id).version == 0
    j2 = j.copy()
    j2.task_groups[0].count = 20
    s.upsert_job(11, j2)
    got = s.job_by_id("default", j.id)
    assert got.version == 1
    assert got.create_index == 10
    versions = s.job_versions("default", j.id)
    assert [v.version for v in versions] == [1, 0]
    # unchanged spec does not bump version
    j3 = j2.copy()
    s.upsert_job(12, j3)
    assert s.job_by_id("default", j.id).version == 1


def test_allocs_indexes():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    j = mock.job()
    s.upsert_job(2, j)
    allocs = []
    for i in range(3):
        a = mock.alloc()
        a.job_id = j.id
        a.job = j
        a.node_id = n.id
        a.name = f"{j.id}.web[{i}]"
        allocs.append(a)
    s.upsert_allocs(3, allocs)
    assert len(s.allocs_by_node(n.id)) == 3
    assert len(s.allocs_by_job("default", j.id)) == 3
    assert s.alloc_by_id(allocs[0].id).create_index == 3
    # stop one via stub update (plan path)
    stub = Allocation(id=allocs[0].id, desired_status=ALLOC_DESIRED_STOP,
                      desired_description="test")
    s.upsert_allocs(4, [stub])
    got = s.alloc_by_id(allocs[0].id)
    assert got.desired_status == ALLOC_DESIRED_STOP
    assert got.job is not None            # inherited from existing
    assert got.node_id == n.id
    assert len(s.allocs_by_node_terminal(n.id, False)) == 2


def test_bulk_load_allocs_matches_upsert_semantics():
    """bulk_load_allocs (the C2M replay seed) must leave the store in
    the same observable state as repeated upsert_allocs: tables,
    secondary indexes, job summaries, retrievability — plus a changelog
    floor bump that forces resident tables to rebuild."""
    from nomad_tpu_torch.models import ALLOC_CLIENT_RUNNING

    def seed(store, loader):
        nodes = [mock.node() for _ in range(4)]
        for i, n in enumerate(nodes):
            s_idx = store.latest_index() + 1
            store.upsert_node(s_idx, n)
        j = mock.job()
        j.id = "bulk-job"
        store.upsert_job(store.latest_index() + 1, j)
        allocs = []
        for i in range(40):
            a = mock.alloc()
            a.job_id = j.id
            a.job = j
            a.node_id = nodes[i % 4].id
            a.name = f"{j.id}.web[{i}]"
            a.client_status = ALLOC_CLIENT_RUNNING
            allocs.append(a)
        loader(store, store.latest_index() + 1, allocs)
        return j, nodes, allocs

    ref = StateStore()
    j1, nodes1, _ = seed(ref, lambda s, i, al: s.upsert_allocs(i, al))
    bulk = StateStore()
    j2, nodes2, allocs2 = seed(bulk, lambda s, i, al: s.bulk_load_allocs(i, al))

    assert len(bulk.allocs_by_job("default", j2.id)) == \
        len(ref.allocs_by_job("default", j1.id)) == 40
    for n in nodes2:
        assert len(bulk.allocs_by_node(n.id)) == 10
    a = allocs2[7]
    got = bulk.alloc_by_id(a.id)
    assert got is not None and got.modify_index == got.create_index
    # summaries aggregated identically
    s_ref = ref.job_summary("default", j1.id).summary["web"]
    s_bulk = bulk.job_summary("default", j2.id).summary["web"]
    assert s_bulk == s_ref == {"running": 40}
    # delta path invalidated: a reader from before the bulk load must
    # be told to rebuild (changes_since -> None)
    assert bulk.changes_since(0, bulk.latest_index()) is None
    # eval index present
    assert len(bulk.allocs_by_eval(allocs2[0].eval_id)) >= 1


def test_update_allocs_from_client_and_summary():
    s = StateStore()
    j = mock.job()
    s.upsert_job(1, j)
    a = mock.alloc()
    a.job_id = j.id
    s.upsert_allocs(2, [a])
    summ = s.job_summary("default", j.id)
    assert summ.summary["web"].get("starting") == 1
    upd = Allocation(id=a.id, client_status=ALLOC_CLIENT_RUNNING)
    s.update_allocs_from_client(3, [upd])
    assert s.alloc_by_id(a.id).client_status == ALLOC_CLIENT_RUNNING
    summ = s.job_summary("default", j.id)
    assert summ.summary["web"].get("starting", 0) == 0
    assert summ.summary["web"].get("running") == 1


def test_evals_by_job_and_delete():
    s = StateStore()
    e = mock.evaluation()
    s.upsert_evals(5, [e])
    assert s.eval_by_id(e.id) is not None
    assert len(s.evals_by_job("default", e.job_id)) == 1
    s.delete_evals(6, [e.id])
    assert s.eval_by_id(e.id) is None
    assert s.evals_by_job("default", e.job_id) == []


def test_plan_results_atomic():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    j = mock.job()
    s.upsert_job(2, j)
    placed = mock.alloc()
    placed.node_id = n.id
    placed.job_id = j.id
    s.upsert_plan_results(10, allocs_stopped=[], allocs_placed=[placed],
                          allocs_preempted=[])
    assert s.alloc_by_id(placed.id).modify_index == 10
    assert s.index("allocs") == 10


def test_scheduler_config():
    s = StateStore()
    assert s.scheduler_config().scheduler_algorithm == "binpack"
    cfg = SchedulerConfiguration(scheduler_algorithm="spread")
    s.set_scheduler_config(7, cfg)
    assert s.scheduler_config().scheduler_algorithm == "spread"


def test_snapshot_min_index_blocks_until_write():
    s = StateStore()
    n = mock.node()
    s.upsert_node(1, n)
    results = {}

    def waiter():
        snap = s.snapshot_min_index(5, timeout_s=2.0)
        results["index"] = snap.latest_index()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    s.upsert_node(5, mock.node())
    t.join(timeout=2)
    assert results["index"] == 5


def test_snapshot_min_index_timeout():
    s = StateStore()
    with pytest.raises(TimeoutError):
        s.snapshot_min_index(99, timeout_s=0.05)


def test_deployment_lifecycle():
    s = StateStore()
    j = mock.job()
    s.upsert_job(1, j)
    d = mock.deployment()
    d.job_id = j.id
    s.upsert_deployment(2, d)
    assert s.deployment_by_id(d.id).status == "running"
    assert s.latest_deployment_by_job("default", j.id).id == d.id
    from nomad_tpu_torch.models.deployment import DeploymentStatusUpdate
    s.update_deployment_status(3, DeploymentStatusUpdate(
        deployment_id=d.id, status="successful", status_description="done"))
    assert s.deployment_by_id(d.id).status == "successful"
