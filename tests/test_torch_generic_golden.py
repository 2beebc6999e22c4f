"""The port's run of tests/test_generic_golden.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Golden GenericScheduler scenarios ported from
scheduler/generic_sched_test.go. Each test names its reference function
(TestServiceSched_*) and asserts the same plan shape, blocked-eval
spawning, failed-TG metrics, and state outcomes through the Harness.
"""

import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING,
    ALLOC_DESIRED_STOP, Constraint, EVAL_STATUS_BLOCKED,
    EVAL_STATUS_COMPLETE, TRIGGER_JOB_REGISTER, TRIGGER_NODE_UPDATE,
)
from nomad_tpu_torch.models.constraints import CONSTRAINT_DISTINCT_HOSTS
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.utils.ids import generate_uuid

import test_torch_select  # noqa: F401  (torch's thread cap)


def ev_for(job, trigger=TRIGGER_JOB_REGISTER):
    return Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        type=job.type, triggered_by=trigger, job_id=job.id,
        status="pending")


def planned_allocs(plan):
    return [a for allocs in plan.node_allocation.values() for a in allocs]


def test_job_register():
    """TestServiceSched_JobRegister:20 — 10 nodes, count 10: one plan,
    all placed, distinct dynamic ports per node, eval complete."""
    h = Harness(device="cpu")
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    assert len(h.plans) == 1
    assert len(h.create_evals) == 0
    assert len(planned_allocs(h.plans[0])) == 10
    out = h.store.allocs_by_job(job.namespace, job.id)
    assert len(out) == 10
    # no port collisions per node
    used = {}
    for a in out:
        for tr in a.allocated_resources.tasks.values():
            for nw in tr.networks:
                for p in nw.dynamic_ports:
                    key = (a.node_id, p.value)
                    assert key not in used, f"port collision {key}"
                    used[key] = True
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_register_distinct_hosts():
    """TestServiceSched_JobRegister_DistinctHosts:276 — count 11 over 10
    nodes with distinct_hosts: 10 place on distinct nodes, 1 fails and
    spawns a blocked eval."""
    h = Harness(device="cpu")
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 11
    job.constraints.append(Constraint(operand=CONSTRAINT_DISTINCT_HOSTS))
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    assert len(h.plans) == 1
    assert len(h.create_evals) == 1
    assert len(h.evals[-1].failed_tg_allocs) == 1
    out = h.store.allocs_by_job(job.namespace, job.id)
    assert len(out) == 10
    assert len({a.node_id for a in out}) == 10, "node collision"
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_register_count_zero():
    """TestServiceSched_JobRegister_CountZero:862 — nothing planned."""
    h = Harness(device="cpu")
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 0
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    assert h.plans == []
    assert h.store.allocs_by_job(job.namespace, job.id) == []
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_register_create_blocked_eval():
    """TestServiceSched_JobRegister_CreateBlockedEval:985 — no nodes:
    no plan, one blocked eval carrying per-TG metrics."""
    h = Harness(device="cpu")
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    assert h.plans == []
    assert len(h.create_evals) == 1
    blocked = h.create_evals[0]
    assert blocked.status == EVAL_STATUS_BLOCKED
    metrics = h.evals[-1].failed_tg_allocs.get("web")
    assert metrics is not None
    assert metrics.nodes_evaluated == 0
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_register_feasible_and_infeasible_tg():
    """TestServiceSched_JobRegister_FeasibleAndInfeasibleTG:1083 — one
    group places, the impossible one reports failed allocs."""
    h = Harness(device="cpu")
    for _ in range(2):
        node = mock.node()
        node.node_class = "class_0"
        node.compute_class()
        h.store.upsert_node(h.next_index(), node)
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].constraints = [
        Constraint(ltarget="${node.class}", rtarget="class_0",
                   operand="=")]
    tg2 = job.copy().task_groups[0]
    tg2.name = "web2"
    tg2.count = 2
    tg2.constraints = [Constraint(ltarget="${node.class}",
                                  rtarget="class_1", operand="=")]
    job.task_groups.append(tg2)
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    assert len(h.plans) == 1
    assert len(planned_allocs(h.plans[0])) == 2
    assert set(h.evals[-1].failed_tg_allocs.keys()) == {"web2"}
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_evaluate_blocked_eval_finished():
    """TestServiceSched_EvaluateBlockedEval_Finished:1327 — a blocked
    eval re-runs once capacity exists, places, and is untracked."""
    h = Harness(device="cpu")
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    ev = ev_for(job)
    ev.status = EVAL_STATUS_BLOCKED
    h.process("service", ev)
    assert len(h.plans) == 1
    assert len(planned_allocs(h.plans[0])) == 10
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_job_modify_destructive():
    """TestServiceSched_JobModify:1411 — a changed task spec stops the
    old 10 and places 10 new."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(10):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = nodes[i].id
        a.name = f"{job.id}.web[{i}]"
        a.client_status = ALLOC_CLIENT_RUNNING
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)

    job2 = job.copy()
    job2.id = job.id
    job2.version = job.version + 1
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", ev_for(job2))
    assert len(h.plans) == 1
    plan = h.plans[0]
    stopped = [a for allocs in plan.node_update.values() for a in allocs]
    assert len(stopped) == 10
    assert len(planned_allocs(plan)) == 10
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_modify_count_zero():
    """TestServiceSched_JobModify_CountZero:1608 — scaling to zero
    stops everything and places nothing."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(10):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = nodes[i].id
        a.name = f"{job.id}.web[{i}]"
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    job2 = job.copy()
    job2.id = job.id
    job2.version = job.version + 1
    job2.task_groups[0].count = 0
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", ev_for(job2))
    plan = h.plans[0]
    stopped = [a for allocs in plan.node_update.values() for a in allocs]
    assert len(stopped) == 10
    assert len(planned_allocs(plan)) == 0
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_job_modify_in_place():
    """TestServiceSched_JobModify_InPlace:2058 — a non-destructive
    change (e.g. +meta) updates in place: no stops, allocs keep their
    nodes."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(10):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = nodes[i].id
        a.name = f"{job.id}.web[{i}]"
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    job2 = job.copy()
    job2.id = job.id
    job2.version = job.version + 1
    job2.meta = {**job.meta, "foo": "bar"}
    h.store.upsert_job(h.next_index(), job2)
    h.process("service", ev_for(job2))
    plan = h.plans[0]
    stopped = [a for allocs in plan.node_update.values() for a in allocs]
    assert len(stopped) == 0
    placed = planned_allocs(plan)
    assert len(placed) == 10
    before = {a.id: a.node_id for a in allocs}
    for a in placed:
        assert before.get(a.id) == a.node_id, "in-place moved nodes"
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_node_drain():
    """TestServiceSched_NodeDrain:2987 — all allocs on a draining node
    migrate to other nodes."""
    h = Harness(device="cpu")
    drained = mock.node()
    drained.drain = True
    drained.canonicalize()
    h.store.upsert_node(h.next_index(), drained)
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(10):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = drained.id
        a.name = f"{job.id}.web[{i}]"
        a.desired_transition.migrate = True
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    h.process("service", ev_for(job, TRIGGER_NODE_UPDATE))
    plan = h.plans[0]
    stopped = [a for allocs in plan.node_update.values() for a in allocs]
    assert len(stopped) == 10
    placed = planned_allocs(plan)
    assert len(placed) == 10
    assert all(a.node_id != drained.id for a in placed)
    h.assert_eval_status(None, EVAL_STATUS_COMPLETE)


def test_node_drain_queued_allocations():
    """TestServiceSched_NodeDrain_Queued_Allocations:3182 — draining
    the only node leaves the migrations queued as failed TG allocs."""
    h = Harness(device="cpu")
    node = mock.node()
    h.store.upsert_node(h.next_index(), node)
    job = mock.job()
    job.task_groups[0].count = 2
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(2):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = node.id
        a.name = f"{job.id}.web[{i}]"
        a.desired_transition.migrate = True
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    drained = h.store.node_by_id(node.id)
    drained.drain = True
    drained.canonicalize()
    h.store.upsert_node(h.next_index(), drained)
    h.process("service", ev_for(job, TRIGGER_NODE_UPDATE))
    # both migrations fail placement: they surface as failed TG allocs
    assert h.evals[-1].failed_tg_allocs.get("web") is not None


def test_retry_limit():
    """TestServiceSched_RetryLimit:3233 — a planner that rejects every
    plan forces the scheduler to give up after its retry budget and
    mark the eval failed."""
    h = Harness(device="cpu")

    class RejectPlanner:
        def submit_plan(self, plan):
            from nomad_tpu_torch.models import PlanResult
            # full rejection: nothing committed, snapshot refreshed
            return PlanResult(refresh_index=h.store.latest_index())

        def update_eval(self, ev):
            h.evals.append(ev)

        def create_eval(self, ev):
            h.create_evals.append(ev)

        def reblock_eval(self, ev):
            h.reblock_evals.append(ev)

    h.planner = RejectPlanner()
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    h.process("service", ev_for(job))
    # no allocs landed and the eval did not complete successfully
    assert h.store.allocs_by_job(job.namespace, job.id) == []
    assert h.evals[-1].status != EVAL_STATUS_COMPLETE


def test_stop_after_client_disconnect_lost_replacement():
    """TestServiceSched_NodeDown:2655 (lost branch) — allocs on a down
    node are marked lost and replaced."""
    h = Harness(device="cpu")
    down = mock.node()
    h.store.upsert_node(h.next_index(), down)
    live = [mock.node() for _ in range(10)]
    for n in live:
        h.store.upsert_node(h.next_index(), n)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(10):
        a = mock.alloc()
        a.job = job
        a.job_id = job.id
        a.node_id = down.id
        a.name = f"{job.id}.web[{i}]"
        a.client_status = ALLOC_CLIENT_RUNNING
        allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    h.store.update_node_status(h.next_index(), down.id, "down",
                               int(time.time()))
    h.process("service", ev_for(job, TRIGGER_NODE_UPDATE))
    plan = h.plans[0]
    stopped = [a for allocs in plan.node_update.values() for a in allocs]
    assert len(stopped) == 10
    assert all(a.client_status == "lost" for a in stopped)
    placed = planned_allocs(plan)
    assert len(placed) == 10
    assert all(a.node_id != down.id for a in placed)
