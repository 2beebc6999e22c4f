"""The port's run of tests/test_system_golden.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Golden SystemScheduler scenarios ported from the reference test
suite — each test keeps its source's name and asserts the same plan
shape (scheduler/system_sched_test.go).
"""

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_LOST, ALLOC_DESIRED_STOP,
    EVAL_STATUS_COMPLETE, NODE_STATUS_DOWN,
    PreemptionConfig, SchedulerConfiguration,
    TRIGGER_JOB_REGISTER, TRIGGER_NODE_UPDATE,
)
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.scheduler import Harness

import test_torch_select  # noqa: F401  (torch's thread cap)


def _ev(job, trigger=TRIGGER_JOB_REGISTER, node_id=""):
    return Evaluation(namespace=job.namespace, priority=job.priority,
                      type=job.type, triggered_by=trigger,
                      job_id=job.id, node_id=node_id)


def _planned(plan):
    return [a for allocs in plan.node_allocation.values() for a in allocs]


def _stopped(plan):
    return [a for allocs in plan.node_update.values() for a in allocs]


def _sys_alloc(job, node, name="my-job.web[0]"):
    a = mock.alloc()
    # a COPY: the alloc carries the job as of placement time; sharing
    # the live object would alias later upsert_job index bumps into
    # the alloc and mask in-place-update detection
    a.job = job.copy()
    a.job_id = job.id
    a.node_id = node.id
    a.name = name
    a.task_group = "web"
    return a


def test_SystemSched_JobRegister():
    """system_sched_test.go:18 — 10 nodes, one plan, 10 placements,
    dc metrics, zero queued, eval complete."""
    h = Harness(device="cpu")
    for _ in range(10):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))

    assert len(h.plans) == 1
    planned = _planned(h.plans[0])
    assert len(planned) == 10
    out = h.store.allocs_by_job("default", job.id)
    assert len(out) == 10
    assert out[0].metrics.nodes_available.get("dc1") == 10
    assert h.evals[-1].queued_allocations.get("web", 0) == 0
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_ExhaustResources():
    """system_sched_test.go:237 — a service hog fills the node; the
    higher-priority system job preempts it: plan has exactly one
    placement (the system job) and one preemption (the service job),
    nothing queued."""
    h = Harness(device="cpu")
    h.store.set_scheduler_config(
        h.next_index(),
        SchedulerConfiguration(preemption_config=PreemptionConfig(
            system_scheduler_enabled=True)))
    h.store.upsert_node(h.next_index(), mock.node())

    svc = mock.job()
    svc.task_groups[0].count = 1
    svc.task_groups[0].tasks[0].resources.cpu = 3600
    h.store.upsert_job(h.next_index(), svc)
    h.process("service", _ev(svc))

    job = mock.system_job()     # priority 100 > svc's 50
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))

    plan = h.plans[1]
    assert len(plan.node_allocation) == 1
    assert len(plan.node_preemptions) == 1
    for allocs in plan.node_allocation.values():
        assert len(allocs) == 1
        assert allocs[0].job_id == job.id
    for victims in plan.node_preemptions.values():
        assert len(victims) == 1
        assert victims[0].job_id == svc.id
    assert h.evals[-1].queued_allocations.get("web", 0) == 0


def test_SystemSched_JobModify():
    """system_sched_test.go:533 — a destructive update evicts every
    live alloc (terminal ones ignored) and re-places on all 10 nodes."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    live = []
    for n in nodes:
        a = _sys_alloc(job, n)
        live.append(a)
        h.store.upsert_allocs(h.next_index(), [a])
    for n in nodes[:5]:          # terminal allocs must be ignored
        t = _sys_alloc(job, n)
        t.desired_status = ALLOC_DESIRED_STOP
        h.store.upsert_allocs(h.next_index(), [t])

    job2 = mock.system_job()
    job2.id = job.id
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    h.store.upsert_job(h.next_index(), job2)
    h.process("system", _ev(job2))

    assert len(h.plans) == 1
    plan = h.plans[0]
    assert len(_stopped(plan)) == len(live)
    assert len(_planned(plan)) == 10
    out = [a for a in h.store.allocs_by_job("default", job.id)
           if not a.terminal_status()]
    assert len(out) == 10
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_JobModify_InPlace():
    """system_sched_test.go:738 — a non-destructive update (same
    tasks) updates allocs in place: no evictions, 10 planned updates
    that KEEP their alloc ids."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    ids = set()
    for n in nodes:
        a = _sys_alloc(job, n)
        ids.add(a.id)
        h.store.upsert_allocs(h.next_index(), [a])

    job2 = mock.system_job()
    job2.id = job.id             # same tasks -> in-place
    h.store.upsert_job(h.next_index(), job2)
    h.process("system", _ev(job2))

    assert len(h.plans) == 1
    plan = h.plans[0]
    assert len(_stopped(plan)) == 0
    planned = _planned(plan)
    assert len(planned) == 10
    assert {a.id for a in planned} == ids


def test_SystemSched_NodeDown():
    """system_sched_test.go:983 — a down node's alloc is evicted:
    exactly one node_update entry, stopped or lost."""
    h = Harness(device="cpu")
    node = mock.node()
    node.status = NODE_STATUS_DOWN
    h.store.upsert_node(h.next_index(), node)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    a = _sys_alloc(job, node)
    h.store.upsert_allocs(h.next_index(), [a])

    h.process("system", _ev(job, TRIGGER_NODE_UPDATE, node.id))

    assert len(h.plans) == 1
    plan = h.plans[0]
    assert len(plan.node_update.get(node.id, [])) == 1
    stopped = _stopped(plan)
    assert len(stopped) == 1
    p = stopped[0]
    assert p.desired_status == ALLOC_DESIRED_STOP or \
        p.client_status == ALLOC_CLIENT_LOST
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_NodeDrain_Down():
    """system_sched_test.go:1050 — draining AND down: the alloc is
    evicted exactly once (the drain must not double-count the down)."""
    h = Harness(device="cpu")
    node = mock.node()
    node.drain = True
    node.status = NODE_STATUS_DOWN
    h.store.upsert_node(h.next_index(), node)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    a = _sys_alloc(job, node)
    h.store.upsert_allocs(h.next_index(), [a])

    h.process("system", _ev(job, TRIGGER_NODE_UPDATE, node.id))

    assert len(h.plans) == 1
    updates = h.plans[0].node_update.get(node.id, [])
    assert [x.id for x in updates] == [a.id]
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_NodeDrain():
    """system_sched_test.go:1112 — a draining (but up) node's alloc is
    migrated away: one eviction, eval complete."""
    h = Harness(device="cpu")
    node = mock.node()
    node.drain = True
    h.store.upsert_node(h.next_index(), node)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    a = _sys_alloc(job, node)
    h.store.upsert_allocs(h.next_index(), [a])

    h.process("system", _ev(job, TRIGGER_NODE_UPDATE, node.id))

    assert len(h.plans) == 1
    assert len(_stopped(h.plans[0])) == 1
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_Queued_With_Constraints():
    """system_sched_test.go:1276 — an infeasible node (darwin) must
    not report queued allocations."""
    h = Harness(device="cpu")
    node = mock.node()
    node.attributes["kernel.name"] = "darwin"
    node.compute_class()
    h.store.upsert_node(h.next_index(), node)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)

    h.process("system", _ev(job, TRIGGER_NODE_UPDATE, node.id))
    assert h.evals[-1].queued_allocations.get("web", 0) == 0


def test_SystemSched_JobDeregister_Purged():
    """system_sched_test.go:837 — purging the job evicts every alloc
    on every node."""
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(4)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    allocs = []
    for n in nodes:
        a = _sys_alloc(job, n)
        allocs.append(a)
        h.store.upsert_allocs(h.next_index(), [a])
    h.store.delete_job(h.next_index(), "default", job.id)

    h.process("system", _ev(job))

    assert len(h.plans) == 1
    stopped = _stopped(h.plans[0])
    assert {a.id for a in stopped} == {a.id for a in allocs}
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_SystemSched_ExistingAllocNoNodes():
    """system_sched_test.go:1464 — the job's only node is gone; the
    existing alloc is stopped and the eval still completes."""
    h = Harness(device="cpu")
    node = mock.node()
    h.store.upsert_node(h.next_index(), node)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    assert len(h.store.allocs_by_job("default", job.id)) == 1

    # node disappears; re-evaluate the job
    h.store.delete_node(h.next_index(), [node.id])
    h.process("system", _ev(job, TRIGGER_NODE_UPDATE, node.id))
    live = [a for a in h.store.allocs_by_job("default", job.id)
            if not a.terminal_status() and
            a.desired_status != ALLOC_DESIRED_STOP]
    assert live == []
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE
