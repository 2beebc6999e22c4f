"""The port's run of tests/test_system_sched.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

SystemScheduler tests (reference: scheduler/system_sched_test.go)."""

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    Constraint, EVAL_STATUS_COMPLETE, NODE_STATUS_DOWN,
    TRIGGER_JOB_REGISTER, TRIGGER_NODE_UPDATE,
)
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.scheduler import Harness

import test_torch_select  # noqa: F401  (torch's thread cap)


def _ev(job, trigger=TRIGGER_JOB_REGISTER):
    return Evaluation(namespace=job.namespace, priority=job.priority,
                      type=job.type, triggered_by=trigger, job_id=job.id)


def test_system_job_placed_on_all_nodes():
    h = Harness(device="cpu")
    nodes = [mock.node() for _ in range(5)]
    for n in nodes:
        h.store.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert len(allocs) == 5
    assert {a.node_id for a in allocs} == {n.id for n in nodes}
    assert h.evals[-1].status == EVAL_STATUS_COMPLETE


def test_system_job_respects_constraints():
    h = Harness(device="cpu")
    good, bad = mock.node(), mock.node()
    bad.attributes["kernel.name"] = "darwin"
    bad.compute_class()
    h.store.upsert_node(h.next_index(), good)
    h.store.upsert_node(h.next_index(), bad)
    job = mock.system_job()   # constraint kernel.name = linux
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    allocs = h.store.allocs_by_job("default", job.id)
    assert len(allocs) == 1
    assert allocs[0].node_id == good.id


def test_system_new_node_gets_alloc():
    h = Harness(device="cpu")
    n1 = mock.node()
    h.store.upsert_node(h.next_index(), n1)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    assert len(h.store.allocs_by_job("default", job.id)) == 1

    n2 = mock.node()
    h.store.upsert_node(h.next_index(), n2)
    h.process("system", _ev(job, TRIGGER_NODE_UPDATE))
    allocs = [a for a in h.store.allocs_by_job("default", job.id)
              if not a.terminal_status()]
    assert len(allocs) == 2
    assert {a.node_id for a in allocs} == {n1.id, n2.id}


def test_system_node_down_marks_lost():
    h = Harness(device="cpu")
    n1, n2 = mock.node(), mock.node()
    h.store.upsert_node(h.next_index(), n1)
    h.store.upsert_node(h.next_index(), n2)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    assert len(h.store.allocs_by_job("default", job.id)) == 2

    h.store.update_node_status(h.next_index(), n1.id, NODE_STATUS_DOWN)
    h.process("system", _ev(job, TRIGGER_NODE_UPDATE))
    allocs = h.store.allocs_by_job("default", job.id)
    live = [a for a in allocs if not a.terminal_status()]
    assert len(live) == 1
    assert live[0].node_id == n2.id


def test_system_job_deregister():
    h = Harness(device="cpu")
    for _ in range(3):
        h.store.upsert_node(h.next_index(), mock.node())
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    job2 = h.store.job_by_id("default", job.id).copy()
    job2.stop = True
    h.store.upsert_job(h.next_index(), job2)
    h.process("system", _ev(job2))
    live = [a for a in h.store.allocs_by_job("default", job.id)
            if not a.terminal_status()]
    assert live == []


def test_system_exhausted_node_reports_failed_tg():
    h = Harness(device="cpu")
    n = mock.node()
    # node too small for the system job's 500MHz ask
    n.node_resources.cpu.cpu_shares = 300
    h.store.upsert_node(h.next_index(), n)
    job = mock.system_job()
    h.store.upsert_job(h.next_index(), job)
    h.process("system", _ev(job))
    assert h.store.allocs_by_job("default", job.id) == []
    failed = h.evals[-1].failed_tg_allocs
    assert "web" in failed
    assert failed["web"].nodes_exhausted == 1
