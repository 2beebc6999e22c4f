"""The reference's drain suite (tests/test_drain.py) against the port's
the drainer and the Client's migrations, servers on the CPU (device="cpu"), assertions unchanged.

The reference's docstring:

Node drain: staged migration, system-job ordering, completion.

Reference scenarios: nomad/drainer/drainer_int_test.go
(TestDrainer_Simple, TestDrainer_DrainEmptyNode, ignore-system flows)
and client-side migrate handling.
"""

import time

import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

from nomad_tpu_torch.server import Server as _Server
from nomad_tpu_torch import mock
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.models import ALLOC_CLIENT_RUNNING
from nomad_tpu_torch.models.node import DrainSpec, DrainStrategy
from nomad_tpu_torch.server import ServerConfig


def Server(config=None, **kw):
    # the port's Server on the CPU: the kernels' plain versions
    return _Server(config, device="cpu", **kw)


def _wait_for(pred, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


@pytest.fixture
def cluster2():
    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0))
    server.start()
    clients = [Client(server, ClientConfig(node_name=f"drain-{i}"))
               for i in range(2)]
    for c in clients:
        c.start()
    yield server, clients
    for c in clients:
        c.shutdown()
    server.shutdown()


def _service_job(count=3, max_parallel=2):
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": "120s"}
    tg.migrate.max_parallel = max_parallel
    job.constraints = []
    job.canonicalize()
    return job


def _live_allocs(server, node_id):
    return [a for a in server.store.allocs_by_node(node_id)
            if not a.client_terminal_status()]


def test_drain_migrates_all_allocs_and_completes(cluster2):
    server, clients = cluster2
    job = _service_job(count=3, max_parallel=2)
    server.register_job(job)
    assert _wait_for(lambda: sum(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_job(job.namespace, job.id)) == 3)

    # drain whichever node holds allocations
    nodes = server.store.nodes()
    target = max(nodes, key=lambda n: len(_live_allocs(server, n.id)))
    other = [n for n in nodes if n.id != target.id][0]
    server.update_node_drain(target.id, DrainStrategy(
        drain_spec=DrainSpec(deadline_s=60.0)))

    # every replacement lands on the other node and runs
    assert _wait_for(lambda: sum(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_node(other.id)) == 3, timeout=30.0)
    assert _wait_for(lambda: not _live_allocs(server, target.id))
    # drain marked complete: strategy cleared, node stays ineligible
    assert _wait_for(lambda: server.store.node_by_id(
        target.id).drain_strategy is None)
    drained = server.store.node_by_id(target.id)
    assert drained.drain is False
    assert drained.scheduling_eligibility == "ineligible"


def test_drain_ignores_system_jobs_when_asked(cluster2):
    server, clients = cluster2
    sysjob = mock.system_job()
    sysjob.task_groups[0].tasks[0].driver = "mock_driver"
    sysjob.task_groups[0].tasks[0].config = {"run_for": "120s"}
    sysjob.constraints = []
    sysjob.canonicalize()
    server.register_job(sysjob)
    job = _service_job(count=2)
    server.register_job(job)

    assert _wait_for(lambda: sum(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_job(job.namespace, job.id)) == 2)
    assert _wait_for(lambda: sum(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_job(sysjob.namespace, sysjob.id)) == 2)

    nodes = server.store.nodes()
    target = max(nodes, key=lambda n: len(
        [a for a in _live_allocs(server, n.id) if a.job_id == job.id]))
    server.update_node_drain(target.id, DrainStrategy(
        drain_spec=DrainSpec(deadline_s=60.0, ignore_system_jobs=True)))

    assert _wait_for(lambda: server.store.node_by_id(
        target.id).drain_strategy is None, timeout=30.0)
    # the system alloc is still running on the drained node
    sys_allocs = [a for a in _live_allocs(server, target.id)
                  if a.job_id == sysjob.id]
    assert len(sys_allocs) == 1
    assert sys_allocs[0].client_status == ALLOC_CLIENT_RUNNING
    # the service allocs are gone
    assert not [a for a in _live_allocs(server, target.id)
                if a.job_id == job.id]


def test_drain_stops_system_jobs_last(cluster2):
    server, clients = cluster2
    sysjob = mock.system_job()
    sysjob.task_groups[0].tasks[0].driver = "mock_driver"
    sysjob.task_groups[0].tasks[0].config = {"run_for": "120s"}
    sysjob.constraints = []
    sysjob.canonicalize()
    server.register_job(sysjob)
    assert _wait_for(lambda: sum(
        a.client_status == ALLOC_CLIENT_RUNNING
        for a in server.store.allocs_by_job(sysjob.namespace, sysjob.id)) == 2)

    target = server.store.nodes()[0]
    server.update_node_drain(target.id, DrainStrategy(
        drain_spec=DrainSpec(deadline_s=60.0)))

    assert _wait_for(lambda: server.store.node_by_id(
        target.id).drain_strategy is None, timeout=30.0)
    assert _wait_for(lambda: not _live_allocs(server, target.id))


def test_store_desired_transitions():
    from nomad_tpu_torch.models.alloc import DesiredTransition
    from nomad_tpu_torch.state import StateStore
    store = StateStore()
    a = mock.alloc()
    store.upsert_allocs(10, [a])
    store.update_alloc_desired_transitions(
        11, [a.id, "missing-id"], DesiredTransition(migrate=True))
    got = store.alloc_by_id(a.id)
    assert got.desired_transition.should_migrate()
    assert got.modify_index == 11


def test_transition_payload_survives_wal_roundtrip():
    from nomad_tpu_torch.models.alloc import DesiredTransition
    from nomad_tpu_torch.server.persistence import decode_payload, encode_payload
    wire = encode_payload("alloc_desired_transition",
                          dict(alloc_ids=["a1"],
                               transition=DesiredTransition(migrate=True),
                               evals=[]))
    back = decode_payload("alloc_desired_transition", wire)
    assert isinstance(back["transition"], DesiredTransition)
    assert back["transition"].should_migrate()
