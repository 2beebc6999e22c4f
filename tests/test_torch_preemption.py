"""The port's run of tests/test_preemption.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Preemption tests (reference: scheduler/preemption_test.go patterns)."""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (ComparableResources, SchedulerConfiguration,
                                    ALLOC_DESIRED_EVICT)
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.models.scheduler_config import PreemptionConfig
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.scheduler.preemption import (
    Preemptor, basic_resource_distance, preemption_score, net_priority)

import test_torch_select  # noqa: F401  (torch's thread cap)


def _mk_alloc(job, node_id, cpu, mem, tg="web"):
    a = mock.alloc()
    a.job = job
    a.job_id = job.id
    a.node_id = node_id
    a.task_group = tg
    a.allocated_resources.tasks["web"].cpu.cpu_shares = cpu
    a.allocated_resources.tasks["web"].memory.memory_mb = mem
    a.allocated_resources.tasks["web"].networks = []
    return a


def test_resource_distance():
    ask = ComparableResources(cpu_shares=1000, memory_mb=1000, disk_mb=0)
    exact = ComparableResources(cpu_shares=1000, memory_mb=1000)
    assert basic_resource_distance(ask, exact) == pytest.approx(0.0)
    half = ComparableResources(cpu_shares=500, memory_mb=500)
    assert basic_resource_distance(ask, half) == pytest.approx(0.7071, abs=1e-3)


def test_preemption_score_logistic():
    assert preemption_score(2048.0) == pytest.approx(0.5)
    assert preemption_score(0.0) > 0.99
    assert preemption_score(10000.0) < 0.01


def test_preemptor_picks_lowest_priority_closest():
    node = mock.node()   # 3900 cpu avail
    lo = mock.job()
    lo.priority = 20
    hi = mock.job()
    hi.priority = 40
    placing = mock.job()
    placing.priority = 70
    a1 = _mk_alloc(lo, node.id, 1000, 2000)    # low prio, close to ask
    a2 = _mk_alloc(lo, node.id, 2800, 5800)    # low prio, big
    a3 = _mk_alloc(hi, node.id, 1000, 2000)    # higher prio
    p = Preemptor(placing.priority, "default", placing.id)
    p.set_node(node)
    p.set_candidates([a1, a2, a3])
    # node is oversubscribed; greedy picks a1 (distance 0) then a2, and
    # the superset filter keeps only a2 since it alone frees enough
    # (preemption.go filterSuperset:702)
    victims = p.preempt_for_task_group(
        ComparableResources(cpu_shares=1000, memory_mb=2000))
    assert victims is not None
    assert all(v.job.priority == 20 for v in victims)
    assert [v.id for v in victims] == [a2.id]


def test_preemptor_priority_delta_gate():
    node = mock.node()
    near = mock.job()
    near.priority = 45    # delta < 10 vs 50: not preemptible
    placing = mock.job()
    placing.priority = 50
    a = _mk_alloc(near, node.id, 3500, 7000)
    p = Preemptor(placing.priority, "default", placing.id)
    p.set_node(node)
    p.set_candidates([a])
    assert p.preempt_for_task_group(
        ComparableResources(cpu_shares=1000, memory_mb=1000)) is None


def test_preemptor_superset_filter():
    node = mock.node()
    lo = mock.job()
    lo.priority = 10
    placing = mock.job()
    placing.priority = 70
    # node is full: 3 allocs of 1300 cpu each
    allocs = [_mk_alloc(lo, node.id, 1300, 2600) for _ in range(3)]
    p = Preemptor(placing.priority, "default", placing.id)
    p.set_node(node)
    p.set_candidates(allocs)
    victims = p.preempt_for_task_group(
        ComparableResources(cpu_shares=1200, memory_mb=2000))
    assert victims is not None
    assert len(victims) == 1   # one eviction is enough


def test_service_preemption_end_to_end():
    h = Harness(device="cpu")
    # enable service preemption
    h.store.set_scheduler_config(1, SchedulerConfiguration(
        preemption_config=PreemptionConfig(service_scheduler_enabled=True)))
    n = mock.node()
    h.store.upsert_node(h.next_index(), n)
    # fill the node with a low-priority job
    lowjob = mock.job()
    lowjob.priority = 20
    lowjob.task_groups[0].count = 7   # 7*500 = 3500 of 3900
    lowjob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), lowjob)
    h.process("service", Evaluation(namespace="default", type="service",
                                    triggered_by="job-register",
                                    job_id=lowjob.id))
    assert len(h.store.allocs_by_job("default", lowjob.id)) == 7

    # high priority job needs 1000 cpu: must preempt
    hijob = mock.job()
    hijob.priority = 70
    hijob.task_groups[0].count = 1
    hijob.task_groups[0].tasks[0].resources.cpu = 1000
    hijob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), hijob)
    h.process("service", Evaluation(namespace="default", type="service",
                                    triggered_by="job-register",
                                    job_id=hijob.id))
    placed = h.store.allocs_by_job("default", hijob.id)
    assert len(placed) == 1
    assert placed[0].preempted_allocations
    evicted = [h.store.alloc_by_id(aid)
               for aid in placed[0].preempted_allocations]
    assert all(a.desired_status == ALLOC_DESIRED_EVICT for a in evicted)
    assert all(a.preempted_by_allocation == placed[0].id for a in evicted)
    # minimal victim set: 3500+1000 <= 3900 needs 2 evictions (600 free + 2*500)
    assert len(evicted) == 2


def test_preemption_disabled_by_default_for_service():
    h = Harness(device="cpu")
    n = mock.node()
    h.store.upsert_node(h.next_index(), n)
    lowjob = mock.job()
    lowjob.priority = 20
    lowjob.task_groups[0].count = 7
    lowjob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), lowjob)
    h.process("service", Evaluation(namespace="default", type="service",
                                    triggered_by="job-register",
                                    job_id=lowjob.id))
    hijob = mock.job()
    hijob.priority = 70
    hijob.task_groups[0].count = 1
    hijob.task_groups[0].tasks[0].resources.cpu = 1000
    hijob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), hijob)
    h.process("service", Evaluation(namespace="default", type="service",
                                    triggered_by="job-register",
                                    job_id=hijob.id))
    assert h.store.allocs_by_job("default", hijob.id) == []
    assert "web" in h.evals[-1].failed_tg_allocs


def test_system_preemption_enabled_by_default():
    h = Harness(device="cpu")
    n = mock.node()
    h.store.upsert_node(h.next_index(), n)
    lowjob = mock.job()
    lowjob.priority = 20
    lowjob.task_groups[0].count = 7
    lowjob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), lowjob)
    h.process("service", Evaluation(namespace="default", type="service",
                                    triggered_by="job-register",
                                    job_id=lowjob.id))
    sysjob = mock.system_job()     # priority 100, needs 500cpu/256mb
    sysjob.task_groups[0].tasks[0].resources.networks = []
    h.store.upsert_job(h.next_index(), sysjob)
    h.process("system", Evaluation(namespace="default", type="system",
                                   triggered_by="job-register",
                                   job_id=sysjob.id))
    placed = h.store.allocs_by_job("default", sysjob.id)
    assert len(placed) == 1
    assert placed[0].preempted_allocations


def test_mixed_competition_preempting_node_can_win():
    """rank.go:415-448 semantics: a full node whose post-eviction
    binpack + logistic preemption score beats an empty node's plain
    binpack score wins the SAME selection. A low-priority filler on a
    node leaves it 'full'; the empty node has a weak (nearly empty)
    binpack score; the preempting node scores (binpack-after-evict +
    ~1.0 logistic)/2, which is higher."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import (Evaluation, EVAL_STATUS_PENDING,
                                        TRIGGER_JOB_REGISTER)
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.utils.ids import generate_uuid

    h = Harness(device="cpu")
    from nomad_tpu_torch.models import PreemptionConfig, SchedulerConfiguration
    h.store.set_scheduler_config(
        h.next_index(),
        SchedulerConfiguration(preemption_config=PreemptionConfig(
            service_scheduler_enabled=True, batch_scheduler_enabled=True)))

    full = mock.node()
    full.name = "full-node"
    empty = mock.node()
    empty.name = "empty-node"
    h.store.upsert_node(h.next_index(), full)
    h.store.upsert_node(h.next_index(), empty)

    # low-prio filler saturating the full node
    filler = mock.job()
    filler.id = "filler"
    filler.priority = 10   # netPriority ~10+1 -> logistic ~1.0
    tg = filler.task_groups[0]
    tg.count = 1
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.cpu = 3600
        t.resources.memory_mb = 7000
    tg.networks = []
    h.store.upsert_job(h.next_index(), filler)
    ev = Evaluation(id=generate_uuid(), namespace="default", priority=10,
                    triggered_by=TRIGGER_JOB_REGISTER, job_id=filler.id,
                    status=EVAL_STATUS_PENDING, type="service")
    h.process("service", ev)
    filler_alloc_node = [a for p in h.plans
                         for allocs in p.node_allocation.values()
                         for a in allocs][0].node_id

    # also occupy the other node slightly so its binpack score is low
    # (near-empty binpack score ~ (20-2*10^~1)/18 ~ 0)
    hi = mock.job()
    hi.id = "hi"
    hi.priority = 80
    tg = hi.task_groups[0]
    tg.count = 1
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.cpu = 2000
        t.resources.memory_mb = 4000
    tg.networks = []
    h.store.upsert_job(h.next_index(), hi)
    ev2 = Evaluation(id=generate_uuid(), namespace="default", priority=80,
                     triggered_by=TRIGGER_JOB_REGISTER, job_id=hi.id,
                     status=EVAL_STATUS_PENDING, type="service")
    h.process("service", ev2)
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 1
    preempted = [a for allocs in plan.node_preemptions.values()
                 for a in allocs]
    # the preempting node must win: (binpack-after-evict ~0.77 +
    # logistic ~1.0)/2 ~ 0.88 beats the empty node's near-zero binpack
    assert placed[0].node_id == filler_alloc_node
    assert len(preempted) == 1
    assert placed[0].preempted_allocations == [preempted[0].id]


def _dev_holder(node, prio, instance_ids, job_id="holder"):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import AllocatedDeviceResource
    from nomad_tpu_torch.utils.ids import generate_uuid
    a = mock.alloc()
    a.id = generate_uuid()
    a.node_id = node.id
    a.job = mock.job()
    a.job.priority = prio
    a.job.id = job_id
    a.job_id = job_id
    tr = a.allocated_resources.tasks["web"]
    tr.networks = []
    g = node.node_resources.devices[0]
    tr.devices = [AllocatedDeviceResource(
        vendor=g.vendor, type=g.type, name=g.name,
        device_ids=list(instance_ids))]
    return a


def test_preempt_for_device_frees_instances():
    """preemption.go PreemptForDevice: lowest-priority holders of the
    needed device group are evicted until enough instances free."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import RequestedDevice
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.nvidia_node()
    ids = [i.id for i in node.node_resources.devices[0].instances]
    low = _dev_holder(node, 20, ids[:2], "low")
    high = _dev_holder(node, 40, ids[2:], "high")
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([low, high])
    p.set_preemptions([])
    # 2 needed, 0 free -> evict the lowest-priority holder only
    victims = p.preempt_for_device(RequestedDevice(name="gpu", count=2), node)
    assert victims is not None and [v.id for v in victims] == [low.id]
    # 3 needed -> both holders fall
    victims3 = p.preempt_for_device(RequestedDevice(name="gpu", count=3), node)
    assert victims3 is not None and len(victims3) == 2
    # nothing to evict when enough already free
    p2 = Preemptor(80, "default", "the-job")
    p2.set_node(node)
    p2.set_candidates([low])
    p2.set_preemptions([])
    assert p2.preempt_for_device(
        RequestedDevice(name="gpu", count=2), node) == []


def test_preempt_for_device_ineligible_holders_block():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import RequestedDevice
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.nvidia_node()
    ids = [i.id for i in node.node_resources.devices[0].instances]
    close = _dev_holder(node, 75, ids, "close")   # delta < 10
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([close])
    p.set_preemptions([])
    assert p.preempt_for_device(
        RequestedDevice(name="gpu", count=1), node) is None


def _port_holder(node, prio, port, mbits=100, job_id="net-holder"):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import NetworkResource, Port
    from nomad_tpu_torch.utils.ids import generate_uuid
    a = mock.alloc()
    a.id = generate_uuid()
    a.node_id = node.id
    a.job = mock.job()
    a.job.priority = prio
    a.job.id = job_id
    a.job_id = job_id
    tr = a.allocated_resources.tasks["web"]
    tr.networks = [NetworkResource(
        device="eth0", ip="192.168.0.100", mbits=mbits,
        reserved_ports=[Port(label="p", value=port)])]
    return a


def test_preempt_for_network_port_collision():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.node()
    holder = _port_holder(node, 20, 8080)
    other = _port_holder(node, 20, 9090, job_id="other")
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([holder, other])
    p.set_preemptions([])
    victims = p.preempt_for_network([8080], 0.0, node)
    assert victims is not None and [v.id for v in victims] == [holder.id]
    # ineligible holder blocks the node
    p2 = Preemptor(25, "default", "the-job")
    p2.set_node(node)
    p2.set_candidates([holder])
    p2.set_preemptions([])
    assert p2.preempt_for_network([8080], 0.0, node) is None


def test_preempt_for_network_bandwidth():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.node()   # eth0 1000 mbits
    hog = _port_holder(node, 20, 8080, mbits=800, job_id="hog")
    small = _port_holder(node, 30, 9090, mbits=100, job_id="small")
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([hog, small])
    p.set_preemptions([])
    # need 500 mbits; used 900/1000 -> shortfall 400 -> evict the
    # lowest-priority (hog) first
    victims = p.preempt_for_network([], 500.0, node)
    assert victims is not None
    assert [v.id for v in victims] == [hog.id]


def test_scheduler_preempts_for_devices_e2e():
    """A device job whose instances are all held by low-priority allocs
    places by evicting them (device preemption through the full
    scheduler)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.models import (Evaluation, RequestedDevice,
                                        EVAL_STATUS_PENDING,
                                        TRIGGER_JOB_REGISTER,
                                        PreemptionConfig, SchedulerConfiguration)
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.utils.ids import generate_uuid

    h = Harness(device="cpu")
    h.store.set_scheduler_config(
        h.next_index(),
        SchedulerConfiguration(preemption_config=PreemptionConfig(
            service_scheduler_enabled=True)))
    node = mock.nvidia_node()
    h.store.upsert_node(h.next_index(), node)
    ids = [i.id for i in node.node_resources.devices[0].instances]
    holder = _dev_holder(node, 20, ids, "low-dev")
    h.store.upsert_job(h.next_index(), holder.job)
    h.store.upsert_allocs(h.next_index(), [holder])

    job = mock.job()
    job.id = "needs-gpu"
    job.priority = 80
    tg = job.task_groups[0]
    tg.count = 1
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.devices = [RequestedDevice(name="gpu", count=2)]
    tg.networks = []
    h.store.upsert_job(h.next_index(), job)
    ev = Evaluation(id=generate_uuid(), namespace="default", priority=80,
                    triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
                    status=EVAL_STATUS_PENDING, type="service")
    h.process("service", ev)
    plan = h.plans[-1]
    placed = [a for al in plan.node_allocation.values() for a in al]
    preempted = [a for al in plan.node_preemptions.values() for a in al]
    assert len(placed) == 1, h.evals
    assert [a.id for a in preempted] == [holder.id]
    devs = placed[0].allocated_resources.tasks["web"].devices
    assert len(devs[0].device_ids) == 2
