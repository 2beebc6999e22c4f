"""The port's run of tests/test_devices.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Device scheduling end-to-end: DeviceChecker feasibility mask, slot
accounting in the kernel, affinity scoring, instance-ID assignment, and
plan-applier collision defense, and at the end the client's configured
device groups (test_client_fingerprints_configured_devices,
test_device_job_runs_on_cluster: a Client beside the Server).

Reference semantics: scheduler/feasible.go DeviceChecker:1138,
scheduler/device.go AssignDevice:32, scheduler/rank.go:456 device
scoring, nomad/structs/devices.go DeviceAccounter.
"""

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (Affinity, Constraint, Evaluation,
                                    RequestedDevice, EVAL_STATUS_PENDING,
                                    TRIGGER_JOB_REGISTER)
from nomad_tpu_torch.scheduler.devices import (assign_devices, device_columns,
                                               group_satisfies,
                                               static_device_mask)
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.utils.ids import generate_uuid

import test_torch_select  # noqa: F401  (torch's thread cap)


def _eval_for(job):
    return Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
        status=EVAL_STATUS_PENDING, type=job.type)


def _gpu_job(count=1, dev_count=1, name="gpu", constraints=(),
             affinities=()):
    job = mock.job()
    job.id = f"{name}-job"
    tg = job.task_groups[0]
    tg.count = count
    for t in tg.tasks:
        t.resources.networks = []
        t.resources.devices = [RequestedDevice(
            name="gpu", count=dev_count,
            constraints=list(constraints), affinities=list(affinities))]
    tg.networks = []
    return job


# -- unit: matching & masks --------------------------------------------
def test_group_satisfies_name_forms():
    g = mock.nvidia_node().node_resources.devices[0]
    # name forms are <type>, <vendor>/<type>, <vendor>/<type>/<model>
    # (structs.go RequestedDevice.Name; feasible_test.go TestDeviceChecker)
    for name in ("gpu", "nvidia/gpu", "nvidia/gpu/1080ti"):
        assert group_satisfies(g, RequestedDevice(name=name, count=1)), name
    assert not group_satisfies(g, RequestedDevice(name="tpu", count=1))
    assert not group_satisfies(g, RequestedDevice(name="amd/gpu", count=1))
    assert not group_satisfies(g, RequestedDevice(name="nvidia/fpga",
                                                  count=1))


def test_group_satisfies_constraints():
    g = mock.nvidia_node().node_resources.devices[0]
    ok = RequestedDevice(name="gpu", count=1, constraints=[
        Constraint("${device.attr.memory}", "10000", ">=")])
    bad = RequestedDevice(name="gpu", count=1, constraints=[
        Constraint("${device.attr.memory}", "99999", ">=")])
    model = RequestedDevice(name="gpu", count=1, constraints=[
        Constraint("${device.model}", "1080ti", "=")])
    assert group_satisfies(g, ok)
    assert not group_satisfies(g, bad)
    assert group_satisfies(g, model)


def test_static_device_mask():
    nodes = [mock.node(), mock.nvidia_node(), mock.tpu_node()]
    asks = [RequestedDevice(name="gpu", count=2)]
    mask = static_device_mask(nodes, asks)
    assert mask.tolist() == [False, True, False]
    # more instances than the node has
    mask5 = static_device_mask(nodes, [RequestedDevice(name="gpu", count=5)])
    assert mask5.tolist() == [False, False, False]


def test_device_columns_slots_and_score():
    plain, gpu, tpu = mock.node(), mock.nvidia_node(), mock.tpu_node()
    nodes = [plain, gpu, tpu]
    aff = Affinity(ltarget="${device.attr.cuda_cores}", rtarget="3584",
                   operand="=", weight=50)
    asks = [RequestedDevice(name="gpu", count=2, affinities=[aff])]
    slots, score, fires = device_columns(nodes, asks, lambda nid: [])
    assert fires
    assert slots[0] == 0.0            # no devices at all
    assert slots[1] == 2.0            # 4 instances // 2 per placement
    assert slots[2] == 0.0            # tpu group doesn't match
    assert score[1] == pytest.approx(1.0)


# -- scheduler e2e -----------------------------------------------------
@pytest.fixture
def device_cluster():
    h = Harness(device="cpu")
    nodes = []
    for i in range(4):
        n = mock.node()
        n.name = f"plain-{i}"
        n.compute_class()
        nodes.append(n)
        h.store.upsert_node(h.next_index(), n)
    g = mock.nvidia_node()
    g.name = "gpu-node"
    h.store.upsert_node(h.next_index(), g)
    return h, nodes, g


def test_device_job_places_on_device_node_with_ids(device_cluster):
    h, _plain, gpu_node = device_cluster
    job = _gpu_job(count=2, dev_count=1)
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 2
    ids_seen = set()
    for a in placed:
        assert a.node_id == gpu_node.id
        devs = a.allocated_resources.tasks["web"].devices
        assert len(devs) == 1 and devs[0].vendor == "nvidia"
        assert len(devs[0].device_ids) == 1
        ids_seen.update(devs[0].device_ids)
    assert len(ids_seen) == 2, "instance IDs must be disjoint"


def test_device_exhaustion_blocks_placement(device_cluster):
    h, _plain, _gpu = device_cluster
    # 4 instances, 2 per alloc -> only 2 placements fit
    job = _gpu_job(count=3, dev_count=2, name="hungry")
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 2
    all_ids = [i for a in placed
               for i in a.allocated_resources.tasks["web"].devices[0].device_ids]
    assert len(all_ids) == 4 and len(set(all_ids)) == 4
    # the eval records the failure
    assert h.evals and any(e.triggered_by for e in h.evals) or \
        h.plans[-1] is plan


def test_device_affinity_prefers_matching_node(device_cluster):
    h, _plain, _gpu = device_cluster
    # add a second gpu node with fewer cuda cores
    weak = mock.nvidia_node()
    weak.name = "weak-gpu"
    weak.node_resources.devices[0].attributes["cuda_cores"] = 100
    weak.node_resources.devices[0].name = "1050"
    weak.compute_class()
    h.store.upsert_node(h.next_index(), weak)

    aff = Affinity(ltarget="${device.attr.cuda_cores}", rtarget="3584",
                   operand="=", weight=100)
    job = _gpu_job(count=1, dev_count=1, name="aff",
                   affinities=[aff])
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    assert len(placed) == 1
    node = h.store.snapshot().node_by_id(placed[0].node_id)
    devs = node.node_resources.devices[0]
    assert devs.attributes["cuda_cores"] == 3584
    # "devices" scorer recorded on metrics
    assert placed[0].metrics is not None


def test_assign_devices_respects_existing_usage(device_cluster):
    h, _plain, gpu_node = device_cluster
    # pre-existing alloc using 3 of the 4 instances
    pre = mock.alloc()
    pre.node_id = gpu_node.id
    ids = [i.id for i in gpu_node.node_resources.devices[0].instances]
    from nomad_tpu_torch.models import AllocatedDeviceResource
    pre.allocated_resources.tasks["web"].devices = [
        AllocatedDeviceResource(vendor="nvidia", type="gpu", name="1080ti",
                                device_ids=ids[:3])]
    offers, _ = assign_devices(
        gpu_node, _gpu_job(dev_count=1).task_groups[0], [pre])
    assert offers is not None
    assert offers["web"][0].device_ids == [ids[3]]
    # asking for 2 must fail now
    offers2, _ = assign_devices(
        gpu_node, _gpu_job(dev_count=2).task_groups[0], [pre])
    assert offers2 is None


def test_kernel_scan_vs_chunked_device_slots():
    """Device slots behave identically in the chunked and scan paths."""
    import nomad_tpu_torch.ops.select as sel
    from nomad_tpu_torch.ops import kernels
    n = 6
    capacity = np.full((n, 4), 10000.0, np.float32)
    slots = np.array([0, 1, 2, 3, 0, 5], np.float32)
    kw = dict(
        ask=np.array([100.0, 100.0, 0.0, 0.0], np.float32), count=8,
        feasible=np.ones(n, bool), capacity=capacity,
        used=np.zeros((n, 4), np.float32), desired_count=8.0,
        tg_collisions=np.zeros(n, np.int32),
        job_count=np.zeros(n, np.int32),
        dev_slots=slots.copy(),
        dev_score=np.array([0, 0, 0.5, 0, 0, 0], np.float32),
        dev_fires=True)
    chunked = sel.SelectKernel(device="cpu").select(sel.SelectRequest(**kw))
    req2 = sel.SelectRequest(**kw)
    n_pad = sel._pad_n(n)
    args, statics = sel.pack_request(req2, n_pad)
    # the port's scan arm, as SelectKernel runs it for a request the
    # chunked kernel cannot take
    _c, outs = kernels.select_scan(
        **sel.SelectKernel(device="cpu")._tensors(args, sel._SCAN_ARGS),
        k_steps=sel._bucket_k(8), **statics)
    scan = sel.unpack_result(req2, outs)
    assert np.array_equal(chunked.node_idx, scan.node_idx)
    assert np.allclose(chunked.final_score, scan.final_score,
                       rtol=1e-4, atol=1e-5)
    # slot budget respected: node usage never exceeds its slots
    from collections import Counter
    counts = Counter(chunked.node_idx.tolist())
    counts.pop(-1, None)
    for node_i, c in counts.items():
        assert c <= slots[node_i], (node_i, c)


def test_plan_applier_rejects_device_collision(device_cluster):
    h, _plain, gpu_node = device_cluster
    from nomad_tpu_torch.models import AllocatedDeviceResource, AllocsFit
    ids = [i.id for i in gpu_node.node_resources.devices[0].instances]

    def dev_alloc(instance_ids):
        a = mock.alloc()
        a.id = generate_uuid()
        a.node_id = gpu_node.id
        tr = a.allocated_resources.tasks["web"]
        tr.networks = []          # isolate the device dimension
        tr.devices = [AllocatedDeviceResource(
            vendor="nvidia", type="gpu", name="1080ti",
            device_ids=list(instance_ids))]
        return a

    pre = dev_alloc([ids[0]])
    colliding = dev_alloc([ids[0]])
    fit, dim, _ = AllocsFit(gpu_node, [pre, colliding], check_devices=True)
    assert not fit and "device" in dim
    # disjoint IDs fit
    ok = dev_alloc([ids[1]])
    fit2, _dim2, _ = AllocsFit(gpu_node, [pre, ok], check_devices=True)
    assert fit2


# -- tests/test_devices.py: a Client beside the Server ------------------
def test_client_fingerprints_configured_devices():
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.models import NodeDevice, NodeDeviceResource
    from nomad_tpu_torch.server import Server, ServerConfig
    server = Server(ServerConfig(num_schedulers=0), device="cpu")
    dev = NodeDeviceResource(
        vendor="google", type="tpu", name="v5e",
        instances=[NodeDevice(id="tpu-0", healthy=True)])
    c = Client(server, ClientConfig(devices=(dev,)))
    assert c.node.node_resources.devices[0].type == "tpu"
    assert c.node.attributes["device.tpu"] == "1"


def test_device_job_runs_on_cluster():
    """Full path: client fingerprints a TPU device group, a job asking
    for the device schedules onto it and runs to completion with
    instance IDs recorded on the alloc."""
    import time
    from nomad_tpu_torch.client import Client, ClientConfig
    from nomad_tpu_torch.models import (NodeDevice, NodeDeviceResource,
                                  ALLOC_CLIENT_COMPLETE)
    from nomad_tpu_torch.server import Server, ServerConfig

    def wait_for(pred, timeout=15.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return False

    server = Server(ServerConfig(num_schedulers=2, heartbeat_ttl_s=30.0),
                    device="cpu")
    server.start()
    dev = NodeDeviceResource(
        vendor="google", type="tpu", name="v5e",
        instances=[NodeDevice(id=f"tpu-{i}", healthy=True)
                   for i in range(4)])
    plain = Client(server, ClientConfig(node_name="plain"))
    tpu = Client(server, ClientConfig(node_name="tpu-bearing",
                                      devices=(dev,)))
    plain.start()
    tpu.start()
    try:
        job = mock.batch_job()
        job.task_groups[0].count = 2
        task = job.task_groups[0].tasks[0]
        task.config = {"run_for": "50ms"}
        task.resources.devices = [RequestedDevice(name="tpu", count=2)]
        server.register_job(job)

        assert wait_for(lambda: len(
            server.store.allocs_by_job("default", job.id)) == 2)
        allocs = server.store.allocs_by_job("default", job.id)
        used_ids = []
        for a in allocs:
            assert a.node_id == tpu.node.id
            devs = a.allocated_resources.tasks[task.name].devices
            assert devs[0].type == "tpu" and len(devs[0].device_ids) == 2
            used_ids.extend(devs[0].device_ids)
        assert len(set(used_ids)) == 4
        assert wait_for(lambda: all(
            a.client_status == ALLOC_CLIENT_COMPLETE
            for a in server.store.allocs_by_job("default", job.id)))
    finally:
        plain.shutdown()
        tpu.shutdown()
        server.shutdown()
