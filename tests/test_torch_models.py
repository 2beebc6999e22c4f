"""The reference's model tests (tests/test_models.py: resources, networks
and port ranges, job and task-group canonicalization and validation, the
wire codec, reschedule policies) against the port's copies of models/ and
utils/codec.py, their assertions unchanged.
"""

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import (
    Allocation, AllocsFit, ComparableResources, Constraint, Job,
    NetworkIndex, NetworkResource, Port, ScoreFitBinPack, ScoreFitSpread,
    ALLOC_DESIRED_STOP, ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_FAILED,
)
from nomad_tpu_torch.models.networks import parse_port_ranges
from nomad_tpu_torch.utils.codec import to_wire, from_wire


def test_job_canonicalize_and_validate():
    j = mock.job()
    assert j.validate() == []
    assert j.task_groups[0].reschedule_policy is not None
    assert j.task_groups[0].update is None  # structs layer does not default it


def test_job_validate_errors():
    j = Job(id="has space", type="bogus", priority=200)
    errs = j.validate()
    assert any("space" in e for e in errs)
    assert any("invalid job type" in e for e in errs)
    assert any("priority" in e for e in errs)
    assert any("datacenters" in e for e in errs)
    assert any("task groups" in e for e in errs)


def test_system_job_no_spread_affinity():
    j = mock.system_job()
    assert j.validate() == []
    from nomad_tpu_torch.models import Spread
    j.spreads = [Spread(attribute="${node.datacenter}", weight=50)]
    assert any("spread" in e for e in j.validate())


def test_job_copy_deep():
    j = mock.job()
    c = j.copy()
    assert c is not j
    assert to_wire(c) == to_wire(j)
    c.task_groups[0].count = 99
    assert j.task_groups[0].count == 10


def test_job_specchanged():
    j = mock.job()
    c = j.copy()
    c.modify_index += 100
    assert not j.specchanged(c)
    c.task_groups[0].count += 1
    assert j.specchanged(c)


def test_node_compute_class_stable():
    n1 = mock.node()
    n2 = mock.node()
    # ids/secrets differ but class hash must match (identical machines)
    assert n1.computed_class == n2.computed_class
    n2.attributes["kernel.name"] = "darwin"
    n2.compute_class()
    assert n1.computed_class != n2.computed_class


def test_alloc_terminal_status():
    a = mock.alloc()
    assert not a.terminal_status()
    a.desired_status = ALLOC_DESIRED_STOP
    assert a.terminal_status()
    a.desired_status = "run"
    a.client_status = ALLOC_CLIENT_FAILED
    assert a.terminal_status()


def test_alloc_index_parse():
    a = mock.alloc()
    assert a.name.endswith("[0]")
    assert a.index() == 0
    a.name = "job.web[13]"
    assert a.index() == 13


def test_allocs_fit_basic():
    n = mock.node()
    a = mock.alloc()
    fit, dim, used = AllocsFit(n, [a])
    assert fit, dim
    assert used.cpu_shares == 500
    assert used.memory_mb == 256


def test_allocs_fit_exhausted_cpu():
    n = mock.node()
    a = mock.alloc()
    a.allocated_resources.tasks["web"].cpu.cpu_shares = 4000  # > 4000-100 reserved
    fit, dim, _ = AllocsFit(n, [a])
    assert not fit
    assert dim == "cpu"


def test_allocs_fit_ignores_terminal():
    n = mock.node()
    a1, a2 = mock.alloc(), mock.alloc()
    a2.allocated_resources.tasks["web"].cpu.cpu_shares = 3800
    a2.desired_status = ALLOC_DESIRED_STOP
    # strip ports so no collision between the two
    a1.allocated_resources.tasks["web"].networks = []
    a2.allocated_resources.tasks["web"].networks = []
    fit, dim, used = AllocsFit(n, [a1, a2])
    assert fit, dim
    assert used.cpu_shares == 500


def test_score_fit_binpack_bounds():
    n = mock.node()
    # empty utilization -> score 0 (20 - 10^1 - 10^1)
    empty = ComparableResources()
    assert ScoreFitBinPack(n, empty) == pytest.approx(0.0)
    # full utilization -> 18
    full = ComparableResources(cpu_shares=3900, memory_mb=7936)
    assert ScoreFitBinPack(n, full) == pytest.approx(18.0)
    # spread is inverse
    assert ScoreFitSpread(n, empty) == pytest.approx(18.0)
    assert ScoreFitSpread(n, full) == pytest.approx(0.0)
    # half used in both dims
    half = ComparableResources(cpu_shares=1950, memory_mb=3968)
    expected = 20.0 - 2 * 10 ** 0.5
    assert ScoreFitBinPack(n, half) == pytest.approx(expected)


def test_network_index_collision_and_assign():
    n = mock.node()
    idx = NetworkIndex()
    assert not idx.set_node(n)
    # port 22 is reserved via reserved_host_ports
    ask = NetworkResource(mbits=10, reserved_ports=[Port(label="ssh", value=22)])
    offer, err = idx.assign_network(ask)
    assert offer is None
    assert "reserved port collision" in err
    ask2 = NetworkResource(mbits=10, dynamic_ports=[Port(label="http", to=-1)])
    offer, err = idx.assign_network(ask2)
    assert err == ""
    port = offer.dynamic_ports[0].value
    assert 20000 <= port <= 32000
    assert offer.dynamic_ports[0].to == port


def test_network_index_add_allocs():
    n = mock.node()
    idx = NetworkIndex()
    idx.set_node(n)
    a = mock.alloc()  # reserves 5000 + 9876 on 192.168.0.100
    assert not idx.add_allocs([a])
    ask = NetworkResource(mbits=10, reserved_ports=[Port(label="db", value=5000)])
    offer, err = idx.assign_network(ask)
    assert offer is None and "collision" in err
    # terminal allocs release ports
    idx2 = NetworkIndex()
    idx2.set_node(n)
    a.desired_status = ALLOC_DESIRED_STOP
    idx2.add_allocs([a])
    offer, err = idx2.assign_network(ask)
    assert err == ""


def test_parse_port_ranges():
    assert parse_port_ranges("80,100-103,205") == [80, 100, 101, 102, 103, 205]
    with pytest.raises(ValueError):
        parse_port_ranges("700000")


def test_free_dynamic_port_count():
    n = mock.node()
    idx = NetworkIndex()
    idx.set_node(n)
    full = idx.free_dynamic_port_count("192.168.0.100")
    assert full == 12001
    idx.add_reserved(NetworkResource(
        ip="192.168.0.100", dynamic_ports=[Port(label="x", value=20001)]))
    assert idx.free_dynamic_port_count("192.168.0.100") == full - 1


def test_wire_roundtrip():
    j = mock.job()
    data = to_wire(j)
    j2 = from_wire(Job, data)
    assert to_wire(j2) == data
    a = mock.alloc()
    a2 = from_wire(Allocation, to_wire(a))
    assert to_wire(a2) == to_wire(a)


def test_eval_blocked_creation():
    e = mock.evaluation()
    b = e.create_blocked_eval({"v1:abc": True}, False, "")
    assert b.status == "blocked"
    assert b.previous_eval == e.id
    assert b.triggered_by == "queued-allocs"


def test_reschedule_delay_functions():
    a = mock.alloc()
    from nomad_tpu_torch.models.job import ReschedulePolicy
    from nomad_tpu_torch.models.alloc import RescheduleTracker, RescheduleEvent
    pol = ReschedulePolicy(delay_s=5.0, delay_function="exponential",
                           max_delay_s=100.0, unlimited=True)
    a.reschedule_tracker = RescheduleTracker(events=[
        RescheduleEvent(reschedule_time=1000.0)] * 3)
    assert a._next_delay(pol) == 40.0   # 5 * 2^3
    pol.delay_function = "constant"
    assert a._next_delay(pol) == 5.0
    pol.delay_function = "fibonacci"
    assert a._next_delay(pol) == 15.0   # 5,5,10,15 -> idx3
    pol.delay_function = "exponential"
    a.reschedule_tracker.events = a.reschedule_tracker.events * 4
    assert a._next_delay(pol) == 100.0  # capped
