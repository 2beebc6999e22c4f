"""The reference's kernel-layer tests (tests/test_select_kernel.py: binpack
and spread scoring, masks, no-fit reasons, anti-affinity and collision
penalties, distinct hosts and properties, reschedule penalty, affinity,
spread targets, ports, the top-k scores and usage carried between
placements) against the port's SelectKernel on the CPU (its kernels'
plain versions), their assertions unchanged.
"""

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import ScoreFitBinPack, ScoreFitSpread, ComparableResources
from nomad_tpu_torch.ops.select import SelectKernel, SelectRequest

import test_torch_select  # noqa: F401  (torch's thread cap)


def _basic_req(n_nodes=4, cpu=4000, mem=8192, disk=100 * 1024, **kw):
    capacity = np.tile(np.array([[cpu, mem, disk]], dtype=np.float32),
                       (n_nodes, 1))
    defaults = dict(
        ask=np.array([500, 256, 150], dtype=np.float32),
        count=1,
        feasible=np.ones(n_nodes, dtype=bool),
        capacity=capacity,
        used=np.zeros((n_nodes, 3), dtype=np.float32),
        desired_count=10,
        tg_collisions=np.zeros(n_nodes, dtype=np.int32),
        job_count=np.zeros(n_nodes, dtype=np.int32),
    )
    defaults.update(kw)
    return SelectRequest(**defaults)


class _FakeNode:
    """Adapter so models.funcs scoring can be used as the golden value."""
    def __init__(self, cpu, mem):
        self.cpu, self.mem = cpu, mem

    def comparable_resources(self):
        return ComparableResources(cpu_shares=self.cpu, memory_mb=self.mem)

    def comparable_reserved_resources(self):
        return ComparableResources()


def test_binpack_prefers_fuller_node():
    # node 1 already half full -> binpack should pick it
    used = np.zeros((2, 3), dtype=np.float32)
    used[1] = [2000, 4096, 0]
    req = _basic_req(2, used=used)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 1
    golden = ScoreFitBinPack(_FakeNode(4000, 8192),
                             ComparableResources(cpu_shares=2500,
                                                 memory_mb=4352)) / 18.0
    assert res.final_score[0] == pytest.approx(golden, abs=1e-5)
    assert res.scores["binpack"][0] == pytest.approx(golden, abs=1e-5)


def test_spread_algorithm_prefers_empty_node():
    used = np.zeros((2, 3), dtype=np.float32)
    used[1] = [2000, 4096, 0]
    req = _basic_req(2, used=used, algorithm="spread")
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 0
    golden = ScoreFitSpread(_FakeNode(4000, 8192),
                            ComparableResources(cpu_shares=500,
                                                memory_mb=256)) / 18.0
    assert res.final_score[0] == pytest.approx(golden, abs=1e-5)


def test_infeasible_nodes_masked():
    feasible = np.array([False, True, False])
    req = _basic_req(3, feasible=feasible)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 1
    assert res.nodes_filtered == 2


def test_no_fit_returns_minus_one_and_dimension():
    req = _basic_req(2, ask=np.array([5000, 100, 0], dtype=np.float32))
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == -1
    assert res.placed == 0
    # both nodes exhausted on cpu
    assert res.exhausted_dim[0][0] == 2


def test_multi_placement_spreads_by_anti_affinity():
    # 4 identical nodes, place 4 instances: anti-affinity should spread
    # them one per node (each placement adds a collision penalty)
    req = _basic_req(4, count=4)
    res = SelectKernel("cpu").select(req)
    assert res.placed == 4
    assert sorted(res.node_idx.tolist()) == [0, 1, 2, 3]
    # first placement scored binpack only; later ones also clean
    assert (res.scores["job-anti-affinity"][:] == 0).all()


def test_multi_placement_collision_penalty_applied():
    # 1 node only: all instances stack, and the anti-affinity penalty
    # must appear from the second placement on
    req = _basic_req(1, count=3, desired_count=3)
    res = SelectKernel("cpu").select(req)
    assert res.placed == 3
    anti = res.scores["job-anti-affinity"]
    assert anti[0] == 0
    assert anti[1] == pytest.approx(-(1 + 1) / 3)
    assert anti[2] == pytest.approx(-(2 + 1) / 3)
    # final = mean(binpack, anti) when anti fires
    bp = res.scores["binpack"]
    assert res.final_score[1] == pytest.approx((bp[1] + anti[1]) / 2, abs=1e-5)


def test_distinct_hosts_blocks_second_placement():
    req = _basic_req(2, count=3, distinct_hosts=True)
    res = SelectKernel("cpu").select(req)
    assert res.placed == 2
    assert sorted(res.node_idx.tolist()[:2]) == [0, 1]
    assert res.node_idx[2] == -1


def test_reschedule_penalty():
    pen = np.array([True, False])
    req = _basic_req(2, penalty=pen)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 1
    # placing on node 0 would score (binpack - 1)/2
    req2 = _basic_req(1, penalty=np.array([True]))
    res2 = SelectKernel("cpu").select(req2)
    bp = res2.scores["binpack"][0]
    assert res2.final_score[0] == pytest.approx((bp - 1) / 2, abs=1e-5)


def test_affinity_scoring():
    aff = np.array([0.0, 50.0], dtype=np.float32)   # node 1 matches w=50
    req = _basic_req(2, affinity=aff, affinity_sum_weights=50.0)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 1
    bp = res.scores["binpack"][0]
    assert res.final_score[0] == pytest.approx((bp + 1.0) / 2, abs=1e-5)


def test_anti_affinity_negative_weight():
    aff = np.array([0.0, -50.0], dtype=np.float32)
    req = _basic_req(2, affinity=aff, affinity_sum_weights=50.0)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 0


def test_spread_with_targets():
    # 4 nodes: dc codes [0,0,1,1]; target dc0=80%, dc1=20%, count=10
    codes = np.array([0, 0, 1, 1], dtype=np.int32)
    c = 65
    counts = np.zeros(c, dtype=np.float32)
    present = np.zeros(c, dtype=bool)
    desired = np.full(c, -1.0, dtype=np.float32)
    desired[0] = 8.0
    desired[1] = 2.0
    spread = dict(codes=codes, counts=counts, present=present,
                  desired=desired, weight=100.0, has_targets=True)
    req = _basic_req(4, count=10, desired_count=10,
                     spreads=[spread], sum_spread_weights=100.0)
    res = SelectKernel("cpu").select(req)
    assert res.placed == 10
    placed_dc0 = sum(1 for i in res.node_idx if i in (0, 1))
    placed_dc1 = sum(1 for i in res.node_idx if i in (2, 3))
    assert placed_dc0 == 8
    assert placed_dc1 == 2
    # first placement in dc0: boost = (8-1)/8 * 1.0
    assert res.scores["allocation-spread"][0] == pytest.approx(7 / 8, abs=1e-5)


def test_spread_even_no_targets():
    codes = np.array([0, 0, 1, 1], dtype=np.int32)
    c = 65
    spread = dict(codes=codes, counts=np.zeros(c, np.float32),
                  present=np.zeros(c, bool),
                  desired=np.full(c, -1.0, np.float32),
                  weight=50.0, has_targets=False)
    req = _basic_req(4, count=4, desired_count=4,
                     spreads=[spread], sum_spread_weights=50.0)
    res = SelectKernel("cpu").select(req)
    assert res.placed == 4
    dc0 = sum(1 for i in res.node_idx if i in (0, 1))
    assert dc0 == 2   # even spread


def test_distinct_property_limit():
    # nodes share rack values [r0,r0,r1,r1]; limit 1 per rack
    codes = np.array([0, 0, 1, 1], dtype=np.int32)
    dp = dict(codes=codes, counts=np.zeros(65, np.float32), limit=1.0)
    req = _basic_req(4, count=4, distinct_props=[dp])
    res = SelectKernel("cpu").select(req)
    assert res.placed == 2
    racks = {0: 0, 1: 0}
    for i in res.node_idx:
        if i >= 0:
            racks[0 if i in (0, 1) else 1] += 1
    assert racks == {0: 1, 1: 1}


def test_port_feasibility():
    free = np.array([0.0, 5.0], dtype=np.float32)
    req = _basic_req(2, port_need=2.0, free_ports=free)
    res = SelectKernel("cpu").select(req)
    assert res.node_idx[0] == 1
    port_ok = np.array([True, False])
    req2 = _basic_req(2, port_ok=port_ok)
    res2 = SelectKernel("cpu").select(req2)
    assert res2.node_idx[0] == 0


def test_top_k_scores_returned():
    used = np.zeros((4, 3), dtype=np.float32)
    used[2] = [2000, 4096, 0]   # node 2 should be best under binpack
    req = _basic_req(4, used=used)
    res = SelectKernel("cpu").select(req)
    assert res.top_idx[0][0] == 2
    assert res.top_scores[0][0] >= res.top_scores[0][1]


def test_usage_carries_between_placements():
    # tiny node: only fits 2 instances; third must go elsewhere
    cap = np.array([[1100, 600, 1000], [4000, 8192, 10000]], dtype=np.float32)
    req = _basic_req(2, count=3, capacity=cap,
                     ask=np.array([500, 256, 100], dtype=np.float32))
    res = SelectKernel("cpu").select(req)
    assert res.placed == 3
    # node 0 fits twice (1100 cpu >= 2*500), third lands on node 1
    assert res.node_idx.tolist().count(0) == 2
    assert res.node_idx.tolist().count(1) == 1
