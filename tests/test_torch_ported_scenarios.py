"""The port's run of tests/test_ported_scenarios.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Golden scenarios ported from the reference scheduler test tables: exact
operand truth tables from feasible_test.go:740-1100, binpack score goldens from
rank_test.go:28-130, spread score goldens from spread_test.go:25-360,
and preemption victim-selection behavior from preemption_test.go.
"""

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import ComparableResources, Constraint
from nomad_tpu_torch.ops.select import SelectKernel, SelectRequest, C_MAX
from nomad_tpu_torch.ops.tables import NodeTable
from nomad_tpu_torch.ops.targets import constraint_mask

import test_torch_select  # noqa: F401  (torch's thread cap)


# -- checkConstraint truth table (feasible_test.go:740) -----------------
def _mask_one(lval, rval, op):
    """Evaluate one (lVal, rVal, operand) case through the columnar
    constraint engine: a single node carrying lval as an attribute."""
    node = mock.node()
    if lval is not None:
        node.attributes["test.attr"] = lval
    node.compute_class()
    t = NodeTable([node])
    t.finalize()
    rtarget = "" if rval is None else str(rval)
    return bool(constraint_mask(t.cols, "${attr.test.attr}", rtarget, op)[0])


CHECK_CONSTRAINT_CASES = [
    ("=", "foo", "foo", True),
    ("is", "foo", "foo", True),
    ("==", "foo", "foo", True),
    ("==", "foo", None, False),
    ("==", None, "foo", False),
    ("!=", "foo", "foo", False),
    ("!=", "foo", "bar", True),
    ("!=", None, "foo", True),
    ("version", "1.2.3", "~> 1.0", True),
    ("version", None, "~> 1.0", False),
    ("regexp", "foobarbaz", "[\\w]+", True),
    ("regexp", None, "[\\w]+", False),
    ("<", "foo", "bar", False),
    ("<", None, "bar", False),
    ("set_contains", "foo,bar,baz", "foo,  bar  ", True),
    ("set_contains", "foo,bar,baz", "foo,bam", False),
    ("is_set", "foo", None, True),
    ("is_set", None, None, False),
    ("is_not_set", None, None, True),
    ("is_not_set", "foo", None, False),
]


@pytest.mark.parametrize("op,lval,rval,expect", CHECK_CONSTRAINT_CASES)
def test_check_constraint_table(op, lval, rval, expect):
    assert _mask_one(lval, rval, op) == expect


# checkLexicalOrder (feasible_test.go:877)
LEXICAL_CASES = [
    ("<", "bar", "foo", True),
    ("<=", "foo", "foo", True),
    (">", "bar", "foo", False),
    (">", "foo", "bar", True),
    (">=", "foo", "foo", True),
]


@pytest.mark.parametrize("op,lval,rval,expect", LEXICAL_CASES)
def test_check_lexical_order_table(op, lval, rval, expect):
    assert _mask_one(lval, rval, op) == expect


# checkVersionMatch (feasible_test.go:917)
VERSION_CASES = [
    ("1.2.3", "~> 1.0", True),
    ("1.2.3", ">= 1.0, < 1.4", True),
    ("2.0.1", "~> 1.0", False),
    ("1.4", ">= 1.0, < 1.4", False),
    (1, "~> 1.0", True),
    ("1.3.0-beta1", ">= 0.6.1", False),   # prerelease excluded (version)
    ("1.3.0-beta1+ent", "= 1.3.0-beta1", True),
]


@pytest.mark.parametrize("lval,rval,expect", VERSION_CASES)
def test_check_version_table(lval, rval, expect):
    assert _mask_one(lval, rval, "version") == expect


# checkSemverConstraint (feasible_test.go:988: prerelease included)
SEMVER_CASES = [
    ("1.2.3", "~> 1.0", False),
    ("1.2.3", ">= 1.0, < 1.4", True),
    ("1.3.0-beta1", ">= 0.6.1", True),
    ("1.7.0-alpha1", ">= 1.6.0-beta1", True),
]


@pytest.mark.parametrize("lval,rval,expect", SEMVER_CASES)
def test_check_semver_table(lval, rval, expect):
    assert _mask_one(lval, rval, "semver") == expect


# -- BinPack score goldens (rank_test.go TestBinPackIterator) -----------
def _score_single_node(cap_cpu, cap_mem, ask_cpu, ask_mem,
                       used_cpu=0.0, used_mem=0.0, algorithm="binpack"):
    capacity = np.array([[cap_cpu, cap_mem, 1e9, 1e9]], np.float32)
    used = np.array([[used_cpu, used_mem, 0, 0]], np.float32)
    req = SelectRequest(
        ask=np.array([ask_cpu, ask_mem, 0, 0], np.float32), count=1,
        feasible=np.ones(1, bool), capacity=capacity, used=used,
        desired_count=1.0, tg_collisions=np.zeros(1, np.int32),
        job_count=np.zeros(1, np.int32), algorithm=algorithm)
    res = SelectKernel(device="cpu").select(req)
    return (int(res.node_idx[0]), float(res.final_score[0]))


def test_binpack_perfect_fit_scores_one():
    # node 2048/2048 with 1024/1024 reserved -> comparable 1024;
    # ask 1024 -> perfect fit -> 20-10^0-10^0 = 18 -> 18/18 = 1.0
    idx, score = _score_single_node(1024, 1024, 1024, 1024)
    assert idx == 0
    assert score == pytest.approx(1.0, abs=1e-5)


def test_binpack_half_fit_score_range():
    # node 4096/4096 with 1024 reserved -> comparable 3072; ask 1024
    # rank_test.go expects the final score in (0.50, 0.60)
    idx, score = _score_single_node(3072, 3072, 1024, 1024)
    assert idx == 0
    assert 0.50 < score < 0.60


def test_binpack_overloaded_excluded():
    # comparable 512 < ask 1024 -> no placement
    idx, _ = _score_single_node(512, 512, 1024, 1024)
    assert idx == -1


def test_spread_algorithm_inverts_preference():
    # spread algorithm: fitness = total-2 (funcs.go ScoreFitSpread),
    # so an empty node outscores a packed one
    _, empty = _score_single_node(4000, 4000, 100, 100, 0, 0,
                                  algorithm="spread")
    _, packed = _score_single_node(4000, 4000, 100, 100, 3000, 3000,
                                   algorithm="spread")
    assert empty > packed


# -- Spread score goldens (spread_test.go) ------------------------------
def _spread_component(codes, counts_by_code, desired_by_code, weight,
                      sum_w, has_targets, node_i, n):
    """Kernel 'allocation-spread' component of node_i (others masked)."""
    c = np.full(C_MAX + 1, 0.0, np.float32)
    present = np.zeros(C_MAX + 1, bool)
    for k, v in counts_by_code.items():
        c[k] = v
        present[k] = v > 0
    desired = np.full(C_MAX + 1, -1.0, np.float32)
    for k, v in (desired_by_code or {}).items():
        desired[k] = v
    feas = np.zeros(n, bool)
    feas[node_i] = True
    req = SelectRequest(
        ask=np.array([10, 10, 0, 0], np.float32), count=1,
        feasible=feas,
        capacity=np.full((n, 4), 1e6, np.float32),
        used=np.zeros((n, 4), np.float32),
        desired_count=10.0,
        tg_collisions=np.zeros(n, np.int32),
        job_count=np.zeros(n, np.int32),
        spreads=[dict(codes=np.asarray(codes, np.int32), counts=c,
                      present=present, desired=desired,
                      weight=float(weight), has_targets=has_targets)],
        sum_spread_weights=float(sum_w))
    res = SelectKernel(device="cpu").select(req)
    assert res.node_idx[0] == node_i
    return float(res.scores["allocation-spread"][0])


def test_spread_targeted_golden():
    """spread_test.go TestSpreadIterator_SingleAttribute: count=10,
    target dc1=80%% (desired 8, implicit dc2 desired 2), two existing
    allocs in dc1 -> dc1 node scores 0.625, dc2 node 0.5."""
    codes = [0, 1, 0, 0]          # dc1, dc2, dc1, dc1
    counts = {0: 2}               # two existing allocs in dc1
    desired = {0: 8.0, 1: 2.0}
    s_dc1 = _spread_component(codes, counts, desired, 100, 100, True, 0, 4)
    s_dc2 = _spread_component(codes, counts, desired, 100, 100, True, 1, 4)
    assert s_dc1 == pytest.approx(0.625, abs=1e-6)
    assert s_dc2 == pytest.approx(0.5, abs=1e-6)


def test_spread_multi_attribute_golden():
    """spread_test.go TestSpreadIterator_MultipleAttributes: dc spread
    (w=100, dc1=60%%, dc2=40%%) + rack spread (w=50, r1=40%%, r2=60%%),
    count=10, allocs on nodes 0 (dc1/r1) and 2 (dc1/r2). Expected
    combined: n0 0.500, n1 0.667, n2 0.556, n3 0.556."""
    dcs = [0, 1, 0, 0]
    racks = [0, 0, 1, 1]
    n = 4
    expected = [0.500, 0.667, 0.556, 0.556]
    for i in range(n):
        dc_c = np.full(C_MAX + 1, 0.0, np.float32)
        dc_c[0] = 2.0             # two allocs in dc1
        dc_p = dc_c > 0
        dc_d = np.full(C_MAX + 1, -1.0, np.float32)
        dc_d[0], dc_d[1] = 6.0, 4.0
        r_c = np.full(C_MAX + 1, 0.0, np.float32)
        r_c[0], r_c[1] = 1.0, 1.0
        r_p = r_c > 0
        r_d = np.full(C_MAX + 1, -1.0, np.float32)
        r_d[0], r_d[1] = 4.0, 6.0
        feas = np.zeros(n, bool)
        feas[i] = True
        req = SelectRequest(
            ask=np.array([10, 10, 0, 0], np.float32), count=1,
            feasible=feas,
            capacity=np.full((n, 4), 1e6, np.float32),
            used=np.zeros((n, 4), np.float32),
            desired_count=10.0,
            tg_collisions=np.zeros(n, np.int32),
            job_count=np.zeros(n, np.int32),
            spreads=[
                dict(codes=np.asarray(dcs, np.int32), counts=dc_c,
                     present=dc_p, desired=dc_d, weight=100.0,
                     has_targets=True),
                dict(codes=np.asarray(racks, np.int32), counts=r_c,
                     present=r_p, desired=r_d, weight=50.0,
                     has_targets=True),
            ],
            sum_spread_weights=150.0)
        res = SelectKernel(device="cpu").select(req)
        got = float(res.scores["allocation-spread"][0])
        assert got == pytest.approx(expected[i], abs=5e-4), f"node {i}"


def test_spread_even_golden():
    """spread_test.go TestSpreadIterator_EvenSpread: no targets.
    Nothing placed -> all nodes score 0; after two allocs land in dc1,
    dc1 scores -1 and dc2 scores +1."""
    codes = [0, 1, 0, 0]
    s_empty = _spread_component(codes, {}, None, 100, 100, False, 0, 4)
    assert s_empty == pytest.approx(0.0, abs=1e-6)
    s_dc1 = _spread_component(codes, {0: 2}, None, 100, 100, False, 0, 4)
    s_dc2 = _spread_component(codes, {0: 2}, None, 100, 100, False, 1, 4)
    assert s_dc1 == pytest.approx(-1.0, abs=1e-6)
    assert s_dc2 == pytest.approx(1.0, abs=1e-6)


# -- Preemption behavior (preemption_test.go) ---------------------------
def _mk_candidate(prio, cpu, mem, node_id="n1"):
    from nomad_tpu_torch.models import AllocatedResources, AllocatedTaskResources
    from nomad_tpu_torch.models.resources import (AllocatedCpuResources,
                                                  AllocatedMemoryResources)
    from nomad_tpu_torch.utils.ids import generate_uuid
    a = mock.alloc()
    a.id = generate_uuid()
    a.node_id = node_id
    a.job = mock.job()
    a.job.priority = prio
    a.job_id = a.job.id
    tr = a.allocated_resources.tasks["web"]
    tr.cpu = AllocatedCpuResources(cpu)
    tr.memory = AllocatedMemoryResources(mem)
    tr.networks = []
    return a


def test_preemptor_picks_lowest_priority_first():
    """filterAndGroupPreemptibleAllocs: candidates grouped by priority
    ascending; lower priority evicted before higher."""
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.node()   # 4000/8192 minus 100/256 reserved
    low = _mk_candidate(20, 1900, 3900, node.id)
    high = _mk_candidate(40, 1900, 3900, node.id)
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([low, high])
    p.set_preemptions([])
    ask = ComparableResources(cpu_shares=1900, memory_mb=3900)
    victims = p.preempt_for_task_group(ask)
    assert victims is not None
    assert [v.id for v in victims] == [low.id]


def test_preemptor_respects_priority_delta():
    """Only allocs with priority <= job priority - 10 are preemptible."""
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.node()
    close = _mk_candidate(75, 3000, 6000, node.id)   # delta < 10
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([close])
    p.set_preemptions([])
    ask = ComparableResources(cpu_shares=3000, memory_mb=6000)
    assert p.preempt_for_task_group(ask) is None


def test_preemptor_distance_prefers_closest_victim():
    """basicResourceDistance: the victim whose resources are closest to
    the needed ask is chosen over a bigger-than-needed one."""
    from nomad_tpu_torch.scheduler.preemption import Preemptor
    node = mock.node()
    # fill the node so nothing fits without eviction
    big = _mk_candidate(20, 3000, 6000, node.id)
    close = _mk_candidate(20, 1000, 2000, node.id)
    p = Preemptor(80, "default", "the-job")
    p.set_node(node)
    p.set_candidates([big, close])
    p.set_preemptions([])
    ask = ComparableResources(cpu_shares=900, memory_mb=1800)
    victims = p.preempt_for_task_group(ask)
    assert victims is not None
    assert victims[0].id == close.id


def test_preemption_score_logistic():
    """rank.go preemptionScore:773 — logistic with inflection at 2048."""
    from nomad_tpu_torch.scheduler.preemption import preemption_score
    assert preemption_score(2048.0) == pytest.approx(0.5)
    assert preemption_score(0.0) > 0.99
    assert preemption_score(4096.0) < 0.01
