"""The port's eval gateways (nomad_tpu_torch/server/worker.py) and its
dispatch cost model, on the CPU.

The port's versions of the JAX package's gateway tests
(tests/test_batch_worker.py, the deterministic tests of
tests/test_microbatch.py and its DispatchCostModel tests that need no
Server), each on SelectKernel("cpu"); a concurrent-gateway parity test over
100 seeds against the JAX package's solo select (node choices identical,
scores within rtol=atol=1e-6 as in tests/test_torch_select.py); and the
slice end to end: three groups of evals on one snapshot of a 200-node
cluster as lanes of the port's BatchGateway — service jobs (chunked-
batched), spread jobs (scan-batched), batch jobs of count 600 (K-way-
batched) — placed as the JAX package's schedulers place the same evals
one by one.
"""

import threading
import time

import numpy as np
import pytest

import nomad_tpu.ops.select as jsel
from nomad_tpu import mock
from nomad_tpu.models import (Affinity, EVAL_STATUS_PENDING, Evaluation,
                              Spread, SpreadTarget, TRIGGER_JOB_REGISTER)
from nomad_tpu.scheduler import new_scheduler as jax_new_scheduler
from nomad_tpu.scheduler.harness import Harness
from nomad_tpu.utils.codec import to_wire
from nomad_tpu.utils.ids import generate_uuid
from nomad_tpu_torch import models as tmodels
from nomad_tpu_torch.mock import fixtures as tmodels_mock
from nomad_tpu_torch.ops import select as select_mod
from nomad_tpu_torch.ops.select import (DispatchCostModel, SelectKernel,
                                        SelectRequest, calibrate_cost_model)
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.scheduler.harness import Harness as TorchHarness
from nomad_tpu_torch.server import BatchGateway, MicroBatchGateway
from nomad_tpu_torch.state.carry import store_from_wire
from nomad_tpu_torch.utils import metrics, stages
from nomad_tpu_torch.utils.codec import from_wire

CAP_ROW = np.array([[4000.0, 8192.0, 102400.0, 1000.0]], np.float32)
RTOL = ATOL = 1e-6


def _mk_req(capacity, count=4, ask=None, used=None, spreads=None,
            cls=SelectRequest):
    n = capacity.shape[0]
    if used is None:
        used = np.zeros_like(capacity)
    return cls(
        ask=np.asarray(ask if ask is not None
                       else [100.0, 100.0, 10.0, 0.0], np.float32),
        count=count, feasible=np.ones(n, dtype=bool),
        capacity=capacity, used=used, desired_count=float(count),
        tg_collisions=np.zeros(n, np.int32),
        job_count=np.zeros(n, np.int32),
        spreads=spreads or [])


class ForceBatchKernel:
    """Wraps the port's CPU kernel but pins the profitability answer so
    the trigger logic under test is deterministic."""

    def __init__(self, profitable=True):
        self.inner = SelectKernel("cpu")
        self.profitable = profitable
        self.select_calls = 0
        self.select_many_calls = []

    def select(self, req):
        self.select_calls += 1
        return self.inner.select(req)

    def select_many(self, reqs):
        self.select_many_calls.append(len(reqs))
        return self.inner.select_many(reqs)

    def batch_dispatch_profitable(self, n, tolerance=1.0):
        return self.profitable


def _streamingify(gw, gap=1e-5):
    """Force the arrival-rate model into 'streaming' so tests exercise
    the window instead of the idle fast path; `gap` also sets the
    straggler bound (STRAGGLER_GAPS * gap)."""
    gw._gap_ewma = gap
    gw._last_arrival = time.monotonic()


# -- BatchGateway --------------------------------------------------------

def test_batch_gateway_coalesces_concurrent_lanes():
    """Three lanes dispatching concurrently produce ONE select_many
    call, and each lane gets its own result back."""
    calls = []
    real = SelectKernel("cpu")

    class Spy:
        def select_many(self, reqs):
            calls.append(len(reqs))
            return real.select_many(reqs)

    capacity = np.tile(CAP_ROW, (64, 1))
    gw = BatchGateway(Spy(), lanes=3)
    out = {}

    def lane(i):
        try:
            out[i] = gw.dispatch(_mk_req(capacity, count=2 + i))
        finally:
            gw.lane_finished()

    threads = [threading.Thread(target=lane, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert sorted(out) == [0, 1, 2]
    assert out[0].placed == 2 and out[1].placed == 3 and out[2].placed == 4
    assert calls == [3]
    assert gw.stats == {"dispatches": 1, "batches": 1, "lanes_sum": 3}


def test_batch_gateway_barrier_shrinks_when_lane_dies_early():
    """A lane that finishes without dispatching must not wedge the
    others at the barrier."""
    capacity = np.tile(CAP_ROW, (64, 1))
    gw = BatchGateway(SelectKernel("cpu"), lanes=2)
    gw.lane_finished()
    res = gw.dispatch(_mk_req(capacity, count=1))
    assert res.placed == 1


def test_batch_gateway_surfaces_a_failure_in_every_lane():
    """A failed dispatch is not retried another way: each lane of the
    batch re-raises it."""
    class Broken:
        def select_many(self, reqs):
            raise RuntimeError("kernel launch failed")

    capacity = np.tile(CAP_ROW, (8, 1))
    gw = BatchGateway(Broken(), lanes=2)
    errors = []

    def lane():
        try:
            gw.dispatch(_mk_req(capacity, count=1))
        except RuntimeError as e:
            errors.append(str(e))
        finally:
            gw.lane_finished()

    threads = [threading.Thread(target=lane) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert errors == ["kernel launch failed"] * 2


def test_gateway_window_on_the_host_is_the_configured_one():
    """Only a kernel on the card sizes the windows from the measured
    round trip; on the host they are the configured ones."""
    assert BatchGateway(SelectKernel("cpu"), lanes=2).window_s == \
        BatchGateway.WINDOW_S
    gw = MicroBatchGateway(kernel=SelectKernel("cpu"), window_us=1234)
    assert gw.window_us() == pytest.approx(1234)


# -- MicroBatchGateway: deterministic triggers ---------------------------

def test_occupancy_trigger_fires_at_min_batch_while_engine_busy():
    n = 64
    cap = np.tile(CAP_ROW, (n, 1))
    release = threading.Event()

    class Blocking(ForceBatchKernel):
        def select(self, req):
            self.select_calls += 1
            release.wait(30)
            return self.inner.select(req)

    kernel = Blocking(profitable=True)
    gw = MicroBatchGateway(kernel=kernel, window_us=60_000_000,
                           min_batch=3, partition=False)
    outs = {}

    def first():
        outs["first"] = gw.dispatch(_mk_req(cap, count=1))

    t1 = threading.Thread(target=first)
    t1.start()
    deadline = time.monotonic() + 10
    while kernel.select_calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert kernel.select_calls == 1
    _streamingify(gw, gap=1.0)

    def lane(i):
        outs[i] = gw.dispatch(_mk_req(cap, count=2 + i))

    threads = [threading.Thread(target=lane, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(45)
    assert kernel.select_many_calls == [3]
    assert gw.stats["occupancy_dispatches"] == 1
    assert gw.stats["deadline_dispatches"] == 0
    assert gw.stats["batches"] == 1
    assert [outs[i].placed for i in range(3)] == [2, 3, 4]
    release.set()
    t1.join(30)
    assert outs["first"].placed == 1


def test_deadline_trigger_fires_partial_batch_after_window():
    cap = np.tile(CAP_ROW, (64, 1))
    kernel = ForceBatchKernel(profitable=True)
    gw = MicroBatchGateway(kernel=kernel, window_us=120_000,
                           min_batch=8, partition=False)
    _streamingify(gw, gap=0.05)
    t0 = time.monotonic()
    res = gw.dispatch(_mk_req(cap, count=3))
    waited = time.monotonic() - t0
    assert res.placed == 3
    assert gw.stats["deadline_dispatches"] == 1
    assert gw.stats["occupancy_dispatches"] == 0
    assert waited >= 0.1


def test_straggler_fires_within_a_few_arrival_gaps():
    cap = np.tile(CAP_ROW, (64, 1))
    kernel = ForceBatchKernel(profitable=True)
    gw = MicroBatchGateway(kernel=kernel, window_us=10_000_000,
                           min_batch=8, partition=False)
    _streamingify(gw, gap=0.005)
    t0 = time.monotonic()
    res = gw.dispatch(_mk_req(cap, count=2))
    waited = time.monotonic() - t0
    assert res.placed == 2
    assert waited < 5.0
    assert gw.stats["deadline_dispatches"] == 1


def test_idle_lane_dispatches_immediately():
    cap = np.tile(CAP_ROW, (64, 1))
    kernel = ForceBatchKernel(profitable=True)
    gw = MicroBatchGateway(kernel=kernel, window_us=500_000,
                           min_batch=4, partition=False)
    t0 = time.monotonic()
    res = gw.dispatch(_mk_req(cap, count=2))
    assert res.placed == 2
    assert time.monotonic() - t0 < 0.4
    assert gw.stats["immediate_dispatches"] == 1


def test_unprofitable_shape_dispatches_immediately_even_streaming():
    cap = np.tile(CAP_ROW, (64, 1))
    kernel = ForceBatchKernel(profitable=False)
    gw = MicroBatchGateway(kernel=kernel, window_us=500_000,
                           min_batch=4, partition=False)
    _streamingify(gw)
    t0 = time.monotonic()
    res = gw.dispatch(_mk_req(cap, count=2))
    assert res.placed == 2
    assert time.monotonic() - t0 < 0.4
    assert gw.stats["immediate_dispatches"] == 1


def test_drain_collects_requests_parked_behind_inflight_dispatch():
    cap = np.tile(CAP_ROW, (64, 1))
    release = threading.Event()

    class Blocking(ForceBatchKernel):
        def select(self, req):
            self.select_calls += 1
            release.wait(20)
            return self.inner.select(req)

    kernel = Blocking(profitable=True)
    gw = MicroBatchGateway(kernel=kernel, window_us=60_000_000,
                           min_batch=8, partition=False)
    outs = {}

    def first():
        outs["first"] = gw.dispatch(_mk_req(cap, count=1))

    t1 = threading.Thread(target=first)
    t1.start()
    deadline = time.monotonic() + 10
    while kernel.select_calls == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert kernel.select_calls == 1

    def parked(i):
        outs[i] = gw.dispatch(_mk_req(cap, count=2 + i))

    threads = [threading.Thread(target=parked, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    assert gw.stats["dispatches"] == 1
    release.set()
    t1.join(30)
    for t in threads:
        t.join(30)
    assert outs["first"].placed == 1
    assert outs[0].placed == 2 and outs[1].placed == 3
    assert gw.stats["drain_dispatches"] == 1
    assert kernel.select_many_calls == [2]


def test_window_widens_under_depth_and_decays_when_shallow():
    cap = np.tile(CAP_ROW, (64, 1))
    depth = {"v": 10_000}
    kernel = ForceBatchKernel(profitable=False)
    gw = MicroBatchGateway(kernel=kernel, window_us=1000, min_batch=4,
                           depth_fn=lambda: depth["v"], depth_high=512,
                           partition=False)
    base = gw.window_us()
    for _ in range(8):
        gw.dispatch(_mk_req(cap, count=1))
    assert gw.window_us() == pytest.approx(base * gw.SCALE_MAX)
    depth["v"] = 0
    for _ in range(24):
        gw.dispatch(_mk_req(cap, count=1))
    assert gw.window_us() == pytest.approx(base)


def test_reclaim_widens_window_up_to_its_bound():
    gw = MicroBatchGateway(kernel=ForceBatchKernel(), window_us=1000,
                           min_batch=4)
    base = gw.window_us()
    assert gw.widen_window() == {"window_us": pytest.approx(base * 2.0)}
    assert gw.window_us() == pytest.approx(base * 2.0)
    for _ in range(8):
        gw.widen_window()
    assert gw.window_us() == pytest.approx(base * gw.SCALE_MAX)


def test_gateway_wait_stage_reported():
    cap = np.tile(CAP_ROW, (64, 1))
    gw = MicroBatchGateway(kernel=ForceBatchKernel(profitable=True),
                           window_us=50_000, min_batch=8,
                           partition=False)
    _streamingify(gw, gap=0.02)
    stages.enable()
    try:
        gw.dispatch(_mk_req(cap, count=2))
        snap = stages.snapshot()
    finally:
        stages.disable()
    assert snap["gateway_wait"]["calls"] >= 1
    assert snap["gateway_wait"]["seconds"] >= 0.04


# -- the dispatch cost model ---------------------------------------------

def test_seeded_cost_model_engages_lanes_without_probe(monkeypatch):
    fresh = DispatchCostModel()
    monkeypatch.setattr(select_mod, "cost_model", fresh)
    k = SelectKernel("cpu")
    n = 2000
    n_pad = select_mod._pad_n(n)
    fresh.seed("chunked@cpu", n_pad, 0.004)
    fresh.seed("chunked_batched@cpu", n_pad, 0.002)
    for _ in range(3):
        assert k.batch_dispatch_profitable(n)
    fresh2 = DispatchCostModel()
    monkeypatch.setattr(select_mod, "cost_model", fresh2)
    fresh2.seed("chunked@cpu", n_pad, 0.002)
    fresh2.seed("chunked_batched@cpu", n_pad, 0.008)
    assert not k.batch_dispatch_profitable(n)
    fresh2._stats[("chunked_batched@cpu", n_pad)][0] = 0.0025
    assert k.batch_dispatch_profitable(n, tolerance=1.5)


def test_unmeasured_profitability_is_no_on_the_host(monkeypatch):
    """With nothing measured the host answers no (as the JAX package's
    CPU backend does); the card's answer is yes, every dispatch there
    being a kernel launch. The card's numbers never answer for the
    host."""
    fresh = DispatchCostModel()
    monkeypatch.setattr(select_mod, "cost_model", fresh)
    n_pad = select_mod._pad_n(500)
    fresh.seed("chunked", n_pad, 0.004)
    fresh.seed("chunked_batched", n_pad, 0.001)
    assert not SelectKernel("cpu").batch_dispatch_profitable(500)


def test_calibration_probe_seeds_both_arms(monkeypatch):
    fresh = DispatchCostModel()
    monkeypatch.setattr(select_mod, "cost_model", fresh)
    k = SelectKernel("cpu")
    snap = calibrate_cost_model(64, count=8, lanes=2, kernel=k)
    n_pad = select_mod._pad_n(64)
    assert fresh.best(["chunked@cpu"], n_pad) is not None
    assert fresh.best(["chunked_batched@cpu"], n_pad) is not None
    assert all(v["samples"] >= DispatchCostModel.MIN_SAMPLES
               for v in snap.values()), snap
    assert set(snap) == {"chunked@cpu@64", "chunked_batched@cpu@64"}


def test_compile_walls_never_enter_the_ewma():
    m = DispatchCostModel()
    m.observe("chunked_batched", 256, 5.0, lanes=2, compiled=True)
    assert m.estimate("chunked_batched", 256) is None
    assert ("chunked_batched", 256) not in m._stats
    for _ in range(3):
        m.observe("chunked_batched", 256, 0.004, lanes=2)
    assert m.estimate("chunked_batched", 256) == pytest.approx(0.002)


def test_cost_model_snapshot_load_round_trip_and_seeded_replace():
    m = DispatchCostModel()
    for _ in range(4):
        m.observe("chunked", 1024, 0.004)
        m.observe("chunked_batched", 1024, 0.006, lanes=2)
    snap = m.snapshot()
    m2 = DispatchCostModel()
    assert m2.load_snapshot(snap) == 2
    assert m2.estimate("chunked", 1024) == pytest.approx(
        m.estimate("chunked", 1024), rel=1e-4)
    m3 = DispatchCostModel()
    for _ in range(3):
        m3.observe("kway@cpu", 4096, 0.01)
    m4 = DispatchCostModel()
    m4.load_snapshot(m3.snapshot())
    assert m4.estimate("kway@cpu", 4096) == pytest.approx(0.01)
    m2.observe("chunked", 1024, 9.9)
    assert m2.estimate("chunked", 1024) == pytest.approx(0.004, rel=1e-3)
    m2.observe("chunked", 1024, 0.008)
    assert m2.estimate("chunked", 1024) > 0.004
    m5 = DispatchCostModel()
    m5.load_snapshot(m.snapshot())
    m5.observe("chunked", 1024, 9.9, compiled=True)
    assert m5.estimate("chunked", 1024) == pytest.approx(0.004, rel=1e-3)
    m5.observe("chunked", 1024, 0.008)
    assert m5.estimate("chunked", 1024) > 0.004
    assert DispatchCostModel().load_snapshot(
        {"nonsense": {"x": 1}, "chunked@bad": {"ewma_s": "?"}}) == 0


def test_every_arm_reports_to_the_cost_model(monkeypatch):
    """The solo arms report again, and each batched arm per lane."""
    fresh = DispatchCostModel()
    monkeypatch.setattr(select_mod, "cost_model", fresh)
    cap = np.tile(CAP_ROW, (64, 1))
    k = SelectKernel("cpu")
    spread = [dict(codes=np.arange(64, dtype=np.int32) % 4,
                   counts=np.zeros(5, np.float32),
                   present=np.zeros(5, bool),
                   desired=np.full(5, -1.0, np.float32), weight=50.0,
                   has_targets=False)]
    k.select(_mk_req(cap, count=3))
    k.select(_mk_req(cap, count=600, ask=[10.0, 10.0, 1.0, 0.0]))
    k.select(_mk_req(cap, count=3, spreads=spread))
    k.select_many([_mk_req(cap, count=3) for _ in range(2)])
    k.select_many([_mk_req(cap, count=3, spreads=spread) for _ in range(2)])
    k.select_many([_mk_req(cap, count=600, ask=[10.0, 10.0, 1.0, 0.0])
                   for _ in range(2)])
    assert sorted(a for a, _n in fresh._stats) == sorted(
        a + "@cpu" for a in select_mod.SOLO_ARMS + select_mod.BATCHED_ARMS)


# -- concurrent-gateway parity against the JAX package -------------------

def _same_result(want, got, tag):
    np.testing.assert_array_equal(got.node_idx, want.node_idx,
                                  err_msg=f"{tag} node_idx")
    np.testing.assert_allclose(got.final_score, want.final_score,
                               rtol=RTOL, atol=ATOL,
                               err_msg=f"{tag} final_score")
    for name, col in want.scores.items():
        np.testing.assert_allclose(got.scores[name], col, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag} {name}")
    assert got.placed == want.placed, tag


def test_concurrent_gateway_parity_100_seeds():
    """100 random shared-table request groups dispatched concurrently
    through the port's micro-batch gateway place as the JAX package's
    solo select places each request. Partitioning is off: it perturbs
    winners on purpose and is tested on its own."""
    n = 64
    kernel = ForceBatchKernel(profitable=True)
    base_cap = np.tile(CAP_ROW, (n, 1))
    ref = jsel.SelectKernel()
    for seed in range(100):
        rng = np.random.RandomState(seed)
        lanes = int(rng.randint(2, 5))
        capacity = (base_cap * rng.uniform(0.8, 1.2)).astype(np.float32)
        used = (capacity * rng.uniform(0.0, 0.4, size=capacity.shape)
                ).astype(np.float32)
        with_spread = seed % 4 == 0
        reqs, clones = [], []
        for _ in range(lanes):
            if with_spread:
                count = 16
                codes = rng.randint(0, 4, size=n).astype(np.int32)
                spreads = [dict(codes=codes,
                                counts=np.zeros(5, np.float32),
                                present=np.zeros(5, bool),
                                desired=np.full(5, -1.0, np.float32),
                                weight=50.0, has_targets=False)]
            else:
                count = int(rng.randint(1, 33))
                spreads = None
            ask = np.array([float(rng.randint(50, 400)),
                            float(rng.randint(50, 400)), 10.0, 0.0],
                           np.float32)
            reqs.append(_mk_req(capacity, count=count, ask=ask,
                                used=used.copy(), spreads=spreads))
            clones.append(_mk_req(capacity, count=count, ask=ask,
                                  used=used.copy(), spreads=spreads,
                                  cls=jsel.SelectRequest))
        gw = MicroBatchGateway(kernel=kernel, window_us=5_000_000,
                               min_batch=lanes, partition=False)
        _streamingify(gw)
        outs = {}

        def lane(i, req):
            outs[i] = gw.dispatch(req)

        threads = [threading.Thread(target=lane, args=(i, r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert sorted(outs) == list(range(lanes)), f"seed {seed}"
        for i, clone in enumerate(clones):
            _same_result(ref.select(clone), outs[i], f"seed {seed} lane {i}")
    assert sum(kernel.select_many_calls) > 100


# -- the slice end to end ------------------------------------------------

N_CLUSTER = 200
RACKS = 8


def _cluster():
    nodes = []
    for i in range(N_CLUSTER):
        node = mock.node()
        node.id = f"00000000-0000-4000-8000-{i:012d}"
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % RACKS}"
        node.compute_class()
        nodes.append(node)
    return nodes


def _groups():
    """(scheduler, job) lists: 4 service jobs of count 3, 3 spread jobs
    of count 8, 2 batch jobs of count 600."""
    service = []
    for i in range(4):
        job = mock.job()
        job.id = job.name = f"svc-{i}"
        job.task_groups[0].count = 3
        service.append(("service", job))
    spread = []
    for i in range(3):
        job = mock.job()
        job.id = job.name = f"spread-{i}"
        job.spreads = [Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[SpreadTarget(value="r1", percent=30),
                           SpreadTarget(value="r2", percent=20)])]
        job.affinities = [Affinity(ltarget="${meta.rack}", rtarget="r3",
                                   operand="=", weight=40)]
        job.task_groups[0].count = 8
        spread.append(("service", job))
    batch = []
    for i in range(2):
        job = mock.batch_job()
        job.id = job.name = f"batch-{i}"
        job.task_groups[0].count = 600
        for task in job.task_groups[0].tasks:
            task.resources.cpu = 20
            task.resources.memory_mb = 32
            task.resources.networks = []
        batch.append(("batch", job))
    return [("chunked_batched", service), ("scan_batched", spread),
            ("kway_batched", batch)]


def _eval(job):
    return Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
        status=EVAL_STATUS_PENDING, type=job.type)


def _placements(store, job_id, names):
    return sorted((a.name, names[a.node_id])
                  for a in store.allocs_by_job("default", job_id))


@pytest.fixture(scope="module")
def slice_runs():
    """Per group: the JAX package's placements (one eval at a time, each
    on the pre-taken snapshot), the port's (the group's evals as
    concurrent BatchGateway lanes on one snapshot), the port's eval
    statuses and the batch_dispatch counts of the port's group."""
    nodes = _cluster()
    names = {n.id: n.name for n in nodes}
    out = []
    for arm, group in _groups():
        jh = Harness()
        for n in nodes:
            jh.store.upsert_node(jh.next_index(), n)
        th = TorchHarness(store_from_wire([to_wire(n) for n in nodes], [],
                                          []), device="cpu")
        evs = []
        for _kind, job in group:
            ev = _eval(job)
            evs.append(ev)
            jh.store.upsert_job(jh.next_index(), job)
            th.store.upsert_job(th.next_index(),
                                from_wire(tmodels.Job, to_wire(job)))
        jsnap = jh.store.snapshot()
        for (kind, _job), ev in zip(group, evs):
            jax_new_scheduler(kind, jsnap, jh).process(ev)
        tsnap = th.store.snapshot()
        gw = BatchGateway(SelectKernel("cpu"), lanes=len(group),
                          partition=False)
        gw.window_s = 120.0          # fire at full width
        before = metrics.counter_totals().get(
            "nomad.select.batch_dispatch", 0.0)
        errors = []
        # a cost model of the group's own: its keys are the arms that ran
        costs, select_mod.cost_model = select_mod.cost_model, \
            DispatchCostModel()

        def lane(kind, ev):
            try:
                sched = new_scheduler(kind, tsnap, th)
                sched.kernel_dispatch = gw.dispatch
                sched.process(from_wire(tmodels.Evaluation, to_wire(ev)))
            except Exception as e:          # surfaces in the test
                errors.append(e)
            finally:
                gw.lane_finished()

        threads = [threading.Thread(target=lane, args=(kind, ev))
                   for (kind, _job), ev in zip(group, evs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        costs, select_mod.cost_model = select_mod.cost_model, costs
        dispatched = metrics.counter_totals().get(
            "nomad.select.batch_dispatch", 0.0) - before
        out.append(dict(
            arm=arm, errors=errors, stats=dict(gw.stats),
            arms_run={a for a, _n in costs._stats},
            batch_dispatch=dispatched,
            jax=[_placements(jh.store, j.id, names) for _k, j in group],
            port=[_placements(th.store, j.id, names) for _k, j in group],
            counts=[j.task_groups[0].count for _k, j in group],
            status=[e.status for e in th.evals]))
    return out


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["service-chunked-batched",
                              "spread-scan-batched", "batch-kway-batched"])
def test_slice_places_as_the_jax_package(slice_runs, which):
    run = slice_runs[which]
    assert run["errors"] == []
    assert run["status"] == ["complete"] * len(run["counts"])
    for jp, tp, count in zip(run["jax"], run["port"], run["counts"]):
        assert len(jp) == count
        assert tp == jp
    assert run["batch_dispatch"] >= 1
    assert run["stats"]["batches"] >= 1
    assert run["arm"] + "@cpu" in run["arms_run"]


# -- a sliced solo fire drops the feasibility token ----------------------

@pytest.mark.parametrize("lane,lanes", [(0, 2), (1, 2), (2, 3)])
def test_solo_slice_drops_the_live_feasibility_token(lane, lanes):
    """A request that carries a live feasibility token (its combined mask
    parked on the mirror) and is sliced by MicroBatchGateway._solo places
    only inside its decorrelation slice: the slice clears the token, so
    the kernel reads the sliced host mask and not the parked full one.
    The JAX package keeps the token there; the port departs on purpose."""
    th = TorchHarness(device="cpu")
    for i in range(64):
        node = tmodels_mock.node()
        node.name = f"node-{i}"
        th.store.upsert_node(th.next_index(), node)
    job = tmodels_mock.batch_job()
    job.task_groups[0].count = 256          # _solo slices from 256 on
    for task in job.task_groups[0].tasks:
        task.resources.cpu = 100
        task.resources.memory_mb = 64
        task.resources.networks = []
    th.store.upsert_job(th.next_index(), job)
    gw = MicroBatchGateway(kernel=SelectKernel("cpu"), window_us=1000)
    seen = []

    def dispatch(req):
        full = req.feasible.copy()
        token = req.feas_token
        res = gw.dispatch(req, decorrelate=(lane, lanes))
        seen.append((full, token, req.feas_token, res))
        return res

    sched = new_scheduler("batch", th.store.snapshot(), th)
    sched.kernel_dispatch = dispatch
    sched.process(tmodels.Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
        status=EVAL_STATUS_PENDING, type=job.type))
    assert len(seen) == 1
    full, token, after, res = seen[0]
    assert token is not None                # the mask was parked
    assert after is None                    # the slice dropped it
    probe = _mk_req(np.tile(CAP_ROW, (64, 1)), count=1)
    probe.feasible = full
    slice_mask, _ = select_mod.decorrelation_slice(probe, lane, lanes,
                                                   (None, None))
    assert slice_mask is not None and 8 <= slice_mask.sum() < full.sum()
    rows = res.node_idx[res.node_idx >= 0]
    assert res.placed == 256 and rows.size
    assert slice_mask[rows].all()
    assert len(th.store.allocs_by_job(job.namespace, job.id)) == 256
