"""The port's run of tests/test_preemption_columnar.py: its tests and assertions
over nomad_tpu_torch, on the CPU (the kernels' plain versions).

Batched columnar preemption parity.

The columnar victim selector (`PreemptionRound._evaluate_columnar`)
must be BIT-identical to the per-node reference Preemptor: victim
sets AND their order, scores, the logistic column, the freed vectors,
and the plan's node_preemptions through the full scheduler. The float
op order in the vectorized pipeline deliberately mirrors the scalar
one, so equality here is exact (np.array_equal / ==), never approx.

The port has no switch that turns its columnar path off, so the
reference's tests that compared its two paths through
NOMAD_TPU_COLUMNAR_PREEMPT
(test_randomized_columnar_reference_parity_1k_seeds,
test_parity_with_staged_preemptions, test_kill_switch_forces_reference,
test_escape_hatch_e2e_equivalence) compare across the packages: the same
seeded scenario built in each, the port's columnar round against the JAX
package's per-node reference path, the switch set on the JAX side only
and restored after. test_governor_gauges_and_watermark_reclaim waits for
the port of server/core.py.
"""

import contextlib
import os
import random
from functools import partial
from types import SimpleNamespace

import numpy as np

from nomad_tpu_torch import mock
from nomad_tpu_torch.models import SchedulerConfiguration
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.models.job import MigrateStrategy
from nomad_tpu_torch.models.plan import Plan
from nomad_tpu_torch.models.scheduler_config import PreemptionConfig
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.scheduler import preemption as pmod
from nomad_tpu_torch.scheduler.preemption import PreemptionRound
from nomad_tpu_torch.state.store import StateStore

from nomad_tpu import mock as jmock
from nomad_tpu.models import SchedulerConfiguration as JSchedulerConfiguration
from nomad_tpu.models.evaluation import Evaluation as JEvaluation
from nomad_tpu.models.job import MigrateStrategy as JMigrateStrategy
from nomad_tpu.models.plan import Plan as JPlan
from nomad_tpu.models.scheduler_config import \
    PreemptionConfig as JPreemptionConfig
from nomad_tpu.scheduler import Harness as JHarness
from nomad_tpu.scheduler.preemption import \
    PreemptionRound as JPreemptionRound
from nomad_tpu.state.store import StateStore as JStateStore

import test_torch_select  # noqa: F401  (torch's thread cap)

# what a scenario and a round are built from, in each package
PORT = SimpleNamespace(mock=mock, StateStore=StateStore,
                       MigrateStrategy=MigrateStrategy, Plan=Plan,
                       PreemptionRound=PreemptionRound,
                       SchedulerConfiguration=SchedulerConfiguration,
                       PreemptionConfig=PreemptionConfig,
                       Evaluation=Evaluation,
                       Harness=partial(Harness, device="cpu"))
JAX = SimpleNamespace(mock=jmock, StateStore=JStateStore,
                      MigrateStrategy=JMigrateStrategy, Plan=JPlan,
                      PreemptionRound=JPreemptionRound,
                      SchedulerConfiguration=JSchedulerConfiguration,
                      PreemptionConfig=JPreemptionConfig,
                      Evaluation=JEvaluation, Harness=JHarness)
SWITCH = "NOMAD_TPU_COLUMNAR_PREEMPT"


@contextlib.contextmanager
def _jax_scalar():
    """The JAX package's per-node reference path for the block: its
    switch off, the environment restored after. The port reads no
    switch."""
    prev = os.environ.get(SWITCH)
    os.environ[SWITCH] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(SWITCH, None)
        else:
            os.environ[SWITCH] = prev


def _mk_alloc(job, node_id, cpu, mem, disk=0, pkg=PORT):
    a = pkg.mock.alloc()
    a.job = job
    a.job_id = job.id
    a.namespace = job.namespace
    a.node_id = node_id
    a.task_group = job.task_groups[0].name
    tr = a.allocated_resources.tasks["web"]
    tr.cpu.cpu_shares = cpu
    tr.memory.memory_mb = mem
    tr.networks = []
    if disk:
        a.allocated_resources.shared.disk_mb = disk
    return a


def _scenario(seed: int, pkg=PORT):
    """Random node fleet + mixed-priority allocs + a placing job,
    fully seeded (mock ids included — mock.seeded_mock_ids), so the
    same seed builds the same scenario in either package."""
    with pkg.mock.seeded_mock_ids(seed):
        return _build_scenario(seed, pkg)


def _build_scenario(seed: int, pkg=PORT):
    mock, MigrateStrategy = pkg.mock, pkg.MigrateStrategy
    rng = random.Random(seed)
    store = pkg.StateStore()
    idx = 1
    nodes = [mock.node() for _ in range(rng.randint(2, 10))]
    for n in nodes:
        store.upsert_node(idx, n)
        idx += 1
    jobs = []
    for _ in range(rng.randint(1, 4)):
        j = mock.job()
        j.priority = rng.choice([10, 20, 30, 40, 45, 50])
        if rng.random() < 0.3:
            # max_parallel-bearing groups exercise the crowding
            # penalty AND the mp-group cache exclusion
            j.task_groups[0].migrate = MigrateStrategy(
                max_parallel=rng.randint(1, 2))
        store.upsert_job(idx, j)
        idx += 1
        jobs.append(j)
    placing = mock.job()
    placing.priority = rng.choice([55, 70, 90])
    store.upsert_job(idx, placing)
    idx += 1
    allocs = []
    for n in nodes:
        for _ in range(rng.randint(0, 5)):
            j = rng.choice(jobs + [placing])   # own-job rows ride along
            allocs.append(_mk_alloc(
                j, n.id,
                rng.choice([200, 500, 1000, 1500, 2500]),
                rng.choice([256, 512, 1024, 4000]),
                disk=rng.choice([0, 0, 300]), pkg=pkg))
    if allocs:
        store.upsert_allocs(idx, allocs)
        idx += 1
    snap = store.snapshot()
    table = snap.node_table()
    mask = np.ones(table.n, bool)
    ask = np.array([rng.choice([500, 1000, 2000, 3500]),
                    rng.choice([512, 1024, 4000, 7000]),
                    rng.choice([0, 0, 200]), 0], np.float32)
    return snap, table, mask, ask, placing


def _run_round(sc, columnar: bool, stage_preempt=None):
    """One round over `sc`: the port's columnar path, or with `columnar`
    False the JAX package's per-node path over a JAX scenario (the staged
    victims taken by id from its own store)."""
    pkg = PORT if columnar else JAX
    snap, table, mask, ask, job = sc
    table.preempt_cache.clear()
    plan = pkg.Plan(job=job, eval_id="e1")
    if stage_preempt is not None:
        for v in stage_preempt:
            plan.append_preempted_alloc(snap.alloc_by_id(v.id), "")
    with (contextlib.nullcontext() if columnar else _jax_scalar()):
        r = pkg.PreemptionRound(snap, table, mask, ask, job, plan)
    assert r._columnar == columnar
    used = table.base_used.copy()
    pre_score, freed_cols = r.columns(used)
    fp = r.find_placement(used)
    victims = {i: [a.id for a in v] for i, v in r._victims.items()}
    return {
        "pre_score": pre_score,
        "freed_cols": freed_cols,
        "scores": r._scores.copy(),
        "logistic": r._logistic.copy(),
        "freed": r._freed.copy(),
        "victims": victims,
        "mp_groups": dict(r._mp_groups),
        "fp": (None if fp is None
               else (fp[0], [a.id for a in fp[1]], fp[2])),
    }


def _assert_equal(a, b, seed):
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), (seed, key, x, y)
        else:
            assert x == y, (seed, key, x, y)


def test_randomized_columnar_reference_parity_1k_seeds():
    """Victims (sets AND order), scores, logistic, freed — exactly
    equal across 1000 random scenarios."""
    with_victims = 0
    for seed in range(1000):
        sc = _scenario(seed)
        a = _run_round(sc, True)
        b = _run_round(_scenario(seed, JAX), False)
        if a["victims"]:
            with_victims += 1
        _assert_equal(a, b, seed)
    # the generator must actually exercise selection, not just fail
    assert with_victims > 500


def test_parity_with_staged_preemptions():
    """Plan-staged victims drive set_preemptions' crowding counts;
    the columnar penalty column must read the same counts."""
    checked = 0
    for seed in range(120):
        sc = _scenario(seed)
        snap, table, mask, ask, job = sc
        # stage some other node's allocs as already-preempted
        pool = [a for n in table.nodes
                for a in snap.allocs_by_node(n.id)]
        if not pool:
            continue
        rng = random.Random(seed + 7)
        staged = rng.sample(pool, min(2, len(pool)))
        a = _run_round(sc, True, stage_preempt=staged)
        b = _run_round(_scenario(seed, JAX), False, stage_preempt=staged)
        _assert_equal(a, b, seed)
        checked += 1
    assert checked > 100


def test_dirty_row_invalidation_matches_fresh_round():
    """After plan mutations between columns() calls, the dirty-row
    re-evaluation must land exactly where a fresh round would."""
    for seed in range(60):
        sc = _scenario(seed)
        snap, table, mask, ask, job = sc
        table.preempt_cache.clear()
        plan = Plan(job=job, eval_id="e1")
        r = PreemptionRound(snap, table, mask, ask, job, plan)
        used = table.base_used.copy()
        r.columns(used)
        if not r._victims:
            continue
        # mutate plan state touching the first victim node (staged
        # preemption changes both the node signature and the global
        # max_parallel counts)
        idx = next(iter(r._victims))
        for v in r._victims[idx]:
            plan.append_preempted_alloc(v, "")
        ps2, fr2 = r.columns(used)
        # a fresh round over the SAME mutated plan must agree exactly
        table.preempt_cache.clear()
        fresh = PreemptionRound(snap, table, mask, ask, job, plan)
        ps3, fr3 = fresh.columns(used)
        assert np.array_equal(ps2, ps3), seed
        assert np.array_equal(fr2, fr3), seed
        return


def test_victim_cache_cross_round_parity_and_hit_accounting():
    """A second round over an unchanged table serves memo hits with
    identical outputs, and the hit counters move."""
    sc = _scenario(3)
    snap, table, mask, ask, job = sc
    table.preempt_cache.clear()
    used = table.base_used.copy()
    r1 = PreemptionRound(snap, table, mask, ask, job,
                         Plan(job=job, eval_id="e1"))
    ps1, fr1 = r1.columns(used)
    hits0 = pmod.PREEMPT_STATS["cache_hits"]
    r2 = PreemptionRound(snap, table, mask, ask, job,
                         Plan(job=job, eval_id="e2"))
    ps2, fr2 = r2.columns(used)
    assert np.array_equal(ps1, ps2)
    assert np.array_equal(fr1, fr2)
    if table.preempt_cache:
        assert pmod.PREEMPT_STATS["cache_hits"] > hits0
    # victims served from cache are equal per node
    for i, v in r1._victims.items():
        assert [a.id for a in r2._victims[i]] == [a.id for a in v]


def test_cache_max_bound_clears(monkeypatch):
    sc = _scenario(5)
    snap, table, mask, ask, job = sc
    table.preempt_cache.clear()
    monkeypatch.setattr(pmod, "CACHE_MAX", 0)
    clears0 = pmod.PREEMPT_STATS["cache_clears"]
    r = PreemptionRound(snap, table, mask, ask, job,
                        Plan(job=job, eval_id="e1"))
    r.columns(table.base_used.copy())
    if r._victims:
        assert pmod.PREEMPT_STATS["cache_clears"] > clears0
        assert len(table.preempt_cache) <= 1


def test_rows_max_overflow_falls_back_per_node(monkeypatch):
    """A node whose eligible candidate set overflows preempt_rows_max
    takes the reference path — outputs identical either way."""
    sc = _scenario(11)
    a = _run_round(sc, True)
    monkeypatch.setattr(pmod, "ROWS_MAX", 1)
    fb0 = pmod.PREEMPT_STATS["fallback_nodes"]
    b = _run_round(sc, True)
    _assert_equal(a, b, "rows_max")
    assert pmod.PREEMPT_STATS["fallback_nodes"] >= fb0


def test_device_ask_keeps_reference_path():
    """A tg with a device ask flags the round fallback-only (the
    PreemptForDevice variant walks instance tables per alloc)."""
    from nomad_tpu_torch.models.resources import RequestedDevice

    sc = _scenario(2)
    snap, table, mask, ask, job = sc
    job.task_groups[0].tasks[0].resources.devices = [
        RequestedDevice(name="gpu", count=1)]
    r = PreemptionRound(snap, table, mask, ask, job,
                        Plan(job=job, eval_id="e1"),
                        tg=job.task_groups[0])
    assert not r._columnar


def test_network_ask_keeps_reference_path():
    """Reserved-port and bandwidth asks flag the round fallback-only
    (the PreemptForNetwork variant)."""
    from nomad_tpu_torch.models.networks import NetworkResource, Port

    sc = _scenario(4)
    snap, table, mask, ask, job = sc
    tg = job.task_groups[0]
    tg.networks = [NetworkResource(reserved_ports=[Port(value=8080)])]
    r = PreemptionRound(snap, table, mask, ask, job,
                        Plan(job=job, eval_id="e1"), tg=tg)
    assert not r._columnar
    # bandwidth dimension alone (no reserved ports) also falls back
    tg.networks = []
    ask_mb = ask.copy()
    ask_mb[3] = 100.0
    r2 = PreemptionRound(snap, table, mask, ask_mb, job,
                         Plan(job=job, eval_id="e2"), tg=tg)
    assert not r2._columnar


def test_kill_switch_forces_reference():
    """The JAX package's switch forces its reference path; the port's
    round over the same scenario is columnar, with the same outputs."""
    snap, table, mask, ask, job = _scenario(6, JAX)
    with _jax_scalar():
        r = JPreemptionRound(snap, table, mask, ask, job,
                             JPlan(job=job, eval_id="e1"))
    assert not r._columnar
    snap, table, mask, ask, job = _scenario(6)
    r2 = PreemptionRound(snap, table, mask, ask, job,
                         Plan(job=job, eval_id="e2"))
    assert r2._columnar
    _assert_equal(_run_round(_scenario(6), True),
                  _run_round(_scenario(6, JAX), False), 6)


def test_preempt_stage_reports_with_attrs():
    """The preempt stage fires around the selection pass with
    nodes-scanned / victim-count attrs (the flight-recorder hook sees
    them)."""
    from nomad_tpu_torch.utils import stages

    sc = _scenario(8)
    snap, table, mask, ask, job = sc
    table.preempt_cache.clear()
    seen = []
    stages.set_trace_hook(
        lambda st, sec, attrs: seen.append((st, sec, attrs)))
    try:
        stages.enable()
        r = PreemptionRound(snap, table, mask, ask, job,
                            Plan(job=job, eval_id="e1"))
        r.columns(table.base_used.copy())
    finally:
        stages.disable()
        stages.set_trace_hook(None)
    pre = [x for x in seen if x[0] == "preempt"]
    assert pre, seen
    attrs = pre[0][2]
    assert attrs["nodes_scanned"] > 0
    assert "victims" in attrs
    snap_stages = stages.snapshot()
    assert snap_stages["preempt"]["calls"] > 0


def test_escape_hatch_e2e_equivalence():
    """The full service scheduler path — kernel competition columns,
    victim staging, plan node_preemptions — is identical with the
    port's columnar engine and the JAX package's engine off."""

    def build(pkg=PORT):
        mock = pkg.mock
        h = pkg.Harness()
        Ev = pkg.Evaluation
        h.store.set_scheduler_config(
            h.next_index(),
            pkg.SchedulerConfiguration(
                preemption_config=pkg.PreemptionConfig(
                    service_scheduler_enabled=True,
                    batch_scheduler_enabled=True,
                    system_scheduler_enabled=True)))
        nodes = []
        for i in range(8):
            n = mock.node()
            n.name = f"node-{i}"
            nodes.append(n)
            h.store.upsert_node(h.next_index(), n)
        lo = mock.batch_job()
        lo.priority = 20
        lo.task_groups[0].count = 8
        lo.task_groups[0].tasks[0].resources.cpu = 3300
        lo.task_groups[0].tasks[0].resources.memory_mb = 6000
        h.store.upsert_job(h.next_index(), lo)
        ev = Ev(job_id=lo.id, namespace=lo.namespace,
                        type="batch", priority=lo.priority,
                        triggered_by="job-register")
        h.process("batch", ev)
        hi = mock.job()
        hi.priority = 80
        tg = hi.task_groups[0]
        tg.count = 4
        tg.networks = []
        for t in tg.tasks:
            t.resources.networks = []
            t.resources.cpu = 2000
            t.resources.memory_mb = 4000
        h.store.upsert_job(h.next_index(), hi)
        ev2 = Ev(job_id=hi.id, namespace=hi.namespace,
                         type="service", priority=hi.priority,
                         triggered_by="job-register")
        h.process("service", ev2)
        return h.plans[-1]

    plan_on = build()
    with _jax_scalar():
        plan_off = build(JAX)
    on_p = sorted(len(v) for v in plan_on.node_preemptions.values())
    off_p = sorted(len(v) for v in plan_off.node_preemptions.values())
    assert on_p == off_p
    assert sum(len(v) for v in plan_on.node_allocation.values()) == \
        sum(len(v) for v in plan_off.node_allocation.values())
    assert sum(on_p) == 4      # every placement had to evict
