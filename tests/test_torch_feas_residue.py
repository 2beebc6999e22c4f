"""The reference's residue-feasibility and vectorized-spread tests
(tests/test_feas_residue.py) against the port, their assertions
unchanged, on the CPU.

Residue-compiled feasibility + vectorized spread/distinct scoring: the
vectorized input builds must be BIT-IDENTICAL to their scalar twins
(1k-seed randomized parity), the device mask token must survive
CSI/preferred-node residue mutations as a sparse scatter, and the
scalar paths must place identically.

The port has no switch that turns its residue and vectorized paths off,
so the reference's tests that compared the two arms through
NOMAD_TPU_FEAS_RESIDUE (test_property_counts_vec_parity_1k_seeds,
test_end_to_end_on_off_parity_with_csi_churn,
test_distinct_fold_single_placement_parity,
test_kill_switch_degenerates_to_scalar) compare across the packages: the
same seeded fleet built in each, the port's vectorized arm against the
JAX package's scalar arm, the switch set on the JAX side only and
restored after.
"""

import contextlib
import copy
import importlib
import os
from types import SimpleNamespace

import numpy as np

import test_torch_select  # noqa: F401  (torch's thread cap)


def _package(root: str) -> SimpleNamespace:
    """The modules a scenario is built from, in one package."""
    m = importlib.import_module
    harness = m(f"{root}.scheduler.harness").Harness
    return SimpleNamespace(
        mock=m(f"{root}.mock"), models=m(f"{root}.models"),
        csi=m(f"{root}.models.csi"), job=m(f"{root}.models.job"),
        spread_ops=m(f"{root}.ops.spread"),
        ProposedIndex=m(f"{root}.ops.tables").ProposedIndex,
        fc=m(f"{root}.scheduler.feasible_compiler"),
        generate_uuid=m(f"{root}.utils.ids").generate_uuid,
        Harness=((lambda: harness(device="cpu"))
                 if root == "nomad_tpu_torch" else harness))


PORT = _package("nomad_tpu_torch")
JAX = _package("nomad_tpu")

RACKS = [f"r{i}" for i in range(7)]
TIERS = ["gold", "silver", "bronze"]
ATTRS = ("${meta.rack}", "${meta.tier}", "${node.datacenter}",
         "${node.class}")


@contextlib.contextmanager
def _jax_scalar():
    """The JAX package's scalar arm for the block: its residue switch
    off, the environment restored after. The port reads no switch."""
    env = JAX.fc.ENV_RESIDUE
    prev = os.environ.get(env)
    os.environ[env] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = prev


def _eval_for(job, pkg=PORT):
    models = pkg.models
    return models.Evaluation(
        id=pkg.generate_uuid(), namespace=job.namespace,
        priority=job.priority,
        triggered_by=models.TRIGGER_JOB_REGISTER, job_id=job.id,
        status=models.EVAL_STATUS_PENDING, type=job.type)


def _fleet(n=48, seed=7, pkg=PORT):
    rng = np.random.default_rng(seed)
    h = pkg.Harness()
    nodes = []
    for i in range(n):
        node = pkg.mock.node()
        # deterministic ids: row order and argmax tie-breaks depend on
        # them, and the on/off arms must see the SAME fleet
        node.id = f"00000000-0000-4000-8000-{i:012d}"
        node.name = f"node-{i}"
        node.datacenter = f"dc{(i % 3) + 1}"
        node.meta["rack"] = RACKS[int(rng.integers(len(RACKS)))]
        # some nodes miss the tier attribute entirely: the missing
        # bucket must round-trip the vectorized encode too
        if rng.random() > 0.2:
            node.meta["tier"] = TIERS[int(rng.integers(len(TIERS)))]
        node.attributes["csi.plugin.p1"] = "1"
        node.compute_class()
        nodes.append(node)
        h.store.upsert_node(h.next_index(), node)
    return h, nodes


# -- 1k-seed parity: dictionary encoding off the interned columns ------

def test_attr_codes_vec_parity_1k_seeds():
    """_interned_codes must reproduce NodeTable.attr_codes'
    first-encounter-order numbering EXACTLY — codes array and values
    list — across randomized attribute churn (mutations, deletions,
    new values) on every interned target."""
    spread_ops = PORT.spread_ops
    h, nodes = _fleet()
    rng = np.random.default_rng(123)
    checked = 0
    for round_ in range(250):
        # mutate one node: rotate its rack, maybe drop/restore tier
        node = copy.deepcopy(
            h.store.node_by_id(nodes[int(rng.integers(len(nodes)))].id))
        node.meta["rack"] = RACKS[int(rng.integers(len(RACKS)))]
        if rng.random() < 0.3:
            node.meta.pop("tier", None)
        else:
            node.meta["tier"] = TIERS[int(rng.integers(len(TIERS)))]
        h.store.upsert_node(h.next_index(), node)
        snap = h.store.snapshot()
        t = snap.node_table()
        for attr in ATTRS:
            built = spread_ops._interned_codes(t, attr, snap)
            assert built is not None, attr
            vcodes, vvalues = built
            t._attr_codes_cache.pop(attr, None)
            scodes, svalues = t.attr_codes(attr)
            assert vvalues == svalues, (attr, round_)
            assert np.array_equal(vcodes, scodes), (attr, round_)
            checked += 1
    assert checked == 1000


def test_property_counts_vec_parity_1k_seeds():
    """property_counts_vec (one gather + np.add.at) must match the
    per-alloc scalar walk bit-for-bit over randomized proposed-alloc
    sets — counts AND present, with and without a task-group scope,
    including allocs on missing-attribute nodes. The scalar walk is the
    JAX package's, on the same fleet."""
    tables, jobs = {}, {}
    for pkg in (PORT, JAX):
        h, _nodes = _fleet(pkg=pkg)
        tables[pkg.mock] = h.store.snapshot().node_table()
        jobs[pkg.mock] = pkg.mock.job()
    rng = np.random.default_rng(42)

    class _Alloc:
        def __init__(self, tg):
            self.task_group = tg

    for seed in range(1000):
        pis = {pkg.mock: pkg.ProposedIndex(tables[pkg.mock],
                                           jobs[pkg.mock], [])
               for pkg in (PORT, JAX)}
        t = tables[PORT.mock]
        m = int(rng.integers(0, 12))
        for _ in range(m):
            row = int(rng.integers(t.n))
            alloc = _Alloc("web" if rng.random() < 0.6 else "db")
            for pi in pis.values():
                pi._count(row, alloc)
        attr = ATTRS[int(rng.integers(len(ATTRS)))]
        tg_name = [None, "web", "db"][int(rng.integers(3))]
        with _jax_scalar():
            _codes, values = tables[JAX.mock].attr_codes(attr)
            s_counts, s_present = pis[JAX.mock].property_counts(
                attr, values, tg_name)
        _codes, values = t.attr_codes(attr)
        v_counts, v_present = pis[PORT.mock].property_counts(
            attr, values, tg_name)
        assert v_counts.dtype == s_counts.dtype, seed
        assert np.array_equal(v_counts, s_counts), (seed, attr, tg_name)
        assert np.array_equal(v_present, s_present), (seed, attr, tg_name)


# -- end-to-end on/off parity with CSI churn ---------------------------

def _spread_job(i, source=None, count=2, distinct=True, pkg=PORT):
    models = pkg.models
    job = pkg.mock.job()
    job.id = f"sp-{i}"
    job.datacenters = ["dc1", "dc2", "dc3"]
    job.spreads = [models.Spread(
        attribute="${node.datacenter}", weight=70,
        spread_target=[models.SpreadTarget(value="dc1", percent=50),
                       models.SpreadTarget(value="dc2", percent=30)])]
    tg = job.task_groups[0]
    tg.count = count
    for task in tg.tasks:
        task.resources.networks = []
        task.resources.cpu = 20
        task.resources.memory_mb = 32
    tg.networks = []
    tg.spreads = [models.Spread(attribute="${meta.rack}", weight=30)]
    if distinct:
        tg.constraints.append(models.Constraint(
            ltarget="${meta.rack}", rtarget="4",
            operand="distinct_property"))
    if source is not None:
        tg.volumes = {"vol": pkg.job.VolumeRequest(
            name="vol", type="csi", source=source)}
    return job


def _run_wave(pkg):
    """The parity scenario: spreads + distinct_property + CSI volumes
    with claim churn, a single-writer volume exhausting its write cap
    mid-wave, and a node mutation between evals. Returns the placement
    trace (job -> sorted node names)."""
    csi = pkg.csi
    h, nodes = _fleet(n=24, seed=11, pkg=pkg)
    vols = [
        csi.CSIVolume(id="multi-vol", plugin_id="p1",
                      access_mode=csi.ACCESS_MULTI_NODE_MULTI_WRITER,
                      topology_node_ids=[n.id for j, n in enumerate(nodes)
                                         if j % 4 != 3]),
        csi.CSIVolume(id="solo-vol", plugin_id="p1",
                      access_mode=csi.ACCESS_SINGLE_NODE_WRITER),
    ]
    h.store.upsert_csi_volumes(h.next_index(), vols)
    trace = {}
    by_name = {n.id: n.name for n in nodes}
    for r in range(10):
        if r == 4:
            # claim churn mid-wave: release every claim on the
            # multi-writer volume so later rounds see fresh state
            v = h.store.csi_volume("default", "multi-vol")
            for aid in list(v.write_allocs):
                h.store.csi_volume_release(
                    h.next_index(), "default", "multi-vol", aid)
        node = copy.deepcopy(h.store.node_by_id(nodes[r % 24].id))
        node.meta["canary"] = f"c{r}"
        h.store.upsert_node(h.next_index(), node)
        # rounds 6+ hit the exhausted single-writer volume: the
        # write cap clamps the batch mid-wave (round 6 claims the
        # single slot, later rounds place zero)
        src = "solo-vol" if r >= 6 else "multi-vol"
        job = _spread_job(r, source=src, pkg=pkg)
        h.store.upsert_job(h.next_index(), job)
        h.process("service", _eval_for(job, pkg))
        placed = h.store.allocs_by_job("default", job.id)
        trace[job.id] = sorted(by_name[a.node_id] for a in placed)
    return trace


def test_end_to_end_on_off_parity_with_csi_churn():
    on = _run_wave(PORT)
    with _jax_scalar():
        off = _run_wave(JAX)
    assert on == off
    # the wave genuinely exercised the cap: the first solo-vol round
    # placed exactly the one write slot, the later ones none
    assert len(on["sp-6"]) == 1
    assert on["sp-7"] == [] and on["sp-8"] == [] and on["sp-9"] == []


def test_distinct_fold_single_placement_parity():
    """count==1 with distinct_hosts/distinct_property and no
    contending proposed alloc folds the kernel state to a plan-time
    verdict — same placements, distinct_folds counted."""
    results = {}
    for arm, pkg in ((True, PORT), (False, JAX)):
        with (contextlib.nullcontext() if arm else _jax_scalar()):
            h, nodes = _fleet(n=16, seed=3, pkg=pkg)
            pkg.spread_ops.reset_stats()
            job = _spread_job(0, count=1, pkg=pkg)
            job.constraints.append(
                pkg.models.Constraint(operand="distinct_hosts"))
            h.store.upsert_job(h.next_index(), job)
            h.process("service", _eval_for(job, pkg))
            placed = h.store.allocs_by_job("default", job.id)
            by_name = {n.id: n.name for n in nodes}
            results[arm] = sorted(by_name[a.node_id] for a in placed)
            if arm:
                assert pkg.spread_ops.STATS["distinct_folds"] > 0
    assert results[True] == results[False]
    assert len(results[True]) == 1


# -- token survival through real store mutations -----------------------

def test_token_survives_csi_residue():
    """A CSI job's per-eval mask mutation must ride the parked device
    mask as a sparse residue scatter — token kept, zero re-uploads —
    and a residue fold mid-stream must only cost a re-park, never a
    wrong verdict."""
    fc, csi = PORT.fc, PORT.csi
    h, nodes = _fleet(n=24, seed=5)
    vol = csi.CSIVolume(id="data-vol", plugin_id="p1",
                        access_mode=csi.ACCESS_MULTI_NODE_MULTI_WRITER,
                        topology_node_ids=[n.id for j, n in
                                           enumerate(nodes) if j % 3])
    h.store.upsert_csi_volumes(h.next_index(), [vol])
    # warm: compile, park the combined mask, establish the token
    for i in (100, 101):
        w = _spread_job(i, source="data-vol")
        h.store.upsert_job(h.next_index(), w)
        h.process("service", _eval_for(w))
    fc.reset_stats()
    feas = h.store.table_cache.device.feas
    up0 = feas.stats["uploads"]
    rs0 = feas.stats["residue_scatters"]
    for r in range(4):
        job = _spread_job(r, source="data-vol")
        h.store.upsert_job(h.next_index(), job)
        h.process("service", _eval_for(job))
        assert h.store.allocs_by_job("default", job.id)
    st = fc.stats()
    assert st["token_survivals"] >= 4, st
    assert st["token_invalidations"] == 0, st
    assert st["residue_rows"] > 0, st
    if feas.snapshot()["entries"]:
        # masks actually parked on a device: survival must have
        # shipped scatters, not re-uploads
        assert feas.stats["residue_scatters"] > rs0
        assert feas.stats["uploads"] == up0
        assert feas.debt() > 0
        # governor reclaim mid-stream: fold drops parked entries
        # and zeroes the debt; the next eval re-parks and places
        # identically
        dropped = feas.fold()
        assert dropped["residue_debt_cleared"] > 0
        assert feas.debt() == 0
    job = _spread_job(99, source="data-vol")
    h.store.upsert_job(h.next_index(), job)
    h.process("service", _eval_for(job))
    assert h.store.allocs_by_job("default", job.id)


def _kill_switch_wave(pkg):
    csi = pkg.csi
    h, nodes = _fleet(n=16, seed=9, pkg=pkg)
    vol = csi.CSIVolume(id="data-vol", plugin_id="p1",
                        access_mode=csi.ACCESS_MULTI_NODE_MULTI_WRITER)
    h.store.upsert_csi_volumes(h.next_index(), [vol])
    pkg.fc.reset_stats()
    pkg.spread_ops.reset_stats()
    by_name = {n.id: n.name for n in nodes}
    placed = {}
    for r in range(3):
        job = _spread_job(r, source="data-vol", pkg=pkg)
        h.store.upsert_job(h.next_index(), job)
        h.process("service", _eval_for(job, pkg))
        assert h.store.allocs_by_job("default", job.id)
        placed[job.id] = sorted(
            by_name[a.node_id]
            for a in h.store.allocs_by_job("default", job.id))
    return placed


def test_kill_switch_degenerates_to_scalar():
    """NOMAD_TPU_FEAS_RESIDUE=0 on the JAX side: no token ever survives
    a residue mutation (dense path), every spread input builds scalar,
    and the vectorized counters stay at zero. The port's run of the same
    scenario takes its vectorized path and places the same."""
    fc, spread_ops = JAX.fc, JAX.spread_ops
    with _jax_scalar():
        assert not fc.residue_enabled()
        assert not spread_ops.enabled()
        scalar = _kill_switch_wave(JAX)
        assert fc.stats()["token_survivals"] == 0
        assert spread_ops.STATS["vector_builds"] == 0
        assert spread_ops.STATS["scalar_builds"] > 0
        assert spread_ops.STATS["spread_score_evals"] == 0
    vector = _kill_switch_wave(PORT)
    assert PORT.spread_ops.STATS["vector_builds"] > 0
    assert PORT.spread_ops.STATS.get("scalar_builds", 0) == 0
    assert PORT.spread_ops.STATS["spread_score_evals"] > 0
    assert vector == scalar
