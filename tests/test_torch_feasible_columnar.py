"""The reference's compiled-feasibility tests
(tests/test_feasible_columnar.py) against the port, their assertions
unchanged, on the CPU.

The contract under test: compiled masks over interned attribute
columns (scheduler/feasible_compiler.py + state/node_attr_index.py)
are BIT-IDENTICAL to the scalar checkConstraint reference
(ops/targets.constraint_mask) across the full operand set — including
missing-attribute, invalid-regex, and both-sides-interpolated
semantics — and the incremental index advanced through real store
mutations equals a fresh rebuild.

The port has no NOMAD_TPU_COLUMNAR_FEAS: test_kill_switch_e2e_equivalence
runs the port's engine against the JAX package's scalar reference (the
switch set on the JAX side only and restored after).
test_feas_mask_store_tokens is tests/test_torch_device_table.py's.
"""

import copy
import os
import random

import numpy as np
import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.mock import seeded_mock_ids
from nomad_tpu_torch.models import Constraint, TRIGGER_JOB_REGISTER
from nomad_tpu_torch.models.evaluation import Evaluation
from nomad_tpu_torch.ops.targets import TargetColumns, constraint_mask
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.scheduler import feasible_compiler as fc
from nomad_tpu_torch.state import node_attr_index as nai
from nomad_tpu_torch.state.store import StateStore

import test_torch_select  # noqa: F401  (torch's thread cap)

OPERANDS = ("=", "==", "is", "!=", "not", "<", "<=", ">", ">=",
            "version", "semver", "regexp", "set_contains",
            "set_contains_all", "set_contains_any", "is_set",
            "is_not_set", "bogus_operand")

LTARGETS = ("${attr.arch}", "${attr.ver}", "${meta.rack}",
            "${node.class}", "${node.datacenter}",
            "${node.unique.name}", "${attr.absent}", "${unknown.x}",
            "literal-left", "")

RTARGETS = ("amd64", "arm64", "r1", ">= 1.2.0", "~> 1.2", "1.2.3",
            "r[0-9]+", "(", "a,b", "amd64,arm64", "", "${attr.arch}",
            "${meta.rack}", "${attr.absent}", "linux")

ATTR_POOL = {"arch": ("amd64", "arm64", None),
             "ver": ("1.2.3", "1.10.0", "0.9", "not-a-version", None)}
META_POOL = {"rack": ("r1", "r2", "r15", None)}


def _rand_nodes(rng, n):
    nodes = []
    for _ in range(n):
        node = mock.node()
        for k, pool in ATTR_POOL.items():
            v = rng.choice(pool)
            if v is None:
                node.attributes.pop(k, None)
            else:
                node.attributes[k] = v
        for k, pool in META_POOL.items():
            v = rng.choice(pool)
            if v is None:
                node.meta.pop(k, None)
            else:
                node.meta[k] = v
        node.node_class = rng.choice(("", "c1", "c2"))
        node.datacenter = rng.choice(("dc1", "dc2"))
        nodes.append(node)
    return nodes


@pytest.mark.parametrize("chunk", range(10))
def test_parity_1k_seeds(chunk):
    """Compiled _cons_mask ≡ ops.targets.constraint_mask over random
    node sets and every operand/target combination, 100 seeds per
    chunk x 10 chunks = 1000 seeds. The index rows are built in node
    order, so index row space == TargetColumns row space and the masks
    compare directly."""
    for seed in range(chunk * 100, chunk * 100 + 100):
        rng = random.Random(seed)
        with seeded_mock_ids(seed):
            nodes = _rand_nodes(rng, rng.randint(3, 12))
        idx = nai.NodeAttrIndex(nodes, version=0)
        cols = TargetColumns(nodes)
        for _ in range(12):
            lt = rng.choice(LTARGETS)
            rt = rng.choice(RTARGETS)
            op = rng.choice(OPERANDS)
            got = fc._cons_mask(idx, None, lt, rt, op)
            assert got is not None, (seed, lt, rt, op)
            want = constraint_mask(cols, lt, rt, op)
            assert np.array_equal(got, want), \
                (seed, lt, rt, op, got, want)


def test_parity_row_twin_matches_reference():
    """The journal-replay scalar twin (_op_row) agrees with the
    reference mask row-for-row on the same random scenarios — this is
    the path a node UPDATE takes, so its semantics must be pinned to
    the same reference as the columnar build."""
    for seed in range(200):
        rng = random.Random(10_000 + seed)
        with seeded_mock_ids(seed):
            nodes = _rand_nodes(rng, 6)
        cols = TargetColumns(nodes)
        for _ in range(6):
            lt = rng.choice(LTARGETS)
            rt = rng.choice(RTARGETS)
            op = rng.choice(OPERANDS)
            want = constraint_mask(cols, lt, rt, op)
            prog_op = ("cons", lt, rt, op, "reason")
            got = [fc._op_row(node, prog_op) for node in nodes]
            if op in ("distinct_hosts", "distinct_property"):
                continue
            assert np.array_equal(np.array(got, dtype=bool), want), \
                (seed, lt, rt, op)


def test_intern_overflow_falls_back():
    """A column whose intern table outgrows the cap flags overflow and
    _cons_mask declines (the compiler then runs the scalar reference
    for that op)."""
    rng = random.Random(1)
    with seeded_mock_ids(1):
        nodes = _rand_nodes(rng, 8)
    for i, node in enumerate(nodes):
        node.attributes["uniq"] = f"value-{i}"
    idx = nai.NodeAttrIndex(nodes, version=0)
    prev = nai.INTERN_MAX_VALUES
    nai.INTERN_MAX_VALUES = 4
    try:
        assert fc._cons_mask(idx, None, "${attr.uniq}", "value-1",
                             "=") is None
        assert idx.columns["${attr.uniq}"].overflow
    finally:
        nai.INTERN_MAX_VALUES = prev


def _store_with_nodes(n):
    store = StateStore()
    index = 0
    nodes = []
    for i in range(n):
        index += 1
        node = mock.node()
        node.attributes["arch"] = "amd64" if i % 2 else "arm64"
        node.meta["rack"] = f"r{i % 3}"
        store.upsert_node(index, node)
        nodes.append(node)
    return store, nodes, index


COLS = ("${attr.arch}", "${meta.rack}", "${node.class}",
        "${node.datacenter}")


def _decoded(idx):
    """{column key: {node id: value-or-None}} — code-independent view,
    so an incremental index and a fresh rebuild compare even though
    their intern orders differ."""
    out = {}
    for key in COLS:
        col = idx.column(key)
        out[key] = {
            idx.ids[r]: (None if col.codes[r] == -1
                         else col.values[col.codes[r]])
            for r in range(idx.n)}
    return out


def test_incremental_equals_fresh_rebuild():
    """Register / attribute-update / deregister through the REAL store
    mutation path: the write-through index advanced by synced() decodes
    identically to an index rebuilt from scratch at every step."""
    with seeded_mock_ids(42):
        store, nodes, index = _store_with_nodes(12)
        cache = store.attr_index
        snap = store.snapshot()
        cache.build_install(snap)
        with cache.lock:
            idx = cache.synced(snap)
            assert idx is not None
            _decoded(idx)           # force-build the columns

        rng = random.Random(7)
        for step in range(30):
            index += 1
            kind = rng.choice(("update", "register", "deregister"))
            if kind == "update":
                node = copy.deepcopy(
                    rng.choice(store.snapshot().nodes()))
                node.attributes["arch"] = rng.choice(
                    ("amd64", "arm64", "riscv"))
                if rng.random() < 0.3:
                    node.meta.pop("rack", None)
                else:
                    node.meta["rack"] = f"r{rng.randint(0, 4)}"
                store.upsert_node(index, node)
            elif kind == "register":
                node = mock.node()
                node.attributes["arch"] = "amd64"
                store.upsert_node(index, node)
            else:
                victims = store.snapshot().nodes()
                if len(victims) > 2:
                    store.delete_node(index,
                                      [rng.choice(victims).id])
            snap = store.snapshot()
            with cache.lock:
                idx = cache.synced(snap)
                assert idx is not None
                got = _decoded(idx)
                assert idx.n == len(snap.nodes())
            fresh = nai.NodeAttrIndex(snap.nodes(),
                                      snap.index("nodes"))
            assert got == _decoded(fresh), (step, kind)


def _constrained_job(i=0):
    job = mock.job()
    job.id = f"feas-job-{i}"
    tg = job.task_groups[0]
    tg.constraints.extend([
        Constraint(ltarget="${attr.cpu.arch}", rtarget="amd64",
                   operand="="),
        Constraint(ltarget="${meta.rack}", rtarget="r[0-1]",
                   operand="regexp"),
    ])
    return job


def _eval_for(job):
    return Evaluation(namespace=job.namespace, priority=job.priority,
                      type=job.type, triggered_by=TRIGGER_JOB_REGISTER,
                      job_id=job.id,
                      job_modify_index=job.modify_index)


def _e2e_run(seed, port: bool):
    """The seeded scenario through one package's GenericScheduler: the
    port's compiled engine, or the JAX package's scalar reference under
    NOMAD_TPU_COLUMNAR_FEAS=0 (restored after)."""
    if port:
        pmock, PHarness, PEvaluation = mock, \
            (lambda: Harness(device="cpu")), Evaluation
        PConstraint, trigger = Constraint, TRIGGER_JOB_REGISTER
        env = None
    else:
        from nomad_tpu import mock as pmock
        from nomad_tpu.models import Constraint as PConstraint
        from nomad_tpu.models import TRIGGER_JOB_REGISTER as trigger
        from nomad_tpu.models.evaluation import Evaluation as PEvaluation
        from nomad_tpu.scheduler import Harness as PHarness
        from nomad_tpu.scheduler import feasible_compiler as jfc
        env = jfc.ENV
    prev = os.environ.get(env) if env else None
    if env:
        os.environ[env] = "0"
    try:
        with pmock.seeded_mock_ids(seed):
            h = PHarness()
            order = {}
            for i in range(30):
                node = pmock.node()
                node.attributes["cpu.arch"] = \
                    "amd64" if i % 3 else "arm64"
                node.meta["rack"] = f"r{i % 4}"
                h.store.upsert_node(h.next_index(), node)
                order[node.id] = i
            job = pmock.job()
            job.id = f"feas-job-{seed}"
            job.task_groups[0].constraints.extend([
                PConstraint(ltarget="${attr.cpu.arch}", rtarget="amd64",
                            operand="="),
                PConstraint(ltarget="${meta.rack}", rtarget="r[0-1]",
                            operand="regexp"),
            ])
            h.store.upsert_job(h.next_index(), job)
            ev = PEvaluation(namespace=job.namespace,
                             priority=job.priority, type=job.type,
                             triggered_by=trigger, job_id=job.id,
                             job_modify_index=job.modify_index)
            h.store.upsert_evals(h.next_index(), [ev])
            h.process("service", ev)
        plan = h.plans[0]
        placed = sorted(order[nid] for nid in plan.node_allocation)
        m = next(iter(plan.node_allocation.values()))[0].metrics
        return (placed, m.nodes_filtered,
                dict(m.constraint_filtered or {}))
    finally:
        if env:
            if prev is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = prev


def test_kill_switch_e2e_equivalence():
    """GenericScheduler end to end, the port's engine against the JAX
    package's NOMAD_TPU_COLUMNAR_FEAS=0: identical placements, filter
    counts, and per-constraint attribution on the same seeded
    scenario."""
    for seed in (11, 12, 13):
        assert _e2e_run(seed, True) == _e2e_run(seed, False), seed


def test_mask_journal_patches_one_row():
    """A node attribute update re-evaluates exactly ONE mask row via
    the journal (no full rebuild, no column rebuild), and the patched
    verdict is correct: flipping an arm64 node to amd64 admits it."""
    with seeded_mock_ids(99):
        h = Harness(device="cpu")
        nodes = []
        for i in range(20):
            node = mock.node()
            node.attributes["cpu.arch"] = "amd64" if i else "arm64"
            node.meta["rack"] = "r0"
            h.store.upsert_node(h.next_index(), node)
            nodes.append(node)
        job = _constrained_job(0)
        h.store.upsert_job(h.next_index(), job)
        ev = _eval_for(job)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process("service", ev)
        fc.reset_stats()
        g0 = h.store.attr_index.gauge_stats()

        flip = copy.deepcopy(h.store.node_by_id(nodes[0].id))
        flip.attributes["cpu.arch"] = "amd64"
        h.store.upsert_node(h.next_index(), flip)
        job2 = _constrained_job(1)
        h.store.upsert_job(h.next_index(), job2)
        ev2 = _eval_for(job2)
        h.store.upsert_evals(h.next_index(), [ev2])
        h.process("service", ev2)

    st = fc.stats()
    assert st["mask_patches"] == 1 and st["rows_patched"] == 1, st
    assert st["mask_builds"] == 0 and st["fallbacks"] == 0, st
    g1 = h.store.attr_index.gauge_stats()
    assert g1["idx_column_builds"] == g0["idx_column_builds"]
    # the flipped node is now feasible: one fewer node filtered
    m1 = next(iter(h.plans[0].node_allocation.values()))[0].metrics
    m2 = next(iter(h.plans[1].node_allocation.values()))[0].metrics
    assert m2.nodes_filtered == m1.nodes_filtered - 1


def test_drop_masks_keeps_columns():
    """The governor reclaim drops cached masks but keeps intern
    tables: the next eval pays one mask BUILD from codes, zero column
    builds."""
    with seeded_mock_ids(5):
        h = Harness(device="cpu")
        for i in range(10):
            node = mock.node()
            node.attributes["cpu.arch"] = "amd64"
            node.meta["rack"] = "r0"
            h.store.upsert_node(h.next_index(), node)
        job = _constrained_job(0)
        h.store.upsert_job(h.next_index(), job)
        ev = _eval_for(job)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process("service", ev)

        assert h.store.attr_index.drop_masks()["masks_dropped"] >= 1
        fc.reset_stats()
        g0 = h.store.attr_index.gauge_stats()
        # a node update invalidates the table-level check cache so the
        # next eval actually re-enters the compiler (without it the
        # NodeTable's own mask_cache would serve the checks)
        node = copy.deepcopy(h.store.snapshot().nodes()[0])
        node.meta["canary"] = "x"
        h.store.upsert_node(h.next_index(), node)
        job2 = _constrained_job(1)
        h.store.upsert_job(h.next_index(), job2)
        ev2 = _eval_for(job2)
        h.store.upsert_evals(h.next_index(), [ev2])
        h.process("service", ev2)
    st = fc.stats()
    assert st["mask_builds"] == 1 and st["fallbacks"] == 0, st
    g1 = h.store.attr_index.gauge_stats()
    assert g1["idx_column_builds"] == g0["idx_column_builds"]
