"""The port's placement path as a whole, against the JAX package's.

A pinned-id cluster of 64 nodes is built in the JAX package and carried
into the port through wire dicts (nomad_tpu_torch.state.carry). The same
three evals go through both packages' Harness — the mock service job
(chunked kernel), a count-600 batch job (N = 64 > KWAY_W, so the K-way
kernel) and a spread + affinity job (scan kernel) — with the port on the
CPU, where its kernels' plain versions run. Placements by node name, eval
status and failed_tg_allocs must be identical, and the AllocMetric scores
agree within rtol=1e-6, atol=1e-6.
"""

import numpy as np
import pytest

from nomad_tpu import mock
from nomad_tpu.models import (Affinity, EVAL_STATUS_PENDING, Evaluation,
                              Spread, SpreadTarget, TRIGGER_JOB_REGISTER)
from nomad_tpu.scheduler.harness import Harness
from nomad_tpu.utils.codec import to_wire
from nomad_tpu.utils.ids import generate_uuid
from nomad_tpu_torch import models as tmodels
from nomad_tpu_torch.scheduler.harness import Harness as TorchHarness
from nomad_tpu_torch.state.carry import store_from_wire
from nomad_tpu_torch.utils.codec import from_wire

N_NODES = 64
RACKS = 16


def _nodes():
    nodes = []
    for i in range(N_NODES):
        node = mock.node()
        node.id = f"00000000-0000-4000-8000-{i:012d}"
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % RACKS}"
        node.compute_class()
        nodes.append(node)
    return nodes


def _jobs():
    service = mock.job()
    batch = mock.batch_job()
    batch.task_groups[0].count = 600
    for task in batch.task_groups[0].tasks:
        task.resources.cpu = 20
        task.resources.memory_mb = 32
        task.resources.networks = []
    spread = mock.job()
    spread.id = spread.name = "spread-affinity"
    spread.spreads = [Spread(
        attribute="${meta.rack}", weight=60,
        spread_target=[SpreadTarget(value="r1", percent=30),
                       SpreadTarget(value="r2", percent=20)])]
    spread.affinities = [Affinity(ltarget="${meta.rack}", rtarget="r3",
                                  operand="=", weight=40)]
    spread.task_groups[0].count = 20
    return [("service", service), ("batch", batch), ("service", spread)]


def _eval(job):
    return Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
        status=EVAL_STATUS_PENDING, type=job.type)


def _placed(store, job_id, names):
    return {a.name: (names[a.node_id], a.metrics)
            for a in store.allocs_by_job("default", job_id)}


@pytest.fixture(scope="module")
def runs():
    """Both packages' harnesses after the three evals: per eval, the
    (placements, last eval) of each."""
    nodes = _nodes()
    names = {n.id: n.name for n in nodes}
    jh = Harness()
    for n in nodes:
        jh.store.upsert_node(jh.next_index(), n)
    th = TorchHarness(store_from_wire([to_wire(n) for n in nodes], [], []),
                      device="cpu")
    out = []
    for kind, job in _jobs():
        ev = _eval(job)
        jh.store.upsert_job(jh.next_index(), job)
        jh.process(kind, ev)
        th.store.upsert_job(th.next_index(),
                            from_wire(tmodels.Job, to_wire(job)))
        th.process(kind, from_wire(tmodels.Evaluation, to_wire(ev)))
        out.append((job, _placed(jh.store, job.id, names), jh.evals[-1],
                    _placed(th.store, job.id, names), th.evals[-1]))
    return out


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["service-chunked", "batch-kway",
                              "spread-scan"])
def test_placements_identical(runs, which):
    job, jplaced, jev, tplaced, tev = runs[which]
    assert len(jplaced) == sum(tg.count for tg in job.task_groups)
    assert {k: v[0] for k, v in tplaced.items()} == \
        {k: v[0] for k, v in jplaced.items()}
    assert tev.status == jev.status == "complete"
    assert to_wire(tev.failed_tg_allocs) == to_wire(jev.failed_tg_allocs)


@pytest.mark.parametrize("which", [0, 1, 2],
                         ids=["service-chunked", "batch-kway",
                              "spread-scan"])
def test_alloc_metrics_agree(runs, which):
    _job, jplaced, _jev, tplaced, _tev = runs[which]
    for name, (_node, jm) in jplaced.items():
        tm = tplaced[name][1]
        assert tm.nodes_evaluated == jm.nodes_evaluated
        assert tm.nodes_filtered == jm.nodes_filtered
        assert tm.dimension_exhausted == jm.dimension_exhausted
        assert len(tm.score_meta_data) == len(jm.score_meta_data)
        for ts, js in zip(tm.score_meta_data, jm.score_meta_data):
            assert ts.node_id == js.node_id
            assert ts.scores.keys() == js.scores.keys()
            np.testing.assert_allclose(
                [ts.norm_score] + [ts.scores[k] for k in sorted(ts.scores)],
                [js.norm_score] + [js.scores[k] for k in sorted(js.scores)],
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("first", [999, 5000, 100_000])
def test_harness_over_a_later_store_advances_its_snapshot(first):
    """A port Harness built over a store that already holds writes up to
    or past index 1000 hands out indexes above them, so its own writes advance
    the snapshot: a second job sees the first job's allocs and finds no
    room. (The JAX package's Harness starts at 1000 whatever the store
    holds; the port departs on purpose.)"""
    from nomad_tpu_torch.mock import fixtures as tmock
    from nomad_tpu_torch.state import StateStore
    store = StateStore()
    for i in range(2):
        node = tmock.node()
        node.name = f"node-{i}"
        store.upsert_node(first + i, node)
    h = TorchHarness(store, device="cpu")
    assert h.next_index() > store.latest_index() == first + 1
    placed = []
    for name in ("fill", "late"):
        job = tmock.job()
        job.id = job.name = name
        job.task_groups[0].count = 2 if name == "fill" else 1
        for task in job.task_groups[0].tasks:
            task.resources.cpu = 3000      # one a 4,000 MHz node
            task.resources.networks = []
        before = store.latest_index()
        h.store.upsert_job(h.next_index(), job)
        h.process("service", tmodels.Evaluation(
            id=generate_uuid(), namespace=job.namespace,
            priority=job.priority, triggered_by=TRIGGER_JOB_REGISTER,
            job_id=job.id, status=EVAL_STATUS_PENDING, type=job.type))
        assert store.latest_index() > before
        placed.append(len(store.allocs_by_job(job.namespace, job.id)))
    assert placed == [2, 0]
    assert h.evals[-1].failed_tg_allocs
