"""The port's Server against the JAX package's Server, on the CPU.

Both packages' servers get the same seeded inputs — 40 nodes over four
racks, service jobs, spread jobs (a `${meta.rack}` spread) and batch
jobs, every mock id from `seeded_mock_ids` and every id the servers mint
from one seeded `os.urandom` stream, as in
tests/test_torch_golden_parity.py — registered while the workers are
paused, then scheduled through broker -> worker -> plan queue -> applier.
Each worker's pause is acknowledged by its loop before the inputs land,
and each run waits for the broker's quiescence with every job placed,
failing with what is missing past its deadline.

Config (A), sequential (one worker, no batching, no micro-batch gateway):
per job the allocs by (name, node name), the task-group counts and every
eval's final status are identical, and each alloc's scores agree within
1e-6. Config (B), drained batches (two workers, eval_batch_size 8, no
micro-batch gateway, so each drain is one BatchGateway), with batched
lanes forced on in both packages (NOMAD_TPU_EVAL_BATCH=force on the JAX
side, the profitability answer on the port's): lanes on one snapshot may
place differently, so each job's alloc count is identical and no node is
over capacity. The JAX Server runs as its own tests run it
(JAX_PLATFORMS=cpu, gateway_window_us=0); the port's with device="cpu".
"""

import os
import random
import threading
import time

import numpy as np
import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

SEEDS = (1, 2, 3)
NODES = 40
RACKS = 4
SEQUENTIAL = dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0)
DRAINED = dict(num_schedulers=2, eval_batch_size=8, gateway_window_us=0)


def _packages(port: bool):
    if port:
        from nomad_tpu_torch import mock, models
        from nomad_tpu_torch.server import Server, ServerConfig
    else:
        from nomad_tpu import mock, models
        from nomad_tpu.server import Server, ServerConfig
    return mock, models, Server, ServerConfig


def _inputs(mock, models, seed):
    """(nodes, jobs) from `seed`, equal in both packages."""
    with mock.seeded_mock_ids(seed):
        nodes = [mock.node() for _ in range(NODES)]
        service = [mock.job() for _ in range(4)]
        spread = [mock.job() for _ in range(2)]
        batch = [mock.batch_job() for _ in range(2)]
    rng = np.random.RandomState(seed)
    for i, node in enumerate(nodes):
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % RACKS}"
        node.compute_class()
    for tag, jobs in (("svc", service), ("spread", spread),
                      ("batch", batch)):
        for i, job in enumerate(jobs):
            job.id = job.name = f"{tag}-{i}"
            tg = job.task_groups[0]
            for t in tg.tasks:
                t.resources.networks = []
            tg.networks = []
    for job in service:
        job.task_groups[0].count = int(rng.randint(2, 7))
    for job in spread:
        job.spreads = [models.Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[models.SpreadTarget(value="r1", percent=40)])]
        job.task_groups[0].count = int(rng.randint(6, 13))
    for job in batch:
        job.task_groups[0].count = int(rng.randint(10, 31))
    return nodes, service + spread + batch


def _run(port: bool, cfg: dict, seed: int, monkeypatch):
    """One server of one package over the seed's inputs; returns its
    outcome: per job the allocs, counts, eval statuses and scores, per
    node its capacity and what its live allocs use, and the server's
    worker batches and batched kernel dispatches."""
    mock, models, Server, ServerConfig = _packages(port)
    nodes, jobs = _inputs(mock, models, seed)
    kw = dict(device="cpu") if port else {}
    rng = random.Random(seed)
    dispatches0 = _batch_dispatches(port)
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", rng.randbytes)
        s = Server(ServerConfig(heartbeat_ttl_s=3600.0, **cfg), **kw)
        s.start()
        try:
            _pause_workers(s)
            idx = s._raft_index
            for node in nodes:
                idx += 1
                s.store.upsert_node(idx, node)
            s._raft_index = idx
            for job in jobs:
                s.register_job(job)
            for w in s.workers:
                w.set_pause(False)
            want = {j.id: j.task_groups[0].count for j in jobs}
            _wait_quiescent(s, want, deadline_s=60.0)
            out = _outcome(s, jobs)
            out["batches"] = sum(w.stats["batches"] for w in s.workers)
            out["batch_dispatches"] = \
                _batch_dispatches(port) - dispatches0
            return out
        finally:
            s.shutdown()


class _AckedPause(threading.Event):
    """A worker's pause flag that records when the worker's loop has seen
    it set: the loop reads it before every dequeue, so once `seen` is
    set the worker holds no dequeue and takes no eval until the pause
    clears."""

    def __init__(self):
        super().__init__()
        self.seen = threading.Event()

    def is_set(self):
        paused = super().is_set()
        if paused:
            self.seen.set()
        return paused


def _pause_workers(s, deadline_s=30.0):
    """Pause every worker and wait until each one's loop acknowledged it
    (a worker inside its blocking dequeue acknowledges when the dequeue
    returns); fails if one does not within the deadline."""
    flags = []
    for w in s.workers:
        w._paused = _AckedPause()
        w.set_pause(True)
        flags.append(w._paused)
    deadline = time.time() + deadline_s
    for i, flag in enumerate(flags):
        assert flag.seen.wait(max(deadline - time.time(), 0.0)), \
            f"worker {i} did not acknowledge its pause in {deadline_s} s"


def _wait_quiescent(s, want, deadline_s):
    """Wait until every job has its count of allocs and the broker holds
    no ready or unacked eval; fails naming what is missing if that does
    not happen within the deadline."""
    deadline = time.time() + deadline_s
    while True:
        st = s.eval_broker.stats
        short = {j: (len(s.store.allocs_by_job("default", j)), n)
                 for j, n in want.items()
                 if len(s.store.allocs_by_job("default", j)) != n}
        if not short and st.total_ready == 0 and st.total_unacked == 0:
            return
        if time.time() > deadline:
            raise AssertionError(
                f"not quiescent after {deadline_s} s: allocs (have, "
                f"want) {short}, broker ready {st.total_ready} unacked "
                f"{st.total_unacked}, blocked "
                f"{s.blocked_evals.blocked_count()}")
        time.sleep(0.02)


def _batch_dispatches(port: bool) -> float:
    """The package's process-wide count of batched select_many
    dispatches (`nomad.select.batch_dispatch`)."""
    if port:
        from nomad_tpu_torch.utils import metrics
    else:
        from nomad_tpu.utils import metrics
    return metrics.counter_totals().get("nomad.select.batch_dispatch",
                                        0.0)


def _outcome(s, jobs):
    store = s.store
    names = {n.id: n.name for n in store.nodes()}
    out = {"jobs": {}, "nodes": {}}
    for job in jobs:
        allocs = store.allocs_by_job(job.namespace, job.id)
        scores = {}
        for a in allocs:
            m = a.metrics
            scores[a.name] = [] if m is None else sorted(
                (names.get(sm.node_id), sm.norm_score,
                 tuple(sm.scores[k] for k in sorted(sm.scores)))
                for sm in m.score_meta_data)
        evals = sorted(store.evals_by_job(job.namespace, job.id),
                       key=lambda e: (e.create_index, e.id))
        counts = {}
        for a in allocs:
            counts[a.task_group] = counts.get(a.task_group, 0) + 1
        out["jobs"][job.id] = dict(
            placed=sorted((a.name, names[a.node_id]) for a in allocs),
            counts=counts, evals=[e.status for e in evals],
            scores=scores)
    for node in store.nodes():
        res = node.comparable_resources()
        cpu = mem = 0.0
        ports = []
        for a in store.allocs_by_node(node.id):
            if a.terminal_status() or a.allocated_resources is None:
                continue
            c = a.allocated_resources.comparable()
            cpu += c.cpu_shares
            mem += c.memory_mb
            for t in a.allocated_resources.tasks.values():
                for net in t.networks:
                    ports += [p.value for p in net.reserved_ports]
                    ports += [p.value for p in net.dynamic_ports]
        out["nodes"][node.name] = dict(cap=(res.cpu_shares, res.memory_mb),
                                       used=(cpu, mem), ports=ports)
    return out


def _assert_within_capacity(outcome, jobs_want):
    for jid, n in jobs_want.items():
        assert len(outcome["jobs"][jid]["placed"]) == n, jid
    for name, row in outcome["nodes"].items():
        assert row["used"][0] <= row["cap"][0] + 1e-6, name
        assert row["used"][1] <= row["cap"][1] + 1e-6, name
        assert len(row["ports"]) == len(set(row["ports"])), name


@pytest.mark.parametrize("seed", SEEDS)
def test_sequential_server_places_as_the_jax_server(monkeypatch, seed):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    want = _run(False, SEQUENTIAL, seed, monkeypatch)
    got = _run(True, SEQUENTIAL, seed, monkeypatch)
    assert got["jobs"].keys() == want["jobs"].keys()
    for jid, w in want["jobs"].items():
        g = got["jobs"][jid]
        assert sum(w["counts"].values()) > 0, jid
        assert g["placed"] == w["placed"], jid
        assert g["counts"] == w["counts"], jid
        assert g["evals"] == w["evals"], jid
        assert g["scores"].keys() == w["scores"].keys(), jid
        for name, ws in w["scores"].items():
            gs = g["scores"][name]
            assert [(n, len(v)) for n, _s, v in gs] == \
                [(n, len(v)) for n, _s, v in ws], name
            for (_n, gn, gv), (_m, wn, wv) in zip(gs, ws):
                np.testing.assert_allclose([gn, *gv], [wn, *wv],
                                           rtol=1e-6, atol=1e-6)
    assert got["nodes"] == want["nodes"]


@pytest.mark.parametrize("seed", SEEDS)
def test_drained_batches_place_every_job_within_capacity(monkeypatch, seed):
    from nomad_tpu_torch.ops.select import SelectKernel
    monkeypatch.setenv("NOMAD_TPU_EVAL_BATCH", "force")
    monkeypatch.setattr(SelectKernel, "batch_dispatch_profitable",
                        lambda self, n, tolerance=1.0: True)
    mock, models, _S, _C = _packages(True)
    _nodes, jobs = _inputs(mock, models, seed)
    want = {j.id: j.task_groups[0].count for j in jobs}
    ref = _run(False, DRAINED, seed, monkeypatch)
    got = _run(True, DRAINED, seed, monkeypatch)
    # the port's workers really drained lanes and dispatched them batched
    assert got["batches"] >= 1
    assert got["batch_dispatches"] >= 1
    _assert_within_capacity(ref, want)
    _assert_within_capacity(got, want)
    assert {j: len(o["placed"]) for j, o in got["jobs"].items()} == \
        {j: len(o["placed"]) for j, o in ref["jobs"].items()}
