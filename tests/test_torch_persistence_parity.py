"""The port's persistence against the JAX package's, on the CPU.

Both packages' servers get the same seeded inputs, as in
tests/test_torch_server_parity.py (40 nodes over four racks; service,
spread and batch jobs; every mock id from `seeded_mock_ids` and every id
a server mints from one seeded `os.urandom` stream), each with a data
directory, in the sequential config. The nodes go into the store
directly and a first snapshot holds them; half the jobs are placed, a
second snapshot is taken, and the other half are placed, so a restart
reads a snapshot and a WAL tail of registers, plans and eval updates.

Then each data directory is copied, and four servers restart: the port's
and the JAX package's from their own directories, the port's from the
JAX package's copy and the JAX package's from the port's. The restored
stores (jobs, allocs by id with their node's name and statuses, eval
statuses, the latest index) are equal in all four. Three more seeded
jobs then place identically, by node name, on all four. Both snapshot
formats (columnar and legacy), over three seeds. The JAX Server runs as
its own tests run it (JAX_PLATFORMS=cpu); the port's with device="cpu".
"""

import os
import random
import shutil
import time

import numpy as np
import pytest

import test_torch_select  # noqa: F401  (torch's thread cap)

SEEDS = (1, 2, 3)
NODES = 40
RACKS = 4
# ingest_window_us < 0: neither package builds its ingest gateway, so a
# register writes the same two entries (job, then eval) in both
CONFIG = dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0,
              heartbeat_ttl_s=3600.0, snapshot_background=False,
              snapshot_every=100_000, ingest_window_us=-1.0)


def _packages(port: bool):
    if port:
        from nomad_tpu_torch import mock, models
        from nomad_tpu_torch.server import Server, ServerConfig
    else:
        from nomad_tpu import mock, models
        from nomad_tpu.server import Server, ServerConfig
    return mock, models, Server, ServerConfig


def _strip(job):
    job.name = job.id
    tg = job.task_groups[0]
    for t in tg.tasks:
        t.resources.networks = []
    tg.networks = []


def _inputs(mock, models, seed):
    """(nodes, first jobs, next jobs) from `seed`, equal in both
    packages."""
    with mock.seeded_mock_ids(seed):
        nodes = [mock.node() for _ in range(NODES)]
        service = [mock.job() for _ in range(3)]
        spread = [mock.job() for _ in range(2)]
        batch = [mock.batch_job() for _ in range(2)]
        after = [mock.job(), mock.job(), mock.batch_job()]
    rng = np.random.RandomState(seed)
    for i, node in enumerate(nodes):
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % RACKS}"
        node.compute_class()
    for tag, jobs in (("svc", service), ("spread", spread),
                      ("batch", batch), ("after", after)):
        for i, job in enumerate(jobs):
            job.id = f"{tag}-{i}"
            _strip(job)
    for job in service + after[:1]:
        job.task_groups[0].count = int(rng.randint(2, 7))
    for job in spread + after[1:2]:
        job.spreads = [models.Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[models.SpreadTarget(value="r1", percent=40)])]
        job.task_groups[0].count = int(rng.randint(6, 13))
    for job in batch + after[2:]:
        job.task_groups[0].count = int(rng.randint(10, 31))
    first = [service[0], spread[0], batch[0], service[1],
             service[2], spread[1], batch[1]]
    return nodes, first, after


def _settle(s, jobs, timeout=60.0):
    want = {j.id: j.task_groups[0].count for j in jobs}
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = s.eval_broker.stats
        if all(len(s.store.allocs_by_job("default", j)) == n
               for j, n in want.items()) and \
                st.total_ready == 0 and st.total_unacked == 0:
            return
        time.sleep(0.01)
    raise AssertionError(f"jobs not placed in {timeout} s")


def _server(port: bool, data_dir: str, columnar: bool, **config):
    _mock, _models, Server, ServerConfig = _packages(port)
    kw = dict(device="cpu") if port else {}
    return Server(ServerConfig(data_dir=data_dir,
                               snapshot_columnar=columnar,
                               **{**CONFIG, **config}), **kw)


def _first_life(port, seed, data_dir, columnar, monkeypatch):
    mock, models, _S, _C = _packages(port)
    nodes, first, _after = _inputs(mock, models, seed)
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", random.Random(seed).randbytes)
        s = _server(port, data_dir, columnar)
        try:
            idx = s._raft_index
            for node in nodes:
                idx += 1
                s.store.upsert_node(idx, node)
            s._raft_index = idx
            s.persistence.snapshot(s.store)
            # registered before start: leadership enqueues their evals
            half = len(first) // 2
            for job in first[:half]:
                s.register_job(job)
            s.start()
            _settle(s, first[:half])
            s.persistence.snapshot(s.store)
            # the second half registers while the worker is paused, so
            # the servers mint their ids in one order (a worker inside
            # its blocking dequeue notices the pause on its next loop)
            for w in s.workers:
                w.set_pause(True)
            time.sleep(0.6)
            for job in first[half:]:
                s.register_job(job)
            for w in s.workers:
                w.set_pause(False)
            _settle(s, first)
        finally:
            s.shutdown()


def _state(s):
    store = s.store
    names = {n.id: n.name for n in store.nodes()}
    return dict(
        jobs=sorted((j.id, j.version, j.status, j.stop)
                    for j in store.jobs()),
        allocs=sorted((a.id, a.name, names.get(a.node_id), a.client_status,
                       a.desired_status) for a in store.allocs()),
        evals=sorted((e.id, e.job_id, e.status) for e in store.evals()),
        index=store.latest_index(), nodes=sorted(names.values()))


def _placements(s, jobs):
    names = {n.id: n.name for n in s.store.nodes()}
    return {j.id: sorted((a.name, names[a.node_id])
                         for a in s.store.allocs_by_job("default", j.id))
            for j in jobs}


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "legacy"])
@pytest.mark.parametrize("seed", SEEDS)
def test_restarts_restore_and_place_across_packages(tmp_path, monkeypatch,
                                                    seed, columnar):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    dirs = {}
    for port in (False, True):
        d = str(tmp_path / ("port" if port else "jax"))
        _first_life(port, seed, d, columnar, monkeypatch)
        dirs[port, port] = d
        # the other package restores a copy of this directory
        dirs[not port, port] = shutil.copytree(
            d, str(tmp_path / ("port-copy" if port else "jax-copy")))
    states, placed = {}, {}
    for (port, written_by), d in sorted(dirs.items()):
        mock, models, _S, _C = _packages(port)
        _nodes, _first, after = _inputs(mock, models, seed)
        with monkeypatch.context() as m:
            m.setattr(os, "urandom", random.Random(seed + 100).randbytes)
            s = _server(port, d, columnar)
            try:
                assert s.persistence.stats["restore_format"] == \
                    (2 if columnar else 1)
                assert s.cold_start_stats["wal_entries_replayed"] > 0
                states[port, written_by] = _state(s)
                s.start()
                for job in after:
                    s.register_job(job)
                _settle(s, after)
                placed[port, written_by] = _placements(s, after)
            finally:
                s.shutdown()
    ref = states[False, False]
    assert len(ref["allocs"]) == sum(
        j.task_groups[0].count
        for j in _inputs(*_packages(True)[:2], seed)[1])
    for key, st in states.items():
        assert st == ref, key
    for key, p in placed.items():
        assert p == placed[False, False], key
    assert all(p for p in placed[False, False].values())


def test_port_replays_the_jax_packages_ingest_entries(tmp_path,
                                                      monkeypatch):
    """With its ingest gateway on, the JAX package writes a register and
    its eval as ONE job_register entry; the port replays such a WAL to
    the state the JAX package restores from it."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    mock, models, _S, _C = _packages(False)
    _nodes, first, _after = _inputs(mock, models, 1)
    d = str(tmp_path / "jax")
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", random.Random(1).randbytes)
        s = _server(False, d, True, ingest_window_us=200.0)
        try:
            assert s.ingest is not None
            for job in first[:3]:
                s.register_job(job)
        finally:
            s.shutdown()
    copy = shutil.copytree(d, str(tmp_path / "jax-copy"))
    states = {}
    for port, data_dir in ((False, d), (True, copy)):
        s = _server(port, data_dir, True)
        try:
            states[port] = _state(s)
            assert s.cold_start_stats["wal_entries_replayed"] == 3
        finally:
            s.shutdown()
    assert states[True] == states[False]
    assert [st for _i, _j, st in states[True]["evals"]] == ["pending"] * 3
