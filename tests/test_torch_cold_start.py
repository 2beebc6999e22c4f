"""The port's columnar snapshots, restore and cold start.

The state-level tests of tests/test_cold_start.py and
tests/test_persistence.py over nomad_tpu_torch, their assertions
unchanged: columnar and legacy round trips over every dumped table, the
codec's pools and defaults, the vectorized cold table build, the warm
alloc index, the legacy snapshot upgraded through Persistence and a
restarted Server, and a restarted Server that rebuilds nothing. The
Server / Persistence / RaftLog tests of WAL replay and snapshot writing
are in tests/test_torch_persistence.py.

Then the port's own: snapshots cross the package boundary in both
directions and in both formats (the JAX package's dump, packed with
msgpack as its persistence writes it, restored by the port, and back),
and after restore -> prime -> prefetch_device the E1-E8 steps of
tests/test_torch_resident.py rebuild nothing, every dispatch is served by
the device mirror, and they place as on the store that was never dumped.
"""

import json
import random
from dataclasses import replace
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest

import nomad_tpu.acl as jacl
import nomad_tpu.models as jmodels
import nomad_tpu.models.alloc as jalloc
import nomad_tpu.models.namespace as jnamespace
from nomad_tpu import mock as jmock
from nomad_tpu.ops.tables import NodeTable as JNodeTable
from nomad_tpu.state import StateStore as JStateStore
from nomad_tpu.utils.codec import to_wire as jax_to_wire
from nomad_tpu_torch import acl, mock
from nomad_tpu_torch import models
from nomad_tpu_torch.models import Allocation, Evaluation
from nomad_tpu_torch.models import alloc as talloc
from nomad_tpu_torch.models import namespace as tnamespace
from nomad_tpu_torch.ops.tables import NodeTable, PrefetchThread
from nomad_tpu_torch.scheduler.harness import Harness as TorchHarness
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.persistence import Persistence
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.state.columnar import decode_table, encode_table
from nomad_tpu_torch.utils import metrics as tmetrics
from nomad_tpu_torch.utils.codec import from_wire
from nomad_tpu_torch.utils.codec import to_wire

import test_torch_resident as resident
import test_torch_select  # noqa: F401  (torch's thread cap)

PORT = SimpleNamespace(mock=mock, StateStore=StateStore, acl=acl,
                       models=models, alloc=talloc, namespace=tnamespace)
JAX = SimpleNamespace(mock=jmock, StateStore=JStateStore, acl=jacl,
                      models=jmodels, alloc=jalloc, namespace=jnamespace)


def _canon(d) -> str:
    return json.dumps(d, sort_keys=True, default=str)


def _pack_cycle(data: dict) -> dict:
    """Exercise the real file framing: msgpack encode + decode."""
    return msgpack.unpackb(msgpack.packb(data, use_bin_type=True),
                           raw=False, strict_map_key=False)


def _seeded_store(rng: random.Random, n_nodes=8, n_jobs=4,
                  allocs_per_job=25, pkg=PORT):
    """A store touching every dumped table: nodes, jobs (+versions),
    evals, allocs (varied statuses/transitions/deployment bits),
    deployments, namespaces, ACL policies+tokens, CSI volumes, service
    registrations, periodic launches, scheduler config."""
    mock = pkg.mock
    AclPolicy, AclToken = pkg.acl.AclPolicy, pkg.acl.AclToken
    SchedulerConfiguration = pkg.models.SchedulerConfiguration
    AllocDeploymentStatus = pkg.alloc.AllocDeploymentStatus
    DesiredTransition = pkg.alloc.DesiredTransition
    Namespace = pkg.namespace.Namespace

    s = pkg.StateStore()
    idx = 10
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.name = f"cold-node-{i}"
        idx += 1
        s.upsert_node(idx, n)
        nodes.append(n)
    jobs = []
    for j in range(n_jobs):
        job = mock.job()
        job.id = f"cold-job-{j}"
        idx += 1
        s.upsert_job(idx, job)
        if rng.random() < 0.5:      # a second version for job_versions
            job2 = job.copy()
            job2.task_groups[0].tasks[0].env = {"V": str(j)}
            idx += 1
            s.upsert_job(idx, job2)
        jobs.append(job)
    d = mock.deployment()
    d.job_id = jobs[0].id
    idx += 1
    s.upsert_deployment(idx, d)
    statuses = ["pending", "running", "complete", "failed", "lost"]
    desireds = ["run", "stop", "evict"]
    allocs = []
    for j, job in enumerate(jobs):
        for i in range(allocs_per_job):
            a = mock.alloc()
            a.id = f"alloc-{j}-{i}"
            a.job_id = job.id
            a.job = job
            a.node_id = rng.choice(nodes).id
            a.name = f"{job.id}.web[{i}]"
            a.client_status = rng.choice(statuses)
            a.desired_status = rng.choice(desireds)
            if rng.random() < 0.3:
                a.desired_transition = DesiredTransition(migrate=True)
            if rng.random() < 0.3:
                a.deployment_id = d.id
                a.deployment_status = AllocDeploymentStatus(
                    healthy=rng.random() < 0.5)
            allocs.append(a)
    idx += 1
    s.upsert_allocs(idx, allocs)
    evals = []
    for j in range(10):
        e = mock.evaluation()
        e.job_id = rng.choice(jobs).id
        evals.append(e)
    idx += 1
    s.upsert_evals(idx, evals)
    idx += 1
    s.upsert_namespaces(idx, [Namespace(name="prod",
                                        description="prod ns")])
    idx += 1
    s.upsert_acl_policies(idx, [AclPolicy(
        name="dev", rules='namespace "default" { policy = "read" }')])
    idx += 1
    s.upsert_acl_tokens(idx, [AclToken(
        accessor_id="acc-1", secret_id="sec-1", name="t",
        type="client", policies=["dev"])])
    idx += 1
    s.upsert_periodic_launch(idx, "default", jobs[0].id, 123.5)
    idx += 1
    s.set_scheduler_config(idx, SchedulerConfiguration())
    return s


def _seeded_pair(seed: int, pkg, **kw):
    """_seeded_store with its mock ids drawn from `seed` too, so the same
    seed builds the same store in either package."""
    with pkg.mock.seeded_mock_ids(seed):
        return _seeded_store(random.Random(seed), pkg=pkg, **kw)


def _tables_equal(got: NodeTable, ref: NodeTable) -> None:
    assert got.ids == ref.ids
    assert np.array_equal(got.capacity, ref.capacity)
    assert np.array_equal(got.base_used, ref.base_used)
    assert got._net_bits == ref._net_bits
    assert np.array_equal(got.free_ports, ref.free_ports)
    for a, b in zip(ref.live_allocs, got.live_allocs):
        assert [x.id for x in a] == [x.id for x in b]
    assert set(got.alloc_by_id) == set(ref.alloc_by_id)


class TestColumnarRoundTrip:
    def test_randomized_parity_columnar_vs_legacy(self):
        """Columnar restore ≡ legacy restore ≡ the original dump, on
        the FULL store state (randomized content over every table)."""
        for seed in range(5):
            rng = random.Random(seed)
            s = _seeded_store(rng)
            legacy = s.dump()
            col = _pack_cycle(s.dump_columnar())
            s_col = StateStore()
            s_col.restore(col)
            s_leg = StateStore()
            s_leg.restore(_pack_cycle(legacy))
            assert _canon(s_col.dump()) == _canon(s_leg.dump()), \
                f"seed {seed}: columnar restore diverged from legacy"
            assert _canon(s_col.dump()) == _canon(legacy), \
                f"seed {seed}: round trip diverged from original"
            # re-dumping columnar from a columnar restore round-trips
            again = StateStore()
            again.restore(_pack_cycle(s_col.dump_columnar()))
            assert _canon(again.dump()) == _canon(legacy)

    def test_legacy_snapshot_upgrades_to_columnar(self, tmp_path):
        """Old→new migration: a legacy-format snapshot file restores
        into a columnar-writing server, whose next snapshot is format
        2 and restores identically."""
        rng = random.Random(99)
        s = _seeded_store(rng)
        legacy_dir = str(tmp_path / "legacy")
        p = Persistence(legacy_dir, columnar=False, background=False)
        p.snapshot(s)
        srv = Server(ServerConfig(num_schedulers=0,
                                  data_dir=legacy_dir,
                                  snapshot_background=False),
                     device="cpu")
        try:
            assert srv.persistence.stats["restore_format"] == 1
            assert _canon(srv.store.dump()) == _canon(s.dump())
            srv.persistence.snapshot(srv.store)     # now columnar
        finally:
            srv.shutdown()
        srv2 = Server(ServerConfig(num_schedulers=0,
                                   data_dir=legacy_dir), device="cpu")
        try:
            assert srv2.persistence.stats["restore_format"] == 2
            assert _canon(srv2.store.dump()) == _canon(s.dump())
        finally:
            srv2.shutdown()

    def test_pool_sharing_and_empty_containers(self):
        """Shared flyweights stay shared through the codec; empty
        dict/list fields come back as FRESH containers per row (no
        cross-row aliasing of task_states)."""
        job = mock.job()
        res = mock.alloc().allocated_resources
        allocs = []
        for i in range(10):
            a = mock.alloc()
            a.id = f"fly-{i}"
            a.job = job
            a.allocated_resources = res
            a.task_states = {}
            allocs.append(a)
        dec = decode_table(Allocation, _pack_cycle(
            {"t": encode_table(allocs)})["t"])
        out = dec.objs
        assert len({id(o.job) for o in out}) == 1
        assert len({id(o.allocated_resources) for o in out}) == 1
        assert len({id(o.task_states) for o in out}) == len(out)
        out[0].task_states["web"] = "poison"
        assert out[1].task_states == {}

    def test_forward_compat_missing_field_defaults(self):
        """A snapshot written before a field existed restores with the
        dataclass default (factories called per row)."""
        evals = [mock.evaluation() for _ in range(3)]
        enc = _pack_cycle({"t": encode_table(evals)})["t"]
        dropped = enc["fields"].pop("status")
        assert dropped is not None
        out = decode_table(Evaluation, enc).objs
        assert all(o.status == Evaluation().status for o in out)


class TestNodeTableColdBuild:
    def test_build_from_columns_parity(self):
        """The vectorized cold build produces a table identical to
        build_all on the restored snapshot (usage, row lists, port
        bits, registry)."""
        for seed in range(3):
            rng = random.Random(1000 + seed)
            s = _seeded_store(rng, n_nodes=12, n_jobs=3,
                              allocs_per_job=40)
            s2 = StateStore()
            s2.restore(_pack_cycle(s.dump_columnar()))
            cold = s2.pop_cold_columns()
            assert cold is not None
            snap = s2.snapshot()
            ref = NodeTable.build_all(snap)
            got = NodeTable.build_from_columns(snap, cold)
            assert got.ids == ref.ids
            assert np.array_equal(got.base_used, ref.base_used)
            assert got._net_bits == ref._net_bits
            assert np.array_equal(got.free_ports, ref.free_ports)
            for a, b in zip(ref.live_allocs, got.live_allocs):
                assert [x.id for x in a] == [x.id for x in b]
            assert set(got.alloc_by_id) == set(ref.alloc_by_id)


class TestRecoveryInvariants:
    def test_no_rebuilds_after_restore(self, tmp_path):
        """After a cold boot from a columnar snapshot: the first
        columnar read per job pays ZERO dense index rebuilds, and the
        first node_table() read pays ZERO full NodeTable builds (the
        primed table serves it)."""
        rng = random.Random(7)
        s = _seeded_store(rng)
        data_dir = str(tmp_path / "inv")
        p = Persistence(data_dir, background=False)
        p.snapshot(s)
        srv = Server(ServerConfig(num_schedulers=0, data_dir=data_dir),
                     device="cpu")
        try:
            snap = srv.store.snapshot()
            jobs = {(a.namespace, a.job_id)
                    for a in srv.store.allocs()}
            for ns, job_id in jobs:
                cols = snap.job_alloc_columns(ns, job_id)
                assert cols is not None
                assert cols.n == len(snap.allocs_by_job(ns, job_id))
            assert srv.store.alloc_index.stats["rebuilds"] == 0
            assert snap.node_table() is not None
            assert srv.store.table_cache.stats["full_builds"] == 0
            assert srv.store.table_cache.stats.get("primes") == 1
        finally:
            srv.shutdown()

    def test_bulk_load_keeps_index_warm(self):
        """bulk_load_allocs no longer invalidates the columnar index:
        a fresh job's chunked load installs+extends an entry, and the
        read after the load pays zero rebuilds and matches a detached
        dense build row for row."""
        s = StateStore()
        n = mock.node()
        s.upsert_node(11, n)
        job = mock.batch_job()
        s.upsert_job(12, job)
        tg = job.task_groups[0].name
        idx = 12
        for chunk in range(3):
            allocs = [Allocation(
                id=f"bl-{chunk}-{i}", namespace="default",
                job_id=job.id, task_group=tg,
                name=f"{job.id}.{tg}[{chunk * 50 + i}]",
                node_id=n.id, eval_id="bl-eval",
                client_status="running", desired_status="run")
                for i in range(50)]
            idx += 1
            s.bulk_load_allocs(idx, allocs)
        cols = s.snapshot().job_alloc_columns("default", job.id)
        assert cols is not None and cols.n == 150
        assert s.alloc_index.stats["rebuilds"] == 0
        from nomad_tpu_torch.state.alloc_index import JobAllocColumns
        dense = JobAllocColumns.build(
            s.snapshot().allocs_by_job("default", job.id))
        assert sorted(cols.ids) == sorted(dense.ids)
        # a delta after the bulk load still applies on top
        a2 = s.snapshot().allocs_by_job("default", job.id)[0]
        idx += 1
        s.update_allocs_from_client(idx, [replace(
            a2, client_status="failed")])
        cols = s.snapshot().job_alloc_columns("default", job.id)
        r = cols.row_of[a2.id]
        assert cols.client[r] == 3      # CLIENT_FAILED_CODE
        assert s.alloc_index.stats["rebuilds"] == 0


def test_store_dump_restore_roundtrip():
    """tests/test_persistence.py's round trip of the legacy dump."""
    s = StateStore()
    n = mock.node()
    s.upsert_node(11, n)
    j = mock.job()
    s.upsert_job(12, j)
    a = mock.alloc()
    a.node_id = n.id
    a.job_id = j.id
    s.upsert_allocs(13, [a])
    e = mock.evaluation()
    s.upsert_evals(14, [e])
    d = mock.deployment()
    s.upsert_deployment(15, d)

    data = s.dump()
    s2 = StateStore()
    s2.restore(data)
    assert s2.node_by_id(n.id).name == n.name
    assert s2.job_by_id("default", j.id).version == 0
    assert s2.alloc_by_id(a.id).job is not None
    assert len(s2.allocs_by_node(n.id)) == 1
    assert len(s2.allocs_by_job("default", j.id)) == 1
    assert s2.eval_by_id(e.id) is not None
    assert s2.deployment_by_id(d.id) is not None
    assert s2.latest_index() == s.latest_index()
    assert s2.job_summary("default", j.id) is not None


# -- snapshots across the package boundary ----------------------------

def _dump(store, fmt: str) -> dict:
    return _pack_cycle(store.dump_columnar() if fmt == "columnar"
                       else store.dump())


@pytest.mark.parametrize("fmt", ["columnar", "legacy"])
@pytest.mark.parametrize("seed", [3, 11])
def test_snapshot_from_jax_restores_in_port(seed, fmt):
    """The JAX package's snapshot, restored by the port: the same
    indexes, nodes, evals and allocs (by wire form), every other table
    as the JAX store dumps it, and a primed NodeTable whose columns equal
    a build_all over the restored state's, and the JAX package's own
    table over the original."""
    src = _seeded_pair(seed, JAX)
    data = _dump(src, fmt)
    got = StateStore()
    got.restore(data)
    assert dict(got._root.indexes.items()) == \
        dict(src._root.indexes.items())
    for table in ("nodes", "evals", "allocs"):
        mine = sorted(_canon(to_wire(x))
                      for x in got._root.table(table).values())
        want = sorted(_canon(jax_to_wire(x))
                      for x in src._root.table(table).values())
        assert mine == want, table
    same = _canon(got.dump()) == _canon(src.dump())
    assert same, "the port's restore dumps otherwise than the JAX store"
    cold = got.pop_cold_columns()
    assert (cold is not None) == (fmt == "columnar")
    got.table_cache.prime(got.snapshot(), cold)
    primed = got.snapshot().node_table()
    assert got.table_cache.stats["full_builds"] == 0
    _tables_equal(primed, NodeTable.build_all(got.snapshot()))
    ref = JNodeTable.build_all(src.snapshot())
    assert primed.ids == ref.ids
    assert np.array_equal(primed.capacity, ref.capacity)
    assert np.array_equal(primed.base_used, ref.base_used)
    assert np.array_equal(primed.free_ports, ref.free_ports)


@pytest.mark.parametrize("fmt", ["columnar", "legacy"])
@pytest.mark.parametrize("seed", [3, 11])
def test_snapshot_from_port_restores_in_jax(seed, fmt):
    """The other direction: the port's snapshot, restored by the JAX
    package, holds the same state and the same table."""
    src = _seeded_pair(seed, PORT)
    got = JStateStore()
    got.restore(_dump(src, fmt))
    assert dict(got._root.indexes.items()) == \
        dict(src._root.indexes.items())
    for table in ("nodes", "evals", "allocs"):
        mine = sorted(_canon(jax_to_wire(x))
                      for x in got._root.table(table).values())
        want = sorted(_canon(to_wire(x))
                      for x in src._root.table(table).values())
        assert mine == want, table
    same = _canon(got.dump()) == _canon(src.dump())
    assert same, "the JAX package's restore dumps otherwise than the port"
    ref = NodeTable.build_all(src.snapshot())
    table = JNodeTable.build_all(got.snapshot())
    assert table.ids == ref.ids
    assert np.array_equal(table.capacity, ref.capacity)
    assert np.array_equal(table.base_used, ref.base_used)
    assert np.array_equal(table.free_ports, ref.free_ports)


# -- after a restore, nothing rebuilds ---------------------------------

def _port_steps(nodes):
    """tests/test_torch_resident.py's E1-E8 steps, carried into the
    port: ("job", job), ("node", node) and ("volume", volume)."""
    from nomad_tpu_torch.models import csi as tcsi
    out = []
    for step in resident._sequence(nodes):
        if step[0] == "node":
            out.append(("node", from_wire(models.Node,
                                          jax_to_wire(step[1]))))
        elif step[0] == "volume":
            out.append(("volume", from_wire(tcsi.CSIVolume,
                                            jax_to_wire(step[1]))))
        else:
            out.append(("job", step[1],
                        from_wire(models.Job, jax_to_wire(step[2]))))
    return out


def _run_steps(h, steps, names):
    """The steps through `h`; per eval its placements, the resident
    counters' deltas, and the table cache's full builds and the mirror's
    uploads so far."""
    import copy
    out = []
    for step in steps:
        if step[0] == "node":
            h.store.upsert_node(h.next_index(), copy.deepcopy(step[1]))
            continue
        if step[0] == "volume":
            h.store.upsert_csi_volumes(h.next_index(),
                                       [copy.deepcopy(step[1])])
            continue
        _kind, sched, job = step
        job = copy.deepcopy(job)
        before = tmetrics.counter_totals()
        h.store.upsert_job(h.next_index(), job)
        h.process(sched, from_wire(models.Evaluation,
                                   jax_to_wire(resident._eval(job))))
        after = tmetrics.counter_totals()
        assert h.evals[-1].status == "complete"
        out.append((
            sorted((a.name, a.desired_status, names[a.node_id])
                   for a in h.store.allocs_by_job("default", job.id)),
            {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
                "nomad.select.dispatches", "nomad.select.resident_dispatch",
                "nomad.select.resident_fallback")},
            h.store.table_cache.stats["full_builds"],
            h.store.table_cache.device.stats["uploads"]))
    return out


@pytest.fixture(scope="module")
def cold_runs():
    """E1-E8 on a store that was never dumped, and on its restore
    (columnar, packed with msgpack) after prime and a prefetch thread."""
    jnodes = resident._nodes()
    nodes = [from_wire(models.Node, jax_to_wire(n)) for n in jnodes]
    names = {n.id: n.name for n in nodes}
    steps = _port_steps(jnodes)
    warm = TorchHarness(device="cpu")
    for n in nodes:
        warm.store.upsert_node(warm.next_index(), n)
    # something to restore besides the nodes: a first job's allocs
    first = ("job", "service", replace(steps[0][2], id="seed-job",
                                       name="seed-job"))
    _run_steps(warm, [first], names)
    data = _pack_cycle(warm.store.dump_columnar())
    store = StateStore()
    store.restore(data)
    cache = store.table_cache
    cache.prime(store.snapshot(), store.pop_cold_columns())
    prefetch = PrefetchThread(cache, "cpu")
    prefetch.start()
    prefetch.join(timeout=60)
    assert not prefetch.is_alive()
    uploads = cache.device.stats["uploads"]
    warm_builds = warm.store.table_cache.stats["full_builds"]
    warm_runs = [(p, c, b - warm_builds, u)
                 for p, c, b, u in _run_steps(warm, steps, names)]
    cold = TorchHarness(store, device="cpu")
    return dict(warm=warm_runs, cold=_run_steps(cold, steps, names),
                cache=cache, uploads=uploads)


@pytest.mark.parametrize("which", range(len(resident.EVALS)),
                         ids=resident.EVALS)
def test_restored_steps_place_as_the_never_dumped_store(cold_runs, which):
    assert cold_runs["cold"][which][0] == cold_runs["warm"][which][0]


def test_restored_steps_rebuild_nothing_and_ride_the_mirror(cold_runs):
    """The prefetch made the mirror's one upload and the prime the one
    table: E1-E4 pay no full build and no upload. E5's node change forces
    one rebuild (and its upload) on both stores alike, as in the
    reference. Every dispatch from E1 on is served by the mirror."""
    assert cold_runs["uploads"] == 1
    assert cold_runs["cache"].stats["primes"] == 1
    cold, warm = cold_runs["cold"], cold_runs["warm"]
    assert [b for _p, _c, b, _u in cold[:4]] == [0, 0, 0, 0]
    assert [u for _p, _c, _b, u in cold[:4]] == [1, 1, 1, 1]
    assert [b for _p, _c, b, _u in cold] == [b for _p, _c, b, _u in warm]
    for _placed, c, _b, _u in cold:
        assert c["nomad.select.resident_fallback"] == 0
        assert c["nomad.select.resident_dispatch"] == \
            c["nomad.select.dispatches"] > 0


# -- prefetch_device ---------------------------------------------------

def _restored(seed=5):
    """A store restored from a columnar snapshot and primed from its
    cold columns."""
    store = StateStore()
    store.restore(_pack_cycle(_seeded_store(random.Random(seed))
                              .dump_columnar()))
    store.table_cache.prime(store.snapshot(), store.pop_cold_columns())
    return store


def test_prefetch_with_nothing_primed_is_a_no_op():
    cache = StateStore().table_cache
    cache.prefetch_device("cpu")
    assert cache.device.snapshot()["materialized"] is False
    assert cache.device.stats["uploads"] == 0


def test_prefetch_failure_reaches_the_joiner(monkeypatch):
    """A failed upload raises in the prefetch thread's join(), and a
    mirror that does not take the primed table raises too: nothing is
    left to ship the dense columns unseen."""
    from nomad_tpu_torch.ops.device_table import DeviceNodeTable

    def broken(*_args, **_kw):
        raise RuntimeError("upload failed")

    store = _restored()
    with monkeypatch.context() as m:
        m.setattr(DeviceNodeTable, "_upload", broken)
        thread = PrefetchThread(store.table_cache, "cpu")
        thread.start()
        with pytest.raises(RuntimeError, match="upload failed"):
            thread.join(timeout=60)
    assert not thread.is_alive()
    # the mirror moved on past the primed table: the prefetch raises
    store.table_cache.device.note_rebuild()
    with pytest.raises(RuntimeError, match="did not take"):
        store.table_cache.prefetch_device("cpu")
    # a prefetch that succeeds joins quietly, and the mirror is resident
    fresh = _restored()
    thread = PrefetchThread(fresh.table_cache, "cpu")
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive() and thread.error is None
    assert fresh.table_cache.device.snapshot()["materialized"] is True


def test_prefetch_uploads_the_mesh_table():
    """With a mesh set, the prefetch uploads the mesh-resident table
    too: one upload before the first eval, and the eval's dispatch served
    by it with no re-put."""
    from nomad_tpu_torch.ops.select import mesh_stats_snapshot, set_mesh
    from nomad_tpu_torch.parallel import make_mesh
    jnodes = resident._nodes()
    nodes = [from_wire(models.Node, jax_to_wire(n)) for n in jnodes]
    names = {n.id: n.name for n in nodes}
    steps = _port_steps(jnodes)
    warm = TorchHarness(device="cpu")
    for n in nodes:
        warm.store.upsert_node(warm.next_index(), n)
    want = _run_steps(warm, steps[:2], names)
    store = StateStore()
    try:
        set_mesh(make_mesh(2, "cpu"))
        before = dict(tmetrics.counter_totals())
        fresh = TorchHarness(device="cpu")
        for n in nodes:
            fresh.store.upsert_node(fresh.next_index(), n)
        store.restore(_pack_cycle(fresh.store.dump_columnar()))
        store.table_cache.prime(store.snapshot(), store.pop_cold_columns())
        store.table_cache.prefetch_device("cpu")
        assert mesh_stats_snapshot()["reshard_uploads"] == 1
        got = _run_steps(TorchHarness(store, device="cpu"), steps[:2],
                         names)
        stats = mesh_stats_snapshot()
        after = tmetrics.counter_totals()
    finally:
        set_mesh(None)
    assert [p for p, *_r in got] == [p for p, *_r in want]
    assert stats["reshard_uploads"] == 1
    assert stats["resident_hits"] + stats["delta_scatters"] >= 2
    served = after.get("nomad.select.mesh_resident_dispatch", 0.0) - \
        before.get("nomad.select.mesh_resident_dispatch", 0.0)
    assert served == sum(c["nomad.select.dispatches"] for _p, c, *_r in got)
    assert store.table_cache.stats["full_builds"] == 0
