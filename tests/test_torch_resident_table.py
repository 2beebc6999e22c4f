"""The reference's resident node table tests (tests/test_resident_table.py:
the NodeTableCache reused across snapshots, alloc deltas against a full
rebuild, node changes, port bits, older snapshots, changelog truncation,
the HAMT's transient updates, immutable store roots and the shared mask
cache) against the port's ops/tables.py and state/, their assertions
unchanged.
"""

import numpy as np

from nomad_tpu_torch.mock import fixtures as mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_DESIRED_STOP, NODE_STATUS_DOWN,
)
from nomad_tpu_torch.ops.tables import NodeTable
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.utils.hamt import Hamt

import test_torch_select  # noqa: F401  (torch's thread cap)


def _store_with_nodes(n):
    s = StateStore()
    nodes = []
    for i in range(n):
        node = mock.node()
        node.name = f"node-{i}"
        nodes.append(node)
        s.upsert_node(i + 1, node)
    return s, nodes


def _assert_tables_equal(a: NodeTable, b: NodeTable):
    assert a.ids == b.ids
    np.testing.assert_allclose(a.base_used, b.base_used, atol=1e-4)
    np.testing.assert_allclose(a.free_ports, b.free_ports)
    assert a._net_bits == b._net_bits
    for i in range(a.n):
        assert sorted(x.id for x in a.live_allocs[i]) == \
            sorted(x.id for x in b.live_allocs[i])


def test_resident_table_reused_across_snapshots():
    s, _ = _store_with_nodes(4)
    t1 = s.snapshot().node_table()
    t2 = s.snapshot().node_table()
    assert t1 is t2  # same index -> same table object


def test_alloc_delta_matches_full_rebuild():
    s, nodes = _store_with_nodes(4)
    t0 = s.snapshot().node_table()  # prime the cache

    a1 = mock.alloc()
    a1.node_id = nodes[0].id
    a2 = mock.alloc()
    a2.node_id = nodes[1].id
    s.upsert_allocs(100, [a1, a2])

    snap = s.snapshot()
    t1 = snap.node_table()
    assert t1 is not t0
    _assert_tables_equal(t1, NodeTable.build_all(snap))

    # stop one alloc -> usage released via delta
    a1b = a1.copy()
    a1b.desired_status = ALLOC_DESIRED_STOP
    a1b.client_status = ALLOC_CLIENT_COMPLETE
    s.upsert_allocs(101, [a1b])
    snap2 = s.snapshot()
    t2 = snap2.node_table()
    _assert_tables_equal(t2, NodeTable.build_all(snap2))

    # old version untouched (MVCC): t1 still accounts a1
    i0 = t1.id_to_idx[nodes[0].id]
    assert any(x.id == a1.id for x in t1.live_allocs[i0])
    assert not any(x.id == a1.id for x in t2.live_allocs[i0])


def test_node_change_triggers_rebuild_and_ready_mask():
    s, nodes = _store_with_nodes(3)
    t0 = s.snapshot().node_table()
    assert bool(t0.ready.all())
    s.update_node_status(50, nodes[0].id, NODE_STATUS_DOWN)
    t1 = s.snapshot().node_table()
    assert t1 is not t0
    i = t1.id_to_idx[nodes[0].id]
    assert not t1.ready[i]
    assert bool(t0.ready.all())  # old version frozen


def test_port_bits_released_on_alloc_stop():
    s, nodes = _store_with_nodes(1)
    a = mock.alloc()  # mock alloc reserves ports via web task resources
    a.node_id = nodes[0].id
    s.upsert_allocs(10, [a])
    t1 = s.snapshot().node_table()
    free_with = float(t1.free_ports[0])

    a2 = a.copy()
    a2.desired_status = ALLOC_DESIRED_STOP
    a2.client_status = ALLOC_CLIENT_COMPLETE
    s.upsert_allocs(11, [a2])
    t2 = s.snapshot().node_table()
    snap_free = float(NodeTable.build_all(s.snapshot()).free_ports[0])
    assert float(t2.free_ports[0]) == snap_free
    assert float(t2.free_ports[0]) >= free_with


def test_older_snapshot_gets_private_build():
    s, nodes = _store_with_nodes(2)
    old_snap = s.snapshot()
    a = mock.alloc()
    a.node_id = nodes[0].id
    s.upsert_allocs(99, [a])
    s.snapshot().node_table()  # cache moves to index 99
    t_old = old_snap.node_table()  # older than cache -> private build
    i = t_old.id_to_idx[nodes[0].id]
    assert not any(x.id == a.id for x in t_old.live_allocs[i])


def test_changelog_truncation_forces_rebuild():
    s, nodes = _store_with_nodes(2)
    s.snapshot().node_table()
    s.CHANGELOG_MAX = 4  # shrink to force pruning (class attr override)
    s._changes = s._changes[:]
    for k in range(20):
        a = mock.alloc()
        a.node_id = nodes[k % 2].id
        s.upsert_allocs(200 + k, [a])
    snap = s.snapshot()
    t = snap.node_table()
    _assert_tables_equal(t, NodeTable.build_all(snap))


def test_hamt_update_transient_preserves_old_versions():
    h = Hamt()
    for i in range(100):
        h = h.set(i, i)
    h2 = h.update([(i, i * 2) for i in range(50)])
    assert all(h.get(i) == i for i in range(100))
    assert all(h2.get(i) == i * 2 for i in range(50))
    assert all(h2.get(i) == i for i in range(50, 100))
    assert len(h2) == 100


def test_store_roots_immutable_across_transactions():
    s = StateStore()
    node = mock.node()
    s.upsert_node(1, node)
    snap = s.snapshot()
    before = [n.id for n in snap.nodes()]
    for i in range(64):
        extra = mock.node()
        s.upsert_node(10 + i, extra)
    assert [n.id for n in snap.nodes()] == before
    assert len(s.snapshot().nodes()) == 65


def test_mask_cache_shared_across_alloc_deltas():
    s, nodes = _store_with_nodes(3)
    t0 = s.snapshot().node_table()
    t0.mask_cache[("probe",)] = [("r", np.ones(3, bool))]
    a = mock.alloc()
    a.node_id = nodes[0].id
    s.upsert_allocs(77, [a])
    t1 = s.snapshot().node_table()
    # alloc deltas keep node columns -> mask cache carried over
    assert ("probe",) in t1.mask_cache
    s.update_node_status(78, nodes[1].id, NODE_STATUS_DOWN)
    t2 = s.snapshot().node_table()
    # node change -> full rebuild -> fresh mask cache
    assert ("probe",) not in t2.mask_cache
