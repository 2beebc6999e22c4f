"""The port's device-resident node table (nomad_tpu_torch.ops.device_table)
on CPU tensors, where the scatter wrappers run their plain versions.

- The three row scatters against the JAX package's programs
  (`_scatter_set`, `DeviceNodeTable.overlay_used` with its own padding,
  `_feas_scatter`) on JAX's CPU backend: 20 numpy-seeded inputs at
  n = 1,000 (n_pad 1,024), D = 4, m in {0, 1, 7, 300}; exact equality,
  byte for byte (the functions do no rounding beyond one float32 add).
- Updates are out of place: an older DeviceTableState and a parked mask
  keep their values after a scatter, an overlay and a residue.
- The wrappers' host checks: a row out of range and a repeated overlay
  or feasibility row raise ValueError; distinct rows out of order are
  sorted (with their values) to the same result.
- scatter_set at SET_CASES (rows out of order, a repeated row with equal
  and with different values, tile edges, no row): against the JAX
  program where a repeated row carries one value and against each row's
  last value everywhere; numpy rows and values; the card path's host
  helper (`_set_rows`: sort, last-wins dedupe, the order it returns) and
  the layout of its one upload.
- The plain overlay_add and feas_scatter against the JAX programs at the
  fused kernels' edge shapes (EDGE_CASES: one row, rows 0 and n_pad - 1,
  the tiles' first and last rows, every row, an n_pad that is not a
  multiple of 16), byte for byte; and the host pack helper that feeds
  the kernels' one upload.
- The mirror tests of tests/test_table_deltas.py and the FeasMaskStore
  token test of tests/test_feasible_columnar.py, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import device_table as jdt
from nomad_tpu_torch.mock import fixtures as mock
from nomad_tpu_torch.models import (
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_RUNNING, ALLOC_DESIRED_STOP)
from nomad_tpu_torch.models.networks import Port
from nomad_tpu_torch.ops import device_table as tdt
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops.tables import NodeTable
from nomad_tpu_torch.state import StateStore
import test_torch_select  # noqa: F401  (torch's thread cap)

N, N_PAD, D = 1000, 1024, 4
CPU = torch.device("cpu")
SEEDS = range(20)
MS = [0, 1, 7, 300]


def _bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _inputs(seed, m):
    rng = np.random.default_rng(seed)
    used = np.zeros((N_PAD, D), np.float32)
    used[:N] = rng.uniform(0, 8000, (N, D)).astype(np.float32)
    ports = np.zeros(N_PAD, np.float32)
    ports[:N] = rng.integers(0, 12000, N).astype(np.float32)
    mask = np.zeros(N_PAD, bool)
    mask[:N] = rng.random(N) > 0.3
    rows = np.sort(rng.choice(N, m, replace=False)).astype(np.int32)
    vals = rng.uniform(-500, 500, (m, D)).astype(np.float32)
    port_rows = rng.integers(0, 12000, m).astype(np.float32)
    bits = rng.random(m) > 0.5
    return used, ports, mask, rows, vals, port_rows, bits


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_set_matches_jax(seed, m):
    used, ports, _mask, rows, vals, port_rows, _bits = _inputs(seed, m)
    want_u, want_p = jdt._scatter_set(jnp.asarray(used), jnp.asarray(ports),
                                      rows, vals, port_rows)
    got_u, got_p = kernels.scatter_set(
        torch.from_numpy(used), torch.from_numpy(ports),
        torch.from_numpy(rows), torch.from_numpy(vals),
        torch.from_numpy(port_rows))
    _bytes_equal(got_u.numpy(), want_u)
    _bytes_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("seed", SEEDS)
def test_overlay_add_matches_jax(seed, m):
    used, ports, _mask, rows, vals, _pr, _bits = _inputs(seed, m)
    jst = jdt.DeviceTableState(1, 1, N, N_PAD, None, jnp.asarray(used),
                               jnp.asarray(ports))
    want = jdt.DeviceNodeTable().overlay_used(jst, rows, vals)
    tst = tdt.DeviceTableState(1, 1, N, N_PAD, None, torch.from_numpy(used),
                               torch.from_numpy(ports))
    got = tdt.DeviceNodeTable().overlay_used(tst, rows, vals)
    _bytes_equal(got.numpy(), want)
    if m:
        # the host's base_used + plan_delta, which the dense path ships
        host = used.copy()
        delta = np.zeros_like(used)
        delta[rows] = vals
        _bytes_equal(got.numpy(), host + delta)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("seed", SEEDS)
def test_feas_scatter_matches_jax(seed, m):
    _u, _p, mask, rows, _v, _pr, bits = _inputs(seed, m)
    want = jdt._feas_scatter(jnp.asarray(mask), rows, bits)
    got = kernels.feas_scatter(torch.from_numpy(mask),
                               torch.from_numpy(rows),
                               torch.from_numpy(bits))
    _bytes_equal(got.numpy(), want)


def test_updates_are_out_of_place():
    used, ports, mask, rows, vals, port_rows, bits = _inputs(0, 7)
    st = tdt.DeviceTableState(1, 1, N, N_PAD, None, torch.from_numpy(used),
                              torch.from_numpy(ports))
    keep = (st.used.clone(), st.free_ports.clone())
    kernels.scatter_set(st.used, st.free_ports, torch.from_numpy(rows),
                        torch.from_numpy(vals), torch.from_numpy(port_rows))
    got = tdt.DeviceNodeTable().overlay_used(st, rows, vals)
    assert not torch.equal(got, st.used)
    assert torch.equal(st.used, keep[0])
    assert torch.equal(st.free_ports, keep[1])

    store = tdt.FeasMaskStore()
    tok = store.put("k", mask[:N], epoch=0, version=1, rows=None,
                    device=CPU)
    parked = store.resident(tok, N_PAD, CPU)
    before = parked.clone()
    out = store.apply_residue(parked, rows, bits)
    assert torch.equal(out[torch.from_numpy(rows).long()],
                       torch.from_numpy(bits))
    assert torch.equal(parked, before)
    assert torch.equal(store.resident(tok, N_PAD, CPU), before)


def test_mirror_state_unchanged_by_later_deltas():
    rng = np.random.RandomState(5)
    s, nodes = _store_with_nodes(6)
    t1 = s.snapshot().node_table()
    st1 = t1.device_mirror.arrays_for(t1, CPU)
    keep = [x.clone() for x in (st1.capacity, st1.used, st1.free_ports)]
    s.upsert_allocs(400, [_rand_alloc(rng, nodes) for _ in range(3)])
    t2 = s.snapshot().node_table()
    st2 = t2.device_mirror.arrays_for(t2, CPU)
    assert st2 is not st1 and not torch.equal(st2.used, st1.used)
    for old, new in zip(keep, (st1.capacity, st1.used, st1.free_ports)):
        assert torch.equal(old, new)


@pytest.mark.parametrize("which", ["scatter_set", "overlay_add",
                                   "feas_scatter"])
@pytest.mark.parametrize("bad", [-1, N_PAD])
def test_rows_out_of_range_raise(which, bad):
    used, ports, mask, rows, vals, port_rows, bits = _inputs(1, 7)
    rows = rows.copy()
    rows[3] = bad
    idx = torch.from_numpy(rows)
    with pytest.raises(ValueError):
        if which == "scatter_set":
            kernels.scatter_set(torch.from_numpy(used),
                                torch.from_numpy(ports), idx,
                                torch.from_numpy(vals),
                                torch.from_numpy(port_rows))
        elif which == "overlay_add":
            kernels.overlay_add(torch.from_numpy(used), idx,
                                torch.from_numpy(vals))
        else:
            kernels.feas_scatter(torch.from_numpy(mask), idx,
                                 torch.from_numpy(bits))


def test_repeated_overlay_row_raises():
    used, _p, _m, rows, vals, _pr, _b = _inputs(2, 7)
    # distinct rows out of order are taken
    perm = torch.from_numpy(rows[::-1].copy())
    got = kernels.overlay_add(torch.from_numpy(used), perm,
                              torch.from_numpy(vals[::-1].copy()))
    want = kernels.overlay_add(torch.from_numpy(used),
                               torch.from_numpy(rows),
                               torch.from_numpy(vals))
    assert torch.equal(got, want)
    rows = rows.copy()
    rows[4] = rows[2]
    with pytest.raises(ValueError):
        kernels.overlay_add(torch.from_numpy(used), torch.from_numpy(rows),
                            torch.from_numpy(vals))


# The fused overlay_add / feas_scatter kernels work in tiles of 256 rows
# (overlay_add) and 4,096 (feas_scatter), 16 mask bytes a thread: the
# edge shapes a tile search or a ragged tail could get wrong, as
# (n_pad, rows every case holds, rows drawn at random besides).
EDGE_CASES = {
    "one_row": (1001, [517], 0),
    "first_and_last": (1001, [0, 1000], 0),
    "tile_edges": (8200, [0, 255, 256, 511, 4095, 4096, 8191, 8192, 8199],
                   0),
    "every_row": (37, list(range(37)), 0),
    "ragged_10001": (10_001, [0, 9999, 10_000], 300),
}


def edge_inputs(label, d=D):
    """(used [n_pad, d], mask [n_pad], sorted distinct rows, vals [m, d],
    bits [m]) of one edge case, from a seed."""
    n_pad, fixed, extra = EDGE_CASES[label]
    rng = np.random.default_rng(sorted(EDGE_CASES).index(label))
    rows = np.unique(np.concatenate(
        [np.asarray(fixed, np.int64),
         rng.choice(n_pad, extra, replace=False)])).astype(np.int32)
    m = rows.size
    used = rng.uniform(0, 8000, (n_pad, d)).astype(np.float32)
    mask = rng.random(n_pad) > 0.3
    vals = rng.uniform(-500, 500, (m, d)).astype(np.float32)
    bits = rng.random(m) > 0.5
    return used, mask, rows, vals, bits


@pytest.mark.parametrize("label", sorted(EDGE_CASES))
@pytest.mark.parametrize("which", ["overlay_add", "feas_scatter"])
def test_edge_shapes_match_jax(which, label):
    used, mask, rows, vals, bits = edge_inputs(label)
    idx = torch.from_numpy(rows)
    if which == "overlay_add":
        want = jdt._overlay_add(jnp.asarray(used), rows, vals)
        got = kernels.overlay_add_plain(torch.from_numpy(used), idx,
                                        torch.from_numpy(vals))
    else:
        want = jdt._feas_scatter(jnp.asarray(mask), rows, bits)
        got = kernels.feas_scatter_plain(torch.from_numpy(mask), idx,
                                         torch.from_numpy(bits))
    _bytes_equal(got.numpy(), want)


@pytest.mark.parametrize("m,d,kind", [(1, 4, "f32"), (7, 4, "f32"),
                                      (300, 3, "f32"), (5, 1, "bool"),
                                      (4096, 1, "bool")])
def test_pack_host_round_trips(m, d, kind):
    """One buffer holds the rows at offset 0 and the values at the next
    16-byte boundary (where a vector load may read them), byte for byte;
    an order vector packs the same way."""
    rng = np.random.default_rng(m)
    rows = np.sort(rng.choice(10_000, m, replace=False)).astype(np.int32)
    if kind == "f32":
        vals = rng.uniform(-500, 500, (m, d)).astype(np.float32)
    else:
        vals = (rng.random(m) > 0.5).view(np.uint8)
    order = rng.permutation(m).astype(np.int32)
    buf, offs = kernels.pack_host([rows, vals, order])
    assert buf.dtype == torch.uint8 and buf.device.type == "cpu"
    assert offs[0] == 0 and all(o % 16 == 0 for o in offs)
    assert offs[1] >= rows.nbytes and offs[2] >= offs[1] + vals.nbytes
    assert buf.numel() == offs[2] + order.nbytes
    raw = buf.numpy()
    for o, want in zip(offs, (rows, vals, order)):
        got = raw[o:o + want.nbytes].view(want.dtype).reshape(want.shape)
        _bytes_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_rows_sort_unsorted_rows(seed):
    """Distinct rows in any order: the wrapper's host check hands the
    kernel the rows sorted with the order that sorts them, and
    feas_scatter and overlay_add give the sorted rows' result."""
    used, mask, rows, vals, bits = edge_inputs("ragged_10001")
    perm = np.random.default_rng(seed).permutation(rows.size)
    shuffled = torch.from_numpy(rows[perm].copy())
    got_rows, order = kernels._patch_rows(shuffled, mask.size)
    assert np.array_equal(got_rows, rows)
    assert np.array_equal(rows[perm][order], rows)
    sorted_rows, none = kernels._patch_rows(torch.from_numpy(rows),
                                            mask.size)
    assert none is None and np.array_equal(sorted_rows, rows)
    want = kernels.feas_scatter(torch.from_numpy(mask),
                                torch.from_numpy(rows),
                                torch.from_numpy(bits))
    got = kernels.feas_scatter(torch.from_numpy(mask), shuffled,
                               torch.from_numpy(bits[perm].copy()))
    assert torch.equal(got, want)
    want = kernels.overlay_add(torch.from_numpy(used),
                               torch.from_numpy(rows),
                               torch.from_numpy(vals))
    got = kernels.overlay_add(torch.from_numpy(used), shuffled,
                              torch.from_numpy(vals[perm].copy()))
    assert torch.equal(got, want)


@pytest.mark.parametrize("where", ["adjacent", "apart"])
def test_repeated_feas_row_raises(where):
    _u, mask, rows, _v, bits = edge_inputs("ragged_10001")
    rows = rows.copy()
    if where == "adjacent":
        rows[4] = rows[3]
    else:
        rows = rows[::-1].copy()
        rows[0] = rows[-1]
    with pytest.raises(ValueError, match="repeat"):
        kernels.feas_scatter(torch.from_numpy(mask), torch.from_numpy(rows),
                             torch.from_numpy(bits))


@pytest.mark.parametrize("end", ["first", "last"])
@pytest.mark.parametrize("which", ["overlay_add", "feas_scatter"])
def test_sorted_rows_out_of_range_raise(which, end):
    """Increasing rows skip the sort: their range is read off the ends."""
    used, mask, rows, vals, bits = edge_inputs("ragged_10001")
    rows = rows.copy()
    if end == "first":
        rows[0] = -1
    else:
        rows[-1] = mask.size
    idx = torch.from_numpy(rows)
    with pytest.raises(ValueError, match="outside"):
        if which == "overlay_add":
            kernels.overlay_add(torch.from_numpy(used), idx,
                                torch.from_numpy(vals))
        else:
            kernels.feas_scatter(torch.from_numpy(mask), idx,
                                 torch.from_numpy(bits))


# scatter_set's shapes: the fused kernel's tiles (256 rows), and the row
# lists a repeat-tolerant `.at[idx].set` takes, as (n_pad, rows every case
# holds, rows drawn at random besides, how they are arranged). "offset" is
# "out_of_order" on a column 4 bytes off alignment (on the card).
SET_CASES = {
    "one_row": (1001, [517], 0, "sorted"),
    "tile_edges": (8200, [0, 255, 256, 511, 4095, 4096, 8191, 8192, 8199],
                   0, "sorted"),
    "ragged_10001": (10_001, [0, 9999, 10_000], 300, "sorted"),
    "out_of_order": (10_001, [0, 10_000], 200, "shuffled"),
    "offset": (10_001, [0, 10_000], 200, "shuffled"),
    "repeated_equal": (1000, [3, 999], 40, "repeat_equal"),
    "repeated_different": (1000, [3, 999], 40, "repeat_different"),
    "empty": (1000, [], 0, "sorted"),
}


def set_case(label):
    """(used [n_pad, 4], ports [n_pad], rows, used_rows, port_rows) of one
    scatter_set case, from a seed. A repeated row comes back at random
    places in rows, with its first value (repeat_equal) or a new one."""
    n_pad, fixed, extra, how = SET_CASES[label]
    rng = np.random.default_rng(100 + sorted(SET_CASES).index(label))
    rows = np.unique(np.concatenate(
        [np.asarray(fixed, np.int64),
         rng.choice(n_pad, extra, replace=False)])).astype(np.int32)
    used = rng.uniform(0, 8000, (n_pad, D)).astype(np.float32)
    ports = rng.integers(0, 12000, n_pad).astype(np.float32)
    vals = rng.uniform(-500, 500, (rows.size, D)).astype(np.float32)
    prow = rng.integers(0, 12000, rows.size).astype(np.float32)
    if how.startswith("repeat"):
        again = rng.choice(rows.size, 6, replace=False)
        rows = np.concatenate([rows, rows[again]])
        more_v = vals[again] if how == "repeat_equal" else \
            rng.uniform(-500, 500, (6, D)).astype(np.float32)
        more_p = prow[again] if how == "repeat_equal" else \
            rng.integers(0, 12000, 6).astype(np.float32)
        vals, prow = np.concatenate([vals, more_v]), np.concatenate(
            [prow, more_p])
    if how != "sorted":
        perm = rng.permutation(rows.size)
        rows, vals, prow = rows[perm], vals[perm], prow[perm]
    return used, ports, rows, vals, prow


@pytest.mark.parametrize("label", sorted(SET_CASES))
def test_scatter_set_cases_match_jax(label):
    """scatter_set (the plain version, here) at its edge shapes: against
    the JAX package's `_scatter_set` where a repeated row carries one
    value (its semantics are defined there), and against the last value
    of each repeated row, set in order on the host, everywhere."""
    used, ports, rows, vals, prow = set_case(label)
    got_u, got_p = kernels.scatter_set(
        torch.from_numpy(used), torch.from_numpy(ports),
        torch.from_numpy(rows), torch.from_numpy(vals),
        torch.from_numpy(prow))
    want_u, want_p = used.copy(), ports.copy()
    for r, v, p in zip(rows, vals, prow):
        want_u[r], want_p[r] = v, p
    _bytes_equal(got_u.numpy(), want_u)
    _bytes_equal(got_p.numpy(), want_p)
    if label != "repeated_different":
        ju, jp = jdt._scatter_set(jnp.asarray(used), jnp.asarray(ports),
                                  rows, vals, prow)
        _bytes_equal(got_u.numpy(), ju)
        _bytes_equal(got_p.numpy(), jp)


@pytest.mark.parametrize("label", sorted(SET_CASES))
def test_scatter_set_takes_numpy_rows_and_values(label):
    """The host table's numpy rows and values give the tensors' result."""
    used, ports, rows, vals, prow = set_case(label)
    u, p = torch.from_numpy(used), torch.from_numpy(ports)
    a = kernels.scatter_set(u, p, rows, vals, prow)
    b = kernels.scatter_set(u, p, torch.from_numpy(rows),
                            torch.from_numpy(vals), torch.from_numpy(prow))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("label", sorted(SET_CASES))
def test_set_rows_sort_and_keep_each_rows_last_value(label):
    """The card path's host helper: rows sorted and distinct, each the
    last occurrence of its row in idx, order None only when idx was
    strictly increasing; the kernel's slot k takes values[order[k]]."""
    used, _p, rows, vals, _pr = set_case(label)
    got, order = kernels._set_rows(rows, used.shape[0])
    assert np.array_equal(got, np.unique(rows))
    if order is None:
        assert np.array_equal(got, rows)
        assert rows.size < 2 or (rows[1:] > rows[:-1]).all()
        return
    assert order.dtype == np.int32
    assert np.array_equal(rows[order], got)
    last = {int(r): i for i, r in enumerate(rows)}
    assert order.tolist() == [last[int(r)] for r in got]


@pytest.mark.parametrize("end", ["first", "last"])
@pytest.mark.parametrize("how", ["sorted", "shuffled"])
def test_scatter_set_rows_out_of_range_raise(how, end):
    used, ports, rows, vals, prow = set_case(
        "ragged_10001" if how == "sorted" else "out_of_order")
    rows = rows.copy()
    pos = np.argmin(rows) if end == "first" else np.argmax(rows)
    rows[pos] = -1 if end == "first" else used.shape[0]
    with pytest.raises(ValueError, match="outside"):
        kernels.scatter_set(torch.from_numpy(used), torch.from_numpy(ports),
                            rows, vals, prow)


def test_scatter_set_pack_layout():
    """The one upload of a scatter_set call from the host: the sorted rows
    at offset 0, then the used rows and the port rows in the rows' sorted
    order (each at a 16-byte boundary), byte for byte."""
    used, _p, rows, vals, prow = set_case("repeated_different")
    got, order = kernels._set_rows(rows, used.shape[0])
    buf, offs = kernels.pack_host([got, vals[order], prow[order]])
    raw = buf.numpy()
    assert offs[0] == 0 and all(o % 16 == 0 for o in offs)
    for o, want in zip(offs, (got, vals[order], prow[order])):
        _bytes_equal(raw[o:o + want.nbytes].view(want.dtype).reshape(
            want.shape), want)
    assert buf.numel() == offs[2] + prow[order].nbytes


@pytest.mark.parametrize("label", sorted(EDGE_CASES))
def test_overlay_used_at_edge_shapes_matches_jax(label):
    """DeviceNodeTable.overlay_used over a table of the edge case's size
    (the overlay too dense to scatter, every_row, falls back in both)."""
    used, _mask, rows, vals, _bits = edge_inputs(label)
    n = used.shape[0]
    ports = np.zeros(n, np.float32)
    jst = jdt.DeviceTableState(1, 1, n, n, None, jnp.asarray(used),
                               jnp.asarray(ports))
    want = jdt.DeviceNodeTable().overlay_used(jst, rows, vals)
    tst = tdt.DeviceTableState(1, 1, n, n, None, torch.from_numpy(used),
                               torch.from_numpy(ports))
    got = tdt.DeviceNodeTable().overlay_used(tst, rows, vals)
    if want is None:
        assert got is None and label == "every_row"
    else:
        _bytes_equal(got.numpy(), want)


@pytest.mark.parametrize("label", sorted(EDGE_CASES))
def test_feas_store_patch_and_residue_match_jax(label):
    """A parked mask patched by put() with journal rows mapped to table
    space (distinct, in no order: the feasibility compiler's rows), then a
    per-eval residue of sorted rows: the parked and the scattered masks
    equal the JAX package's FeasMaskStore's byte for byte."""
    _u, mask, rows, _v, bits = edge_inputs(label)
    n = mask.size
    n_pad = tdt._pad_n(n)
    journal = np.random.default_rng(n).permutation(rows)
    mask2 = mask.copy()
    mask2[rows] = ~mask2[rows]
    jstore, tstore = jdt.FeasMaskStore(), tdt.FeasMaskStore()
    jstore.put("k", mask, 0, 1, None)
    tstore.put("k", mask, 0, 1, None, CPU)
    jtok = jstore.put("k", mask2, 0, 2, [int(r) for r in journal])
    ttok = tstore.put("k", mask2, 0, 2, [int(r) for r in journal], CPU)
    assert ttok == jtok
    jarr = jstore.resident(jtok, n_pad)
    tarr = tstore.resident(ttok, n_pad, CPU)
    _bytes_equal(tarr.numpy(), jarr)
    assert tstore.stats["scatters"] == jstore.stats["scatters"]
    _bytes_equal(tstore.apply_residue(tarr, rows, bits).numpy(),
                 jstore.apply_residue(jarr, rows, bits))


# -- the mirror tests of tests/test_table_deltas.py, on the port ---------

def _store_with_nodes(n):
    s = StateStore()
    nodes = []
    for i in range(n):
        node = mock.node()
        node.name = f"node-{i}"
        nodes.append(node)
        s.upsert_node(i + 1, node)
    return s, nodes


_PORT_SEQ = iter(range(20000, 60000))


def _rand_alloc(rng, nodes):
    a = mock.alloc()
    a.node_id = nodes[rng.randint(len(nodes))].id
    a.client_status = ALLOC_CLIENT_RUNNING
    res = a.allocated_resources.tasks["web"]
    res.cpu.cpu_shares = int(rng.randint(10, 800))
    res.memory.memory_mb = int(rng.randint(16, 1024))
    res.networks[0].reserved_ports = [Port(label="admin",
                                           value=next(_PORT_SEQ))]
    res.networks[0].dynamic_ports = []
    return a


def _assert_mirror_parity(t: NodeTable, step):
    st = t.device_mirror.arrays_for(t, CPU)
    assert st is not None, f"mirror stale for served table at {step}"
    assert torch.equal(st.used[:t.n], torch.from_numpy(t.base_used)), step
    assert torch.equal(st.free_ports[:t.n],
                       torch.from_numpy(t.free_ports.astype(np.float32))), \
        step
    assert torch.equal(st.capacity[:t.n], torch.from_numpy(t.capacity)), \
        step


def test_randomized_deltas_keep_mirror_parity():
    """Randomized plan sequences (adds / stops / in-place updates) ride the
    delta path; the mirror, advanced by scatters, equals the host table
    row for row every 10 steps."""
    rng = np.random.RandomState(7)
    s, nodes = _store_with_nodes(12)
    cache = s.table_cache
    _assert_mirror_parity(s.snapshot().node_table(), "init")
    builds0 = cache.stats["full_builds"]
    live = []
    idx = 100
    for step in range(200):
        batch = []
        for _ in range(rng.randint(1, 4)):
            a = _rand_alloc(rng, nodes)
            batch.append(a)
            live.append(a)
        if len(live) > 4 and rng.rand() < 0.5:
            for _ in range(rng.randint(1, 3)):
                v = live.pop(rng.randint(len(live)))
                v2 = v.copy()
                v2.desired_status = ALLOC_DESIRED_STOP
                v2.client_status = ALLOC_CLIENT_COMPLETE
                batch.append(v2)
        if live and rng.rand() < 0.3:
            v = live[rng.randint(len(live))]
            v2 = v.copy()
            v2.allocated_resources = v.allocated_resources.copy()
            v2.allocated_resources.tasks["web"].cpu.cpu_shares = \
                int(rng.randint(10, 800))
            live[live.index(v)] = v2
            batch.append(v2)
        idx += 1
        s.upsert_allocs(idx, batch)
        t = s.snapshot().node_table()
        if step % 10 == 0:
            _assert_mirror_parity(t, step)
    assert cache.stats["full_builds"] == builds0
    assert cache.device.stats["scatters"] > 0
    assert cache.device.stats["uploads"] == 1
    assert cache.device_delta_debt() > 0
    # capacity and used (16 rows x 4 float32 each) + free_ports
    assert cache.device_mirror_bytes() == 16 * 4 * 4 * 2 + 16 * 4


def test_wide_delta_folds():
    """A refresh touching most of the table's rows re-uploads instead of
    scattering (SPARSE_MAX_FRAC) and counts as a fold."""
    rng = np.random.RandomState(11)
    s, nodes = _store_with_nodes(8)
    _assert_mirror_parity(s.snapshot().node_table(), "init")
    batch = []
    for i in range(len(nodes) * 3):
        a = _rand_alloc(rng, nodes)
        a.node_id = nodes[i % len(nodes)].id
        batch.append(a)
    s.upsert_allocs(200, batch)
    t2 = s.snapshot().node_table()
    assert s.table_cache.device.stats["folds"] >= 1
    assert s.table_cache.device.stats["scatters"] == 0
    _assert_mirror_parity(t2, "wide")


def test_stale_table_version_gets_dense_fallback():
    rng = np.random.RandomState(3)
    s, nodes = _store_with_nodes(4)
    t1 = s.snapshot().node_table()
    assert t1.device_mirror.arrays_for(t1, CPU) is not None
    s.upsert_allocs(300, [_rand_alloc(rng, nodes)])
    t2 = s.snapshot().node_table()
    assert t1.device_version != t2.device_version
    assert t1.device_mirror.arrays_for(t1, CPU) is None
    assert t2.device_mirror.arrays_for(t2, CPU) is not None


def test_mirror_serves_only_its_device():
    s, _nodes = _store_with_nodes(4)
    t = s.snapshot().node_table()
    mirror = t.device_mirror
    assert mirror.device is None
    assert mirror.arrays_for(t, CPU) is not None
    assert mirror.device == CPU
    assert mirror.arrays_for(t, torch.device("meta")) is None


def test_fold_refuses_stale_table():
    rng = np.random.RandomState(13)
    s, nodes = _store_with_nodes(4)
    t1 = s.snapshot().node_table()
    t1.device_mirror.arrays_for(t1, CPU)
    s.upsert_allocs(700, [_rand_alloc(rng, nodes)])
    t2 = s.snapshot().node_table()
    assert not t2.device_mirror.fold(t1, t1.device_version)["folded"]
    assert s.table_cache.fold_device()["folded"]
    assert s.table_cache.device_delta_debt() == 0
    _assert_mirror_parity(t2, "post fold")


def test_delta_journal_and_rebuild():
    rng = np.random.RandomState(17)
    s, nodes = _store_with_nodes(4)
    cache = s.table_cache
    t1 = s.snapshot().node_table()
    s.upsert_allocs(800, [_rand_alloc(rng, nodes)])
    s.upsert_allocs(801, [_rand_alloc(rng, nodes)])
    t2 = s.snapshot().node_table()
    ent = cache.device.deltas_since(t1.device_version)
    assert [v for v, _r in ent] == [t2.device_version]
    assert cache.device_delta_log_len() == 1
    epoch0 = cache.device.epoch
    late = mock.node()
    late.name = "late-joiner"
    s.upsert_node(900, late)
    t3 = s.snapshot().node_table()
    assert t3.n == t2.n + 1
    assert cache.device.epoch == epoch0 + 1
    assert cache.device_delta_log_len() == 0
    assert cache.device.deltas_since(t1.device_version) is None


def test_feas_mask_store_tokens():
    """put/peek/resident token discipline: full upload, row-scatter patch
    within an epoch, and stale-token refusal (the JAX package's
    tests/test_feasible_columnar.py::test_feas_mask_store_tokens)."""
    s = tdt.FeasMaskStore()
    mask = np.array([True, False, True, False, True], dtype=bool)
    n_pad = tdt._pad_n(len(mask))
    tok = s.put("k", mask, epoch=0, version=5, rows=None, device=CPU)
    assert tok == ("k", 0, 5, 5)
    assert s.peek("k") == (0, 5)
    arr = s.resident(tok, n_pad, CPU)
    assert arr is not None
    assert np.array_equal(arr.numpy()[:5], mask)
    assert s.stats["uploads"] == 1

    mask2 = mask.copy()
    mask2[1] = True
    tok2 = s.put("k", mask2, epoch=0, version=6, rows=[1], device=CPU)
    assert s.stats["scatters"] == 1
    arr2 = s.resident(tok2, n_pad, CPU)
    assert np.array_equal(arr2.numpy()[:5], mask2)
    assert np.array_equal(arr.numpy()[:5], mask)      # out of place
    assert s.resident(tok, n_pad, CPU) is None
    assert s.stats["stale"] == 1
    assert s.resident(tok2, n_pad * 2, CPU) is None
    assert s.resident(tok2, n_pad, torch.device("meta")) is None
    tok3 = s.put("k", mask2, epoch=1, version=7, rows=[1], device=CPU)
    assert s.stats["uploads"] == 2
    assert s.resident(tok3, n_pad, CPU) is not None
