"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: they skip where no CUDA device is present, and run on
the GPU with `python -m pytest tests/test_torch_cuda.py -q`."""

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
from nomad_tpu_torch.state.carry import select_request_from_arrays
from test_torch_device_table import EDGE_CASES, edge_inputs, set_case
from test_torch_kway import EDGE_CASES as KWAY_EDGE_CASES
from test_torch_kway import kway_edge_args
from nomad_tpu_torch.mock.kway_edges import pad_rows
from nomad_tpu_torch.mock.chunked_edges import (
    CHUNKED_EDGES, CHUNKED_LANES, chunked_edge_args, chunked_lanes,
    edge_rows, one_lane, pad_lanes)
from nomad_tpu_torch.mock.scan_edges import (
    SCAN_EDGES, edge_case as scan_edge_case, lanes_batch as scan_lanes_batch,
    mixed_lanes as scan_mixed_lanes)
from test_torch_select import N_NODES, _fields

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same(got, want):
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        assert g.shape == w.shape
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=0.0, atol=1e-6)
        else:
            assert torch.equal(g.to(w.dtype), w)


@pytest.mark.parametrize("kind", ["chunked", "kway", "scan"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kernel_matches_plain_on_card(cuda, kind, seed):
    req = select_request_from_arrays(_fields(seed, kind))
    n_pad = tsel._pad_n(N_NODES)
    args, st = tsel.pack_request(req, n_pad)
    sk = tsel.SelectKernel(cuda)
    if kind == "scan":
        targs = sk._tensors(args, tsel._SCAN_ARGS)
        kw = dict(k_steps=tsel._bucket_k(req.count), **st)
        run, plain = kernels.select_scan, kernels.scan_plain
    elif kind == "kway":
        targs = sk._tensors(args, tsel._CHUNKED_ARGS)
        w = tsel._kway_w(n_pad)
        kw = dict(max_steps=tsel._kway_steps(w),
                  spread_alg=st["spread_alg"], w=w)
        run, plain = kernels.select_kway, kernels.kway_plain
    else:
        targs = sk._tensors(args, tsel._CHUNKED_ARGS)
        kw = dict(max_steps=64, spread_alg=st["spread_alg"])
        run, plain = kernels.select_chunked, kernels.chunked_plain
    before = kernels.LAUNCHES[kind]
    got = run(**targs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kind] == before + 1
    want = plain(**targs, **kw)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])


@pytest.mark.parametrize("m", [1, 37])
def test_table_kernels_match_plain_on_card(cuda, m):
    """scatter_set, overlay_add and feas_scatter against their plain
    versions on the card, exactly, with their inputs left unchanged."""
    rng = np.random.default_rng(m)
    n_pad, d = 256, 4
    used = torch.from_numpy(
        rng.uniform(0, 8000, (n_pad, d)).astype(np.float32)).to(cuda)
    ports = torch.from_numpy(
        rng.integers(0, 12000, n_pad).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(rng.random(n_pad) > 0.3).to(cuda)
    idx = torch.from_numpy(np.sort(
        rng.choice(200, m, replace=False)).astype(np.int32))
    vals = torch.from_numpy(
        rng.uniform(-500, 500, (m, d)).astype(np.float32))
    prow = torch.from_numpy(rng.integers(0, 12000, m).astype(np.float32))
    bits = torch.from_numpy(rng.random(m) > 0.5)
    keep = [t.clone() for t in (used, ports, mask)]
    cases = [
        ("scatter_set", kernels.scatter_set, kernels.scatter_set_plain,
         (used, ports, idx, vals, prow)),
        ("overlay_add", kernels.overlay_add, kernels.overlay_add_plain,
         (used, idx, vals)),
        ("feas_scatter", kernels.feas_scatter, kernels.feas_scatter_plain,
         (mask, idx, bits)),
    ]
    for name, run, plain, args in cases:
        before = kernels.LAUNCHES[name]
        got = run(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.device == w.device and torch.equal(g, w), name
    for t, k in zip((used, ports, mask), keep):
        assert torch.equal(t, k)


def _fused_case(cuda, which, used, mask, rows, vals, bits, vals_on):
    """(wrapper, plain, args) of overlay_add or feas_scatter, with the row
    values on the host (the main path's case) or on the card."""
    idx = torch.from_numpy(rows)
    v = torch.from_numpy(vals if which == "overlay_add" else bits)
    if vals_on == "card":
        v = v.to(cuda)
    if which == "overlay_add":
        return kernels.overlay_add, kernels.overlay_add_plain, (used, idx, v)
    return kernels.feas_scatter, kernels.feas_scatter_plain, (mask, idx, v)


def _held_once(which, run, plain, args):
    """One wrapper call: one launch, equal to the plain version bit for
    bit, its input column left as it was."""
    keep = args[0].clone()
    before = kernels.LAUNCHES[which]
    got = run(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[which] == before + 1
    want = plain(*args)
    assert got.device == want.device and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(args[0], keep)


@pytest.mark.parametrize("vals_on", ["host", "card"])
@pytest.mark.parametrize("label", sorted(EDGE_CASES))
@pytest.mark.parametrize("which", ["overlay_add", "feas_scatter"])
def test_fused_scatter_edge_shapes_on_card(cuda, which, label, vals_on):
    used, mask, rows, vals, bits = edge_inputs(label)
    run, plain, args = _fused_case(
        cuda, which, torch.from_numpy(used).to(cuda),
        torch.from_numpy(mask).to(cuda), rows, vals, bits, vals_on)
    _held_once(which, run, plain, args)


@pytest.mark.parametrize("vals_on", ["host", "card"])
@pytest.mark.parametrize("which", ["overlay_add", "feas_scatter"])
def test_fused_scatter_scalar_paths_on_card(cuda, which, vals_on):
    """Columns 4 bytes off 16-byte alignment (a slice), and a used column
    of D = 3, take the kernels' scalar paths; rows out of order take the
    sort (host values) or the uploaded order (values on the card)."""
    used, mask, rows, vals, bits = edge_inputs("ragged_10001")
    n = mask.size
    flat = torch.empty(n * 4 + 1, dtype=torch.float32, device=cuda)
    off_used = flat[1:].view(n, 4)
    off_used.copy_(torch.from_numpy(used))
    raw = torch.empty(n + 4, dtype=torch.bool, device=cuda)
    off_mask = raw[4:]
    off_mask.copy_(torch.from_numpy(mask))
    assert off_used.data_ptr() % 16 == 4 and off_mask.data_ptr() % 16 == 4
    perm = np.random.default_rng(3).permutation(rows.size)
    cases = [(off_used, off_mask, rows, vals, bits),
             (off_used, off_mask, rows[perm].copy(), vals[perm].copy(),
              bits[perm].copy())]
    if which == "overlay_add":
        u3, _m, r3, v3, b3 = edge_inputs("ragged_10001", d=3)
        cases.append((torch.from_numpy(u3).to(cuda), off_mask, r3, v3, b3))
    for u, mk, r, v, b in cases:
        run, plain, args = _fused_case(cuda, which, u, mk, r, v, b, vals_on)
        _held_once(which, run, plain, args)


def test_fused_scatters_make_no_synchronising_call(cuda):
    """overlay_add and feas_scatter, given host rows and host values as
    the main path gives them, run under sync debug mode "error": one
    asynchronous upload of a pinned buffer, no synchronising copy."""
    used, mask, rows, vals, bits = edge_inputs("ragged_10001")
    u = torch.from_numpy(used).to(cuda)
    mk = torch.from_numpy(mask).to(cuda)
    kernels.load_library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = kernels.overlay_add(u, torch.from_numpy(rows),
                                torch.from_numpy(vals))
        b = kernels.feas_scatter(mk, torch.from_numpy(rows),
                                 torch.from_numpy(bits))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    idx = torch.from_numpy(rows)
    assert torch.equal(a, kernels.overlay_add_plain(u, idx,
                                                    torch.from_numpy(vals)))
    assert torch.equal(b, kernels.feas_scatter_plain(
        mk, idx, torch.from_numpy(bits)))


@pytest.mark.parametrize("label", ["one_row", "tile_edges", "ragged_10001",
                                   "out_of_order", "repeated_equal",
                                   "repeated_different", "offset"])
@pytest.mark.parametrize("vals_on", ["host", "card"])
def test_scatter_set_edge_shapes_on_card(cuda, label, vals_on):
    """The fused scatter_set: one launch writing both columns, equal bit
    for bit to scatter_set_plain on the CPU (where a repeated row's last
    value wins), its inputs left as they were; columns 4 bytes off
    alignment take the scalar path."""
    used, ports, rows, vals, prow = set_case(label)
    u, p = torch.from_numpy(used).to(cuda), torch.from_numpy(ports).to(cuda)
    if label == "offset":
        flat = torch.empty(u.numel() + 1, dtype=torch.float32, device=cuda)
        flat[1:].copy_(u.view(-1))
        u = flat[1:].view(u.shape)
        assert u.data_ptr() % 16 == 4
    v, pv = torch.from_numpy(vals), torch.from_numpy(prow)
    if vals_on == "card":
        v, pv = v.to(cuda), pv.to(cuda)
    keep = (u.clone(), p.clone())
    before = kernels.LAUNCHES["scatter_set"]
    got = kernels.scatter_set(u, p, torch.from_numpy(rows), v, pv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_set"] == before + 1
    want = kernels.scatter_set_plain(
        torch.from_numpy(used), torch.from_numpy(ports),
        torch.from_numpy(rows), torch.from_numpy(vals),
        torch.from_numpy(prow))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
    assert torch.equal(u, keep[0]) and torch.equal(p, keep[1])


def test_scatter_set_makes_no_synchronising_call(cuda):
    """scatter_set, given host rows and host values (numpy, as the mirror
    gives them), runs under sync debug mode "error"."""
    used, ports, rows, vals, prow = set_case("out_of_order")
    u, p = torch.from_numpy(used).to(cuda), torch.from_numpy(ports).to(cuda)
    kernels.load_library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.scatter_set(u, p, rows, vals, prow)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kernels.scatter_set_plain(u, p, torch.from_numpy(rows),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(prow))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _on(cuda, args):
    return {k: torch.from_numpy(v).to(cuda) if isinstance(v, np.ndarray)
            else v.item() if isinstance(v, np.generic) else v
            for k, v in args.items()}


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(KWAY_EDGE_CASES))
def test_kway_edge_shapes_on_card(cuda, label, spread_alg):
    """The K-way kernel (radix top-(W + 1), winner-only rescoring, streams
    that stop at their first loser) at the edge shapes, with a 2-phase
    budget so that launches continue from the card's own carry: every
    launch equal to kway_plain bit for bit."""
    n, count, kind = KWAY_EDGE_CASES[label]
    w = tsel._kway_w(tsel._pad_n(n))
    targs = _on(cuda, kway_edge_args(n, count, kind, w, seed=1))
    kw = dict(max_steps=2, spread_alg=spread_alg, w=w)
    for _launch in range(6):
        got = kernels.select_kway(**targs, **kw)
        torch.cuda.synchronize()
        want = kernels.kway_plain(**targs, **kw)
        _assert_equal(got[0], want[0])
        _assert_equal(got[1], want[1])
        packed = got[1][0]
        rem = int(packed[0, -2])
        if rem <= 0 or int(packed[:, w:2 * w].sum()) == 0:
            break
        used, coll, freep, devs = got[0]
        targs.update(used0=used, tg_coll0=coll, free_ports=freep,
                     dev_slots0=devs, k_valid=rem)


def test_kway_batched_mixed_lanes_on_card(cuda):
    """Four K-way lanes over one capacity table with mixed counts and
    feasibility (10, 600 and 600 instances, the last lane with no feasible
    row): the batched launch equals the batched plain version and each
    lane's solo kernel, exactly."""
    n, w = 200, 32
    lanes = [kway_edge_args(n, c, kind, w, seed=2)
             for c, kind in ((10, "random"), (600, "random"), (600, "few"),
                             (600, "none"))]
    targs = {}
    for k in lanes[0]:
        if k == "capacity":
            targs[k] = lanes[0][k]
        elif k == "k_valid":
            targs[k] = np.array([ln[k] for ln in lanes], np.int32)
        elif isinstance(lanes[0][k], np.ndarray):
            targs[k] = np.stack([ln[k] for ln in lanes])
        else:
            targs[k] = np.array([ln[k] for ln in lanes], np.float32)
    targs = _on(cuda, targs)
    kw = dict(max_steps=tsel._kway_steps(w), spread_alg=False, w=w)
    got = kernels.select_kway_batched(**targs, **kw)
    torch.cuda.synchronize()
    want = kernels.kway_batched_plain(**targs, **kw)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    for i in range(len(lanes)):
        s_carry, s_outs = kernels.select_kway(**kernels.lane_args(targs, i),
                                              **kw)
        _assert_equal([t[i] for t in got[0]], s_carry)
        _assert_equal([t[i] for t in got[1]], s_outs)


def _chunked_launches(targs, kw, count, launches=4):
    """The chunked kernel as SelectKernel's loop runs it: each launch after
    the first continues from the carry the last one left on the card, and
    a first launch that drains the count is followed by one continuation
    (half the count, from its carry) all the same; every launch equal to
    chunked_plain bit for bit. Returns the (steps, remaining) a launch."""
    args, trail = dict(targs), []
    for launch in range(launches):
        got = kernels.select_chunked(**args, **kw)
        torch.cuda.synchronize()
        want = kernels.chunked_plain(**args, **kw)
        _assert_equal(got[0], want[0])
        _assert_equal(got[1], want[1])
        rem, steps = int(got[1][6]), int(got[1][7])
        trail.append((steps, rem))
        if rem <= 0 or steps == 0 or int(got[1][1][steps - 1]) == 0:
            if launch > 0:
                break
            rem = max(count // 2, 1)
        used, coll, freep, devs = got[0]
        args.update(used0=used, tg_coll0=coll, free_ports=freep,
                    dev_slots0=devs, k_valid=rem)
    return trail


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(CHUNKED_EDGES))
def test_chunked_edge_shapes_on_card(cuda, label, spread_alg):
    """The chunked kernel (kept list, one step warp, streams that stop at
    their first loser, step 0 across the SMs) at the edge shapes of
    CHUNKED_EDGES at their card rows, with SelectKernel's step budget and
    continuation launches from the card's own carry: every launch equal to
    chunked_plain bit for bit."""
    count = CHUNKED_EDGES[label][2]
    targs = _on(cuda, chunked_edge_args(label, seed=2, card=True))
    kw = dict(max_steps=64 if count <= 64 else 512, spread_alg=spread_alg)
    trail = _chunked_launches(targs, kw, count)
    assert len(trail) >= 2


@pytest.mark.parametrize("spread_alg", [False, True])
def test_chunked_short_budget_continues_on_card(cuda, spread_alg):
    """A budget of 8 steps a launch on the all-alike table: many launches,
    each from the card's own carry, every one bit for bit."""
    targs = _on(cuda, chunked_edge_args("all alike, count 512", seed=3,
                                        card=True))
    trail = _chunked_launches(targs, dict(max_steps=8, spread_alg=spread_alg),
                              512, launches=6)
    assert len(trail) == 6 and all(s == 8 for s, _ in trail)


@pytest.mark.parametrize("spread_alg", [False, True])
def test_chunked_batched_mixed_lanes_on_card(cuda, spread_alg):
    """Eight chunked lanes over one table at 400 rows, one that runs dry
    and one with no feasible row: the batched launch equals the batched
    plain version and each lane's solo kernel, exactly."""
    targs = _on(cuda, chunked_lanes(400, CHUNKED_LANES, seed=4))
    kw = dict(max_steps=512, spread_alg=spread_alg)
    got = kernels.select_chunked_batched(**targs, **kw)
    torch.cuda.synchronize()
    want = kernels.chunked_batched_plain(**targs, **kw)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    for i in range(len(CHUNKED_LANES)):
        s_carry, s_outs = kernels.select_chunked(
            **kernels.lane_args(targs, i), **kw)
        _assert_equal([t[i] for t in got[0]], s_carry)
        _assert_equal([t[i] for t in got[1]], s_outs)
    assert int(got[1][6][2]) > 0


def test_chunked_wrappers_make_no_synchronising_call(cuda):
    """The chunked wrappers (two launches each) never synchronise."""
    solo = _on(cuda, chunked_edge_args("runs dry", seed=5, card=True))
    lanes = _on(cuda, chunked_lanes(400, CHUNKED_LANES, seed=5))
    kw = dict(max_steps=512, spread_alg=False)
    kernels.select_chunked(**solo, **kw)
    kernels.select_chunked_batched(**lanes, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.select_chunked(**solo, **kw)
        kernels.select_chunked_batched(**lanes, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_harness_without_device_places_on_card(cuda):
    """The port's Harness() with no device names the card: a service job
    over 48 nodes goes through the chunked kernel there."""
    from nomad_tpu_torch import mock, models
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.utils.ids import generate_uuid
    h = Harness()
    for i in range(48):
        node = mock.node()
        node.name = f"node-{i}"
        h.store.upsert_node(h.next_index(), node)
    job = mock.job()
    h.store.upsert_job(h.next_index(), job)
    ev = models.Evaluation(
        id=generate_uuid(), namespace=job.namespace, priority=job.priority,
        triggered_by=models.TRIGGER_JOB_REGISTER, job_id=job.id,
        status=models.EVAL_STATUS_PENDING, type=job.type)
    before = kernels.LAUNCHES["chunked"]
    h.process("service", ev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chunked"] > before
    allocs = h.store.allocs_by_job(job.namespace, job.id)
    assert len(allocs) == job.task_groups[0].count


@pytest.mark.parametrize("kind", ["chunked", "kway", "scan"])
@pytest.mark.parametrize("seed", [0, 3])
def test_batched_kernel_matches_plain_and_solo_on_card(cuda, kind, seed):
    """Every lane of a batched launch equals the batched plain version and
    the solo kernel on that lane's request, exactly."""
    from test_torch_batched import N_PAD, _batch
    fields = _batch(seed, kind, lanes=3)
    sk = tsel.SelectKernel(cuda)
    packs, st = [], None
    s_live = p_live = 0
    for f in fields:
        args, st = tsel.pack_request(select_request_from_arrays(f), N_PAD)
        packs.append(args)
        s_live, p_live = max(s_live, st["s_live"]), max(p_live, st["p_live"])
    names = tsel._SCAN_ARGS if kind == "scan" else tsel._CHUNKED_ARGS
    targs = sk._tensors(tsel.SelectKernel._stack_lanes(packs, names), names)
    if kind == "scan":
        kw = dict(k_steps=tsel._bucket_k(max(f["count"] for f in fields)),
                  spread_alg=st["spread_alg"], s_live=s_live, p_live=p_live)
    elif kind == "kway":
        w = tsel._kway_w(N_PAD)
        kw = dict(max_steps=tsel._kway_steps(w),
                  spread_alg=st["spread_alg"], w=w)
    else:
        kw = dict(max_steps=64, spread_alg=st["spread_alg"])
    run = getattr(kernels, f"select_{kind}_batched")
    before = kernels.LAUNCHES[f"{kind}_batched"]
    got = run(**targs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"{kind}_batched"] == before + 1
    want = getattr(kernels, f"{kind}_batched_plain")(**targs, **kw)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])
    solo = getattr(kernels, f"select_{kind}")
    for i in range(len(fields)):
        s_carry, s_outs = solo(**kernels.lane_args(targs, i), **kw)
        _assert_same([t[i] for t in got[0]], s_carry)
        _assert_same([t[i] for t in got[1]], s_outs)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        assert g.shape == w.shape
        assert torch.equal(g.to(w.dtype), w)


def _launched(before):
    """The LAUNCHES keys counted since the snapshot `before`, with the
    launches each counted."""
    return {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]}


def _scan_key(solo, shards, per):
    """The LAUNCHES key of the sharded scan kernel (`solo` "scan" or
    "scan_batched") that S shards of `per` rows take, as the library routes
    them."""
    route = kernels.scan_sharded_info(shards, per)["route"]
    return f"{solo}_{'cluster' if route == 'cluster' else 'sharded'}"


def _chunked_key(shards):
    """The LAUNCHES key of the sharded chunked kernel that S shards take,
    as the library routes them."""
    route = kernels.chunked_sharded_info(shards)["route"]
    return f"chunked_batched_{'cluster' if route == 'cluster' else 'sharded'}"


@pytest.mark.parametrize("kind", ["kway", "scan"])
@pytest.mark.parametrize("n", [48, 100])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_kernel_matches_plain_and_solo_on_card(cuda, kind, n,
                                                       shards):
    """A node-sharded launch equals its plain version and the solo kernel
    on the same padded table, exactly. At these small n the exchange
    buffers, scratch and outputs share the allocator's size classes."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    req = select_request_from_arrays(_fields(n, kind, n=n))
    n_pad = pad_for_mesh(make_mesh(shards, cuda), n)
    args, st = tsel.pack_request(req, n_pad)
    sk = tsel.SelectKernel(cuda)
    if kind == "scan":
        targs = sk._tensors(args, tsel._SCAN_ARGS)
        kw = dict(k_steps=tsel._bucket_k(req.count), **st)
    else:
        targs = sk._tensors(args, tsel._CHUNKED_ARGS)
        w = tsel._kway_w(n_pad)
        kw = dict(max_steps=tsel._kway_steps(w),
                  spread_alg=st["spread_alg"], w=w)
    run = getattr(kernels, f"select_{kind}_sharded")
    name = "kway_sharded" if kind == "kway" \
        else _scan_key("scan", shards, n_pad // shards)
    before = dict(kernels.LAUNCHES)
    got = run(**targs, **kw, shards=shards)
    torch.cuda.synchronize()
    assert _launched(before) == {name: 1}
    want = getattr(kernels, f"{kind}_sharded_plain")(**targs, **kw,
                                                     shards=shards)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    solo = getattr(kernels, f"select_{kind}")(**targs, **kw)
    _assert_equal(got[0], solo[0])
    _assert_equal(got[1], solo[1])


def test_sharded_kernel_refuses_more_shards_than_the_card_holds(cuda):
    """A cooperative launch over more blocks than the card holds at once
    is refused: the wrapper raises before it launches."""
    most = kernels.max_shards("scan_sharded", cuda)
    assert most >= 8
    n = (most + 1) * 8
    req = select_request_from_arrays(_fields(0, "scan", n=n))
    args, st = tsel.pack_request(req, n)
    targs = tsel.SelectKernel(cuda)._tensors(args, tsel._SCAN_ARGS)
    before = kernels.LAUNCHES["scan_sharded"]
    with pytest.raises(ValueError):
        kernels.select_scan_sharded(**targs, k_steps=16, **st,
                                    shards=most + 1)
    assert kernels.LAUNCHES["scan_sharded"] == before


def _lanes_batch(kind, n, lanes, shards, cuda, seed):
    """`lanes` lanes of test_torch_batched's requests over one n-node
    table, packed at a mesh's padding of `shards` shards, on the card;
    with the kernels' keyword arguments."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    from test_torch_batched import _lane_fields
    rng = np.random.RandomState(4000 + seed)
    capacity = rng.uniform(500, 4000, size=(n, 4)).astype(np.float32)
    capacity[:, 2] *= 20
    capacity[:, 3] = 1000.0
    if kind == "kway":
        capacity[:, :2] *= 4
    fields = [_lane_fields(rng, n, kind, capacity, seed % 4 == 3)
              for _ in range(lanes)]
    n_pad = pad_for_mesh(make_mesh(shards, cuda), n)
    packs, s_live, p_live = [], 0, 0
    for f in fields:
        args, st = tsel.pack_request(select_request_from_arrays(f), n_pad)
        packs.append(args)
        s_live, p_live = max(s_live, st["s_live"]), max(p_live, st["p_live"])
    names = tsel._SCAN_ARGS if kind == "scan" else tsel._CHUNKED_ARGS
    targs = tsel.SelectKernel(cuda)._tensors(
        tsel.SelectKernel._stack_lanes(packs, names), names)
    count = max(f["count"] for f in fields)
    if kind == "scan":
        kw = dict(k_steps=tsel._bucket_k(count), spread_alg=st["spread_alg"],
                  s_live=s_live, p_live=p_live)
    elif kind == "kway":
        w = tsel._kway_w(n_pad)
        kw = dict(max_steps=tsel._kway_steps(w),
                  spread_alg=st["spread_alg"], w=w)
    else:
        kw = dict(max_steps=64 if count <= 64 else 512,
                  spread_alg=st["spread_alg"])
    return targs, kw


def _held_batched_sharded(kind, targs, kw, shards):
    """One batched sharded call held exactly against its plain version and
    the single-card batched kernel on the same padded lanes; returns the
    launches it made."""
    name = f"{kind}_batched_sharded"
    counted = _scan_key("scan_batched", shards,
                        targs["capacity"].shape[0] // shards) \
        if kind == "scan" else _chunked_key(shards) if kind == "chunked" \
        else name
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, f"select_{name}")(**targs, **kw, shards=shards)
    torch.cuda.synchronize()
    launched = _launched(before)
    assert set(launched) == {counted}, launched
    launches = launched[counted]
    want = getattr(kernels, f"{name}_plain")(**targs, **kw, shards=shards)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    single = getattr(kernels, f"select_{kind}_batched")(**targs, **kw)
    _assert_equal(got[0], single[0])
    _assert_equal(got[1], single[1])
    return launches


@pytest.mark.parametrize("lanes", [1, 2, 5])
@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("n", [48, 100])
@pytest.mark.parametrize("kind", ["chunked", "kway", "scan"])
def test_batched_sharded_kernel_matches_plain_and_single_card_on_card(
        cuda, kind, n, shards, lanes):
    """A batched node-sharded launch (lanes * shards blocks) equals its
    plain version and the single-card batched kernel on the same padded
    lanes, exactly. At these small n the exchange buffers, scratch and
    outputs share the allocator's size classes."""
    targs, kw = _lanes_batch(kind, n, lanes, shards, cuda,
                             seed=10 * shards + lanes)
    assert _held_batched_sharded(kind, targs, kw, shards) == 1


@pytest.mark.parametrize("kind", ["chunked", "kway", "scan"])
def test_batched_sharded_lanes_beyond_the_card_launch_in_groups(cuda, kind):
    """More lanes * shards blocks than the card holds at once: the wrapper
    launches the lanes in groups of as many as fit, each group its own
    cooperative launch, and every lane still equals the plain version and
    the single-card batched kernel."""
    shards = 32
    per = kernels.max_shards(f"{kind}_batched_sharded", cuda) // shards
    assert per >= 1
    lanes = per + 3
    targs, kw = _lanes_batch(kind, 100, lanes, shards, cuda, seed=7)
    assert _held_batched_sharded(kind, targs, kw, shards) == \
        -(-lanes // per) >= 2


def _shard_count(cuda, shards):
    return kernels.max_shards("kway_sharded", cuda) if shards == "max" \
        else shards


def _continue(targs, got, w, lanes=None):
    """The next launch's arguments from a K-way launch's carry on the card
    (a batched launch's when lanes is given); None when nothing is left
    to place or the last launch placed nothing."""
    used, coll, freep, devs = got[0]
    packed = got[1][0]
    if lanes is None:
        rem = int(packed[0, -2])
        if rem <= 0 or int(packed[:, w:2 * w].sum()) == 0:
            return None
        k_valid = rem
    else:
        k_valid = packed[:, 0, -2].clamp(min=0).to(torch.int32)
        if int(k_valid.sum()) == 0 or int(packed[:, :, w:2 * w].sum()) == 0:
            return None
    return dict(targs, used0=used, tg_coll0=coll, free_ports=freep,
                dev_slots0=devs, k_valid=k_valid)


@pytest.mark.parametrize("shards", [1, 2, 8, "max"])
@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(KWAY_EDGE_CASES))
def test_kway_sharded_edge_shapes_on_card(cuda, label, spread_alg, shards):
    """The node-sharded K-way kernel (the radix top-(W + 1) a shard and
    across shards, winner-only rescoring by the owning shard, streams that
    stop at their first loser) at the edge shapes, padded as a mesh of S
    shards pads the table (S 1, 2, 8 and the most the card holds), with
    an 8-phase budget so that launches continue from the card's own carry:
    every launch equal to kway_sharded_plain and to the single-card kernel
    on the same padded table, bit for bit."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _shard_count(cuda, shards)
    n, count, kind = KWAY_EDGE_CASES[label]
    w = tsel._kway_w(tsel._pad_n(n))
    args = pad_rows(kway_edge_args(n, count, kind, w, seed=3),
                    pad_for_mesh(make_mesh(shards, cuda), n))
    targs = _on(cuda, args)
    kw = dict(max_steps=8, spread_alg=spread_alg, w=w)
    for _launch in range(8):
        got = kernels.select_kway_sharded(**targs, **kw, shards=shards)
        torch.cuda.synchronize()
        want = kernels.kway_sharded_plain(**targs, **kw, shards=shards)
        _assert_equal(got[0], want[0])
        _assert_equal(got[1], want[1])
        single = kernels.select_kway(**targs, **kw)
        _assert_equal(got[0], single[0])
        _assert_equal(got[1], single[1])
        targs = _continue(targs, got, w)
        if targs is None:
            break


@pytest.mark.parametrize("shards", [1, 2, 8, "max"])
def test_kway_batched_sharded_mixed_lanes_on_card(cuda, shards):
    """Five K-way lanes over one capacity table (counts 10, 600 and 600 with
    few feasible rows, a lane with no feasible row, and a lane that runs
    dry), padded as a mesh of S shards pads it, launched with an 8-phase
    budget and continued from the card's carry until every lane is done:
    every launch equal to the batched plain version and to the
    single-card batched kernel on the same padded lanes, bit for bit."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _shard_count(cuda, shards)
    n, w = 200, 32
    n_pad = pad_for_mesh(make_mesh(shards, cuda), n)
    lanes = [pad_rows(kway_edge_args(n, c, kind, w, seed=4), n_pad)
             for c, kind in ((10, "random"), (600, "random"), (600, "few"),
                             (600, "none"), (4000, "dry"))]
    targs = {}
    for k in lanes[0]:
        if k == "capacity":
            targs[k] = lanes[0][k]
        elif k == "k_valid":
            targs[k] = np.array([ln[k] for ln in lanes], np.int32)
        elif isinstance(lanes[0][k], np.ndarray):
            targs[k] = np.stack([ln[k] for ln in lanes])
        else:
            targs[k] = np.array([ln[k] for ln in lanes], np.float32)
    targs = _on(cuda, targs)
    kw = dict(max_steps=8, spread_alg=False, w=w)
    launches = 0
    while targs is not None and launches < 16:
        got = kernels.select_kway_batched_sharded(**targs, **kw,
                                                  shards=shards)
        torch.cuda.synchronize()
        want = kernels.kway_batched_sharded_plain(**targs, **kw,
                                                  shards=shards)
        _assert_equal(got[0], want[0])
        _assert_equal(got[1], want[1])
        single = kernels.select_kway_batched(**targs, **kw)
        _assert_equal(got[0], single[0])
        _assert_equal(got[1], single[1])
        targs = _continue(targs, got, w, lanes=len(lanes))
        launches += 1
    assert launches > 1


def _held_scan(targs, kw, batched=False):
    """One scan launch (solo or batched) held exactly against its plain
    version and, batched, lane by lane against the solo kernel."""
    name = "scan_batched" if batched else "scan"
    before = kernels.LAUNCHES[name]
    got = getattr(kernels, f"select_{name}")(**targs, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    want = getattr(kernels, f"{name}_plain")(**targs, **kw)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    if batched:
        for i in range(targs["used0"].shape[0]):
            s_carry, s_outs = kernels.select_scan(
                **kernels.lane_args(targs, i), **kw)
            _assert_equal([t[i] for t in got[0]], s_carry)
            _assert_equal([t[i] for t in got[1]], s_outs)
    return got


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(SCAN_EDGES))
def test_scan_edge_shapes_on_card(cuda, label, spread_alg):
    """The scan kernels (cached records, per-code tables, winner-only
    rescoring, the stop at the first invalid step) at the edge shapes:
    the solo kernel equal to scan_plain, and the case as two lanes over one
    table equal to scan_batched_plain and to the solo kernel, exactly."""
    args, st = scan_edge_case(label, 31, spread_alg)
    _held_scan(_on(cuda, args), st)
    lanes = [scan_edge_case(label, 31 + i, spread_alg) for i in range(2)]
    lanes[1][0]["capacity"] = lanes[0][0]["capacity"]
    args, st = scan_lanes_batch(lanes)
    _held_scan(_on(cuda, args), dict(st, k_steps=lanes[0][1]["k_steps"]),
               batched=True)


def test_scan_records_past_shared_memory_on_card(cuda):
    """The all-live edge shape has more rows live at step 0 than the scan
    kernels keep in shared memory, so its launches (held exactly above,
    solo and as two lanes) also sweep records from device memory."""
    args, st = scan_edge_case("16,384 rows all live", 31)
    got = _held_scan(_on(cuda, args), st)
    live = int(got[1][12][0])
    assert live > kernels.scan_shared_slots()
    assert live > kernels.scan_shared_slots(batched=True)


def test_scan_mixed_lanes_on_card(cuda):
    """Ten scan lanes of counts 16-61 with their own stanzas and
    constraints, the last with no feasible row, over one table: each lane
    stops at its own first invalid step; the launch equals the batched
    plain version and each lane's solo kernel, exactly."""
    args, st = scan_mixed_lanes(200, 41)
    got = _held_scan(_on(cuda, args), st, batched=True)
    assert bool((got[1][0][-1] == -1).all())


def _scan_shards(cuda, shards):
    return kernels.max_shards("scan_sharded", cuda) if shards == "max" \
        else shards


def _held_scan_sharded(targs, kw, shards, batched=False):
    """One sharded scan launch (solo or batched) held exactly against its
    plain version and the single-card kernel on the same padded request;
    the kernel of the route the library gives for S (a cluster a lane, or
    the cooperative grid) launched, and no other."""
    solo = "scan_batched" if batched else "scan"
    name = _scan_key(solo, shards, targs["capacity"].shape[0] // shards)
    before = dict(kernels.LAUNCHES)
    got = getattr(kernels, f"select_{solo}_sharded")(**targs, **kw,
                                                     shards=shards)
    torch.cuda.synchronize()
    launched = _launched(before)
    assert set(launched) == {name}, launched
    want = getattr(kernels, f"{solo}_sharded_plain")(**targs, **kw,
                                                     shards=shards)
    _assert_equal(got[0], want[0])
    _assert_equal(got[1], want[1])
    single = getattr(kernels, f"select_{solo}")(**targs, **kw)
    _assert_equal(got[0], single[0])
    _assert_equal(got[1], single[1])
    return got


@pytest.mark.parametrize("shards", [1, 2, 8, 16, 32, "max"])
@pytest.mark.parametrize("label", sorted(SCAN_EDGES))
def test_scan_sharded_edge_shapes_on_card(cuda, label, shards):
    """The sharded scan (the scan body shard by shard: a thread-block cluster
    a lane up to 16 shards, the cooperative grid past that) at the edge
    shapes, each table padded as a mesh of S shards pads it: equal to
    scan_sharded_plain and to the single-card scan kernel, exactly."""
    from nomad_tpu_torch.mock.scan_edges import pad_rows as scan_pad_rows
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _scan_shards(cuda, shards)
    args, st = scan_edge_case(label, 31)
    n = args["capacity"].shape[0]
    targs = _on(cuda, scan_pad_rows(
        args, pad_for_mesh(make_mesh(shards, cuda), n)))
    _held_scan_sharded(targs, st, shards)


@pytest.mark.parametrize("shards", [1, 2, 8, 16, 32, "max"])
def test_scan_batched_sharded_mixed_lanes_on_card(cuda, shards):
    """Eleven scan lanes over one table (counts 16-61 with their own
    stanzas and constraints, one with no feasible row, one that runs dry),
    padded as a mesh of S shards pads it: each lane stops at its own first
    invalid step, and the launch equals the batched plain version and the
    single-card batched kernel, exactly."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _scan_shards(cuda, shards)
    args, st = scan_mixed_lanes(200, 41, dry=True, n_pad=pad_for_mesh(
        make_mesh(shards, cuda), 200))
    got = _held_scan_sharded(_on(cuda, args), st, shards, batched=True)
    assert bool((got[1][0][-2] == -1).all())


def test_scan_sharded_routes_on_card(cuda):
    """The route is fixed by S alone: clusters up to 16 shards (the card
    holds at least one cluster of each size), the grid past that; a
    shard's live slots in shared memory are its rows, as far as the
    shared memory holds them."""
    for shards in (1, 2, 8, 16, 17, 32):
        per = 10_016 // shards
        info = kernels.scan_sharded_info(shards, per)
        assert info["route"] == ("cluster" if shards <= 16 else "grid")
        assert (info["max_clusters"] >= 1) == (shards <= 16)
        if per <= 9_000:
            assert info["slots"] == per
        else:
            assert 9_000 < info["slots"] < per


def _chunked_shards(cuda, shards):
    return kernels.max_shards("chunked_batched_sharded", cuda) \
        if shards == "max" else shards


def _held_chunked_sharded(targs, kw, shards, launches=2):
    """Batched sharded chunked launches as SelectKernel continues a lane:
    each launch after the first from the carry the last one left on the
    card (the lanes' remaining counts; a first launch that drains every
    lane is followed by one from its carry all the same, at half the
    counts), every launch held exactly against its plain version and the
    single-card batched kernel, on the kernel of the route the library
    gives for S and no other. Returns each launch's (steps, remaining) a
    lane."""
    name, args, trail = _chunked_key(shards), dict(targs), []
    for launch in range(launches):
        before = dict(kernels.LAUNCHES)
        got = kernels.select_chunked_batched_sharded(**args, **kw,
                                                     shards=shards)
        torch.cuda.synchronize()
        assert set(_launched(before)) == {name}
        want = kernels.chunked_batched_sharded_plain(**args, **kw,
                                                     shards=shards)
        single = kernels.select_chunked_batched(**args, **kw)
        for other in (want, single):
            _assert_equal(got[0], other[0])
            _assert_equal(got[1], other[1])
        rem, steps = got[1][6], got[1][7]
        trail.append(list(zip(steps.tolist(), rem.tolist())))
        left = rem.clamp(min=0).to(torch.int32)
        if int(left.sum()) == 0:
            left = (args["k_valid"] // 2).clamp(min=1).to(torch.int32)
        used, coll, freep, devs = got[0]
        args.update(used0=used, tg_coll0=coll, free_ports=freep,
                    dev_slots0=devs, k_valid=left)
    return trail


@pytest.mark.parametrize("shards", [2, 8, 16, 32, "max"])
@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(CHUNKED_EDGES))
def test_chunked_sharded_edge_shapes_on_card(cuda, label, spread_alg,
                                             shards):
    """The sharded chunked kernels (a kept list a shard, the owner's steps
    on its warp, an exchange a handoff: a thread-block cluster a lane up to
    16 shards, the cooperative grid past that) at CHUNKED_EDGES' card rows,
    each table padded as a mesh of S shards pads it, one lane, with
    SelectKernel's step budget and a continuation launch from the card's
    own carry: equal to the plain version and the single-card batched
    kernel, exactly."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _chunked_shards(cuda, shards)
    count = CHUNKED_EDGES[label][2]
    n_pad = pad_for_mesh(make_mesh(shards, cuda),
                         edge_rows(label, card=True))
    targs = _on(cuda, one_lane(chunked_edge_args(label, seed=6, card=True,
                                                 n_pad=n_pad)))
    kw = dict(max_steps=64 if count <= 64 else 512, spread_alg=spread_alg)
    assert len(_held_chunked_sharded(targs, kw, shards)) == 2


@pytest.mark.parametrize("shards", [1, 2, 8, 16, 32, "max"])
def test_chunked_batched_sharded_mixed_lanes_on_card(cuda, shards):
    """CHUNKED_LANES (eight lanes of counts 1-512 over one table of 400
    rows, one that runs dry and one with no feasible row), padded as a mesh
    of S shards pads it, with an 8-step budget continued three times from
    the card's own carry: every launch equal to the plain version and the
    single-card batched kernel, exactly."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    shards = _chunked_shards(cuda, shards)
    a = pad_lanes(chunked_lanes(400, CHUNKED_LANES, seed=8),
                  pad_for_mesh(make_mesh(shards, cuda), 400))
    trail = _held_chunked_sharded(_on(cuda, a),
                                  dict(max_steps=8, spread_alg=False),
                                  shards, launches=4)
    assert any(s == 8 for s, _ in trail[0])


def test_chunked_sharded_routes_on_card(cuda):
    """The route is fixed by S alone: clusters up to 16 shards (the card
    holds at least one cluster of each size), the grid past that."""
    for shards in (1, 2, 8, 16, 17, 32):
        info = kernels.chunked_sharded_info(shards)
        assert info["route"] == ("cluster" if shards <= 16 else "grid")
        assert (info["max_clusters"] >= 1) == (shards <= 16)


def test_chunked_sharded_wrapper_makes_no_synchronising_call(cuda):
    """The batched sharded chunked wrapper, on either route, never
    synchronises."""
    from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
    calls = []
    for shards in (8, 32):
        a = pad_lanes(chunked_lanes(400, CHUNKED_LANES, seed=5),
                      pad_for_mesh(make_mesh(shards, cuda), 400))
        calls.append((_on(cuda, a), shards))
    kw = dict(max_steps=512, spread_alg=False)
    for args, shards in calls:
        kernels.select_chunked_batched_sharded(**args, **kw, shards=shards)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args, shards in calls:
            kernels.select_chunked_batched_sharded(**args, **kw,
                                                   shards=shards)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# -- the golden scheduler scenarios and the cold start on the card ------

GOLDEN_ON_CARD = [
    ("test_torch_generic_golden", "test_job_register"),
    ("test_torch_generic_golden", "test_job_register_distinct_hosts"),
    ("test_torch_generic_golden", "test_job_modify_destructive"),
    ("test_torch_generic_golden",
     "test_job_register_feasible_and_infeasible_tg"),
    ("test_torch_generic_golden", "test_node_drain"),
    ("test_torch_system_golden", "test_SystemSched_ExhaustResources"),
]


def _golden_run(monkeypatch, module_name, test_name, on_card):
    """One port golden test with every id drawn from one seeded stream;
    its harnesses on the card (Harness() with no device) or, as the test
    is written, on the CPU. Returns the harnesses it made."""
    import importlib
    import os
    import random
    mod = importlib.import_module(module_name)
    made = []
    base = mod.Harness

    class Recording(base):
        def __init__(self, store=None, device=None):
            super().__init__(store, device=None if on_card else device)
            made.append(self)

    with monkeypatch.context() as m:
        m.setattr(mod, "Harness", Recording)
        m.setattr(os, "urandom", random.Random(20260417).randbytes)
        getattr(mod, test_name)()
    return made


@pytest.mark.parametrize("module_name,test_name", GOLDEN_ON_CARD,
                         ids=[t for _m, t in GOLDEN_ON_CARD])
def test_golden_scenario_places_on_card_as_on_cpu(cuda, monkeypatch,
                                                  module_name, test_name):
    """A golden scheduler scenario through Harness() on the card, its
    assertions included, places as the same scenario on the CPU: per
    alloc name the same node and statuses, the scores within 1e-6, the
    same evals and plans; and the card's kernels ran (each of these
    scenarios dispatches at least one placement; the system scheduler's
    other golden scenarios place none)."""
    from nomad_tpu_torch.utils.codec import to_wire
    from test_torch_golden_parity import _placements
    arms = ("chunked", "kway", "scan")
    before = sum(kernels.LAUNCHES[k] for k in arms)
    card = _golden_run(monkeypatch, module_name, test_name, True)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES[k] for k in arms) > before
    cpu = _golden_run(monkeypatch, module_name, test_name, False)
    assert len(card) == len(cpu) >= 1
    for ch, hh in zip(card, cpu):
        assert ch.device is None and hh.device == "cpu"
        got, want = _placements(ch, to_wire), _placements(hh, to_wire)
        for key in ("nodes", "jobs", "evals", "created", "plans"):
            assert got[key] == want[key], key
        assert got["allocs"].keys() == want["allocs"].keys()
        for key, rows in want["allocs"].items():
            mine = got["allocs"][key]
            assert [r[:4] for r in mine] == [r[:4] for r in rows], key
            for (*_t, ts), (*_w, ws) in zip(mine, rows):
                assert [(n, k) for n, k, _v in ts] == \
                    [(n, k) for n, k, _v in ws], key
                for (_n, _k, tv), (_n2, _k2, wv) in zip(ts, ws):
                    np.testing.assert_allclose(tv, wv, rtol=1e-6, atol=1e-6)


def test_cold_start_eval_is_resident_on_card(cuda):
    """restore -> prime -> prefetch_device(cuda) on a thread -> one eval:
    the mirror's one upload is the prefetch's, the table is the prime's,
    the eval's dispatch is served by the mirror and places as the same
    pipeline on the CPU."""
    import copy
    import msgpack
    from nomad_tpu_torch import mock, models
    from nomad_tpu_torch.ops.tables import PrefetchThread
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.utils import metrics
    with mock.seeded_mock_ids(7):
        nodes = []
        for i in range(200):
            node = mock.node()
            node.name = f"node-{i}"
            nodes.append(node)
        first, job = mock.job(), mock.job()
    src = Harness(device="cpu")
    for node in nodes:
        src.store.upsert_node(src.next_index(), node)
    src.store.upsert_job(src.next_index(), first)
    src.process("service", models.Evaluation(
        job_id=first.id, namespace=first.namespace, type=first.type,
        priority=first.priority, triggered_by=models.TRIGGER_JOB_REGISTER))
    blob = msgpack.packb(src.store.dump_columnar(), use_bin_type=True)
    placed = {}
    for device in ("cuda", "cpu"):
        store = StateStore()
        store.restore(msgpack.unpackb(blob, raw=False,
                                      strict_map_key=False))
        cache = store.table_cache
        cache.prime(store.snapshot(), store.pop_cold_columns())
        thread = PrefetchThread(cache, device)
        thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive()
        assert cache.device.stats["uploads"] == 1
        h = Harness(store, device=device)
        h.store.upsert_job(h.next_index(), copy.deepcopy(job))
        c0 = metrics.counter_totals()
        l0 = kernels.LAUNCHES["chunked"]
        h.process("service", models.Evaluation(
            job_id=job.id, namespace=job.namespace, type=job.type,
            priority=job.priority,
            triggered_by=models.TRIGGER_JOB_REGISTER))
        if device == "cuda":
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["chunked"] > l0
            assert cache.device.device == torch.device("cuda")
        c1 = metrics.counter_totals()
        delta = {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in (
            "nomad.select.dispatches", "nomad.select.resident_dispatch",
            "nomad.select.resident_fallback")}
        assert delta["nomad.select.resident_fallback"] == 0
        assert delta["nomad.select.resident_dispatch"] == \
            delta["nomad.select.dispatches"] > 0
        assert cache.stats["full_builds"] == 0
        assert cache.device.stats["uploads"] == 1
        assert h.evals[-1].status == "complete"
        placed[device] = sorted((a.name, a.node_id) for a in
                                store.allocs_by_job(job.namespace, job.id))
    assert len(placed["cuda"]) == job.task_groups[0].count
    assert placed["cuda"] == placed["cpu"]


# -- the dev-mode server on the card ------------------------------------

SERVER_CONFIGS = {
    "A": dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0),
    "B": dict(num_schedulers=2, eval_batch_size=8, gateway_window_us=0),
    "C": dict(num_schedulers=2, eval_batch_size=8),
}


def _server_run(device, cfg, n_nodes=200):
    """A fresh Server over 200 seeded nodes: 8 service jobs (count 10,
    chunked), 2 spread jobs (count 20, scan) and 2 batch jobs (count 600,
    K-way), registered while the workers are paused. Returns the
    placements by (job, alloc name, node name) and the launches from the
    workers' resume until every job is placed."""
    import time
    from nomad_tpu_torch import mock, models
    from nomad_tpu_torch.server import Server, ServerConfig
    with mock.seeded_mock_ids(7):
        nodes = [mock.node() for _ in range(n_nodes)]
        service = [mock.job() for _ in range(8)]
        spread = [mock.job() for _ in range(2)]
        batch = [mock.batch_job() for _ in range(2)]
    for i, node in enumerate(nodes):
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % 4}"
        node.compute_class()
    for tag, jobs in (("svc", service), ("spread", spread),
                      ("batch", batch)):
        for i, job in enumerate(jobs):
            job.id = job.name = f"{tag}-{i}"
    for job in spread:
        job.spreads = [models.Spread(
            attribute="${meta.rack}", weight=60,
            spread_target=[models.SpreadTarget(value="r1", percent=40)])]
        job.task_groups[0].count = 20
    for job in batch:
        job.task_groups[0].count = 600
    jobs = service[:3] + spread + service[3:6] + batch + service[6:]
    s = Server(ServerConfig(heartbeat_ttl_s=3600.0, **cfg), device=device)
    s.start()
    try:
        for w in s.workers:
            w.set_pause(True)
        time.sleep(0.6)
        idx = s._raft_index
        for node in nodes:
            idx += 1
            s.store.upsert_node(idx, node)
        s._raft_index = idx
        for job in jobs:
            s.register_job(job)
        kernels.reset_launches()
        for w in s.workers:
            w.set_pause(False)
        want = {j.id: j.task_groups[0].count for j in jobs}
        deadline = time.time() + 120
        while time.time() < deadline and not all(
                len(s.store.allocs_by_job("default", j)) == n
                for j, n in want.items()):
            time.sleep(0.01)
        launches = dict(kernels.LAUNCHES)
        names = {n.id: n.name for n in nodes}
        placed = {j: sorted((a.name, names[a.node_id]) for a in
                            s.store.allocs_by_job("default", j))
                  for j in want}
        for j, n in want.items():
            assert len(placed[j]) == n, (j, len(placed[j]), n)
        for node in s.store.nodes():
            total = node.comparable_resources()
            cpu = sum(a.allocated_resources.comparable().cpu_shares
                      for a in s.store.allocs_by_node(node.id)
                      if not a.terminal_status())
            assert cpu <= total.cpu_shares, node.name
        return placed, launches
    finally:
        s.shutdown()


@pytest.mark.parametrize("label", sorted(SERVER_CONFIGS))
def test_server_places_every_job_on_card(cuda, monkeypatch, label):
    """Configs (A) sequential, (B) drained batches through BatchGateways,
    (C) the micro-batch gateway: every job placed on the card, no node
    over its CPU; in (B), with lanes forced on as the CPU tests force
    them, the batched arms launched."""
    from nomad_tpu_torch.ops.select import SelectKernel
    if label == "B":
        monkeypatch.setattr(SelectKernel, "batch_dispatch_profitable",
                            lambda self, n, tolerance=1.0: True)
    _placed, launches = _server_run(None, SERVER_CONFIGS[label])
    assert launches["chunked"] + launches["chunked_batched"] > 0
    if label == "B":
        assert launches["chunked_batched"] + launches["kway_batched"] \
            + launches["scan_batched"] > 0, launches


def test_server_sequential_places_on_card_as_on_cpu(cuda):
    """Config (A) on the card places every alloc on the node the plain
    versions on the CPU choose."""
    card, launches = _server_run(None, SERVER_CONFIGS["A"])
    for arm in ("chunked", "kway", "scan"):
        assert launches[arm] > 0, launches
    cpu, _ = _server_run("cpu", SERVER_CONFIGS["A"])
    assert card == cpu


def test_server_calibrates_on_card(cuda):
    """dispatch_calibration: start() measures the solo and batched arms on
    the card at the store's table shape."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops.select import _pad_n, cost_model
    from nomad_tpu_torch.server import Server, ServerConfig
    s = Server(ServerConfig(num_schedulers=0, dispatch_calibration=True))
    try:
        for i in range(24):
            s.store.upsert_node(100 + i, mock.node())
        s.start()
        n_pad = _pad_n(24)
        snap = cost_model.snapshot()
        assert f"chunked@{n_pad}" in snap
        assert f"chunked_batched@{n_pad}" in snap
    finally:
        s.shutdown()


def _restart_jobs(tag, seed):
    """A service job (count 10, chunked), a spread job (count 20, scan)
    and a batch job (count 600, K-way)."""
    from nomad_tpu_torch import mock, models
    with mock.seeded_mock_ids(seed):
        service, spread, batch = mock.job(), mock.job(), mock.batch_job()
    for kind, job in (("svc", service), ("spread", spread),
                      ("batch", batch)):
        job.id = job.name = f"{tag}-{kind}"
    spread.spreads = [models.Spread(
        attribute="${meta.rack}", weight=60,
        spread_target=[models.SpreadTarget(value="r1", percent=40)])]
    spread.task_groups[0].count = 20
    batch.task_groups[0].count = 600
    return [service, spread, batch]


def _restart_place(s, jobs, names):
    import time
    placed = {}
    for job in jobs:
        s.register_job(job)
        deadline = time.time() + 120
        want = job.task_groups[0].count
        while time.time() < deadline and len(
                s.store.allocs_by_job("default", job.id)) < want:
            time.sleep(0.01)
        placed[job.id] = sorted(
            (a.name, names[a.node_id])
            for a in s.store.allocs_by_job("default", job.id))
        assert len(placed[job.id]) == want, job.id
    return placed


def test_server_restart_restores_onto_card(cuda, tmp_path):
    """A 200-node Server with a data directory on the card places a
    spread and a batch job, snapshots, places a service job, shuts down
    and restarts on the card: the prefetch has joined at construction
    (the mirror uploaded on the card, no prefetch thread left), the first
    eval builds no full table and launches scatter_set for the replayed
    rows, and the next jobs place as on a CPU restart of a copy of the
    same directory."""
    import shutil
    import threading
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig
    cfg = dict(num_schedulers=1, eval_batch_size=1, gateway_window_us=0,
               heartbeat_ttl_s=3600.0, snapshot_background=False)
    with mock.seeded_mock_ids(11):
        nodes = [mock.node() for _ in range(200)]
    for i, node in enumerate(nodes):
        node.name = f"node-{i}"
        node.meta["rack"] = f"r{i % 4}"
        node.compute_class()
    names = {n.id: n.name for n in nodes}
    life = str(tmp_path / "life")
    s = Server(ServerConfig(data_dir=life, **cfg))
    s.start()
    try:
        idx = s._raft_index
        for node in nodes:
            idx += 1
            s.store.upsert_node(idx, node)
        s._raft_index = idx
        first = _restart_jobs("first", 12)
        _restart_place(s, first[1:], names)
        # the WAL tail past this snapshot is the service job's plan: the
        # first eval after the restart scatters its few rows (a delta of
        # more than half the table would re-upload the mirror instead)
        with s._raft_l:
            s.persistence.snapshot(s.store)
        _restart_place(s, first[:1], names)
    finally:
        s.shutdown()
    cpu_dir = shutil.copytree(life, str(tmp_path / "cpu"))
    after = {}
    for device, data_dir in ((None, life), ("cpu", cpu_dir)):
        s = Server(ServerConfig(data_dir=data_dir, **cfg), device=device)
        try:
            cache = s.store.table_cache
            assert not any(t.name == "node-table-prefetch" and t.is_alive()
                           for t in threading.enumerate())
            assert cache.stats["primes"] == 1
            assert cache.device.stats["uploads"] == 1
            assert cache.device.device.type == ("cuda" if device is None
                                                else "cpu")
            s.start()
            jobs = _restart_jobs("next", 13)
            kernels.reset_launches()
            first = _restart_place(s, jobs[:1], names)
            if device is None:
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["scatter_set"] > 0, \
                    dict(kernels.LAUNCHES)
                assert kernels.LAUNCHES["chunked"] > 0
            assert cache.stats["full_builds"] == 0
            first.update(_restart_place(s, jobs[1:], names))
            assert cache.stats["full_builds"] == 0
            after[device] = first
        finally:
            s.shutdown()
    assert after[None] == after["cpu"]


def test_ring_places_a_job_through_a_follower_on_card(cuda):
    """Three Servers with device=None (the card) joined by raft over
    loopback RPC: with the leader's own worker paused, a follower
    dequeues the eval over RPC, selects on the card against its own
    replicated store and resident table (its mirror on the card) and
    submits the plan to the leader's applier; every replica then holds
    the placements, and no node is over its CPU."""
    import time
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.rpc import RpcServer
    from nomad_tpu_torch.server import Server, ServerConfig

    def wait(pred, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.02)
        return False

    servers, rpcs = [], []
    for _ in range(3):
        s = Server(ServerConfig(num_schedulers=1, heartbeat_ttl_s=3600.0,
                                dead_server_cleanup_s=0.0,
                                follower_max_remote=1))
        assert s.device.type == "cuda"
        servers.append(s)
        rpcs.append(RpcServer(s, port=0))
    addrs = [r.addr for r in rpcs]
    try:
        for s, r in zip(servers, rpcs):
            s.attach_raft(r, addrs)
            r.start()
            s.start()
        assert wait(lambda: sum(s.raft.is_leader() for s in servers) == 1)
        lead = next(s for s in servers if s.raft.is_leader())
        for w in lead.workers:
            w.set_pause(True)
        time.sleep(0.6)
        with mock.seeded_mock_ids(21):
            nodes = [mock.node() for _ in range(64)]
            job = mock.job()
        for i, node in enumerate(nodes):
            node.name = f"node-{i}"
            lead.register_node(node)
        job.task_groups[0].count = 10
        kernels.reset_launches()
        lead.register_job(job)
        assert wait(lambda: all(
            len(s.store.allocs_by_job("default", job.id)) == 10
            for s in servers))
        plans = {s.raft.self_addr: s.follower_sched.snapshot_stats()[
            "remote_plans"] for s in servers if s is not lead}
        assert sum(plans.values()) >= 1, plans
        assert kernels.LAUNCHES["chunked"] >= 1
        for s in servers:
            if s is lead:
                continue
            for w in s.follower_sched.workers:
                assert w._kernel.device.type == "cuda"
        for node in lead.store.nodes():
            total = node.comparable_resources()
            cpu = sum(a.allocated_resources.comparable().cpu_shares
                      for a in lead.store.allocs_by_node(node.id)
                      if not a.terminal_status())
            assert cpu <= total.cpu_shares, node.name
    finally:
        for s, r in zip(servers, rpcs):
            r.shutdown()
            s.shutdown()
