"""The port's placement kernels against the JAX package's, seed by seed.

For each of the three kernels (chunked, K-way, scan) the same seeded numpy
request goes through the JAX jitted program (on the CPU backend, as the
JAX package's own tests run it) and through the port's wrapper on CPU
tensors, which runs the kernel's plain PyTorch version. Choices, chunks,
top-k indices and carries must be identical; scores agree within
rtol=1e-6, atol=1e-6 (10**x is computed in float64 and rounded in the
port, while XLA's float32 pow differs from that by 1 ulp on some inputs).
A SelectKernel.select round trip on both sides must give the same
SelectResult, and tests/scalar_reference.py's scalar_select is a third
witness, held to the tolerance the JAX package's parity suite uses for it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
from nomad_tpu_torch.state.carry import select_request_from_arrays
from scalar_reference import scalar_select

# one intra-op thread: the port's small tensors gain nothing from more,
# and the reference's timing tests run beside these under xdist; the
# port's other test modules that run torch in-process import this one
torch.set_num_threads(1)

SEEDS = list(range(20))
N_NODES = 48           # one node-axis bucket (64) for every seed
RTOL = ATOL = 1e-6
CODES = 6


def _spread(rng, n, count, targeted):
    codes = rng.randint(0, CODES, n).astype(np.int32)
    codes[rng.rand(n) < 0.05] = jsel.C_MAX       # nodes missing the attr
    counts = np.zeros(jsel.C_MAX + 1, np.float32)
    for c in rng.randint(0, CODES, rng.randint(0, 4)):
        counts[c] += rng.randint(1, 4)
    desired = np.full(jsel.C_MAX + 1, -1.0, np.float32)
    if targeted:
        for c in range(CODES):
            if rng.rand() < 0.6:
                desired[c] = float(rng.randint(1, count + 2))
    return dict(codes=codes, counts=counts, present=counts > 0,
                desired=desired, weight=float(rng.randint(10, 100)),
                has_targets=targeted)


def _fields(seed, kind, n=N_NODES):
    """SelectRequest fields over n nodes: heterogeneous capacities and
    usage, ports, penalties, affinities, device slots and preemption
    scores; for the scan also spreads, a distinct property,
    distinct_hosts and reserved ports."""
    rng = np.random.RandomState(1000 + seed)
    count = {"chunked": rng.randint(1, 60), "kway": rng.randint(513, 700),
             "scan": rng.randint(9, 17)}[kind]
    capacity = rng.uniform(500, 4000, size=(n, 4)).astype(np.float32)
    capacity[:, 2] *= 20
    capacity[:, 3] = 1000.0
    if kind == "kway":
        capacity[:, :2] *= 4            # room for ~10-30 instances a node
    used = (capacity * rng.uniform(0, 0.6, size=(n, 4))).astype(np.float32)
    ask = np.array([rng.uniform(50, 600), rng.uniform(50, 600),
                    rng.uniform(1, 50), 0], np.float32)
    f = dict(
        ask=ask, count=count, feasible=rng.rand(n) > 0.15,
        capacity=capacity, used=used, desired_count=float(count),
        tg_collisions=rng.randint(0, 3, n).astype(np.int32),
        job_count=rng.randint(0, 2, n).astype(np.int32),
        penalty=rng.rand(n) > 0.85,
        affinity=(rng.uniform(-1, 1, n) * (rng.rand(n) > 0.5)
                  ).astype(np.float32),
        affinity_sum_weights=1.0,
        algorithm="spread" if seed % 4 == 3 else "binpack",
        port_need=float(rng.randint(0, 3)),
        free_ports=rng.uniform(0, 400 if kind == "kway" else 15,
                               n).astype(np.float32),
        port_ok=rng.rand(n) > 0.1,
        dev_slots=rng.randint(0, 400 if kind == "kway" else 5,
                              n).astype(np.float32),
        dev_score=(rng.uniform(0, 1, n) * (rng.rand(n) > 0.5)
                   ).astype(np.float32),
        dev_fires=bool(rng.rand() < 0.7),
        pre_score=(rng.uniform(0.1, 1, n) * (rng.rand(n) > 0.6)
                   ).astype(np.float32),
    )
    if kind == "scan":
        sp = [_spread(rng, n, count, True), _spread(rng, n, count, False)]
        f.update(
            spreads=sp, sum_spread_weights=sum(s["weight"] for s in sp),
            distinct_props=[dict(
                codes=rng.randint(0, CODES, n).astype(np.int32),
                counts=np.zeros(jsel.C_MAX + 1, np.float32),
                limit=float(rng.randint(2, 5)))],
            distinct_hosts=bool(rng.rand() < 0.3),
            scan_exclusive=bool(rng.rand() < 0.3))
    return f


def _jax_request(fields):
    kw = {}
    for k, v in fields.items():
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif k in ("spreads", "distinct_props"):
            v = [{kk: (vv.copy() if isinstance(vv, np.ndarray) else vv)
                  for kk, vv in e.items()} for e in v]
        kw[k] = v
    return jsel.SelectRequest(**kw)


def _torch_args(args, names):
    out = {}
    for k in names:
        v = args[k]
        if isinstance(v, np.ndarray) and v.ndim > 0:
            out[k] = torch.from_numpy(v.copy())
        else:
            out[k] = v.item() if isinstance(v, np.generic) else v
    return out


def _same(name, jax_out, port_out):
    a = np.asarray(jax_out)
    b = port_out.numpy() if isinstance(port_out, torch.Tensor) \
        else np.asarray(port_out)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        assert np.array_equal(a, b.astype(a.dtype)), (name, a, b)


def _packed(seed, kind):
    fields = _fields(seed, kind)
    n_pad = jsel._pad_n(N_NODES)
    jargs, statics = jsel.pack_request(_jax_request(fields), n_pad)
    targs, tstatics = tsel.pack_request(
        select_request_from_arrays(fields), n_pad)
    assert statics == tstatics
    assert jargs.keys() == targs.keys()
    for k in jargs:
        _same(f"pack {k}", jargs[k], targs[k])
    return fields, jargs, statics


@pytest.mark.parametrize("seed", SEEDS)
def test_chunked_matches_jax(seed):
    _fields_, args, st = _packed(seed, "chunked")
    cargs = {k: args[k] for k in jsel._CHUNKED_ARGS}
    jc, jo = jsel._select_chunked(**cargs, max_steps=64,
                                  spread_alg=st["spread_alg"])
    tc, to = kernels.select_chunked(**_torch_args(args, jsel._CHUNKED_ARGS),
                                    max_steps=64,
                                    spread_alg=st["spread_alg"])
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    for i, (a, b) in enumerate(zip(jo, to)):
        _same(f"out {i}", a, b)
    assert int(jo[7]) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_kway_matches_jax(seed):
    _fields_, args, st = _packed(seed, "kway")
    cargs = {k: args[k] for k in jsel._CHUNKED_ARGS}
    w = jsel._kway_w(jsel._pad_n(N_NODES))
    steps = jsel._kway_steps(w)
    jc, (jp, jts) = jsel._select_kway(**cargs, max_steps=steps,
                                      spread_alg=st["spread_alg"], w=w)
    tc, (tp, tts) = kernels.select_kway(
        **_torch_args(args, jsel._CHUNKED_ARGS), max_steps=steps,
        spread_alg=st["spread_alg"], w=w)
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    _same("packed", jp, tp)
    _same("top scores", jts, tts)


def test_kway_seeds_exercise_multi_winner_phases():
    """The K-way seeds reach phases that place on several winners (the
    waterline rule), not only the 2-way overshoot tail."""
    w = jsel._kway_w(jsel._pad_n(N_NODES))
    multi = 0
    for seed in SEEDS:
        _fields_, args, st = _packed(seed, "kway")
        _carry, (packed, _ts) = kernels.select_kway(
            **_torch_args(args, jsel._CHUNKED_ARGS),
            max_steps=jsel._kway_steps(w), spread_alg=st["spread_alg"], w=w)
        winners = (packed[:, w:2 * w] > 0).sum(dim=1)
        multi += int(winners.max()) > 1
    assert multi >= len(SEEDS) // 2


@pytest.mark.parametrize("seed", SEEDS)
def test_scan_matches_jax(seed):
    _fields_, args, st = _packed(seed, "scan")
    k = jsel._bucket_k(int(args["k_valid"]))
    jc, jo = jsel._select_scan(**args, k_steps=k, **st)
    tc, to = kernels.select_scan(**_torch_args(args, jsel._SCAN_ARGS),
                                 k_steps=k, **st)
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    for i, (a, b) in enumerate(zip(jo, to)):
        _same(f"out {i}", a, b)


def _same_result(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "scores":
            assert x.keys() == y.keys()
            for k in x:
                _same(f"scores[{k}]", x[k], y[k])
        else:
            _same(f.name, x, y)


@pytest.mark.parametrize("kind", ["chunked", "kway", "scan"])
@pytest.mark.parametrize("seed", SEEDS[:8])
def test_select_round_trip_and_scalar_witness(kind, seed):
    fields = _fields(seed, kind)
    ref = _jax_request(fields)
    want = jsel.SelectKernel().select(_jax_request(fields))
    got = tsel.SelectKernel("cpu").select(
        select_request_from_arrays(fields))
    _same_result(want, got)
    assert got.placed > 0
    nodes, final, comps = scalar_select(ref)
    assert got.node_idx.tolist() == nodes
    # the JAX package's tolerance for its scalar witness
    # (tests/test_kernel_parity.py)
    np.testing.assert_allclose(got.final_score, final, rtol=2e-4, atol=2e-5)
    for name, exp in comps.items():
        np.testing.assert_allclose(got.scores[name], exp, rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_kernel_wrappers_count_no_cpu_launches():
    from nomad_tpu_torch.parallel import make_mesh
    kernels.reset_launches()
    fields = _fields(0, "chunked")
    tsel.SelectKernel("cpu").select(select_request_from_arrays(fields))
    tsel.set_mesh(make_mesh(4, "cpu"))
    try:
        tsel.SelectKernel("cpu").select(select_request_from_arrays(fields))
        reqs = [select_request_from_arrays(fields) for _ in range(2)]
        reqs[1].capacity = reqs[0].capacity
        tsel.SelectKernel("cpu").select_many(reqs)
    finally:
        tsel.set_mesh(None)
    assert kernels.LAUNCHES == {"chunked": 0, "kway": 0, "scan": 0,
                                "chunked_batched": 0, "kway_batched": 0,
                                "scan_batched": 0, "scatter_set": 0,
                                "overlay_add": 0, "feas_scatter": 0,
                                "scan_sharded": 0, "kway_sharded": 0,
                                "chunked_batched_sharded": 0,
                                "kway_batched_sharded": 0,
                                "scan_batched_sharded": 0, "scan_cluster": 0,
                                "scan_batched_cluster": 0,
                                "chunked_batched_cluster": 0}


def test_wrapper_rejects_unsupported_device():
    fields = _fields(1, "scan")
    args, st = tsel.pack_request(select_request_from_arrays(fields),
                                 jsel._pad_n(N_NODES))
    targs = _torch_args(args, jsel._SCAN_ARGS)
    with pytest.raises(ValueError):
        kernels.select_scan(**dict(targs, capacity=targs["capacity"].to(
            "meta")), k_steps=16, **st)
