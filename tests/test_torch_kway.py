"""The K-way placement phase by phase: the premise of the card kernel's
winner-only rescoring, and the K-way edge shapes, against the JAX package.

- The rescoring premise (20 seeds, n = 200, W = 32, binpack and spread,
  with ports, device slots, penalties, affinities and preemption scores):
  kway_plain chained one phase a launch (max_steps=1, each launch fed the
  previous carry). After each phase `masked`, recomputed from the carry by
  the plain sweep (`kernels._local_sweep`, the helper kway_plain itself
  runs), differs from the previous phase's only at the rows the phase
  placed on with chunk > 0; the chained phases' winners, chunks and carries
  equal one max_steps-long run's (the step-0 diagnostics differ by design:
  every launch reports its first phase's); and both equal the JAX
  package's `_select_kway` on the same seeded numpy inputs (ints exactly,
  scores within 1e-6).
- The edge shapes of the card kernel's radix top-(W + 1) (EDGE_CASES):
  n = W + 1, fewer than W + 1 feasible rows, exactly W + 1, all-alike
  nodes (one tie storm), a first phase with no feasible row, and a lane
  that runs out of room after placing (an invalid later phase): kway_plain
  against `_select_kway`. tests/test_torch_cuda.py holds the kernel
  against kway_plain at the same shapes on the card.
- The node-sharded K-way (rows 10b and 10c): the same edge shapes through
  kway_plain(..., shards=S), S 2 and 8, on the table padded as a mesh of
  S shards pads it, against `_select_kway` on that padded table, bit for
  bit (scores at tolerance 0); shards that hold fewer rows than W + 1,
  with all-alike rows and with no feasible row, so that the tie order at
  one score (NEG_INF included) crosses shards; and the premise of the
  sharded kernel's cross-shard merge: `_topk_shards(v, k, S)`, each
  shard's own top-k laid end to end in shard order and taken again,
  equals `_topk_stable(v, k)` (and `lax.top_k` where no signed zeros
  appear) for S 1, 2, 8 and 33 on tie storms, NEG_INF rows and mixes of
  -0.0 and +0.0.
"""

import jax
import numpy as np
import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.mock import kway_edges as edges
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
from nomad_tpu_torch.state.carry import select_request_from_arrays
from test_torch_select import _fields, _same, _torch_args

SEEDS = list(range(20))
N = 200


def _carry_args(args, carry, remaining):
    """The next launch's arguments: args continued from `carry`."""
    used, coll, free_p, dev_slots = carry
    return dict(args, used0=used, tg_coll0=coll, free_ports=free_p,
                dev_slots0=dev_slots, k_valid=remaining)


def _masked(a, spread_alg):
    """masked of one full sweep from the arguments' carries."""
    return kernels._local_sweep(
        a["capacity"], a["used0"], a["feasible"], a["ask"], a["tg_coll0"],
        a["penalty"], a["affinity_norm"], a["desired_count"],
        a["port_need"], a["free_ports"], a["port_ok"], a["dev_slots0"],
        a["dev_score"], a["dev_fires"], a["pre_score"], spread_alg)[0]


def _jax_kway(args, **statics):
    cargs = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in args.items()}
    return jsel._select_kway(**cargs, **statics)


def _same_run(jax_out, port_out):
    (jc, (jp, jts)), (tc, (tp, tts)) = jax_out, port_out
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    _same("packed", jp, tp)
    _same("top scores", jts, tts)


@pytest.mark.parametrize("seed", SEEDS)
def test_rescoring_premise_and_chained_phases(seed):
    fields = _fields(seed, "kway", n=N)
    n_pad = tsel._pad_n(N)
    args, st = tsel.pack_request(select_request_from_arrays(fields), n_pad)
    targs = _torch_args(args, jsel._CHUNKED_ARGS)
    w = tsel._kway_w(n_pad)
    statics = dict(spread_alg=st["spread_alg"], w=w)
    whole = kernels.kway_plain(**targs, max_steps=tsel._kway_steps(w),
                               **statics)
    _same_run(_jax_kway(targs, max_steps=tsel._kway_steps(w), **statics),
              whole)
    packed = whole[1][0]
    phases = int(packed[0, -1])
    assert phases > 1

    a, prev, rescored = dict(targs), _masked(targs, st["spread_alg"]), 0
    for phase in range(phases):
        carry, (p, _ts) = kernels.kway_plain(**a, max_steps=1, **statics)
        assert torch.equal(p[0, :2 * w], packed[phase, :2 * w]), phase
        a = _carry_args(a, carry, int(p[0, -2]))
        now = _masked(a, st["spread_alg"])
        changed = set(torch.nonzero(
            now.view(torch.int32) != prev.view(torch.int32))[:, 0].tolist())
        placed = set(p[0, :w][p[0, w:2 * w] > 0].tolist())
        assert changed <= placed, (phase, changed - placed)
        rescored += len(changed)
        prev = now
    assert int(a["k_valid"]) == int(packed[0, -2])
    for i, (got, want) in enumerate(zip(carry, whole[0])):
        assert torch.equal(got, want), i
    assert rescored > 0


# The card kernel's radix top-(W + 1) at its edges, as (n, count, kind):
# kind "few" keeps 2 (W + 1) // 5 rows feasible, "w_plus_1" exactly W + 1,
# "alike" makes every node the same, "none" makes no row feasible, "dry"
# leaves room for fewer instances than the count.
EDGE_CASES = {
    "n_is_w_plus_1": (33, 600, "random"),
    "few_feasible": (200, 600, "few"),
    "w_plus_1_feasible": (200, 600, "w_plus_1"),
    "all_alike": (200, 600, "alike"),
    "first_phase_invalid": (200, 600, "none"),
    "runs_dry": (200, 4000, "dry"),
}


# the feasible rows the "few", "w_plus_1" and "none" kinds keep, at width w
EDGE_FEASIBLE = {"few": lambda w: 2 * (w + 1) // 5,
                 "w_plus_1": lambda w: w + 1, "none": lambda w: 0}


def kway_edge_args(n, count, kind, w, seed):
    """The kernel arguments (numpy, by _CHUNKED_ARGS name) of one K-way
    request over n rows at width w, seeded; kind as in EDGE_CASES, made by
    the port's one edge-input generator."""
    base = kind if kind in ("alike", "dry") else "random"
    keep = EDGE_FEASIBLE[kind](w) if kind in EDGE_FEASIBLE else None
    a = edges.kway_edge_args(n, count, base, seed, feasible_rows=keep)
    assert sorted(a) == sorted(jsel._CHUNKED_ARGS)
    return a


def _edge(label, seed=0):
    n, count, kind = EDGE_CASES[label]
    w = tsel._kway_w(tsel._pad_n(n))
    return kway_edge_args(n, count, kind, w, seed), w


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(EDGE_CASES))
def test_kway_edge_shapes_match_jax(label, spread_alg):
    args, w = _edge(label)
    statics = dict(max_steps=tsel._kway_steps(w), spread_alg=spread_alg,
                   w=w)
    targs = _torch_args(args, jsel._CHUNKED_ARGS)
    got = kernels.kway_plain(**targs, **statics)
    _same_run(_jax_kway(targs, **statics), got)
    packed = got[1][0]
    steps, remaining = int(packed[0, -1]), int(packed[0, -2])
    feasible_count = int(packed[0, -3])
    n, count, kind = EDGE_CASES[label]
    if kind == "none":
        assert steps == 1 and remaining == count and feasible_count == 0
        # the top-k of an all-NEG_INF table: its first rows, in order
        assert packed[0, 2 * w:2 * w + 5].tolist() == [0, 1, 2, 3, 4]
    if kind == "dry":
        # a later phase found no feasible row and reported its counts
        assert steps > 1 and remaining > 0
        assert int(packed[steps - 1, -3]) == 0
    if kind in ("few", "w_plus_1"):
        assert feasible_count == EDGE_FEASIBLE[kind](w)


def _exact_run(jax_out, port_out):
    """_same_run at tolerance 0: every integer and every float bit equal
    (the seeded random requests above differ from the JAX programs' scores
    by up to 1e-6 on some seeds; the edge inputs do not)."""
    (jc, (jp, jts)), (tc, (tp, tts)) = jax_out, port_out
    for name, a, b in [(f"carry {i}", a, b) for i, (a, b)
                       in enumerate(zip(jc, tc))] + [("packed", jp, tp),
                                                     ("top scores", jts,
                                                      tts)]:
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert a.dtype.itemsize == b.dtype.itemsize, name
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
        else:
            assert np.array_equal(a, b.astype(a.dtype)), name


def _sharded_case(args, n, shards, w, spread_alg):
    """args padded to a mesh of `shards` shards over n rows: kway_plain
    with the node axis split, held bit for bit against `_select_kway` and
    against the unsplit plain version on the same padded table."""
    padded = edges.pad_rows(args, pad_for_mesh(make_mesh(shards, "cpu"), n))
    statics = dict(max_steps=tsel._kway_steps(w), spread_alg=spread_alg,
                   w=w)
    targs = _torch_args(padded, jsel._CHUNKED_ARGS)
    got = kernels.kway_plain(**targs, **statics, shards=shards)
    _exact_run(_jax_kway(targs, **statics), got)
    whole = kernels.kway_plain(**targs, **statics)
    for a, b in zip(got[0] + got[1], whole[0] + whole[1]):
        assert torch.equal(a, b)
    return got[1][0]


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(EDGE_CASES))
@pytest.mark.parametrize("shards", [2, 8])
def test_kway_sharded_edge_shapes_match_jax(shards, label, spread_alg):
    args, w = _edge(label)
    n, count, kind = EDGE_CASES[label]
    packed = _sharded_case(args, n, shards, w, spread_alg)
    steps, remaining = int(packed[0, -1]), int(packed[0, -2])
    if kind == "none":
        assert steps == 1 and remaining == count
        assert packed[0, 2 * w:2 * w + 5].tolist() == [0, 1, 2, 3, 4]
    if kind == "dry":
        assert steps > 1 and remaining > 0
        assert int(packed[steps - 1, -3]) == 0


@pytest.mark.parametrize("kind", ["alike", "none"])
@pytest.mark.parametrize("shards", [2, 8])
def test_kway_sharded_ties_cross_shards(shards, kind):
    """48 rows at W 32: every shard holds fewer than W + 1 rows (24 at S
    2; 8 at S 8, padded to 64), so the lane's top-(W + 1) spans shards.
    All-alike rows are one tie storm at one score, no feasible row one at
    NEG_INF: either way the winners are the lowest rows, in row order,
    across the shards' boundaries."""
    n, w = 48, 32
    assert pad_for_mesh(make_mesh(shards, "cpu"), n) // shards < w + 1
    args = edges.kway_edge_args(n, 600, "alike", seed=5,
                                feasible_rows=0 if kind == "none" else None)
    packed = _sharded_case(args, n, shards, w, spread_alg=False)
    top5 = packed[0, 2 * w:2 * w + 5].tolist()
    assert top5 == [0, 1, 2, 3, 4]
    if kind == "alike":
        assert packed[0, :w].tolist() == list(range(w))
    else:
        assert int(packed[0, -1]) == 1 and int(packed[0, -3]) == 0


def _premise_values(case, n, rng):
    if case == "storm":
        return np.full(n, 0.5, np.float32)
    if case == "neg_inf":
        v = np.full(n, kernels.NEG_INF, np.float32)
        live = rng.choice(n, n // 10, replace=False)
        v[live] = rng.choice([0.25, 0.5, 0.75], live.size)
        return v
    if case == "signed_zeros":
        v = np.where(rng.random(n) < 0.5, np.float32(0.0),
                     np.float32(-0.0)).astype(np.float32)
        some = rng.choice(n, n // 8, replace=False)
        v[some] = rng.choice([-1.0, 1.0, kernels.NEG_INF], some.size)
        return v
    return rng.choice([0.1, 0.2, 0.3, kernels.NEG_INF], n).astype(np.float32)


@pytest.mark.parametrize("k", [5, 129])
@pytest.mark.parametrize("case", ["storm", "neg_inf", "signed_zeros",
                                  "few_values"])
@pytest.mark.parametrize("shards", [1, 2, 8, 33])
def test_merge_premise_topk_shards(shards, case, k):
    """The sharded kernel's top-(W + 1) is each shard's own top-k (its
    whole slice when that is shorter), then the top-k of the S lists laid
    end to end: equal to the top-k of the whole table, ties in row order.
    264 rows split into 33 shards hold 8 each, fewer than k = 129."""
    n = 264
    rng = np.random.default_rng(1000 * shards + k)
    v = torch.from_numpy(_premise_values(case, n, rng))
    gv, gi = kernels._topk_shards(v, k, shards)
    wv, wi = kernels._topk_stable(v, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    if case != "signed_zeros":
        # lax.top_k orders +0.0 before -0.0; the port's rule (order_key in
        # select_common.cuh) holds them equal, and a masked K-way score is
        # never -0.0 (its binpack term is +0.0 or positive)
        jv, ji = jax.lax.top_k(v.numpy(), k)
        assert np.array_equal(np.asarray(ji), wi.numpy())
        assert np.array_equal(np.asarray(jv), wv.numpy())


@pytest.mark.parametrize("spread_alg", [False, True])
def test_masked_score_of_zero_is_positive_zero(spread_alg):
    """lax.top_k orders +0.0 before -0.0, while the port's order key holds
    them equal; the two agree on every K-way table because a masked score
    is never -0.0. Rows built to score exactly zero (the fit term at 0:
    nothing used and nothing asked under binpack, full under spread), with
    every other term at -0.0 where an input can be, score +0.0 in the
    plain sweep and in the JAX package's own sweep."""
    n = 8
    capacity = np.tile(np.array([4000., 8192., 100., 100.], np.float32),
                       (n, 1))
    ask = np.zeros(4, np.float32) if not spread_alg else \
        np.array([1000., 2048., 0., 0.], np.float32)
    used = np.zeros((n, 4), np.float32) if not spread_alg else \
        capacity - ask[None, :]
    neg0 = np.full(n, -0.0, np.float32)
    args = dict(capacity=capacity, used=used, feasible=np.ones(n, bool),
                ask=ask, coll=np.zeros(n, np.int32),
                penalty=np.zeros(n, bool), affinity_norm=neg0,
                desired_count=1.0, port_need=0.0,
                free_p=np.full(n, 10.0, np.float32),
                port_ok=np.ones(n, bool),
                dev_slots=np.full(n, 10.0, np.float32), dev_score=neg0,
                dev_fires=0.0, pre_score=neg0)
    masked = kernels._local_sweep(
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in args.items()}, spread_alg=spread_alg)[0].numpy()
    assert np.all(masked == 0.0) and not np.any(np.signbit(masked))
    jfinal = jsel._local_final_score(
        used + ask[None, :], np.maximum(capacity[:, 0], 1e-9),
        np.maximum(capacity[:, 1], 1e-9), args["coll"], args["penalty"],
        neg0, 1.0, spread_alg, neg0, 0.0, neg0)
    assert not np.any(np.signbit(np.asarray(jfinal)))
