"""The node-sharded scan (the mesh's scan, one lane and batched) against
the JAX package, and the premises of its shard-by-shard body.

- The edge shapes (SCAN_EDGES of nomad_tpu_torch/mock/scan_edges.py, the
  one generator the tests and chip_smoke.py share), each table padded as a
  mesh of 8 shards pads it (`pad_rows`): select_scan_sharded and
  select_scan_batched_sharded (two lanes over one table) at S 1, 2 and 8
  against the JAX package's _select_scan and _scan_batched_jit run SPMD
  on the virtual 8-device CPU mesh of tests/conftest.py, the inputs
  sharded as the JAX package's mesh shards them (parallel/sharded.py).
  Placements, top-5 rows, counts and carries identical; scores within
  rtol = atol = 1e-6, as tests/test_torch_parallel.py holds them (10**x is
  rounded from float64 in the port, XLA's float32 pow can differ by 1
  ulp).
- The premises of the card's shard body (csrc/sharded_kernels.cu), on
  plain helpers kept here: the shards' live lists laid end to end in shard
  order are the single card's live list, and a slot's position s * per +
  slot orders as its row does; the best of the shards' bests under (score
  descending, position ascending) is the global arg-max (lowest row among
  ties), across shard boundaries, in a tie storm and beside shards whose
  live rows are all NEG_INF or that have none; every output row after a
  lane's first invalid step equals that step's row, on each lane of a
  batch, at S 1, 2 and 8.
tests/test_torch_cuda.py holds the card's kernels against their plain
versions and the single-card kernel at the same cases.
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import nomad_tpu.ops.select as jsel
from nomad_tpu.parallel import make_mesh as jax_make_mesh
from nomad_tpu_torch.mock import scan_edges as edges
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
from test_torch_batched import _torch
from test_torch_scan import _first_invalid, _repeats_after, _same_run
from test_torch_select import _torch_args

MESH = 8
SHARDS = (1, 2, 8)
# each argument's partition over the `nodes` mesh by PACK_SHARD_KINDS
# kind, one request (ShardedSelect.select) and a batch of lanes
# (ShardedSelect.place_batched_chunked_args: the lane axis replicated)
_SOLO = {"node": P("nodes"), "node2": P("nodes", None),
         "code": P(None, "nodes"), "rep": P(), "scalar": None}
_LANES = {"node": P(None, "nodes"), "node2": P(None, "nodes", None),
          "code": P(None, None, "nodes"), "rep": P(), "scalar": P()}


def _mesh_pad(n):
    """The rows of a table padded for a mesh of MESH shards; every S of
    SHARDS divides it."""
    return pad_for_mesh(make_mesh(MESH, "cpu"), n)


def _on_mesh(args, mesh, specs):
    out = {}
    for k, v in args.items():
        spec = P("nodes", None) if k == "capacity" \
            else specs[jsel.PACK_SHARD_KINDS[k]]
        out[k] = v if spec is None else jax.device_put(
            np.asarray(v), NamedSharding(mesh, spec))
    return out


def _edge(label, seed, spread_alg=False):
    args, st = edges.edge_case(label, seed, spread_alg)
    n = args["capacity"].shape[0]
    return edges.pad_rows(args, _mesh_pad(n)), st


@lru_cache(maxsize=None)
def _solo_case(label):
    """(padded arguments, statics, the JAX package's _select_scan over the
    mesh) of one edge case."""
    args, st = _edge(label, 31)
    mesh = jax_make_mesh(MESH)
    with mesh:
        out = jsel._select_scan(**_on_mesh(args, mesh, _SOLO), **st)
    return args, st, jax.device_get(out)


def _batch(lanes, k_steps):
    """One batched call's arguments from padded solo ones over lane 0's
    capacity, and its statics."""
    for a, _st in lanes[1:]:
        a["capacity"] = lanes[0][0]["capacity"]
    args, st = edges.lanes_batch(lanes)
    st["k_steps"] = k_steps
    return args, st


def _jax_batched(args, st):
    mesh = jax_make_mesh(MESH)
    placed = _on_mesh(args, mesh, _LANES)
    fn = jsel._scan_batched_jit(st["k_steps"], st["spread_alg"],
                                st["s_live"], st["p_live"])
    with mesh:
        out = fn(*[placed[nm] for nm in jsel._SCAN_ARGS])
    return jax.device_get(out)


@lru_cache(maxsize=None)
def _batched_case(label):
    """Two lanes of one edge case over one table (the case, and the same
    shape from another seed), with the JAX package's result."""
    lanes = [_edge(label, 31 + i) for i in range(2)]
    args, st = _batch(lanes, lanes[0][1]["k_steps"])
    return args, st, _jax_batched(args, st)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("label", sorted(edges.SCAN_EDGES))
def test_sharded_scan_edge_shapes_match_jax(label, shards):
    args, st, jout = _solo_case(label)
    got = kernels.select_scan_sharded(
        **_torch_args(args, jsel._SCAN_ARGS), **st, shards=shards)
    _same_run(jout, got)
    if (np.asarray(got[1][0]) < 0).any():
        _repeats_after(got[1], _first_invalid(got[1][0]))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("label", sorted(edges.SCAN_EDGES))
def test_sharded_scan_edge_shapes_batched_match_jax(label, shards):
    args, st, jout = _batched_case(label)
    _same_run(jout, kernels.select_scan_batched_sharded(
        **_torch(args), **st, shards=shards))


@lru_cache(maxsize=None)
def _mixed_case():
    """MIXED_LANES and the lane that runs dry over 200 rows, padded."""
    args, st = edges.mixed_lanes(200, 41, dry=True, n_pad=_mesh_pad(200))
    return args, st, _jax_batched(args, st)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_mixed_lanes_stop_premise(shards):
    """Ten lanes of counts 16-61 with their own stanzas and constraints,
    one with no feasible row, and a lane that runs dry: every lane's
    outputs after its first invalid step repeat that step, in the JAX
    package's mesh run and the port's sharded one, which agree."""
    args, st, jout = _mixed_case()
    got = kernels.select_scan_batched_sharded(**_torch(args), **st,
                                              shards=shards)
    _same_run(jout, got)
    choice = np.asarray(got[1][0])
    assert (choice[-2] == -1).all()
    assert 0 < (choice[-1] >= 0).sum() < edges.DRY_LANE[0]
    for b in range(choice.shape[0]):
        _repeats_after([np.asarray(o)[b] for o in got[1]],
                       _first_invalid(choice[b]))


# -- the shard body's premises on plain helpers ------------------------------

def _shard_live(ok, shards):
    """Each shard's live rows in row order, as its step-0 sweep lists them
    (slot i of shard s is row lists[s][i])."""
    per = len(ok) // shards
    return [s * per + np.nonzero(ok[s * per:(s + 1) * per])[0]
            for s in range(shards)]


def _better(av, ai, bv, bi):
    return av > bv or (av == bv and ai < bi)


def _lane_winner(masked, live, shards):
    """The lane's winner as the shard body takes it: each shard's best live
    slot under (score desc, slot asc), published as (score, position s *
    per + slot), or (-inf, INT_MAX) for a shard with no live row; then the
    best of the S candidates under (score desc, position asc). Returns
    (score, row) or (-inf, None)."""
    per = len(masked) // shards
    none = np.iinfo(np.int32).max
    lists = _shard_live(live, shards)
    best = (-np.inf, none)
    for s, rows in enumerate(lists):
        v, slot = -np.inf, none
        for i, row in enumerate(rows):
            if _better(masked[row], i, v, slot):
                v, slot = masked[row], i
        cand = (v, none if slot == none else s * per + slot)
        if _better(cand[0], cand[1], best[0], best[1]):
            best = cand
    if best[1] == none:
        return -np.inf, None
    s = best[1] // per
    return best[0], int(lists[s][best[1] - s * per])


def _step0(seed, shards):
    """masked and the live rows of step 0 of a seeded request, its table
    padded to whole shards of at least TOP_K rows."""
    n = 200
    args, st = edges.scan_edge_args(n, 30, "random", 9000 + seed,
                                    s_live=seed % 5, p_live=seed % 3)
    args = edges.pad_rows(args, -(-n // (shards * 8)) * shards * 8)
    a = _torch_args(args, jsel._SCAN_ARGS)
    carry = (a["used0"], a["tg_coll0"], a["job_count0"],
             torch.zeros_like(a["tg_coll0"]), a["free_ports"],
             a["dev_slots0"], a["sp_counts0"], a["sp_present0"].bool(),
             a["dp_counts0"])
    masked = kernels._scan_sweep(a, carry, spread_alg=False,
                                 s_live=st["s_live"],
                                 p_live=st["p_live"])[0].numpy()
    return masked, masked > kernels.NEG_INF / 2


@pytest.mark.parametrize("shards", [1, 2, 8, 33])
@pytest.mark.parametrize("seed", range(5))
def test_shard_live_lists_premise(seed, shards):
    """The shards' live lists, end to end in shard order, are the single
    card's live list, and positions s * per + slot ascend with the rows."""
    masked, live = _step0(seed, shards)
    lists = _shard_live(live, shards)
    assert np.array_equal(np.concatenate(lists), np.nonzero(live)[0])
    per = len(live) // shards
    pos = np.concatenate([s * per + np.arange(len(rows))
                          for s, rows in enumerate(lists)])
    assert (np.diff(pos) > 0).all() and (pos < len(live)).all()
    assert live.sum() > 0
    v, row = _lane_winner(masked, live, shards)
    assert row == int(np.argmax(masked)) and v == masked.max()


def _tie_case(kind, seed, n, shards):
    """(masked, live) with ties: "ties" scores from three values, so ties
    cross shard boundaries; "storm" every live row the same score;
    "neg_inf" shards whose live rows are all NEG_INF beside shards with no
    live row and a few scored ones."""
    rng = np.random.default_rng(seed)
    per = n // shards
    live = rng.random(n) < 0.7
    if kind == "ties":
        masked = rng.choice(np.float32([0.25, 0.5, 0.75]), n)
    elif kind == "storm":
        masked = np.full(n, np.float32(0.5))
    else:
        masked = np.full(n, np.float32(kernels.NEG_INF))
        for s in range(shards):
            if s % 3 == 1:
                live[s * per:(s + 1) * per] = False
        rows = rng.choice(np.nonzero(live)[0], 3, replace=False)
        masked[rows] = np.float32(0.5)
        # the same best score on both sides of a shard boundary
        if shards > 1:
            b = per * (shards // 2)
            live[b - 1:b + 1] = True
            masked[b - 1:b + 1] = np.float32(0.75)
    masked = np.where(live, masked, np.float32(kernels.NEG_INF))
    return masked.astype(np.float32), live


@pytest.mark.parametrize("shards", [2, 8, 33])
@pytest.mark.parametrize("kind", ["ties", "storm", "neg_inf"])
def test_shard_winner_premise(kind, shards):
    """The best of the shards' bests is the global arg-max, lowest row
    among ties (as jnp.argmax), and so is the plain version's
    _argmax_shards."""
    for seed in range(10):
        n = shards * 16
        masked, live = _tie_case(kind, seed, n, shards)
        v, row = _lane_winner(masked, live, shards)
        want = int(np.argmax(masked))
        assert row == want and v == masked[want], (seed, row, want)
        assert kernels._argmax_shards(torch.from_numpy(masked),
                                      shards) == want
