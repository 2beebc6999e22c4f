"""The node-sharded chunked kernels (row 10c chunked: chunked_cluster_body
and chunked_grid_body in csrc/sharded_kernels.cu, a thread-block cluster a
lane up to 16 shards and the cooperative grid past that) step by step: the
premises of their design, the wrappers' launch arguments, and the edge
shapes against the JAX package.

- A plain model of the shard body (ShardedLists): shard s of S keeps the
  top-m of its own rows (m the single card's fitted length, capped at the
  shard's rows; a list of its whole shard never drops an entry), the owner
  of the best head knows every shard's head (a table every block keeps on
  the grid route, the handoff's message on the cluster route), and it runs
  step after step from its own list and the best head of the other shards.
  It hands off once that head ranks above its own, and makes its list again
  from its rows when it is short of two entries. At every step the model's
  winner
  and runner-up are the JAX program's two argmax passes over the whole of
  masked (select.py:496-500), and each shard's list is the exact top of its
  rows. Made-up tables (tie storms, equal scores on either side of a shard
  boundary, NEG_INF rows, -0.0 against +0.0, few values, and a winner that
  changes shard every step) at S 1, 2, 3 and 8, with shards shorter than m,
  equal to it and one row longer; and real chains, chunked_plain one step a
  launch on padded mesh tables, where masked changes at the winner's row
  only.
- The three chunked wrappers, taken past their CPU branch to a stand-in
  library: each passes its entry point exactly the arguments of its C
  signature (ctypes would pass extra ones on without a word).
- The edge shapes (`nomad_tpu_torch.mock.chunked_edges`): CHUNKED_EDGES as
  one lane each and CHUNKED_LANES, padded as a mesh of S shards pads them
  (`pad_for_mesh`), through chunked_batched_sharded_plain at S 2 and 8,
  against the JAX package's `_chunked_batched_jit` on the same padded
  lanes: choices, chunks, top-5 rows, counts and carries identical, scores
  within 1e-6.
tests/test_torch_cuda.py holds the card's kernels against the plain version
and the single-card batched kernel at the same edge shapes.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.mock.chunked_edges import (
    CHUNKED_EDGES, CHUNKED_LANES, chunked_edge_args, chunked_lanes,
    edge_rows, one_lane, pad_lanes)
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
from nomad_tpu_torch.parallel import make_mesh, pad_for_mesh
from nomad_tpu_torch.state.carry import select_request_from_arrays
from test_torch_chunked import (_better, _carry_args, _fitted_m, _masked,
                                _max_steps)
from test_torch_select import _fields, _same, _torch_args

NEG_INF = np.float32(kernels.NEG_INF)
SHARDS = (1, 2, 3, 8)
SENTINEL = (-np.inf, np.iinfo(np.int32).max)


class ShardedLists:
    """The shard body's kept lists and heads (chunked_cluster_body,
    chunk_drive and chunked_steps<true>): shard s owns rows [s * per, (s +
    1) * per) and
    keeps their top-m in (score desc, row asc) order. `top2` is a step's
    winner and runner-up as the owner's warp finds them, after the
    handoffs and rebuilds the kernel makes first; `update` is
    chunk_list_update on the owner's list."""

    def __init__(self, masked, shards, m):
        self.per = masked.numel() // shards
        self.m = min(m, self.per)
        self.whole = self.m == self.per
        self.lists = [self._top(masked, s) for s in range(shards)]
        self.owner = None
        self.handoffs = self.rebuilds = self.drops = 0

    def _top(self, masked, s):
        lo = s * self.per
        v, i = kernels._topk_stable(masked[lo:lo + self.per], self.m)
        return v.tolist(), [lo + r for r in i.tolist()]

    def _head(self, s):
        v, i = self.lists[s]
        return (v[0], i[0]) if v else SENTINEL

    def _best(self, skip=None):
        best, at = SENTINEL, None
        for s in range(len(self.lists)):
            if s != skip and _better(*self._head(s), *best):
                best, at = self._head(s), s
        return best, at

    def top2(self, masked):
        """(winner row, its score, runner-up row, its score)."""
        while True:
            if self.owner is None:
                # an exchange: every block finds the best head's owner
                self.owner = self._best()[1]
            s = self.owner
            v, i = self.lists[s]
            other = self._best(skip=s)[0]
            if v and not _better(v[0], i[0], *other):
                self.owner = None
                self.handoffs += 1
                continue
            if len(v) < 2:
                self.lists[s] = self._top(masked, s)
                self.rebuilds += 1
                continue
            second = (v[1], i[1]) if _better(v[1], i[1], *other) else other
            return i[0], v[0], second[1], second[0]

    def update(self, sv):
        v, i = self.lists[self.owner]
        c = i[0]
        if not self.whole and not _better(sv, c, v[-1], i[-1]):
            del v[0], i[0]
            self.drops += 1
            return
        r = sum(_better(a, b, sv, c) for a, b in zip(v[1:], i[1:]))
        v[:] = v[1:r + 1] + [sv] + v[r + 1:]
        i[:] = i[1:r + 1] + [c] + i[r + 1:]

    def exact(self, masked):
        """Each shard's list is the exact top of its rows."""
        for s, (v, i) in enumerate(self.lists):
            lo = s * self.per
            want = kernels._topk_stable(masked[lo:lo + self.per], len(i))[1]
            assert i == [lo + r for r in want.tolist()], s


def _argmax_passes(masked, c, cv, r, rv):
    """(c, cv) is the JAX program's argmax and (r, rv) its argmax with the
    winner set to NEG_INF (select.py:496-500). The runner-up's row is held
    where both are valid: a NEG_INF runner-up changes no chunk, and the
    JAX program's may be the winner's own row (row 0)."""
    v = np.array(masked, np.float32)
    choice = int(jnp.argmax(v))
    assert c == choice and cv == float(v[choice])
    if cv > kernels.NEG_INF / 2:
        v[choice] = NEG_INF
        ri = int(jnp.argmax(v))
        assert rv == float(v[ri])
        if rv > kernels.NEG_INF / 2:
            assert r == ri


def _made_up(case, shards, per, rng):
    """A table of shards * per scores, and the draw of a winner's new
    score."""
    n = shards * per
    if case == "storm":
        return np.full(n, 0.5, np.float32), [0.5, 0.25, 0.75]
    if case == "boundary":
        # equal scores on either side of every shard boundary, above the rest
        v = np.full(n, 0.5, np.float32)
        for s in range(1, shards):
            v[s * per - 1:s * per + 1] = 0.9
        v[0] = 0.9
        return v, [0.9, 0.5, 0.25]
    if case == "neg_inf":
        v = np.full(n, NEG_INF, np.float32)
        live = rng.choice(n, max(n // 10, 2), replace=False)
        v[live] = rng.choice([0.25, 0.5, 0.75], live.size)
        return v, [float(NEG_INF), 0.3, 0.6]
    if case == "signed_zeros":
        v = np.where(rng.random(n) < 0.5, np.float32(0.0),
                     np.float32(-0.0)).astype(np.float32)
        some = rng.choice(n, n // 8, replace=False)
        v[some] = rng.choice([-1.0, 1.0, NEG_INF], some.size)
        return v, [0.0, -0.0, -1.0, 1.0]
    if case == "alternating":
        # every shard's rows descend alike, and a winner falls below them
        # all: the next best head is always the next shard's
        v = np.tile(1.0 - 1e-3 * np.arange(per, dtype=np.float32), shards)
        return v.astype(np.float32), [-1.0]
    v = rng.choice([0.1, 0.2, 0.3, NEG_INF], n).astype(np.float32)
    return v, [0.1, 0.2, 0.3, float(NEG_INF)]


CASES = ["storm", "boundary", "neg_inf", "signed_zeros", "few_values",
         "alternating"]
M = 32
SIZES = {"shorter": M - 12, "equal": M, "one_longer": M + 1}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_lists_match_two_argmax_passes(case, shards, size):
    """Each step the winner's score moves to a value drawn from the case's
    few values; the owner's winner and runner-up stay the argmax passes'
    over the whole table, and every shard's list the exact top of its
    rows, through handoffs, drops and rebuilds."""
    per = SIZES[size]
    rng = np.random.default_rng(zlib.crc32(f"{case} {shards} {size}".encode()))
    v, draw = _made_up(case, shards, per, rng)
    t = torch.from_numpy(v)
    lists = ShardedLists(t, shards, M)
    assert lists.whole == (per <= M)
    steps = min(2 * M + 8, v.size) if case == "alternating" else 2 * M + 8
    for _step in range(steps):
        c, cv, r, rv = lists.top2(t)
        _argmax_passes(v, c, cv, r, rv)
        lists.exact(t)
        if not cv > kernels.NEG_INF / 2:
            break   # the kernel reports the invalid step and ends
        v[c] = np.float32(rng.choice(draw))
        lists.update(float(v[c]))
    if lists.whole:
        assert lists.drops == 0 and lists.rebuilds == 0
    if case == "alternating":
        # the winner changes shard at every step
        assert lists.handoffs == (steps - 1 if shards > 1 else 0)
    if size == "one_longer" and case == "storm":
        assert lists.drops > 0


def _mesh_rows(shards, n):
    return pad_for_mesh(make_mesh(shards, "cpu"), n)


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("seed", range(4))
def test_sharded_lists_along_real_chains(seed, shards, spread_alg):
    """chunked_plain one step a launch on a request padded as a mesh of S
    shards pads it: masked changes at the winner's row only, the model's
    winner and runner-up are the argmax passes' at every step, and the long
    run of the sharded plain version makes the chained choices and chunks
    and ends at the same carry."""
    fields = _fields(seed, "chunked", n=200)
    fields["algorithm"] = "spread" if spread_alg else "binpack"
    args, st = tsel.pack_request(select_request_from_arrays(fields),
                                 _mesh_rows(shards, 200))
    a = _torch_args(args, jsel._CHUNKED_ARGS)
    whole = kernels.chunked_plain(**a, max_steps=64, spread_alg=spread_alg,
                                  shards=shards)
    steps = int(whole[1][7])
    assert steps > 1
    masked = _masked(a, spread_alg)
    lists = ShardedLists(masked, shards,
                         _fitted_m(masked.numel(), 64, int(a["k_valid"])))
    for step in range(steps):
        c, cv, r, rv = lists.top2(masked)
        _argmax_passes(masked, c, cv, r, rv)
        carry, o = kernels.chunked_plain(**a, max_steps=1,
                                         spread_alg=spread_alg)
        assert int(o[0][0]) == int(whole[1][0][step])
        assert int(o[1][0]) == int(whole[1][1][step])
        a = _carry_args(a, carry, int(o[6]))
        now = _masked(a, spread_alg)
        changed = torch.nonzero(now.view(torch.int32)
                                != masked.view(torch.int32))[:, 0].tolist()
        assert changed in ([], [c])
        masked = now
        if int(o[0][0]) < 0:
            break
        lists.update(float(masked[c]))
        lists.exact(masked)
    # a list fitted to the launch's steps is never made again
    assert lists.rebuilds == 0
    for got, want in zip((a["used0"], a["tg_coll0"], a["free_ports"],
                          a["dev_slots0"]), whole[0]):
        assert torch.equal(got, want)


def _jax_batched(a, max_steps, spread_alg):
    return jsel._chunked_batched_jit(max_steps, spread_alg)(
        *[a[k] for k in jsel._CHUNKED_ARGS])


def _torch_lanes(a):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in a.items()}


def _same_batched(jax_out, port_out):
    (jc, jo), (tc, to) = jax_out, port_out
    for i, (x, y) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", x, y)
    for i, (x, y) in enumerate(zip(jo, to)):
        _same(f"out {i}", x, y)


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("label", sorted(CHUNKED_EDGES))
def test_chunked_sharded_edge_shapes_match_jax(label, shards, spread_alg):
    n_pad = _mesh_rows(shards, edge_rows(label))
    a = one_lane(chunked_edge_args(label, seed=3, n_pad=n_pad))
    max_steps = _max_steps(CHUNKED_EDGES[label][2])
    got = kernels.select_chunked_batched_sharded(
        **_torch_lanes(a), max_steps=max_steps, spread_alg=spread_alg,
        shards=shards)
    _same_batched(_jax_batched(a, max_steps, spread_alg), got)
    steps, feas = int(got[1][7][0]), got[1][5][0]
    if label == "first step invalid":
        assert steps == 1 and int(feas[0]) == 0
    elif label == "runs dry":
        assert steps > 1 and int(got[1][6][0]) > 0
        assert int(feas[steps - 1]) == 0
    elif label == "chunk reaches CHUNK_J":
        assert int(got[1][1][0][0]) == kernels.CHUNK_J


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("shards", [2, 8])
def test_chunked_sharded_mixed_lanes_match_jax(shards, spread_alg):
    a = pad_lanes(chunked_lanes(64, CHUNKED_LANES, seed=7),
                  _mesh_rows(shards, 64))
    got = kernels.select_chunked_batched_sharded(
        **_torch_lanes(a), max_steps=512, spread_alg=spread_alg,
        shards=shards)
    _same_batched(_jax_batched(a, 512, spread_alg), got)
    rem, steps = got[1][6], got[1][7]
    assert int(rem[2]) > 0 and int(got[1][5][2, int(steps[2]) - 1]) == 0
    assert int(steps[5]) == 1 and int(got[1][5][5, 0]) == 0


class _Launcher:
    """A stand-in for one C entry point of the kernels' library: records
    the arguments of a call, which must match the entry point's argtypes
    one for one (ctypes would pass extra arguments on silently)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        want = kernels._ARGTYPES[self.name]
        assert len(args) == len(want), (self.name, len(args), len(want))
        for i, (arg, kind) in enumerate(zip(args, want)):
            if kind is kernels._F:
                assert isinstance(arg, float), (self.name, i, arg)
            else:
                assert isinstance(arg, int), (self.name, i, arg)
        self.calls.append((self.name, args))
        return 0


@pytest.mark.parametrize("case", ["solo", "batched", "cluster", "grid"])
def test_chunked_wrappers_pass_their_launchers_arguments(monkeypatch, case):
    """Each chunked wrapper, taken past its CPU branch, calls its entry
    point with exactly the arguments of its C signature: every pointer
    where a pointer goes (the outputs, the caller's carries, the scratch)
    and, for the sharded one, the shards and rows a shard last."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return _Launcher(name, calls)

    monkeypatch.setattr(kernels, "load_library", lambda: Lib())
    monkeypatch.setattr(kernels, "_is_cpu", lambda capacity: False)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(kernels, "chunked_sharded_info", lambda shards: dict(
        route="cluster" if case == "cluster" else "grid", max_clusters=1))
    monkeypatch.setattr(kernels, "max_shards", lambda kernel, device: 8)
    monkeypatch.setattr(torch.cuda, "device", lambda device: torch.device(
        device))
    kernels._CHUNK_PLAN.clear()
    shards = 4 if case in ("cluster", "grid") else 1
    a = _torch_lanes(pad_lanes(chunked_lanes(64, CHUNKED_LANES, seed=7),
                               _mesh_rows(shards, 64)))
    kw = dict(max_steps=64, spread_alg=False)
    if case == "solo":
        got = kernels.select_chunked(**kernels.lane_args(a, 0), **kw)
        name = "nomad_select_chunked"
    elif case == "batched":
        got = kernels.select_chunked_batched(**a, **kw)
        name = "nomad_select_chunked_batched"
    else:
        got = kernels.select_chunked_batched_sharded(**a, **kw,
                                                     shards=shards)
        name = "nomad_select_chunked_batched_sharded"
    kernels._CHUNK_PLAN.clear()
    lanes = len(CHUNKED_LANES)
    launches = -(-lanes // (8 // shards)) if case == "grid" else 1
    assert [c[0] for c in calls] == [name] * launches
    args = calls[0][1]
    carry, outs = got
    # the caller's carries after the 13 tensors, the outputs after the
    # lane scalars, all at lane 0
    src = kernels.lane_args(a, 0) if case == "solo" else a
    assert list(args[13:17]) == [src[k].data_ptr() for k in (
        "used0", "tg_coll0", "free_ports", "dev_slots0")]
    at = {"solo": 25, "batched": 26, "cluster": 26, "grid": 26}[case]
    assert list(args[at:at + 8]) == [t.data_ptr() for t in outs]
    assert args[1] == carry[0].data_ptr() and args[4] == carry[1].data_ptr()
    if case in ("cluster", "grid"):
        assert args[-3:-1] == (shards, 64 // shards)
        assert (args[-5] == 0) == (case == "cluster")
    assert len(outs) == 8 and outs[3].dtype == torch.float32
