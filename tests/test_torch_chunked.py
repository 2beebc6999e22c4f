"""The chunked placement step by step: the premises of the card kernel's
redesign (select_kernels.cu, chunked_body), and the chunked edge shapes,
against the JAX package.

- The rescoring premise (20 seeds, n = 200, binpack and spread, with
  ports, device slots, penalties, affinities and preemption scores):
  chunked_plain chained one step a launch (max_steps=1, each launch fed the
  previous carry). After each step `masked`, recomputed from the carry by
  the plain sweep (`kernels._local_sweep`), differs from the previous
  step's only at the winner's row; the chained steps' choices, chunks and
  carries equal one long run's (the step-0 diagnostics differ by design:
  every launch reports its first step's), and both equal the JAX package's
  `_select_chunked` (ints exactly, scores within 1e-6). Along the chain
  the kernel's kept list (KeptList) names the same winner and runner-up as
  the JAX program's two argmax passes at every step, at a length of 64
  and at the length the kernel fits to the launch (`_fitted_m`), which
  is never made again where it is not capped at 256.
- The kept list on made-up scores: tie storms, NEG_INF rows, mixes of -0.0
  and +0.0 and few distinct values, over tables smaller than the list, one
  row longer, and four times longer, at list lengths 32, 64 and 256.
- The stream walk: a chunk from the winner's sub-placements walked 16 (the
  kernel's CHUNK_ROUND) or 32 a round up to the first loser or past a_max
  equals the JAX program's min(max(leading wins, 1), a_max).
- The edge shapes (`nomad_tpu_torch.mock.chunked_edges`, counts up to
  512): chunked_plain against `_select_chunked`, and the chain and the
  list along each; tests/test_torch_cuda.py holds the kernel against
  chunked_plain at the same shapes on the card.
- A batch of 8 mixed lanes over one capacity table, one of them running
  dry, against `_chunked_batched_jit`.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.mock.chunked_edges import (
    CHUNKED_EDGES, CHUNKED_LANES, chunked_edge_args, chunked_lanes)
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
from nomad_tpu_torch.state.carry import select_request_from_arrays
from test_torch_select import _fields, _same, _torch_args

SEEDS = list(range(20))
N = 200
NEG_INF = np.float32(kernels.NEG_INF)


def _better(av, ai, bv, bi):
    """The kernels' order: score descending, row ascending (-0.0 and +0.0
    equal)."""
    return av > bv or (av == bv and ai < bi)


class KeptList:
    """The card kernel's kept candidate list (chunked_body and
    chunk_list_update in select_kernels.cu): the top-m of masked in (score
    desc, row asc) order. A step takes its winner (the first entry) out
    and puts it back at its new score where that still ranks above the
    last entry, or drops it (every row outside the list ranks below the
    last entry); a list of every row never drops one. A step that finds it
    below two entries makes it again from masked (`ready`)."""

    def __init__(self, masked, m):
        self.m = min(m, masked.numel())
        self.whole = masked.numel() <= m
        self.rebuilds = self.drops = 0
        self.rebuild(masked)

    def rebuild(self, masked):
        v, i = kernels._topk_stable(masked, self.m)
        self.v, self.i = v.tolist(), i.tolist()
        self.rebuilds += 1

    def top2(self):
        return self.i[0], self.v[0], self.i[1]

    def ready(self, masked):
        """A new list before a step if this one is short."""
        if len(self.i) < 2:
            self.rebuild(masked)

    def update(self, sv):
        """The first entry rescored to sv."""
        c = self.i[0]
        if not self.whole and not _better(sv, c, self.v[-1], self.i[-1]):
            del self.v[0], self.i[0]
            self.drops += 1
        else:
            r = sum(_better(v, i, sv, c)
                    for v, i in zip(self.v[1:], self.i[1:]))
            self.v = self.v[1:r + 1] + [sv] + self.v[r + 1:]
            self.i = self.i[1:r + 1] + [c] + self.i[r + 1:]


def _fitted_m(n, max_steps, k_valid):
    """chunked_body's list length: a step drops at most one entry and a
    launch runs at most min(max_steps, k_valid) steps, so that many plus
    one needs no new list; at least TOP_K, at most CHUNK_M (256) and n."""
    return min(n, max(kernels.TOP_K, min(256, min(max_steps, k_valid) + 1)))


def _same_top2(kept, masked):
    """The list's first two are the JAX program's winner and runner-up
    (select.py:496-500): argmax, then argmax with the winner set to
    NEG_INF. The runner-up's row is held where the winner and the
    runner-up are valid: an invalid winner places nothing and ends the
    loop, and every sub-placement score beats a NEG_INF runner-up whatever
    its row (the JAX program's is then row 0, which may be the winner's
    own; the list's is the first other row)."""
    v = np.array(masked, np.float32)
    choice = int(jnp.argmax(v))
    c, cv, r = kept.top2()
    assert c == choice and cv == float(v[choice])
    if cv > kernels.NEG_INF / 2:
        v[choice] = NEG_INF
        ri = int(jnp.argmax(v))
        rv = float(v[ri])
        assert kept.v[1] == rv
        if rv > kernels.NEG_INF / 2:
            assert r == ri


def _carry_args(args, carry, remaining):
    used, coll, free_p, dev_slots = carry
    return dict(args, used0=used, tg_coll0=coll, free_ports=free_p,
                dev_slots0=dev_slots, k_valid=remaining)


def _masked(a, spread_alg):
    return kernels._local_sweep(
        a["capacity"], a["used0"], a["feasible"], a["ask"], a["tg_coll0"],
        a["penalty"], a["affinity_norm"], a["desired_count"],
        a["port_need"], a["free_ports"], a["port_ok"], a["dev_slots0"],
        a["dev_score"], a["dev_fires"], a["pre_score"], spread_alg)[0]


def _max_steps(count):
    """SelectKernel's budget of a chunked launch (select.py)."""
    return 64 if count <= 64 else 512


def _jax_run(targs, max_steps, spread_alg):
    cargs = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in targs.items()}
    return jsel._select_chunked(**cargs, max_steps=max_steps,
                                spread_alg=spread_alg)


def _same_run(jax_out, port_out):
    (jc, jo), (tc, to) = jax_out, port_out
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    for i, (a, b) in enumerate(zip(jo, to)):
        _same(f"out {i}", a, b)


def _chain(targs, spread_alg, whole, max_steps):
    """chunked_plain one step a launch from targs, each launch fed the
    last carry, against the long run `whole` (of `max_steps`): the premise
    (masked changes at the winner's row only), the chained choices, chunks
    and carries, and the kept lists' winner and runner-up against the
    argmax passes at every step. Returns the kept list of length 64; the
    one of the kernel's fitted length is never made again unless its
    length was capped."""
    steps = int(whole[1][7])
    a = dict(targs)
    prev = _masked(a, spread_alg)
    k_valid = int(a["k_valid"])
    fit = _fitted_m(prev.numel(), max_steps, k_valid)
    kept, fitted = KeptList(prev, 64), KeptList(prev, fit)
    for step in range(steps):
        for lst in (kept, fitted):
            lst.ready(prev)
            _same_top2(lst, prev)
        c = kept.top2()[0]
        carry, o = kernels.chunked_plain(**a, max_steps=1,
                                         spread_alg=spread_alg)
        assert int(o[0][0]) == int(whole[1][0][step]), step
        assert int(o[1][0]) == int(whole[1][1][step]), step
        valid = int(o[0][0]) >= 0
        a = _carry_args(a, carry, int(o[6]))
        now = _masked(a, spread_alg)
        changed = torch.nonzero(now.view(torch.int32)
                                != prev.view(torch.int32))[:, 0].tolist()
        assert changed in ([], [c]), (step, changed)
        if valid:
            for lst in (kept, fitted):
                lst.update(float(now[c]))
        prev = now
    assert int(a["k_valid"]) == int(whole[1][6])
    for got, want in zip((a["used0"], a["tg_coll0"], a["free_ports"],
                          a["dev_slots0"]), whole[0]):
        assert torch.equal(got, want)
    if min(max_steps, k_valid) + 1 <= 256:
        assert fitted.rebuilds == 1, (fit, steps)
    return kept


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_rescoring_premise_and_chained_steps(seed, spread_alg):
    fields = _fields(seed, "chunked", n=N)
    fields["algorithm"] = "spread" if spread_alg else "binpack"
    n_pad = tsel._pad_n(N)
    args, st = tsel.pack_request(select_request_from_arrays(fields), n_pad)
    assert st["spread_alg"] == spread_alg
    targs = _torch_args(args, jsel._CHUNKED_ARGS)
    whole = kernels.chunked_plain(**targs, max_steps=64,
                                  spread_alg=spread_alg)
    _same_run(_jax_run(targs, 64, spread_alg), whole)
    assert int(whole[1][7]) > 1
    _chain(targs, spread_alg, whole, 64)


def _made_up(case, n, rng):
    """A table of scores and a draw of a winner's new score."""
    if case == "storm":
        vals = [0.5, 0.25, 0.75]
        return np.full(n, 0.5, np.float32), vals
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
    v = rng.choice([0.1, 0.2, 0.3, NEG_INF], n).astype(np.float32)
    return v, [0.1, 0.2, 0.3, float(NEG_INF)]


@pytest.mark.parametrize("m", [32, 64, 256])
@pytest.mark.parametrize("size", ["below_m", "m_plus_1", "four_m"])
@pytest.mark.parametrize("case", ["storm", "neg_inf", "signed_zeros",
                                  "few_values"])
def test_kept_list_matches_two_argmax_passes(case, size, m):
    """Each step the winner's score moves to a value drawn from the case's
    few values (ties, NEG_INF, signed zeros); the list's first two stay
    the argmax passes' winner and runner-up throughout."""
    n = {"below_m": m // 2, "m_plus_1": m + 1, "four_m": 4 * m}[size]
    rng = np.random.default_rng(zlib.crc32(f"{case} {size} {m}".encode()))
    v, draw = _made_up(case, n, rng)
    t = torch.from_numpy(v)
    kept = KeptList(t, m)
    for _step in range(2 * m + 8):
        kept.ready(t)
        _same_top2(kept, v)
        # the list is the exact top of the table, in order
        assert kept.i == kernels._topk_stable(t, len(kept.i))[1].tolist()
        c = kept.top2()[0]
        v[c] = np.float32(rng.choice(draw))
        kept.update(float(v[c]))
    if size == "below_m":
        assert kept.whole and kept.drops == 0 and kept.rebuilds == 1
    if size == "m_plus_1" and case == "storm":
        # the table one row longer than the list: a drop leaves m - 1
        assert kept.drops > 0


def _walk(wins, a_max, width):
    """The card kernel's stream walk (chunked_steps): rounds of `width`
    sub-placements until the first loser, or until a round would start at
    or past a_max; then min(max(f, 1), a_max)."""
    f = kernels.CHUNK_J
    for j0 in range(0, kernels.CHUNK_J, width):
        if not np.float32(j0) < a_max:
            f = j0
            break
        lose = np.flatnonzero(~wins[j0:j0 + width])
        if lose.size:
            f = j0 + int(lose[0])
            break
    return np.minimum(np.maximum(np.float32(f), np.float32(1.0)), a_max)


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("a_kind", ["whole", "fraction", "small"])
def test_stream_walk_matches_leading_wins(a_kind, width):
    rng = np.random.default_rng({"whole": 1, "fraction": 2, "small": 3}[
        a_kind])
    for _ in range(400):
        p = rng.choice([0.9, 0.99, 1.0])
        wins = rng.random(kernels.CHUNK_J) < p
        a_max = {"whole": rng.integers(0, 400),
                 "fraction": rng.uniform(0, 300),
                 "small": rng.choice([0.0, 0.5, 1.0, 1.5, 31.0, 32.0,
                                      33.0])}[a_kind]
        a_max = np.float32(a_max)
        lead = np.cumprod(wins.astype(np.int32)).sum()
        want = np.minimum(np.maximum(np.float32(lead), np.float32(1.0)),
                          a_max)
        got = _walk(wins, a_max, width)
        assert got.tobytes() == want.tobytes(), (a_max, lead)


def _edge(label, seed=0):
    return _torch_args(chunked_edge_args(label, seed), jsel._CHUNKED_ARGS)


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(CHUNKED_EDGES))
def test_chunked_edge_shapes_match_jax(label, spread_alg):
    targs = _edge(label)
    count = CHUNKED_EDGES[label][2]
    got = kernels.select_chunked(**targs, max_steps=_max_steps(count),
                                 spread_alg=spread_alg)
    _same_run(_jax_run(targs, _max_steps(count), spread_alg), got)
    choice, chunk, ti, _ts, _exh, feas, rem, steps = got[1]
    steps, rem = int(steps), int(rem)
    if label == "first step invalid":
        assert steps == 1 and rem == count and int(feas[0]) == 0
        assert ti[0].tolist() == [0, 1, 2, 3, 4]
    elif label == "runs dry":
        assert steps > 1 and rem > 0 and int(feas[steps - 1]) == 0
    elif label == "two feasible rows":
        assert int(feas[0]) == 2
    elif label == "n below 5":
        # a table of 8 rows: the top-5 reach its padding, NEG_INF rows in
        # row order
        assert targs["capacity"].shape[0] == 8
        neg = ti[0][_ts[0] <= kernels.NEG_INF / 2].tolist()
        assert neg == sorted(neg) and max(neg) >= 3
    elif label == "chunk reaches CHUNK_J":
        assert int(chunk[0]) == kernels.CHUNK_J
    elif label == "all alike, count 512":
        # more steps than the kept list holds: the kernel rebuilds it
        assert steps > 64 and int(feas[0]) == N
    elif label.startswith("tie"):
        # the runner-up ties the winner's sub-placement 2: the lower row
        # wins the tie (chunk 3), the higher loses it (chunk 2)
        assert int(chunk[0]) == (3 if "lower" in label else 2)
        assert int(choice[0]) == (0 if "lower" in label else 1)


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(CHUNKED_EDGES))
def test_chunked_edge_chain_and_kept_list(label, spread_alg):
    targs = _edge(label, seed=1)
    count = CHUNKED_EDGES[label][2]
    whole = kernels.chunked_plain(**targs, max_steps=_max_steps(count),
                                  spread_alg=spread_alg)
    kept = _chain(targs, spread_alg, whole, _max_steps(count))
    if label == "all alike, count 512" and spread_alg:
        # every winner drops out: the list is made again
        assert kept.rebuilds > 1


@pytest.mark.parametrize("spread_alg", [False, True])
def test_chunked_batched_mixed_lanes_match_jax(spread_alg):
    a = chunked_lanes(64, CHUNKED_LANES, seed=7)
    jc, jo = jsel._chunked_batched_jit(512, spread_alg)(
        *[a[k] for k in jsel._CHUNKED_ARGS])
    targs = {k: torch.from_numpy(v) for k, v in a.items()}
    tc, to = kernels.select_chunked_batched(**targs, max_steps=512,
                                            spread_alg=spread_alg)
    for i, (x, y) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", x, y)
    for i, (x, y) in enumerate(zip(jo, to)):
        _same(f"out {i}", x, y)
    rem, steps = to[6], to[7]
    assert int(rem[2]) > 0 and int(to[5][2, int(steps[2]) - 1]) == 0
    assert int(steps[5]) == 1 and int(to[5][5, 0]) == 0
