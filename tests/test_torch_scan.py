"""The scan placement step by step: the premises of the card kernel's
cached terms and of its stop at the first invalid step, and the scan's
edge shapes, against the JAX package.

- The cached terms (20 seeds, n = 200, binpack and spread, s_live 0-4 and
  p_live 0-4, with ports, device slots, penalties, affinities and
  preemption scores, some of them -0.0, a stanza weight of -0.0, rows
  missing an attribute, and histograms with random counts, no code present
  or every present code at one count): from a carry with random usage and
  scan_placed, `_cached_masked` (each row's record of
  node-local terms and the per-code spread and distinct_property tables,
  composed as the card kernel composes them) equals the plain sweep
  (`kernels._scan_sweep`, the one scan_plain runs) bit for bit, float32
  bits compared as int32; and from the request's own carry its arg-max,
  score and top-5 equal `_select_scan(k_steps=1)`'s (indices exactly,
  scores within 1e-6).
- The live rows (10 of those seeds): a row that is not feasible or does
  not fit at step 0 is so after every later step, so the card kernel
  sweeps only the other rows after step 0.
- The incremental spread tables (10 seeds of 300 random placements): the
  card kernel's rule for a stanza's bounds after one placement agrees
  with a full scan of the histogram.
- The early stop: `_select_scan` and `_scan_batched_jit` where k_valid <
  k_steps, where the request runs dry part-way (distinct_hosts or
  scan_exclusive with fewer rows than its count) and where step 0 is
  already invalid: every output row after the first invalid one equals
  that row exactly, and select_scan / select_scan_batched on the CPU equal
  the JAX package there.
- The edge shapes (SCAN_EDGES of nomad_tpu_torch/mock/scan_edges.py, the
  one generator the tests and chip_smoke.py share): a tie storm, n not a
  multiple of 1024, one feasible row, none, k_valid 1, a count above 1024
  (2,048 steps), requests that run dry, every stanza and constraint with
  empty histograms, solo and as two lanes over one table; and ten batched
  lanes of counts 16-61 with their own stanzas, the last with no feasible
  row: select_scan and select_scan_batched against the JAX package, ints
  exactly, scores within 1e-6 (the float32 pow of XLA differs from the
  port's float64-rounded one by 1 ulp on some inputs).
tests/test_torch_cuda.py holds the kernels against their plain versions at
the same cases on the card.
"""

import numpy as np
import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.mock import scan_edges as edges
from nomad_tpu_torch.ops import kernels
from test_torch_batched import _torch
from test_torch_select import _same, _torch_args

SEEDS = list(range(20))
N = 200
HISTS = ("random", "empty", "flat")


def _jax_scan(args, **statics):
    return jsel._select_scan(**args, **statics)


def _jax_batched(args, k_steps, spread_alg, s_live, p_live):
    return jsel._scan_batched_jit(k_steps, spread_alg, s_live, p_live)(
        *[args[nm] for nm in jsel._SCAN_ARGS])


def _same_run(jax_out, port_out):
    (jc, jo), (tc, to) = jax_out, port_out
    for i, (a, b) in enumerate(zip(jc, tc)):
        _same(f"carry {i}", a, b)
    for i, (a, b) in enumerate(zip(jo, to)):
        _same(f"out {i}", a, b)


def _premise_case(seed):
    """A seeded request for the cached-terms premise, and its statics."""
    return edges.scan_edge_args(
        N, 30, "random", 7000 + seed, s_live=seed % 5,
        p_live=(3 * seed + 1) % 5, hist=HISTS[seed % 3],
        distinct_hosts=seed % 4 == 2, exclusive=seed % 4 == 3,
        spread_alg=seed % 2 == 1)


def _carry(t, scan_placed):
    return (t["used0"], t["tg_coll0"], t["job_count0"], scan_placed,
            t["free_ports"], t["dev_slots0"], t["sp_counts0"],
            t["sp_present0"], t["dp_counts0"])


def _cached_masked(a, carry, *, spread_alg, s_live, p_live):
    """masked of one scan step as the card's scan kernels compose it
    (select_common.cuh: scan_local_of, scan_tables, scan_compose). Each
    row's record holds its node-local terms: part = ((binpack + anti) +
    pen) + aff, dev, pre, the fired count without the spread's flag,
    node-local feasibility and fit. The spread and distinct_property
    terms are tables over every code, read at the row's codes; a row's
    score is ((part + st) + dev) + pre over the fired count with the
    spread's flag added, st summed over the stanzas from +0.0."""
    loc = kernels._scan_local(a, carry, spread_alg)
    part = loc["binpack"] + loc["anti"] + loc["pen"] + loc["aff"]
    fired_base = (1.0 + loc["anti_fires"].to(torch.float32)
                  + loc["pen_fires"].to(torch.float32)
                  + loc["aff_fires"].to(torch.float32)
                  + (1.0 if a["dev_fires"] > 0 else 0.0)
                  + loc["pre_fires"].to(torch.float32))
    every = torch.arange(carry[6].shape[-1], device=part.device)
    feas = loc["feas"]
    for p in range(p_live):
        table = kernels._dp_admits(a, carry, p, every)
        if table is not None:
            feas = feas & table[a["dp_codes"][p].long()]
    st = torch.zeros_like(part)
    for s in range(s_live):
        table = kernels._spread_term(a, carry, s, every)
        st = st + table[a["sp_codes"][s].long()]
    score = (((part + st) + loc["dev"]) + a["pre_score"]) \
        / (fired_base + (st != 0.0).to(torch.float32))
    return torch.where(feas & loc["fit"], score, kernels.NEG_INF)


@pytest.mark.parametrize("seed", SEEDS)
def test_cached_terms_premise(seed):
    args, st = _premise_case(seed)
    t = _torch_args(args, jsel._SCAN_ARGS)
    rng = np.random.default_rng(seed)
    # a carry part-way through a scan: more usage, some rows placed on
    t["used0"] = t["used0"] + torch.from_numpy(
        (args["capacity"] * rng.uniform(0, 0.3, (N, 1))).astype(np.float32)
        * np.array([1, 1, 0, 0], np.float32))
    placed = torch.from_numpy(rng.integers(0, 2, N).astype(np.int32))
    for scan_placed in (placed, torch.zeros(N, dtype=torch.int32)):
        carry = _carry(t, scan_placed)
        want = kernels._scan_sweep(t, carry, **st)[0]
        got = _cached_masked(t, carry, **st)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool((got > kernels.NEG_INF / 2).any())

    # from the request's own carry: the JAX program's first step
    jargs = dict(args, used0=t["used0"].numpy())
    _jc, jo = _jax_scan(jargs, k_steps=1, **st)
    assert int(jo[0][0]) >= 0
    choice = int(torch.argmax(got))
    assert int(jo[0][0]) == choice
    _same("score", np.asarray(jo[1])[0], got[choice])
    ts, ti = kernels._topk_stable(got, kernels.TOP_K)
    _same("top-5 rows", np.asarray(jo[9])[0], ti)
    _same("top-5 scores", np.asarray(jo[10])[0], ts)


@pytest.mark.parametrize("seed", SEEDS[:10])
def test_dead_rows_stay_dead(seed):
    """The premise of the card kernel's live rows: a row that is not
    feasible or does not fit at step 0 (masked NEG_INF) is so at every
    later step, so the kernel sweeps only the others after step 0. The
    carry after s steps is scan_plain's with k_steps s."""
    args, st = _premise_case(seed)
    t = _torch_args(args, jsel._SCAN_ARGS)
    ok0 = kernels._scan_sweep(t, _carry(t, torch.zeros(N, dtype=torch.int32)),
                              **st)[3]
    died = 0
    for s in range(1, 25):
        carry, outs = kernels.scan_plain(**t, k_steps=s, **st)
        ok = kernels._scan_sweep(t, carry, **st)[3]
        assert not bool((ok & ~ok0).any()), s
        died = max(died, int((ok0 & ~ok).sum()))
        if int(outs[0][-1]) < 0:
            break
    assert died > 0


def test_premise_cases_cover_the_terms():
    """The premise's seeds reach every s_live and p_live, both algorithms,
    each histogram shape, -0.0 components and missing codes."""
    seen = set()
    for seed in SEEDS:
        args, st = _premise_case(seed)
        seen.add(("s_live", st["s_live"]))
        seen.add(("p_live", st["p_live"]))
        seen.add(("spread_alg", st["spread_alg"]))
        seen.add(("hist", HISTS[seed % 3]))
        if np.signbit(args["affinity_norm"][args["affinity_norm"] == 0]).any():
            seen.add("-0.0 affinity")
        if (args["sp_codes"][:st["s_live"]] == edges.C_MAX).any():
            seen.add("missing code")
    assert {("s_live", s) for s in range(5)} <= seen
    assert {("p_live", p) for p in range(5)} <= seen
    assert {("spread_alg", True), ("spread_alg", False)} <= seen
    assert {("hist", h) for h in HISTS} <= seen
    assert {"-0.0 affinity", "missing code"} <= seen


def _bounds(counts, present):
    """A stanza's bounds over its present codes, as a full scan finds
    them: (minimum, present codes at it, maximum, any present)."""
    if not present.any():
        return 1e30, 0, -1e30, False
    mn, mx = counts[present].min(), counts[present].max()
    return mn, int((present & (counts == mn)).sum()), mx, True


@pytest.mark.parametrize("seed", list(range(10)))
def test_incremental_bounds_premise(seed):
    """The premise of the card kernel's incremental spread tables
    (scan_tables): after one placement at code c, the stanza's bounds are
    unchanged exactly where the counting thread's rule says so (present
    codes before, the count not past the maximum, and the code not the
    minimum's only holder nor a new code below it), and then the present
    codes at the minimum change as the rule counts them. Counts as float32
    under random placements, from histograms with no code, one code, ties
    at the minimum and gaps."""
    rng = np.random.default_rng(seed)
    c_axis = edges.C_MAX + 1
    counts = np.zeros(c_axis, np.float32)
    present = np.zeros(c_axis, bool)
    codes = rng.choice(c_axis, rng.integers(0, 8), replace=False)
    counts[codes] = rng.integers(0, 4, len(codes))
    present[codes] = rng.random(len(codes)) < 0.8
    mn, nmin, mx, any_ = _bounds(counts, present)
    kept = 0
    for _ in range(300):
        c = int(rng.choice(codes)) if len(codes) and rng.random() < 0.9 \
            else int(rng.integers(0, c_axis))
        old, was = counts[c], present[c]
        now = np.float32(old + np.float32(1.0))
        counts[c], present[c] = now, True
        full, n = False, nmin
        if not any_ or now > mx:
            full = True
        elif was and old == mn:
            if n > 1:
                n -= 1
            else:
                full = True
        elif not was and now <= mn:
            if now < mn:
                full = True
            else:
                n += 1
        want = _bounds(counts, present)
        if not full:
            kept += 1
            assert (mn, n, mx, any_) == want, (c, old, was)
        mn, nmin, mx, any_ = want
    assert kept > 0


def _first_invalid(choice):
    bad = np.nonzero(np.asarray(choice) < 0)[0]
    assert len(bad), "no invalid step"
    return int(bad[0])


def _repeats_after(outs, j):
    """Every output row after step j equals row j exactly."""
    for i, o in enumerate(outs):
        o = np.asarray(o)
        for r in range(j + 1, o.shape[0]):
            assert np.array_equal(o[r], o[j]), (i, r, j)


# (label, n, count, k_steps, options of scan_edge_args)
STOP_CASES = {
    "k_valid below k_steps": (N, 30, 64, {}),
    "runs dry, distinct_hosts": (N, 40, 64,
                                 dict(feasible_rows=12, distinct_hosts=True)),
    "runs dry, exclusive": (N, 40, 64, dict(feasible_rows=12, exclusive=True)),
    "step 0 invalid": (N, 30, 32, dict(feasible_rows=0)),
}


@pytest.mark.parametrize("label", sorted(STOP_CASES))
def test_early_stop_premise(label):
    n, count, k, opts = STOP_CASES[label]
    args, st = edges.scan_edge_args(n, count, "random", 11, **opts)
    jout = _jax_scan(args, k_steps=k, **st)
    j = _first_invalid(jout[1][0])
    assert j < k - 1
    if label == "step 0 invalid":
        assert j == 0
    elif label.startswith("runs dry"):
        assert j < count
    _repeats_after(jout[1], j)
    _same_run(jout, kernels.select_scan(
        **_torch_args(args, jsel._SCAN_ARGS), k_steps=k, **st))


def test_early_stop_premise_batched():
    lanes = [edges.scan_edge_args(N, count, "random", 20 + i, **opts)
             for i, (_n, count, _k, opts) in enumerate(STOP_CASES.values())]
    for a, _st in lanes[1:]:
        a["capacity"] = lanes[0][0]["capacity"]
    args, st = edges.lanes_batch(lanes)
    k = 64
    jout = _jax_batched(args, k, **st)
    for b in range(len(lanes)):
        j = _first_invalid(np.asarray(jout[1][0])[b])
        _repeats_after([np.asarray(o)[b] for o in jout[1]], j)
    _same_run(jout, kernels.select_scan_batched(**_torch(args), k_steps=k,
                                                **st))


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("label", sorted(edges.SCAN_EDGES))
def test_scan_edge_shapes_match_jax(label, spread_alg):
    args, st = edges.edge_case(label, 31, spread_alg)
    jout = _jax_scan(args, **st)
    _same_run(jout, kernels.select_scan(
        **_torch_args(args, jsel._SCAN_ARGS), **st))
    choice = np.asarray(jout[1][0])
    if label == "none feasible":
        assert (choice == -1).all()
    elif label == "one feasible row":
        assert len(set(choice[choice >= 0].tolist())) == 1
    elif label == "tie storm":
        # ties go to the lowest row; distinct spread codes never split them
        assert (choice >= 0).sum() == 300


@pytest.mark.parametrize("label", sorted(edges.SCAN_EDGES))
def test_scan_edge_shapes_batched_match_jax(label):
    """Each edge case as two lanes over one table (the case, and the same
    shape from another seed)."""
    lanes = [edges.edge_case(label, 31 + i) for i in range(2)]
    lanes[1][0]["capacity"] = lanes[0][0]["capacity"]
    args, st = edges.lanes_batch(lanes)
    k = lanes[0][1]["k_steps"]
    _same_run(_jax_batched(args, k, **st),
              kernels.select_scan_batched(**_torch(args), k_steps=k, **st))


def test_scan_mixed_lanes_match_jax():
    args, st = edges.mixed_lanes(N, 41)
    jout = _jax_batched(args, **st)
    _same_run(jout, kernels.select_scan_batched(**_torch(args), **st))
    choice = np.asarray(jout[1][0])
    assert (choice[-1] == -1).all()
    assert (choice[0] >= 0).sum() == edges.MIXED_LANES[0][0]
