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
"""

import pytest
import torch

import nomad_tpu.ops.select as jsel
from nomad_tpu_torch.mock import kway_edges as edges
from nomad_tpu_torch.ops import kernels
from nomad_tpu_torch.ops import select as tsel
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
