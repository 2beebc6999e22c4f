"""Seeded inputs of the chunked placement kernel at the edges of its kept
candidate list, its step warp and its stream walk: the one generator the
CPU tests, the card tests and the card's smoke run share, so all three
check the same cases under the same names. Built on `kway_edges`, whose
arguments are the chunked kernel's too (`select._CHUNKED_ARGS`)."""

from __future__ import annotations

import numpy as np

from .kway_edges import kway_edge_args, pad_rows

# label: (rows on the CPU, rows on the card, count, kind, feasible rows).
# kind is a kway_edge_args kind, or "room" (one feasible row with room for
# more than CHUNK_J instances: a chunk reaches CHUNK_J), "tie_low" /
# "tie_high" (a runner-up whose score equals the winner's third
# sub-placement's exactly, its row above / below the winner's, so that
# the winner wins / loses the tie there). The table is padded as
# `select.pack_request` pads it (`select._pad_n`), so a request of 3 rows
# is a table of 8.
CHUNKED_EDGES = {
    "all alike, count 512": (200, 10_000, 512, "alike", None),
    "first step invalid": (200, 10_000, 40, "random", 0),
    "runs dry": (200, 400, 512, "dry", None),
    "two feasible rows": (200, 10_000, 40, "random", 2),
    "n below 5": (3, 3, 20, "random", None),
    "chunk reaches CHUNK_J": (200, 10_000, 512, "room", 1),
    "tie, winner row lower": (8, 8, 20, "tie_low", None),
    "tie, winner row higher": (8, 8, 20, "tie_high", None),
}


def _pad_n(n: int) -> int:
    """The table's rows for a request of n (`select._pad_n`)."""
    p = 8
    while p < n:
        p *= 2
    return p


def chunked_edge_args(label, seed, card=False, n_pad=None):
    """The chunked kernel's arguments (numpy, by `select._CHUNKED_ARGS`
    name) of the edge case `label` of CHUNKED_EDGES, seeded, over its CPU
    or (`card`) its card rows, padded as `select.pack_request` pads them
    or, given `n_pad` (a mesh's padding, `pad_for_mesh`), to n_pad rows."""
    n_cpu, n_card, count, kind, keep = CHUNKED_EDGES[label]
    n = n_card if card else n_cpu
    if kind in ("tie_low", "tie_high"):
        a = kway_edge_args(n, count, "alike", seed)
        ask = a["ask"]
        # the winner w at used 0 and coll 0; the runner-up r at two
        # instances more: its score is the winner's with three placed
        # (sub-placement 2), bit for bit; every other row infeasible
        w, r = (0, 1) if kind == "tie_low" else (1, 0)
        a["used0"][r] = 2 * ask
        a["tg_coll0"][r] = 2
        a["free_ports"][r] -= 2
        a["dev_slots0"][r] -= 2
        a["feasible"][2:] = False
        assert a["used0"][w].sum() == 0
    else:
        a = kway_edge_args(n, count, "random" if kind == "room" else kind,
                           seed, feasible_rows=keep)
        if kind == "room":
            row = np.flatnonzero(a["feasible"])[0]
            a["capacity"][row, :2] = 1e6
    return pad_rows(a, _pad_n(n) if n_pad is None else n_pad)


# a batch of 8 lanes: (count, kind, feasible rows); lane 2 runs dry (its
# feasible rows hold one instance each), lane 5 has no feasible row
CHUNKED_LANES = ((10, "random", None), (40, "random", None),
                 (512, "dry", 300), (20, "alike", None), (5, "random", 2),
                 (30, "random", 0), (60, "random", None), (1, "random", None))


def chunked_lanes(n, specs, seed):
    """The batched chunked kernel's arguments (numpy, [B]-led but the one
    capacity table) of len(specs) lanes over n rows, each (count, kind,
    feasible rows, at most n) made by kway_edge_args from its own seed over
    lane 0's capacity: a lane's usage kept as its fraction of that
    capacity, a "dry" lane's room left at 250 below it on every row."""
    lanes = [kway_edge_args(n, count, kind, seed + i,
                            feasible_rows=None if keep is None
                            else min(keep, n))
             for i, (count, kind, keep) in enumerate(specs)]
    cap = lanes[0]["capacity"]
    out = {}
    for i, (a, (_count, kind, _keep)) in enumerate(zip(lanes, specs)):
        frac = a["used0"][:, :2] / a["capacity"][:, :2]
        a["used0"][:, :2] = cap[:, :2] - 250.0 if kind == "dry" \
            else (cap[:, :2] * frac).astype(np.float32)
        a["capacity"] = cap
    for k, v in lanes[0].items():
        if k == "capacity":
            out[k] = cap
        elif k == "k_valid":
            out[k] = np.array([a[k] for a in lanes], np.int32)
        elif isinstance(v, np.ndarray):
            out[k] = np.stack([a[k] for a in lanes])
        else:
            out[k] = np.array([a[k] for a in lanes], np.float32)
    return out


def edge_rows(label, card=False):
    """The rows of edge case `label` before any padding."""
    return CHUNKED_EDGES[label][1 if card else 0]


def one_lane(args):
    """One request's arguments as a batch of one lane: arrays with a lane
    axis (the shared capacity without), k_valid as int32 [1] and the other
    scalars as float32 [1]."""
    out = {}
    for k, v in args.items():
        if k == "capacity":
            out[k] = v
        elif isinstance(v, np.ndarray) and v.ndim >= 1:
            out[k] = v[None]
        else:
            out[k] = np.array([v], np.int32 if k == "k_valid"
                              else np.float32)
    return out


def pad_lanes(args, n_pad):
    """A batch of chunked_lanes' arguments over n_pad rows, each lane's rows
    past the table's own zero: infeasible, as a mesh pads its table so that
    each shard holds equal rows (`pad_rows`, lane by lane)."""
    n = args["capacity"].shape[0]
    out = dict(args)
    for k, a in args.items():
        if k == "capacity":
            pad = np.zeros((n_pad,) + a.shape[1:], a.dtype)
            pad[:n] = a
        elif k != "ask" and isinstance(a, np.ndarray) and a.ndim >= 2:
            pad = np.zeros(a.shape[:1] + (n_pad,) + a.shape[2:], a.dtype)
            pad[:, :n] = a
        else:
            continue
        out[k] = pad
    return out
