"""Seeded inputs of the K-way placement kernel at the edges of its
top-(W + 1): the one generator the CPU tests and the card's smoke run
share, so both check the same cases under the same names."""

from __future__ import annotations

import numpy as np


def kway_edge_args(n, count, kind, seed, feasible_rows=None):
    """The K-way kernel's arguments (numpy, by `select._CHUNKED_ARGS`
    name) of one request over n rows, seeded.

    kind "random": heterogeneous nodes with every scorer present (ports,
    device slots, penalties, affinities, preemption scores); "alike":
    every node the same (one tie storm); "dry": random nodes with room for
    few instances each, so a later phase finds no feasible row.
    `feasible_rows`, when given, keeps exactly that many rows feasible
    (and passing every other test of a row): 0 makes the first phase
    invalid, w + 1 fills the top-(w + 1) of a kernel of width w
    exactly."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if kind == "alike":
        zeros = np.zeros(n, f32)
        a = dict(capacity=np.tile(np.array([4000., 8192., 102400., 1000.],
                                           f32), (n, 1)),
                 used0=np.zeros((n, 4), f32), feasible=np.ones(n, bool),
                 tg_coll0=np.zeros(n, np.int32), penalty=np.zeros(n, bool),
                 affinity_norm=zeros, free_ports=np.full(n, 400., f32),
                 port_ok=np.ones(n, bool), dev_slots0=np.full(n, 400., f32),
                 dev_score=zeros, pre_score=zeros, dev_fires=0.0)
    else:
        capacity = np.stack(
            [rng.choice([2000., 4000., 8000.], n),
             rng.choice([4096., 8192., 16384.], n),
             np.full(n, 102400.), np.full(n, 1000.)], 1).astype(f32)
        used = (capacity * rng.uniform(0.0, 0.7, (n, 1))).astype(f32)
        used[:, 2:] = 0.0
        if kind == "dry":
            used[:, :2] = capacity[:, :2] - 250.0
        a = dict(
            capacity=capacity, used0=used, feasible=rng.random(n) > 0.05,
            tg_coll0=rng.integers(0, 3, n).astype(np.int32),
            penalty=rng.random(n) < 0.05,
            affinity_norm=np.where(rng.random(n) < 0.2, 0.5, 0.0).astype(f32),
            free_ports=rng.integers(0, 400, n).astype(f32),
            port_ok=rng.random(n) > 0.02,
            dev_slots0=rng.integers(0, 400, n).astype(f32),
            dev_score=np.where(rng.random(n) < 0.3, rng.uniform(0, 1, n),
                               0.0).astype(f32),
            pre_score=np.where(rng.random(n) < 0.05, rng.uniform(0.1, 0.9, n),
                               0.0).astype(f32),
            dev_fires=1.0)
    if feasible_rows is not None:
        rows = rng.choice(n, feasible_rows, replace=False)
        a["feasible"][:] = False
        a["feasible"][rows] = True
        a["port_ok"][rows] = True
        a["free_ports"][rows] = 400.0
        a["dev_slots0"][rows] = 400.0
        a["used0"][rows, :2] = 0.0
    a.update(ask=np.array([100., 128., 10., 0.], f32), k_valid=count,
             desired_count=float(count), port_need=1.0)
    return a


# the arguments with one entry a table row
ROW_ARGS = ("capacity", "used0", "feasible", "tg_coll0", "penalty",
            "affinity_norm", "free_ports", "port_ok", "dev_slots0",
            "dev_score", "pre_score")


def pad_rows(args, n_pad):
    """`args` (kway_edge_args' numpy arguments) over n_pad rows, the rows
    past the request's own zero: infeasible, as `select.pack_request` pads
    a table (a mesh pads its table so each shard holds equal rows)."""
    out = dict(args)
    for k in ROW_ARGS:
        a = args[k]
        pad = np.zeros((n_pad,) + a.shape[1:], a.dtype)
        pad[:a.shape[0]] = a
        out[k] = pad
    return out
