"""Seeded inputs of the scan placement kernel (one instance a step, with
spread stanzas, distinct_property limits, distinct_hosts and reserved
ports) at the edges of its cached terms and of its stop at the first
invalid step: the one generator the CPU tests and the card's smoke run
share, so both check the same cases under the same names."""

from __future__ import annotations

import numpy as np

S_MAX = 4      # spread stanzas the kernel takes
P_MAX = 4      # distinct_property constraints it takes
C_MAX = 64     # the code of a row missing the attribute
CODES = 6      # attribute values in use per stanza or constraint


def _bucket_k(k: int) -> int:
    """The scan's step budget for a count (`select._bucket_k`)."""
    if k <= 1024:
        b = 1
        while b < k:
            b *= 2
        return b
    return min(-(-k // 1024) * 1024, 65536)


def scan_edge_args(n, count, kind, seed, s_live=2, p_live=1,
                   feasible_rows=None, hist="random", distinct_hosts=False,
                   exclusive=False, spread_alg=False):
    """The scan kernel's arguments (numpy, by `select._SCAN_ARGS` name,
    scalars as `select.pack_request` gives them) and its statics
    (spread_alg, s_live, p_live) for one request over n rows, seeded.

    kind "random": heterogeneous nodes with every scorer present (ports,
    device slots, penalties, affinities and preemption scores, some of
    them -0.0), s_live spread stanzas (targeted and even ones, a stanza
    weight of -0.0, rows missing the attribute) and p_live distinct
    properties; "alike": every node the same, one code a stanza (one tie
    storm). `hist` shapes the spread histograms: "random" counts, "empty"
    (no code present), or "flat" (every present code at one count: min ==
    max). `feasible_rows`, when given, keeps exactly that many rows
    feasible (and passing every other node-local test, no
    distinct_property limit binding): 0 makes step 0 invalid.
    `distinct_hosts` and `exclusive` set the request's flags, so that a
    request with fewer such rows than its count runs dry."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c_axis = C_MAX + 1
    if kind == "alike":
        zeros = np.zeros(n, f32)
        a = dict(capacity=np.tile(np.array([4000., 8192., 102400., 1000.],
                                           f32), (n, 1)),
                 used0=np.zeros((n, 4), f32), feasible=np.ones(n, bool),
                 tg_coll0=np.zeros(n, np.int32),
                 job_count0=np.zeros(n, np.int32),
                 penalty=np.zeros(n, bool), affinity_norm=zeros,
                 free_ports=np.full(n, 400., f32), port_ok=np.ones(n, bool),
                 dev_slots0=np.full(n, 400., f32), dev_score=zeros,
                 pre_score=zeros, dev_fires=f32(0.0))
        codes = np.zeros((S_MAX, n), np.int32)
        dcodes = np.zeros((P_MAX, n), np.int32)
    else:
        capacity = np.stack(
            [rng.choice([2000., 4000., 8000.], n),
             rng.choice([4096., 8192., 16384.], n),
             np.full(n, 102400.), np.full(n, 1000.)], 1).astype(f32)
        used = (capacity * rng.uniform(0.0, 0.7, (n, 1))).astype(f32)
        used[:, 2:] = 0.0

        def signed_zeros(v, frac=0.1):
            v = v.astype(f32)
            v[(v == 0) & (rng.random(n) < frac)] = f32(-0.0)
            return v
        a = dict(
            capacity=capacity, used0=used, feasible=rng.random(n) > 0.05,
            tg_coll0=rng.integers(0, 3, n).astype(np.int32),
            job_count0=rng.integers(0, 2, n).astype(np.int32),
            penalty=rng.random(n) < 0.05,
            affinity_norm=signed_zeros(np.where(
                rng.random(n) < 0.2, rng.choice([0.5, -0.5], n), 0.0)),
            free_ports=rng.integers(0, 40, n).astype(f32),
            port_ok=rng.random(n) > 0.02,
            dev_slots0=rng.integers(0, 40, n).astype(f32),
            dev_score=signed_zeros(np.where(rng.random(n) < 0.3,
                                            rng.uniform(0, 1, n), 0.0)),
            pre_score=signed_zeros(np.where(rng.random(n) < 0.05,
                                            rng.uniform(0.1, 0.9, n), 0.0)),
            dev_fires=f32(1.0))
        codes = rng.integers(0, CODES, (S_MAX, n)).astype(np.int32)
        codes[rng.random((S_MAX, n)) < 0.05] = C_MAX
        dcodes = rng.integers(0, CODES, (P_MAX, n)).astype(np.int32)
        dcodes[rng.random((P_MAX, n)) < 0.03] = C_MAX
    if feasible_rows is not None:
        rows = rng.choice(n, feasible_rows, replace=False)
        a["feasible"][:] = False
        a["feasible"][rows] = True
        a["port_ok"][rows] = True
        a["free_ports"][rows] = 400.0
        a["dev_slots0"][rows] = 400.0
        a["used0"][rows, :2] = 0.0
        a["job_count0"][rows] = 0
        dcodes[:, rows] %= CODES    # none missing a distinct property

    sp_counts = np.zeros((S_MAX, c_axis), f32)
    sp_desired = np.full((S_MAX, c_axis), -1.0, f32)
    sp_weight = np.zeros(S_MAX, f32)
    sp_has_targets = np.zeros(S_MAX, bool)
    sp_valid = np.zeros(S_MAX, bool)
    for s in range(s_live):
        if hist == "random":
            sp_counts[s, :CODES] = rng.integers(0, 4, CODES)
        elif hist == "flat":
            sp_counts[s, :CODES] = np.where(rng.random(CODES) < 0.6, 2, 0)
        sp_has_targets[s] = s % 2 == 0
        if sp_has_targets[s]:
            for c in range(CODES):
                if rng.random() < 0.6:
                    sp_desired[s, c] = float(rng.integers(1, count + 2))
        sp_weight[s] = float(rng.integers(10, 100))
        sp_valid[s] = True
    if s_live > 1 and kind != "alike":
        sp_weight[1] = f32(-0.0)
    # rows of stanzas past s_live carry the missing code, as pack_request
    # pads them
    codes[s_live:] = C_MAX
    dp_counts = np.zeros((P_MAX, c_axis), f32)
    dp_limit = np.zeros(P_MAX, f32)
    dp_valid = np.zeros(P_MAX, bool)
    for p in range(p_live):
        dp_counts[p, :CODES] = rng.integers(0, 3, CODES)
        # limits that let a good part of the count place before they bind;
        # none binds on a tie storm or on the rows feasible_rows keeps
        dp_limit[p] = float(count + 10) if kind == "alike" \
            or feasible_rows is not None \
            else float(rng.integers(2 + count // 8, 4 + count // 3))
        dp_valid[p] = True
    dcodes[p_live:] = C_MAX
    a.update(
        ask=np.array([100., 128., 10., 0.], f32), k_valid=np.int32(count),
        distinct_hosts_flag=f32(1.0 if distinct_hosts else 0.0),
        scan_exclusive=f32(1.0 if exclusive else 0.0),
        desired_count=f32(count), port_need=f32(1.0), sp_codes=codes,
        sp_counts0=sp_counts, sp_present0=sp_counts > 0,
        sp_desired=sp_desired, sp_weight=sp_weight,
        sp_has_targets=sp_has_targets, sp_valid=sp_valid,
        sum_spread_w=f32(max(float(sp_weight.sum()), 0.0)),
        dp_codes=dcodes, dp_counts0=dp_counts, dp_limit=dp_limit,
        dp_valid=dp_valid)
    return a, dict(spread_alg=spread_alg, s_live=s_live, p_live=p_live)


# The scan kernel's edge shapes, as label: (n, count, k_steps, kind,
# options of scan_edge_args); k_steps None is the count's bucket.
SCAN_EDGES = {
    "tie storm": (1_500, 300, None, "alike", dict(s_live=2, p_live=1)),
    "n not a multiple of 1024": (1_000, 100, None, "random", {}),
    "one feasible row": (2_000, 20, None, "random",
                         dict(feasible_rows=1)),
    "none feasible": (2_000, 20, None, "random", dict(feasible_rows=0)),
    "k_valid 1": (2_000, 1, 16, "random", {}),
    "count above 1024": (1_200, 1_100, None, "random",
                         dict(s_live=1, p_live=0)),
    "runs dry, distinct_hosts": (2_000, 80, None, "random",
                                 dict(feasible_rows=50,
                                      distinct_hosts=True)),
    "runs dry, exclusive": (2_000, 80, None, "random",
                            dict(feasible_rows=50, exclusive=True,
                                 hist="flat")),
    "every stanza, empty histograms": (1_000, 40, None, "random",
                                       dict(s_live=4, p_live=4,
                                            hist="empty")),
    # more live rows than the card kernel's records in shared memory hold
    "16,384 rows all live": (16_384, 200, None, "random",
                             dict(feasible_rows=16_384)),
}


def edge_case(label, seed, spread_alg=False):
    """(arguments, statics with k_steps) of SCAN_EDGES[label]."""
    n, count, k_steps, kind, opts = SCAN_EDGES[label]
    args, statics = scan_edge_args(n, count, kind, seed,
                                   spread_alg=spread_alg, **opts)
    statics["k_steps"] = k_steps or _bucket_k(count)
    return args, statics


# the arguments with a node axis: first (ROW_ARGS) or last (CODE_ARGS)
ROW_ARGS = ("capacity", "used0", "feasible", "tg_coll0", "job_count0",
            "penalty", "affinity_norm", "free_ports", "port_ok",
            "dev_slots0", "dev_score", "pre_score")
CODE_ARGS = ("sp_codes", "dp_codes")


def pad_rows(args, n_pad):
    """`args` (scan_edge_args' numpy arguments of one request) over n_pad
    rows, as `select.pack_request` pads a table (a mesh pads its table so
    each shard holds equal rows): the rows past the request's own zero,
    so infeasible, with every code the missing one."""
    out = dict(args)
    for k in ROW_ARGS:
        a = args[k]
        pad = np.zeros((n_pad,) + a.shape[1:], a.dtype)
        pad[:a.shape[0]] = a
        out[k] = pad
    for k in CODE_ARGS:
        a = args[k]
        pad = np.full(a.shape[:-1] + (n_pad,), C_MAX, a.dtype)
        pad[..., :a.shape[-1]] = a
        out[k] = pad
    return out


# Batched lanes of mixed counts (16-61) over one table, each with its own
# stanzas and constraints, the last with no feasible row: (count, s_live,
# p_live, feasible_rows) a lane.
MIXED_LANES = tuple((16 + 5 * i, i % 3, i % 2, None) for i in range(9)) \
    + ((61, 2, 1, 0),)


def lanes_batch(lanes):
    """One batched call's arguments from solo ones (scan_edge_args' output
    of one n each): capacity from lane 0, shared; every other array
    stacked on a lane axis, and the scalars as [B] arrays (k_valid int32,
    the others float32); statics the batch's largest s_live and p_live and
    lane 0's spread_alg."""
    args = [a for a, _ in lanes]
    out = {}
    for k in args[0]:
        if k == "capacity":
            out[k] = args[0][k]
        elif k == "k_valid":
            out[k] = np.array([a[k] for a in args], np.int32)
        elif isinstance(args[0][k], np.ndarray) and args[0][k].ndim:
            out[k] = np.stack([a[k] for a in args])
        else:
            out[k] = np.array([a[k] for a in args], np.float32)
    statics = dict(spread_alg=lanes[0][1]["spread_alg"],
                   s_live=max(st["s_live"] for _, st in lanes),
                   p_live=max(st["p_live"] for _, st in lanes))
    return out, statics


# a lane that runs dry: distinct_hosts over fewer feasible rows than its
# count, (count, s_live, p_live, feasible_rows) as a MIXED_LANES entry
DRY_LANE = (80, 1, 0, 50)


def mixed_lanes(n, seed, spread_alg=False, dry=False, n_pad=None):
    """(batched arguments, statics with k_steps) of MIXED_LANES over n
    rows, lane i from seed + i; with `dry`, DRY_LANE as one more lane;
    with n_pad, each table padded to n_pad rows (pad_rows)."""
    specs = MIXED_LANES + ((DRY_LANE,) if dry else ())
    lanes = [scan_edge_args(n, count, "random", seed + i, s_live=s,
                            p_live=p, feasible_rows=keep,
                            distinct_hosts=(count, s, p, keep) == DRY_LANE,
                            spread_alg=spread_alg)
             for i, (count, s, p, keep) in enumerate(specs)]
    if n_pad is not None:
        lanes = [(pad_rows(a, n_pad), st) for a, st in lanes]
    args, statics = lanes_batch(lanes)
    statics["k_steps"] = _bucket_k(max(c for c, _, _, _ in specs))
    return args, statics
