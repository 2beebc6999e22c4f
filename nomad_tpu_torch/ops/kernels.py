"""The kernels of the main path: wrappers, plain versions, launch counters,
and the build of the CUDA sources.

Each kernel replaces one jax.jit device program of the JAX package and is
written by hand in CUDA C++ for Hopper:

  select_chunked  <- _select_chunked_fn  (ops/select.py; node-local scoring,
                                          count <= 512)
  select_kway     <- _kway_core          (ops/select.py; count > 512)
  select_scan     <- _select_scan_fn     (ops/select.py; spread / distinct /
                                          reserved ports)
  select_chunked_batched <- _chunked_batched_jit  (ops/select.py; B lanes
  select_kway_batched    <- _select_kway_batched   over one capacity table,
  select_scan_batched    <- _scan_batched_jit      one block a lane)
      in csrc/select_kernels.cu;
  scatter_set     <- _scatter_set        (ops/device_table.py; the resident
                                          table's alloc-delta rows)
  overlay_add     <- _overlay_add        (ops/device_table.py; a dispatch's
                                          used0 = resident used + plan overlay)
  feas_scatter    <- _feas_scatter       (ops/device_table.py; row patches and
                                          residue of a parked feasibility mask)
      in csrc/table_kernels.cu;
  select_scan_sharded <- _select_scan    over a `nodes` mesh (parallel/
  select_kway_sharded <- _select_kway      sharded.py; the node axis split
                                           into S shards, one block a
                                           shard, one launch)
  select_chunked_batched_sharded <- _chunked_batched_jit  over the mesh
  select_kway_batched_sharded    <- _select_kway_batched  (select_many on
  select_scan_batched_sharded    <- _scan_batched_jit     a mesh: B lanes
                                           of S shards, B * S blocks)
      in csrc/sharded_kernels.cu: the scan and the batched chunked kernel
      as scan_batched_cluster_kernel / chunked_batched_cluster_kernel (a
      lane one thread-block cluster) up to a shard count the library fixes
      (scan_sharded_info, chunked_sharded_info), past it as
      scan_batched_sharded_kernel / chunked_batched_sharded_kernel (one
      cooperative launch), the K-way cooperative at every S.
      The __device__ pieces the placement kernels share are in
      csrc/select_common.cuh.

A wrapper takes the same arguments as its plain PyTorch version. On CPU
tensors it runs the plain version (the tests' path); on CUDA tensors it
launches its kernel or raises — there is no fallback. `LAUNCHES` counts
kernel launches, one per launch and nowhere else.

The kernels are compiled from the repo's sources at first launch with
nvcc into `nomad_tpu_torch/_build/` (keyed by the hash of every source)
and bound with ctypes; importing this module needs no CUDA toolchain.

Boolean node columns (`feasible`, `penalty`, `port_ok`, the spread /
distinct-property flags, the parked feasibility masks) are passed to the
kernels as uint8 views of the bool tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..utils.locks import make_lock

S_MAX = 4       # max spread stanzas per task group
P_MAX = 4       # max distinct_property constraints
C_MAX = 64      # max distinct attribute values per spread/property axis
NEG_INF = -1e30
TOP_K = 5       # ScoreMetaData entries kept (reference kheap topK)
CHUNK_J = 256   # max instances placed on one node per chunked step
W_MAX = 128     # widest K-way phase the kernel takes
D_MAX = 8       # widest resource vector the kernels take
CHUNK_PRE_ROWS = 256   # rows a block of the chunked kernels' step-0 sweep
                       # (select_kernels.cu PRE_NT)

LAUNCHES: Dict[str, int] = {"chunked": 0, "kway": 0, "scan": 0,
                            "chunked_batched": 0, "kway_batched": 0,
                            "scan_batched": 0, "scatter_set": 0,
                            "overlay_add": 0, "feas_scatter": 0,
                            "scan_sharded": 0, "kway_sharded": 0,
                            "chunked_batched_sharded": 0,
                            "kway_batched_sharded": 0,
                            "scan_batched_sharded": 0, "scan_cluster": 0,
                            "scan_batched_cluster": 0,
                            "chunked_batched_cluster": 0}

# argument names, in order, of the node-local kernels (chunked, K-way) and
# of the scan; _LOCAL_INPUTS are _local_inputs' arguments, in its order
LOCAL_NAMES = ("capacity", "used0", "feasible", "ask", "k_valid", "tg_coll0",
               "penalty", "affinity_norm", "desired_count", "port_need",
               "free_ports", "port_ok", "dev_slots0", "dev_score",
               "dev_fires", "pre_score")
SCAN_NAMES = (
    "capacity", "used0", "feasible", "ask", "k_valid",
    "tg_coll0", "job_count0", "distinct_hosts_flag", "scan_exclusive",
    "penalty", "affinity_norm", "desired_count",
    "port_need", "free_ports", "port_ok",
    "dev_slots0", "dev_score", "dev_fires", "pre_score",
    "sp_codes", "sp_counts0", "sp_present0", "sp_desired",
    "sp_weight", "sp_has_targets", "sp_valid", "sum_spread_w",
    "dp_codes", "dp_counts0", "dp_limit", "dp_valid")
_LOCAL_INPUTS = ("capacity", "used0", "feasible", "ask", "tg_coll0",
                 "penalty", "affinity_norm", "free_ports", "port_ok",
                 "dev_slots0", "dev_score", "pre_score")
# the float scalars of one request, [B] arrays in a batched call
_LANE_FLOATS = ("desired_count", "port_need", "dev_fires",
                "distinct_hosts_flag", "scan_exclusive", "sum_spread_w")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- shared plain pieces ---------------------------------------------------

def _pow10(x: torch.Tensor) -> torch.Tensor:
    """10**x rounded from float64, as the kernels compute it."""
    return torch.pow(10.0, x.double()).float()


def _topk_stable(v: torch.Tensor, k: int):
    """lax.top_k order: value descending, lower index first among ties
    (torch.topk makes no such promise)."""
    vals, idx = torch.sort(v, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def _local_final_score(after, cap_cpu, cap_mem, coll, penalty, affinity,
                       desired_count, spread_alg, dev_score, dev_fires,
                       pre_score):
    """Node-local score, term for term as the JAX package's
    `_local_final_score` (binpack/spread fit + anti-affinity + penalty +
    affinity + devices + preemption, mean over fired scorers)."""
    free_cpu = 1.0 - after[..., 0] / cap_cpu
    free_mem = 1.0 - after[..., 1] / cap_mem
    total = _pow10(free_cpu) + _pow10(free_mem)
    if spread_alg:
        fit_score = torch.clamp(total - 2.0, 0.0, 18.0)
    else:
        fit_score = torch.clamp(20.0 - total, 0.0, 18.0)
    binpack = _div(fit_score, 18.0)
    collf = coll.to(torch.float32)
    anti_fires = collf > 0
    anti = torch.where(anti_fires,
                       _div(-(collf + 1.0), max(desired_count, 1.0)), 0.0)
    pen = torch.where(penalty, -1.0, 0.0)
    aff_fires = affinity != 0.0
    dev = dev_score if dev_fires > 0 else torch.zeros_like(dev_score)
    pre_fires = pre_score != 0.0
    fired = (1.0 + anti_fires.to(torch.float32)
             + penalty.to(torch.float32)
             + aff_fires.to(torch.float32)
             + (1.0 if dev_fires > 0 else 0.0)
             + pre_fires.to(torch.float32))
    return (binpack + anti + pen + affinity + dev + pre_score) / fired


def _topk_shards(v: torch.Tensor, k: int, shards: int):
    """_topk_stable(v, k) as the node-sharded kernels compute it: each of
    `shards` equal slices of v takes its own top-k (value descending, lower
    row first), and the S sorted lists merge under the same order into the
    first k of their union."""
    if shards == 1:
        return _topk_stable(v, k)
    per = v.shape[0] // shards
    kk = min(k, per)
    lv, li = torch.sort(v.view(shards, per), dim=1, descending=True,
                        stable=True)
    base = torch.arange(0, shards * per, per, device=v.device)
    cv = lv[:, :kk].reshape(-1)
    ci = (li[:, :kk] + base[:, None]).reshape(-1)
    order = torch.argsort(ci)        # rows are distinct: ascending row
    cv, ci = cv[order], ci[order]
    vals, pos = torch.sort(cv, descending=True, stable=True)
    return vals[:k], ci[pos[:k]].to(torch.int32)


def _argmax_shards(v: torch.Tensor, shards: int) -> int:
    """argmax(v), lowest row among ties, as the node-sharded scan finds it:
    each slice's own arg-max, then the best of the S candidates (a later
    slice's rows are higher, so the first best candidate wins a tie)."""
    if shards == 1:
        return int(torch.argmax(v))
    per = v.shape[0] // shards
    li = torch.argmax(v.view(shards, per), dim=1)
    lv = v.view(shards, per).gather(1, li[:, None])[:, 0]
    s = int(torch.argmax(lv))
    return s * per + int(li[s])


def _meta(masked, feas, fit_dims, ok, shards: int = 1):
    """Top-k score meta + first-failing-dimension counts + ok count; with
    `shards`, each slice's counts summed and their top-k lists merged, as
    the node-sharded kernels reduce them."""
    n = masked.shape[0]
    ts, ti = _topk_shards(masked, TOP_K, shards)
    prefix_ok = torch.cumprod(fit_dims.to(torch.int32), dim=1)
    earlier_ok = torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=masked.device),
         prefix_ok[:, :-1].bool()], dim=1)
    first_fail = feas[:, None] & earlier_ok & ~fit_dims
    exh = first_fail.view(shards, n // shards, -1).sum(dim=1).sum(dim=0)
    return (ti, ts, exh.to(torch.int32),
            int(ok.view(shards, -1).sum(dim=1).sum()))


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b in IEEE float32 division. On CUDA, PyTorch divides by a
    host scalar as a multiplication by its reciprocal, which can differ
    by 1 ulp; a divisor tensor on a's device keeps true division, as the
    kernels and the JAX programs compute it."""
    return a / torch.as_tensor(b, dtype=torch.float32, device=a.device)


def _leading_true(wins: torch.Tensor) -> torch.Tensor:
    """Length of the leading run of True along the last axis."""
    return torch.cumprod(wins.to(torch.int32), dim=-1).sum(dim=-1)


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _local_sweep(capacity, used, feasible, ask, coll, penalty,
                 affinity_norm, desired_count, port_need, free_p, port_ok,
                 dev_slots, dev_score, dev_fires, pre_score, spread_alg):
    """One sweep of the node-local kernels over every row, from the carries
    (used, coll, free_p, dev_slots): (masked, feas, fit_dims, ok), masked
    the score where a row is feasible and fits and NEG_INF elsewhere. Row
    x's masked value reads only row x of the carries and the inputs."""
    feas = feasible.bool() & (free_p >= port_need) & port_ok.bool() & \
        (dev_slots >= 1.0)
    after = used + ask[None, :]
    fit_dims = after <= capacity + 1e-6
    ok = feas & fit_dims.all(dim=1)
    final = _local_final_score(
        after, torch.clamp(capacity[:, 0], min=1e-9),
        torch.clamp(capacity[:, 1], min=1e-9), coll, penalty.bool(),
        affinity_norm, desired_count, spread_alg, dev_score, dev_fires,
        pre_score)
    return torch.where(ok, final, NEG_INF), feas, fit_dims, ok


# -- chunked ---------------------------------------------------------------

def chunked_plain(capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
                  affinity_norm, desired_count, port_need, free_ports,
                  port_ok, dev_slots0, dev_score, dev_fires, pre_score, *,
                  max_steps: int, spread_alg: bool, shards: int = 1):
    """Plain version of the chunked greedy kernel: a step loop of tensor
    ops mirroring the JAX `_select_chunked_fn`. With `shards` the node axis
    is split as the node-sharded kernels split it: the winner and the
    runner-up are the first two of the shards' merged top-2 lists."""
    dev = capacity.device
    n, d = capacity.shape
    feasible, penalty, port_ok = feasible.bool(), penalty.bool(), \
        port_ok.bool()
    cap_cpu = torch.clamp(capacity[:, 0], min=1e-9)
    cap_mem = torch.clamp(capacity[:, 1], min=1e-9)
    arange_j = torch.arange(CHUNK_J, dtype=torch.float32, device=dev)
    used = used0.clone()
    coll = tg_coll0.clone()
    free_p = free_ports.clone()
    dev_slots = dev_slots0.clone()
    out_choice = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)
    out_chunk = torch.zeros(max_steps, dtype=torch.int32, device=dev)
    out_ti = torch.full((max_steps, TOP_K), -1, dtype=torch.int32,
                        device=dev)
    out_ts = torch.full((max_steps, TOP_K), NEG_INF, dtype=torch.float32,
                        device=dev)
    out_exh = torch.zeros((max_steps, d), dtype=torch.int32, device=dev)
    out_feas = torch.zeros(max_steps, dtype=torch.int32, device=dev)
    big = _f32(1e9, dev)
    remaining, step, alive = int(k_valid), 0, True
    while remaining > 0 and alive and step < max_steps:
        masked, feas, fit_dims, ok = _local_sweep(
            capacity, used, feasible, ask, coll, penalty, affinity_norm,
            desired_count, port_need, free_p, port_ok, dev_slots, dev_score,
            dev_fires, pre_score, spread_alg)
        if shards == 1:
            choice = int(torch.argmax(masked))
            masked2 = masked.clone()
            masked2[choice] = NEG_INF
            runner_idx = int(torch.argmax(masked2))
            runner_val = masked2[runner_idx]
        else:
            tv, ti2 = _topk_shards(masked, 2, shards)
            choice, runner_idx = int(ti2[0]), int(ti2[1])
            runner_val = tv[1]
        valid = bool(masked[choice] > NEG_INF / 2)
        if step == 0 or not valid:
            ti, ts, exh, feas_count = _meta(masked, feas, fit_dims, ok,
                                            shards)
        else:
            ti = torch.full((TOP_K,), -1, dtype=torch.int32, device=dev)
            ts = torch.full((TOP_K,), NEG_INF, device=dev)
            exh = torch.full((d,), -1, dtype=torch.int32, device=dev)
            feas_count = -1

        free_dims = capacity[choice] - used[choice]
        per_dim = torch.where(ask > 0, torch.floor((free_dims + 1e-6) / ask),
                              big)
        m_fit = per_dim.min()
        m_port = torch.floor(_div(free_p[choice], port_need)) \
            if port_need > 0 \
            else big
        a_max = torch.minimum(
            torch.minimum(torch.minimum(m_fit, m_port), dev_slots[choice]),
            _f32(remaining, dev))

        after_j = used[choice][None, :] + (arange_j[:, None] + 1.0) * ask
        coll_j = coll[choice].to(torch.float32) + arange_j
        final_j = _local_final_score(
            after_j, cap_cpu[choice], cap_mem[choice], coll_j,
            penalty[choice], affinity_norm[choice], desired_count,
            spread_alg, dev_score[choice], dev_fires, pre_score[choice])
        wins = (final_j > runner_val) | \
            ((final_j == runner_val) & (choice < runner_idx))
        chunk = torch.minimum(
            torch.clamp(_leading_true(wins).to(torch.float32), min=1.0),
            a_max)
        if not valid:
            chunk = torch.zeros_like(chunk)
        chunk_i = int(chunk)
        idx = torch.tensor([choice], device=dev)
        used.index_add_(0, idx, (chunk * ask)[None, :])
        coll.index_add_(0, idx, torch.tensor([chunk_i], dtype=coll.dtype,
                                             device=dev))
        free_p.index_add_(0, idx, (-chunk * port_need).reshape(1))
        dev_slots.index_add_(0, idx, (-chunk).reshape(1))

        out_choice[step] = choice if valid else -1
        out_chunk[step] = chunk_i
        out_ti[step] = ti
        out_ts[step] = ts
        out_exh[step] = exh
        out_feas[step] = feas_count
        remaining -= chunk_i
        step += 1
        alive = valid
    return ((used, coll, free_p, dev_slots),
            (out_choice, out_chunk, out_ti, out_ts, out_exh, out_feas,
             torch.tensor(remaining, dtype=torch.int32),
             torch.tensor(step, dtype=torch.int32)))


# -- K-way -----------------------------------------------------------------

def kway_plain(capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
               affinity_norm, desired_count, port_need, free_ports, port_ok,
               dev_slots0, dev_score, dev_fires, pre_score, *,
               max_steps: int, spread_alg: bool, w: int, shards: int = 1):
    """Plain version of the K-way waterline kernel, mirroring the JAX
    `_kway_core`, including its packed int output layout. With `shards`
    the node axis is split as kway_sharded_plain says."""
    dev = capacity.device
    n, d = capacity.shape
    feasible, penalty, port_ok = feasible.bool(), penalty.bool(), \
        port_ok.bool()
    cap_cpu = torch.clamp(capacity[:, 0], min=1e-9)
    cap_mem = torch.clamp(capacity[:, 1], min=1e-9)
    arange_j = torch.arange(CHUNK_J, dtype=torch.float32, device=dev)
    used = used0.clone()
    coll = tg_coll0.clone()
    free_p = free_ports.clone()
    dev_slots = dev_slots0.clone()
    out_widx = torch.full((max_steps, w), -1, dtype=torch.int32, device=dev)
    out_chunk = torch.zeros((max_steps, w), dtype=torch.int32, device=dev)
    out_ti = torch.full((max_steps, TOP_K), -1, dtype=torch.int32,
                        device=dev)
    out_ts = torch.full((max_steps, TOP_K), NEG_INF, dtype=torch.float32,
                        device=dev)
    out_exh = torch.zeros((max_steps, d), dtype=torch.int32, device=dev)
    out_feas = torch.zeros(max_steps, dtype=torch.int32, device=dev)
    big = _f32(1e9, dev)
    remaining, step, alive = int(k_valid), 0, True
    while remaining > 0 and alive and step < max_steps:
        masked, feas, fit_dims, ok = _local_sweep(
            capacity, used, feasible, ask, coll, penalty, affinity_norm,
            desired_count, port_need, free_p, port_ok, dev_slots, dev_score,
            dev_fires, pre_score, spread_alg)
        tv, ti_all = _topk_shards(masked, w + 1, shards)
        widx = ti_all[:w].long()
        wl_val, wl_idx = tv[w], int(ti_all[w])
        wvalid = tv[:w] > NEG_INF / 2
        valid = bool(wvalid[0])
        if step == 0 or not valid:
            ti, ts, exh, feas_count = _meta(masked, feas, fit_dims, ok,
                                            shards)
        else:
            ti = torch.full((TOP_K,), -1, dtype=torch.int32, device=dev)
            ts = torch.full((TOP_K,), NEG_INF, device=dev)
            exh = torch.full((d,), -1, dtype=torch.int32, device=dev)
            feas_count = -1

        free_dims = capacity[widx] - used[widx]
        per_dim = torch.where(ask[None, :] > 0,
                              torch.floor((free_dims + 1e-6) / ask[None, :]),
                              big)
        m_fit = per_dim.min(dim=1).values
        m_port = torch.floor(_div(free_p[widx], port_need)) \
            if port_need > 0 \
            else big.expand(w)
        a_max = torch.minimum(torch.minimum(m_fit, m_port), dev_slots[widx])
        a_max = torch.minimum(a_max, _f32(CHUNK_J, dev))

        after_j = used[widx][:, None, :] \
            + (arange_j[None, :, None] + 1.0) * ask[None, None, :]
        coll_j = coll[widx].to(torch.float32)[:, None] + arange_j[None, :]
        final_j = _local_final_score(
            after_j, cap_cpu[widx][:, None], cap_mem[widx][:, None], coll_j,
            penalty[widx][:, None], affinity_norm[widx][:, None],
            desired_count, spread_alg, dev_score[widx][:, None], dev_fires,
            pre_score[widx][:, None])
        wins = (final_j > wl_val) | \
            ((final_j == wl_val) & (widx[:, None] < wl_idx))
        chunk = torch.minimum(
            torch.clamp(_leading_true(wins).to(torch.float32), min=1.0),
            a_max)
        chunk = torch.where(wvalid, chunk, 0.0)

        total = chunk.sum()
        runner_val, runner_idx = tv[1], int(ti_all[1])
        wins0 = (final_j[0] > runner_val) | \
            ((final_j[0] == runner_val) & (widx[0] < runner_idx))
        chunk0 = torch.minimum(
            torch.clamp(_leading_true(wins0).to(torch.float32), min=1.0),
            a_max[0])
        if bool(total > float(remaining)):
            first_only = torch.zeros_like(chunk)
            first_only[0] = torch.minimum(chunk0, _f32(remaining, dev))
            chunk = first_only
        if not valid:
            chunk = torch.zeros_like(chunk)
        chunk_i = chunk.to(torch.int32)

        # winner rows are distinct; index_add_ keeps accumulate semantics
        used.index_add_(0, widx, chunk[:, None] * ask[None, :])
        coll.index_add_(0, widx, chunk_i.to(coll.dtype))
        free_p.index_add_(0, widx, -chunk * port_need)
        dev_slots.index_add_(0, widx, -chunk)

        out_widx[step] = torch.where(chunk_i > 0, widx.to(torch.int32), -1)
        out_chunk[step] = chunk_i
        out_ti[step] = ti
        out_ts[step] = ts
        out_exh[step] = exh
        out_feas[step] = feas_count
        remaining -= int(chunk_i.sum())
        step += 1
        alive = valid
    packed_i = torch.cat(
        [out_widx, out_chunk, out_ti, out_exh, out_feas[:, None],
         torch.full((max_steps, 1), remaining, dtype=torch.int32,
                    device=dev),
         torch.full((max_steps, 1), step, dtype=torch.int32, device=dev)],
        dim=1)
    return (used, coll, free_p, dev_slots), (packed_i, out_ts)


# -- scan ------------------------------------------------------------------
# The scan's carry, in order: used, tg_coll, job_cnt, scan_placed, free_p,
# dev_slots, sp_counts, sp_present, dp_counts.

def _scan_local(a: Dict, carry, spread_alg: bool) -> Dict:
    """The node-local terms of one scan step over every row (the JAX
    `_select_scan_fn`'s step, select.py:202-253), from the carry and the
    scan's arguments by name (SCAN_NAMES): node-local feasibility, the fit
    per dimension and in all, the score components and the scorers'
    flags."""
    used, tg_coll, job_cnt, scan_placed, free_p, dev_slots = carry[:6]
    capacity, ask = a["capacity"], a["ask"]
    feas = a["feasible"].bool().clone()
    if a["distinct_hosts_flag"] > 0:
        feas &= job_cnt == 0
    if a["scan_exclusive"] > 0:
        feas &= scan_placed == 0
    feas &= free_p >= a["port_need"]
    feas &= a["port_ok"].bool()
    feas &= dev_slots >= 1.0
    after = used + ask[None, :]
    fit_dims = after <= capacity + 1e-6
    free_cpu = 1.0 - after[:, 0] / torch.clamp(capacity[:, 0], min=1e-9)
    free_mem = 1.0 - after[:, 1] / torch.clamp(capacity[:, 1], min=1e-9)
    total = _pow10(free_cpu) + _pow10(free_mem)
    if spread_alg:
        fit_score = torch.clamp(total - 2.0, 0.0, 18.0)
    else:
        fit_score = torch.clamp(20.0 - total, 0.0, 18.0)
    coll = tg_coll.to(torch.float32)
    anti_fires = coll > 0
    penalty = a["penalty"].bool()
    dev_score = a["dev_score"]
    return dict(
        feas=feas, fit_dims=fit_dims, fit=fit_dims.all(dim=1),
        binpack=_div(fit_score, 18.0),
        anti=torch.where(anti_fires,
                         _div(-(coll + 1.0), max(a["desired_count"], 1.0)),
                         0.0),
        pen=torch.where(penalty, -1.0, 0.0), aff=a["affinity_norm"],
        dev=dev_score if a["dev_fires"] > 0 else torch.zeros_like(dev_score),
        anti_fires=anti_fires, pen_fires=penalty,
        aff_fires=a["affinity_norm"] != 0.0,
        pre_fires=a["pre_score"] != 0.0)


def _spread_term(a: Dict, carry, s: int, codes: torch.Tensor):
    """Spread stanza s's term (0.0 where the stanza is not valid) at the
    attribute codes `codes` (select.py:256-296): a row's codes, or every
    code for the kernel's per-code table."""
    sp_counts, sp_present = carry[6], carry[7]
    dev = codes.device
    c_axis = sp_counts.shape[-1]
    missing = codes == c_axis - 1
    used_cnt = sp_counts[s][codes] + 1.0
    desired = a["sp_desired"][s][codes]
    has_desired = desired >= 0.0
    w = _div(a["sp_weight"][s], max(a["sum_spread_w"], 1e-9))
    targeted = torch.where(
        has_desired,
        (desired - used_cnt) / torch.clamp(desired, min=1e-9) * w,
        -1.0)
    pres = sp_present[s]
    cnts = sp_counts[s]
    min_cnt = torch.where(pres, cnts, 1e30).min()
    max_cnt = torch.where(pres, cnts, -1e30).max()
    any_present = bool(pres.any())
    cur = sp_counts[s][codes]
    even = torch.where(min_cnt == 0.0, -1.0,
                       (min_cnt - cur) / torch.clamp(min_cnt, min=1e-9))
    at_min = cur == min_cnt
    if bool(min_cnt == max_cnt):
        at_val = _f32(-1.0, dev)
    elif bool(min_cnt == 0.0):
        at_val = _f32(1.0, dev)
    else:
        at_val = (max_cnt - min_cnt) / torch.clamp(min_cnt, min=1e-9)
    even = torch.where(at_min, at_val, even)
    if not any_present:
        even = torch.zeros_like(even)
    even = torch.where(missing, -1.0, even)
    if bool(a["sp_has_targets"][s]):
        contrib = torch.where(missing, -1.0, targeted)
    else:
        contrib = even
    if bool(a["sp_valid"][s]):
        return contrib
    return torch.zeros_like(contrib)


def _dp_admits(a: Dict, carry, p: int, codes: torch.Tensor):
    """Whether distinct_property p admits one more placement at the codes
    `codes` (select.py:211-217), or None where p is not valid."""
    dp_counts = carry[8]
    if not bool(a["dp_valid"][p]):
        return None
    missing = codes == dp_counts.shape[-1] - 1
    return (dp_counts[p][codes] + 1.0 <= a["dp_limit"][p]) & ~missing


def _scan_sweep(a: Dict, carry, *, spread_alg: bool, s_live: int,
                p_live: int):
    """One step of the scan's sweep over every row, term for term as the
    JAX `_select_scan_fn`'s step: (masked, feas, fit_dims, ok, binpack,
    anti, pen, aff, spread_total, dev)."""
    loc = _scan_local(a, carry, spread_alg)
    feas = loc["feas"]
    for p in range(p_live):
        ok_p = _dp_admits(a, carry, p, a["dp_codes"][p].long())
        if ok_p is not None:
            feas &= ok_p
    spread_total = torch.zeros(feas.shape[0], dtype=torch.float32,
                               device=feas.device)
    for s in range(s_live):
        spread_total = spread_total + _spread_term(a, carry, s,
                                                   a["sp_codes"][s].long())
    fired = (1.0 + loc["anti_fires"].to(torch.float32)
             + loc["pen_fires"].to(torch.float32)
             + loc["aff_fires"].to(torch.float32)
             + (spread_total != 0.0).to(torch.float32)
             + (1.0 if a["dev_fires"] > 0 else 0.0)
             + loc["pre_fires"].to(torch.float32))
    final = (loc["binpack"] + loc["anti"] + loc["pen"] + loc["aff"]
             + spread_total + loc["dev"] + a["pre_score"]) / fired
    ok = feas & loc["fit"]
    return (torch.where(ok, final, NEG_INF), feas, loc["fit_dims"], ok,
            loc["binpack"], loc["anti"], loc["pen"], loc["aff"],
            spread_total, loc["dev"])


def scan_plain(capacity, used0, feasible, ask, k_valid, tg_coll0, job_count0,
               distinct_hosts_flag, scan_exclusive, penalty, affinity_norm,
               desired_count, port_need, free_ports, port_ok, dev_slots0,
               dev_score, dev_fires, pre_score, sp_codes, sp_counts0,
               sp_present0, sp_desired, sp_weight, sp_has_targets, sp_valid,
               sum_spread_w, dp_codes, dp_counts0, dp_limit, dp_valid, *,
               k_steps: int, spread_alg: bool, s_live: int, p_live: int,
               shards: int = 1):
    """Plain version of the one-instance-per-step scan, mirroring the JAX
    `_select_scan_fn`: returns (carry, 13 per-step output buffers). With
    `shards` the node axis is split as scan_sharded_plain says."""
    a = dict(zip(SCAN_NAMES, (
        capacity, used0, feasible, ask, k_valid, tg_coll0, job_count0,
        distinct_hosts_flag, scan_exclusive, penalty, affinity_norm,
        desired_count, port_need, free_ports, port_ok, dev_slots0,
        dev_score, dev_fires, pre_score, sp_codes, sp_counts0, sp_present0,
        sp_desired, sp_weight, sp_has_targets, sp_valid, sum_spread_w,
        dp_codes, dp_counts0, dp_limit, dp_valid)))
    dev = capacity.device
    n, d = capacity.shape
    sp_codes_l, dp_codes_l = sp_codes.long(), dp_codes.long()
    used = used0.clone()
    tg_coll = tg_coll0.clone()
    job_cnt = job_count0.clone()
    scan_placed = torch.zeros(n, dtype=torch.int32, device=dev)
    free_p = free_ports.clone()
    dev_slots = dev_slots0.clone()
    sp_counts = sp_counts0.clone()
    sp_present = sp_present0.bool().clone()
    dp_counts = dp_counts0.clone()
    carry = (used, tg_coll, job_cnt, scan_placed, free_p, dev_slots,
             sp_counts, sp_present, dp_counts)
    rows_s = torch.arange(sp_counts.shape[0], device=dev)
    rows_p = torch.arange(dp_counts.shape[0], device=dev)
    outs = []
    for step_i in range(k_steps):
        (masked, feas, fit_dims, ok, binpack, anti, pen, aff, spread_total,
         dev_v) = _scan_sweep(a, carry, spread_alg=spread_alg,
                              s_live=s_live, p_live=p_live)
        choice = _argmax_shards(masked, shards)
        valid = bool(masked[choice] > NEG_INF / 2) and step_i < k_valid
        if step_i == 0 or not valid:
            ti, ts, exh, ok_count = _meta(masked, feas, fit_dims, ok,
                                          shards)
        else:
            ti = torch.full((TOP_K,), -1, dtype=torch.int32, device=dev)
            ts = torch.full((TOP_K,), NEG_INF, device=dev)
            exh = torch.full((d,), -1, dtype=torch.int32, device=dev)
            ok_count = -1

        c = choice

        def at(v):
            return v[c] if valid else _f32(0.0, dev)

        outs.append((c if valid else -1, at(masked), at(binpack), at(anti),
                     at(pen), at(aff), at(spread_total), at(dev_v),
                     at(pre_score), ti, ts, exh, ok_count))

        incf = 1.0 if valid else 0.0
        inc = 1 if valid else 0
        idx = torch.tensor([c], device=dev)
        used.index_add_(0, idx, (incf * ask)[None, :])
        for col in (tg_coll, job_cnt, scan_placed):
            col.index_add_(0, idx, torch.tensor([inc], dtype=col.dtype,
                                                device=dev))
        free_p.index_add_(0, idx, _f32([-incf * port_need], dev))
        dev_slots.index_add_(0, idx, _f32([-incf], dev))
        chosen_sp = sp_codes_l[:, c]
        sp_counts.index_put_((rows_s, chosen_sp),
                             torch.full_like(rows_s, 0, dtype=torch.float32)
                             + incf, accumulate=True)
        sp_present[rows_s, chosen_sp] = sp_present[rows_s, chosen_sp] | valid
        chosen_dp = dp_codes_l[:, c]
        dp_counts.index_put_((rows_p, chosen_dp),
                             torch.full_like(rows_p, 0, dtype=torch.float32)
                             + incf, accumulate=True)

    i32 = dict(dtype=torch.int32, device=dev)
    choice_out = torch.tensor([o[0] for o in outs], **i32)
    floats = [torch.stack([o[k] for o in outs]).to(torch.float32)
              for k in range(1, 9)]
    out = (choice_out, *floats,
           torch.stack([o[9] for o in outs]),
           torch.stack([o[10] for o in outs]).to(torch.float32),
           torch.stack([o[11] for o in outs]),
           torch.tensor([o[12] for o in outs], **i32))
    return carry, out


# -- node-sharded (mesh) --------------------------------------------------
# The JAX package's mesh path runs the solo programs with the node axis
# split over a `nodes` mesh (parallel/sharded.py); XLA adds the cross-shard
# arg-max, top-k and sums. The sharded kernels split the padded table into
# `shards` equal slices (shard s owns rows [s*per, (s+1)*per)); their plain
# versions make the same decomposition: each slice's own arg-max, top-k and
# counts, then the cross-shard reduction in the kernel's order. Every such
# reduction is exact, so the results equal the solo versions' on the same
# padded table.

def scan_sharded_plain(*args, shards: int, **kw):
    """Plain version of the node-sharded scan; arguments and results as
    scan_plain's, with the shard count."""
    return scan_plain(*args, shards=shards, **kw)


def kway_sharded_plain(*args, shards: int, **kw):
    """Plain version of the node-sharded K-way kernel; arguments and
    results as kway_plain's, with the shard count."""
    return kway_plain(*args, shards=shards, **kw)


# select_many over a mesh runs the batched programs SPMD with the node axis
# sharded and the lane axis replicated: each lane is the sharded solo
# program on its own request, so the plain versions are the sharded plain
# versions lane by lane (arguments by name, as the batched ones).

def chunked_batched_sharded_plain(*, max_steps: int, spread_alg: bool,
                                  shards: int, **a):
    """Plain version of the batched node-sharded chunked kernel; results as
    chunked_batched_plain's."""
    return _per_lane(chunked_plain, LOCAL_NAMES, a,
                     dict(max_steps=max_steps, spread_alg=spread_alg,
                          shards=shards))


def kway_batched_sharded_plain(*, max_steps: int, spread_alg: bool, w: int,
                               shards: int, **a):
    """Plain version of the batched node-sharded K-way kernel; results as
    kway_batched_plain's."""
    return _per_lane(kway_plain, LOCAL_NAMES, a,
                     dict(max_steps=max_steps, spread_alg=spread_alg, w=w,
                          shards=shards))


def scan_batched_sharded_plain(*, k_steps: int, spread_alg: bool,
                               s_live: int, p_live: int, shards: int, **a):
    """Plain version of the batched node-sharded scan; results as
    scan_batched_plain's."""
    return _per_lane(scan_plain, SCAN_NAMES, a,
                     dict(k_steps=k_steps, spread_alg=spread_alg,
                          s_live=s_live, p_live=p_live, shards=shards))


# -- resident table --------------------------------------------------------
# The three row scatters are out of place, as JAX's `.at[].set/.add`: each
# returns new tensors and leaves its inputs as they were. `idx` holds table
# rows as a CPU int32 tensor (the wrappers check it on the host before a
# launch; overlay_add's and feas_scatter's rows must be distinct, in any
# order); the row values may lie on the CPU or on the table's device.

def scatter_set_plain(used, ports, idx, used_rows, port_rows):
    """(used with used_rows set at idx, ports with port_rows set at idx)."""
    dev = used.device
    i = idx.to(dev, torch.long)
    return (used.clone().index_copy_(0, i, used_rows.to(dev)),
            ports.clone().index_copy_(0, i, port_rows.to(dev)))


def overlay_add_plain(used, idx, vals):
    """used with vals added at the (distinct) rows idx."""
    dev = used.device
    return used.clone().index_add_(0, idx.to(dev, torch.long), vals.to(dev))


def feas_scatter_plain(mask, idx, vals):
    """mask with vals set at the (distinct) rows idx."""
    dev = mask.device
    return mask.clone().index_copy_(0, idx.to(dev, torch.long), vals.to(dev))


# -- build and load --------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc"
# every CUDA source of the package, each compiled by its own nvcc process
# (all started together) and linked into one shared library
SOURCES = (_CSRC / "select_kernels.cu", _CSRC / "table_kernels.cu",
           _CSRC / "sharded_kernels.cu")
# headers the sources include: part of the build's key
HEADERS = (_CSRC / "select_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_LIB = None
_LIB_LOCK = make_lock()
_CPU = torch.device("cpu")
BUILD_INFO: Dict[str, object] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the K-way kernels' exchange buffers (_xchg), shards, rows a shard, stream
_XCHG = [_P] * 5 + [_I] * 2 + [_P]
# the sharded scan's and chunked kernels': their grid route's entries and
# flags, shards, rows a shard, stream
_SCAN_XCHG = [_P] * 2 + [_I] * 2 + [_P]
_ARGTYPES = {
    "nomad_select_chunked": [_P] * 17 + [_I] * 5 + [_F] * 3 + [_P] * 9
    + [_I, _P],
    "nomad_select_kway": [_P] * 13 + [_I] * 5 + [_F] * 3 + [_I, _P, _P, _P],
    "nomad_select_scan": [_P] * 30 + [_I] * 7 + [_F] * 6 + [_P] * 14,
    "nomad_select_chunked_batched": [_P] * 17 + [_I] * 5 + [_P] * 4
    + [_P] * 9 + [_I, _P],
    "nomad_select_kway_batched": [_P] * 13 + [_I] * 5 + [_P] * 4
    + [_I, _P, _P, _P],
    "nomad_select_scan_batched": [_P] * 30 + [_I] * 7 + [_P] * 7
    + [_P] * 14,
    "nomad_scatter_set": [_P] * 9 + [_I] * 3 + [_P],
    "nomad_overlay_add": [_P] * 5 + [_I] * 3 + [_P],
    "nomad_feas_scatter": [_P] * 5 + [_I] * 2 + [_P],
    "nomad_select_scan_sharded": [_P] * 30 + [_I] * 7 + [_F] * 6 + [_P] * 13
    + _SCAN_XCHG,
    "nomad_select_kway_sharded": [_P] * 13 + [_I] * 5 + [_F] * 3
    + [_I, _P, _P] + _XCHG,
    "nomad_select_chunked_batched_sharded": [_P] * 17 + [_I] * 5 + [_P] * 4
    + [_P] * 8 + _SCAN_XCHG,
    "nomad_select_kway_batched_sharded": [_P] * 13 + [_I] * 5 + [_P] * 4
    + [_I, _P, _P] + _XCHG,
    "nomad_select_scan_batched_sharded": [_P] * 30 + [_I] * 7 + [_P] * 7
    + [_P] * 13 + _SCAN_XCHG,
    "nomad_sharded_max_blocks": [_I, ctypes.POINTER(ctypes.c_int)],
    "nomad_scan_sharded_info": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "nomad_chunked_sharded_info": [_I, ctypes.POINTER(ctypes.c_int)],
    "nomad_scan_shared_slots": [_I, ctypes.POINTER(ctypes.c_int)],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")


def library_loaded() -> bool:
    """Whether the kernels' library is loaded in this process: the first
    launch after it is not pays the build or the load."""
    return _LIB is not None


def load_library():
    """Build (once per hash of the sources and flags) and load the
    kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES + HEADERS:
            h.update(src.name.encode() + b"\0" + src.read_bytes())
        key = h.hexdigest()[:16]
        so = BUILD_DIR / f"nomad_kernels_{key}.so"
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc, tag = _nvcc(), f"{key}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in SOURCES]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                      for src, o in zip(SOURCES, objs)])
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            os.replace(tmp, so)
            for o in objs:
                o.unlink()
            built = True
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(path=str(so), built=built,
                          seconds=time.perf_counter() - t0)
        _LIB = lib
        return lib


# -- wrappers --------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if isinstance(t, torch.Tensor) and t.device == device \
            and t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _bools(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    """A bool column, checked: the kernels read its bytes as uint8."""
    _check(name, t, torch.bool, shape, device)
    return t


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _is_cpu(capacity: torch.Tensor) -> bool:
    if capacity.device.type == "cpu":
        return True
    if capacity.device.type != "cuda":
        raise ValueError(f"unsupported device {capacity.device}")
    return False


def _local_inputs(capacity, used0, feasible, ask, tg_coll0, penalty,
                  affinity_norm, free_ports, port_ok, dev_slots0, dev_score,
                  pre_score, lead=(), copies=True):
    """Checks the node-local kernels' inputs; returns the 13 tensors the
    kernels take (the 12 inputs, carries as fresh copies the kernel updates
    in place, and the masked scratch), the carry tensors, and (n, d).
    `lead` is () for one request and (B,) for a batch: every input but the
    shared capacity then carries a leading lane axis, and the scratch has
    one row a lane. Without `copies` (the chunked kernels, whose step-0
    sweep copies each row it reads) the carries are fresh and unwritten,
    and the caller's four carries follow the 13 tensors."""
    dev = capacity.device
    if capacity.dim() != 2:
        raise ValueError("capacity must be [N, D]")
    n, d = capacity.shape
    if not (2 <= d <= D_MAX) or n < TOP_K:
        raise ValueError(f"unsupported table shape {(n, d)}")
    f32, i32 = torch.float32, torch.int32
    lead = tuple(lead)
    _check("capacity", capacity, f32, (n, d), dev)
    _check("used0", used0, f32, lead + (n, d), dev)
    _check("ask", ask, f32, lead + (d,), dev)
    _check("tg_coll0", tg_coll0, i32, lead + (n,), dev)
    for nm, t in (("affinity_norm", affinity_norm), ("free_ports", free_ports),
                  ("dev_slots0", dev_slots0), ("dev_score", dev_score),
                  ("pre_score", pre_score)):
        _check(nm, t, f32, lead + (n,), dev)
    if copies:
        used, coll = used0.clone(), tg_coll0.clone()
        free_p, dev_slots = free_ports.clone(), dev_slots0.clone()
    else:
        used = torch.empty(lead + (n, d), dtype=f32, device=dev)
        coll = torch.empty(lead + (n,), dtype=i32, device=dev)
        free_p = torch.empty(lead + (n,), dtype=f32, device=dev)
        dev_slots = torch.empty(lead + (n,), dtype=f32, device=dev)
    masked = torch.empty(lead + (n,), dtype=f32, device=dev)
    ptrs = [capacity, used, _bools("feasible", feasible, lead + (n,), dev),
            ask, coll, _bools("penalty", penalty, lead + (n,), dev),
            affinity_norm, free_p,
            _bools("port_ok", port_ok, lead + (n,), dev), dev_slots,
            dev_score, pre_score, masked]
    if not copies:
        ptrs += [used0, tg_coll0, free_ports, dev_slots0]
    return ptrs, (used, coll, free_p, dev_slots), n, d


def _lanes(used0) -> int:
    """The lane count B of a batched call (any B >= 1)."""
    if not isinstance(used0, torch.Tensor) or used0.dim() != 3 \
            or used0.shape[0] < 1:
        raise ValueError("used0 must be [B, N, D] with B >= 1")
    return used0.shape[0]


def _lane_scalars(b: int, device, **named):
    """The per-lane scalar arrays of a batched call, checked: k_valid is
    int32 [B], every other one float32 [B]."""
    for nm, t in named.items():
        _check(nm, t, torch.int32 if nm == "k_valid" else torch.float32,
               (b,), device)
    return list(named.values())


def _at(tensors, g: int = 0):
    """Pointers of lane-led (contiguous) tensors at lane g."""
    if g == 0:
        return [t.data_ptr() for t in tensors]
    return [t.data_ptr() + g * t.stride(0) * t.element_size()
            for t in tensors]


def _stream(device) -> int:
    """The raw handle of the device's current stream, read without making
    a Stream object (a few microseconds a launch on a busy host)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _chunked_outputs(lanes: int, steps: int, d: int, device, solo=False,
                     scratch: int = 0):
    """The chunked kernels' eight outputs (choice, chunk [B, steps]; ti,
    ts [B, steps, TOP_K]; exh [B, steps, d]; feas [B, steps]; remaining,
    steps [B]; without the lane axis where `solo`) in one int32
    allocation, handed out as views (ts as float32), and after them, 16
    bytes aligned, `scratch` ints of the launch's own scratch (the pre-pass
    counts, or the grid route's exchange). Returns (outputs, scratch)."""
    sizes = [lanes * s for s in (steps, steps, steps * TOP_K, steps * TOP_K,
                                 steps * d, steps, 1, 1)]
    sizes += [-sum(sizes) % 4, scratch]
    outs = list(torch.empty(sum(sizes), dtype=torch.int32,
                            device=device).split(sizes))
    scratch_at = outs.pop() if scratch else None
    del outs[8:]   # the alignment's pad, and an empty scratch
    lead = () if solo else (lanes,)
    for i, s in enumerate(((steps,), (steps,), (steps, TOP_K),
                           (steps, TOP_K), (steps, d), (steps,))):
        outs[i] = outs[i].view(lead + s)
    outs[3] = outs[3].view(torch.float32)
    if solo:
        outs[6], outs[7] = outs[6].view(()), outs[7].view(())
    return outs, scratch_at


def _chunked_part(lanes: int, n: int) -> int:
    """The ints of the chunked kernels' scratch for their step-0 sweep's
    counts: a block's D_MAX first-failing-dimension counts and its ok rows,
    for each block of CHUNK_PRE_ROWS rows of each lane."""
    return lanes * -(-n // CHUNK_PRE_ROWS) * (D_MAX + 1)


def select_chunked(capacity, used0, feasible, ask, k_valid, tg_coll0,
                   penalty, affinity_norm, desired_count, port_need,
                   free_ports, port_ok, dev_slots0, dev_score, dev_fires,
                   pre_score, *, max_steps: int, spread_alg: bool):
    """Chunked greedy placement; arguments and results as chunked_plain.
    `remaining` and `steps` come back as 0-d int32 tensors."""
    if _is_cpu(capacity):
        return chunked_plain(
            capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
            affinity_norm, desired_count, port_need, free_ports, port_ok,
            dev_slots0, dev_score, dev_fires, pre_score,
            max_steps=max_steps, spread_alg=spread_alg)
    dev = capacity.device
    ptrs, carry, n, d = _local_inputs(
        capacity, used0, feasible, ask, tg_coll0, penalty, affinity_norm,
        free_ports, port_ok, dev_slots0, dev_score, pre_score, copies=False)
    outs, part = _chunked_outputs(1, max_steps, d, dev, solo=True,
                                  scratch=_chunked_part(1, n))
    lib = load_library()
    rc = lib.nomad_select_chunked(
        *[t.data_ptr() for t in ptrs], n, d, int(k_valid), int(max_steps),
        int(bool(spread_alg)), float(desired_count), float(port_need),
        float(dev_fires), *[t.data_ptr() for t in outs], part.data_ptr(),
        part.numel(), _stream(dev))
    _raise_on(rc, "chunked")
    LAUNCHES["chunked"] += 1
    return carry, tuple(outs)


def select_kway(capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
                affinity_norm, desired_count, port_need, free_ports, port_ok,
                dev_slots0, dev_score, dev_fires, pre_score, *,
                max_steps: int, spread_alg: bool, w: int):
    """K-way waterline placement; arguments and results as kway_plain."""
    if _is_cpu(capacity):
        return kway_plain(
            capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
            affinity_norm, desired_count, port_need, free_ports, port_ok,
            dev_slots0, dev_score, dev_fires, pre_score,
            max_steps=max_steps, spread_alg=spread_alg, w=w)
    dev = capacity.device
    ptrs, carry, n, d = _local_inputs(
        capacity, used0, feasible, ask, tg_coll0, penalty, affinity_norm,
        free_ports, port_ok, dev_slots0, dev_score, pre_score)
    if not (1 <= w <= W_MAX) or n < w + 1:
        raise ValueError(f"K-way width {w} unsupported for {n} rows")
    packed = torch.empty((max_steps, 2 * w + TOP_K + d + 3),
                         dtype=torch.int32, device=dev)
    out_ts = torch.empty((max_steps, TOP_K), dtype=torch.float32, device=dev)
    lib = load_library()
    rc = lib.nomad_select_kway(
        *[t.data_ptr() for t in ptrs], n, d, int(k_valid), int(max_steps),
        int(bool(spread_alg)), float(desired_count), float(port_need),
        float(dev_fires), int(w), packed.data_ptr(), out_ts.data_ptr(),
        _stream(dev))
    _raise_on(rc, "kway")
    LAUNCHES["kway"] += 1
    return carry, (packed, out_ts)


def _scan_inputs(a: Dict, lead=()):
    """Checks the scan's inputs (dict `a` by argument name, `lead` as in
    _local_inputs); returns the kernel's 29 input tensors (their pointers
    in the kernel's order; the caller holds them, scratch included, until
    the launch is enqueued), its carry tensors, and (n, d)."""
    dev = a["capacity"].device
    ptrs, (used, coll, free_p, dev_slots), n, d = _local_inputs(
        *(a[k] for k in _LOCAL_INPUTS), lead=lead)
    f32, i32 = torch.float32, torch.int32
    lead = tuple(lead)
    c = C_MAX + 1
    _check("job_count0", a["job_count0"], i32, lead + (n,), dev)
    _check("sp_codes", a["sp_codes"], i32, lead + (S_MAX, n), dev)
    _check("dp_codes", a["dp_codes"], i32, lead + (P_MAX, n), dev)
    for nm, shape in (("sp_counts0", (S_MAX, c)), ("sp_desired", (S_MAX, c)),
                      ("sp_weight", (S_MAX,)), ("dp_counts0", (P_MAX, c)),
                      ("dp_limit", (P_MAX,))):
        _check(nm, a[nm], f32, lead + shape, dev)
    # codes index the C-long histograms: an out-of-range code would be an
    # out-of-bounds access on the card, so check them before the launch
    sp_codes, dp_codes = a["sp_codes"], a["dp_codes"]
    lo = min(int(sp_codes.min()), int(dp_codes.min()))
    hi = max(int(sp_codes.max()), int(dp_codes.max()))
    if lo < 0 or hi > C_MAX:
        raise ValueError(f"attribute codes span [{lo}, {hi}], "
                         f"outside [0, {C_MAX}]")
    job_cnt = a["job_count0"].clone()
    scan_placed = torch.zeros(lead + (n,), dtype=i32, device=dev)
    sp_counts = torch.empty(lead + (S_MAX, c), dtype=f32, device=dev)
    sp_present = torch.empty(lead + (S_MAX, c), dtype=torch.bool, device=dev)
    dp_counts = torch.empty(lead + (P_MAX, c), dtype=f32, device=dev)
    (t_cap, t_used, t_feas, t_ask, t_coll, t_pen, t_aff, t_free, t_port,
     t_dev, t_dscore, t_pre, t_masked) = ptrs
    inputs = [t_cap, t_used, t_feas, t_ask, t_coll, job_cnt, scan_placed,
              t_pen, t_aff, t_free, t_port, t_dev, t_dscore, t_pre,
              sp_codes, a["sp_counts0"],
              _bools("sp_present0", a["sp_present0"], lead + (S_MAX, c), dev),
              a["sp_desired"], a["sp_weight"],
              _bools("sp_has_targets", a["sp_has_targets"], lead + (S_MAX,),
                  dev),
              _bools("sp_valid", a["sp_valid"], lead + (S_MAX,), dev),
              dp_codes, a["dp_counts0"], a["dp_limit"],
              _bools("dp_valid", a["dp_valid"], lead + (P_MAX,), dev),
              sp_counts, sp_present.view(torch.uint8), dp_counts, t_masked]
    carry = (used, coll, job_cnt, scan_placed, free_p, dev_slots, sp_counts,
             sp_present, dp_counts)
    return inputs, carry, n, d


def _scan_outputs(lead, k: int, d: int, dev):
    """The scan's 13 per-step output buffers."""
    lead = tuple(lead)
    f32, i32 = torch.float32, torch.int32
    return (torch.empty(lead + (k,), dtype=i32, device=dev),
            *[torch.empty(lead + (k,), dtype=f32, device=dev)
              for _ in range(8)],
            torch.empty(lead + (k, TOP_K), dtype=i32, device=dev),
            torch.empty(lead + (k, TOP_K), dtype=f32, device=dev),
            torch.empty(lead + (k, d), dtype=i32, device=dev),
            torch.empty(lead + (k,), dtype=i32, device=dev))


def _scan_records(lanes: int, n: int, dev) -> torch.Tensor:
    """Scratch for the scan kernels' per-row records (select_common.cuh,
    ScanRecs): 68 bytes a row a lane."""
    return torch.empty(lanes * n * 17, dtype=torch.float32, device=dev)


def _check_live(s_live: int, p_live: int) -> None:
    if not (0 <= s_live <= S_MAX and 0 <= p_live <= P_MAX):
        raise ValueError(f"s_live={s_live}, p_live={p_live} out of range")


def select_scan(capacity, used0, feasible, ask, k_valid, tg_coll0,
                job_count0, distinct_hosts_flag, scan_exclusive, penalty,
                affinity_norm, desired_count, port_need, free_ports, port_ok,
                dev_slots0, dev_score, dev_fires, pre_score, sp_codes,
                sp_counts0, sp_present0, sp_desired, sp_weight,
                sp_has_targets, sp_valid, sum_spread_w, dp_codes, dp_counts0,
                dp_limit, dp_valid, *, k_steps: int, spread_alg: bool,
                s_live: int, p_live: int):
    """One-instance-per-step scan; arguments and results as scan_plain."""
    args = (capacity, used0, feasible, ask, k_valid, tg_coll0, job_count0,
            distinct_hosts_flag, scan_exclusive, penalty, affinity_norm,
            desired_count, port_need, free_ports, port_ok, dev_slots0,
            dev_score, dev_fires, pre_score, sp_codes, sp_counts0,
            sp_present0, sp_desired, sp_weight, sp_has_targets, sp_valid,
            sum_spread_w, dp_codes, dp_counts0, dp_limit, dp_valid)
    statics = dict(k_steps=k_steps, spread_alg=spread_alg, s_live=s_live,
                   p_live=p_live)
    if _is_cpu(capacity):
        return scan_plain(*args, **statics)
    dev = capacity.device
    _check_live(s_live, p_live)
    inputs, carry, n, d = _scan_inputs(dict(zip(SCAN_NAMES, args)))
    k = int(k_steps)
    outs = _scan_outputs((), k, d, dev)
    recs = _scan_records(1, n, dev)
    lib = load_library()
    rc = lib.nomad_select_scan(
        *[t.data_ptr() for t in inputs], recs.data_ptr(), n, d, int(k_valid),
        k, int(bool(spread_alg)), int(s_live), int(p_live),
        float(distinct_hosts_flag), float(scan_exclusive),
        float(desired_count), float(port_need), float(dev_fires),
        float(sum_spread_w), *[t.data_ptr() for t in outs], _stream(dev))
    _raise_on(rc, "scan")
    LAUNCHES["scan"] += 1
    return carry, outs


# -- batched ---------------------------------------------------------------
# The JAX package's vmap of a solo program over B lanes that share one
# capacity table (in_axes None for capacity, 0 for every other argument):
# each argument but capacity carries a leading lane axis, and the per-lane
# scalars (k_valid, desired_count, port_need, dev_fires and, for the scan,
# distinct_hosts_flag, scan_exclusive and sum_spread_w) become [B] tensors.
# The step budget and the other keyword arguments are the batch's own. A
# vmapped loop runs until its slowest lane is done and leaves a finished
# lane's state as it was, so each lane's result is its solo result under
# the batch's budget: the plain versions run the solo plain version lane
# by lane and stack the results. Any B >= 1 is taken; there is no lane
# padding. The batched functions take their arguments by name.

def _named(names, a: Dict) -> Dict:
    """The keyword arguments of a batched call, checked by name."""
    if sorted(a) != sorted(names):
        raise TypeError(f"expected the arguments {names}, got {sorted(a)}")
    return a


def lane_args(a: Dict, i: int) -> Dict:
    """Lane i's solo arguments of a batched call."""
    out = {}
    for k, v in a.items():
        if k == "capacity":
            out[k] = v
        elif k == "k_valid":
            out[k] = int(v[i])
        elif k in _LANE_FLOATS:
            out[k] = float(v[i])
        else:
            out[k] = v[i]
    return out


def _per_lane(plain, names, a, statics):
    a = _named(names, a)
    lanes = [plain(**lane_args(a, i), **statics)
             for i in range(_lanes(a["used0"]))]
    return tuple(tuple(torch.stack([ln[part][j] for ln in lanes])
                       for j in range(len(lanes[0][part])))
                 for part in (0, 1))


def chunked_batched_plain(*, max_steps: int, spread_alg: bool, **a):
    """Plain version of the batched chunked kernel (the JAX
    `_chunked_batched_jit`): chunked_plain lane by lane under the batch's
    max_steps; results as chunked_plain's with a leading lane axis."""
    return _per_lane(chunked_plain, LOCAL_NAMES, a,
                     dict(max_steps=max_steps, spread_alg=spread_alg))


def kway_batched_plain(*, max_steps: int, spread_alg: bool, w: int, **a):
    """Plain version of the batched K-way kernel (the JAX
    `_select_kway_batched`): kway_plain lane by lane."""
    return _per_lane(kway_plain, LOCAL_NAMES, a,
                     dict(max_steps=max_steps, spread_alg=spread_alg, w=w))


def scan_batched_plain(*, k_steps: int, spread_alg: bool, s_live: int,
                       p_live: int, **a):
    """Plain version of the batched scan (the JAX `_scan_batched_jit`):
    scan_plain lane by lane under the batch's k_steps, s_live, p_live."""
    return _per_lane(scan_plain, SCAN_NAMES, a,
                     dict(k_steps=k_steps, spread_alg=spread_alg,
                          s_live=s_live, p_live=p_live))


def _local_batched(a: Dict, copies=True):
    """Checks a batched node-local call; returns (_local_inputs' tensors,
    carry, B, n, d, the 4 lane-scalar tensors)."""
    b = _lanes(a["used0"])
    ptrs, carry, n, d = _local_inputs(*(a[k] for k in _LOCAL_INPUTS),
                                      lead=(b,), copies=copies)
    lane = _lane_scalars(b, a["capacity"].device, k_valid=a["k_valid"],
                         desired_count=a["desired_count"],
                         port_need=a["port_need"], dev_fires=a["dev_fires"])
    return ptrs, carry, b, n, d, lane


def select_chunked_batched(*, max_steps: int, spread_alg: bool, **a):
    """B chunked placements over one capacity table in one launch of B
    blocks; arguments and results as chunked_batched_plain."""
    a = _named(LOCAL_NAMES, a)
    if _is_cpu(a["capacity"]):
        return chunked_batched_plain(**a, max_steps=max_steps,
                                     spread_alg=spread_alg)
    dev = a["capacity"].device
    ptrs, carry, b, n, d, lane = _local_batched(a, copies=False)
    outs, part = _chunked_outputs(b, max_steps, d, dev,
                                  scratch=_chunked_part(b, n))
    lib = load_library()
    rc = lib.nomad_select_chunked_batched(
        *[t.data_ptr() for t in ptrs], b, n, d, int(max_steps),
        int(bool(spread_alg)), *_at(lane), *[t.data_ptr() for t in outs],
        part.data_ptr(), part.numel(), _stream(dev))
    _raise_on(rc, "chunked_batched")
    LAUNCHES["chunked_batched"] += 1
    return carry, tuple(outs)


def select_kway_batched(*, max_steps: int, spread_alg: bool, w: int, **a):
    """B K-way placements over one capacity table in one launch of B
    blocks; arguments and results as kway_batched_plain."""
    a = _named(LOCAL_NAMES, a)
    if _is_cpu(a["capacity"]):
        return kway_batched_plain(**a, max_steps=max_steps,
                                  spread_alg=spread_alg, w=w)
    dev = a["capacity"].device
    ptrs, carry, b, n, d, lane = _local_batched(a)
    if not (1 <= w <= W_MAX) or n < w + 1:
        raise ValueError(f"K-way width {w} unsupported for {n} rows")
    packed = torch.empty((b, max_steps, 2 * w + TOP_K + d + 3),
                         dtype=torch.int32, device=dev)
    out_ts = torch.empty((b, max_steps, TOP_K), dtype=torch.float32,
                         device=dev)
    lib = load_library()
    rc = lib.nomad_select_kway_batched(
        *[t.data_ptr() for t in ptrs], b, n, d, int(max_steps),
        int(bool(spread_alg)), *_at(lane), int(w), packed.data_ptr(),
        out_ts.data_ptr(), _stream(dev))
    _raise_on(rc, "kway_batched")
    LAUNCHES["kway_batched"] += 1
    return carry, (packed, out_ts)


def select_scan_batched(*, k_steps: int, spread_alg: bool, s_live: int,
                        p_live: int, **a):
    """B scans over one capacity table in one launch of B blocks;
    arguments and results as scan_batched_plain."""
    a = _named(SCAN_NAMES, a)
    statics = dict(k_steps=k_steps, spread_alg=spread_alg, s_live=s_live,
                   p_live=p_live)
    if _is_cpu(a["capacity"]):
        return scan_batched_plain(**a, **statics)
    dev = a["capacity"].device
    _check_live(s_live, p_live)
    b = _lanes(a["used0"])
    inputs, carry, n, d = _scan_inputs(a, lead=(b,))
    lane = _lane_scalars(
        b, dev, k_valid=a["k_valid"],
        distinct_hosts_flag=a["distinct_hosts_flag"],
        scan_exclusive=a["scan_exclusive"], desired_count=a["desired_count"],
        port_need=a["port_need"], dev_fires=a["dev_fires"],
        sum_spread_w=a["sum_spread_w"])
    k = int(k_steps)
    outs = _scan_outputs((b,), k, d, dev)
    recs = _scan_records(b, n, dev)
    lib = load_library()
    rc = lib.nomad_select_scan_batched(
        *[t.data_ptr() for t in inputs], recs.data_ptr(), b, n, d, k,
        int(bool(spread_alg)), int(s_live), int(p_live), *_at(lane),
        *[t.data_ptr() for t in outs], _stream(dev))
    _raise_on(rc, "scan_batched")
    LAUNCHES["scan_batched"] += 1
    return carry, outs


def _cpu_rows(idx) -> np.ndarray:
    """A scatter's row indices as a numpy view, checked to be a 1-d int32
    tensor on the CPU or a 1-d int32 numpy array."""
    a = idx.numpy() if isinstance(idx, torch.Tensor) \
        and idx.device.type == "cpu" else idx
    if not isinstance(a, np.ndarray) or a.dtype != np.int32 or a.ndim != 1:
        raise ValueError("idx must be a 1-d int32 tensor on the CPU or a "
                         "1-d int32 numpy array")
    return a


def _in_range(lo: int, hi: int, n: int) -> None:
    if lo < 0 or hi >= n:
        raise ValueError(f"rows span [{lo}, {hi}], outside [0, {n})")


def _patch_rows(idx, n: int):
    """A patch's rows checked on the host (in [0, n), no row twice: the
    fused kernels give each row one slot) and sorted, as the kernels' tile
    searches need them: (rows, order), rows an int32 array in increasing
    order and order None when idx already was, else the int32 permutation
    with rows = idx[order]. Plan and journal rows mostly arrive
    increasing, which proves them distinct in O(m)."""
    rows, order = _sorted_rows(idx)
    if rows.size > 1 and (rows[1:] == rows[:-1]).any():
        raise ValueError("patch rows repeat")
    _rows_in(rows, n)
    return rows, order


def _set_rows(idx, n: int):
    """scatter_set's rows checked on the host (in [0, n)) and sorted as
    _patch_rows sorts them, except that a row may repeat, as
    `.at[idx].set` allows: each repeated row is kept once, at its last
    occurrence in idx (the value a sequential index_copy_ leaves), and
    order then lists the kept rows' positions in idx."""
    rows, order = _sorted_rows(idx)
    if order is not None:
        last = np.append(rows[1:] != rows[:-1], True)
        if not last.all():
            rows, order = rows[last], order[last]
    _rows_in(rows, n)
    return rows, order


def _sorted_rows(idx):
    """(rows, order): idx's rows in increasing order by a stable sort, and
    the int32 permutation with rows = idx[order], None when idx was
    strictly increasing already."""
    rows = _cpu_rows(idx)
    if rows.size < 2 or (rows[1:] > rows[:-1]).all():
        return rows, None
    order = np.argsort(rows, kind="stable").astype(np.int32)
    return rows[order], order


def _rows_in(rows, n: int) -> None:
    """Sorted rows in [0, n): an index out of range would be an
    out-of-bounds write on the card."""
    if rows.size:
        _in_range(int(rows[0]), int(rows[-1]), n)


def pack_host(arrays, pin: bool = False):
    """The numpy arrays packed into ONE uint8 CPU tensor, each at a 16-byte
    aligned offset, so a single copy ships them all; pinned when `pin`,
    for an asynchronous upload. Returns (buffer, offsets)."""
    offsets, end = [], 0
    for a in arrays:
        end = -(-end // 16) * 16
        offsets.append(end)
        end += a.nbytes
    buf = torch.empty(end, dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    for a, o in zip(arrays, offsets):
        raw[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    return buf, offsets


_NUMPY = {torch.float32: np.float32, torch.bool: np.bool_}


def _host_values(name: str, vals, dtype, shape) -> np.ndarray:
    """Row values on the host (a CPU tensor or a numpy array) as a numpy
    array, checked."""
    if isinstance(vals, torch.Tensor):
        if vals.device.type != "cpu":
            raise ValueError(f"{name}: on {vals.device}, expected the CPU "
                             "or the table's device")
        vals = vals.contiguous()
        _check(name, vals, dtype, shape, _CPU)
        return vals.numpy()
    if not isinstance(vals, np.ndarray):
        raise TypeError(f"{name}: expected a tensor or an array, got "
                        f"{type(vals)}")
    if vals.dtype != _NUMPY[dtype] or vals.shape != tuple(shape):
        raise ValueError(f"{name}: {vals.dtype} {vals.shape}, expected "
                         f"{dtype} {tuple(shape)}")
    return vals


def _patch_on(device, rows, order, parts):
    """A patch on the card with no synchronising copy: (held, idx, ptrs).
    `parts` lists the value arrays as (name, vals, dtype, shape); ptrs
    gives each one's (values, order) pointers for the kernel (order 0 for
    none). ONE asynchronous upload of a pinned host buffer carries the
    rows, the host values packed in the rows' sorted order, and, where
    values already on the card are read in place and the rows were
    sorted, the order that sorted them. `held` (the device buffer and the
    values on the card) is kept until the launch is enqueued. PyTorch's
    caching host allocator does not hand the pinned buffer out again
    before the copy that reads it has run, so it is dropped at once."""
    arrays, slots, held = [rows], [], []
    for name, vals, dtype, shape in parts:
        if isinstance(vals, torch.Tensor) and vals.device == device:
            v = vals.contiguous()
            _check(name, v, dtype, shape, device)
            slots.append(v)
            held.append(v)
        else:
            a = _host_values(name, vals, dtype, shape)
            slots.append(len(arrays))
            arrays.append(a if order is None else a[order])
    card_order = order is not None and len(held) > 0
    if card_order:
        arrays.append(order)
    host, offsets = pack_host(arrays, pin=True)
    buf = host.to(device, non_blocking=True)
    base = buf.data_ptr()
    o = base + offsets[-1] if card_order else 0
    ptrs = [(s.data_ptr(), o) if isinstance(s, torch.Tensor)
            else (base + offsets[s], 0) for s in slots]
    return [buf] + held, base, ptrs


def scatter_set(used, ports, idx, used_rows, port_rows):
    """The resident table advanced past an alloc delta: new (used, ports)
    with the rows idx set; arguments and results as scatter_set_plain,
    except that idx and the row values may also be numpy arrays (the host
    table's own). A repeated row takes its last value. On the card: one
    fused copy-and-patch launch that writes both columns, fed by one
    asynchronous upload."""
    rows, order = _set_rows(idx, used.shape[0])
    if _is_cpu(used):
        return scatter_set_plain(used, ports, torch.as_tensor(idx),
                                 torch.as_tensor(used_rows),
                                 torch.as_tensor(port_rows))
    dev = used.device
    n, d = used.shape
    _check("used", used, torch.float32, (n, d), dev)
    _check("ports", ports, torch.float32, (n,), dev)
    if rows.size == 0:
        return used.clone(), ports.clone()
    m = _cpu_rows(idx).size
    held, i, ((v, o), (pv, po)) = _patch_on(
        dev, rows, order,
        [("used_rows", used_rows, torch.float32, (m, d)),
         ("port_rows", port_rows, torch.float32, (m,))])
    out_used, out_ports = torch.empty_like(used), torch.empty_like(ports)
    rc = load_library().nomad_scatter_set(
        used.data_ptr(), ports.data_ptr(), out_used.data_ptr(),
        out_ports.data_ptr(), i, v, o, pv, po, n, rows.size, d,
        _stream(dev))
    _raise_on(rc, "scatter_set")
    LAUNCHES["scatter_set"] += 1
    return out_used, out_ports


def overlay_add(used, idx, vals):
    """A dispatch's used0: new used with vals added at the distinct rows
    idx; arguments and result as overlay_add_plain. On the card: one fused
    copy-and-patch launch fed by one asynchronous upload."""
    rows, order = _patch_rows(idx, used.shape[0])
    if _is_cpu(used):
        return overlay_add_plain(used, idx, vals)
    if rows.size == 0:
        return used.clone()
    dev = used.device
    n, d = used.shape
    _check("used", used, torch.float32, (n, d), dev)
    held, i, ((v, o),) = _patch_on(dev, rows, order,
                                   [("vals", vals, torch.float32,
                                     (rows.size, d))])
    out = torch.empty_like(used)
    rc = load_library().nomad_overlay_add(
        used.data_ptr(), out.data_ptr(), i, v, o, n, rows.size, d,
        _stream(dev))
    _raise_on(rc, "overlay_add")
    LAUNCHES["overlay_add"] += 1
    return out


def feas_scatter(mask, idx, vals):
    """A parked feasibility mask patched by row: new mask with vals set at
    the distinct rows idx; arguments and result as feas_scatter_plain. On
    the card: one fused copy-and-patch launch fed by one asynchronous
    upload (bool columns are read and written as bytes)."""
    rows, order = _patch_rows(idx, mask.shape[0])
    if _is_cpu(mask):
        return feas_scatter_plain(mask, idx, vals)
    if rows.size == 0:
        return mask.clone()
    dev = mask.device
    n = mask.shape[0]
    _check("mask", mask, torch.bool, (n,), dev)
    held, i, ((v, o),) = _patch_on(dev, rows, order,
                                   [("vals", vals, torch.bool,
                                     (rows.size,))])
    out = torch.empty_like(mask)
    rc = load_library().nomad_feas_scatter(
        mask.data_ptr(), out.data_ptr(), i, v, o, n, rows.size,
        _stream(dev))
    _raise_on(rc, "feas_scatter")
    LAUNCHES["feas_scatter"] += 1
    return out


# -- node-sharded (mesh) wrappers ------------------------------------------
# A cooperative sharded launch needs all its blocks (shards, or lanes times
# shards) resident on the card at once. The solo wrappers raise above that;
# the batched ones launch the lanes in consecutive groups of as many lanes
# as fit, each group a launch of its own (lanes share only the read-only
# capacity, so the grouping does not change a result). The sharded scan on
# its cluster route (scan_sharded_info) is no cooperative launch: a lane is
# one thread-block cluster, and every lane goes in one launch.

# the most blocks each cooperative sharded kernel can launch with on a
# card, by (kernel, device index)
_MAX_SHARDS: Dict[tuple, int] = {}
# scan_sharded_info by (shards, per, device index)
_SCAN_INFO: Dict[tuple, Dict[str, object]] = {}
# chunked_sharded_info by (shards, device index), and the batched sharded
# chunked calls' (LAUNCHES key, lane groups) by (lanes, shards, device
# index)
_CHUNK_INFO: Dict[tuple, Dict[str, object]] = {}
_CHUNK_PLAN: Dict[tuple, tuple] = {}
# the ints of one ChunkEntry (csrc/sharded_kernels.cu, 96 bytes)
CHUNK_ENTRY_INTS = 24
# nomad_sharded_max_blocks' kernel ids: the solo launchers run the batched
# kernels with one lane (the scan's: its grid path)
_SHARDED_IDS = {"scan_sharded": 0, "scan_batched_sharded": 0,
                "kway_sharded": 1, "kway_batched_sharded": 1,
                "chunked_batched_sharded": 2}


def _shard_layout(shards: int, n: int, tensors) -> int:
    """Checks a sharded call's layout: `shards` equal slices of the n rows,
    each at least TOP_K rows (pad_for_mesh gives 8 or more), every tensor
    on one card. Returns the rows a shard owns."""
    if shards < 1 or n % shards or n // shards < TOP_K:
        raise ValueError(f"{n} rows do not split into {shards} shards of "
                         f"at least {TOP_K} rows")
    cards = {t.get_device() for t in tensors if isinstance(t, torch.Tensor)}
    cards.discard(-1)   # the CPU
    if len(cards) > 1:
        raise NotImplementedError(
            f"shards on {len(cards)} cards: a mesh across cards needs a "
            f"per-step exchange between them (ROADMAP queue 2, row 10d)")
    return n // shards


def max_shards(kernel: str, device) -> int:
    """The most blocks the sharded `kernel` (a key of LAUNCHES ending in
    "_sharded"; for the scan, its cooperative grid path) launches with on
    `device`: blocks it holds at once a SM times its SMs. A cooperative
    launch over more blocks is refused."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (kernel, idx)
    if key not in _MAX_SHARDS:
        lib = load_library()
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = lib.nomad_sharded_max_blocks(_SHARDED_IDS[kernel],
                                              ctypes.byref(out))
        _raise_on(rc, f"{kernel} occupancy query")
        _MAX_SHARDS[key] = out.value
    return _MAX_SHARDS[key]


def scan_shared_slots(batched: bool = False) -> int:
    """The live rows whose records the scan kernel (or the batched one)
    keeps in shared memory on the current card; its sweep reads the later
    live rows' records from device memory."""
    out = ctypes.c_int(0)
    _raise_on(load_library().nomad_scan_shared_slots(int(batched),
                                                     ctypes.byref(out)),
              "scan shared-memory query")
    return out.value


def scan_sharded_info(shards: int, per: int) -> Dict[str, object]:
    """How the sharded scan runs `shards` shards of `per` rows on the
    current card, as the library decides it: its route ("cluster", a
    thread-block cluster a lane, up to a shard count fixed in
    csrc/sharded_kernels.cu; else "grid"), the live rows whose records a
    shard keeps in shared memory (its later live rows' come from device
    memory), and on the cluster path the most clusters of that size the
    card holds at once (cudaOccupancyMaxActiveClusters; 0 on the grid
    path)."""
    key = (int(shards), int(per), torch.cuda.current_device())
    if key not in _SCAN_INFO:
        out = (ctypes.c_int * 3)()
        _raise_on(load_library().nomad_scan_sharded_info(key[0], key[1],
                                                         out),
                  "sharded scan query")
        _SCAN_INFO[key] = dict(route="cluster" if out[0] else "grid",
                               slots=out[1], max_clusters=out[2])
    return dict(_SCAN_INFO[key])


def chunked_sharded_info(shards: int) -> Dict[str, object]:
    """How the sharded chunked kernels run `shards` shards on the current
    card, as the library decides it: the route ("cluster", a thread-block
    cluster a lane, up to a shard count fixed in csrc/sharded_kernels.cu;
    else "grid", one cooperative launch), and on the cluster route the most
    clusters of that size the card holds at once
    (cudaOccupancyMaxActiveClusters; 0 on the grid route)."""
    key = (int(shards), torch.cuda.current_device())
    if key not in _CHUNK_INFO:
        out = (ctypes.c_int * 2)()
        _raise_on(load_library().nomad_chunked_sharded_info(key[0], out),
                  "sharded chunked query")
        _CHUNK_INFO[key] = dict(route="cluster" if out[0] else "grid",
                                max_clusters=out[1])
    return dict(_CHUNK_INFO[key])


def _check_coresident(kernel: str, shards: int, device) -> int:
    """Raises unless one lane's `shards` blocks fit on the card at once;
    returns the most lanes of them one launch holds."""
    most = max_shards(kernel, device)
    if shards > most:
        raise ValueError(f"{shards} shards: the card holds at most {most} "
                         f"blocks of {kernel} at once")
    return most // shards


def _lane_groups(kernel: str, lanes: int, shards: int, device):
    """The [start, stop) lane ranges of a batched sharded call's
    cooperative launches."""
    per = _check_coresident(kernel, shards, device)
    return [(g, min(g + per, lanes)) for g in range(0, lanes, per)]


def _xchg(lanes: int, shards: int, kl: int, device):
    """The K-way kernels' exchange buffers for `lanes` lanes (ShardXchg in
    csrc/sharded_kernels.cu): the shards' candidate lists (kl entries a
    shard), the shards' counts, the winners' chunks and the lanes'
    flags."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.empty((lanes, 2, shards, kl), **f32),
            torch.empty((lanes, 2, shards, kl), **i32),
            torch.empty((lanes, 2, shards, D_MAX + 1), **i32),
            torch.empty((lanes, W_MAX + 1), **f32),
            torch.empty((lanes, 2, 2), **i32))


def _scan_xchg(lanes: int, shards: int, device):
    """The sharded scan's exchange on its grid path: each lane's entries by
    round parity (ScanEntry [lanes, 2, shards], 96 bytes each, in
    csrc/sharded_kernels.cu) and the lanes' flags [lanes, 2]."""
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.empty((lanes, 2, shards, 24), **i32),
            torch.empty((lanes, 2), **i32))


def select_scan_sharded(capacity, used0, feasible, ask, k_valid, tg_coll0,
                        job_count0, distinct_hosts_flag, scan_exclusive,
                        penalty, affinity_norm, desired_count, port_need,
                        free_ports, port_ok, dev_slots0, dev_score,
                        dev_fires, pre_score, sp_codes, sp_counts0,
                        sp_present0, sp_desired, sp_weight, sp_has_targets,
                        sp_valid, sum_spread_w, dp_codes, dp_counts0,
                        dp_limit, dp_valid, *, k_steps: int,
                        spread_alg: bool, s_live: int, p_live: int,
                        shards: int):
    """The scan with the node axis split into `shards` blocks, one launch
    (a thread-block cluster, or past the shards a cluster takes one
    cooperative launch: scan_sharded_info); arguments and results as
    scan_sharded_plain."""
    args = (capacity, used0, feasible, ask, k_valid, tg_coll0, job_count0,
            distinct_hosts_flag, scan_exclusive, penalty, affinity_norm,
            desired_count, port_need, free_ports, port_ok, dev_slots0,
            dev_score, dev_fires, pre_score, sp_codes, sp_counts0,
            sp_present0, sp_desired, sp_weight, sp_has_targets, sp_valid,
            sum_spread_w, dp_codes, dp_counts0, dp_limit, dp_valid)
    statics = dict(k_steps=k_steps, spread_alg=spread_alg, s_live=s_live,
                   p_live=p_live)
    per = _shard_layout(shards, capacity.shape[0], args)
    if _is_cpu(capacity):
        return scan_sharded_plain(*args, shards=shards, **statics)
    dev = capacity.device
    _check_live(s_live, p_live)
    with torch.cuda.device(dev):
        route = scan_sharded_info(shards, per)["route"]
    xchg = (None, None)
    if route == "grid":
        _check_coresident("scan_sharded", shards, dev)
        xchg = _scan_xchg(1, shards, dev)
    inputs, carry, n, d = _scan_inputs(dict(zip(SCAN_NAMES, args)))
    k = int(k_steps)
    outs = _scan_outputs((), k, d, dev)
    recs = _scan_records(1, n, dev)
    lib = load_library()
    rc = lib.nomad_select_scan_sharded(
        *[t.data_ptr() for t in inputs], recs.data_ptr(), n, d, int(k_valid),
        k, int(bool(spread_alg)), int(s_live), int(p_live),
        float(distinct_hosts_flag), float(scan_exclusive),
        float(desired_count), float(port_need), float(dev_fires),
        float(sum_spread_w), *[t.data_ptr() for t in outs],
        *[0 if t is None else t.data_ptr() for t in xchg], int(shards), per,
        _stream(dev))
    name = "scan_cluster" if route == "cluster" else "scan_sharded"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return carry, outs


def select_kway_sharded(capacity, used0, feasible, ask, k_valid, tg_coll0,
                        penalty, affinity_norm, desired_count, port_need,
                        free_ports, port_ok, dev_slots0, dev_score,
                        dev_fires, pre_score, *, max_steps: int,
                        spread_alg: bool, w: int, shards: int):
    """The K-way kernel with the node axis split into `shards` blocks, one
    cooperative launch; arguments and results as kway_sharded_plain."""
    args = (capacity, used0, feasible, ask, k_valid, tg_coll0, penalty,
            affinity_norm, desired_count, port_need, free_ports, port_ok,
            dev_slots0, dev_score, dev_fires, pre_score)
    per = _shard_layout(shards, capacity.shape[0], args)
    if _is_cpu(capacity):
        return kway_sharded_plain(*args, shards=shards, max_steps=max_steps,
                                  spread_alg=spread_alg, w=w)
    dev = capacity.device
    ptrs, carry, n, d = _local_inputs(
        capacity, used0, feasible, ask, tg_coll0, penalty, affinity_norm,
        free_ports, port_ok, dev_slots0, dev_score, pre_score)
    if not (1 <= w <= W_MAX) or n < w + 1:
        raise ValueError(f"K-way width {w} unsupported for {n} rows")
    _check_coresident("kway_sharded", shards, dev)
    packed = torch.empty((max_steps, 2 * w + TOP_K + d + 3),
                         dtype=torch.int32, device=dev)
    out_ts = torch.empty((max_steps, TOP_K), dtype=torch.float32, device=dev)
    xchg = _xchg(1, shards, w + 1, dev)
    lib = load_library()
    rc = lib.nomad_select_kway_sharded(
        *[t.data_ptr() for t in ptrs], n, d, int(k_valid), int(max_steps),
        int(bool(spread_alg)), float(desired_count), float(port_need),
        float(dev_fires), int(w), packed.data_ptr(), out_ts.data_ptr(),
        *[t.data_ptr() for t in xchg], int(shards), per, _stream(dev))
    _raise_on(rc, "kway_sharded")
    LAUNCHES["kway_sharded"] += 1
    return carry, (packed, out_ts)


def _chunked_plan(lanes: int, shards: int, device):
    """(LAUNCHES key, lane groups) of a batched sharded chunked call of
    `lanes` lanes of `shards` shards on the card `device`: every lane in one
    launch of thread-block clusters, or the cooperative grid's lane groups
    (chunked_sharded_info's route). Looked up once for each (lanes, S,
    card)."""
    key = (lanes, shards, device.index)
    plan = _CHUNK_PLAN.get(key)
    if plan is None:
        with torch.cuda.device(device):
            route = chunked_sharded_info(shards)["route"]
        plan = ("chunked_batched_cluster", [(0, lanes)]) \
            if route == "cluster" else \
            ("chunked_batched_sharded",
             _lane_groups("chunked_batched_sharded", lanes, shards, device))
        _CHUNK_PLAN[key] = plan
    return plan


def select_chunked_batched_sharded(*, max_steps: int, spread_alg: bool,
                                   shards: int, **a):
    """B chunked placements over one capacity table, each lane's node axis
    split into `shards` blocks (select_many's chunked arm on a mesh): every
    lane in one launch of thread-block clusters, or past the shards a
    cluster takes the lanes in cooperative groups (chunked_sharded_info);
    arguments and results as chunked_batched_sharded_plain."""
    a = _named(LOCAL_NAMES, a)
    per = _shard_layout(shards, a["capacity"].shape[0], a.values())
    if _is_cpu(a["capacity"]):
        return chunked_batched_sharded_plain(
            **a, max_steps=max_steps, spread_alg=spread_alg, shards=shards)
    dev = a["capacity"].device
    ptrs, carry, b, n, d, lane = _local_batched(a, copies=False)
    name, groups = _chunked_plan(b, shards, dev)
    # the grid route's exchange, one group's at a time (the groups launch
    # in order on one stream): its entries, then its flags
    most = groups[0][1] if name == "chunked_batched_sharded" else 0
    outs, xchg = _chunked_outputs(
        b, max_steps, d, dev,
        scratch=most * 2 * (shards * CHUNK_ENTRY_INTS + 1))
    entries = flags = 0
    if most:
        entries = xchg.data_ptr()
        flags = entries + most * 2 * shards * CHUNK_ENTRY_INTS * 4
    lib = load_library()
    for g0, g1 in groups:
        rc = lib.nomad_select_chunked_batched_sharded(
            ptrs[0].data_ptr(), *_at(ptrs[1:], g0), g1 - g0, n, d,
            int(max_steps), int(bool(spread_alg)), *_at(lane, g0),
            *_at(outs, g0), entries, flags, int(shards), per, _stream(dev))
        _raise_on(rc, name)
        LAUNCHES[name] += 1
    return carry, tuple(outs)


def select_kway_batched_sharded(*, max_steps: int, spread_alg: bool, w: int,
                                shards: int, **a):
    """B K-way placements over one capacity table, each lane's node axis
    split into `shards` blocks (select_many's K-way arm on a mesh);
    arguments and results as kway_batched_sharded_plain."""
    a = _named(LOCAL_NAMES, a)
    per = _shard_layout(shards, a["capacity"].shape[0], a.values())
    if _is_cpu(a["capacity"]):
        return kway_batched_sharded_plain(
            **a, max_steps=max_steps, spread_alg=spread_alg, w=w,
            shards=shards)
    dev = a["capacity"].device
    ptrs, carry, b, n, d, lane = _local_batched(a)
    if not (1 <= w <= W_MAX) or n < w + 1:
        raise ValueError(f"K-way width {w} unsupported for {n} rows")
    outs = (torch.empty((b, max_steps, 2 * w + TOP_K + d + 3),
                        dtype=torch.int32, device=dev),
            torch.empty((b, max_steps, TOP_K), dtype=torch.float32,
                        device=dev))
    groups = _lane_groups("kway_batched_sharded", b, shards, dev)
    xchg = _xchg(groups[0][1], shards, w + 1, dev)
    lib = load_library()
    for g0, g1 in groups:
        rc = lib.nomad_select_kway_batched_sharded(
            ptrs[0].data_ptr(), *_at(ptrs[1:], g0), g1 - g0, n, d,
            int(max_steps), int(bool(spread_alg)), *_at(lane, g0), int(w),
            *_at(outs, g0), *_at(xchg), int(shards), per, _stream(dev))
        _raise_on(rc, "kway_batched_sharded")
        LAUNCHES["kway_batched_sharded"] += 1
    return carry, outs


def select_scan_batched_sharded(*, k_steps: int, spread_alg: bool,
                                s_live: int, p_live: int, shards: int, **a):
    """B scans over one capacity table, each lane's node axis split into
    `shards` blocks (select_many's scan arm on a mesh): every lane in one
    launch of thread-block clusters, or past the shards a cluster takes
    the lanes in cooperative groups (scan_sharded_info); arguments and
    results as scan_batched_sharded_plain."""
    a = _named(SCAN_NAMES, a)
    statics = dict(k_steps=k_steps, spread_alg=spread_alg, s_live=s_live,
                   p_live=p_live)
    per = _shard_layout(shards, a["capacity"].shape[0], a.values())
    if _is_cpu(a["capacity"]):
        return scan_batched_sharded_plain(**a, **statics, shards=shards)
    dev = a["capacity"].device
    _check_live(s_live, p_live)
    b = _lanes(a["used0"])
    with torch.cuda.device(dev):
        route = scan_sharded_info(shards, per)["route"]
    if route == "grid":
        groups = _lane_groups("scan_batched_sharded", b, shards, dev)
        xchg = _scan_xchg(groups[0][1], shards, dev)
    else:
        groups, xchg = [(0, b)], (None, None)
    inputs, carry, n, d = _scan_inputs(a, lead=(b,))
    lane = _lane_scalars(
        b, dev, k_valid=a["k_valid"],
        distinct_hosts_flag=a["distinct_hosts_flag"],
        scan_exclusive=a["scan_exclusive"], desired_count=a["desired_count"],
        port_need=a["port_need"], dev_fires=a["dev_fires"],
        sum_spread_w=a["sum_spread_w"])
    k = int(k_steps)
    outs = _scan_outputs((b,), k, d, dev)
    # one group's records at a time: the groups launch in order on one
    # stream
    recs = _scan_records(groups[0][1] - groups[0][0], n, dev)
    name = "scan_batched_cluster" if route == "cluster" \
        else "scan_batched_sharded"
    lib = load_library()
    for g0, g1 in groups:
        rc = lib.nomad_select_scan_batched_sharded(
            inputs[0].data_ptr(), *_at(inputs[1:], g0), recs.data_ptr(),
            g1 - g0, n, d, k, int(bool(spread_alg)), int(s_live),
            int(p_live), *_at(lane, g0), *_at(outs, g0),
            *[0 if t is None else t.data_ptr() for t in xchg], int(shards),
            per, _stream(dev))
        _raise_on(rc, name)
        LAUNCHES[name] += 1
    return carry, outs
