"""Device-resident node table: the dense columns kept on the card across
evals, advanced by row scatters (the counterpart of the JAX package's
nomad_tpu/ops/device_table.py).

Without it every dispatch packs the node table's dense columns and copies
them to the card. This module keeps ONE device copy per NodeTableCache:

  - `capacity` is immutable per node-set epoch: uploaded once, reused by
    every dispatch until a node registration or status change rebuilds the
    host table (epoch bump -> fresh upload).
  - `used` / `free_ports` advance by `scatter_set` of the rows a plan apply
    touched, with the host-computed values, so the mirror is bit-identical
    to the host table by construction and checkable row for row.
  - a dispatch's plan overlay (`ProposedIndex.used_sparse`) is added on the
    card by `overlay_add` over the resident `used`, so the kernel's `used0`
    never crosses the bus densely.
  - combined feasibility masks are parked on the card (`FeasMaskStore`) and
    patched by row (`feas_scatter`) after node updates and per-eval residue.

Every update is out of place, as JAX's `.at[]` is: a new tensor replaces
the old one in a new DeviceTableState, and no resident tensor is ever
written. A dispatch may be reading `used` itself (empty overlay), the
chunked and K-way loops read the same inputs across launches, and a parked
mask must stay the pre-residue mask because its token outlives the eval.

MVCC: the mirror tracks ONE version — the cache's latest. Every NodeTable
the cache serves carries a (mirror, version) token; a dispatch uses the
device tensors only while the token still matches, otherwise it packs the
dense columns (stale snapshots pay, the steady state does not). The
scatters run on the current stream, the one the select kernels use, so
each dispatch sees the delta that came before it.

The mirror materializes on the device of the first dispatch that asks for
it; a dispatch on another device is not served (ops/select.py).

Delta debt: the rows scattered since the last full upload. `fold` replaces
the scatter history with one contiguous re-upload.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.locks import make_lock
from . import kernels

# overlay/scatter row blocks above this fraction of the table fall back
# to dense shipping — scattering most of the table costs more than one
# contiguous transfer
SPARSE_MAX_FRAC = 0.5
DELTA_LOG_MAX = 256
# widest delta worth journaling row indices for: wider entries journal a
# None sentinel (a reader of the journal re-uploads past it)
JOURNAL_ROWS_MAX = 16384
FEAS_ENTRIES_MAX = 64


def _pad_n(n: int) -> int:
    # the kernel's node-axis padding rule (ops/select._pad_n), kept here
    # because ops/select imports this module
    p = 8
    while p < n:
        p *= 2
    return p


def _rows(rows) -> torch.Tensor:
    """Table rows (any int iterable or array) as the CPU int32 tensor the
    scatter wrappers check and take."""
    if isinstance(rows, np.ndarray):
        arr = rows.astype(np.int32, copy=False)
    else:
        arr = np.fromiter(rows, np.int32, len(rows))
    return torch.from_numpy(np.ascontiguousarray(arr))


class DeviceTableState:
    """Immutable snapshot of the mirror's device tensors. Readers grab one
    reference and use it without locking; updates replace the whole state
    object, never mutate it or its tensors."""

    __slots__ = ("version", "epoch", "n", "n_pad", "capacity", "used",
                 "free_ports")

    def __init__(self, version: int, epoch: int, n: int, n_pad: int,
                 capacity, used, free_ports):
        self.version = version
        self.epoch = epoch
        self.n = n
        self.n_pad = n_pad
        self.capacity = capacity
        self.used = used
        self.free_ports = free_ports


class FeasMaskStore:
    """Device-resident combined feasibility masks.

    One per mirror, keyed by the stack's feasibility cache key. Entries
    are versioned by the node-attr index (ids_epoch, version) — the
    authority on WHICH nodes the mask covers and WHEN it was last
    correct — not by the mirror's own version, which advances on alloc
    deltas that don't touch feasibility. `put` uploads the full padded
    mask on first sight, epoch change or device change, and row-scatters
    on incremental attribute updates; `resident` hands the tensor to the
    dispatch only when the request's token still names the entry exactly."""

    def __init__(self):
        self._l = make_lock()
        # feas_key -> {"arr", "n", "n_pad", "epoch", "version", "device"}
        self._entries: Dict[object, dict] = {}
        # rows scattered atop parked masks by per-eval residue since the
        # last fold/reset; fold() zeroes it
        self.residue_debt = 0
        self.stats: Dict[str, int] = {
            "uploads": 0, "scatters": 0, "patch_rows": 0, "hits": 0,
            "stale": 0, "residue_scatters": 0, "residue_rows": 0,
            "folds": 0,
        }

    def peek(self, key) -> Optional[Tuple[int, int]]:
        """(ids_epoch, version) of the resident entry, or None. The
        compiler uses this to journal only the rows changed since."""
        with self._l:
            e = self._entries.get(key)
            return None if e is None else (e["epoch"], e["version"])

    def put(self, key, mask: np.ndarray, epoch: int, version: int,
            rows, device) -> Optional[Tuple]:
        """Park `mask` (table-space bool[n]) on `device` and return the
        token (key, epoch, version, n) a request attaches to dispatch
        against it, or None when a concurrent put moved the entry. `rows`
        — table rows changed since this entry's previous version within
        the same epoch — selects the row-scatter patch over the full
        upload; None forces the upload."""
        n = len(mask)
        n_pad = _pad_n(n)
        tok = (key, epoch, version, n)
        # snapshot the decision inputs under the lock; the device work
        # runs OUTSIDE it — parking a mask must not serialize concurrent
        # readers behind a dispatch
        with self._l:
            e = self._entries.get(key)
            if e is not None and e["epoch"] == epoch \
                    and e["version"] == version and e["n"] == n \
                    and e["device"] == device:
                return tok  # already current
            patchable = (
                e is not None and e["epoch"] == epoch
                and e["n"] == n and e["device"] == device
                and rows is not None
                and len(rows) <= n * SPARSE_MAX_FRAC)
            base = e["arr"] if patchable else None
            base_ver = e["version"] if patchable else None
        kind = "none"
        if patchable and len(rows) == 0:
            # version advanced but no row's verdict context changed:
            # stamp the entry, no device work
            arr = base
        elif patchable:
            idx = _rows(rows)
            vals = torch.from_numpy(mask[idx.numpy()].astype(bool))
            arr = kernels.feas_scatter(base, idx, vals)
            kind = "scatters"
        else:
            padded = torch.zeros(n_pad, dtype=torch.bool)
            padded[:n] = torch.from_numpy(np.asarray(mask, dtype=bool))
            arr = padded.to(device)
            kind = "uploads"
        with self._l:
            if patchable:
                # a concurrent put moved the entry while we patched its
                # snapshot: our base is stale, drop this park (the next
                # eval re-parks from its own fresher mask)
                e2 = self._entries.get(key)
                if e2 is None or e2["version"] != base_ver \
                        or e2["epoch"] != epoch:
                    return None
            if kind != "none":
                self.stats[kind] += 1
            if kind == "scatters":
                self.stats["patch_rows"] += len(rows)
            self._entries[key] = {"arr": arr, "n": n, "n_pad": n_pad,
                                  "epoch": epoch, "version": version,
                                  "device": device}
            while len(self._entries) > FEAS_ENTRIES_MAX:
                self._entries.pop(next(iter(self._entries)))
            return tok

    def resident(self, token, n_pad: int, device):
        """The device tensor for `token`, or None when the entry moved on,
        the kernel's padding disagrees, or it lies on another device — the
        caller then packs the host mask."""
        if token is None:
            return None
        key, epoch, version, n = token
        with self._l:
            e = self._entries.get(key)
            if e is None or e["epoch"] != epoch \
                    or e["version"] != version or e["n_pad"] != n_pad \
                    or e["device"] != device:
                self.stats["stale"] += 1
                return None
            self.stats["hits"] += 1
            return e["arr"]

    def apply_residue(self, arr, rows: np.ndarray, vals: np.ndarray):
        """Reproduce the host mask's residue mutations (CSI claims, quota
        caps, preferred-node restriction) on the parked device mask with
        ONE row scatter — per eval, never stored, so the resident entry
        itself stays the pre-residue combined mask and the token keeps
        surviving. Returns the scattered tensor."""
        m = len(rows)
        if m == 0:
            return arr
        out = kernels.feas_scatter(
            arr, _rows(rows),
            torch.from_numpy(np.asarray(vals, dtype=bool).copy()))
        with self._l:
            self.stats["residue_scatters"] += 1
            self.stats["residue_rows"] += m
            self.residue_debt += m
        return out

    def fold(self) -> dict:
        """Drop the parked entries and zero the residue debt — the next
        eval re-parks a fresh combined mask instead of compounding
        scatter work atop a long-lived base."""
        with self._l:
            dropped = len(self._entries)
            self._entries.clear()
            debt = self.residue_debt
            self.residue_debt = 0
            self.stats["folds"] += 1
        return {"feas_entries_dropped": dropped,
                "residue_debt_cleared": debt}

    def debt(self) -> int:
        with self._l:
            return self.residue_debt

    def snapshot(self) -> dict:
        with self._l:
            return {"entries": len(self._entries),
                    "residue_debt": self.residue_debt, **self.stats}


class DeviceNodeTable:
    """The device-resident mirror one NodeTableCache owns.

    Lazy: holds no device memory until a kernel dispatch first asks for
    tensors via `arrays_for`, and then lives on that dispatch's device.
    Until then, `note_delta`/`note_rebuild` just advance the version
    counter so a later materialization starts from the right table."""

    def __init__(self):
        self._l = make_lock()
        self._state: Optional[DeviceTableState] = None
        self._device = None         # the materialized state's device
        self.version = 0            # latest host table version (token)
        self.epoch = 0              # node-set generation
        self.delta_debt = 0         # rows scattered since last upload
        # journal: (version, touched-row indices) per delta, recorded
        # whether or not the mirror is materialized, so a reader that fell
        # behind can catch up by scatter-setting the union of journaled
        # rows from the latest host table. Bounded ring.
        self.delta_log: List[Tuple[int, Optional[np.ndarray]]] = []
        self.stats: Dict[str, int] = {
            "uploads": 0, "scatters": 0, "scatter_rows": 0, "folds": 0,
            "overlay_dispatches": 0, "overlay_rows": 0, "stale_misses": 0,
        }
        # device-resident compiled feasibility masks: keyed by the stack's
        # feas cache key, versioned by the attr index — deliberately NOT
        # by this mirror's version/epoch, because node attribute changes
        # and alloc deltas advance independently
        self.feas = FeasMaskStore()

    @property
    def device(self):
        """The device the mirror lives on, or None while it is lazy."""
        return self._device

    # -- cache-side bookkeeping (called under the cache's lock) --------
    def note_rebuild(self) -> int:
        """A node-set rebuild invalidated the columns: bump the epoch,
        drop the device tensors (re-materialized lazily from the new
        table), return the new version token."""
        with self._l:
            self.epoch += 1
            self.version += 1
            self._state = None
            self._device = None
            self.delta_debt = 0
            self.delta_log.clear()
            return self.version

    def note_delta(self, table, rows) -> int:
        """Advance the mirror past an alloc-delta refresh: `rows` are the
        host-table indices the refresh touched. When materialized, scatter
        them on the current stream; otherwise only the version advances.
        Returns the new version token."""
        with self._l:
            self.version += 1
            self.delta_log.append(
                (self.version,
                 np.fromiter(rows, np.int32, len(rows))
                 if len(rows) <= JOURNAL_ROWS_MAX else None))
            if len(self.delta_log) > DELTA_LOG_MAX:
                del self.delta_log[:len(self.delta_log) - DELTA_LOG_MAX]
            st = self._state
            if st is None:
                return self.version
            if rows:
                st = self._scatter(st, table, rows)
            self._state = DeviceTableState(self.version, self.epoch, st.n,
                                           st.n_pad, st.capacity, st.used,
                                           st.free_ports)
            return self.version

    def deltas_since(self, version: int) -> Optional[List[Tuple[int,
                                                                np.ndarray]]]:
        """The journal entries bridging (version, self.version], or None
        when the journal can't (caller re-uploads): the gap predates the
        retained ring, a rebuild cleared the log, or a bridging entry was
        too wide to journal (sentinel)."""
        with self._l:
            if version > self.version:
                return None
            if version == self.version:
                return []
            need = self.version - version
            ent = [e for e in self.delta_log if e[0] > version]
            if len(ent) != need or any(r is None for _v, r in ent):
                return None
            return ent

    def _scatter(self, st: DeviceTableState, table,
                 rows) -> DeviceTableState:
        m = len(rows)
        if m > st.n * SPARSE_MAX_FRAC:
            # wide delta: one contiguous upload beats a scatter of most
            # of the table (counts as a fold, resets the debt)
            return self._upload(table, st.epoch, self._device, fold=True)
        from ..utils import stages

        t0 = _time.perf_counter() if stages.enabled else 0.0
        # the host table's rows and values go to the wrapper as numpy
        # arrays, packed from there straight into its upload
        idx = _rows(rows).numpy()
        used, ports = kernels.scatter_set(
            st.used, st.free_ports, idx,
            table.base_used[idx].astype(np.float32, copy=False),
            table.free_ports[idx].astype(np.float32, copy=False))
        if stages.enabled:
            stages.add("h2d", _time.perf_counter() - t0)
        self.delta_debt += m
        self.stats["scatters"] += 1
        self.stats["scatter_rows"] += m
        return DeviceTableState(st.version, st.epoch, st.n, st.n_pad,
                                st.capacity, used, ports)

    def _upload(self, table, epoch: int, device,
                fold: bool) -> DeviceTableState:
        from ..utils import stages

        t0 = _time.perf_counter() if stages.enabled else 0.0
        n = table.n
        n_pad = _pad_n(n)
        d = table.base_used.shape[1]
        cap = np.zeros((n_pad, d), np.float32)
        cap[:n] = table.capacity
        used = np.zeros((n_pad, d), np.float32)
        used[:n] = table.base_used
        ports = np.zeros(n_pad, np.float32)
        ports[:n] = table.free_ports
        st = DeviceTableState(self.version, epoch, n, n_pad,
                              torch.from_numpy(cap).to(device),
                              torch.from_numpy(used).to(device),
                              torch.from_numpy(ports).to(device))
        if stages.enabled:
            stages.add("h2d", _time.perf_counter() - t0)
        # the journal survives uploads on purpose: it records the deltas,
        # not this mirror's scatter history — only a rebuild clears it
        self.delta_debt = 0
        self.stats["folds" if fold else "uploads"] += 1
        return st

    def fold(self, table, version: Optional[int] = None) -> dict:
        """Replace the mirror's scatter history with one contiguous
        re-upload from the current host table. `table` must be the version
        the mirror tracks (the cache passes its latest). No-op when never
        materialized."""
        with self._l:
            if version is not None and version != self.version:
                return {"folded": False, "reason": "stale table"}
            debt = self.delta_debt
            if self._state is None:
                self.delta_debt = 0
                return {"folded": False, "reason": "not materialized"}
            self._state = self._upload(table, self.epoch, self._device,
                                       fold=True)
            return {"folded": True, "debt_cleared": debt}

    # -- kernel-side access --------------------------------------------
    def arrays_for(self, table, device) -> Optional[DeviceTableState]:
        """The device tensors for `table`, or None when the mirror has
        moved past it (stale snapshot -> dense fallback) or lives on
        another device. The first valid call materializes the mirror on
        `device` from this table (full upload)."""
        token = getattr(table, "device_version", -1)
        with self._l:
            if token != self.version:
                self.stats["stale_misses"] += 1
                return None
            st = self._state
            if st is None:
                st = self._upload(table, self.epoch, device, fold=False)
                self._state = st
                self._device = device
            elif self._device != device:
                self.stats["stale_misses"] += 1
                return None
            return st

    def overlay_used(self, st: DeviceTableState, rows: np.ndarray,
                     deltas: np.ndarray):
        """used0 = resident used + the sparse per-eval plan overlay,
        computed on the card. Returns a tensor, or None when the overlay
        is too dense to be worth scattering."""
        m = len(rows)
        if m == 0:
            return st.used
        if m > st.n * SPARSE_MAX_FRAC:
            return None
        self.stats["overlay_dispatches"] += 1
        self.stats["overlay_rows"] += m
        return kernels.overlay_add(
            st.used, _rows(rows),
            torch.from_numpy(np.ascontiguousarray(deltas, np.float32)))

    # -- accounting ----------------------------------------------------
    def debt(self) -> int:
        return self.delta_debt

    def log_len(self) -> int:
        return len(self.delta_log)

    def device_bytes(self) -> int:
        """Bytes the materialized mirror pins on the device (capacity +
        used + free_ports; 0 while lazy)."""
        with self._l:
            st = self._state
        if st is None:
            return 0
        return sum(t.nbytes for t in (st.capacity, st.used, st.free_ports))

    def snapshot(self) -> dict:
        with self._l:
            return {"version": self.version, "epoch": self.epoch,
                    "materialized": self._state is not None,
                    "delta_debt": self.delta_debt,
                    "delta_log": len(self.delta_log), **self.stats}


def resident_request_args(mirror, req, n_pad: int, device,
                          metric_prefix: str) -> Optional[dict]:
    """Resident replacements for a request's table-shaped kernel inputs
    (capacity, used0, free_ports, and the parked feasibility mask) — the
    one place that owns the MVCC gate, the overlay fallback and the
    free_ports identity rule. Returns None for stale tables, shape
    mismatches, or overlays too wide to scatter, counting
    `<metric_prefix>_fallback` / `<metric_prefix>_dispatch`."""
    t = req.table
    if t is None or req.used_base_rows is None:
        return None
    from ..utils import metrics
    state = mirror.arrays_for(t, device)
    if state is None or state.n_pad != n_pad:
        metrics.incr_counter(metric_prefix + "_fallback")
        return None
    used0 = mirror.overlay_used(state, req.used_base_rows,
                                req.used_base_deltas)
    if used0 is None:
        metrics.incr_counter(metric_prefix + "_fallback")
        return None
    out = {"capacity": state.capacity, "used0": used0}
    if req.free_ports is not None and \
            req.free_ports is getattr(t, "free_ports", None):
        out["free_ports"] = state.free_ports
    tok = req.feas_token
    # the mesh-resident table parks no masks (its `feas` is None)
    if tok is not None and mirror.feas is not None:
        arr = mirror.feas.resident(tok, n_pad, device)
        if arr is not None:
            res = req.feas_residue
            if res is not None and len(res[0]):
                # the token survived residue mutations — re-apply them on
                # the card as one sparse scatter instead of re-uploading
                # the combined mask
                arr = mirror.feas.apply_residue(arr, res[0], res[1])
                metrics.incr_counter(metric_prefix + "_feas_residue")
            out["feasible"] = arr
            metrics.incr_counter(metric_prefix + "_feas_resident")
    metrics.incr_counter(metric_prefix + "_dispatch")
    return out
