"""Mesh-resident node table: the hot columns of the node table (capacity,
used, free_ports) kept on the mesh's card across evals, laid out for the
node-sharded kernels (the counterpart of the JAX package's
nomad_tpu/parallel/sharded_table.py).

The single-card mirror (ops/device_table.py DeviceNodeTable) pads the
table to a power of two; the mesh pads it to `pad_for_mesh` rows, S equal
shards of at least 8 rows, so the mesh keeps columns of its own and
advances them with the same delta protocol:

  - cold start, node-set rebuild or a journal it cannot bridge: ONE
    contiguous upload per column, counted as a `reshard_upload`;
  - alloc deltas: the cache's DeviceNodeTable journals every refresh's
    touched rows (`delta_log`, always on in this package); this table
    catches up from its version to the request table's by setting the
    journaled rows from the CURRENT host columns with the `scatter_set`
    kernel. Rows are global and shard s owns rows [s*per, (s+1)*per); on
    one card the columns are one contiguous tensor, so each shard's rows
    are set where it owns them, as XLA's partitioned scatter sets them.
    Setting host-latest values makes replay order-free and bit-identical
    to a fresh upload;
  - a dispatch's plan overlay is added with the `overlay_add` kernel over
    the resident used column (rows distinct, checked on the host).

Every update is out of place, as on the single-card mirror: a dispatch may
still read the older tensors.

MVCC: the (mirror identity, version) token of every NodeTable gates reuse
as on the single card: a snapshot older than the resident state gets
None (its dispatch packs the dense columns), a journal gap or a new cache
generation pays one contiguous re-upload.

Fold: the rows scattered since the last contiguous upload are the debt;
`fold` replaces the scatter history with one re-upload.

Unlike the JAX package's table this one is always on (no
NOMAD_TPU_MESH_RESIDENT switch or configure hook), a failed kernel launch
propagates instead of turning into a stale miss, and scatters run over
exactly the m touched rows (no row-bucket padding). It parks no
feasibility masks (`feas` is None): a mesh dispatch packs its mask, as the
JAX package's does.
"""

from __future__ import annotations

import time as _time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.device_table import DeviceTableState, SPARSE_MAX_FRAC, _rows
from ..utils.locks import make_lock


def pad_for_mesh(mesh, n: int) -> int:
    """Pad N so it divides evenly over the mesh's shards, at least 8 rows a
    shard: the one padding rule of the sharded dispatcher and this
    resident table (their shapes must agree or residency never hits)."""
    return mesh.per(n) * mesh.shards


class ShardedDeviceNodeTable:
    """The mesh-resident table one process-wide ShardedSelect owns.

    Tracks ONE (host mirror, version) pair, the latest NodeTableCache
    generation it served. `arrays_for(table)` returns the mesh's columns
    for that table, advancing by journal replay when the table is ahead,
    or None for stale snapshots (dense fallback)."""

    # a mesh dispatch packs its feasibility mask (resident_request_args
    # reads no parked mask from this table)
    feas = None

    def __init__(self, mesh):
        self.mesh = mesh
        self._l = make_lock()
        self._state: Optional[DeviceTableState] = None
        self._mirror = None         # the host cache's DeviceNodeTable
        self._version = -1
        self._epoch = -1
        self.delta_debt = 0         # rows scattered since last upload
        self.stats: Dict[str, int] = {
            "reshard_uploads": 0, "reshard_bytes": 0,
            "delta_scatters": 0, "delta_rows": 0,
            "resident_hits": 0, "stale_misses": 0, "journal_gaps": 0,
            "overlay_dispatches": 0, "folds": 0,
        }

    # -- kernel-side access --------------------------------------------
    def arrays_for(self, table, device=None) -> Optional[DeviceTableState]:
        """The mesh's columns for `table`, or None when this table is a
        stale snapshot (the resident state moved past it) or `device` is
        not the mesh's. A table ahead of the resident version catches the
        table up by journal replay; a gap or a new cache generation pays
        one contiguous re-upload."""
        if device is not None and not self.mesh.on(device):
            return None
        mirror = getattr(table, "device_mirror", None)
        token = getattr(table, "device_version", -1)
        if mirror is None or token < 0:
            return None
        with self._l:
            st = self._state
            if st is None or self._mirror is not mirror \
                    or self._epoch != mirror.epoch:
                return self._upload_locked(table, mirror, token)
            if token == self._version:
                self.stats["resident_hits"] += 1
                return st
            if token < self._version:
                # older snapshot than the resident state: MVCC says it
                # must not read newer columns
                self.stats["stale_misses"] += 1
                return None
            entries = mirror.deltas_since(self._version)
            if entries is None:
                self.stats["journal_gaps"] += 1
                return self._upload_locked(table, mirror, token)
            # drop journal entries past the request's version: the
            # mirror may already be ahead of this table's snapshot
            rows_l = [r for v, r in entries if v <= token and len(r)]
            rows = (np.unique(np.concatenate(rows_l)) if rows_l
                    else np.zeros(0, np.int32))
            if len(rows) > st.n * SPARSE_MAX_FRAC:
                # wide delta: one contiguous upload beats scattering
                # most of the table
                return self._upload_locked(table, mirror, token)
            if len(rows):
                st = self._scatter_locked(st, table, rows)
                self._state = st
            self._version = token
            self.stats["resident_hits"] += 1
            return self._state

    def _scatter_locked(self, st: DeviceTableState, table,
                        rows: np.ndarray) -> DeviceTableState:
        m = len(rows)
        # the host table's rows and values go to the wrapper as numpy
        # arrays, packed from there straight into its upload
        idx = _rows(rows).numpy()
        used, ports = kernels.scatter_set(
            st.used, st.free_ports, idx,
            table.base_used[idx].astype(np.float32, copy=False),
            table.free_ports[idx].astype(np.float32, copy=False))
        self.delta_debt += m
        self.stats["delta_scatters"] += 1
        self.stats["delta_rows"] += m
        return DeviceTableState(st.version, st.epoch, st.n, st.n_pad,
                                st.capacity, used, ports)

    def _upload_locked(self, table, mirror, token) -> DeviceTableState:
        """One contiguous upload per column (capacity, used, free_ports)
        at the mesh's padding: the cold-start / catch-up-miss path."""
        from ..utils import stages
        t0 = _time.perf_counter() if stages.enabled else 0.0
        n = table.n
        n_pad = pad_for_mesh(self.mesh, n)
        d = table.base_used.shape[1]
        cap = np.zeros((n_pad, d), np.float32)
        cap[:n] = table.capacity
        used = np.zeros((n_pad, d), np.float32)
        used[:n] = table.base_used
        ports = np.zeros(n_pad, np.float32)
        ports[:n] = table.free_ports
        dev = self.mesh.device
        st = DeviceTableState(token, mirror.epoch, n, n_pad,
                              torch.from_numpy(cap).to(dev),
                              torch.from_numpy(used).to(dev),
                              torch.from_numpy(ports).to(dev))
        if stages.enabled:
            stages.add("h2d", _time.perf_counter() - t0)
        self._state = st
        self._mirror = mirror
        self._version = token
        self._epoch = mirror.epoch
        self.delta_debt = 0
        self.stats["reshard_uploads"] += 1
        self.stats["reshard_bytes"] += cap.nbytes + used.nbytes \
            + ports.nbytes
        return st

    def overlay_used(self, st: DeviceTableState, rows, deltas):
        """used0 = resident used + the sparse per-eval plan overlay,
        computed on the mesh's card. Returns a tensor, st.used itself for
        an empty overlay, or None when the overlay is too dense to be
        worth scattering."""
        m = len(rows)
        if m == 0:
            return st.used
        if m > st.n * SPARSE_MAX_FRAC:
            return None
        self.stats["overlay_dispatches"] += 1
        return kernels.overlay_add(
            st.used, _rows(rows),
            torch.from_numpy(np.ascontiguousarray(deltas, np.float32)))

    # -- accounting ----------------------------------------------------
    def fold(self, table, version: Optional[int] = None) -> dict:
        """Replace the scatter history with one contiguous re-upload from
        the current host table."""
        with self._l:
            mirror = getattr(table, "device_mirror", None)
            token = getattr(table, "device_version", -1)
            if version is not None and version != token:
                return {"folded": False, "reason": "stale table"}
            if self._state is None or mirror is None:
                self.delta_debt = 0
                return {"folded": False, "reason": "not materialized"}
            if token < self._version:
                return {"folded": False, "reason": "stale table"}
            debt = self.delta_debt
            self._upload_locked(table, mirror, token)
            self.stats["folds"] += 1
            return {"folded": True, "debt_cleared": debt}

    def debt(self) -> int:
        return self.delta_debt

    def device_bytes(self) -> int:
        """Bytes the resident columns pin on the mesh's card."""
        with self._l:
            st = self._state
        if st is None:
            return 0
        return sum(t.nbytes for t in (st.capacity, st.used, st.free_ports))

    def snapshot(self) -> dict:
        with self._l:
            return {"materialized": self._state is not None,
                    "version": self._version,
                    "reshard_debt": self.delta_debt, **self.stats}
