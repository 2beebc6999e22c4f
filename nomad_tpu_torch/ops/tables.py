"""Columnar device state: the NodeTable and per-eval proposed-allocation
index.

This is the data layout that replaces the reference's one-node-at-a-time
iterator state (SURVEY.md §7.1): node capacities/usages are (N, 3)
float32 arrays [cpu_shares, memory_mb, disk_mb]; attributes resolve to
columns through ops/targets.py; allocation accounting becomes
segment-sums over node indices.

Build is O(nodes + allocs) from a state snapshot and cached per state
index epoch; the scheduler calls `NodeTable.build` once per eval at most
(and usually hits the cache across evals of the same snapshot).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from functools import lru_cache

from ..models import NetworkIndex
from ..models.job import (CONSTRAINT_DISTINCT_HOSTS,
                          CONSTRAINT_DISTINCT_PROPERTY)
from .targets import TargetColumns, constraint_mask
from ..utils.locks import make_lock

RES_DIMS = 4  # cpu_shares, memory_mb, disk_mb, network_mbits
DIM_NAMES = ("cpu", "memory", "disk", "network")

# table-maintenance accounting (governor gauges + the steady-state
# smoke test): full column builds vs incremental delta refreshes. A
# healthy steady state performs ZERO full builds — every refresh rides
# the delta path; the counters make that checkable instead of assumed.
BUILD_STATS: Dict[str, int] = {"full_builds": 0, "delta_refreshes": 0}


# usage rows memoized by the identity of the alloc's resources object:
# fleets share identical AllocatedResources shapes (and the C2M replay
# seed shares ONE flyweight row across millions of allocs), so a 2M-row
# table build becomes 2M dict hits instead of 2M ComparableResources
# constructions. Values are immutable once allocated; holding the key
# object in the memo pins its id() against reuse — which is also why
# the memos must stay SMALL: every entry pins a full resources graph
# (~2 KB) past its alloc's death. A churning server mints one fresh
# resources object per placement wave, so the old clear-at-100k policy
# accreted ~100-200 MB of dead graphs between resets (the r6 soak's
# residual RSS slope). FIFO-evict at a working-set-sized bound
# instead: misses just recompute.
# sized for the real working set: live flyweights being added/removed
# during a refresh (a handful), not history — verified by the r6 soak
# instrumentation: post-fix object growth over 2000 evals is ~1
_MEMO_MAX = 4096
_usage_memo: Dict[int, Tuple[object, Tuple[float, float, float, float]]] = {}
_port_bits_memo: Dict[int, Tuple[object, int]] = {}


def _memo_insert(memo: Dict, key: int, value) -> None:
    if len(memo) >= _MEMO_MAX:
        # dicts preserve insertion order: drop the oldest entry.
        # Concurrent scheduler lanes share these module-level memos
        # unlocked, so two threads can race to evict the same key
        # (KeyError) or mutate between iter() and next() (RuntimeError)
        # — tolerate both rather than lock the hot path; the bound
        # only overshoots by the thread count
        try:
            memo.pop(next(iter(memo)), None)
        except (StopIteration, RuntimeError):
            pass
    memo[key] = value


def resource_memo_len() -> int:
    """Governor accounting: pinned resources-graph entries across the
    identity memos."""
    return len(_usage_memo) + len(_port_bits_memo)

# inlined Allocation.terminal_status for the 2M-row build loop
from ..models.alloc import (  # noqa: E402
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST,
    ALLOC_DESIRED_EVICT, ALLOC_DESIRED_STOP)

TERMINAL_DESIRED = frozenset((ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT))
TERMINAL_CLIENT = frozenset((ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                             ALLOC_CLIENT_LOST))


@lru_cache(maxsize=4096)
def _reserved_port_bits(spec: str) -> int:
    """A node's reserved-host-port bitmask. Equivalent to
    NetworkIndex.set_node + merging used_ports (the reserved range is
    applied to every IP identically, so the merge IS the range);
    memoized because fleets share a handful of reserved-port configs
    and a 50k-node table init was re-parsing each one."""
    from ..models.networks import parse_port_ranges
    try:
        ports = parse_port_ranges(spec)
    except ValueError:
        return 0
    bits = 0
    for p in ports:
        bits |= 1 << p
    return bits


def _res_port_bits(res) -> int:
    """Port bitmask of one AllocatedResources graph (the unmemoized
    core of NodeTable._alloc_port_bits; the columnar cold build calls
    it once per unique resources-pool entry)."""
    if res is None:
        return 0
    bits = 0
    for nw in res.shared.networks:
        for ports in (nw.reserved_ports, nw.dynamic_ports):
            for p in ports:
                if p.value > 0:
                    bits |= 1 << p.value
    for task in res.tasks.values():
        for nw in task.networks:
            for ports in (nw.reserved_ports, nw.dynamic_ports):
                for p in ports:
                    if p.value > 0:
                        bits |= 1 << p.value
    return bits


def _alloc_usage(alloc) -> Tuple[float, float, float, float]:
    res = alloc.allocated_resources
    if res is not None:
        hit = _usage_memo.get(id(res))
        if hit is not None and hit[0] is res:
            return hit[1]
    c = alloc.comparable_resources()
    if c is None:
        return (0.0, 0.0, 0.0, 0.0)
    mbits = sum(nw.mbits for nw in c.networks)
    out = (float(c.cpu_shares), float(c.memory_mb), float(c.disk_mb),
           float(mbits))
    if res is not None:
        _memo_insert(_usage_memo, id(res), (res, out))
    return out


class NodeTable:
    """Columnar view of the ready node set + live allocation usage."""

    def __init__(self, nodes: List):
        self.nodes = nodes
        self.n = len(nodes)
        self.ids = [n.id for n in nodes]
        self.id_to_idx = {nid: i for i, nid in enumerate(self.ids)}
        self.cols = TargetColumns(nodes)
        # applied-alloc registry for the delta path (alloc id -> the
        # object version whose usage is currently accounted). ONE plain
        # dict SHARED across clone_for_deltas generations: the registry
        # is only ever read/written inside the serialized table-refresh
        # path (NodeTableCache.get holds its lock), never by concurrent
        # eval readers of older versions — so it needs no MVCC, and a
        # 10k-alloc refresh costs 10k dict stores instead of a
        # 2M-entry copy-on-write storm (round-5 profile: 111 ms/eval)
        self.alloc_by_id: Dict[str, object] = {}
        # attribute dictionary-encodings, valid per table version
        self._attr_codes_cache: Dict[str, Tuple[np.ndarray, List[str]]] = {}
        # ready-in-datacenters masks, valid per table version
        self._ready_dc_cache: Dict[Tuple, Tuple] = {}
        # until finalize() seals the table it is private to its builder:
        # bulk loads append rows in place and batch the registry, avoiding
        # O(allocs-per-node^2) copy-on-write during build
        self._sealed = False
        self._pending_allocs: List[Tuple[str, object]] = []
        # cross-eval static feasibility memoization, content-addressed by
        # constraint/driver/volume set (the columnar analog of computed-
        # node-class memoization, feasible.go:1026-1118); valid for this
        # table version — node attribute columns are immutable here
        self.mask_cache: Dict[Tuple, List] = {}
        # cross-eval preemption victim cache keyed on the node's
        # live-alloc ROW IDENTITY (rows are replaced copy-on-write, so
        # an unchanged row means unchanged candidates) + the asking
        # shape; entries pin their row so id() can't be recycled
        # (scheduler/preemption.py PreemptionRound)
        self.preempt_cache: Dict[Tuple, tuple] = {}
        # device-resident mirror token (ops/device_table.py): set by
        # NodeTableCache on tables it serves; a kernel dispatch uses
        # the mirror's tensors only while the token still matches the
        # mirror's version (stale snapshots fall back to dense copies)
        self.device_mirror = None
        self.device_version = -1

        self.capacity = np.zeros((self.n, RES_DIMS), dtype=np.float32)
        self.ready = np.zeros(self.n, dtype=bool)
        self.datacenters = np.empty(self.n, dtype=object)
        for i, node in enumerate(nodes):
            res = node.comparable_resources()
            reserved = node.comparable_reserved_resources()
            self.capacity[i, 0] = res.cpu_shares - reserved.cpu_shares
            self.capacity[i, 1] = res.memory_mb - reserved.memory_mb
            self.capacity[i, 2] = res.disk_mb - reserved.disk_mb
            # network bandwidth as a fit dimension: the reference checks
            # it per-device inside BinPackIterator via AssignNetwork
            # (structs/network.go:406); here total free mbits is a kernel
            # column so the scan never over-commits a node the host-side
            # assigner would then reject
            networks = (node.node_resources.networks
                        if node.node_resources else [])
            self.capacity[i, 3] = sum(nw.mbits for nw in networks)
            self.ready[i] = node.ready()
            self.datacenters[i] = node.datacenter

        # live (non-terminal) alloc usage per node + the live alloc lists
        self.base_used = np.zeros((self.n, RES_DIMS), dtype=np.float32)
        self.live_allocs: List[List] = [[] for _ in range(self.n)]
        # per-node port bitsets (python bigints) for precise conflict checks
        self._net_bits: List[int] = [0] * self.n
        self.free_ports = np.zeros(self.n, dtype=np.float32)
        self._port_col_cache: Dict[int, np.ndarray] = {}

        for i, node in enumerate(nodes):
            reserved = node.reserved_resources
            spec = reserved.reserved_host_ports if reserved else ""
            if spec:
                self._net_bits[i] = _reserved_port_bits(spec)

        self._free_ports_dirty = None  # None == all rows dirty

    @staticmethod
    def _merge_bits(idx: NetworkIndex) -> int:
        bits = 0
        for b in idx.used_ports.values():
            bits |= b
        return bits

    @classmethod
    def build(cls, snapshot, datacenters: Optional[List[str]] = None,
              include_all: bool = False) -> "NodeTable":
        """Build from a state snapshot; restrict to ready nodes in the
        given datacenters (readyNodesInDCs, scheduler/util.go:233)."""
        nodes = []
        for node in snapshot.nodes():
            if not include_all and not node.ready():
                continue
            if datacenters is not None and node.datacenter not in datacenters:
                continue
            nodes.append(node)
        nodes.sort(key=lambda n: n.id)
        BUILD_STATS["full_builds"] += 1
        t = cls(nodes)
        # bulk accumulation: per-alloc numpy scalar adds cost ~4 ops x
        # 2M rows; instead collect (node idx, usage-code) pairs in one
        # tight pass and land them with a single np.add.at (usage rows
        # dedupe heavily — fleets share identical resource shapes).
        # Float adds stay elementwise-sequential, so results match the
        # incremental path bit for bit.
        id_to_idx = t.id_to_idx
        rows = t.live_allocs
        net_bits = t._net_bits
        idx_list: List[int] = []
        code_list: List[int] = []
        code_of: Dict[Tuple, int] = {}
        lut: List[Tuple] = []
        # hot loop: at C2M scale this visits 2M allocs, so every name
        # is a local, the terminal check is inlined attr reads, and the
        # usage-code + port-bits lookups are ONE fused memo keyed by
        # the resources object's identity (bulk-loaded fleets share a
        # flyweight row, so the memo hits ~100%)
        idx_append = idx_list.append
        code_append = code_list.append
        idx_get = id_to_idx.get
        memo: Dict[int, tuple] = {}
        memo_get = memo.get
        term_desired = TERMINAL_DESIRED
        term_client = TERMINAL_CLIENT
        for alloc in snapshot.allocs():
            if alloc.desired_status in term_desired or \
                    alloc.client_status in term_client:
                continue
            i = idx_get(alloc.node_id)
            if i is None:
                continue
            res = alloc.allocated_resources
            hit = memo_get(id(res))
            if hit is None or hit[2] is not res:
                u = _alloc_usage(alloc)
                c = code_of.get(u)
                if c is None:
                    c = len(lut)
                    code_of[u] = c
                    lut.append(u)
                bits = t._alloc_port_bits(alloc)
                if res is not None:
                    memo[id(res)] = hit = (c, bits, res)
                else:
                    hit = (c, bits, None)
            c = hit[0]
            bits = hit[1]
            idx_append(i)
            code_append(c)
            rows[i].append(alloc)
            if bits:
                net_bits[i] |= bits
        # the alloc-id registry is derived from the row lists at seal
        # time (one pass there beats 2M tuple appends here)
        t._bulk_rows_pending = True
        if idx_list:
            ii = np.fromiter(idx_list, np.int32, len(idx_list))
            cc = np.fromiter(code_list, np.int32, len(code_list))
            np.add.at(t.base_used, ii,
                      np.asarray(lut, np.float32)[cc])
        t.finalize()
        return t

    @classmethod
    def build_all(cls, snapshot) -> "NodeTable":
        """Resident-table build: ALL nodes regardless of status/DC —
        readiness and datacenter become per-eval feasibility masks so
        one table serves every eval (SURVEY §7.2 step 8)."""
        return cls.build(snapshot, datacenters=None, include_all=True)

    @classmethod
    def build_from_columns(cls, snapshot, cold) -> "NodeTable":
        """Vectorized cold build from a columnar restore's decoded
        alloc columns (state/columnar.py ColdAllocColumns):
        used-resources lands as ONE np.add.at scatter over (node row,
        resources-pool code), with usage and port bits computed once
        per UNIQUE pool entry instead of once per alloc. Produces a
        table identical to build_all(snapshot) on the same state
        (liveness, row lists, port bits — parity-tested in
        tests/test_torch_cold_start.py)."""
        nodes = sorted(snapshot.nodes(), key=lambda n: n.id)
        BUILD_STATS["column_builds"] = \
            BUILD_STATS.get("column_builds", 0) + 1
        t = cls(nodes)
        n_rows = len(cold.allocs)
        if n_rows:
            idx_get = t.id_to_idx.get
            node_idx = np.fromiter(
                (idx_get(nid, -1) for nid in cold.node_ids),
                np.int32, n_rows)
            sel = cold.live & (node_idx >= 0)
            # usage LUT + port bits once per unique resources row;
            # code -1 (no resources) lands on the trailing zero row
            pool = cold.res_pool
            lut = np.zeros((len(pool) + 1, RES_DIMS), np.float32)
            pool_bits: List[int] = []
            for c, res in enumerate(pool):
                comp = res.comparable()
                lut[c] = (float(comp.cpu_shares), float(comp.memory_mb),
                          float(comp.disk_mb),
                          float(sum(nw.mbits for nw in comp.networks)))
                pool_bits.append(_res_port_bits(res))
            if cold.res_codes is not None:
                # astype always copies: frombuffer views are read-only
                codes = cold.res_codes.astype(np.int32)
                codes[codes < 0] = len(pool)
            else:
                codes = np.full(n_rows, len(pool), np.int32)
            live_rows = np.nonzero(sel)[0]
            ii = node_idx[live_rows]
            np.add.at(t.base_used, ii, lut[codes[live_rows]])
            rows = t.live_allocs
            allocs = cold.allocs
            sel_nodes = ii.tolist()
            for j, i in zip(live_rows.tolist(), sel_nodes):
                rows[i].append(allocs[j])
            if any(pool_bits):
                net_bits = t._net_bits
                npool = len(pool)
                for i, c in zip(sel_nodes, codes[live_rows].tolist()):
                    if c < npool:
                        b = pool_bits[c]
                        if b:
                            net_bits[i] |= b
            t._bulk_rows_pending = True
        t.finalize()
        return t

    def clone_for_deltas(self) -> "NodeTable":
        """Copy-on-write clone sharing the immutable node columns
        (capacity, attrs, ids) but with private usage state, so alloc
        deltas applied to the clone never mutate a version an in-flight
        eval is reading (MVCC for the device-facing cache)."""
        t = NodeTable.__new__(NodeTable)
        t.nodes = self.nodes
        t.n = self.n
        t.ids = self.ids
        t.id_to_idx = self.id_to_idx
        t.cols = self.cols
        t.capacity = self.capacity
        t.ready = self.ready
        t.datacenters = self.datacenters
        t.base_used = self.base_used.copy()
        # outer list copied; ROW lists are immutable by convention (the
        # mutators replace rows instead of appending in place), so inner
        # lists are shared between versions
        t.live_allocs = self.live_allocs[:]
        t._net_bits = self._net_bits[:]
        t.free_ports = self.free_ports.copy()
        t._port_col_cache = {}
        t._free_ports_dirty = (None if self._free_ports_dirty is None
                               else set(self._free_ports_dirty))
        self._seal()
        # shared on purpose — see the registry invariant in __init__
        t.alloc_by_id = self.alloc_by_id
        t.mask_cache = self.mask_cache  # node columns shared => masks too
        t.preempt_cache = self.preempt_cache  # row identity keys the entries
        t._attr_codes_cache = self._attr_codes_cache
        t._ready_dc_cache = self._ready_dc_cache  # status cols shared
        t._sealed = True
        t._pending_allocs = []
        t.device_mirror = None      # stamped by the cache per version
        t.device_version = -1
        return t

    @staticmethod
    def _alloc_port_bits(alloc) -> int:
        res = alloc.allocated_resources
        if res is None:
            return 0
        hit = _port_bits_memo.get(id(res))
        if hit is not None and hit[0] is res:
            return hit[1]
        bits = _res_port_bits(res)
        _memo_insert(_port_bits_memo, id(res), (res, bits))
        return bits

    def add_alloc_usage(self, i: int, alloc) -> None:
        u = _alloc_usage(alloc)
        self.base_used[i, 0] += u[0]
        self.base_used[i, 1] += u[1]
        self.base_used[i, 2] += u[2]
        self.base_used[i, 3] += u[3]
        if self._sealed:
            self.live_allocs[i] = self.live_allocs[i] + [alloc]  # row CoW
            self.alloc_by_id[alloc.id] = alloc
        else:
            self.live_allocs[i].append(alloc)
            self._pending_allocs.append((alloc.id, alloc))
        self._net_bits[i] |= self._alloc_port_bits(alloc)
        self._mark_ports_dirty(i)

    def remove_alloc_usage(self, i: int, alloc) -> None:
        """Inverse of add_alloc_usage. Port bits are simply cleared:
        host ports are exclusive per node, so no other live alloc can
        hold the same bit."""
        u = _alloc_usage(alloc)
        self.base_used[i, 0] -= u[0]
        self.base_used[i, 1] -= u[1]
        self.base_used[i, 2] -= u[2]
        self.base_used[i, 3] -= u[3]
        self._seal()
        self.live_allocs[i] = [a for a in self.live_allocs[i]
                               if a.id != alloc.id]
        self.alloc_by_id.pop(alloc.id, None)
        bits = self._alloc_port_bits(alloc)
        # keep ports that the node itself reserves (reserved_host_ports)
        node_bits = 0
        node = self.nodes[i]
        if node.reserved_resources and \
                node.reserved_resources.reserved_host_ports:
            idx = NetworkIndex()
            idx.set_node(node)
            node_bits = self._merge_bits(idx)
        self._net_bits[i] &= ~(bits & ~node_bits)
        self._mark_ports_dirty(i)

    def apply_alloc_change(self, snapshot, alloc_id: str) -> None:
        """Reconcile one alloc's accounted usage with the snapshot's
        current version (the resident-table delta path)."""
        old = self.alloc_by_id.get(alloc_id)
        new = snapshot.alloc_by_id(alloc_id)
        new_live = new is not None and not new.terminal_status()
        if old is not None:
            i = self.id_to_idx.get(old.node_id)
            if i is not None:
                self.remove_alloc_usage(i, old)
        if new_live:
            i = self.id_to_idx.get(new.node_id)
            if i is not None:
                self.add_alloc_usage(i, new)

    def apply_alloc_changes(self, snapshot, alloc_ids) -> set:
        """Batched delta replay: one vectorized usage scatter-add plus
        one row CoW per touched node, instead of per-alloc scalar numpy
        ops (a 10k-alloc plan apply replays in ~50 ms instead of
        ~700 ms — round-5 profile). The remove half of every change
        (update or disappearance) stays on the scalar path — rare in
        steady state; every alloc with a live new version (brand-new or
        updated) is re-added via the batch path.

        Returns the set of touched node row indices — the cache ships
        exactly these rows to the device mirror as a scatter delta."""
        adds = []
        touched: set = set()
        by_id_get = self.alloc_by_id.get
        idx_get = self.id_to_idx.get
        for aid in dict.fromkeys(alloc_ids):
            old = by_id_get(aid)
            new = snapshot.alloc_by_id(aid)
            new_live = new is not None and not new.terminal_status()
            if old is not None:
                i = idx_get(old.node_id)
                if i is not None:
                    self.remove_alloc_usage(i, old)
                    touched.add(i)
            if new_live:
                i = idx_get(new.node_id)
                if i is not None:
                    adds.append((i, new))
                    touched.add(i)
        if not adds:
            return touched
        self._seal()
        idxs = np.fromiter((i for i, _ in adds), np.int32, len(adds))
        usage = np.asarray([_alloc_usage(a) for _, a in adds], np.float32)
        np.add.at(self.base_used, idxs, usage)
        per_node: Dict[int, List] = {}
        for i, a in adds:
            lst = per_node.get(i)
            if lst is None:
                per_node[i] = [a]
            else:
                lst.append(a)
        by_id = self.alloc_by_id
        rows = self.live_allocs
        for i, lst in per_node.items():
            rows[i] = rows[i] + lst          # one row CoW per node
        for _i, a in adds:
            by_id[a.id] = a
        port_bits = self._alloc_port_bits
        for i, a in adds:
            bits = port_bits(a)
            if bits:
                self._net_bits[i] |= bits
                self._mark_ports_dirty(i)
        return touched

    def _mark_ports_dirty(self, i: int) -> None:
        if self._free_ports_dirty is None:
            return  # already fully dirty
        self._free_ports_dirty.add(i)

    def _seal(self) -> None:
        if self._sealed:
            return
        self._sealed = True
        if getattr(self, "_bulk_rows_pending", False):
            # cold build: derive the alloc-id registry from the row
            # lists in one pass
            self._bulk_rows_pending = False
            reg = self.alloc_by_id
            for row in self.live_allocs:
                for alloc in row:
                    reg[alloc.id] = alloc
        if self._pending_allocs:
            reg = self.alloc_by_id
            for aid, alloc in self._pending_allocs:
                reg[aid] = alloc
            self._pending_allocs = []

    def finalize(self) -> None:
        """Seal the bulk-load phase and recompute derived port columns
        for rows whose usage changed."""
        self._seal()
        dirty = self._free_ports_dirty
        if dirty is None:
            rows = range(self.n)
        elif dirty:
            rows = dirty
        else:
            return
        from ..models.networks import MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT
        span = MAX_DYNAMIC_PORT - MIN_DYNAMIC_PORT + 1
        mask = ((1 << span) - 1) << MIN_DYNAMIC_PORT
        for i in rows:
            self.free_ports[i] = span - (self._net_bits[i] & mask).bit_count()
        self._free_ports_dirty = set()
        self._port_col_cache.clear()

    # -- feasibility columns ------------------------------------------
    def port_used_col(self, port: int) -> np.ndarray:
        """bool[N]: is this host port already used on each node?"""
        col = self._port_col_cache.get(port)
        if col is None:
            bit = 1 << port
            col = np.fromiter(((b & bit) != 0 for b in self._net_bits),
                              dtype=bool, count=self.n)
            self._port_col_cache[port] = col
        return col

    def reserved_ports_ok(self, ports: List[int]) -> np.ndarray:
        """bool[N]: all requested reserved host ports free on the node."""
        ok = np.ones(self.n, dtype=bool)
        for p in ports:
            ok &= ~self.port_used_col(p)
        return ok

    def driver_mask(self, driver: str) -> np.ndarray:
        """DriverChecker (feasible.go:398): driver detected AND healthy.
        Falls back to the attribute form driver.<name>=1."""
        out = np.zeros(self.n, dtype=bool)
        for i, node in enumerate(self.nodes):
            info = node.drivers.get(driver)
            if info is not None:
                out[i] = info.detected and info.healthy
            else:
                out[i] = node.attributes.get(f"driver.{driver}", "") not in ("", "0", "false")
        return out

    def dc_mask(self, datacenters: List[str]) -> np.ndarray:
        dcs = set(datacenters)
        return np.fromiter((d in dcs for d in self.datacenters),
                           dtype=bool, count=self.n)

    def ready_in_dcs(self, datacenters: List[str]):
        """(mask bool[N], n_ready, {dc: count}) of ready nodes in the
        eval's datacenters — readyNodesInDCs (scheduler/util.go:233) as
        cached columns. Node status and DC membership are immutable per
        table version, so one 50k-row pass serves every eval against
        this version instead of a python scan per eval."""
        key = tuple(sorted(set(datacenters)))
        hit = self._ready_dc_cache.get(key)
        if hit is None:
            import collections
            mask = self.ready & self.dc_mask(list(key))
            by_dc = dict(collections.Counter(
                self.datacenters[mask].tolist()))
            hit = (mask, int(mask.sum()), by_dc)
            self._ready_dc_cache[key] = hit
        return hit

    def host_volume_mask(self, volumes: Dict[str, object]) -> np.ndarray:
        """HostVolumeChecker (feasible.go:117)."""
        out = np.ones(self.n, dtype=bool)
        wanted = [(name, req) for name, req in volumes.items()
                  if getattr(req, "type", "host") == "host"]
        if not wanted:
            return out
        for i, node in enumerate(self.nodes):
            for _, req in wanted:
                vol = node.host_volumes.get(req.source)
                if vol is None:
                    out[i] = False
                    break
                if getattr(req, "read_only", False) is False and vol.get("read_only", False):
                    out[i] = False
                    break
        return out

    def attr_codes(self, attribute: str) -> Tuple[np.ndarray, List[str]]:
        """Dictionary-encode one attribute over nodes.
        Returns (codes i32[N] with code==len(values) meaning missing,
        values list). Cached per table version (attributes immutable)."""
        hit = self._attr_codes_cache.get(attribute)
        if hit is not None:
            return hit
        vals, found = self.cols.resolve(attribute)
        mapping: Dict[str, int] = {}
        codes = np.zeros(self.n, dtype=np.int32)
        for i in range(self.n):
            if not found[i]:
                codes[i] = -1
                continue
            v = vals[i]
            c = mapping.get(v)
            if c is None:
                c = len(mapping)
                mapping[v] = c
            codes[i] = c
        values = list(mapping.keys())
        missing = len(values)
        codes[codes == -1] = missing
        self._attr_codes_cache[attribute] = (codes, values)
        return codes, values


class NodeTableCache:
    """Resident node table shared across evals (SURVEY §7.2 step 8).

    Each refresh produces a NEW table version via copy-on-write
    (clone_for_deltas), so snapshots taken earlier keep reading their
    version — the device-facing analog of the store's MVCC roots.
    Alloc changes apply as row deltas from the store changelog; node-set
    changes (rare: registration, status flips, drain) trigger a full
    rebuild because they invalidate the attribute columns.

    Each served table carries a device-mirror token
    (ops/device_table.py): the dense columns live on the card across
    evals and advance by the same row deltas as scatter-sets, so `get`
    hands the kernel a device handle instead of a rebuild + re-upload."""

    def __init__(self):
        from .device_table import DeviceNodeTable
        self._lock = make_lock()
        self._table: Optional[NodeTable] = None
        self._index = -1
        self.device = DeviceNodeTable()
        self.stats: Dict[str, int] = {"full_builds": 0,
                                      "delta_refreshes": 0}

    def _stamp(self, t: NodeTable, version: int) -> NodeTable:
        t.device_mirror = self.device
        t.device_version = version
        return t

    def prime(self, snapshot, cold=None) -> None:
        """Cold-start install: build the resident table ONCE at the
        restored index, from decoded alloc columns when available
        (NodeTable.build_from_columns, fed by StateStore.pop_cold_columns),
        so the first eval after recovery takes the delta path instead of
        paying a dense rebuild inside its latency budget. Pair with
        prefetch_device() to upload the device mirror before that eval."""
        from ..utils import stages
        t0 = time.perf_counter() if stages.enabled else 0.0
        t = (NodeTable.build_from_columns(snapshot, cold)
             if cold is not None else NodeTable.build_all(snapshot))
        with self._lock:
            self._table = self._stamp(t, self.device.note_rebuild())
            self._index = snapshot.latest_index()
            self.stats["primes"] = self.stats.get("primes", 0) + 1
        if stages.enabled:
            stages.add("table_build", time.perf_counter() - t0)

    def prefetch_device(self, device) -> None:
        """Materialize the device mirror of the primed table on `device`
        (one full upload of capacity, used and free_ports) and, while
        set_mesh holds a mesh, the mesh-resident table too (one upload at
        the mesh's padding), so the first eval after a restore dispatches
        resident. Run it on a thread beside the rest of recovery
        (PrefetchThread, whose join() re-raises what it raised). A no-op
        when nothing is primed. A failed upload raises: nothing falls back
        to shipping the dense columns. The cache's lock is held through
        the uploads, so an eval that wants the table meanwhile waits for
        them instead of seeing a half-made mirror."""
        from .select import get_shared_sharded, resolve_device
        dev = resolve_device(device)
        sh = get_shared_sharded()
        if sh is not None and not sh.mesh.on(dev):
            raise ValueError(f"the mesh lives on {sh.mesh.device}, the "
                             f"prefetch asks for {dev}")
        with self._lock:
            t = self._table
            if t is None:
                return
            if self.device.arrays_for(t, dev) is None:
                raise RuntimeError(
                    f"prefetch: the device mirror (version "
                    f"{self.device.version} on {self.device.device}) did "
                    f"not take table version {t.device_version} on {dev}")
            if sh is not None and sh.resident.arrays_for(t, dev) is None:
                raise RuntimeError(
                    f"prefetch: the mesh-resident table did not take "
                    f"table version {t.device_version} on {dev}")

    def get(self, snapshot, build: bool = True) -> Optional[NodeTable]:
        from ..utils import stages
        store = snapshot._store
        target = snapshot.latest_index()
        with self._lock:
            if self._table is not None and self._index == target:
                return self._table
            if self._table is not None and target < self._index:
                # older snapshot than the cache: serve it a private
                # build — or nothing, for callers that would rather
                # fall back than pay a full build
                return NodeTable.build_all(snapshot) if build else None
            t0 = time.perf_counter() if stages.enabled else 0.0
            if self._table is None:
                if not build:
                    return None
                self.stats["full_builds"] += 1
                self._table = self._stamp(NodeTable.build_all(snapshot),
                                          self.device.note_rebuild())
                self._index = target
                if stages.enabled:
                    stages.add("table_build", time.perf_counter() - t0)
                return self._table
            changes = store.changes_since(self._index, target)
            if changes is None or any(k == "node" for k, _ in changes):
                if not build:
                    return None
                self.stats["full_builds"] += 1
                self._table = self._stamp(NodeTable.build_all(snapshot),
                                          self.device.note_rebuild())
                self._index = target
                if stages.enabled:
                    stages.add("table_build", time.perf_counter() - t0)
                return self._table
            if changes:
                # last-write-wins dedupe, then row deltas on a fresh
                # clone; the touched rows reach the device mirror as a
                # row scatter on the current stream
                seen = dict.fromkeys(aid for _k, aid in changes)
                t = self._table.clone_for_deltas()
                rows = t.apply_alloc_changes(snapshot, seen)
                t.finalize()
                BUILD_STATS["delta_refreshes"] += 1
                self.stats["delta_refreshes"] += 1
                self._table = self._stamp(
                    t, self.device.note_delta(t, rows))
                if stages.enabled:
                    stages.add("table_build", time.perf_counter() - t0)
            self._index = target
            return self._table

    # -- device mirror accounting ---------------------------------------
    def device_delta_debt(self) -> int:
        return self.device.debt()

    def device_delta_log_len(self) -> int:
        return self.device.log_len()

    def device_mirror_bytes(self) -> int:
        """Bytes the device-resident mirror holds (0 until
        materialized)."""
        return self.device.device_bytes()

    def fold_device(self) -> dict:
        """Replace the mirror's scatter history with one contiguous
        re-upload from the current host table."""
        with self._lock:
            if self._table is None:
                return {"folded": False, "reason": "no table"}
            return self.device.fold(self._table,
                                    self._table.device_version)

    def fold_mesh(self) -> dict:
        """Replace the mesh-resident table's scatter history with one
        contiguous re-upload from the current host table (no-op without
        a mesh; see ops/select.set_mesh)."""
        from .select import get_shared_sharded
        sh = get_shared_sharded()
        with self._lock:
            t = self._table
        if sh is None:
            return {"folded": False, "reason": "no mesh"}
        if t is None:
            return {"folded": False, "reason": "no table"}
        return sh.resident.fold(t, t.device_version)

    def mesh_reshard_debt(self) -> int:
        """Rows scattered into the mesh-resident table since its last
        contiguous upload (0 without a mesh)."""
        from .select import get_shared_sharded
        sh = get_shared_sharded()
        return sh.resident.debt() if sh is not None else 0

    def preempt_cache_len(self) -> int:
        """Victim-set memo entries on the current table (the dict is
        shared across delta clones, so this IS the live memo size)."""
        with self._lock:
            t = self._table
        return len(t.preempt_cache) if t is not None else 0

    def clear_preempt_cache(self) -> dict:
        """Drop every victim memo entry (each pins a live-alloc row
        list + victim allocs); the next preemption round re-derives
        misses columnar."""
        with self._lock:
            t = self._table
        if t is None:
            return {"dropped": 0}
        dropped = len(t.preempt_cache)
        t.preempt_cache.clear()
        from ..scheduler.preemption import PREEMPT_STATS
        PREEMPT_STATS["cache_clears"] += 1
        return {"dropped": dropped}


class PrefetchThread(threading.Thread):
    """NodeTableCache.prefetch_device(device) on a thread of its own, for
    the cold-start pipeline: restore -> prime -> prefetch, overlapped with
    the rest of recovery. join() re-raises the prefetch's exception in
    the caller, so a failed upload cannot pass unseen."""

    def __init__(self, cache: NodeTableCache, device):
        super().__init__(name="node-table-prefetch", daemon=True)
        self._cache = cache
        self._device = device
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._cache.prefetch_device(self._device)
        except BaseException as exc:    # re-raised by join()
            self.error = exc

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


class ProposedIndex:
    """Per-eval view of the job's proposed allocations: existing live
    allocs of this job plus the in-flight plan, minus stops/preemptions
    (context.go:120-157 ProposedAllocs), projected onto node indices."""

    def __init__(self, table: NodeTable, job, existing_allocs: List,
                 plan=None):
        self.table = table
        self.job = job
        self.plan = plan
        n = table.n
        # per-node usage delta from the plan (stops/preemptions free
        # resources; in-flight placements consume them); touched rows
        # tracked so the overlay can ship sparsely to a device-resident
        # table (used_sparse)
        self.plan_delta = np.zeros((n, RES_DIMS), dtype=np.float32)
        self._plan_touched: set = set()
        # counts of this job's proposed allocs per node / per task group
        self.job_count = np.zeros(n, dtype=np.int32)
        self.tg_count: Dict[str, np.ndarray] = {}
        # job's proposed allocs grouped by node idx (for property counts)
        self.job_allocs_by_node: Dict[int, List] = {}
        # flat (node row, task group) per proposed alloc, in count
        # order — the scatter-ready form the vectorized property
        # counts read (ops/spread.property_counts_vec)
        self._prop_rows: List[int] = []
        self._prop_tgs: List[str] = []
        self._prop_arrays: Optional[Tuple[np.ndarray, np.ndarray]] = None

        stopped_ids = set()
        if plan is not None:
            for allocs in plan.node_update.values():
                for a in allocs:
                    stopped_ids.add(a.id)
            for allocs in plan.node_preemptions.values():
                for a in allocs:
                    stopped_ids.add(a.id)

        for a in existing_allocs:
            if a.terminal_status() or a.id in stopped_ids:
                continue
            i = table.id_to_idx.get(a.node_id)
            if i is None:
                continue
            self._count(i, a)

        if plan is not None:
            # stops/preemptions of *any* job free resources on the node
            all_stopped = {}
            for allocs in plan.node_update.values():
                for a in allocs:
                    all_stopped[a.id] = a
            for allocs in plan.node_preemptions.values():
                for a in allocs:
                    all_stopped.setdefault(a.id, a)
            for a in all_stopped.values():
                i = table.id_to_idx.get(a.node_id)
                if i is None:
                    continue
                # the stub may lack resources; look it up in live allocs
                usage = _alloc_usage(a)
                if not any(usage):
                    for live in table.live_allocs[i]:
                        if live.id == a.id:
                            usage = _alloc_usage(live)
                            break
                self.plan_delta[i] -= usage
                self._plan_touched.add(i)
            for node_id, allocs in plan.node_allocation.items():
                i = table.id_to_idx.get(node_id)
                if i is None:
                    continue
                self._plan_touched.add(i)
                for a in allocs:
                    self.plan_delta[i] += _alloc_usage(a)
                    if a.job_id == job.id and a.namespace == job.namespace:
                        self._count(i, a)

    def _count(self, i: int, alloc) -> None:
        self.job_count[i] += 1
        tg = alloc.task_group
        arr = self.tg_count.get(tg)
        if arr is None:
            arr = np.zeros(self.table.n, dtype=np.int32)
            self.tg_count[tg] = arr
        arr[i] += 1
        self.job_allocs_by_node.setdefault(i, []).append(alloc)
        self._prop_rows.append(i)
        self._prop_tgs.append(tg)

    def prop_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows i32[M], tgs str[M]) per proposed alloc — materialized
        once per eval (construction is the only mutator)."""
        hit = self._prop_arrays
        if hit is None:
            m = len(self._prop_rows)
            rows = (np.asarray(self._prop_rows, dtype=np.int32)
                    if m else np.zeros(0, dtype=np.int32))
            tgs = (np.asarray(self._prop_tgs)
                   if m else np.zeros(0, dtype="U1"))
            hit = self._prop_arrays = (rows, tgs)
        return hit

    def used(self) -> np.ndarray:
        """f32[N,3] effective usage: live + plan overlay."""
        return self.table.base_used + self.plan_delta

    def used_sparse(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows i32[M], deltas f32[M,D]) such that used() equals
        table.base_used with deltas scattered at rows — the per-eval
        plan overlay in sparse form, so a device-resident dispatch
        ships M touched rows instead of the dense (N, D) column."""
        if not self._plan_touched:
            return (np.zeros(0, np.int32),
                    np.zeros((0, RES_DIMS), np.float32))
        rows = np.fromiter(sorted(self._plan_touched), np.int32,
                           len(self._plan_touched))
        return rows, self.plan_delta[rows]

    def tg_counts(self, tg_name: str) -> np.ndarray:
        arr = self.tg_count.get(tg_name)
        if arr is None:
            return np.zeros(self.table.n, dtype=np.int32)
        return arr

    def property_counts(self, attribute: str, values: List[str],
                        tg_name: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(counts f32[C+1], present bool[C+1]) of this job's proposed
        allocs per attribute value (propertyset.go UsedCount semantics;
        tg_name restricts to one task group). Index C is the
        missing-attribute bucket."""
        c = len(values)
        # ride the table's cached dictionary encoding — a cols.resolve
        # here would re-scan all N nodes per spread per eval
        tcodes, tvals = self.table.attr_codes(attribute)
        if tvals is values:
            from .spread import property_counts_vec
            # one gather + np.add.at over the proposed rows'
            # codes replaces the per-alloc Python walk
            return property_counts_vec(self, tcodes, c, tg_name)
        counts = np.zeros(c + 1, dtype=np.float32)
        present = np.zeros(c + 1, dtype=bool)
        missing = len(tvals)
        if tvals is values:
            remap = None
        else:
            code_of = {v: i for i, v in enumerate(values)}
            remap = [code_of.get(v) for v in tvals]
        for i, allocs in self.job_allocs_by_node.items():
            tcode = int(tcodes[i])
            if tcode == missing:
                continue
            code = tcode if remap is None else remap[tcode]
            if code is None:
                continue
            for a in allocs:
                if tg_name is not None and a.task_group != tg_name:
                    continue
                counts[code] += 1
                present[code] = True
        return counts, present
