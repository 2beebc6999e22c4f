"""MVCC in-memory state store with O(1) immutable snapshots and blocking
watches — the go-memdb equivalent.

Reference semantics: nomad/state/state_store.go (StateStore:64, 21-table
schema at nomad/state/schema.go:36-62, SnapshotMinIndex:186) and the FSM
mutations in nomad/fsm.go. Tables are persistent HAMTs: a write
transaction path-copies the touched tables and atomically publishes a new
root; readers (schedulers) hold their root forever at O(1) cost — this is
what makes optimistic concurrent scheduling cheap.

Secondary indexes (allocs by node/job/eval, evals by job) are nested
HAMTs maintained in the same transaction.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..models import (
    Allocation, Deployment, Evaluation, Job, Node, ScalingPolicy,
    SchedulerConfiguration,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT,
    EVAL_STATUS_BLOCKED,
    JOB_STATUS_DEAD, JOB_STATUS_PENDING, JOB_STATUS_RUNNING,
    NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE,
)
from ..models.deployment import DeploymentStatusUpdate
from ..utils.hamt import EditContext, Hamt  # noqa: F401 (substrate option)
from ..utils.layermap import LayerMap
from ..utils.locks import make_condition, make_rlock

# Table substrate: LayerMap implements the same persistent-map
# contract as Hamt (O(1) snapshots, transient edit sessions) on
# layered CPython dicts — 10-100x faster on the store's real write
# and scan workloads (see utils/layermap.py).
_Table = LayerMap

LOG = logging.getLogger("nomad_tpu.state")


@dataclass
class JobSummary:
    """Per-TG alloc status counts (structs.go JobSummary)."""
    job_id: str = ""
    namespace: str = "default"
    summary: Dict[str, Dict[str, int]] = field(default_factory=dict)
    children_pending: int = 0
    children_running: int = 0
    children_dead: int = 0
    create_index: int = 0
    modify_index: int = 0


class _Root:
    """One immutable version of the whole database.

    `edit()` opens a transient write transaction (utils/hamt.py
    EditContext): all table writes through the returned root share one
    edit context, so a transaction touching k keys path-copies each trie
    node at most once. `frozen()` seals the transaction before publish —
    published roots are immutable again."""

    __slots__ = ("tables", "indexes", "_ctx")

    def __init__(self, tables: Hamt, indexes: Hamt, _ctx=None):
        self.tables = tables      # name -> Hamt(primary key -> object)
        self.indexes = indexes    # table name -> last modify index
        self._ctx = _ctx

    def table(self, name: str) -> Hamt:
        # always normalize the edit context: a stored table may carry the
        # ctx of the transaction that wrote it, and writing through a
        # stale ctx would mutate published nodes
        t = self.tables.get(name) or _Table()
        return t.with_ctx(self._ctx)

    def with_table(self, name: str, t: Hamt) -> "_Root":
        return _Root(self.tables.set(name, t), self.indexes, self._ctx)

    def with_index(self, name: str, idx: int) -> "_Root":
        return _Root(self.tables, self.indexes.set(name, idx), self._ctx)

    def edit(self) -> "_Root":
        ctx = EditContext()
        return _Root(self.tables.with_ctx(ctx), self.indexes.with_ctx(ctx),
                     ctx)

    def frozen(self) -> "_Root":
        if self._ctx is None:
            return self
        # deep-freeze: the VALUES of `tables` are per-table Hamts that
        # still carry this transaction's EditContext; leaving it attached
        # would pin every trie node the transaction created (via
        # ctx.keepalive) for as long as the table value survives, and
        # force table() to re-wrap on every read
        tables = self.tables.frozen()
        for name, t in tables.items():
            if t._ctx is not None:
                tables = tables.set(name, t.frozen())
        return _Root(tables, self.indexes.frozen())


TABLES = (
    "nodes", "jobs", "job_versions", "evals", "allocs", "deployments",
    "job_summaries", "scheduler_config", "periodic_launches",
    "acl_policies", "acl_tokens", "csi_volumes", "service_registrations",
    "vault_accessors",
    # secondary indexes
    "allocs_by_node", "allocs_by_job", "allocs_by_eval", "evals_by_job",
    "deployments_by_job", "services_by_name", "services_by_alloc",
    "vault_accessors_by_alloc", "vault_accessors_by_token",
)

JOB_TRACKED_VERSIONS = 6  # structs.go JobTrackedVersions


def _client_status_bucket(a: Optional["Allocation"]) -> Optional[str]:
    """JobSummary bucket for an alloc's client status
    (state_store.go updateSummaryWithAlloc)."""
    if a is None:
        return None
    cs = a.client_status
    if cs == ALLOC_CLIENT_PENDING:
        return "starting"
    if cs == ALLOC_CLIENT_RUNNING:
        return "running"
    if cs == ALLOC_CLIENT_COMPLETE:
        return "complete"
    if cs == ALLOC_CLIENT_FAILED:
        return "failed"
    if cs == ALLOC_CLIENT_LOST:
        return "lost"
    return None


class StateSnapshot:
    """A read-only view at one index. Safe to hold across scheduler runs."""

    def __init__(self, root: _Root, store: "StateStore" = None):
        self._root = root
        self._store = store

    def job_alloc_columns(self, namespace: str, job_id: str):
        """Columnar alloc index for one job at this snapshot's alloc
        index (state/alloc_index.py JobAllocColumns), or None when the
        engine is off or the snapshot is detached from a store."""
        if self._store is None:
            return None
        return self._store.alloc_index.get(self, namespace, job_id)

    def node_table(self, build: bool = True):
        """The columnar node table for this snapshot. Snapshots taken
        from a live store share its resident delta-maintained table
        (ops/tables.py NodeTableCache — SURVEY §7.2 step 8: no per-eval
        rebuild); detached snapshots build fresh. `build=False` returns
        None instead of paying a full private build when the resident
        table has already advanced past this snapshot (callers with a
        cheap fallback, e.g. the plan applier's scalar verify)."""
        from ..ops.tables import NodeTable
        if self._store is None:
            return NodeTable.build_all(self) if build else None
        return self._store.table_cache.get(self, build=build)

    # -- index bookkeeping --------------------------------------------
    def index(self, table: str) -> int:
        return self._root.indexes.get(table, 0)

    def latest_index(self) -> int:
        return max([0] + list(self._root.indexes.values()))

    # -- nodes ---------------------------------------------------------
    def csi_volume(self, namespace: str, volume_id: str):
        return self._root.table("csi_volumes").get((namespace, volume_id))

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._root.table("nodes").get(node_id)

    def nodes(self) -> List[Node]:
        return list(self._root.table("nodes").values())

    def node_count(self) -> int:
        """O(1) node-table cardinality (the worker's batching heuristic
        reads this per drained batch)."""
        return len(self._root.table("nodes"))

    def node_by_prefix(self, prefix: str) -> List[Node]:
        return [n for n in self.nodes() if n.id.startswith(prefix)]

    # -- jobs ----------------------------------------------------------
    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._root.table("jobs").get((namespace, job_id))

    def jobs(self, namespace: Optional[str] = None) -> List[Job]:
        out = self._root.table("jobs").values()
        if namespace is None:
            return list(out)
        return [j for j in out if j.namespace == namespace]

    def job_versions(self, namespace: str, job_id: str) -> List[Job]:
        versions = self._root.table("job_versions").get((namespace, job_id))
        if not versions:
            return []
        return sorted(versions.values(), key=lambda j: -j.version)

    def job_by_id_and_version(self, namespace: str, job_id: str,
                              version: int) -> Optional[Job]:
        versions = self._root.table("job_versions").get((namespace, job_id))
        if not versions:
            return None
        return versions.get(version)

    def job_summary(self, namespace: str, job_id: str) -> Optional[JobSummary]:
        return self._root.table("job_summaries").get((namespace, job_id))

    # -- evals ---------------------------------------------------------
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._root.table("evals").get(eval_id)

    def evals(self) -> List[Evaluation]:
        return list(self._root.table("evals").values())

    def evals_by_job(self, namespace: str, job_id: str) -> List[Evaluation]:
        ids = self._root.table("evals_by_job").get((namespace, job_id))
        if not ids:
            return []
        table = self._root.table("evals")
        return [table[i] for i in ids.keys()]

    # -- allocs --------------------------------------------------------
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._root.table("allocs").get(alloc_id)

    def allocs(self) -> List[Allocation]:
        return list(self._root.table("allocs").values())

    def allocs_by_node(self, node_id: str) -> List[Allocation]:
        return self._by_index("allocs_by_node", node_id, "allocs")

    def allocs_by_node_terminal(self, node_id: str,
                                terminal: bool) -> List[Allocation]:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, namespace: str, job_id: str,
                      anyCreateIndex: bool = True) -> List[Allocation]:
        return self._by_index("allocs_by_job", (namespace, job_id), "allocs")

    def allocs_by_eval(self, eval_id: str) -> List[Allocation]:
        return self._by_index("allocs_by_eval", eval_id, "allocs")

    def allocs_by_deployment(self, deployment_id: str) -> List[Allocation]:
        return [a for a in self.allocs() if a.deployment_id == deployment_id]

    def scheduler_parity_manifest(self) -> Dict[str, List[str]]:
        """Canonical view of scheduling OUTCOMES for cross-cluster
        parity checks: per job, the sorted list of live
        alloc names. Node choice and alloc ids are timing- and
        decorrelation-dependent and legitimately differ between
        equivalent clusters; the name set (job × task group × index)
        is what the scheduler promised and must match exactly —
        3-server distributed scheduling must land the same manifest
        as a single server given the same workload."""
        out: Dict[str, List[str]] = {}
        for a in self.allocs():
            if a.terminal_status():
                continue
            out.setdefault(f"{a.namespace}/{a.job_id}", []).append(a.name)
        return {k: sorted(v) for k, v in out.items()}

    def _by_index(self, index_table: str, key, target: str) -> List:
        ids = self._root.table(index_table).get(key)
        if not ids:
            return []
        table = self._root.table(target)
        return [table[i] for i in ids.keys()]

    # -- deployments ---------------------------------------------------
    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self._root.table("deployments").get(deployment_id)

    def deployments(self) -> List[Deployment]:
        return list(self._root.table("deployments").values())

    def deployments_by_job(self, namespace: str, job_id: str) -> List[Deployment]:
        return self._by_index("deployments_by_job", (namespace, job_id),
                              "deployments")

    def latest_deployment_by_job(self, namespace: str,
                                 job_id: str) -> Optional[Deployment]:
        ds = self.deployments_by_job(namespace, job_id)
        if not ds:
            return None
        return max(ds, key=lambda d: d.create_index)

    # -- periodic launches ---------------------------------------------
    def periodic_launch(self, namespace: str, job_id: str) -> Optional[float]:
        """Last launch time for a periodic job (periodic_launch table)."""
        return self._root.table("periodic_launches").get((namespace, job_id))

    def periodic_launches(self) -> Dict[Tuple[str, str], float]:
        return dict(self._root.table("periodic_launches").items())

    # -- children (periodic / dispatch) --------------------------------
    def jobs_by_parent(self, namespace: str, parent_id: str) -> List[Job]:
        return [j for j in self.jobs(namespace) if j.parent_id == parent_id]

    # -- config --------------------------------------------------------
    def scheduler_config(self) -> SchedulerConfiguration:
        return (self._root.table("scheduler_config").get("config")
                or SchedulerConfiguration())

    # -- namespaces (state_store.go UpsertNamespaces:5565) -------------
    def namespaces(self) -> List:
        """All namespaces; "default" exists implicitly (the reference
        seeds it at bootstrap)."""
        from ..models.namespace import DEFAULT_NAMESPACE, Namespace
        t = self._root.table("namespaces")
        out = list(t.values())
        if t.get(DEFAULT_NAMESPACE) is None:
            out.append(Namespace(name=DEFAULT_NAMESPACE,
                                 description="Default shared namespace"))
        out.sort(key=lambda n: n.name)
        return out

    def namespace_by_name(self, name: str):
        from ..models.namespace import DEFAULT_NAMESPACE, Namespace
        got = self._root.table("namespaces").get(name)
        if got is None and name == DEFAULT_NAMESPACE:
            return Namespace(name=DEFAULT_NAMESPACE,
                             description="Default shared namespace")
        return got

    # -- service registry reads (built-in catalog) ---------------------
    def service_registrations(self, namespace: Optional[str] = None
                              ) -> List:
        out = [s for s in
               self._root.table("service_registrations").values()
               if namespace is None or s.namespace == namespace]
        out.sort(key=lambda s: (s.service_name, s.id))
        return out

    def service_by_name(self, namespace: str, name: str) -> List:
        members = self._root.table("services_by_name").get(
            (namespace, name))
        if members is None:
            return []
        t = self._root.table("service_registrations")
        out = [t.get(rid) for rid in members.keys()]
        return sorted((s for s in out if s is not None),
                      key=lambda s: s.id)

    def services_by_alloc(self, alloc_id: str) -> List:
        members = self._root.table("services_by_alloc").get(alloc_id)
        if members is None:
            return []
        t = self._root.table("service_registrations")
        return sorted((s for s in (t.get(rid) for rid in members.keys())
                       if s is not None), key=lambda s: s.id)

    # -- checkpoint (fsm.go Snapshot:1360) -----------------------------
    def dump(self) -> dict:
        """Wire-encode the full database for a snapshot file (LEGACY
        object format — one wire dict per row; the raft InstallSnapshot
        wire keeps using it for cross-version compatibility). Defined on
        the snapshot view so a raft leader can capture an O(1) MVCC root
        under the apply lock and serialize it afterwards without
        blocking writers (raft.py _send_snapshot)."""
        from ..utils.codec import to_wire
        root = self._root
        out = {"indexes": dict(root.indexes.items()), "tables": {}}
        plain = out["tables"]
        plain["nodes"] = [to_wire(n) for n in root.table("nodes").values()]
        plain["evals"] = [to_wire(e) for e in root.table("evals").values()]
        plain["allocs"] = [to_wire(a) for a in root.table("allocs").values()]
        self._dump_small(root, plain)
        return out

    def dump_columnar(self) -> dict:
        """Format-2 snapshot: the three big tables (allocs/evals/nodes)
        as struct-of-arrays (state/columnar.py — numpy buffers framed
        in msgpack, dedup pools for nested values), everything else in
        the legacy wire shape. Encode/decode is O(columns + unique
        nested values) instead of O(objects)."""
        from .columnar import SNAPSHOT_FORMAT, encode_table
        root = self._root
        out = {"format": SNAPSHOT_FORMAT,
               "indexes": dict(root.indexes.items()),
               "tables": {}, "columnar": {}}
        self._dump_small(root, out["tables"])
        cal = out["columnar"]
        cal["nodes"] = encode_table(list(root.table("nodes").values()))
        cal["evals"] = encode_table(list(root.table("evals").values()))
        cal["allocs"] = encode_table(list(root.table("allocs").values()))
        return out

    def _dump_small(self, root: _Root, plain: dict) -> None:
        """Every table EXCEPT the big three — shared by the legacy and
        columnar dump formats."""
        from ..utils.codec import to_wire
        plain["jobs"] = [to_wire(j) for j in root.table("jobs").values()]
        plain["job_versions"] = [
            {"key": list(k), "versions": {str(v): to_wire(j)
                                          for v, j in versions.items()}}
            for k, versions in root.table("job_versions").items()]
        plain["deployments"] = [to_wire(d)
                                for d in root.table("deployments").values()]
        plain["job_summaries"] = [to_wire(s) for s in
                                  root.table("job_summaries").values()]
        cfg = root.table("scheduler_config").get("config")
        plain["scheduler_config"] = to_wire(cfg) if cfg else None
        plain["periodic_launches"] = [
            {"key": list(k), "launch_time": v}
            for k, v in root.table("periodic_launches").items()]
        plain["scaling_events"] = [
            {"key": list(k), "events": v}
            for k, v in root.table("scaling_events").items()]
        plain["scaling_policies"] = [
            to_wire(p) for p in root.table("scaling_policies").values()]
        plain["event_sinks"] = [
            to_wire(s) for s in root.table("event_sinks").values()]
        plain["server_members"] = list(
            root.table("server_members").get("members") or [])
        plain["acl_policies"] = [to_wire(p) for p in
                                 root.table("acl_policies").values()]
        plain["acl_tokens"] = [to_wire(t) for t in
                               root.table("acl_tokens").values()]
        plain["csi_volumes"] = [to_wire(v) for v in
                                root.table("csi_volumes").values()]
        plain["service_registrations"] = [
            to_wire(s) for s in
            root.table("service_registrations").values()]
        plain["namespaces"] = [to_wire(n) for n in
                               root.table("namespaces").values()]
        plain["vault_accessors"] = [to_wire(a) for a in
                                    root.table("vault_accessors").values()]


class StateStore(StateSnapshot):
    """The mutable handle: all writes go through FSM-style apply methods
    that stamp a raft-like index and notify blocked watchers."""

    CHANGELOG_MAX = 200_000

    def __init__(self):
        root = _Root(_Table(), _Table()).edit()
        super().__init__(root)
        self._store = self  # StateStore doubles as its own snapshot view
        # RLock: composite mutations re-enter (e.g. update_deployment_status
        # upserting the rolled-back job via upsert_job)
        self._lock = make_rlock()
        self._watch = make_condition()
        # bounded changelog feeding the resident NodeTable's delta path:
        # (index, kind, key) in index order; entries at or below
        # _change_floor may have been pruned
        self._changes: List[Tuple[int, str, str]] = []
        self._change_indexes: List[int] = []
        self._change_floor = 0
        from ..ops.tables import NodeTableCache
        self.table_cache = NodeTableCache()
        # columnar per-job alloc index (state/alloc_index.py): the
        # reconciler's struct-of-arrays view, advanced write-through by
        # every alloc mutation below
        from .alloc_index import AllocIndexCache
        self.alloc_index = AllocIndexCache()
        # interned node-attribute columns (state/node_attr_index.py):
        # the feasibility compiler's resident code columns, advanced
        # write-through by every node mutation below
        from .node_attr_index import NodeAttrIndexCache
        self.attr_index = NodeAttrIndexCache()
        # decoded alloc columns left behind by a columnar restore for
        # the resident table's vectorized cold build (pop_cold_columns)
        self._cold_columns = None

    # -- changelog -----------------------------------------------------
    def _log_change(self, index: int, kind: str, key: str) -> None:
        self._changes.append((index, kind, key))
        self._change_indexes.append(index)
        if len(self._changes) > self.CHANGELOG_MAX:
            drop = len(self._changes) - self.CHANGELOG_MAX
            self._change_floor = self._changes[drop - 1][0]
            del self._changes[:drop]
            del self._change_indexes[:drop]

    def changes_since(self, from_idx: int,
                      to_idx: int) -> Optional[List[Tuple[str, str]]]:
        """Node/alloc changes with from_idx < index <= to_idx, or None if
        the log no longer reaches back to from_idx (caller rebuilds)."""
        import bisect
        with self._lock:
            if from_idx < self._change_floor:
                return None
            lo = bisect.bisect_right(self._change_indexes, from_idx)
            hi = bisect.bisect_right(self._change_indexes, to_idx)
            return [(k, key) for (_i, k, key) in self._changes[lo:hi]]

    # -- governance accounting / compaction (governor/) ----------------
    def table_stats(self) -> Dict[str, dict]:
        """Per-table size + layer-overlay stats for the governor's
        accounting pass."""
        out: Dict[str, dict] = {}
        for name, t in self._root.tables.items():
            stats = getattr(t, "layer_stats", None)
            out[name] = stats() if stats is not None else {"size": len(t)}
        return out

    def version_debt(self) -> int:
        """Total uncompacted overlay entries (tip writes + tombstones)
        across tables — the store-side version chain the round-5 soak
        showed growing between snapshots. The automatic fold threshold
        is len(base)/8, which on a 2M-row alloc table lets ~250k stale
        overlay entries accumulate before a fold; the governor bounds
        this via compact()."""
        debt = 0
        for t in self._root.tables.values():
            ov = getattr(t, "overlay_len", None)
            if ov is not None:
                debt += ov()
        return debt

    def changelog_len(self) -> int:
        with self._lock:
            return len(self._changes)

    def compact(self, min_tip: int = 1024, force: bool = False) -> dict:
        """Fold every table whose overlay warrants it into its base,
        dropping tombstones (the state-store analog of old-version
        compaction). A fold costs O(len(base)) under the write lock,
        so a table must earn it: overlay >= min_tip AND >= base/32 —
        without the proportional floor a 2M-row table with a 1k
        overlay would copy 2M entries (stalling every plan apply) to
        reclaim almost nothing.

        `force` is the governor's over-watermark escalation: total
        debt breached its bound, so the proportional floor must not
        be allowed to veto every table (debt split across big tables,
        each individually under base/32, would otherwise leave the
        reclaim a permanent no-op). Forced folds go largest-overlay
        first and stop once half the candidate debt is reclaimed, so
        the big offenders pay and the long tail is spared.

        Published snapshots keep reading their own roots untouched.
        Returns fold accounting for the governor's reclaim event."""
        folded = 0
        reclaimed = 0
        with self._lock:
            cands = []
            for t in self._root.tables.values():
                ov = getattr(t, "overlay_len", None)
                if ov is None:
                    continue
                n = ov()
                if n < max(min_tip, 1):
                    continue
                if not force and n * 32 < t.layer_stats()["base"]:
                    continue
                cands.append((n, id(t), t))
            cands.sort(reverse=True)
            target = sum(n for n, _, _ in cands) / 2.0 if force else None
            for n, _, t in cands:
                if target is not None and reclaimed >= target:
                    break
                reclaimed += n
                t.fold()
                folded += 1
        return {"tables_folded": folded, "overlay_reclaimed": reclaimed}

    # -- snapshot / blocking ------------------------------------------
    def snapshot(self) -> StateSnapshot:
        return StateSnapshot(self._root, self)

    def snapshot_min_index(self, index: int, timeout_s: float = 5.0) -> StateSnapshot:
        """Wait until the store has caught up to `index`, then snapshot
        (state_store.go:186 SnapshotMinIndex — the scheduler's raft fence)."""
        deadline = time.monotonic() + timeout_s
        with self._watch:
            while self.latest_index() < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"timeout waiting for state at index {index} "
                        f"(have {self.latest_index()})")
                self._watch.wait(remaining)
        return self.snapshot()

    def block_min_index(self, index: int, timeout_s: float) -> bool:
        """Blocking-query support: wait for any write past `index`."""
        deadline = time.monotonic() + timeout_s
        with self._watch:
            while self.latest_index() <= index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._watch.wait(remaining)
            return True

    def _publish(self, root: _Root) -> None:
        # seal any open edit context: published roots are immutable
        self._root = root.frozen()
        with self._watch:
            self._watch.notify_all()

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _index_add(root: _Root, table: str, key, member) -> _Root:
        t = root.table(table)
        # nested member sets ride the transaction's edit context but are
        # stored frozen so no stale ctx can ever mutate published nodes
        members = (t.get(key) or _Table()).with_ctx(root._ctx)
        return root.with_table(
            table, t.set(key, members.set(member, True).frozen()))

    @staticmethod
    def _index_del(root: _Root, table: str, key, member) -> _Root:
        t = root.table(table)
        members = t.get(key)
        if members is None:
            return root
        members = members.delete(member)
        if len(members) == 0:
            return root.with_table(table, t.delete(key))
        return root.with_table(table, t.set(key, members.frozen()))

    # -- nodes ---------------------------------------------------------
    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            root = self._root.edit()
            existing = root.table("nodes").get(node.id)
            if existing is not None:
                node.create_index = existing.create_index
                # preserve operator-set fields across re-registration
                node.drain = existing.drain
                node.drain_strategy = existing.drain_strategy
                node.scheduling_eligibility = existing.scheduling_eligibility
            else:
                node.create_index = index
            node.modify_index = index
            node.canonicalize()
            if not node.computed_class:
                node.compute_class()
            root = root.with_table("nodes", root.table("nodes").set(node.id, node))
            root = root.with_index("nodes", index)
            self._log_change(index, "node", node.id)
            self.attr_index.note_upsert(index, node)
            self._publish(root)

    def delete_node(self, index: int, node_ids: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("nodes")
            for nid in node_ids:
                t = t.delete(nid)
            root = root.with_table("nodes", t).with_index("nodes", index)
            for nid in node_ids:
                self._log_change(index, "node", nid)
                self.attr_index.note_delete(index, nid)
            self._publish(root)

    def update_node_status(self, index: int, node_id: str, status: str,
                           updated_at: int = 0) -> None:
        with self._lock:
            self._update_node(index, node_id,
                              status=status, status_updated_at=updated_at)

    def update_node_eligibility(self, index: int, node_id: str,
                                eligibility: str) -> None:
        with self._lock:
            self._update_node(index, node_id, scheduling_eligibility=eligibility)

    def update_node_drain(self, index: int, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> None:
        with self._lock:
            node = self._root.table("nodes").get(node_id)
            if node is None:
                raise KeyError(f"node {node_id} not found")
            eligibility = node.scheduling_eligibility
            if drain_strategy is not None:
                eligibility = NODE_SCHED_INELIGIBLE
            elif mark_eligible:
                eligibility = NODE_SCHED_ELIGIBLE
            self._update_node(index, node_id,
                              drain=drain_strategy is not None,
                              drain_strategy=drain_strategy,
                              scheduling_eligibility=eligibility)

    def _update_node(self, index: int, node_id: str, **changes) -> None:
        root = self._root.edit()
        node = root.table("nodes").get(node_id)
        if node is None:
            raise KeyError(f"node {node_id} not found")
        node = replace(node, modify_index=index, **changes)
        root = root.with_table("nodes", root.table("nodes").set(node_id, node))
        root = root.with_index("nodes", index)
        self._log_change(index, "node", node_id)
        self.attr_index.note_upsert(index, node)
        self._publish(root)

    # -- jobs ----------------------------------------------------------
    def upsert_job(self, index: int, job: Job) -> None:
        with self._lock:
            root = self._upsert_job_root(self._root.edit(), index, job)
            self._publish(root)

    def upsert_jobs_batch(self, index: int, jobs: List[Job]) -> None:
        """Batched register ingest: one committed `ingest_batch`
        entry's job registers on ONE edit root with ONE publish, applied
        in submission order — state-equivalent to sequential upsert_job
        calls at the same index (same-job re-registers on one root still
        see each other's version bumps)."""
        if not jobs:
            return
        with self._lock:
            root = self._root.edit()
            for job in jobs:
                root = self._upsert_job_root(root, index, job)
            self._publish(root)

    def _upsert_job_root(self, root: _Root, index: int, job: Job) -> _Root:
        key = job.namespaced_id()
        existing = root.table("jobs").get(key)
        if existing is not None:
            job.create_index = existing.create_index
            job.job_modify_index = index
            if existing.specchanged(job):
                job.version = existing.version + 1
            else:
                job.version = existing.version
        else:
            job.create_index = index
            job.job_modify_index = index
            job.version = 0
        job.modify_index = index
        if job.status == "":
            job.status = JOB_STATUS_PENDING
        root = root.with_table("jobs", root.table("jobs").set(key, job))
        # version history (pruned to JOB_TRACKED_VERSIONS)
        versions = root.table("job_versions").get(key) or _Table()
        versions = versions.set(job.version, job)
        if len(versions) > JOB_TRACKED_VERSIONS:
            oldest = min(versions.keys())
            versions = versions.delete(oldest)
        root = root.with_table("job_versions",
                               root.table("job_versions").set(key, versions))
        root = self._ensure_job_summary(root, index, job)
        root = self._sync_scaling_policies(root, index, job)
        if job.parent_id:
            root = self._bump_parent_children(
                root, index, (job.namespace, job.parent_id),
                existing.status if existing is not None else None,
                job.status)
        return root.with_index("jobs", index)

    def _sync_scaling_policies(self, root: _Root, index: int,
                               job: Job) -> _Root:
        """Derive scaling policies from the job's task-group scaling
        blocks (state_store.go updateJobScalingPolicies; CRUD surface
        nomad/scaling_endpoint.go:24,90). Policies keep their id across
        re-registrations; groups that drop their scaling block lose
        their policy."""
        key = (job.namespace, job.id)
        members = root.table("scaling_policies_by_job").get(key)
        if members is None and not any(tg.scaling is not None
                                       for tg in job.task_groups):
            return root         # common case: no policies either side
        t = root.table("scaling_policies")      # id -> ScalingPolicy
        changed = False
        live_ids = set()
        for tg in job.task_groups:
            if tg.scaling is None:
                continue
            pid = ScalingPolicy.id_for(job.namespace, job.id, tg.name)
            live_ids.add(pid)
            existing = t.get(pid)
            enabled = tg.scaling.enabled and not job.stop
            if existing is None:
                root = self._index_add(root, "scaling_policies_by_job",
                                       key, pid)
            elif (existing.min, existing.max, existing.policy,
                  existing.enabled) == (tg.scaling.min, tg.scaling.max,
                                        tg.scaling.policy, enabled):
                continue        # unchanged: keep its modify_index
            t = t.set(pid, ScalingPolicy(
                id=pid, namespace=job.namespace,
                target={"Namespace": job.namespace, "Job": job.id,
                        "Group": tg.name},
                min=tg.scaling.min, max=tg.scaling.max,
                policy=dict(tg.scaling.policy),
                enabled=enabled,
                create_index=(existing.create_index
                              if existing is not None else index),
                modify_index=index))
            changed = True
        # stale sweep via the per-job member index — never the whole
        # table (this runs inside every job-register FSM apply)
        for pid in list(members.keys()) if members is not None else []:
            if pid not in live_ids:
                t = t.delete(pid)
                root = self._index_del(root, "scaling_policies_by_job",
                                       key, pid)
                changed = True
        if changed:
            root = root.with_table("scaling_policies", t) \
                       .with_index("scaling_policies", index)
        return root

    # -- scaling policies (nomad/scaling_endpoint.go) ------------------
    def scaling_policies(self, namespace: Optional[str] = None,
                         job_id: Optional[str] = None,
                         policy_type: Optional[str] = None
                         ) -> List[ScalingPolicy]:
        out = []
        for pol in self._root.table("scaling_policies").values():
            if namespace is not None and pol.namespace != namespace:
                continue
            if job_id is not None and pol.target.get("Job") != job_id:
                continue
            if policy_type is not None and pol.type != policy_type:
                continue
            out.append(pol)
        out.sort(key=lambda p: p.id)
        return out

    def scaling_policy_by_id(self, policy_id: str
                             ) -> Optional[ScalingPolicy]:
        return self._root.table("scaling_policies").get(policy_id)

    def scaling_policy_by_target(self, namespace: str, job_id: str,
                                 group: str) -> Optional[ScalingPolicy]:
        return self.scaling_policy_by_id(
            ScalingPolicy.id_for(namespace, job_id, group))

    # -- server membership (nomad/serf.go; the voter set rides the
    # replicated log instead of gossip) --------------------------------
    def set_server_members(self, index: int, members: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("server_members")
            root = root.with_table(
                "server_members",
                t.set("members", list(dict.fromkeys(members)))) \
                .with_index("server_members", index)
            self._publish(root)

    def server_members(self) -> List[str]:
        return list(self._root.table("server_members")
                    .get("members") or [])

    # -- event sinks (nomad/stream/sink.go; event_sinks table) ---------
    def upsert_event_sink(self, index: int, sink) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("event_sinks")
            existing = t.get(sink.id)
            if existing is not None:
                sink.create_index = existing.create_index
                # progress survives reconfiguration
                sink.latest_index = max(sink.latest_index,
                                        existing.latest_index)
            else:
                sink.create_index = index
            sink.modify_index = index
            root = root.with_table("event_sinks", t.set(sink.id, sink)) \
                       .with_index("event_sinks", index)
            self._publish(root)

    def delete_event_sink(self, index: int, sink_id: str) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("event_sinks")
            if t.get(sink_id) is None:
                return
            root = root.with_table("event_sinks", t.delete(sink_id)) \
                       .with_index("event_sinks", index)
            self._publish(root)

    def update_event_sink_progress(self, index: int, sink_id: str,
                                   latest: int) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("event_sinks")
            sink = t.get(sink_id)
            if sink is None or sink.latest_index >= latest:
                return
            from dataclasses import replace as _replace
            sink = _replace(sink, latest_index=latest, modify_index=index)
            root = root.with_table("event_sinks", t.set(sink_id, sink)) \
                       .with_index("event_sinks", index)
            self._publish(root)

    def event_sinks(self) -> List:
        return sorted(self._root.table("event_sinks").values(),
                      key=lambda s: s.id)

    def event_sink(self, sink_id: str):
        return self._root.table("event_sinks").get(sink_id)

    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            root = self._root.edit()
            key = (namespace, job_id)
            existing = root.table("jobs").get(key)
            if existing is not None and existing.parent_id:
                root = self._bump_parent_children(
                    root, index, (namespace, existing.parent_id),
                    existing.status, None)
            root = root.with_table("jobs", root.table("jobs").delete(key))
            root = root.with_table("periodic_launches",
                                   root.table("periodic_launches").delete(key))
            root = root.with_table("job_versions",
                                   root.table("job_versions").delete(key))
            root = root.with_table("job_summaries",
                                   root.table("job_summaries").delete(key))
            # deregistration drops the job's scaling policies
            # (state_store.go deleteJobScalingPolicies)
            members = root.table("scaling_policies_by_job").get(key)
            if members is not None:
                sp = root.table("scaling_policies")
                for pid in members.keys():
                    sp = sp.delete(pid)
                root = root.with_table("scaling_policies", sp) \
                           .with_table(
                               "scaling_policies_by_job",
                               root.table("scaling_policies_by_job")
                                   .delete(key)) \
                           .with_index("scaling_policies", index)
            root = root.with_index("jobs", index).with_index("job_summaries", index)
            self._publish(root)

    def _ensure_job_summary(self, root: _Root, index: int, job: Job) -> _Root:
        key = job.namespaced_id()
        summaries = root.table("job_summaries")
        existing = summaries.get(key)
        if existing is None:
            s = JobSummary(job_id=job.id, namespace=job.namespace,
                           create_index=index, modify_index=index)
            for tg in job.task_groups:
                s.summary[tg.name] = {}
        else:
            s = existing
            for tg in job.task_groups:
                s.summary.setdefault(tg.name, {})
            s.modify_index = index
        return root.with_table("job_summaries", summaries.set(key, s)) \
                   .with_index("job_summaries", index)

    # -- evals ---------------------------------------------------------
    def upsert_evals(self, index: int, evals: List[Evaluation]) -> None:
        with self._lock:
            root = self._root.edit()
            for e in evals:
                root = self._upsert_eval_impl(root, index, e)
            root = root.with_index("evals", index)
            self._publish(root)

    def upsert_evals_batch(
            self, items: List[Tuple[int, List[Evaluation]]]) -> None:
        """Batched WAL replay: N `eval_update` entries' evals
        on ONE edit root with ONE publish, each eval stamped with its
        own entry index — state-equivalent to sequential upsert_evals
        calls."""
        if not items:
            return
        with self._lock:
            root = self._root.edit()
            last = 0
            for index, evals in items:
                for e in evals:
                    root = self._upsert_eval_impl(root, index, e)
                last = index
            root = root.with_index("evals", last)
            self._publish(root)

    def _upsert_eval_impl(self, root: _Root, index: int, e: Evaluation) -> _Root:
        existing = root.table("evals").get(e.id)
        if existing is not None:
            e.create_index = existing.create_index
        else:
            e.create_index = index
        e.modify_index = index
        root = root.with_table("evals", root.table("evals").set(e.id, e))
        root = self._index_add(root, "evals_by_job", (e.namespace, e.job_id), e.id)
        # cancel older blocked evals for the same job (fsm.go applyUpsertEvals
        # -> state_store nested blocked-eval dedup happens broker-side; the
        # store just records)
        return root

    def delete_evals(self, index: int, eval_ids: List[str],
                     alloc_ids: Optional[List[str]] = None) -> None:
        with self._lock:
            root = self._root.edit()
            for eid in eval_ids:
                e = root.table("evals").get(eid)
                if e is None:
                    continue
                root = root.with_table("evals", root.table("evals").delete(eid))
                root = self._index_del(root, "evals_by_job",
                                       (e.namespace, e.job_id), eid)
            for aid in (alloc_ids or []):
                root = self._delete_alloc_impl(root, aid, index)
            root = root.with_index("evals", index).with_index("allocs", index)
            self._publish(root)

    # -- allocs --------------------------------------------------------
    def upsert_allocs(self, index: int, allocs: List[Allocation]) -> None:
        with self._lock:
            root = self._root.edit()
            for a in allocs:
                root = self._upsert_alloc_impl(root, index, a)
            root = root.with_index("allocs", index)
            self._publish(root)

    def bulk_load_allocs(self, index: int, allocs: List[Allocation]) -> None:
        """Replay/restore-grade bulk insert — the C2M seed path and the
        columnar analog of fsm.go's snapshot Restore:1374. Semantics
        match repeated upsert_allocs for brand-new allocs, but the work
        is batched: one transient pass over the alloc table, grouped
        secondary-index updates (one sub-HAMT rebuild per key instead of
        one per member), a single job-summary aggregation, and a
        changelog floor bump so resident node tables rebuild once
        instead of replaying millions of row deltas."""
        with self._lock:
            root = self._root.edit()
            t = root.table("allocs")
            pairs: List[Tuple[str, Allocation]] = []
            by_node: Dict[str, List[str]] = {}
            by_job: Dict[Tuple[str, str], List[str]] = {}
            by_job_objs: Dict[Tuple[str, str], List[Allocation]] = {}
            by_eval: Dict[str, List[str]] = {}
            summary_delta: Dict[Tuple[str, str], Dict[str, Dict[str, int]]] = {}
            for a in allocs:
                a.create_index = index
                a.modify_index = index
                a.alloc_modify_index = index
                pairs.append((a.id, a))
                by_node.setdefault(a.node_id, []).append(a.id)
                by_job.setdefault((a.namespace, a.job_id), []).append(a.id)
                by_job_objs.setdefault((a.namespace, a.job_id),
                                       []).append(a)
                by_eval.setdefault(a.eval_id, []).append(a.id)
                b = _client_status_bucket(a)
                if b is not None:
                    tgs = summary_delta.setdefault((a.namespace, a.job_id), {})
                    counts = tgs.setdefault(a.task_group, {})
                    counts[b] = counts.get(b, 0) + 1
            # captured BEFORE the index update below: a job with no
            # prior allocs can take a fresh columnar-index entry built
            # from exactly this batch (note_bulk_load)
            prior_jobs = {key: root.table("allocs_by_job").get(key)
                          is not None for key in by_job}
            root = root.with_table("allocs", t.update(pairs))
            for name, groups in (("allocs_by_node", by_node),
                                 ("allocs_by_job", by_job),
                                 ("allocs_by_eval", by_eval)):
                it = root.table(name)
                for key, ids in groups.items():
                    sub = (it.get(key) or _Table()).with_ctx(root._ctx)
                    # single-member adds dominate (a 10k batch touches
                    # 10k distinct nodes): set() skips update()'s batch
                    # machinery
                    if len(ids) == 1:
                        sub = sub.set(ids[0], True)
                    else:
                        sub = sub.update([(i, True) for i in ids])
                    it = it.set(key, sub.frozen())
                root = root.with_table(name, it)
            summaries = root.table("job_summaries")
            changed_summaries = False
            for key, tgs in summary_delta.items():
                s: Optional[JobSummary] = summaries.get(key)
                if s is None:
                    continue
                new_sum = dict(s.summary)
                for tg, buckets in tgs.items():
                    counts = dict(new_sum.get(tg, {}))
                    for b, n in buckets.items():
                        counts[b] = counts.get(b, 0) + n
                    new_sum[tg] = counts
                summaries = summaries.set(
                    key, replace(s, summary=new_sum, modify_index=index))
                changed_summaries = True
            if changed_summaries:
                root = root.with_table("job_summaries", summaries) \
                           .with_index("job_summaries", index)
            root = root.with_index("allocs", index)
            # invalidate the RESIDENT TABLE delta path wholesale: one
            # rebuild beats replaying a multi-million-row changelog
            self._changes.clear()
            self._change_indexes.clear()
            self._change_floor = index
            # …but keep the per-job columnar alloc index WARM (the
            # old invalidate_all here made the eval
            # after a seed/restore pay a dense rebuild): existing
            # entries absorb the new rows in place, brand-new jobs get
            # a fresh entry built from exactly this batch
            self.alloc_index.note_bulk_load(index, by_job_objs,
                                            prior_jobs)
            self._publish(root)

    def _upsert_alloc_impl(self, root: _Root, index: int, a: Allocation) -> _Root:
        existing: Optional[Allocation] = root.table("allocs").get(a.id)
        if existing is not None:
            a.create_index = existing.create_index
            # A plan's stop/evict stub carries no job/resources: inherit
            # (fsm.go UpsertAllocs keeps existing fields on update)
            if a.job is None:
                a.job = existing.job
            if a.allocated_resources is None:
                a.allocated_resources = existing.allocated_resources
            if not a.name:
                a.name = existing.name
            if not a.node_id:
                a.node_id = existing.node_id
            if not a.job_id:
                a.job_id = existing.job_id
            if not a.task_group:
                a.task_group = existing.task_group
            if not a.eval_id:
                a.eval_id = existing.eval_id
            if a.client_status == ALLOC_CLIENT_PENDING and existing.client_status:
                # server-side updates don't regress client status
                a.client_status = existing.client_status
                a.task_states = existing.task_states or a.task_states
        else:
            a.create_index = index
        a.modify_index = index
        a.alloc_modify_index = index
        root = root.with_table("allocs", root.table("allocs").set(a.id, a))
        if existing is None:
            root = self._index_add(root, "allocs_by_node", a.node_id, a.id)
            root = self._index_add(root, "allocs_by_job",
                                   (a.namespace, a.job_id), a.id)
            root = self._index_add(root, "allocs_by_eval", a.eval_id, a.id)
        elif existing.node_id != a.node_id:
            root = self._index_del(root, "allocs_by_node", existing.node_id, a.id)
            root = self._index_add(root, "allocs_by_node", a.node_id, a.id)
        root = self._update_summary_for_alloc(root, index, existing, a)
        self._log_change(index, "alloc", a.id)
        self.alloc_index.note_upsert(index, a)
        return root

    def _delete_alloc_impl(self, root: _Root, alloc_id: str,
                           index: int) -> _Root:
        a = root.table("allocs").get(alloc_id)
        if a is None:
            return root
        self._log_change(index, "alloc", alloc_id)
        self.alloc_index.note_delete(index, a.namespace, a.job_id,
                                     alloc_id)
        root = root.with_table("allocs", root.table("allocs").delete(alloc_id))
        root = self._index_del(root, "allocs_by_node", a.node_id, alloc_id)
        root = self._index_del(root, "allocs_by_job",
                               (a.namespace, a.job_id), alloc_id)
        root = self._index_del(root, "allocs_by_eval", a.eval_id, alloc_id)
        return root

    def update_allocs_from_client(self, index: int,
                                  allocs: List[Allocation]) -> None:
        """Client pushes task states / client status (node_endpoint.go:1065)."""
        with self._lock:
            root = self._update_allocs_from_client_root(
                self._root.edit(), index, allocs)
            root = root.with_index("allocs", index)
            self._publish(root)

    def update_allocs_from_client_batch(
            self, items: List[Tuple[int, List[Allocation]]]) -> None:
        """Batched `alloc_client_update` writes on ONE edit root with
        ONE publish, each entry stamped with its own index —
        state-equivalent to sequential update_allocs_from_client calls
        (the mutation sequence is identical; only the layer pushes and
        watcher wakes collapse). Born as WAL replay, now also
        the live ingest path: a coalesced `ingest_batch` run
        of client updates lands through here as one store transaction."""
        if not items:
            return
        with self._lock:
            root = self._root.edit()
            for index, allocs in items:
                root = self._update_allocs_from_client_root(root, index,
                                                            allocs)
                root = root.with_index("allocs", index)
            self._publish(root)

    def _update_allocs_from_client_root(self, root: _Root, index: int,
                                        allocs: List[Allocation]) -> _Root:
        for update in allocs:
            existing = root.table("allocs").get(update.id)
            if existing is None:
                continue
            merged = replace(
                existing,
                client_status=update.client_status,
                client_description=update.client_description,
                task_states=update.task_states or existing.task_states,
                deployment_status=(update.deployment_status
                                   or existing.deployment_status),
                modify_index=index,
                modify_time=update.modify_time or existing.modify_time,
            )
            root = root.with_table("allocs",
                                   root.table("allocs").set(merged.id, merged))
            root = self._update_summary_for_alloc(root, index, existing, merged)
            root = self._maybe_update_deployment_health(root, index, merged)
            self._log_change(index, "alloc", merged.id)
            self.alloc_index.note_upsert(index, merged)
        return root

    def _maybe_update_deployment_health(self, root: _Root, index: int,
                                        alloc: Allocation) -> _Root:
        if not alloc.deployment_id or alloc.deployment_status is None:
            return root
        d: Optional[Deployment] = root.table("deployments").get(alloc.deployment_id)
        if d is None or not d.active():
            return root
        state = d.task_groups.get(alloc.task_group)
        if state is None:
            return root
        # recount healthy/unhealthy from allocs of this deployment
        healthy = unhealthy = 0
        for a in root.table("allocs").values():
            if a.deployment_id != d.id or a.task_group != alloc.task_group:
                continue
            ds = a.deployment_status if a.id != alloc.id else alloc.deployment_status
            if ds is None or ds.healthy is None:
                continue
            if ds.healthy:
                healthy += 1
            else:
                unhealthy += 1
        new_state = replace(state, healthy_allocs=healthy,
                            unhealthy_allocs=unhealthy)
        d = replace(d, task_groups={**d.task_groups,
                                    alloc.task_group: new_state},
                    modify_index=index)
        return root.with_table("deployments",
                               root.table("deployments").set(d.id, d)) \
                   .with_index("deployments", index)

    # -- job summary maintenance --------------------------------------
    def _update_summary_for_alloc(self, root: _Root, index: int,
                                  old: Optional[Allocation],
                                  new: Allocation) -> _Root:
        key = (new.namespace, new.job_id)
        summaries = root.table("job_summaries")
        s: Optional[JobSummary] = summaries.get(key)
        if s is None:
            return root
        tg = new.task_group
        counts = dict(s.summary.get(tg, {}))

        bucket = _client_status_bucket
        ob, nb = bucket(old), bucket(new)
        if ob == nb:
            if old is not None:
                return root
        if ob is not None:
            counts[ob] = max(0, counts.get(ob, 0) - 1)
        if nb is not None:
            counts[nb] = counts.get(nb, 0) + 1
        new_summary = replace(s, summary={**s.summary, tg: counts},
                              modify_index=index)
        return root.with_table("job_summaries", summaries.set(key, new_summary)) \
                   .with_index("job_summaries", index)

    # -- deployments ---------------------------------------------------
    def upsert_deployment(self, index: int, deployment: Deployment) -> None:
        with self._lock:
            root = self._upsert_deployment_impl(self._root, index, deployment)
            self._publish(root)

    def _upsert_deployment_impl(self, root: _Root, index: int,
                                d: Deployment) -> _Root:
        existing = root.table("deployments").get(d.id)
        if existing is not None:
            d.create_index = existing.create_index
        else:
            d.create_index = index
        d.modify_index = index
        root = root.with_table("deployments",
                               root.table("deployments").set(d.id, d))
        if existing is None:
            root = self._index_add(root, "deployments_by_job",
                                   (d.namespace, d.job_id), d.id)
        return root.with_index("deployments", index)

    def update_deployment_status(self, index: int,
                                 update: DeploymentStatusUpdate,
                                 job: Optional[Job] = None,
                                 evals: Optional[List[Evaluation]] = None) -> None:
        with self._lock:
            root = self._root.edit()
            d = root.table("deployments").get(update.deployment_id)
            if d is None:
                raise KeyError(f"deployment {update.deployment_id} not found")
            d = replace(d, status=update.status,
                        status_description=update.status_description,
                        modify_index=index)
            root = root.with_table("deployments",
                                   root.table("deployments").set(d.id, d))
            root = root.with_index("deployments", index)
            if job is not None:
                self._publish(root)
                self.upsert_job(index, job)
                root = self._root.edit()
            for e in (evals or []):
                root = self._upsert_eval_impl(root, index, e)
            if evals:
                root = root.with_index("evals", index)
            self._publish(root)

    # -- plan apply (the commit point) --------------------------------
    def upsert_plan_results(self, index: int, *,
                            allocs_stopped: List[Allocation],
                            allocs_placed: List[Allocation],
                            allocs_preempted: List[Allocation],
                            deployment: Optional[Deployment] = None,
                            deployment_updates: Optional[List[DeploymentStatusUpdate]] = None,
                            evals: Optional[List[Evaluation]] = None) -> None:
        """Apply a verified plan atomically (fsm.go ApplyPlanResults /
        state_store.go UpsertPlanResults)."""
        with self._lock:
            root = self._plan_results_root(
                self._root.edit(), index,
                allocs_stopped=allocs_stopped,
                allocs_placed=allocs_placed,
                allocs_preempted=allocs_preempted,
                deployment=deployment,
                deployment_updates=deployment_updates,
                evals=evals)
            self._publish(root)

    def upsert_plan_group_results(self, index: int,
                                  groups: List[dict]) -> None:
        """Apply a whole plan GROUP as ONE transaction (group-commit
        applier): every group member's writes land on one edit root —
        a single layer push across the alloc/index/summary tables
        instead of N, directly reducing the layer-overlay debt the
        governor's compact() reclaim exists to fold — and publish once,
        so watchers wake once per group."""
        with self._lock:
            root = self._root.edit()
            for g in groups:
                root = self._plan_results_root(
                    root, index,
                    allocs_stopped=g.get("allocs_stopped") or [],
                    allocs_placed=g.get("allocs_placed") or [],
                    allocs_preempted=g.get("allocs_preempted") or [],
                    deployment=g.get("deployment"),
                    deployment_updates=g.get("deployment_updates"),
                    evals=g.get("evals"))
            self._publish(root)

    def _plan_results_root(self, root: _Root, index: int, *,
                           allocs_stopped: List[Allocation],
                           allocs_placed: List[Allocation],
                           allocs_preempted: List[Allocation],
                           deployment: Optional[Deployment] = None,
                           deployment_updates: Optional[List[DeploymentStatusUpdate]] = None,
                           evals: Optional[List[Evaluation]] = None) -> _Root:
        """One plan's writes onto an open edit root (shared by the
        single-plan and group-commit paths; caller holds the lock and
        publishes)."""
        t_allocs = root.table("allocs")
        fresh = [a for a in allocs_placed
                 if t_allocs.get(a.id) is None]
        fresh_ids = {a.id for a in fresh}
        new_placed = [a for a in fresh if a.deployment_id]
        for a in allocs_stopped:
            root = self._upsert_alloc_impl(root, index, a)
        # in-place updates go through the general path; brand-new
        # placements take the bulk path (one index write per key)
        for a in allocs_placed:
            if a.id not in fresh_ids:
                root = self._upsert_alloc_impl(root, index, a)
        root = self._bulk_insert_allocs(root, index, fresh)
        for a in allocs_preempted:
            root = self._upsert_alloc_impl(root, index, a)
        # claim CSI volumes for placements whose task group requests
        # them (csi_hook claim-at-placement; the volume watcher
        # releases claims once allocs turn terminal)
        root = self._claim_csi_for_placements(root, index,
                                              allocs_placed)
        if deployment is not None:
            root = self._upsert_deployment_impl(root, index, deployment)
        for a in new_placed:
            root = self._deployment_account_placement(root, index, a)
        for du in (deployment_updates or []):
            d = root.table("deployments").get(du.deployment_id)
            if d is not None:
                d = replace(d, status=du.status,
                            status_description=du.status_description,
                            modify_index=index)
                root = root.with_table(
                    "deployments", root.table("deployments").set(d.id, d))
        for e in (evals or []):
            root = self._upsert_eval_impl(root, index, e)
        return (root.with_index("allocs", index)
                    .with_index("deployments", index)
                    .with_index("evals", index))

    def _bulk_insert_allocs(self, root: _Root, index: int,
                            allocs: List[Allocation]) -> _Root:
        """Insert allocations known to be ABSENT from the table. Same
        effect as _upsert_alloc_impl per alloc, but secondary-index and
        job-summary writes are grouped per key — a 10k-alloc plan apply
        does ~1 outer write per touched node/job/eval instead of 14
        HAMT writes per alloc."""
        if not allocs:
            return root
        t = root.table("allocs")
        pairs = []
        for a in allocs:
            a.create_index = index
            a.modify_index = index
            a.alloc_modify_index = index
            pairs.append((a.id, a))
            self._log_change(index, "alloc", a.id)
            self.alloc_index.note_upsert(index, a)
        root = root.with_table("allocs", t.update(pairs))

        for table, keyfn in (
                ("allocs_by_node", lambda a: a.node_id),
                ("allocs_by_job", lambda a: (a.namespace, a.job_id)),
                ("allocs_by_eval", lambda a: a.eval_id)):
            groups: Dict = {}
            for a in allocs:
                groups.setdefault(keyfn(a), []).append(a.id)
            tt = root.table(table)
            pairs = []
            for key, ids in groups.items():
                members = tt.get(key)
                if members is None:
                    members = _Table()
                # single-member adds dominate spread-out batches: a
                # frozen set() skips the with_ctx/update/frozen dance
                if len(ids) == 1:
                    members = members.set(ids[0], True)
                else:
                    members = members.with_ctx(root._ctx).update(
                        [(aid, True) for aid in ids]).frozen()
                pairs.append((key, members))
            # ONE outer batch write per index table: per-key .set walks
            # the trie path each time (a 10k-alloc plan touches ~1k
            # nodes)
            root = root.with_table(table, tt.update(pairs))

        # job summaries: aggregate bucket deltas per job
        per_job: Dict = {}
        for a in allocs:
            nb = _client_status_bucket(a)
            if nb is None:
                continue
            deltas = per_job.setdefault((a.namespace, a.job_id), {})
            k = (a.task_group, nb)
            deltas[k] = deltas.get(k, 0) + 1
        if per_job:
            summaries = root.table("job_summaries")
            changed = False
            for key, deltas in per_job.items():
                s: Optional[JobSummary] = summaries.get(key)
                if s is None:
                    continue
                summ = dict(s.summary)
                for (tg, b), cnt in deltas.items():
                    counts = dict(summ.get(tg, {}))
                    counts[b] = counts.get(b, 0) + cnt
                    summ[tg] = counts
                summaries = summaries.set(
                    key, replace(s, summary=summ, modify_index=index))
                changed = True
            if changed:
                root = root.with_table("job_summaries", summaries) \
                           .with_index("job_summaries", index)
        return root

    def update_alloc_desired_transitions(self, index: int,
                                         alloc_ids: List[str],
                                         transition,
                                         evals: Optional[List[Evaluation]] = None) -> None:
        """Set server-desired transitions (state_store.go
        UpdateAllocsDesiredTransitions) — the drainer's migrate flag."""
        with self._lock:
            root = self._root.edit()
            updates = {k: v for k, v in vars(transition).items()
                       if v is not None}
            for aid in alloc_ids:
                a: Optional[Allocation] = root.table("allocs").get(aid)
                if a is None:
                    continue
                a = replace(a, desired_transition=replace(
                    a.desired_transition, **updates), modify_index=index)
                root = root.with_table("allocs",
                                       root.table("allocs").set(aid, a))
                self._log_change(index, "alloc", aid)
                self.alloc_index.note_upsert(index, a)
            for e in (evals or []):
                root = self._upsert_eval_impl(root, index, e)
            root = root.with_index("allocs", index)
            if evals:
                root = root.with_index("evals", index)
            self._publish(root)

    def _deployment_account_placement(self, root: _Root, index: int,
                                      alloc: Allocation) -> _Root:
        """Bump placed counts / canary list on the owning deployment
        (state_store.go updateDeploymentWithAlloc)."""
        d: Optional[Deployment] = root.table("deployments").get(alloc.deployment_id)
        if d is None or not d.active():
            return root
        state = d.task_groups.get(alloc.task_group)
        if state is None:
            return root
        canaries = state.placed_canaries
        if (alloc.deployment_status is not None and alloc.deployment_status.canary
                and alloc.id not in canaries):
            canaries = canaries + [alloc.id]
        new_state = replace(state, placed_allocs=state.placed_allocs + 1,
                            placed_canaries=canaries)
        d = replace(d, task_groups={**d.task_groups,
                                    alloc.task_group: new_state},
                    modify_index=index)
        return root.with_table("deployments",
                               root.table("deployments").set(d.id, d)) \
                   .with_index("deployments", index)

    def update_deployment_promotion(self, index: int, deployment_id: str,
                                    groups: Optional[List[str]] = None,
                                    evals: Optional[List[Evaluation]] = None) -> None:
        """Mark task groups promoted (state_store.go
        UpdateDeploymentPromotion). Validation happens at the RPC layer;
        the FSM apply is unconditional so WAL replay is deterministic."""
        from ..models.deployment import DESC_RUNNING
        with self._lock:
            root = self._root.edit()
            d: Optional[Deployment] = root.table("deployments").get(deployment_id)
            if d is None:
                raise KeyError(f"deployment {deployment_id} not found")
            new_states = dict(d.task_groups)
            for name, state in d.task_groups.items():
                if state.desired_canaries == 0:
                    continue
                if groups and name not in groups:
                    continue
                new_states[name] = replace(state, promoted=True)
            # a paused deployment keeps its pause description; only a
            # running one flips to the plain running text
            desc = (DESC_RUNNING if d.status == "running"
                    else d.status_description)
            d = replace(d, task_groups=new_states,
                        status_description=desc, modify_index=index)
            root = root.with_table("deployments",
                                   root.table("deployments").set(d.id, d))
            for e in (evals or []):
                root = self._upsert_eval_impl(root, index, e)
            root = root.with_index("deployments", index)
            if evals:
                root = root.with_index("evals", index)
            self._publish(root)

    def update_job_stability(self, index: int, namespace: str, job_id: str,
                             version: int, stable: bool) -> None:
        """Flag a job version (un)stable (state_store.go
        UpdateJobStability) — the auto-revert target marker."""
        with self._lock:
            root = self._root.edit()
            key = (namespace, job_id)
            versions = root.table("job_versions").get(key)
            if versions is not None:
                v = versions.get(version)
                if v is not None:
                    v = v.copy()
                    v.stable = stable
                    root = root.with_table(
                        "job_versions",
                        root.table("job_versions").set(key, versions.set(version, v)))
            current: Optional[Job] = root.table("jobs").get(key)
            if current is not None and current.version == version:
                current = current.copy()
                current.stable = stable
                current.modify_index = index
                root = root.with_table("jobs", root.table("jobs").set(key, current))
            root = root.with_index("jobs", index)
            self._publish(root)

    # -- periodic launches ---------------------------------------------
    def upsert_periodic_launch(self, index: int, namespace: str, job_id: str,
                               launch_time: float) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("periodic_launches")
            root = root.with_table("periodic_launches",
                                   t.set((namespace, job_id), launch_time))
            root = root.with_index("periodic_launches", index)
            self._publish(root)

    def delete_periodic_launch(self, index: int, namespace: str,
                               job_id: str) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("periodic_launches").delete((namespace, job_id))
            root = root.with_table("periodic_launches", t)
            root = root.with_index("periodic_launches", index)
            self._publish(root)

    # -- deployments GC ------------------------------------------------
    def delete_deployments(self, index: int, deployment_ids: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            for did in deployment_ids:
                d = root.table("deployments").get(did)
                if d is None:
                    continue
                root = root.with_table("deployments",
                                       root.table("deployments").delete(did))
                root = self._index_del(root, "deployments_by_job",
                                       (d.namespace, d.job_id), did)
            root = root.with_index("deployments", index)
            self._publish(root)

    # -- scaling events (state_store.go UpsertScalingEvent) ------------
    JOB_TRACKED_SCALING_EVENTS = 20

    def add_scaling_event(self, index: int, namespace: str, job_id: str,
                          event: dict) -> None:
        with self._lock:
            root = self._root.edit()
            key = (namespace, job_id)
            events = list(root.table("scaling_events").get(key) or [])
            event = dict(event, create_index=index)
            events.insert(0, event)
            del events[self.JOB_TRACKED_SCALING_EVENTS:]
            root = root.with_table(
                "scaling_events",
                root.table("scaling_events").set(key, events))
            root = root.with_index("scaling_events", index)
            self._publish(root)

    def scaling_events(self, namespace: str, job_id: str) -> List[dict]:
        return list(self._root.table("scaling_events")
                    .get((namespace, job_id)) or [])

    # -- scheduler config ---------------------------------------------
    def set_scheduler_config(self, index: int,
                             config: SchedulerConfiguration) -> None:
        with self._lock:
            config.modify_index = index
            root = self._root.with_table(
                "scheduler_config",
                self._root.table("scheduler_config").set("config", config))
            root = root.with_index("scheduler_config", index)
            self._publish(root)

    # -- ACL (state_store.go ACLPolicy/ACLToken tables) ----------------
    def upsert_acl_policies(self, index: int, policies: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("acl_policies")
            for p in policies:
                existing = t.get(p.name)
                p.create_index = existing.create_index if existing else index
                p.modify_index = index
                t = t.set(p.name, p)
            root = root.with_table("acl_policies", t) \
                       .with_index("acl_policies", index)
            self._publish(root)

    def delete_acl_policies(self, index: int, names: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("acl_policies")
            for name in names:
                t = t.delete(name)
            root = root.with_table("acl_policies", t) \
                       .with_index("acl_policies", index)
            self._publish(root)

    # -- namespaces (state_store.go:5565) ------------------------------
    def upsert_namespaces(self, index: int, namespaces: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("namespaces")
            for ns in namespaces:
                existing = t.get(ns.name)
                ns.create_index = existing.create_index if existing \
                    else index
                ns.modify_index = index
                t = t.set(ns.name, ns)
            root = root.with_table("namespaces", t) \
                       .with_index("namespaces", index)
            self._publish(root)

    def delete_namespaces(self, index: int, names: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("namespaces")
            for name in names:
                t = t.delete(name)
            root = root.with_table("namespaces", t) \
                       .with_index("namespaces", index)
            self._publish(root)

    # -- service registry (built-in catalog; the reference delegates
    # -- to Consul via command/agent/consul/service_client.go) ---------
    def upsert_service_registrations(self, index: int,
                                     services: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("service_registrations")
            for s in services:
                existing = t.get(s.id)
                # own the row: in-proc transports hand us the client's
                # LIVE objects, and its check threads keep mutating them
                s = replace(s, tags=list(s.tags), checks=dict(s.checks))
                s.create_index = existing.create_index if existing \
                    else index
                s.modify_index = index
                if existing is not None and \
                        (existing.namespace, existing.service_name) != \
                        (s.namespace, s.service_name):
                    root = self._index_del(
                        root, "services_by_name",
                        (existing.namespace, existing.service_name),
                        s.id)
                t = t.set(s.id, s)
                root = self._index_add(root, "services_by_name",
                                       (s.namespace, s.service_name),
                                       s.id)
                root = self._index_add(root, "services_by_alloc",
                                       s.alloc_id, s.id)
            root = root.with_table("service_registrations", t) \
                       .with_index("service_registrations", index)
            self._publish(root)

    def delete_service_registrations(self, index: int,
                                     ids: Optional[List[str]] = None,
                                     alloc_ids: Optional[List[str]] = None
                                     ) -> None:
        """Remove catalog rows by id and/or every row an alloc owns."""
        with self._lock:
            root = self._root.edit()
            t = root.table("service_registrations")
            doomed = list(ids or [])
            for alloc_id in alloc_ids or []:
                members = root.table("services_by_alloc").get(alloc_id)
                if members is not None:
                    doomed.extend(members.keys())
            changed = False
            for rid in doomed:
                s = t.get(rid)
                if s is None:
                    continue
                t = t.delete(rid)
                root = self._index_del(root, "services_by_name",
                                       (s.namespace, s.service_name),
                                       rid)
                root = self._index_del(root, "services_by_alloc",
                                       s.alloc_id, rid)
                changed = True
            if changed:
                root = root.with_table("service_registrations", t) \
                           .with_index("service_registrations", index)
                self._publish(root)

    def acl_policy(self, name: str):
        return self._root.table("acl_policies").get(name)

    def acl_policies(self) -> List:
        return sorted(self._root.table("acl_policies").values(),
                      key=lambda p: p.name)

    def upsert_acl_tokens(self, index: int, tokens: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("acl_tokens")
            for tok in tokens:
                existing = t.get(tok.accessor_id)
                tok.create_index = existing.create_index if existing \
                    else index
                tok.modify_index = index
                t = t.set(tok.accessor_id, tok)
                root = root.with_table("acl_tokens", t)
                root = self._index_add(root, "acl_tokens_by_secret",
                                       tok.secret_id, tok.accessor_id)
            root = root.with_table("acl_tokens", t) \
                       .with_index("acl_tokens", index)
            self._publish(root)

    def delete_acl_tokens(self, index: int, accessor_ids: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("acl_tokens")
            for aid in accessor_ids:
                tok = t.get(aid)
                if tok is None:
                    continue
                t = t.delete(aid)
                root = self._index_del(root, "acl_tokens_by_secret",
                                       tok.secret_id, aid)
            root = root.with_table("acl_tokens", t) \
                       .with_index("acl_tokens", index)
            self._publish(root)

    def acl_token_by_accessor(self, accessor_id: str):
        return self._root.table("acl_tokens").get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        members = self._root.table("acl_tokens_by_secret").get(secret_id)
        if not members:
            return None
        for aid in members.keys():
            return self._root.table("acl_tokens").get(aid)
        return None

    def acl_tokens(self) -> List:
        return sorted(self._root.table("acl_tokens").values(),
                      key=lambda t: t.accessor_id)

    # -- Vault accessors (state_store.go UpsertVaultAccessor:5743) -----
    def upsert_vault_accessors(self, index: int, accessors: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("vault_accessors")
            for a in accessors:
                existing = t.get(a.accessor)
                a.create_index = existing.create_index if existing else index
                a.modify_index = index
                t = t.set(a.accessor, a)
                if existing is None:
                    root = self._index_add(root, "vault_accessors_by_alloc",
                                           a.alloc_id, a.accessor)
                    root = self._index_add(root, "vault_accessors_by_token",
                                           a.token, a.accessor)
            root = root.with_table("vault_accessors", t) \
                       .with_index("vault_accessors", index)
            self._publish(root)

    def delete_vault_accessors(self, index: int,
                               accessor_ids: List[str]) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("vault_accessors")
            for aid in accessor_ids:
                a = t.get(aid)
                if a is None:
                    continue
                t = t.delete(aid)
                root = self._index_del(root, "vault_accessors_by_alloc",
                                       a.alloc_id, aid)
                root = self._index_del(root, "vault_accessors_by_token",
                                       a.token, aid)
            root = root.with_table("vault_accessors", t) \
                       .with_index("vault_accessors", index)
            self._publish(root)

    def vault_accessor(self, accessor: str):
        return self._root.table("vault_accessors").get(accessor)

    def vault_accessors(self) -> List:
        return sorted(self._root.table("vault_accessors").values(),
                      key=lambda a: a.accessor)

    def vault_accessors_by_alloc(self, alloc_id: str) -> List:
        """Leases minted for one allocation (state_store.go
        VaultTokenAccessorsByAlloc) — the terminal-alloc revocation
        hot path must not scan the whole lease table."""
        return self._by_index("vault_accessors_by_alloc", alloc_id,
                              "vault_accessors")

    def vault_accessor_by_token(self, token: str):
        ids = self._root.table("vault_accessors_by_token").get(token)
        if not ids:
            return None
        t = self._root.table("vault_accessors")
        for aid in ids.keys():
            return t.get(aid)
        return None

    # -- CSI volumes (state_store.go CSIVolume*) -----------------------
    def upsert_csi_volumes(self, index: int, volumes: List) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("csi_volumes")
            for v in volumes:
                existing = t.get((v.namespace, v.id))
                v.create_index = existing.create_index if existing else index
                v.modify_index = index
                t = t.set((v.namespace, v.id), v)
            root = root.with_table("csi_volumes", t) \
                       .with_index("csi_volumes", index)
            self._publish(root)

    def delete_csi_volume(self, index: int, namespace: str,
                          volume_id: str) -> None:
        with self._lock:
            root = self._root.edit()
            t = root.table("csi_volumes").delete((namespace, volume_id))
            root = root.with_table("csi_volumes", t) \
                       .with_index("csi_volumes", index)
            self._publish(root)

    def csi_volume(self, namespace: str, volume_id: str):
        return self._root.table("csi_volumes").get((namespace, volume_id))

    def csi_volumes(self, namespace: Optional[str] = None) -> List:
        vols = list(self._root.table("csi_volumes").values())
        if namespace is not None:
            vols = [v for v in vols if v.namespace == namespace]
        return sorted(vols, key=lambda v: (v.namespace, v.id))

    def _claim_csi_for_placements(self, root: _Root, index: int,
                                  allocs_placed) -> _Root:
        from dataclasses import replace as _replace
        for a in allocs_placed:
            job = a.job or root.table("jobs").get((a.namespace, a.job_id))
            tg = job.lookup_task_group(a.task_group) if job else None
            if tg is None or not tg.volumes:
                continue
            for req in tg.volumes.values():
                if getattr(req, "type", "host") != "csi":
                    continue
                t = root.table("csi_volumes")
                v = t.get((a.namespace, req.source))
                if v is None:
                    continue
                # re-check capacity PER placement against the claims
                # already applied in this batch: a count>1 group (or two
                # groups in one plan) must not exceed a single-writer
                # access mode (csi.go WriteFreeClaims:385 is per-claim)
                read_only = bool(req.read_only)
                if not v.claimable(read_only) and \
                        a.id not in v.write_allocs and \
                        a.id not in v.read_allocs:
                    LOG.warning(
                        "csi claim for alloc %s on volume %s/%s exceeds "
                        "access mode %s; skipping claim", a.id,
                        a.namespace, req.source, v.access_mode)
                    continue
                v = _replace(v, read_allocs=dict(v.read_allocs),
                             write_allocs=dict(v.write_allocs),
                             modify_index=index)
                v.claim(a.id, a.node_id, read_only)
                root = root.with_table(
                    "csi_volumes", t.set((a.namespace, req.source), v))
                root = root.with_index("csi_volumes", index)
        return root

    def csi_volume_claim(self, index: int, namespace: str, volume_id: str,
                         alloc_id: str, node_id: str,
                         read_only: bool) -> None:
        from dataclasses import replace as _replace
        with self._lock:
            root = self._root.edit()
            v = root.table("csi_volumes").get((namespace, volume_id))
            if v is None:
                raise KeyError(f"volume {volume_id} not found")
            v = _replace(v, read_allocs=dict(v.read_allocs),
                         write_allocs=dict(v.write_allocs),
                         modify_index=index)
            v.claim(alloc_id, node_id, read_only)
            root = root.with_table(
                "csi_volumes",
                root.table("csi_volumes").set((namespace, volume_id), v))
            root = root.with_index("csi_volumes", index)
            self._publish(root)

    def csi_volume_release(self, index: int, namespace: str,
                           volume_id: str, alloc_id: str) -> None:
        from dataclasses import replace as _replace
        with self._lock:
            root = self._root.edit()
            v = root.table("csi_volumes").get((namespace, volume_id))
            if v is None:
                return
            v = _replace(v, read_allocs=dict(v.read_allocs),
                         write_allocs=dict(v.write_allocs),
                         modify_index=index)
            if not v.release(alloc_id):
                return
            root = root.with_table(
                "csi_volumes",
                root.table("csi_volumes").set((namespace, volume_id), v))
            root = root.with_index("csi_volumes", index)
            self._publish(root)

    # -- checkpoint / restore (fsm.go Snapshot:1360 / Restore:1374) ----
    def restore(self, data: dict) -> None:
        """Rebuild the database from a dump. Replaces all state. Both
        formats restore here: legacy object snapshots (format 1 — one
        wire dict per row) and columnar format-2 snapshots
        (state/columnar.py struct-of-arrays).

        The big three tables land through the same grouped bulk-index
        path a plan apply uses (one sub-table build per key instead of
        one HAMT write per row), the per-job columnar alloc index is
        rebuilt EAGERLY from the loaded rows — a wholesale invalidate
        would make the first eval after recovery pay a dense O(allocs)
        rebuild inside its latency budget — and a columnar
        snapshot leaves its decoded alloc columns on `_cold_columns`
        for the resident NodeTable's vectorized cold build
        (ops/tables.py NodeTable.build_from_columns via
        pop_cold_columns)."""
        from ..models import SchedulerConfiguration
        from ..utils.codec import from_wire
        fmt = int(data.get("format", 1))
        tables = data.get("tables", {})
        cold = None
        if fmt >= 2:
            from .columnar import cold_alloc_columns, decode_table
            cal = data.get("columnar", {})
            dec_allocs = decode_table(Allocation, cal.get("allocs"))
            nodes = decode_table(Node, cal.get("nodes")).objs
            evals = decode_table(Evaluation, cal.get("evals")).objs
            allocs = dec_allocs.objs
            cold = cold_alloc_columns(dec_allocs)
        else:
            nodes = [from_wire(Node, w) for w in tables.get("nodes", [])]
            evals = [from_wire(Evaluation, w)
                     for w in tables.get("evals", [])]
            allocs = [from_wire(Allocation, w)
                      for w in tables.get("allocs", [])]
        with self._lock:
            # invalidate the changelog AND the resident table cache:
            # restore replaces state wholesale, so a cached table at the
            # same numeric index would silently serve pre-restore rows
            self._changes.clear()
            self._change_indexes.clear()
            self._change_floor = max(
                [0] + [int(i) for i in data.get("indexes", {}).values()])
            from ..ops.tables import NodeTableCache
            self.table_cache = NodeTableCache()
            from .alloc_index import AllocIndexCache
            old_ai = self.alloc_index
            self.alloc_index = AllocIndexCache(
                max_jobs=old_ai.max_jobs, delta_max=old_ai.delta_max,
                enabled=old_ai.enabled)
            from .node_attr_index import NodeAttrIndexCache
            self.attr_index = NodeAttrIndexCache(
                enabled=self.attr_index.enabled,
                delta_max=self.attr_index.delta_max)
            root = _Root(_Table(), _Table()).edit()
            if nodes:
                root = root.with_table(
                    "nodes", root.table("nodes").update(
                        [(n.id, n) for n in nodes]))

            t = root.table("jobs")
            for w in tables.get("jobs", []):
                job = from_wire(Job, w)
                t = t.set(job.namespaced_id(), job)
            root = root.with_table("jobs", t)

            t = root.table("job_versions")
            for entry in tables.get("job_versions", []):
                key = tuple(entry["key"])
                versions = _Table()
                for v, w in entry["versions"].items():
                    versions = versions.set(int(v), from_wire(Job, w))
                t = t.set(key, versions)
            root = root.with_table("job_versions", t)

            root = self._bulk_install_evals(root, evals)
            root = self._bulk_install_allocs(root, allocs)

            t = root.table("deployments")
            for w in data["tables"].get("deployments", []):
                d = from_wire(Deployment, w)
                t = t.set(d.id, d)
                root = root.with_table("deployments", t)
                root = self._index_add(root, "deployments_by_job",
                                       (d.namespace, d.job_id), d.id)
                t = root.table("deployments")

            t = root.table("job_summaries")
            for w in data["tables"].get("job_summaries", []):
                s = from_wire(JobSummary, w)
                t = t.set((s.namespace, s.job_id), s)
            root = root.with_table("job_summaries", t)

            t = root.table("periodic_launches")
            for entry in data["tables"].get("periodic_launches", []):
                t = t.set(tuple(entry["key"]), entry["launch_time"])
            root = root.with_table("periodic_launches", t)

            t = root.table("scaling_policies")
            for w in data["tables"].get("scaling_policies", []):
                p = from_wire(ScalingPolicy, w)
                t = t.set(p.id, p)
                root = root.with_table("scaling_policies", t)
                root = self._index_add(
                    root, "scaling_policies_by_job",
                    (p.target.get("Namespace", p.namespace),
                     p.target.get("Job", "")), p.id)
                t = root.table("scaling_policies")
            root = root.with_table("scaling_policies", t)

            members = data["tables"].get("server_members") or []
            if members:
                root = root.with_table(
                    "server_members",
                    root.table("server_members").set("members",
                                                     list(members)))

            from ..server.event_sink import EventSink
            t = root.table("event_sinks")
            for w in data["tables"].get("event_sinks", []):
                s = from_wire(EventSink, w)
                t = t.set(s.id, s)
            root = root.with_table("event_sinks", t)

            t = root.table("scaling_events")
            for entry in data["tables"].get("scaling_events", []):
                t = t.set(tuple(entry["key"]), list(entry["events"]))
            root = root.with_table("scaling_events", t)

            cfg = data["tables"].get("scheduler_config")
            if cfg:
                root = root.with_table(
                    "scheduler_config",
                    root.table("scheduler_config").set(
                        "config", from_wire(SchedulerConfiguration, cfg)))

            from ..models.csi import CSIVolume
            t = root.table("csi_volumes")
            for w in data["tables"].get("csi_volumes", []):
                v = from_wire(CSIVolume, w)
                t = t.set((v.namespace, v.id), v)
            root = root.with_table("csi_volumes", t)

            from ..models.namespace import Namespace
            t = root.table("namespaces")
            for w in data["tables"].get("namespaces", []):
                ns = from_wire(Namespace, w)
                t = t.set(ns.name, ns)
            root = root.with_table("namespaces", t)

            from ..server.vault import VaultAccessor
            t = root.table("vault_accessors")
            for w in data["tables"].get("vault_accessors", []):
                a = from_wire(VaultAccessor, w)
                t = t.set(a.accessor, a)
                root = self._index_add(root, "vault_accessors_by_alloc",
                                       a.alloc_id, a.accessor)
                root = self._index_add(root, "vault_accessors_by_token",
                                       a.token, a.accessor)
            root = root.with_table("vault_accessors", t)

            from ..models.services import ServiceRegistration
            t = root.table("service_registrations")
            for w in data["tables"].get("service_registrations", []):
                s = from_wire(ServiceRegistration, w)
                t = t.set(s.id, s)
                root = root.with_table("service_registrations", t)
                root = self._index_add(root, "services_by_name",
                                       (s.namespace, s.service_name),
                                       s.id)
                root = self._index_add(root, "services_by_alloc",
                                       s.alloc_id, s.id)
                t = root.table("service_registrations")
            root = root.with_table("service_registrations", t)

            from ..acl import AclPolicy, AclToken
            t = root.table("acl_policies")
            for w in data["tables"].get("acl_policies", []):
                p = from_wire(AclPolicy, w)
                t = t.set(p.name, p)
            root = root.with_table("acl_policies", t)
            t = root.table("acl_tokens")
            for w in data["tables"].get("acl_tokens", []):
                tok = from_wire(AclToken, w)
                t = t.set(tok.accessor_id, tok)
                root = root.with_table("acl_tokens", t)
                root = self._index_add(root, "acl_tokens_by_secret",
                                       tok.secret_id, tok.accessor_id)
                t = root.table("acl_tokens")

            for table, index in data.get("indexes", {}).items():
                root = root.with_index(table, index)
            self._publish(root)
            # eager per-job columnar index: the eval that follows
            # recovery reads warm columns, zero dense rebuilds
            if allocs:
                self._prime_alloc_index(allocs, self.index("allocs"))
            self._cold_columns = cold

    def _bulk_install_evals(self, root: _Root, evals: List[Evaluation]
                            ) -> _Root:
        """Restore-grade bulk insert: one outer batch write per table,
        one sub-table build per (namespace, job) — same nested-map
        shape `_index_add` produces row by row."""
        if not evals:
            return root
        root = root.with_table(
            "evals",
            root.table("evals").update([(e.id, e) for e in evals]))
        groups: Dict[Tuple[str, str], List[str]] = {}
        for e in evals:
            groups.setdefault((e.namespace, e.job_id), []).append(e.id)
        t = root.table("evals_by_job")
        pairs = []
        for key, ids in groups.items():
            members = (t.get(key) or _Table()).with_ctx(root._ctx)
            pairs.append((key, members.update(
                [(i, True) for i in ids]).frozen()))
        return root.with_table("evals_by_job", t.update(pairs))

    def _bulk_install_allocs(self, root: _Root,
                             allocs: List[Allocation]) -> _Root:
        """Restore-grade alloc insert: grouped secondary-index builds
        (by node / job / eval) instead of three HAMT writes per row."""
        if not allocs:
            return root
        root = root.with_table(
            "allocs",
            root.table("allocs").update([(a.id, a) for a in allocs]))
        for table, keyfn in (
                ("allocs_by_node", lambda a: a.node_id),
                ("allocs_by_job", lambda a: (a.namespace, a.job_id)),
                ("allocs_by_eval", lambda a: a.eval_id)):
            groups: Dict = {}
            for a in allocs:
                groups.setdefault(keyfn(a), []).append(a.id)
            t = root.table(table)
            pairs = []
            for key, ids in groups.items():
                members = (t.get(key) or _Table()).with_ctx(root._ctx)
                pairs.append((key, members.update(
                    [(i, True) for i in ids]).frozen()))
            root = root.with_table(table, t.update(pairs))
        return root

    def _prime_alloc_index(self, allocs: List[Allocation],
                           index: int) -> None:
        """Rebuild the per-job columnar alloc index eagerly from
        freshly loaded rows (a wholesale invalidate would make the
        eval after recovery pay a dense O(allocs) rebuild —
        `alloc_index.stats["rebuilds"]` must stay 0 after a restore).
        Bounded by the cache's max_jobs, largest
        jobs first: the entries most expensive to rebuild are the ones
        kept warm."""
        ai = self.alloc_index
        if not ai.enabled:
            return
        from .alloc_index import JobAllocColumns
        groups: Dict[Tuple[str, str], List[Allocation]] = {}
        for a in allocs:
            groups.setdefault((a.namespace, a.job_id), []).append(a)
        keys = sorted(groups, key=lambda k: -len(groups[k]))
        for key in keys[:ai.max_jobs]:
            ai.install(key, JobAllocColumns.build(groups[key]), index)

    def pop_cold_columns(self):
        """One-shot handoff of the last restore's decoded alloc columns
        to the resident-table prime (NodeTableCache.prime; None after a
        legacy-format restore)."""
        cold = getattr(self, "_cold_columns", None)
        self._cold_columns = None
        return cold

    # -- job status reconciliation (fsm setJobStatus analog) ----------
    def set_job_status(self, index: int, namespace: str, job_id: str,
                       status: str, description: str = "") -> None:
        with self._lock:
            root = self._root.edit()
            key = (namespace, job_id)
            job = root.table("jobs").get(key)
            if job is None:
                return
            old_status = job.status
            job = replace(job, status=status, status_description=description,
                          modify_index=index)
            root = root.with_table("jobs", root.table("jobs").set(key, job))
            root = root.with_index("jobs", index)
            if job.parent_id and old_status != status:
                root = self._bump_parent_children(
                    root, index, (namespace, job.parent_id), old_status, status)
            self._publish(root)

    def derive_job_status(self, namespace: str, job_id: str) -> Optional[str]:
        """Compute what a job's status should be from its allocs + evals
        (state_store.go getJobStatus): stop -> dead; any non-terminal
        alloc -> running; any non-terminal eval -> pending; periodic /
        parameterized parents idle at running; else dead once it has
        history, pending when brand new."""
        job = self.job_by_id(namespace, job_id)
        if job is None:
            return None
        if job.stop:
            return JOB_STATUS_DEAD
        allocs = self.allocs_by_job(namespace, job_id)
        for a in allocs:
            if not a.terminal_status():
                return JOB_STATUS_RUNNING
        evals = self.evals_by_job(namespace, job_id)
        has_eval = False
        for e in evals:
            if e.job_id != job_id:
                continue
            has_eval = True
            if not e.terminal_status():
                return JOB_STATUS_PENDING
        if (job.periodic is not None and job.periodic.enabled) or \
                (job.parameterized_job is not None and not job.dispatched):
            return JOB_STATUS_RUNNING
        if allocs or has_eval:
            return JOB_STATUS_DEAD
        return JOB_STATUS_PENDING

    def reconcile_job_status(self, index: int, namespace: str,
                             job_id: str) -> None:
        want = self.derive_job_status(namespace, job_id)
        job = self.job_by_id(namespace, job_id)
        if want is None or job is None or job.status == want:
            return
        self.set_job_status(index, namespace, job_id, want)

    @staticmethod
    def _children_bucket(status: str) -> Optional[str]:
        return {JOB_STATUS_PENDING: "children_pending",
                JOB_STATUS_RUNNING: "children_running",
                JOB_STATUS_DEAD: "children_dead"}.get(status)

    def _bump_parent_children(self, root: _Root, index: int, parent_key,
                              old_status: Optional[str],
                              new_status: Optional[str]) -> _Root:
        """Maintain the parent JobSummary children counters
        (state_store.go setJobSummary children accounting)."""
        summaries = root.table("job_summaries")
        s: Optional[JobSummary] = summaries.get(parent_key)
        if s is None:
            return root
        ob = self._children_bucket(old_status) if old_status else None
        nb = self._children_bucket(new_status) if new_status else None
        if ob == nb:
            return root
        changes = {}
        if ob is not None:
            changes[ob] = max(0, getattr(s, ob) - 1)
        if nb is not None:
            changes[nb] = getattr(s, nb) + 1
        s = replace(s, modify_index=index, **changes)
        return root.with_table("job_summaries", summaries.set(parent_key, s)) \
                   .with_index("job_summaries", index)
