"""Server persistence: write-ahead log + state snapshots.

Reference semantics: the Raft log (raft-boltdb) + FSM snapshots
(nomad/fsm.go Snapshot:1360 persists every table, Restore:1374 rebuilds
memdb; nomad/server.go:1214 setupRaft). Single-node: the log is
an append-only file of msgpack-framed (index, type, payload) entries
written BEFORE the FSM applies them (WAL discipline); snapshots dump the
whole store and truncate the log. Restore = load snapshot + replay the
log tail. The encode/decode schema per apply type lives here so a
replicated log can reuse it unchanged.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import msgpack

from ..models import (Allocation, Deployment, Evaluation, Job, Node,
                      SchedulerConfiguration)
from ..models.alloc import DesiredTransition
from ..models.deployment import DeploymentStatusUpdate
from ..models.node import DrainStrategy
from ..utils.codec import from_wire, to_wire
from ..utils.locks import make_lock

# payload field -> model type (list-wrapped == repeated)
SCHEMAS: Dict[str, Dict[str, Any]] = {
    "job_register": {"job": Job, "evals": [Evaluation]},
    "job_deregister": {"evals": [Evaluation]},
    "eval_update": {"evals": [Evaluation]},
    "eval_delete": {},
    "node_register": {"node": Node},
    "node_deregister": {},
    "node_status_update": {"evals": [Evaluation]},
    "node_eligibility_update": {},
    "node_drain_update": {"drain_strategy": DrainStrategy},
    "alloc_client_update": {"allocs": [Allocation], "evals": [Evaluation]},
    "plan_results": {"allocs_stopped": [Allocation],
                     "allocs_placed": [Allocation],
                     "allocs_preempted": [Allocation],
                     "deployment": Deployment,
                     "deployment_updates": [DeploymentStatusUpdate],
                     "evals": [Evaluation]},
    # group-commit applier: one entry carrying N plan_results payloads
    # (encode/decode recurse per group member — see below)
    "plan_group_results": {},
    # batched write ingest: one entry carrying N kind-tagged
    # sub-payloads (job_register / alloc_client_update /
    # alloc_desired_transition); encode/decode recurse per entry by its
    # "kind" key — see below
    "ingest_batch": {},
    "scheduler_config": {"config": SchedulerConfiguration},
    "deployment_status_update": {"update": DeploymentStatusUpdate,
                                 "job": Job, "evals": [Evaluation]},
    "deployment_promotion": {"evals": [Evaluation]},
    "alloc_desired_transition": {"transition": DesiredTransition,
                                 "evals": [Evaluation]},
    "job_stability": {},
    "scaling_event": {},
    "server_membership": {},
    "noop": {},
    "deployment_delete": {},
    "periodic_launch": {},
}


def _register_acl_schemas() -> None:
    # deferred, as the JAX package's copy registers them (there acl/
    # imports jobspec, which imports models)
    from ..acl import AclPolicy, AclToken
    from ..models.csi import CSIVolume
    SCHEMAS.update({
        "acl_policy_upsert": {"policies": [AclPolicy]},
        "acl_policy_delete": {},
        "acl_token_upsert": {"tokens": [AclToken]},
        "acl_token_delete": {},
        "csi_volume_register": {"volumes": [CSIVolume]},
        "csi_volume_deregister": {},
        "csi_volume_claim": {},
        "csi_volume_release": {},
    })
    from .event_sink import EventSink
    SCHEMAS.update({
        "event_sink_upsert": {"sink": EventSink},
        "event_sink_delete": {},
        "event_sink_progress": {},
    })
    from ..models.services import ServiceRegistration
    SCHEMAS.update({
        "service_registration_upsert": {"services": [ServiceRegistration]},
        "service_registration_delete": {},
    })
    from ..models.namespace import Namespace
    SCHEMAS.update({
        "namespace_upsert": {"namespaces": [Namespace]},
        "namespace_delete": {},
    })


_register_acl_schemas()


def encode_payload(msg_type: str, payload: dict) -> dict:
    if msg_type == "plan_group_results":
        return {"groups": [encode_payload("plan_results", g)
                           for g in payload.get("groups", [])]}
    if msg_type == "ingest_batch":
        # each sub-entry encodes under its own kind's schema; the
        # "kind" tag itself is a plain string and rides through
        return {"entries": [encode_payload(e.get("kind", ""), e)
                            for e in payload.get("entries", [])]}
    out = {}
    for k, v in payload.items():
        out[k] = to_wire(v)
    return out


def decode_payload(msg_type: str, data: dict) -> dict:
    if msg_type == "plan_group_results":
        return {"groups": [decode_payload("plan_results", g)
                           for g in data.get("groups", [])]}
    if msg_type == "ingest_batch":
        return {"entries": [decode_payload(e.get("kind", ""), e)
                            for e in data.get("entries", [])]}
    schema = SCHEMAS.get(msg_type, {})
    out: dict = {}
    for k, v in data.items():
        hint = schema.get(k)
        if hint is None:
            out[k] = v
        elif isinstance(hint, list):
            out[k] = [from_wire(hint[0], x) for x in (v or [])]
        else:
            out[k] = from_wire(hint, v) if v is not None else None
    return out


class RaftLog:
    """Append-only WAL of msgpack frames: [u32 length][payload]."""

    def __init__(self, path: str):
        self.path = path
        self._l = make_lock()
        self._f: Optional[BinaryIO] = None
        self._good_offset: Optional[int] = None
        self._dirty = False      # flushed-but-not-fsynced bytes pending
        self._trunc_shift = 0    # bytes dropped by truncate_prefix

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        # a torn tail from a crash must be truncated before appending,
        # or the garbage bytes poison every later frame on next replay
        if self._good_offset is not None and os.path.exists(self.path) \
                and os.path.getsize(self.path) > self._good_offset:
            with open(self.path, "r+b") as f:
                f.truncate(self._good_offset)
        self._f = open(self.path, "ab")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def append(self, index: int, msg_type: str, payload: dict,
               sync: bool = False) -> None:
        import time as _time
        frame = msgpack.packb(
            {"i": index, "t": msg_type, "ts": _time.time(),
             "p": encode_payload(msg_type, payload)},
            use_bin_type=True)
        with self._l:
            self._f.write(struct.pack("<I", len(frame)))
            self._f.write(frame)
            self._f.flush()
            if sync:
                os.fsync(self._f.fileno())
                self._dirty = False
            else:
                self._dirty = True

    def sync(self) -> None:
        """Group-fsync point: ONE fsync covers every append since the
        last sync (the WAL analog of the group-commit applier — the
        raft FSM calls it once per committed apply batch)."""
        with self._l:
            if self._f is not None and self._dirty:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._dirty = False

    def size(self) -> int:
        """Current ABSOLUTE stream position (bytes ever appended,
        including prefixes already truncated away) — the snapshot's
        truncation mark. Absolute marks stay valid even if another
        snapshot writer truncates the file between capture and use;
        `_trunc_shift` tracks the bytes removed so far."""
        with self._l:
            if self._f is not None:
                return self._trunc_shift + self._f.tell()
            phys = os.path.getsize(self.path) \
                if os.path.exists(self.path) else 0
            return self._trunc_shift + phys

    def truncate_prefix(self, mark: int) -> None:
        """Drop the log prefix before absolute position `mark` (covered
        by a completed snapshot), KEEPING the tail appended while the
        snapshot was serializing off-thread — a whole-file truncate
        here would lose entries the snapshot does not contain. A mark
        at or below an already-truncated prefix is a no-op, so two
        racing snapshot writers can never cut at a stale offset."""
        with self._l:
            local = mark - self._trunc_shift
            if local <= 0 or not os.path.exists(self.path):
                return
            was_open = self._f is not None
            if was_open:
                self._f.close()
                self._f = None
            with open(self.path, "rb") as f:
                f.seek(local)
                tail = f.read()
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(tail)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._trunc_shift += local
            if was_open:
                self._f = open(self.path, "ab")
            self._dirty = False

    def replay(self) -> List[Tuple[int, str, dict]]:
        """Read all entries; tolerates a torn final frame (crash)."""
        out: List[Tuple[int, str, dict]] = []
        self._good_offset = 0
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as f:
            while True:
                header = f.read(4)
                if len(header) < 4:
                    break
                (length,) = struct.unpack("<I", header)
                frame = f.read(length)
                if len(frame) < length:
                    break  # torn write at crash: drop the tail
                try:
                    entry = msgpack.unpackb(frame, raw=False)
                    decoded = decode_payload(entry["t"], entry["p"])
                except Exception:
                    break  # corrupt frame: treat like a torn tail
                out.append((entry["i"], entry["t"], decoded,
                            entry.get("ts", 0.0)))
                self._good_offset = f.tell()
        return out

class Persistence:
    """Snapshot + WAL pair under a data directory."""

    SNAPSHOT = "state.snap"
    WAL = "raft.log"
    # measured per-(arm, n_pad) dispatch costs (ops/select.py
    # DispatchCostModel.snapshot() format: {"<arm>@<n_pad>":
    # {"ewma_s": float, "samples": int}}), persisted as JSON next to
    # the state snapshot so a restarted server's routing/batching
    # decisions start measured instead of cold. Host+device
    # local by construction — never replicated, safe to delete
    COST_MODEL = "cost_model.json"

    def __init__(self, data_dir: str, snapshot_every: int = 1024, *,
                 columnar: bool = True, background: bool = True,
                 wal_fsync: bool = False, wal_group_fsync: bool = True):
        self.data_dir = data_dir
        self.snapshot_every = snapshot_every
        # snapshot format 2 (state/columnar.py struct-of-arrays) vs the
        # legacy per-object dump; restore auto-detects either
        self.columnar = columnar
        # serialize + write snapshots on a background thread off an
        # O(1) MVCC store snapshot, so maybe_snapshot never stalls the
        # commit path
        self.background = background
        # WAL durability: fsync appends at all (off matches the
        # flush-only behavior), and whether a committed apply
        # batch pays ONE fsync (group) or one per entry
        self.wal_fsync = wal_fsync
        self.wal_group_fsync = wal_group_fsync
        os.makedirs(data_dir, exist_ok=True)
        self.log = RaftLog(os.path.join(data_dir, self.WAL))
        self._since_snapshot = 0
        self._l = make_lock()
        self._snap_l = make_lock()      # one snapshot writer
        self._trigger_l = make_lock()
        self._snap_thread: Optional[threading.Thread] = None
        # absolute WAL mark of the newest PUBLISHED snapshot: a writer
        # whose capture is older must not replace it (a sync snapshot
        # racing a slow background writer), monotone under _snap_l
        self._published_mark = -1
        # counters are += read-modify-writes from the applier (trigger
        # path, under _trigger_l), the writer thread (under _snap_l),
        # and boot restore — no shared lock between them, so they get
        # their own
        self._stats_l = make_lock()
        # nomad-lint: guarded-by[_stats_l]
        self.stats: Dict[str, Any] = {
            "snapshots": 0, "background_snapshots": 0,
            "snapshot_skipped_inflight": 0, "last_snapshot_s": 0.0,
            "last_snapshot_format": 0, "snapshot_errors": 0,
            "restore_s": 0.0, "restore_format": 0,
        }
        # server-level state (e.g. the GC TimeTable) rides along in the
        # snapshot under "extra"; the provider is set by the Server
        self.extra_provider = None
        # set by the Server: returns the live cost-model snapshot dict;
        # written on every state snapshot and at shutdown
        self.cost_model_provider = None
        self.restored_extra: dict = {}

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.data_dir, self.SNAPSHOT)

    @property
    def cost_model_path(self) -> str:
        return os.path.join(self.data_dir, self.COST_MODEL)

    def load_cost_model(self) -> dict:
        import json
        try:
            with open(self.cost_model_path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    def save_cost_model(self) -> None:
        import json
        if self.cost_model_provider is None:
            return
        snap = self.cost_model_provider()
        if not snap:
            return
        tmp = self.cost_model_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=0, sort_keys=True)
        os.replace(tmp, self.cost_model_path)

    def restore_into(self, store
                     ) -> Tuple[int, List[Tuple[int, str, dict, float]]]:
        """Load the snapshot into the store and read the WAL tail.
        Returns ``(highest, entries)``: the snapshot's highest applied
        index (0 if fresh) and the decoded WAL entries for the caller
        to replay (each ``(index, msg_type, payload, ts)``). Both
        snapshot formats restore here — the columnar format-2 file and
        the legacy per-object dump (state/store.py restore
        auto-detects). A leftover ``state.snap.tmp`` from a crash
        mid-snapshot is ignored (os.replace is atomic, so the prior
        snapshot + un-truncated WAL are intact) and cleaned up."""
        import time as _time
        from ..utils import stages
        t0 = _time.perf_counter()
        highest = 0
        tmp = self.snapshot_path + ".tmp"
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:     # pragma: no cover — best effort
                pass
        if os.path.exists(self.snapshot_path):
            with open(self.snapshot_path, "rb") as f:
                data = msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False)
            # snapshot index tuples were listified by msgpack
            self.restored_extra = data.pop("extra", {}) or {}
            with self._stats_l:
                self.stats["restore_format"] = int(data.get("format", 1))
            store.restore(data)
            highest = store.latest_index()
        entries = self.log.replay()
        self.log.open()
        with self._stats_l:
            self.stats["restore_s"] = _time.perf_counter() - t0
        if stages.enabled:
            stages.add("restore", self.stats["restore_s"])
        return highest, entries

    def record(self, index: int, msg_type: str, payload: dict) -> None:
        self.log.append(index, msg_type, payload,
                        sync=self.wal_fsync and not self.wal_group_fsync)

    def commit_barrier(self) -> None:
        """Group-fsync boundary: called once per committed apply batch
        (raft.py _fsm_loop; the dev-mode apply calls it per entry —
        there the entry IS the commit unit). One fsync covers every
        record() since the last barrier."""
        if self.wal_fsync and self.wal_group_fsync:
            self.log.sync()

    def maybe_snapshot(self, store) -> None:
        """Called AFTER the FSM applied the entry — a snapshot capture
        here includes it, so dropping the covered WAL prefix is safe.
        Only TRIGGERS the snapshot: the capture is an O(1) MVCC root +
        WAL mark, and serialization/writing run on a background thread
        (snapshot_background), so the applier never blocks on a dump
        of a large store."""
        with self._l:
            self._since_snapshot += 1
            if self._since_snapshot < self.snapshot_every:
                return
            self._since_snapshot = 0
        self.trigger_snapshot(store)

    def trigger_snapshot(self, store) -> Optional[threading.Thread]:
        """Capture (MVCC snapshot, extra, WAL mark) NOW; serialize and
        write off-thread. Returns the writer thread, or None when the
        write ran inline (background off) or was skipped because one
        is already in flight (the next threshold retriggers)."""
        with self._trigger_l:
            t = self._snap_thread
            if t is not None and t.is_alive():
                with self._stats_l:
                    self.stats["snapshot_skipped_inflight"] += 1
                return None
            snap = store.snapshot()
            extra = self.extra_provider() \
                if self.extra_provider is not None else None
            mark = self.log.size()
            if not self.background:
                self._write_snapshot(snap, extra, mark)
                return None
            t = threading.Thread(target=self._write_snapshot,
                                 args=(snap, extra, mark), daemon=True,
                                 name="snapshot-writer")
            self._snap_thread = t
            t.start()
            with self._stats_l:
                self.stats["background_snapshots"] += 1
            return t

    def snapshot(self, store) -> None:
        """Synchronous snapshot (shutdown, snapshot-install reseed,
        tests): waits out any in-flight background writer, then writes
        inline."""
        self.wait_idle()
        with self._trigger_l:
            snap = store.snapshot()
            extra = self.extra_provider() \
                if self.extra_provider is not None else None
            mark = self.log.size()
        self._write_snapshot(snap, extra, mark)

    def wait_idle(self, timeout_s: float = 30.0) -> None:
        """Join an in-flight background snapshot writer (shutdown)."""
        with self._trigger_l:
            t = self._snap_thread
        if t is not None and t.is_alive():
            t.join(timeout_s)

    def _write_snapshot(self, snap, extra: Optional[dict],
                        wal_mark: int) -> None:
        """Serialize + atomically publish one captured snapshot, then
        drop the WAL prefix it covers (entries appended after the
        capture survive in the tail)."""
        import time as _time
        t0 = _time.perf_counter()
        try:
            with self._snap_l:
                if wal_mark < self._published_mark:
                    # a newer capture already published while this one
                    # waited: replacing it would pair an OLDER snapshot
                    # with a MORE-truncated WAL and lose the gap
                    return
                data = snap.dump_columnar() if self.columnar \
                    else snap.dump()
                if extra is not None:
                    data["extra"] = extra
                blob = msgpack.packb(data, use_bin_type=True)
                tmp = self.snapshot_path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.snapshot_path)
                self.log.truncate_prefix(wal_mark)
                self._published_mark = wal_mark
                with self._stats_l:
                    self.stats["snapshots"] += 1
                    self.stats["last_snapshot_s"] = \
                        _time.perf_counter() - t0
                    self.stats["last_snapshot_format"] = \
                        int(data.get("format", 1))
                try:
                    self.save_cost_model()
                except OSError:     # pragma: no cover — best effort
                    pass
        except Exception:           # pragma: no cover — a failed
            # snapshot must not kill the applier or the writer thread;
            # the WAL keeps everything, the next threshold retries
            import logging
            logging.getLogger("nomad_tpu.persistence").exception(
                "snapshot write failed")
            with self._stats_l:
                self.stats["snapshot_errors"] += 1
