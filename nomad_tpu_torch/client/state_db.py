"""Client-side durable state: alloc/task/driver-handle transitions.

Reference: client/state/state_database.go persists every alloc, task
state, and driver task-handle transition to boltdb so a restarted
client can re-attach to live tasks (client.go restoreState:1055,
task_runner.go RestoreState:996). Here the store is an append-only
JSONL journal with snapshot compaction — the same shape as the server's
WAL (server/persistence.py), sized for a node agent's update rate.

Layout under state_dir:
    client.json        — node identity (id, secret) — client.go keeps
                         the node ID stable across restarts
    state.snap.json    — last compacted snapshot
    state.journal      — JSONL of entries since the snapshot
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

COMPACT_EVERY = 512


class ClientStateDB:
    def __init__(self, state_dir: str):
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self._snap_path = os.path.join(state_dir, "state.snap.json")
        self._journal_path = os.path.join(state_dir, "state.journal")
        self._identity_path = os.path.join(state_dir, "client.json")
        # alloc_id -> {"alloc": wire-dict,
        #              "tasks": {name: {"state":..., "handle":...}}}
        self.state: Dict[str, dict] = {}
        self._journal_len = 0
        self._journal_f = None
        self._load()

    # -- node identity -------------------------------------------------
    def load_identity(self) -> Optional[dict]:
        try:
            with open(self._identity_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def save_identity(self, node_id: str, secret_id: str) -> None:
        tmp = self._identity_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"node_id": node_id, "secret_id": secret_id}, f)
        os.replace(tmp, self._identity_path)

    # -- load / compact -----------------------------------------------
    def _load(self) -> None:
        try:
            with open(self._snap_path) as f:
                self.state = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            self.state = {}
        try:
            with open(self._journal_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._apply(json.loads(line))
                        self._journal_len += 1
                    except json.JSONDecodeError:
                        break      # torn tail write: ignore the rest
        except FileNotFoundError:
            pass

    def _apply(self, entry: dict) -> None:
        op = entry.get("op")
        aid = entry.get("alloc_id", "")
        if op == "put_alloc":
            rec = self.state.setdefault(aid, {"tasks": {}})
            rec["alloc"] = entry["alloc"]
        elif op == "put_task":
            rec = self.state.setdefault(aid, {"tasks": {}})
            rec.setdefault("tasks", {})[entry["task"]] = {
                "state": entry.get("state"),
                "handle": entry.get("handle"),
                "vault_lease": entry.get("vault_lease"),
            }
        elif op == "del_alloc":
            self.state.pop(aid, None)

    def _append(self, entry: dict) -> None:
        self._apply(entry)
        if self._journal_f is None:
            self._journal_f = open(self._journal_path, "a")
        self._journal_f.write(json.dumps(entry) + "\n")
        self._journal_f.flush()
        self._journal_len += 1
        if self._journal_len >= COMPACT_EVERY:
            self.compact()

    def compact(self) -> None:
        tmp = self._snap_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self._snap_path)
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None
        with open(self._journal_path, "w"):
            pass
        self._journal_len = 0

    def close(self) -> None:
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None

    # -- writes --------------------------------------------------------
    def put_alloc(self, alloc) -> None:
        from ..utils.codec import to_wire
        self._append({"op": "put_alloc", "alloc_id": alloc.id,
                      "alloc": to_wire(alloc)})

    def put_task(self, alloc_id: str, task: str, state,
                 handle_state: Optional[dict],
                 vault_lease: Optional[dict] = None) -> None:
        from ..utils.codec import to_wire
        self._append({"op": "put_task", "alloc_id": alloc_id,
                      "task": task, "state": to_wire(state),
                      "handle": handle_state,
                      "vault_lease": vault_lease})

    def delete_alloc(self, alloc_id: str) -> None:
        self._append({"op": "del_alloc", "alloc_id": alloc_id})
