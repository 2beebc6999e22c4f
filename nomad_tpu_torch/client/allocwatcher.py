"""Previous-allocation watcher: wait for the predecessor to terminate
and migrate its ephemeral disk into the replacement's alloc dir.

Reference: client/allocwatcher/alloc_watcher.go — a replacement alloc
(previous_allocation set) blocks its tasks until the watched alloc is
terminal; with ephemeral_disk {migrate = true} the shared data dir and
each task's local dir move over — locally when the predecessor ran on
this node, remotely via the owning client's fs API otherwise
(migrateRemoteAllocDir). sticky-without-migrate moves local data only.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Optional

LOG = logging.getLogger("nomad_tpu.allocwatcher")

WAIT_PREV_TIMEOUT_S = 120.0
POLL_S = 0.5

# the dir set that migrates (allocwatcher: SharedAllocDir data + task
# local dirs)
def _migrate_paths(task_names):
    return ["alloc/data"] + [f"{t}/local" for t in task_names]


def wait_for_previous(get_alloc, prev_id: str,
                      timeout_s: float = WAIT_PREV_TIMEOUT_S):
    """Block until the previous alloc is terminal. Returns
    (status, record) where status is 'terminal' (record carries node
    info), 'gone' (GC'd — nothing to migrate), or 'timeout' (still
    running — migrating now would copy a torn mid-write disk)."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        try:
            last = get_alloc(prev_id)
        except Exception:
            # transient server unreachability must NOT read as "GC'd"
            # — that would silently skip a migration whose data still
            # exists. Keep retrying until the deadline.
            time.sleep(POLL_S)
            continue
        if last is None:
            return "gone", None             # GC'd: nothing to wait on
        status = (last.get("alloc") or {}).get("client_status", "")
        desired = (last.get("alloc") or {}).get("desired_status", "")
        if status in ("complete", "failed", "lost"):
            return "terminal", last
        if desired not in ("stop", "evict") and status not in (
                "pending", "running"):
            return "terminal", last
        time.sleep(POLL_S)
    LOG.warning("previous alloc %s did not terminate within %.0fs; "
                "proceeding without migration", prev_id[:8], timeout_s)
    return "timeout", last


def _copy_local(src_base: str, dst_base: str, rel_paths) -> int:
    moved = 0
    for rel in rel_paths:
        src = os.path.join(src_base, rel)
        dst = os.path.join(dst_base, rel)
        if not os.path.isdir(src):
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copytree(src, dst, dirs_exist_ok=True, symlinks=True)
        moved += 1
    return moved


def _fetch_remote_tree(rpc_call, prev_id: str, rel: str,
                       dst: str) -> None:
    """Recursive pull of one dir over the owning client's fs API
    (ClientFS.List/Cat — the remote side of migrateRemoteAllocDir)."""
    entries = rpc_call("ClientFS.List",
                       {"alloc_id": prev_id, "path": rel})["Entries"]
    if entries is None:
        return
    os.makedirs(dst, exist_ok=True)
    for e in entries:
        name = e["Name"]
        sub_rel = f"{rel}/{name}"
        sub_dst = os.path.join(dst, name)
        if e.get("IsDir"):
            _fetch_remote_tree(rpc_call, prev_id, sub_rel, sub_dst)
        else:
            # CHUNKED pull via the frame stream: a whole-file Cat
            # would buffer multi-GB files in RAM on both ends and
            # blow the RPC timeout exactly when migration matters
            offset = 0
            with open(sub_dst, "wb") as f:
                while True:
                    frames = rpc_call(
                        "ClientFS.Stream",
                        {"alloc_id": prev_id, "path": sub_rel,
                         "offset": offset})["Frames"]
                    progressed = False
                    for fr in frames:
                        data = bytes(fr.get("Data") or b"")
                        if data:
                            f.write(data)
                            offset = fr["Offset"] + len(data)
                            progressed = True
                    if not progressed:
                        break
            mode = e.get("FileMode")
            if mode:
                os.chmod(sub_dst, int(mode))


def migrate_previous(client, runner) -> None:
    """The prerun hook: wait on the predecessor, then migrate its
    ephemeral disk when the group asks for it. Failures degrade to a
    fresh disk (logged), never a dead alloc."""
    alloc = runner.alloc
    prev_id = alloc.previous_allocation
    if not prev_id or alloc.job is None:
        return
    tg = alloc.job.lookup_task_group(alloc.task_group)
    if tg is None or tg.ephemeral_disk is None:
        return
    ed = tg.ephemeral_disk
    if not (ed.sticky or ed.migrate):
        return

    get_alloc = getattr(client.transport, "get_alloc", None)
    wait_status, prev_info = "gone", None
    if get_alloc is not None:
        wait_status, prev_info = wait_for_previous(get_alloc, prev_id)
    if wait_status == "timeout":
        # the predecessor is STILL RUNNING: copying its disk now would
        # snapshot files mid-write — start fresh instead
        return

    task_names = [t.name for t in tg.tasks]
    rels = _migrate_paths(task_names)
    dst_base = runner.alloc_dir.base

    # local predecessor: straight copy
    src_base = client.alloc_base(prev_id)
    if src_base is not None:
        moved = _copy_local(src_base, dst_base, rels)
        LOG.info("migrated %d dirs locally from %s", moved, prev_id[:8])
        return

    # remote predecessor: pull over the owning client's fs API
    if not ed.migrate or prev_info is None:
        return                              # sticky-only is node-local
    node_rpc = prev_info.get("node_rpc") or ""
    if not node_rpc:
        LOG.warning("previous alloc %s: owning node has no client RPC "
                    "address; starting with a fresh ephemeral disk",
                    prev_id[:8])
        return
    from ..rpc.client import RpcClient
    c = RpcClient(node_rpc, dial_timeout_s=3.0)
    ok = fail = 0
    try:
        for rel in rels:
            try:
                _fetch_remote_tree(
                    lambda m, a: c.call(m, a, timeout_s=60.0),
                    prev_id, rel, os.path.join(dst_base, rel))
                ok += 1
            except Exception as e:
                fail += 1
                LOG.warning("remote migration of %s from %s failed: %s",
                            rel, prev_id[:8], e)
        if fail:
            LOG.warning("remote migration from %s INCOMPLETE: %d of %d "
                        "dirs failed; the replacement starts with a "
                        "partial disk", prev_id[:8], fail, ok + fail)
        else:
            LOG.info("migrated ephemeral disk remotely from %s via %s",
                     prev_id[:8], node_rpc)
    finally:
        c.close()
