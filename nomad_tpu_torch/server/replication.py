"""Cross-region replication from the authoritative region.

Reference: nomad/leader.go — replicateNamespaces:352,
replicateACLPolicies:1285, replicateACLTokens (only GLOBAL tokens
replicate; local tokens stay regional). A non-authoritative region's
leader long-polls the authoritative region's list endpoints, two-way
diffs against local state on modify_index, fetches changed full bodies,
and lands the result through its own raft. Transport here is the
federation HTTP surface (the same region-peer addresses the agents
use for request forwarding) instead of the reference's region-keyed
msgpack RPC.

stop() ends the threads at once: it shuts down the sockets of the
long-polls in flight, and join() waits for the threads.
"""

from __future__ import annotations

import http.client
import json
import logging
import socket
import threading
from typing import Dict, Optional
from urllib.parse import urlencode

from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.server.replication")

ERR_BACKOFF_S = 2.0
WAIT = "300s"


class ReplicationManager:
    """Leader-lifetime replication threads (one per replicated table).
    Started by establish_leadership on non-authoritative regions,
    stopped on revoke."""

    def __init__(self, server):
        self.server = server
        self.peer = server.config.region_peers.get(
            server.config.authoritative_region, "")
        self.token = server.config.replication_token
        self._stop = threading.Event()
        self._threads = []
        # connections of the long-polls in flight, shut down by stop()
        self._conns_l = make_lock()
        self._conns = set()
        # name -> REMOTE modify_index at last sync. The local store
        # re-stamps modify_index with its own raft index on apply, so
        # diffing against local state alone would re-upsert everything
        # on every wakeup; this cache converges the diff. Per-term
        # (in-memory): a new leader re-syncs once, which is idempotent.
        self._synced: Dict[str, Dict[str, int]] = {
            "namespaces": {}, "policies": {}, "tokens": {}}

    def start(self) -> None:
        if not self.peer:
            LOG.warning("authoritative region %r has no region-peer "
                        "address; replication disabled",
                        self.server.config.authoritative_region)
            return
        for name, fn in (("namespaces", self._replicate_namespaces),
                         ("acl-policies", self._replicate_policies),
                         ("acl-tokens", self._replicate_tokens)):
            th = threading.Thread(target=self._loop, args=(name, fn),
                                  daemon=True, name=f"replicate-{name}")
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        with self._conns_l:
            conns = list(self._conns)
        for conn in conns:
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def join(self, timeout_s: float) -> None:
        for th in self._threads:
            if th is not threading.current_thread():
                th.join(timeout_s)

    # -- transport -----------------------------------------------------
    def _get(self, path: str, params: Optional[dict] = None):
        if params:
            path += "?" + urlencode(params)
        headers = {"X-Nomad-Token": self.token} if self.token else {}
        host, _, port = self.peer.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=330)
        with self._conns_l:
            self._conns.add(conn)
        try:
            # connected before the check, so a stop() after it finds
            # the socket to shut down
            conn.connect()
            if self._stop.is_set():
                raise RuntimeError("replication stopped")
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status >= 300:
                raise RuntimeError(f"GET {path}: HTTP {resp.status}")
            ridx = resp.getheader("X-Nomad-Index")
            return (json.loads(body or "null"),
                    int(ridx) if ridx else 0)
        finally:
            with self._conns_l:
                self._conns.discard(conn)
            conn.close()

    def _loop(self, name: str, fn) -> None:
        """Long-poll the remote index; on change run one diff+apply
        round. Errors back off instead of spinning."""
        index = 0
        while not self._stop.is_set():
            try:
                index = fn(index)
            except Exception as e:
                LOG.warning("replication of %s from %r failed: %s",
                            name, self.peer, e)
                self._stop.wait(ERR_BACKOFF_S)

    # -- tables --------------------------------------------------------
    def _replicate_namespaces(self, index: int) -> int:
        from ..models.namespace import Namespace
        remote, ridx = self._get("/v1/namespaces",
                                 {"index": index, "wait": WAIT})
        from ..utils.codec import from_wire
        want = {w["name"]: from_wire(Namespace, w) for w in remote or []}
        synced = self._synced["namespaces"]
        local = {n.name: n for n in self.server.store.namespaces()}
        upserts = [ns for name, ns in want.items()
                   if name not in local
                   or synced.get(name) != ns.modify_index]
        doomed = [name for name in local
                  if name not in want and name != "default"]
        if upserts:
            self.server.raft_apply("namespace_upsert",
                                   dict(namespaces=upserts))
            for ns in upserts:
                synced[ns.name] = ns.modify_index
        if doomed:
            self.server.raft_apply("namespace_delete", dict(names=doomed))
            for name in doomed:
                synced.pop(name, None)
        return ridx if ridx else index

    def _replicate_policies(self, index: int) -> int:
        from ..acl import AclPolicy
        from ..utils.codec import from_wire
        remote, ridx = self._get("/v1/acl/policies",
                                 {"index": index, "wait": WAIT})
        want = {w["name"]: w["modify_index"] for w in remote or []}
        synced = self._synced["policies"]
        local = {p.name: p for p in self.server.store.acl_policies()}
        upserts = []
        for name, midx in want.items():
            if name in local and synced.get(name) == midx:
                continue
            body, _ = self._get(f"/v1/acl/policy/{name}")
            if body is not None:
                upserts.append((from_wire(AclPolicy, body), midx))
        doomed = [name for name in local if name not in want]
        if upserts:
            self.server.raft_apply(
                "acl_policy_upsert",
                dict(policies=[p for p, _m in upserts]))
            for p, midx in upserts:
                synced[p.name] = midx
        if doomed:
            self.server.raft_apply("acl_policy_delete",
                                   dict(names=doomed))
            for name in doomed:
                synced.pop(name, None)
        return ridx

    def _replicate_tokens(self, index: int) -> int:
        """Only GLOBAL tokens replicate (leader.go diffACLTokens —
        local tokens belong to their region)."""
        from ..acl import AclToken
        from ..utils.codec import from_wire
        remote, ridx = self._get("/v1/acl/tokens",
                                 {"index": index, "wait": WAIT})
        want: Dict[str, int] = {}
        for w in remote or []:
            if w.get("global") or w.get("global_"):
                want[w["accessor_id"]] = w["modify_index"]
        synced = self._synced["tokens"]
        local = {t.accessor_id: t
                 for t in self.server.store.acl_tokens() if t.global_}
        upserts = []
        for accessor, midx in want.items():
            if accessor in local and synced.get(accessor) == midx:
                continue
            body, _ = self._get(f"/v1/acl/token/{accessor}")
            if body is not None:
                upserts.append((from_wire(AclToken, body), midx))
        doomed = [a for a in local if a not in want]
        if upserts:
            self.server.raft_apply(
                "acl_token_upsert",
                dict(tokens=[t for t, _m in upserts]))
            for t, midx in upserts:
                synced[t.accessor_id] = midx
        if doomed:
            self.server.raft_apply("acl_token_delete",
                                   dict(accessor_ids=doomed))
            for a in doomed:
                synced.pop(a, None)
        return ridx
