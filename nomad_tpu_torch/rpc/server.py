"""Server-side RPC endpoint registry and TCP listener.

The method table mirrors the reference's endpoint structs
(nomad/server.go:264 `endpoints`, node_endpoint.go, job_endpoint.go):
each method declares how to decode its typed arguments and runs against
the Server object. Long-poll methods (Node.GetClientAllocs) block
server-side on the state store's watch condition exactly like blocking
queries over go-memdb watch channels (node_endpoint.go:926).

Concurrency model: one handler thread per in-flight request; responses
are written under a per-connection lock and matched by seq on the
client — the functional equivalent of net/rpc over yamux streams.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Any, Dict, List, Optional

from ..models import Allocation, Node
from ..utils.codec import from_wire, to_wire
from .codec import FrameCodec, RpcRefused
from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.rpc")


def _get_client_allocs(server, args: Dict) -> Dict:
    node_id = args["node_id"]
    min_index = int(args.get("min_index", 0))
    max_wait_s = float(args.get("max_wait_s", 30.0))
    store = server.store
    if min_index > 0:
        store.block_min_index(min_index, timeout_s=max_wait_s)
    snap = store.snapshot()
    allocs = snap.allocs_by_node(node_id)
    return {"allocs": [to_wire(a) for a in allocs],
            "index": snap.latest_index()}


# -- per-domain endpoint registries ----------------------------------
# The reference registers one endpoint struct per domain
# (nomad/server.go:264 `endpoints`: Node, Job, Alloc, Eval, Plan,
# ClientStats, ...); the flat 16-verb dict this grew from made adding a
# batch verb a diff in the middle of an unrelated list. Each registry
# below returns its domain's verbs and declares its own write set;
# build_method_table composes them. Two domains register elsewhere by
# construction: Eval.* / Plan.* (the distributed scheduler plane's
# follower verbs, follower_sched.rpc_handlers) and Raft.* (raft shim)
# merge into RpcServer.methods at Server.attach_raft — same
# registration discipline, later binding. ClientStats rides
# Node.Heartbeat's `stats` argument rather than its own verb.


def node_methods(server) -> Dict[str, Any]:
    def node_register(args):
        node = from_wire(Node, args["node"])
        server.register_node(node)
        return {"heartbeat_ttl_s": server.config.heartbeat_ttl_s}

    def node_update_status(args):
        server.update_node_status(args["node_id"], args["status"])
        return {}

    def node_heartbeat(args):
        return {"ttl_s": server.heartbeat(args["node_id"],
                                          stats=args.get("stats"))}

    def node_update_alloc(args):
        allocs = [from_wire(Allocation, a) for a in args["allocs"]]
        server.update_alloc_status_from_client(allocs)
        return {}

    def node_update_alloc_batch(args):
        # bulk ingest verb: N clients' update groups in one
        # call, decoded through the dedup pool (a fleet pushing one
        # task-state shape materializes it once) and landed as one
        # coalesced raft entry by the ingest gateway
        from ..state.columnar import WirePool, from_wire_pooled
        pool = WirePool()
        groups = [[from_wire_pooled(Allocation, a, pool) for a in g]
                  for g in args.get("updates") or []]
        server.update_alloc_status_from_client_batch(groups)
        return {"groups": len(groups),
                "pool_hits": pool.hits}

    def node_get_client_allocs(args):
        return _get_client_allocs(server, args)

    def node_derive_vault_token(args):
        return {"tokens": server.derive_vault_token(
            args["alloc_id"], list(args.get("tasks") or []))}

    def node_renew_vault_token(args):
        return {"lease_s": server.renew_vault_token(
            args["accessor"], args["token"])}

    return {
        "Node.Register": node_register,
        "Node.UpdateStatus": node_update_status,
        "Node.Heartbeat": node_heartbeat,
        "Node.UpdateAlloc": node_update_alloc,
        "Node.UpdateAllocBatch": node_update_alloc_batch,
        "Node.GetClientAllocs": node_get_client_allocs,
        "Node.DeriveVaultToken": node_derive_vault_token,
        "Node.RenewVaultToken": node_renew_vault_token,
    }


NODE_WRITE_METHODS = frozenset({
    "Node.Register", "Node.UpdateStatus", "Node.Heartbeat",
    "Node.UpdateAlloc", "Node.UpdateAllocBatch",
    "Node.DeriveVaultToken", "Node.RenewVaultToken"})


def status_methods(server) -> Dict[str, Any]:
    def status_ping(_args):
        return {"status": "ok", "leader": True,
                "index": server.store.latest_index()}

    return {"Status.Ping": status_ping}


def server_methods(server) -> Dict[str, Any]:
    def server_join(args):
        return {"members": server.join_member(args["addr"])}

    def server_leave(args):
        return {"members": server.leave_member(args["addr"])}

    def server_members(_args):
        return {"members": server.store.server_members()}

    def server_indirect_ping(args):
        # SWIM ping-req: probe `target` on behalf of another member
        swim = getattr(server, "swim", None)
        if swim is None:
            return {"ok": False}
        return {"ok": swim.probe_for_peer(args["target"])}

    def server_report_failed(args):
        return {"removed": server.handle_peer_failure_report(
            args["addr"], reporter=args.get("reporter", ""))}

    return {
        "Server.Join": server_join,
        "Server.Leave": server_leave,
        "Server.Members": server_members,
        "Server.IndirectPing": server_indirect_ping,
        "Server.ReportFailed": server_report_failed,
    }


SERVER_WRITE_METHODS = frozenset({"Server.Join", "Server.Leave"})


def alloc_methods(server) -> Dict[str, Any]:
    def alloc_get(args):
        from .transport import _alloc_with_node
        return _alloc_with_node(server, args["alloc_id"])

    return {"Alloc.GetAlloc": alloc_get}


def service_methods(server) -> Dict[str, Any]:
    def service_update(args):
        from ..models.services import ServiceRegistration
        upserts = [from_wire(ServiceRegistration, s)
                   for s in args.get("upserts") or []]
        server.update_service_registrations(
            upserts=upserts,
            delete_alloc_ids=args.get("delete_alloc_ids"),
            delete_ids=args.get("delete_ids"))
        return {}

    return {"Service.Update": service_update}


SERVICE_WRITE_METHODS = frozenset({"Service.Update"})


def csi_methods(server) -> Dict[str, Any]:
    def csi_volume_get(args):
        v = server.store.csi_volume(args.get("namespace", "default"),
                                    args["volume_id"])
        return {"volume": v.stub() if v is not None else None}

    return {"CSIVolume.Get": csi_volume_get}


DOMAIN_REGISTRIES = (node_methods, status_methods, server_methods,
                     alloc_methods, service_methods, csi_methods)


def build_method_table(server) -> Dict[str, Any]:
    """method name -> callable(args dict) -> wire-safe result,
    composed from the per-domain registries above."""
    methods: Dict[str, Any] = {}
    for registry in DOMAIN_REGISTRIES:
        methods.update(registry(server))
    return methods


# client-facing writes that must run on the leader (rpc.go forward()),
# composed from each domain's declared write set
WRITE_METHODS = (NODE_WRITE_METHODS | SERVER_WRITE_METHODS
                 | SERVICE_WRITE_METHODS)


class RpcServer:
    """Threaded TCP RPC listener. Bound to a Server instance by
    default; a custom method table makes it a generic RPC endpoint
    (the plugin boundary reuses it, plugins/base.py)."""

    def __init__(self, server=None, host: str = "127.0.0.1", port: int = 0,
                 methods: Optional[Dict[str, Any]] = None):
        self.server = server
        self.methods = methods if methods is not None \
            else build_method_table(server)
        self.raft = None                   # set by Server.attach_raft
        rpc = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                rpc._serve_conn(self.request)

        class Listener(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._listener = Listener((host, port), Handler)
        self.host, self.port = self._listener.server_address
        self._thread: Optional[threading.Thread] = None
        # live connections, closed at shutdown: a stopped endpoint must
        # not keep answering on connections opened before it stopped
        self._conns_l = make_lock()
        self._conns: set = set()
        self._closed = False

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._listener.serve_forever, daemon=True,
            name="rpc-listener")
        self._thread.start()
        LOG.info("rpc listening on %s:%d", self.host, self.port)

    def shutdown(self) -> None:
        """Stop listening, close every live connection (their serving
        threads end at once) and join the listener thread."""
        with self._conns_l:
            self._closed = True
            conns, self._conns = list(self._conns), set()
        self._listener.shutdown()
        self._listener.server_close()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # -- per-connection serving ---------------------------------------
    def _serve_conn(self, sock: socket.socket) -> None:
        with self._conns_l:
            if self._closed:
                return
            self._conns.add(sock)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        codec = FrameCodec(sock)
        wlock = make_lock()
        try:
            while True:
                frame = codec.read_frame()
                if frame is None:
                    return
                seq, method, args = frame
                t = threading.Thread(
                    target=self._dispatch, daemon=True,
                    args=(codec, wlock, seq, method, args),
                    name=f"rpc-{method}")
                t.start()
        except (ConnectionError, OSError):
            return
        finally:
            with self._conns_l:
                self._conns.discard(sock)

    def _dispatch(self, codec: FrameCodec, wlock: threading.Lock,
                  seq: int, method: str, args: Dict) -> None:
        err: Optional[str] = None
        result: Any = None
        fn = self.methods.get(method)
        if fn is None:
            err = f"unknown rpc method: {method}"
        else:
            try:
                if self.raft is not None and method in WRITE_METHODS \
                        and not self.raft.is_leader():
                    result = self.raft.forward_rpc(method, args or {})
                else:
                    result = fn(args or {})
            except RpcRefused as e:
                # deliberate refusal (stopped raft node, fenced
                # leader): still an error to the caller, but expected
                # during staggered teardown — debug, not a traceback
                LOG.debug("rpc %s refused: %s", method, e)
                err = f"{type(e).__name__}: {e}"
            except Exception as e:          # surfaced to the caller
                LOG.exception("rpc %s failed", method)
                err = f"{type(e).__name__}: {e}"
        try:
            with wlock:
                codec.write_frame([seq, err, result])
        except (ConnectionError, OSError):
            pass
