"""The client agent's narrow server surface, in-proc or over the wire.

The client agent only ever needs five verbs (client/client.go's RPC
usage): register, status update, heartbeat, long-poll allocs, push
alloc status. `InProcTransport` binds them to a Server object in the
same process (dev agent); `RemoteTransport` sends them through
RpcClient — the same split as the reference's dev-mode agent embedding
a server vs. a real cluster (command/agent/agent.go).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..models import Allocation, Node
from ..utils.codec import from_wire, to_wire


class ServerTransport:
    """Interface: what the client agent needs from a server."""

    def register_node(self, node: Node) -> float:
        raise NotImplementedError

    def update_node_status(self, node_id: str, status: str) -> None:
        raise NotImplementedError

    def heartbeat(self, node_id: str,
                  stats: Optional[dict] = None) -> float:
        """TTL renewal; `stats` is the optional compact host-stats
        summary the server folds into its cluster rollup."""
        raise NotImplementedError

    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait_s: float
                          ) -> Tuple[List[Allocation], int]:
        raise NotImplementedError

    def update_alloc_status(self, allocs: List[Allocation]) -> None:
        raise NotImplementedError

    def update_alloc_status_batch(
            self, groups: List[List[Allocation]]) -> None:
        """Push N update groups in ONE verb (Node.UpdateAllocBatch):
        each group keeps its own eval derivation, all of
        them coalesce into one raft entry server-side. Default bridges
        to per-group pushes so custom transports keep working."""
        for g in groups:
            self.update_alloc_status(g)

    def derive_vault_token(self, alloc_id: str, tasks) -> dict:
        raise NotImplementedError

    def renew_vault_token(self, accessor: str, token: str) -> float:
        """Extend a derived token's lease; returns the new lease TTL.
        Raises if the lease is unknown or expired (re-derive then)."""
        raise NotImplementedError

    def update_services(self, upserts=None, delete_alloc_ids=None,
                        delete_ids=None) -> None:
        """Sync this client's service registrations into the catalog
        (the reference's Consul sync, command/agent/consul)."""
        raise NotImplementedError

    def get_csi_volume(self, namespace: str, volume_id: str):
        """Volume record stub (plugin_id + modes) for the client's CSI
        mount hook (csi_endpoint.go CSIVolume.Get)."""
        raise NotImplementedError


def _alloc_with_node(server, alloc_id: str):
    """{alloc: wire, node_rpc: addr} or None — the alloc-watcher's
    view of a predecessor (status + where to pull its disk from)."""
    from ..utils.codec import to_wire
    alloc = server.store.alloc_by_id(alloc_id)
    if alloc is None:
        return None
    node = server.store.node_by_id(alloc.node_id)
    node_rpc = ""
    if node is not None:
        node_rpc = node.attributes.get("nomad.client.rpc", "")
    return {"alloc": {"client_status": alloc.client_status,
                      "desired_status": alloc.desired_status,
                      "node_id": alloc.node_id},
            "node_rpc": node_rpc}


class InProcTransport(ServerTransport):
    def __init__(self, server):
        self.server = server

    def register_node(self, node: Node) -> float:
        self.server.register_node(node)
        return self.server.config.heartbeat_ttl_s

    def update_node_status(self, node_id: str, status: str) -> None:
        self.server.update_node_status(node_id, status)

    def heartbeat(self, node_id: str,
                  stats: Optional[dict] = None) -> float:
        return self.server.heartbeat(node_id, stats=stats)

    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait_s: float
                          ) -> Tuple[List[Allocation], int]:
        store = self.server.store
        if min_index > 0:
            store.block_min_index(min_index, timeout_s=max_wait_s)
        snap = store.snapshot()
        return snap.allocs_by_node(node_id), snap.latest_index()

    def update_alloc_status(self, allocs: List[Allocation]) -> None:
        self.server.update_alloc_status_from_client(allocs)

    def update_alloc_status_batch(
            self, groups: List[List[Allocation]]) -> None:
        self.server.update_alloc_status_from_client_batch(groups)

    def derive_vault_token(self, alloc_id: str, tasks) -> dict:
        return self.server.derive_vault_token(alloc_id, list(tasks))

    def renew_vault_token(self, accessor: str, token: str) -> float:
        return self.server.renew_vault_token(accessor, token)

    def update_services(self, upserts=None, delete_alloc_ids=None,
                        delete_ids=None) -> None:
        self.server.update_service_registrations(
            upserts=upserts, delete_alloc_ids=delete_alloc_ids,
            delete_ids=delete_ids)

    def get_alloc(self, alloc_id: str):
        return _alloc_with_node(self.server, alloc_id)

    def get_csi_volume(self, namespace: str, volume_id: str):
        v = self.server.store.csi_volume(namespace, volume_id)
        return v.stub() if v is not None else None


class RemoteTransport(ServerTransport):
    def __init__(self, addr: str):
        from .client import RpcClient
        self.rpc = RpcClient(addr)

    def close(self) -> None:
        self.rpc.close()

    def register_node(self, node: Node) -> float:
        res = self.rpc.call("Node.Register", {"node": to_wire(node)})
        return float(res.get("heartbeat_ttl_s", 10.0))

    def update_node_status(self, node_id: str, status: str) -> None:
        self.rpc.call("Node.UpdateStatus",
                      {"node_id": node_id, "status": status})

    def heartbeat(self, node_id: str,
                  stats: Optional[dict] = None) -> float:
        args = {"node_id": node_id}
        if stats:
            args["stats"] = stats
        return float(self.rpc.call("Node.Heartbeat", args)["ttl_s"])

    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait_s: float
                          ) -> Tuple[List[Allocation], int]:
        res = self.rpc.call(
            "Node.GetClientAllocs",
            {"node_id": node_id, "min_index": min_index,
             "max_wait_s": max_wait_s},
            timeout_s=max_wait_s + 30.0)
        allocs = [from_wire(Allocation, a) for a in res["allocs"]]
        return allocs, int(res["index"])

    def update_alloc_status(self, allocs: List[Allocation]) -> None:
        self.rpc.call("Node.UpdateAlloc",
                      {"allocs": [to_wire(a) for a in allocs]})

    def update_alloc_status_batch(
            self, groups: List[List[Allocation]]) -> None:
        self.rpc.call("Node.UpdateAllocBatch",
                      {"updates": [[to_wire(a) for a in g]
                                   for g in groups]})

    def derive_vault_token(self, alloc_id: str, tasks) -> dict:
        return self.rpc.call("Node.DeriveVaultToken",
                             {"alloc_id": alloc_id,
                              "tasks": list(tasks)})["tokens"]

    def renew_vault_token(self, accessor: str, token: str) -> float:
        return float(self.rpc.call(
            "Node.RenewVaultToken",
            {"accessor": accessor, "token": token})["lease_s"])

    def update_services(self, upserts=None, delete_alloc_ids=None,
                        delete_ids=None) -> None:
        self.rpc.call("Service.Update",
                      {"upserts": [to_wire(s) for s in upserts or []],
                       "delete_alloc_ids": list(delete_alloc_ids or []),
                       "delete_ids": list(delete_ids or [])})

    def get_alloc(self, alloc_id: str):
        """Status + owning-node info of any alloc (the alloc-watcher's
        predecessor probe, client/allocwatcher)."""
        return self.rpc.call("Alloc.GetAlloc", {"alloc_id": alloc_id})

    def get_csi_volume(self, namespace: str, volume_id: str):
        res = self.rpc.call("CSIVolume.Get",
                            {"namespace": namespace,
                             "volume_id": volume_id})
        return res.get("volume")
