"""The wire RPC layer: server<->client communication over TCP.

Reference: nomad/rpc.go (net/rpc + msgpack codec over yamux multiplexed
TCP, :24-30), helper/pool/pool.go (connection pooling), and the
client-side long-poll semantics of node_endpoint.go Node.GetClientAllocs
(:926). The rebuild keeps the shape — seq-tagged request/response frames
with server-side blocking queries — but replaces yamux stream
multiplexing with seq-demultiplexed concurrent requests on one TCP
connection (each request is served by its own handler thread; responses
are written under a lock and matched by seq client-side).
"""

from .codec import FrameCodec, RpcError, RpcRefused
from .server import RpcServer
from .client import RpcClient
from .transport import (ServerTransport, InProcTransport, RemoteTransport)

__all__ = ["FrameCodec", "RpcError", "RpcRefused", "RpcServer",
           "RpcClient", "ServerTransport", "InProcTransport",
           "RemoteTransport"]
