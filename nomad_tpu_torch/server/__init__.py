"""The server: the PyTorch + CUDA counterpart of the JAX package's
nomad_tpu/server/.

`Server(ServerConfig(...), device=None)` registers nodes and jobs,
enqueues evals in the EvalBroker and has its Workers dequeue them, drain
ready evals into batches and run the schedulers, whose kernel dispatches
go solo, through the server-wide MicroBatchGateway or through a per-drain
BatchGateway; plans go through the PlanQueue to the group-committing
PlanApplier, which writes the store. `device=None` is the CUDA card,
`device="cpu"` the kernels' plain versions. With `data_dir` set the
server is durable (persistence.py: the WAL, snapshots and the cost
model's file) and restores from the directory at construction;
connect_hook.py injects connect sidecars at registration; ingest.py
coalesces concurrent writes into one log entry.

Clustered (`attach_raft` over an rpc.RpcServer): raft.py replicates the
log and applies each entry at commit on every replica, swim.py detects
failed peers, and follower_sched.py lets followers schedule on their own
devices against their own replicas, dequeuing from the leader's broker
and submitting plans to its applier over RPC.

The leader runs the event-sink manager (event_sink.py: webhook
delivery with progress committed through raft) and, in a region that is
not the authoritative one, ACL and namespace replication
(replication.py).

Not ported yet: the Vault token authority (server/vault.py carries only
the record a snapshot holds).
"""

from .eval_broker import EvalBroker
from .blocked_evals import BlockedEvals
from .plan_queue import PlanQueue
from .plan_applier import PlanApplier
from .worker import BatchGateway, MicroBatchGateway, Worker
from .core import Server, ServerConfig

__all__ = ["BatchGateway", "BlockedEvals", "EvalBroker", "MicroBatchGateway",
           "PlanApplier", "PlanQueue", "Server", "ServerConfig", "Worker"]
