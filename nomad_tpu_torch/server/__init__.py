"""The server's scheduling plane in dev mode: the PyTorch + CUDA
counterpart of the JAX package's nomad_tpu/server/ for one process and
one leader with no raft.

`Server(ServerConfig(...), device=None)` registers nodes and jobs,
enqueues evals in the EvalBroker and has its Workers dequeue them, drain
ready evals into batches and run the schedulers, whose kernel dispatches
go solo, through the server-wide MicroBatchGateway or through a per-drain
BatchGateway; plans go through the PlanQueue to the group-committing
PlanApplier, which writes the store. `device=None` is the CUDA card,
`device="cpu"` the kernels' plain versions. With `data_dir` set the
server is durable (persistence.py: the WAL, snapshots and the cost
model's file) and restores from the directory at construction;
connect_hook.py injects connect sidecars at registration.

Not ported yet: raft, replication, SWIM, follower scheduling, ingest, the
event-sink manager and the Vault token authority (server/event_sink.py
and server/vault.py carry only the records a snapshot holds).
"""

from .eval_broker import EvalBroker
from .blocked_evals import BlockedEvals
from .plan_queue import PlanQueue
from .plan_applier import PlanApplier
from .worker import BatchGateway, MicroBatchGateway, Worker
from .core import Server, ServerConfig

__all__ = ["BatchGateway", "BlockedEvals", "EvalBroker", "MicroBatchGateway",
           "PlanApplier", "PlanQueue", "Server", "ServerConfig", "Worker"]
