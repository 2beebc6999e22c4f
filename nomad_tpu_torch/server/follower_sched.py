"""Distributed scheduler plane: follower scheduling over fenced local
snapshots, leader-only verify/commit.

The Omega shape applied to a raft ring: every server runs optimistic
schedulers against its OWN replicated MVCC store, and a single
authority — the raft leader — verifies and commits, which is exactly
what the group-commit plan applier terminates. Concretely:

  leader   the eval broker grows a remote-dequeue RPC surface
           (`Eval.Dequeue`/`Eval.Ack`/`Eval.Nack`), each remote
           dequeue covered by a LEASE (EvalLeaseTable) so a dead
           follower's evals are nacked back to READY instead of
           waiting out the broker's full 60 s unack timer;
           `Plan.Submit` feeds remote plans into the SAME plan queue
           local workers use, so the group-commit applier verifies
           local and remote members against one snapshot and demotes
           stale remote plans with the group's commit index as the
           refresh fence — exactly like local retries
  follower a FollowerScheduler runs full worker pools (Worker
           subclass — fence, gateway, device all inherited: each
           follower's workers build their SelectKernel on that
           server's device) whose broker is the leader reached over
           RPC and whose Planner lane submits plans back through
           `Plan.Submit`; scheduling reads come from the follower's
           LOCAL store, gated by the snapshot-min-index fence
           (`store.snapshot_min_index` blocks until local raft
           catch-up reaches the eval's modify_index; the wait surfaces
           as the `fence_wait` stage and a fence timeout NACKS the
           eval — never drops it)

Leadership transfer is seamless by construction: the new leader's
`establish_leadership` re-enqueues every non-terminal eval from the
store (Server._restore_evals), the old leader's lease table flushes on
revoke, in-flight remote leases expire back to READY, and follower
dequeue loops re-home via raft's leader hint with the SWIM member
list as the fallback directory (`_probe_for_leader`).

The whole plane degrades to a leader scheduling alone with
`ServerConfig(follower_sched=False)` or `follower_max_remote=0` — no
loops start, no verbs are called. A remote plan that committed fires
the chaos hook `worker.plan_committed` (chaos/faults.py) before its eval
is acked, as a local one does. The JAX package's copy also reads the
NOMAD_TPU_FOLLOWER_SCHED switch; this one does not.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..chaos import faults as chaos_faults
from ..models import Evaluation, Plan, PlanResult
from ..models.deployment import Deployment, DeploymentStatusUpdate
from ..rpc.codec import RpcError
from ..utils.codec import from_wire, to_wire
from ..utils.locks import make_lock
from .worker import RAFT_SYNC_LIMIT, EvalLane, Worker

LOG = logging.getLogger("nomad_tpu.follower_sched")

# queues follower workers may drain remotely: placement schedulers
# only — `_core` housekeeping evals mutate through leader-local
# pseudo-schedulers and stay home
REMOTE_SCHEDULERS = ("service", "batch", "system")

# leader-side bound on one remote dequeue's long-poll: the handler
# thread parks in the broker at most this long, the follower simply
# calls again (its own DEQUEUE_TIMEOUT_S cadence over RPC)
DEQUEUE_POLL_BOUND_S = 2.0

LEASE_SWEEP_S = 0.25

# a follower's wait for its Plan.Submit: the leader answers once the plan
# commits or is refused (a dead leader drops the connection at once), so
# this bounds only a leader alive but stalled
PLAN_SUBMIT_TIMEOUT_S = 300.0


# -- wire helpers ------------------------------------------------------
# Plan/PlanResult are wire-able dataclasses except their deployment
# fields, typed Optional[object] (persistence.SCHEMAS owns the typed
# decode for raft entries) — re-type them here the same way.

def decode_plan(data: dict) -> Plan:
    plan = from_wire(Plan, data)
    if isinstance(plan.deployment, dict):
        plan.deployment = from_wire(Deployment, plan.deployment)
    plan.deployment_updates = [
        from_wire(DeploymentStatusUpdate, u) if isinstance(u, dict) else u
        for u in (plan.deployment_updates or [])]
    return plan


def decode_plan_result(data: dict) -> PlanResult:
    result = from_wire(PlanResult, data)
    if isinstance(result.deployment, dict):
        result.deployment = from_wire(Deployment, result.deployment)
    result.deployment_updates = [
        from_wire(DeploymentStatusUpdate, u) if isinstance(u, dict) else u
        for u in (result.deployment_updates or [])]
    return result


# -- leader side: the lease table --------------------------------------

class _Lease:
    __slots__ = ("token", "follower", "deadline", "paused")

    def __init__(self, token: str, follower: str, deadline: float):
        self.token = token
        self.follower = follower
        self.deadline = deadline
        self.paused = 0         # Plan.Submit calls in flight


class EvalLeaseTable:
    """Leader-side ledger of evals dequeued by remote followers.

    The broker's own 60 s unack timer is the backstop; the lease is the
    FAST path — a follower that dies (or partitions away) mid-eval gets
    its evals nacked back to READY after `follower_lease_s` with ZERO
    re-enqueue delay (the follower failed, not the eval). One sweeper
    thread (started lazily on the first grant, stopped at shutdown)
    scans deadlines; per-lease timers would leak OS timer threads at
    high dequeue rates and tangle shutdown ordering.

    Also the home of the leader-side scheduler-plane counters
    (`scheduler_plane_status`) — it exists from Server.__init__ on
    every server, and is simply empty on non-leaders.
    """

    def __init__(self, server):
        self.server = server
        self._l = make_lock()
        self._leases: Dict[str, _Lease] = {}      # eval id -> lease
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = {"granted": 0, "released": 0, "expired": 0,
                      "remote_dequeues": 0, "remote_plans": 0,
                      "remote_demotions": 0}

    # -- grants --------------------------------------------------------
    def grant(self, eval_id: str, token: str, follower: str,
              lease_s: float) -> None:
        with self._l:
            self._leases[eval_id] = _Lease(
                token, follower, time.monotonic() + max(lease_s, 0.5))
            self.stats["granted"] += 1
            self.stats["remote_dequeues"] += 1
            self._ensure_sweeper()

    def release(self, eval_id: str, token: str) -> bool:
        with self._l:
            lease = self._leases.get(eval_id)
            if lease is not None and lease.token == token:
                del self._leases[eval_id]
                self.stats["released"] += 1
                return True
            return False

    def pause(self, eval_id: str, token: str) -> None:
        """A plan of the eval is in flight (eval_endpoint.go
        PauseNackTimeout): its lease cannot expire until resume() — a
        re-delivery now would run the eval again without the plan's
        allocs, and both plans could commit."""
        with self._l:
            lease = self._leases.get(eval_id)
            if lease is not None and lease.token == token:
                lease.paused += 1

    def resume(self, eval_id: str, token: str, lease_s: float) -> None:
        """The plan's outcome is known: the lease runs again, from a
        full term."""
        with self._l:
            lease = self._leases.get(eval_id)
            if lease is not None and lease.token == token and lease.paused:
                lease.paused -= 1
                lease.deadline = time.monotonic() + max(lease_s, 0.5)

    def note_plan(self, result: PlanResult) -> None:
        with self._l:
            self.stats["remote_plans"] += 1
            if result.refresh_index:
                self.stats["remote_demotions"] += 1

    # -- introspection (gauges, CLI columns, operator debug) -----------
    def outstanding(self) -> int:
        with self._l:
            return len(self._leases)

    def by_follower(self) -> Dict[str, int]:
        with self._l:
            out: Dict[str, int] = {}
            for lease in self._leases.values():
                out[lease.follower] = out.get(lease.follower, 0) + 1
            return out

    def snapshot_stats(self) -> dict:
        with self._l:
            return {**self.stats, "outstanding": len(self._leases)}

    # -- lifecycle -----------------------------------------------------
    def flush(self) -> None:
        """Leadership revoked: the broker flush already cancelled every
        unack, so the leases are moot — just forget them."""
        with self._l:
            self._leases.clear()

    def stop(self) -> None:
        self._stop.set()
        sweeper = self._sweeper
        if sweeper is not None:
            sweeper.join(timeout=2.0)

    def _ensure_sweeper(self) -> None:
        # self._l held
        if self._sweeper is None and not self._stop.is_set():
            self._sweeper = threading.Thread(
                target=self._sweep_loop, daemon=True, name="eval-leases")
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while not self._stop.wait(LEASE_SWEEP_S):
            now = time.monotonic()
            with self._l:
                expired = [(eid, lease) for eid, lease
                           in self._leases.items()
                           if lease.deadline <= now and not lease.paused]
                for eid, _lease in expired:
                    del self._leases[eid]
                self.stats["expired"] += len(expired)
            for eid, lease in expired:
                LOG.debug("lease expired for eval %s (follower %s); "
                          "nacking back to READY", eid[:8], lease.follower)
                try:
                    # immediate re-enqueue: the FOLLOWER died, the eval
                    # did nothing wrong — no nack backoff
                    self.server.eval_broker.nack(eid, lease.token,
                                                 delay_s=0.0)
                except Exception:   # pragma: no cover — broker flushed
                    pass


# -- leader side: the RPC verbs ----------------------------------------

def wait_index(store, ev: Evaluation) -> int:
    """The index a remote scheduler must reach before it reads its
    store for `ev` (nomad/eval_endpoint.go getWaitIndex): the eval's
    modify index, or the highest modify index of the job's allocs when
    that is later. A re-delivered eval's job may hold allocs committed
    after the eval itself — a plan of its earlier try that landed, or
    one a new leader committed at its barrier — and a follower whose
    replica has not applied them yet would place the same instances
    again."""
    index = ev.modify_index
    for a in store.allocs_by_job(ev.namespace, ev.job_id):
        if a.modify_index > index:
            index = a.modify_index
    return index


def rpc_handlers(server) -> Dict:
    """The scheduler-plane verb table, merged into the RPC method table
    by Server.attach_raft. Handlers never raise for expected cluster
    conditions (not-leader, unknown token): a raised handler error is
    logged server-side and surfaces as an opaque RpcError — structured
    replies keep follower re-homing quiet and teardown clean."""

    def _is_leader() -> bool:
        raft = server.raft
        return raft is None or raft.is_leader()

    def _not_leader() -> dict:
        raft = server.raft
        return {"not_leader": True,
                "leader": getattr(raft, "leader_addr", None)}

    def eval_dequeue(args: dict) -> dict:
        if not _is_leader():
            return _not_leader()
        broker = server.eval_broker
        if not broker.enabled():
            return {"eval": None}
        timeout = min(float(args.get("timeout_s") or 0.5),
                      DEQUEUE_POLL_BOUND_S)
        scheds = [s for s in (args.get("schedulers") or [])
                  if s in REMOTE_SCHEDULERS]
        if not scheds:
            return {"eval": None}
        ev, token = broker.dequeue(scheds, timeout_s=timeout)
        if ev is None:
            return {"eval": None}
        server.eval_leases.grant(
            ev.id, token, follower=str(args.get("follower") or ""),
            lease_s=float(server.config.follower_lease_s))
        return {"eval": to_wire(ev), "token": token,
                "wait_index": wait_index(server.store, ev),
                "queue_wait_s": float(getattr(ev, "queue_wait_s", 0.0))}

    def eval_ack(args: dict) -> dict:
        eval_id, token = args["eval_id"], args["token"]
        server.eval_leases.release(eval_id, token)
        try:
            server.eval_broker.ack(eval_id, token)
        except (KeyError, ValueError) as e:
            # lease already expired (eval redelivered) or broker
            # flushed across a failover — the follower's work stands
            # or was redone; nothing to crash about
            return {"ok": False, "error": str(e)}
        return {"ok": True}

    def eval_nack(args: dict) -> dict:
        eval_id, token = args["eval_id"], args["token"]
        server.eval_leases.release(eval_id, token)
        server.eval_broker.nack(eval_id, token)     # token-checked no-op
        return {"ok": True}                         # when already gone

    def eval_reblock(args: dict) -> dict:
        if not _is_leader():
            return _not_leader()
        ev = from_wire(Evaluation, args["eval"])
        server.blocked_evals.block(ev)
        return {"ok": True}

    def plan_submit(args: dict) -> dict:
        if not _is_leader():
            return _not_leader()
        leases = server.eval_leases
        paused = None
        try:
            plan = decode_plan(args["plan"])
            paused = (plan.eval_id, plan.eval_token)
            leases.pause(*paused)
            future = server.plan_queue.enqueue(plan, remote=True)
            # no timeout, as the local lane's (worker.py EvalLane)
            result: PlanResult = future.result()
        except Exception as e:
            # stale token / queue disabled / leadership lost mid-commit:
            # the follower nacks and the eval redelivers — a structured
            # error, not a traceback
            return {"error": f"{type(e).__name__}: {e}"}
        finally:
            if paused is not None:
                leases.resume(*paused, float(server.config.follower_lease_s))
        server.eval_leases.note_plan(result)
        return {"result": to_wire(result)}

    return {
        "Eval.Dequeue": eval_dequeue,
        "Eval.Ack": eval_ack,
        "Eval.Nack": eval_nack,
        "Eval.Reblock": eval_reblock,
        "Plan.Submit": plan_submit,
    }


# -- follower side -----------------------------------------------------

class RemoteBroker:
    """The follower worker's eval source/sink: the leader's broker
    reached over RPC. Duck-typed to the three calls Worker makes
    (dequeue/ack/nack); every path swallows transport errors — a lost
    ack costs one lease expiry, never a crashed worker loop."""

    def __init__(self, fs: "FollowerScheduler"):
        self.fs = fs

    def dequeue(self, schedulers: List[str],
                timeout_s: Optional[float] = None
                ) -> Tuple[Optional[Evaluation], str]:
        fs = self.fs
        pause = min(max(timeout_s or 0.05, 0.05), 0.5)
        if not fs.active():
            # leader locally (its own workers drain the broker
            # directly), disabled, or stopping: idle at the dequeue
            # cadence so a role flip picks the loop right back up
            fs.wait(pause)
            return None, ""
        addr = fs.leader_addr()
        if not addr:
            fs.wait(pause)
            return None, ""
        try:
            res = fs.call(addr, "Eval.Dequeue",
                          {"schedulers": list(schedulers),
                           "timeout_s": timeout_s or 0.5,
                           "follower": fs.self_addr()},
                          timeout_s=(timeout_s or 0.5)
                          + DEQUEUE_POLL_BOUND_S + 3.0)
        except Exception:
            fs.note_leader_lost(addr)
            fs.wait(pause)
            return None, ""
        if res.get("not_leader"):
            fs.rehome(res.get("leader"))
            return None, ""
        data = res.get("eval")
        if not data:
            return None, ""
        ev = from_wire(Evaluation, data)
        # queue-wait attribution rides the response (dynamic attrs
        # don't survive to_wire): the follower's stage report sees the
        # leader-side READY wait
        ev.queue_wait_s = float(res.get("queue_wait_s") or 0.0)
        # the worker's snapshot fence waits for this index (wait_index)
        ev.wait_index = int(res.get("wait_index") or 0)
        fs.incr("remote_dequeues")
        return ev, str(res.get("token") or "")

    def ack(self, eval_id: str, token: str) -> None:
        if not self._finish("Eval.Ack", eval_id, token):
            self.fs.incr("ack_failures")

    def nack(self, eval_id: str, token: str) -> None:
        if not self._finish("Eval.Nack", eval_id, token):
            self.fs.incr("nack_failures")

    def _finish(self, verb: str, eval_id: str, token: str) -> bool:
        fs = self.fs
        addr = fs.leader_addr()
        if not addr:
            return False
        try:
            res = fs.call(addr, verb,
                          {"eval_id": eval_id, "token": token},
                          timeout_s=5.0)
        except Exception:
            # leader gone: the lease expires (or the new leader's
            # broker was rebuilt from the store) — redelivery is the
            # protocol, not an error
            fs.note_leader_lost(addr)
            return False
        return bool(res.get("ok"))


class RemoteEvalLane(EvalLane):
    """Planner lane for one remotely-dequeued eval: plans flow to the
    leader's plan queue over `Plan.Submit`; refresh fences are honored
    against the LOCAL store (replication delivers the group's commit
    by the time block_min_index returns, same as a local retry)."""

    def __init__(self, fs: "FollowerScheduler", server, ev: Evaluation,
                 token: str, device=None):
        super().__init__(server, ev, token, device=device)
        self.fs = fs

    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        from ..utils import metrics
        t0 = time.monotonic()
        plan.eval_id = self.eval.id
        plan.eval_token = self.token
        plan.snapshot_index = self.snapshot_index
        fs = self.fs
        addr = fs.leader_addr()
        if not addr:
            raise RpcError("no cluster leader for Plan.Submit")
        res = fs.call(addr, "Plan.Submit",
                      {"plan": to_wire(plan), "follower": fs.self_addr()},
                      timeout_s=PLAN_SUBMIT_TIMEOUT_S)
        if res.get("not_leader"):
            fs.rehome(res.get("leader"))
            raise RpcError("Plan.Submit: leadership moved")
        if res.get("error"):
            raise RpcError(f"Plan.Submit failed: {res['error']}")
        result = decode_plan_result(res.get("result") or {})
        fs.incr("remote_plans")
        if chaos_faults.ACTIVE:
            # same hook, same point in the protocol as the local lane:
            # the plan IS committed (leader-side) and the eval is not
            # yet acked — a worker-kill fault here exercises redelivery
            # across the remote path too
            chaos_faults.fire(
                "worker.plan_committed", eval_id=self.eval.id,
                placements=sum(len(a) for a in
                               plan.node_allocation.values()))
        metrics.measure_since("nomad.worker.submit_plan", t0)
        if result.refresh_index:
            # demoted (entirely or partially): the group's commit index
            # is the refresh fence — wait for LOCAL replication to
            # catch up so the retry sees why it lost
            fs.incr("demoted_plans")
            self.server.store.block_min_index(result.refresh_index - 1,
                                              timeout_s=RAFT_SYNC_LIMIT)
        return result

    def reblock_eval(self, ev: Evaluation) -> None:
        fs = self.fs
        addr = fs.leader_addr()
        if not addr:
            raise RpcError("no cluster leader for Eval.Reblock")
        res = fs.call(addr, "Eval.Reblock", {"eval": to_wire(ev)},
                      timeout_s=5.0)
        if res.get("not_leader"):
            fs.rehome(res.get("leader"))
            raise RpcError("Eval.Reblock: leadership moved")


class FollowerWorker(Worker):
    """A full scheduling worker whose broker is remote and whose lane
    submits plans back to the leader. Everything else — the snapshot
    fence, the micro-batch gateway, the server's device, the finisher
    pipeline — is inherited; the fence timeout shrinks to the configured
    `follower_fence_timeout_s` and a timeout NACKS (worker.py)."""

    def __init__(self, fs: "FollowerScheduler", wid: int):
        super().__init__(fs.server, list(REMOTE_SCHEDULERS), wid=wid)
        self.fs = fs
        self.broker = RemoteBroker(fs)
        # remote lanes already overlap across workers; per-worker
        # drain batching would add a dequeue RPC per drained eval
        self.batch_size = 1
        self.fence_timeout_s = float(fs.fence_timeout_s)

    def _make_lane(self, ev: Evaluation, token: str) -> EvalLane:
        return RemoteEvalLane(self.fs, self.server, ev, token,
                              device=self.device)

    def _note_fence(self, seconds: float) -> None:
        super()._note_fence(seconds)
        self.fs.note_fence_wait(seconds)


class FollowerScheduler:
    """Per-server owner of the remote scheduling loops: follower
    workers, the cached leader RPC clients, and the re-homing
    directory. Built in Server.attach_raft (needs the raft identity),
    started by Server.start, stopped FIRST in Server.shutdown so no
    loop is mid-RPC while local transports die."""

    def __init__(self, server):
        cfg = server.config
        self.server = server
        self.configured = bool(getattr(cfg, "follower_sched", True))
        self.lease_s = float(getattr(cfg, "follower_lease_s", 30.0))
        self.fence_timeout_s = float(
            getattr(cfg, "follower_fence_timeout_s", 5.0))
        self.max_remote = int(getattr(cfg, "follower_max_remote", 2))
        self._l = make_lock()
        self._clients: Dict[str, object] = {}
        self._leader_hint: Optional[str] = None
        self._stop = threading.Event()
        self.workers: List[FollowerWorker] = []
        self.stats = {"remote_dequeues": 0, "remote_plans": 0,
                      "demoted_plans": 0, "ack_failures": 0,
                      "nack_failures": 0, "rehomes": 0}
        # fence-wait reservoir behind fence_wait_p99_ms (bounded; p99
        # over recent waits)
        self._fence_res: deque = deque(maxlen=512)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if (not self.configured or self.server.raft is None
                or self.max_remote <= 0):
            return
        base = int(getattr(self.server.config, "num_schedulers", 0))
        for i in range(self.max_remote):
            w = FollowerWorker(self, wid=base + i)
            w.start()
            self.workers.append(w)
        LOG.info("follower scheduler: %d remote workers started",
                 len(self.workers))

    def stop(self) -> None:
        self._stop.set()
        for w in self.workers:
            w.request_stop()
        # closing the clients fails the calls in flight (a Plan.Submit
        # waits for its commit) so the workers end now, nacking
        with self._l:
            clients, self._clients = dict(self._clients), {}
        for c in clients.values():
            try:
                c.close()
            except Exception:
                pass
        for w in self.workers:
            w.stop()
        self.workers = []

    def set_pause(self, paused: bool) -> None:
        for w in self.workers:
            w.set_pause(paused)

    def wait(self, seconds: float) -> None:
        self._stop.wait(seconds)

    def active(self) -> bool:
        if self._stop.is_set():
            return False
        raft = self.server.raft
        return (raft is not None and not raft.is_leader()
                and not getattr(raft, "removed", False))

    # -- stats ---------------------------------------------------------
    def incr(self, key: str, n: int = 1) -> None:
        with self._l:
            self.stats[key] = self.stats.get(key, 0) + n

    def note_fence_wait(self, seconds: float) -> None:
        with self._l:
            self._fence_res.append(seconds)

    def fence_wait_p99_ms(self) -> float:
        with self._l:
            if not self._fence_res:
                return 0.0
            waits = sorted(self._fence_res)
        return waits[min(len(waits) - 1,
                         int(0.99 * len(waits)))] * 1e3

    def snapshot_stats(self) -> dict:
        with self._l:
            out = dict(self.stats)
        out["fence_wait_p99_ms"] = round(self.fence_wait_p99_ms(), 3)
        out["workers"] = len(self.workers)
        return out

    # -- leader directory ----------------------------------------------
    def self_addr(self) -> str:
        raft = self.server.raft
        return raft.self_addr if raft is not None else ""

    def leader_addr(self) -> Optional[str]:
        raft = self.server.raft
        if raft is None:
            return None
        addr = raft.leader_addr
        if addr and addr != raft.self_addr:
            return addr
        with self._l:
            hint = self._leader_hint
        if hint and hint != raft.self_addr:
            return hint
        return self._probe_for_leader()

    def rehome(self, leader: Optional[str]) -> None:
        """A peer told us who leads now (or that our target doesn't):
        adopt the hint and drop the stale client."""
        with self._l:
            if leader and leader != self._leader_hint:
                self._leader_hint = leader
                self.stats["rehomes"] += 1
            elif not leader:
                self._leader_hint = None

    def note_leader_lost(self, addr: str) -> None:
        with self._l:
            if self._leader_hint == addr:
                self._leader_hint = None
            client = self._clients.pop(addr, None)
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    def _probe_for_leader(self) -> Optional[str]:
        """Re-home through the SWIM member list: ask live members who
        leads (Raft.Status). SWIM's verdict filters the candidates —
        probing a FAILED member would just eat a dial timeout."""
        raft = self.server.raft
        if raft is None:
            return None
        swim = getattr(self.server, "swim", None)
        if swim is not None:
            members = swim.live_members()
        else:
            members = self.server.store.server_members() or []
        members = [m for m in members if m != raft.self_addr]
        random.shuffle(members)
        for addr in members:
            if self._stop.is_set():
                return None
            try:
                res = self.call(addr, "Raft.Status", {}, timeout_s=1.0)
            except Exception:
                continue
            if res.get("role") == "leader":
                self.rehome(addr)
                return addr
            hinted = res.get("leader")
            if hinted and hinted != raft.self_addr:
                self.rehome(hinted)
                return hinted
        return None

    # -- transport -----------------------------------------------------
    def call(self, addr: str, method: str, args: dict,
             timeout_s: float = 5.0):
        from ..rpc.client import RpcClient
        with self._l:
            client = self._clients.get(addr)
            if client is None:
                client = RpcClient(addr, dial_timeout_s=1.0)
                self._clients[addr] = client
        return client.call(method, args, timeout_s=timeout_s)
