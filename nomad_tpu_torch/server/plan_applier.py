"""The plan applier: THE serialization point of the cluster.

Reference semantics: nomad/plan_apply.go — planApply:71 single goroutine,
evaluatePlan:400 (per-node feasibility against the freshest snapshot),
partial commits set RefreshIndex to force worker state refresh,
preemption follow-up evals:287-310. Like the reference (optimistic
pipelining, big comment plan_apply.go:44-70), plan N's quorum
replication overlaps plan N+1's verification: the majority-ack wait is
handed to a committer thread that resolves plan futures in commit
order, and — because the FSM applies only at commit on a clustered
leader — plan N's results are overlaid onto the snapshot when
verifying N+1 (the reference applies the result to its private
snapshot for exactly this reason). Verification batches all touched
nodes at once (the EvaluatePool:NumCPU/2 goroutines become one
vectorized pass).

GROUP COMMIT (a departure from the reference): where
plan_apply.go pops ONE plan per iteration, this applier drains every
queued plan — bounded by `ServerConfig.plan_group_max` — and commits
the whole group as ONE raft entry ("plan_group_results"), ONE state
store transaction (a single LayerMap layer push instead of N), and ONE
event-broker flush, with per-plan results demultiplexed back onto each
submitter's future. Verification stays order-equivalent to sequential
apply: all plans verify against one snapshot, and each later plan sees
the earlier group members' node claims through the same overlay
mechanism the pipelined commit already uses — an intra-group loser
demotes to a partial result exactly as a stale-snapshot retry would,
with its refresh fence pointed at the group's commit index so the
retry sees why it lost. `plan_group_max=1` reproduces the
one-entry-per-plan path bit for bit (the escape hatch); the governor
shrinks the group bound under conflict churn
(`governor_plan_group_conflict_high`) and re-widens it after a clean
streak. Verify and commit report flight-recorder spans (applier and
committer tracks) onto the trace each submitting worker stamped on its
plan.

Chaos hook (chaos/faults.py): `plan.group_commit` fires once a plan's or
a group's raft entry is dispatched, before any submitter future
resolves. The JAX package's copy also reads NOMAD_TPU_PLAN_GROUP and sums
every applier's groups in a process-wide GROUP_STATS; this one does
neither.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import trace
from ..chaos import faults as chaos_faults
from ..models import (
    Allocation, AllocsFit, Evaluation, Plan, PlanResult,
    EVAL_STATUS_PENDING,
)
from ..models.evaluation import TRIGGER_PREEMPTION
from .plan_queue import PendingPlan, PlanQueue
from ..utils.locks import make_lock

# conflict-churn accounting: intra-group demotions within this window
# feed the `plan_group.conflict_retries` governor gauge, whose
# watermark shrinks the group bound instead of letting retries thrash
CONFLICT_WINDOW_S = 10.0
# consecutive conflict-free groups before a shrunk bound re-widens
# (also the ingest gateway's clean streak, server/ingest.py)
GROUP_RECOVER_CLEAN = 32


def fail_futures(pairs, exc: Exception) -> None:
    """Fail every unresolved future in a demux pair list — the shared
    abort tail of the group-commit planes (plan groups, ingest
    batches): whatever already resolved keeps its result, everything
    still parked sees the error."""
    for future, _r in pairs:
        if not future.done():
            future.set_exception(exc)


def _count_placements(result) -> int:
    """Fresh placements in a verified plan result — the
    `nomad.plan.placements` counter the telemetry ring rates. Plans
    also carry in-place and attribute updates through node_allocation
    (scheduler/generic.py append_alloc); those allocs are store copies
    with a stamped create_index, while a NEW placement's is still 0
    until the commit stamps it — counting everything would show
    phantom placements/s during a rolling in-place update."""
    return sum(1 for v in result.node_allocation.values()
               for a in v if a.create_index == 0)


class PlanApplier:
    def __init__(self, queue: PlanQueue, server):
        self.queue = queue
        self.server = server      # provides .store and .raft_apply()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._committer: Optional[threading.Thread] = None
        # (pairs, waiter, group index) handed from the verify/apply
        # loop to the committer; pairs is [(future, result)] for one
        # plan OR one whole group. maxsize=1 bounds the pipeline to ONE
        # in-flight commit, matching the reference's overlap of exactly
        # plan N's raft apply with plan N+1's verification
        # (plan_apply.go:56-70); without the bound a partitioned leader
        # would stack local-only applies and serve each submitter its
        # 10s failure in series
        self._commit_q = None
        # submitted-but-not-yet-applied plan results (applier thread
        # only): with apply-at-commit the store lags the log, so N+1's
        # verification must see N's placements or two optimistic plans
        # could double-book one node's capacity
        self._pending: List = []        # [(raft index, PlanResult)]
        # indexes of submitted plans whose commit FAILED — only those
        # leave the overlay early; sibling in-flight plans may still
        # commit and must keep occupying capacity until applied
        self._failed_pending: set = set()
        self._failed_l = make_lock()
        # per-applier group accounting (the governor gauges read these)
        self.stats: Dict[str, int] = {
            "groups": 0, "plans": 0, "conflict_retries": 0,
            "singleton_fallbacks": 0,
        }
        # adaptive group bound: None == config max; the governor's
        # conflict watermark halves it, clean streaks re-widen it
        self._group_bound: Optional[int] = None
        self._clean_groups = 0
        self._conflicts: deque = deque()
        self._conflict_l = make_lock()

    def start(self) -> None:
        import queue as queue_mod
        self._commit_q = queue_mod.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="plan-applier")
        self._thread.start()
        self._committer = threading.Thread(target=self._commit_loop,
                                           daemon=True,
                                           name="plan-committer")
        self._committer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        # the applier thread is dead (or wedged past the join timeout):
        # send the committer its shutdown sentinel, which it processes
        # after any in-flight commit, then fail whatever remains
        if self._commit_q is not None:
            for _ in range(25):
                try:
                    self._commit_q.put(None, timeout=0.2)
                    break
                except Exception:
                    continue
        if self._committer:
            self._committer.join(timeout=5)
        if self._commit_q is not None:
            while True:
                try:
                    item = self._commit_q.get_nowait()
                except Exception:
                    break
                if item is None:
                    continue
                pairs, _w, _gi = item
                fail_futures(pairs, RuntimeError("plan applier stopped"))

    # -- group sizing / governor hooks ---------------------------------
    def _config_bound(self) -> int:
        return max(1, int(getattr(self.server.config,
                                  "plan_group_max", 1) or 1))

    def effective_group_bound(self) -> int:
        """Current drain bound: the config max, shrunk by the
        governor's conflict reclaim."""
        cfg = self._config_bound()
        b = self._group_bound
        return cfg if b is None else max(1, min(b, cfg))

    def mean_group_size(self) -> float:
        g = self.stats["groups"]
        return self.stats["plans"] / g if g else 0.0

    def conflict_pressure(self) -> int:
        """Intra-group demotions within the sliding window — the
        governor gauge the conflict watermark reads (a monotone total
        would cross once and latch over forever)."""
        now = _time.monotonic()
        with self._conflict_l:
            while self._conflicts and \
                    now - self._conflicts[0] > CONFLICT_WINDOW_S:
                self._conflicts.popleft()
            return len(self._conflicts)

    def shrink_group_bound(self) -> dict:
        """Governor reclaim for `governor_plan_group_conflict_high`:
        halve the group bound so optimistic siblings stop trampling
        each other, instead of letting every demoted plan burn a
        verify-retry round trip. Recovery is automatic (_note_group)."""
        cfg = self._config_bound()
        cur = self._group_bound if self._group_bound is not None else cfg
        self._group_bound = max(1, cur // 2)
        self._clean_groups = 0
        return {"plan_group_bound": self._group_bound, "was": cur}

    def _note_group(self, size: int, conflicts: int,
                    singleton: bool = False) -> None:
        self.stats["groups"] += 1
        self.stats["plans"] += size
        if singleton:
            self.stats["singleton_fallbacks"] += 1
        if conflicts:
            self.stats["conflict_retries"] += conflicts
            now = _time.monotonic()
            with self._conflict_l:
                self._conflicts.extend([now] * conflicts)
            self._clean_groups = 0
        else:
            self._clean_groups += 1
            if self._group_bound is not None and \
                    self._clean_groups >= GROUP_RECOVER_CLEAN:
                self._clean_groups = 0
                widened = min(self._config_bound(), self._group_bound * 2)
                self._group_bound = None \
                    if widened >= self._config_bound() else widened

    # -- the applier loop ----------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            bound = self.effective_group_bound()
            if bound > 1:
                group = self.queue.dequeue_group(bound, timeout_s=0.2)
            else:
                pending = self.queue.dequeue(timeout_s=0.2)
                group = [pending] if pending is not None else []
            if not group:
                continue
            if len(group) == 1:
                # the escape hatch AND the idle-queue common case: one
                # plan commits through the unchanged singleton path
                # ("plan_results" raft entries), so plan_group_max=1
                # reproduces the one-entry-per-plan pipeline
                pending = group[0]
                try:
                    result, waiter = self.apply(pending.plan)
                except Exception as e:
                    pending.future.set_exception(e)
                    continue
                self._note_group(1, 0, singleton=True)
                item = ([(pending.future, result)], waiter,
                        result.alloc_index)
            else:
                try:
                    pairs, waiter, index = self.apply_group(group)
                except Exception as e:  # pragma: no cover - defensive
                    for pending in group:
                        if not pending.future.done():
                            pending.future.set_exception(e)
                    continue
                if not pairs:
                    continue
                item = (pairs, waiter, index)
            # hand the quorum wait to the committer and move on to
            # verifying the next group (pipelined commit); blocks while
            # one commit is already in flight (bounded pipeline)
            placed = False
            while not self._stop.is_set():
                try:
                    self._commit_q.put(item, timeout=0.2)
                    placed = True
                    break
                except Exception:
                    continue
            if not placed:
                fail_futures(item[0], RuntimeError("plan applier stopped"))

    def _commit_loop(self) -> None:
        from ..utils import stages
        while True:
            try:
                item = self._commit_q.get(timeout=0.2)
            except Exception:
                if self._stop.is_set():
                    return
                continue
            if item is None:            # shutdown sentinel
                return
            pairs, waiter, group_index = item
            try:
                if waiter is not None:
                    c0 = _time.perf_counter() if stages.enabled else 0.0
                    # no deadline while this server leads: a group whose
                    # wait timed out would still be in the log, free to
                    # commit after its submitters were told it failed
                    # and their evals re-ran without it — the same
                    # instances placed twice (plan_apply.go waits on the
                    # raft future the same way)
                    waiter(timeout_s=None)
                    if stages.enabled:
                        wdt = _time.perf_counter() - c0
                        stages.add("plan_commit", wdt)
                        # the quorum wait (pipelined behind the next
                        # group's verification) on each member's trace
                        for _future, result in pairs:
                            trace.emit(
                                getattr(result, "_trace", None),
                                "plan_commit", wdt, track="committer",
                                group=len(pairs), index=group_index,
                                phase="quorum")
                # demultiplex: every submitter gets ITS result off the
                # one group commit, in submission order
                for future, result in pairs:
                    if not future.done():
                        future.set_result(result)
            except Exception as e:
                # quorum unreachable / leadership lost: the submitting
                # workers see the failure and nack their evals; THIS
                # group's overlay must not keep rejecting capacity
                # forever (siblings already in flight stay)
                with self._failed_l:
                    if group_index:
                        self._failed_pending.add(group_index)
                fail_futures(pairs, e)

    # -- the core ------------------------------------------------------
    def apply(self, plan: Plan):
        """Verify + locally apply ONE plan. Returns (result, waiter);
        waiter is None or a callable blocking until quorum commit. The
        synchronous test/tool entry `apply_sync` folds the wait in."""
        from ..utils import metrics
        _t0 = _time.monotonic()
        try:
            return self._apply(plan)
        finally:
            metrics.measure_since("nomad.plan.evaluate", _t0)
            metrics.incr_counter("nomad.plan.apply")

    def apply_sync(self, plan: Plan) -> PlanResult:
        result, waiter = self.apply(plan)
        if waiter is not None:
            waiter()
        return result

    def _apply(self, plan: Plan):
        from ..utils import stages
        self._check_token(plan)
        store = self.server.store
        snapshot = store.snapshot()
        self._retire_pending(snapshot)
        tr = getattr(plan, "_trace", None)
        _v0 = _time.perf_counter() if stages.enabled else 0.0
        result, payload, evals, _conflicted = self._verify(snapshot,
                                                           plan, ())
        result._trace = tr      # the committer attributes the quorum wait
        if stages.enabled:
            _vdt = _time.perf_counter() - _v0
            stages.add("plan_verify", _vdt)
            trace.emit(tr, "plan_verify", _vdt, track="applier",
                       group=1, demoted=bool(result.refresh_index))
        if payload is None:
            return result, None
        from ..utils import metrics as _metrics
        _metrics.incr_counter("nomad.plan.placements",
                              _count_placements(result))

        # commit through the raft shim (FSM ApplyPlanResults)
        _c0 = _time.perf_counter() if stages.enabled else 0.0
        index, waiter = self.server.raft_apply_async(
            "plan_results", payload)
        if chaos_faults.ACTIVE:
            # same dispatched-not-yet-quorum window as the group path
            # below — the failover cell must trip even when the queue
            # was idle and the plan committed as a singleton
            chaos_faults.fire("plan.group_commit", index=index,
                              plans=1)
        result.alloc_index = index
        if result.refresh_index:
            # partial commit: the accepted slots land at THIS index,
            # above the verify snapshot — the retry's refresh fence
            # must cover them or a remote worker (whose local store
            # lags the leader's) replans from a snapshot that predates
            # the partial commit and re-places slots that already
            # exist (plan_apply.go applyPlan RefreshIndex = max)
            result.refresh_index = max(result.refresh_index, index)
        if waiter is not None:
            # apply-at-commit: the store won't show this plan until the
            # committer's waiter resolves — overlay it for the next
            # verification round
            self._pending.append((index, result))
        for ev in evals:
            self.server.enqueue_eval(ev)
        if stages.enabled:
            _cdt = _time.perf_counter() - _c0
            stages.add("plan_commit", _cdt)
            trace.emit(tr, "plan_commit", _cdt, track="applier",
                       group=1, index=index,
                       pipelined=waiter is not None)
        return result, waiter

    def apply_group(self, group: List[PendingPlan]):
        """Group commit: verify every plan in `group` against ONE
        snapshot — later plans see earlier members' claims through the
        pending-plan overlay, so an intra-group loser demotes to a
        partial result exactly as a stale-snapshot retry would — then
        commit all survivors as ONE raft entry / store transaction /
        event flush. Returns (pairs, waiter, group_index) where pairs
        is [(future, result)] in submission order; futures are resolved
        by the committer, not here. A plan failing the token fence
        fails only its own future and drops out of the group."""
        from ..utils import metrics, stages
        _t0 = _time.monotonic()
        _v0 = _time.perf_counter() if stages.enabled else 0.0
        store = self.server.store
        snapshot = store.snapshot()
        self._retire_pending(snapshot)

        entries: List[Tuple] = []       # (pending, result, payload, evals)
        accepted: List[PlanResult] = []
        conflicts = 0
        for pending in group:
            plan = pending.plan
            tr = getattr(plan, "_trace", None)
            _p0 = _time.perf_counter() if stages.enabled else 0.0
            try:
                self._check_token(plan)
                result, payload, evals, conflicted = self._verify(
                    snapshot, plan, accepted)
            except Exception as e:
                if not pending.future.done():
                    pending.future.set_exception(e)
                continue
            result._trace = tr  # the committer attributes the quorum wait
            if stages.enabled:
                # per-plan span with the group anatomy the aggregate
                # window can't carry: width, intra-group conflict,
                # demotion, and how long the plan sat queued behind
                # the serialization point
                trace.emit(
                    tr, "plan_verify", _time.perf_counter() - _p0,
                    track="applier", group=len(group),
                    conflicted=conflicted,
                    demoted=bool(result.refresh_index),
                    queue_ms=round(max(
                        _time.monotonic() - pending.enqueued_t, 0.0)
                        * 1000.0, 3))
            if conflicted:
                conflicts += 1
            entries.append((pending, result, payload, evals))
            if payload is not None:
                accepted.append(result)
                metrics.incr_counter("nomad.plan.placements",
                                     _count_placements(result))
            metrics.incr_counter("nomad.plan.apply")
        metrics.measure_since("nomad.plan.evaluate", _t0)
        if stages.enabled:
            stages.add("plan_verify", _time.perf_counter() - _v0)
        self._note_group(len(group), conflicts)

        pairs = [(pending.future, result)
                 for (pending, result, _p, _e) in entries]
        payloads = [p for (_pe, _r, p, _e) in entries if p is not None]
        if not payloads:
            return pairs, None, 0

        _c0 = _time.perf_counter() if stages.enabled else 0.0
        index, waiter = self.server.raft_apply_async(
            "plan_group_results", dict(groups=payloads))
        if chaos_faults.ACTIVE:
            # chaos hook (the leader_failover_commit cell): the group's
            # entry is in the leader's log and replicating, but no
            # submitter future has resolved — the exact window where a
            # dying leader must not double-commit (the entry either
            # reaches quorum and survives into the new term, or it never
            # happened; the workers' nack/redelivery covers both)
            chaos_faults.fire("plan.group_commit", index=index,
                              plans=len(payloads))
        for _pending, result, payload, _evs in entries:
            if payload is not None:
                result.alloc_index = index
                if waiter is not None:
                    self._pending.append((index, result))
            if result.refresh_index:
                # a demoted plan's missing capacity becomes visible at
                # the GROUP's commit index, not the snapshot's — point
                # the worker's refresh fence there so the retry sees
                # why it lost instead of replaying the same conflict
                result.refresh_index = max(result.refresh_index, index)
        for _pending, _result, _payload, evals in entries:
            for ev in evals:
                self.server.enqueue_eval(ev)
        if stages.enabled:
            _cdt = _time.perf_counter() - _c0
            stages.add("plan_commit", _cdt)
            # ONE raft entry / store transaction for the whole group:
            # the shared commit span lands on every member's trace with
            # the group size, so a p99 eval's anatomy shows whether it
            # amortized its commit or paid one alone
            for _pending, result, payload, _evs in entries:
                trace.emit(getattr(result, "_trace", None),
                           "plan_commit", _cdt, track="applier",
                           group=len(group), index=index,
                           committed=payload is not None)
        return pairs, waiter, index

    # -- verification --------------------------------------------------
    def _check_token(self, plan: Plan) -> None:
        """Token fence (plan_queue admission in the reference): a plan
        whose eval has been re-delivered (nack timeout mid-process)
        carries a stale token — committing it would double-place the
        job alongside the new holder's plan. Plans from test harness
        paths carry no outstanding eval and pass through."""
        if plan.eval_id and plan.eval_token:
            # tokens come only from worker dequeues, so a tokened plan
            # must still hold the delivery: token mismatch OR a no-
            # longer-outstanding eval (already re-delivered and acked
            # by the new holder) both mean stale
            current = self.server.eval_broker.outstanding(plan.eval_id)
            if current != plan.eval_token:
                raise RuntimeError(
                    f"plan for eval {plan.eval_id} submitted with stale "
                    "token; evaluation was re-delivered")

    def _retire_pending(self, snapshot) -> None:
        """Retire overlay entries the FSM has applied (visible in the
        snapshot now) or whose commit failed. The snapshot is an
        immutable MVCC root, so an entry kept here can never ALSO be
        visible in it — no double counting."""
        with self._failed_l:
            failed, self._failed_pending = self._failed_pending, set()
        latest = snapshot.latest_index()
        self._pending = [(i, r) for (i, r) in self._pending
                         if i > latest and i not in failed]

    def _verify(self, snapshot, plan: Plan, extra):
        """Verify one plan against `snapshot` + the submitted-but-
        unapplied overlay (self._pending) + `extra` (accepted results
        of earlier plans in the same group). Returns (result, payload,
        follow_up_evals, conflicted): payload is None for a no-op
        result; conflicted means a rejection touched a node an `extra`
        result claimed — an intra-group demotion the submitting worker
        will retry."""
        result = PlanResult()
        rejected = False

        # verify each touched node (evaluatePlan / evaluateNodePlan) —
        # one columnar pass over the resident node table for the common
        # shape, scalar fallback for nodes with removals/ports/devices
        verdicts = self._evaluate_nodes(snapshot, plan, extra)
        conflict_nodes = set()
        for r in extra:
            conflict_nodes.update(r.node_allocation)
            conflict_nodes.update(r.node_update)
            conflict_nodes.update(r.node_preemptions)
        conflicted = False
        n_rejected = 0
        for node_id, placements in plan.node_allocation.items():
            if verdicts[node_id]:
                result.node_allocation[node_id] = placements
            else:
                rejected = True
                n_rejected += len(placements)
                if node_id in conflict_nodes:
                    conflicted = True
        if n_rejected:
            from ..utils import metrics
            metrics.incr_counter("nomad.plan.node_rejected", n_rejected)

        # CSI write-claim capacity against the freshest state: two
        # optimistic plans (or two groups in one plan) must not commit
        # more write claimants than the volume's access mode admits
        # (csi.go WriteFreeClaims:385; claims apply per-placement)
        csi_rejected = self._enforce_csi_write_caps(
            snapshot, plan, result.node_allocation, extra)
        if csi_rejected and extra:
            conflicted = True
        rejected = rejected or csi_rejected
        # stops are always committable; preemptions commit only when the
        # placement they made room for was accepted — otherwise victims
        # would be evicted for an alloc that never enters state
        result.node_update = dict(plan.node_update)
        result.node_preemptions = {
            node_id: victims
            for node_id, victims in plan.node_preemptions.items()
            if node_id in result.node_allocation
            or node_id not in plan.node_allocation}
        result.deployment = plan.deployment
        result.deployment_updates = list(plan.deployment_updates)
        if rejected:
            result.refresh_index = snapshot.latest_index()
        if result.is_no_op():
            return result, None, [], conflicted

        stopped = [a for allocs in result.node_update.values()
                   for a in allocs]
        placed = [a for allocs in result.node_allocation.values()
                  for a in allocs]
        preempted = [a for allocs in result.node_preemptions.values()
                     for a in allocs]
        for a in placed:
            if a.job is None:
                a.job = plan.job

        # preempted allocs spawn follow-up evals for their jobs
        # (plan_apply.go:287-310)
        preempted_jobs = set()
        evals: List[Evaluation] = []
        for a in preempted:
            existing = snapshot.alloc_by_id(a.id)
            if existing is None:
                continue
            key = (existing.namespace, existing.job_id)
            if key in preempted_jobs:
                continue
            preempted_jobs.add(key)
            job = snapshot.job_by_id(*key)
            if job is None:
                continue
            evals.append(Evaluation(
                namespace=job.namespace, priority=job.priority,
                type=job.type, triggered_by=TRIGGER_PREEMPTION,
                job_id=job.id, status=EVAL_STATUS_PENDING))

        payload = dict(allocs_stopped=stopped, allocs_placed=placed,
                       allocs_preempted=preempted,
                       deployment=result.deployment,
                       deployment_updates=result.deployment_updates,
                       evals=evals)
        return result, payload, evals, conflicted

    def _overlay_results(self, extra) -> List[PlanResult]:
        """Submitted-but-unapplied results PLUS earlier same-group
        results — everything whose claims the snapshot cannot show."""
        out = [r for _i, r in self._pending]
        out.extend(extra)
        return out

    def _enforce_csi_write_caps(self, snapshot, plan: Plan,
                                node_allocation: Dict[str, List],
                                extra=()) -> bool:
        """Drop placements whose CSI write claims would exceed the
        volume's access mode, budgeting across the whole plan. Mutates
        node_allocation in place; returns True if anything was dropped
        (partial commit => refresh index)."""
        from ..models.csi import (ACCESS_MULTI_NODE_SINGLE_WRITER,
                                  ACCESS_SINGLE_NODE_WRITER)
        budgets: Dict = {}          # (ns, vol_id) -> free write slots
        # submitted-but-unapplied plans (and earlier plans of this
        # group) already hold their write slots
        for pres in self._overlay_results(extra):
            for allocs in pres.node_allocation.values():
                for pa in allocs:
                    pjob = pa.job or snapshot.job_by_id(pa.namespace,
                                                        pa.job_id)
                    ptg = pjob.lookup_task_group(pa.task_group) \
                        if pjob else None
                    for r in (ptg.volumes or {}).values() if ptg else []:
                        if getattr(r, "type", "host") != "csi" or \
                                getattr(r, "read_only", False):
                            continue
                        vol = snapshot.csi_volume(pa.namespace, r.source)
                        if vol is None or vol.access_mode not in (
                                ACCESS_SINGLE_NODE_WRITER,
                                ACCESS_MULTI_NODE_SINGLE_WRITER):
                            continue
                        if pa.id in vol.write_allocs:
                            continue
                        key = (pa.namespace, r.source)
                        if key not in budgets:
                            budgets[key] = 0 if vol.write_allocs else 1
                        budgets[key] -= 1
        dropped = False
        for node_id in list(node_allocation):
            kept = []
            for a in node_allocation[node_id]:
                job = a.job or plan.job or \
                    snapshot.job_by_id(a.namespace, a.job_id)
                tg = job.lookup_task_group(a.task_group) if job else None
                reqs = [r for r in (tg.volumes or {}).values()
                        if getattr(r, "type", "host") == "csi"
                        and not getattr(r, "read_only", False)] if tg else []
                ok = True
                touched = []
                for req in reqs:
                    vol = snapshot.csi_volume(a.namespace, req.source)
                    if vol is None or vol.access_mode not in (
                            ACCESS_SINGLE_NODE_WRITER,
                            ACCESS_MULTI_NODE_SINGLE_WRITER):
                        continue
                    if a.id in vol.write_allocs:
                        continue    # in-place update keeps its claim
                    key = (a.namespace, req.source)
                    if key not in budgets:
                        budgets[key] = 0 if vol.write_allocs else 1
                    if budgets[key] <= 0:
                        ok = False
                        break
                    touched.append(key)
                if ok:
                    for key in touched:
                        budgets[key] -= 1
                    kept.append(a)
                else:
                    dropped = True
            if kept:
                node_allocation[node_id] = kept
            elif node_id in node_allocation:
                del node_allocation[node_id]
        return dropped

    def _res_flags(self, alloc) -> tuple:
        """(has_networks, has_devices), memoized by the resources
        object's identity (plans share flyweight rows). Instance-level:
        the memo's lifetime is this applier's, not the process's."""
        res = alloc.allocated_resources
        if res is None:
            return (False, False)
        memo = self.__dict__.setdefault("_res_flags_memo", {})
        hit = memo.get(id(res))
        if hit is not None and hit[2] is res:
            return hit[:2]
        has_net = bool(res.shared.networks) or any(
            t.networks for t in res.tasks.values())
        has_dev = any(t.devices for t in res.tasks.values())
        if len(memo) > 65536:
            memo.clear()
        memo[id(res)] = (has_net, has_dev, res)
        return has_net, has_dev

    def _evaluate_nodes(self, snapshot, plan: Plan,
                        extra=()) -> Dict[str, bool]:
        """Batched evaluateNodePlan: the reference fans node checks to
        an EvaluatePool of goroutines (plan_apply.go:400); here the
        resident node table turns the common case — placements with no
        removals, ports, or devices on a ready node — into one
        vectorized usage-delta + capacity compare. A 10k-node plan
        verifies in ~50 ms instead of ~10 s of per-node alloc summing.
        Nodes outside the fast shape use the scalar path unchanged.
        `extra` carries earlier same-group results (group commit)."""
        import numpy as np

        from ..ops.tables import _alloc_usage

        items = list(plan.node_allocation.items())
        out: Dict[str, bool] = {}
        table = None
        if len(items) >= 8:
            try:
                # build=False: when the resident table has advanced past
                # this snapshot, a full private build would cost more
                # than the scalar fallback saves
                table = snapshot.node_table(build=False)
            except Exception:
                table = None
        if table is None:
            for node_id, _p in items:
                out[node_id] = self._evaluate_node(snapshot, plan,
                                                   node_id, extra)
            return out

        # overlay usage per node from submitted-but-unapplied plans
        # AND earlier group members, kept per alloc id LAST-WRITE-WINS:
        # an in-place update in the overlay supersedes both the
        # snapshot's copy (subtracted below) and any earlier overlay
        # copy of the same alloc, and a placement in THIS plan that
        # re-uses an overlay alloc's id supersedes it too (the scalar
        # path's placed_ids exclusion) — otherwise the node double-
        # counts one alloc's resources across its versions
        overlay_usage: Dict[str, Dict[str, tuple]] = {}
        overlay_flags: Dict[str, bool] = {}
        for pres in self._overlay_results(extra):
            for node_id, adds in pres.node_allocation.items():
                rows = overlay_usage.setdefault(node_id, {})
                for a in adds:
                    rows[a.id] = _alloc_usage(a)
                    hn, hd = self._res_flags(a)
                    if hn or hd:
                        overlay_flags[node_id] = True
            if pres.node_update or pres.node_preemptions:
                for node_id in list(pres.node_update) + \
                        list(pres.node_preemptions):
                    overlay_flags[node_id] = True

        alloc_by_id = snapshot.alloc_by_id
        idx_get = table.id_to_idx.get
        cand_idx: List[int] = []
        cand_nodes: List[str] = []
        deltas: List[tuple] = []
        for node_id, placements in items:
            i = idx_get(node_id)
            node = table.nodes[i] if i is not None else None
            if node is None or node.status != "ready" or node.drain \
                    or plan.node_update.get(node_id) \
                    or plan.node_preemptions.get(node_id) \
                    or overlay_flags.get(node_id) \
                    or (node.node_resources is not None
                        and node.node_resources.devices):
                out[node_id] = self._evaluate_node(snapshot, plan,
                                                   node_id, extra)
                continue
            d0 = d1 = d2 = d3 = 0.0
            ok = True
            for a in placements:
                hn, hd = self._res_flags(a)
                if hn or hd:
                    ok = False
                    break
                u = _alloc_usage(a)
                d0 += u[0]
                d1 += u[1]
                d2 += u[2]
                d3 += u[3]
                old = alloc_by_id(a.id)
                if old is not None and not old.terminal_status():
                    # in-place update: the snapshot copy is replaced
                    ou = _alloc_usage(old)
                    d0 -= ou[0]
                    d1 -= ou[1]
                    d2 -= ou[2]
                    d3 -= ou[3]
            if not ok:
                out[node_id] = self._evaluate_node(snapshot, plan,
                                                   node_id, extra)
                continue
            ov = overlay_usage.get(node_id)
            if ov is not None:
                placed_ids = {p.id for p in placements}
                for aid, u in ov.items():
                    if aid in placed_ids:
                        continue
                    d0 += u[0]
                    d1 += u[1]
                    d2 += u[2]
                    d3 += u[3]
                    old = alloc_by_id(aid)
                    if old is not None and not old.terminal_status():
                        # overlay in-place update: the snapshot's live
                        # copy is superseded at commit
                        ou = _alloc_usage(old)
                        d0 -= ou[0]
                        d1 -= ou[1]
                        d2 -= ou[2]
                        d3 -= ou[3]
            cand_idx.append(i)
            cand_nodes.append(node_id)
            deltas.append((d0, d1, d2, d3))
        if cand_idx:
            ii = np.asarray(cand_idx, np.int64)
            dd = np.asarray(deltas, np.float32)
            fits = np.all(
                table.base_used[ii] + dd <= table.capacity[ii] + 1e-6,
                axis=1)
            for node_id, fit in zip(cand_nodes, fits):
                out[node_id] = bool(fit)
        return out

    def _evaluate_node(self, snapshot, plan: Plan, node_id: str,
                       extra=()) -> bool:
        """evaluateNodePlan (plan_apply.go:629): would this node's
        placements fit against the freshest state?"""
        node = snapshot.node_by_id(node_id)
        if node is None:
            return False
        if node.status != "ready" and not plan.node_update.get(node_id):
            return False
        if node.drain or node.status != "ready":
            # placements on draining/non-ready nodes rejected; pure stops ok
            if plan.node_allocation.get(node_id):
                return False

        remove_ids = {a.id for a in plan.node_update.get(node_id, [])}
        remove_ids |= {a.id for a in plan.node_preemptions.get(node_id, [])}
        # In-place updates reuse the alloc ID: the planned version replaces
        # the snapshot version, so drop the old copy before appending or the
        # node double-counts its resources (plan_apply.go:674-678).
        placements = plan.node_allocation.get(node_id, [])
        remove_ids |= {a.id for a in placements}
        # overlay submitted-but-unapplied plans (pipelined commit) and
        # earlier same-group results (group commit): their placements
        # occupy capacity, their stops/preemptions free it. Last write
        # wins per alloc id IN COMMIT ORDER — an overlay in-place
        # update supersedes the snapshot's copy and any earlier overlay
        # copy, exactly what the FSM will do at apply
        overlay_by_id: Dict[str, Optional[Allocation]] = {}
        for pres in self._overlay_results(extra):
            for a in pres.node_update.get(node_id, []):
                overlay_by_id[a.id] = None
            for a in pres.node_preemptions.get(node_id, []):
                overlay_by_id[a.id] = None
            for a in pres.node_allocation.get(node_id, []):
                overlay_by_id[a.id] = a
        remove_ids |= set(overlay_by_id)
        placed_ids = {p.id for p in placements}
        proposed = [a for a in snapshot.allocs_by_node(node_id)
                    if not a.terminal_status() and a.id not in remove_ids]
        proposed.extend(a for a in overlay_by_id.values()
                        if a is not None and a.id not in placed_ids)
        proposed.extend(placements)
        fit, _dim, _used = AllocsFit(
            node, proposed,
            check_devices=bool(node.node_resources.devices))
        return fit
