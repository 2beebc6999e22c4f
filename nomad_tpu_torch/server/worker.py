"""Scheduling worker: dequeue -> snapshot fence -> scheduler.process ->
ack/nack, and the eval gateways that coalesce concurrent evals' kernel
dispatches into one batched dispatch (ops/select.py
SelectKernel.select_many).

Reference semantics: nomad/worker.go — run:105-138, dequeueEvaluation:142,
snapshotMinIndex:228, invokeScheduler:244, SubmitPlan:277-343 (snapshot
index fencing + RefreshIndex handling), pause during leadership
transitions.

Multi-eval batching: after a blocking dequeue lands one eval, the worker
drains up to eval_batch_size-1 more READY evals without waiting and
processes them as concurrent lanes. An eval's scheduler routes its kernel
dispatches through a gateway by setting `sched.kernel_dispatch =
gateway.dispatch`; the dispatch blocks until the batch that carries its
request has run. Two gateways, as in the JAX package's
nomad_tpu/server/worker.py:

  BatchGateway       per-drain rendezvous: one lane per eval of a drained
                     batch; fires when every live lane is parked, or when
                     the oldest parked request has waited out a window;
  MicroBatchGateway  one per server: continuous micro-batching across
                     lanes and workers, with occupancy / immediate / drain
                     / deadline triggers and an adaptive window.

The broker's one-outstanding-per-job invariant guarantees the lanes are
distinct jobs; plans still serialize through the plan applier.

Every kernel here lives on the server's device: the Worker's SelectKernel,
the EvalLane's planner device (the schedulers build their PlacementEngine
on it) and the server-wide gateway's kernel. A gateway on another device
than the lane raises. On the card the windows start from a measured host
<-> card round trip (ops/select.py cuda_roundtrip_s), never from a
constant measured on other hardware.

Flight recorder (trace/): each non-core eval opens a trace at dequeue,
backdated to its broker enqueue, and installs it as the thread's span
context around the fence and Process() (worker-N track); the
MicroBatchGateway records each parked request's wait onto the request's
captured trace and runs a fire under the union of its lanes' traces
(gateway track), so one batched launch's kernel span lands on every
lane; the plan carries the trace to the applier. Each acked eval's host
latency reaches the server's governor, whose backpressure shrinks the
drain width to one.

Chaos hook (chaos/faults.py): `worker.plan_committed` fires in
EvalLane.submit_plan after the plan committed and before the eval is
acked; an injected WorkerKilled is logged as such and nacked.

The JAX package's copy also reads the NOMAD_TPU_EVAL_BATCH and
NOMAD_TPU_MICROBATCH switches; this one does not.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import List, Optional

from .. import trace
from ..chaos import faults as chaos_faults
from ..models import Evaluation, JOB_TYPE_CORE, Plan, PlanResult
from ..rpc.codec import RpcError, RpcRefused
from ..scheduler import new_scheduler
from ..utils import gcsafe, stages
from ..utils.locks import make_condition, make_lock

LOG = logging.getLogger("nomad_tpu.worker")

DEQUEUE_TIMEOUT_S = 0.5
RAFT_SYNC_LIMIT = 10.0
# micro-batch lane concurrency per worker: enough overlapping evals to
# feed the gateway's coalescing, few enough that GIL-sharing host
# phases don't inflate each other into the latency the gateway saves
MICRO_LANES = 4
# how long Worker.stop waits for an eval in flight to finish
STOP_JOIN_S = 60.0
# eval latencies (broker enqueue -> ack) a worker keeps
LATENCY_KEEP = 65536


def _window_on_card(kernel, floor_s: float) -> float:
    """A gateway window: on the card at least half a measured round trip
    (waiting that long to share a dispatch always pays) and at most
    0.15 s; `floor_s` where the kernel runs on the host."""
    if getattr(getattr(kernel, "device", None), "type", None) != "cuda":
        return floor_s
    from ..ops.select import cuda_roundtrip_s
    return min(max(0.5 * cuda_roundtrip_s(), floor_s), 0.15)


class BatchGateway:
    """Rendezvous point turning concurrent per-lane kernel dispatches
    into one multi-eval device dispatch (ops/select.py select_many).

    Each lane is one in-flight eval. A lane interacts in exactly two
    ways: dispatch(req) — block until the coalesced result is ready —
    and lane_finished() when its eval completes. A batch fires when
    every still-active lane is parked in dispatch() (maximum width), or
    when the oldest parked request has waited out a short window —
    adaptive behavior: host-bound runs degrade toward per-eval
    dispatches instead of serializing behind stragglers, device-bound
    runs (short host phases) reach full width. Firing a partial batch
    is always safe: late lanes simply form the next batch.

    `partition` (on by default, as in a server) decorrelates the lanes
    of a batch (ops/select.py partition_lanes); with it off every lane
    places exactly as a solo eval on the same snapshot would. `stats`
    counts fires, batched fires and the lanes they carried."""

    WINDOW_S = 0.02

    def __init__(self, kernel, lanes: int, lane_base: int = 0,
                 lane_total: Optional[int] = None, partition: bool = True):
        self._kernel = kernel
        self._cv = make_condition()
        self._active = lanes
        # cross-worker decorrelation for batched lanes: each worker's
        # gateway slices the node hash space at an offset so two
        # workers' lane 0 don't fight over the same winners
        self._lane_base = lane_base
        self._lane_total = lane_total or lanes
        self.partition = partition
        self._waiting: List = []        # [(req, slot_dict)]
        self._open_t = 0.0              # arrival of the oldest waiter
        self._part_cache = (None, None)  # (n, lanes) -> lane ids per node
        self.window_s = _window_on_card(kernel, self.WINDOW_S)
        self.stats = {"dispatches": 0, "batches": 0, "lanes_sum": 0}

    @property
    def device(self):
        """The device of the kernel every fire runs on."""
        return getattr(self._kernel, "device", None)

    def dispatch(self, req):
        slot = {}
        with self._cv:
            if not self._waiting:
                self._open_t = time.monotonic()
            self._waiting.append((req, slot))
            self._fire_if_ready()
            while "out" not in slot:
                if self._waiting:
                    remaining = self.window_s - (time.monotonic()
                                                 - self._open_t)
                    if remaining <= 0:
                        self._fire()
                        continue
                    self._cv.wait(remaining)
                else:
                    self._cv.wait(0.5)
        out = slot["out"]
        if isinstance(out, Exception):
            raise out
        return out

    def lane_finished(self) -> None:
        with self._cv:
            self._active -= 1
            self._fire_if_ready()

    def _fire_if_ready(self) -> None:
        # cv held. Full width: every active lane is parked here, so no
        # later request can join this batch anyway.
        if not self._waiting or len(self._waiting) < self._active:
            return
        self._fire()

    def _fire(self) -> None:
        # cv held on entry; the kernel work runs with it RELEASED so
        # lanes that arrive mid-dispatch can enqueue (and other lanes'
        # host phases overlap the device round trip). Concurrent fires
        # are safe — each pops its own batch.
        batch, self._waiting = self._waiting, []
        if not batch:
            return
        self.stats["dispatches"] += 1
        self.stats["lanes_sum"] += len(batch)
        if len(batch) > 1:
            self.stats["batches"] += 1
        reqs = [r for r, _ in batch]
        self._cv.release()
        try:
            try:
                originals = self._partition(reqs) \
                    if self.partition and len(reqs) > 1 else None
                results = self._kernel.select_many(reqs)
                if originals is not None:
                    # a lane that could not fill its slice retries solo
                    # on the FULL node set — partitioning is a
                    # throughput heuristic and must never change
                    # failure semantics
                    for i, (req, res) in enumerate(zip(reqs, results)):
                        if originals[i] is not None and \
                                res.placed < req.count:
                            req.feasible = originals[i]
                            results[i] = self._kernel.select(req)
                outs = results
            except Exception as e:
                # not a fallback: every lane re-raises it in dispatch()
                outs = [e] * len(batch)
        finally:
            self._cv.acquire()
        for (_r, slot), res in zip(batch, outs):
            slot["out"] = res
        self._cv.notify_all()

    def _partition(self, reqs):
        """Decorrelate concurrent lanes (ops/select.partition_lanes:
        hash-partition + capacity-aware headroom, retry-on-shortfall
        semantics — one shared rule with the worker's solo
        decorrelation and the micro-batch gateway)."""
        from ..ops.select import partition_lanes
        originals, self._part_cache = partition_lanes(
            reqs, self._lane_base, self._lane_total, self._part_cache)
        return originals


class MicroBatchGateway:
    """Continuous micro-batching for eval kernel dispatches: concurrent
    evals' placement requests accumulate for a short ADAPTIVE deadline
    and ship as one batched kernel call (ops/select.select_many),
    instead of each paying a solo dispatch.

    One gateway per server (all workers and all their lane threads
    share it — unlike the per-drain BatchGateway rendezvous above,
    coalescing is continuous across dequeues and across workers).
    Triggers, in priority order:

      occupancy  len(waiting) >= gateway_min_batch (and a pipeline
                 slot is free): the batch is wide enough — fire now,
                 waiting longer only adds latency
      immediate  the cost model says batched dispatch doesn't pay at
                 this shape, or the lane is idle (nothing in flight
                 and the EWMA of inter-arrival gaps says no companion
                 is expected within the window): dispatch NOW,
                 protecting p99
      drain      an in-flight dispatch IS the window (continuous
                 batching): requests that arrived while the device was
                 busy park, and the moment the pipeline empties they
                 fire as one batch — self-clocking, so occupancy grows
                 with load and the added wait is bounded by a dispatch
                 the request could not have started anyway
      deadline   the oldest parked request waited out the adaptive
                 window while requests were streaming: fire whatever
                 accumulated (falls through SOLO when both pipeline
                 slots are busy, so the cap never wedges an eval)

    The window adapts in both directions: queue depth above
    `depth_high` widens it (up to 4x — under a backlog, occupancy is
    worth more than per-eval latency) and a shallow queue decays it
    back; widen_window (a reclaim hook for a depth watermark) doubles
    it. Two-deep pipeline: at most MAX_INFLIGHT batched dispatches are
    in flight — the condition variable is RELEASED around the kernel
    call, so later evals' host phases (reconcile, stack setup) overlap
    an in-flight batch and accumulate the next one. A fire takes at
    most ops/select.GATEWAY_MAX_LANES requests. Each request's park
    time is reported as the `gateway_wait` stage."""

    MAX_INFLIGHT = 2        # two-deep dispatch pipeline
    SCALE_MAX = 4.0         # widest backpressure window multiplier
    GAP_ALPHA = 0.5         # inter-arrival EWMA: recover from an idle
                            # period within ~3 burst arrivals
    GAP_CAP_WINDOWS = 8.0   # idle gaps fold in capped at 8 windows
    STREAM_FACTOR = 2.0     # gap EWMA <= 2 windows == streaming
    STRAGGLER_GAPS = 4.0    # idle-engine wait bound in arrival gaps:
                            # if no companion shows within ~4 expected
                            # gaps the stream has ended — fire rather
                            # than pin the last eval of a burst to the
                            # full window (p99 protection)
    COST_TOLERANCE = 1.5    # coalesce unless the batched arm measures
                            # decisively slower (the per-lane EWMA
                            # folds widths: width 2 ~parity, width 8
                            # wins — strict < would flap batching off)

    def __init__(self, kernel=None, window_us: int = 2000,
                 min_batch: int = 4, depth_fn=None, depth_high: int = 0,
                 partition: bool = True):
        if kernel is None:
            from ..ops.select import SelectKernel
            kernel = SelectKernel()
        self._kernel = kernel
        self._cv = make_condition()
        self._waiting: List = []    # [[req, slot, arrival_t, decor]]
        self._inflight = 0
        self.min_batch = max(2, int(min_batch))
        self.partition = partition
        self._depth_fn = depth_fn
        self._depth_high = int(depth_high)
        self._scale = 1.0
        self._gap_ewma: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._dispatch_ewma = 0.0   # EWMA of fire wall clock: while a
        # dispatch is in flight, parked requests extend their deadline
        # to cover it — the drain trigger (not a premature solo
        # deadline fire) should collect them when the window is
        # shorter than one dispatch
        self._part_cache = (None, None)
        self._solo_decor_cache = (None, None)
        # rotating lane-partition offset: two batches fired while both
        # in flight must not hand their lane 0 the SAME hash slice of
        # the node table — they would argmax the same winners and
        # collide in the plan applier exactly like unpartitioned lanes
        self._part_rot = 0
        self.stats = {"requests": 0, "dispatches": 0, "batches": 0,
                      "lanes_sum": 0, "immediate_dispatches": 0,
                      "occupancy_dispatches": 0, "drain_dispatches": 0,
                      "deadline_dispatches": 0,
                      "wait_s_sum": 0.0, "partition_retries": 0}
        self.base_window_s = _window_on_card(kernel,
                                             max(window_us, 0) / 1e6)

    @property
    def device(self):
        """The device of the kernel every fire runs on."""
        return getattr(self._kernel, "device", None)

    # -- window --------------------------------------------------------
    def window_s(self) -> float:
        return self.base_window_s * self._scale

    def window_us(self) -> float:
        return self.window_s() * 1e6

    def occupancy_mean(self) -> float:
        return self.stats["lanes_sum"] / max(self.stats["dispatches"], 1)

    def widen_window(self) -> dict:
        """Reclaim hook for a queue-depth watermark: under a backlog, a
        wider window buys occupancy (one dispatch for many evals) at the
        cost of per-eval wait — the right trade exactly when the queue,
        not the eval, dominates latency. Decays back via _adapt once the
        depth clears."""
        with self._cv:
            self._scale = min(self._scale * 2.0, self.SCALE_MAX)
            return {"window_us": round(self.window_us(), 1)}

    def _adapt(self) -> None:
        """Depth-coupled window adaptation (cv held): widen while the
        queue depth is over `depth_high`, decay back toward the
        configured target once the queue is shallow — idle lanes
        additionally dispatch immediately via the streaming test, so p99
        is protected from both directions."""
        if self._depth_fn is None or self._depth_high <= 0:
            return
        try:
            depth = self._depth_fn()
        except Exception:       # pragma: no cover — defensive
            return
        if depth > self._depth_high:
            self._scale = min(self._scale * 1.5, self.SCALE_MAX)
        elif depth * 4 < self._depth_high and self._scale > 1.0:
            self._scale = max(self._scale * 0.75, 1.0)

    # -- arrival-rate model --------------------------------------------
    def _note_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            cap = self.GAP_CAP_WINDOWS * max(self.base_window_s, 1e-4)
            gap = min(now - self._last_arrival, cap)
            if self._gap_ewma is None:
                self._gap_ewma = gap
            else:
                self._gap_ewma += self.GAP_ALPHA * (gap - self._gap_ewma)
        self._last_arrival = now

    def _streaming(self) -> bool:
        """Are more requests expected within the window? Cold and idle
        lanes say no — their requests dispatch immediately instead of
        paying a window that nothing will share."""
        if self.window_s() <= 0:
            return False
        if self._gap_ewma is None:
            return False
        return self._gap_ewma <= self.STREAM_FACTOR * self.window_s()

    def _worth_waiting(self, req) -> bool:
        """Cost-model gate: coalescing pays where one batched dispatch
        beats per-lane solo dispatches within COST_TOLERANCE
        (measured, seeded by calibrate_cost_model; exploration probes
        keep the batched side measured either way)."""
        try:
            return self._kernel.batch_dispatch_profitable(
                len(req.feasible), tolerance=self.COST_TOLERANCE)
        except Exception:       # pragma: no cover — defensive
            return True

    # -- dispatch ------------------------------------------------------
    def dispatch(self, req, decorrelate=None):
        """Block until this request's result is ready; requests that
        overlap in the window return from ONE coalesced select_many.
        `decorrelate` carries the worker's (lane, lanes) so solo fires
        keep the cross-worker hash-slice decorrelation the direct
        kernel path applies."""
        slot: dict = {}
        now = time.monotonic()
        # flight recorder: capture the DISPATCHING eval's trace context
        # now — the fire that eventually serves this request runs on
        # whichever thread triggered it, so the park span must attach
        # through the entry, not thread-locals
        entry = [req, slot, now, decorrelate, trace.current_all()]
        with self._cv:
            self._note_arrival(now)
            self._adapt()
            self.stats["requests"] += 1
            self._waiting.append(entry)
            worth = self._worth_waiting(req)
            if worth and len(self._waiting) >= self.min_batch and \
                    self._inflight < self.MAX_INFLIGHT:
                self._fire("occupancy")
            elif not worth or (self._inflight == 0
                               and not self._streaming()):
                self._fire("immediate")
            while "out" not in slot:
                if self._waiting:
                    if self._inflight == 0 and len(self._waiting) >= 2:
                        # the dispatch that just landed was this
                        # group's window: drain it as one batch
                        if self._fire("drain"):
                            continue
                    eff_window = self.window_s()
                    if self._inflight > 0:
                        # engine busy: don't deadline-fire a parked
                        # request solo moments before the in-flight
                        # dispatch would have drained it into a batch
                        eff_window = max(
                            eff_window,
                            min(self._dispatch_ewma * 2.0, 0.25))
                    elif self._gap_ewma is not None:
                        # engine idle: a companion is only expected
                        # within ~the arrival gap — when none shows in
                        # a few gaps the stream has ended, and the last
                        # eval of a burst must not eat the full window
                        eff_window = min(
                            eff_window,
                            max(self.STRAGGLER_GAPS * self._gap_ewma,
                                1e-4))
                    remaining = (self._waiting[0][2] + eff_window
                                 - time.monotonic())
                    if remaining <= 0:
                        if not self._fire("deadline"):
                            # racing fire emptied the lane under us
                            self._cv.wait(0.01)
                        continue
                    self._cv.wait(remaining)
                else:
                    self._cv.wait(0.5)
        out = slot["out"]
        if isinstance(out, Exception):
            raise out
        return out

    def _take_batch(self, max_width: int) -> Optional[List]:
        """Pop the oldest waiter's shared-table group (same node count,
        same capacity identity, same algorithm — select_many's batching
        precondition), capped at max_width. Waiters left behind fire on
        their own deadline."""
        if not self._waiting:
            return None
        head = self._waiting[0][0]
        key = (len(head.feasible), id(head.capacity), head.algorithm)
        batch, rest = [], []
        for e in self._waiting:
            r = e[0]
            if len(batch) < max_width and \
                    (len(r.feasible), id(r.capacity),
                     r.algorithm) == key:
                batch.append(e)
            else:
                rest.append(e)
        self._waiting = rest
        return batch

    def _fire(self, trigger: str) -> bool:
        # cv held on entry; the kernel work runs with it RELEASED so
        # later evals' host phases overlap the in-flight device batch
        # and accumulate the next one (two-deep pipeline: at most
        # MAX_INFLIGHT BATCHED dispatches in flight). With both
        # pipeline slots busy the oldest waiter falls through SOLO, so
        # the cap can delay coalescing but never an eval
        from ..ops.select import GATEWAY_MAX_LANES
        width = GATEWAY_MAX_LANES if self._inflight < self.MAX_INFLIGHT \
            else 1
        batch = self._take_batch(width)
        if not batch:
            return False
        now = time.monotonic()
        self.stats[trigger + "_dispatches"] += 1
        self.stats["dispatches"] += 1
        self.stats["lanes_sum"] += len(batch)
        if len(batch) > 1:
            self.stats["batches"] += 1
        batch_id = self.stats["dispatches"]
        for e in batch:
            waited = now - e[2]
            self.stats["wait_s_sum"] += waited
            if stages.enabled:
                stages.add("gateway_wait", waited)
            # flight recorder: the park span lands on the PARKED eval's
            # trace (captured at dispatch()) with the batch anatomy —
            # the firing thread belongs to some other eval
            for tr_ in e[4]:
                tr_.add_span("gateway_wait", waited, end_mono=now,
                             track="gateway",
                             attrs={"trigger": trigger,
                                    "batch": batch_id,
                                    "lanes": len(batch)})
        # every fire counts as in-flight (the drain trigger's
        # engine-busy signal); the MAX_INFLIGHT cap only limits how
        # WIDE a fire may be, so solo fallthroughs can exceed it
        self._inflight += 1
        reqs = [e[0] for e in batch]
        decors = [e[3] for e in batch]
        # the shared launch fans out to every lane's trace (the kernel
        # span attaches to each eval that rode it)
        fan = [t for e in batch for t in e[4]]
        self._cv.release()
        try:
            with trace.use_many(fan, track="gateway"):
                outs = self._run(reqs, decors)
        finally:
            self._cv.acquire()
            self._inflight -= 1
            wall = time.monotonic() - now
            self._dispatch_ewma += 0.3 * (wall - self._dispatch_ewma)
        for e, res in zip(batch, outs):
            e[1]["out"] = res
        self._cv.notify_all()
        return True

    def _run(self, reqs, decors) -> List:
        try:
            if len(reqs) == 1:
                return [self._solo(reqs[0], decors[0])]
            originals = None
            if self.partition:
                from ..ops.select import (GATEWAY_MAX_LANES,
                                          partition_lanes)
                # cache read/advance/writeback under the cv: two
                # pipelined in-flight fires racing an unlocked
                # reassignment would lose the (n, total)->lane_ids
                # memo every time they overlap
                with self._cv:
                    base = self._part_rot
                    self._part_rot = (self._part_rot + len(reqs)) \
                        % GATEWAY_MAX_LANES
                    cache = self._part_cache
                originals, cache = partition_lanes(
                    reqs, base, GATEWAY_MAX_LANES, cache)
                with self._cv:
                    self._part_cache = cache
            results = self._kernel.select_many(reqs)
            if originals is not None:
                # a lane that could not fill its slice retries solo on
                # the FULL node set — partitioning must never change
                # failure semantics
                for i, (req, res) in enumerate(zip(reqs, results)):
                    if originals[i] is not None and \
                            res.placed < req.count:
                        req.feasible = originals[i]
                        self.stats["partition_retries"] += 1
                        results[i] = self._kernel.select(req)
            return results
        except Exception as e:
            # not a fallback: every lane re-raises it in dispatch()
            return [e] * len(reqs)

    def _solo(self, req, decor):
        """Solo fire with the worker's cross-worker decorrelation (the
        same hash-slice + retry-on-shortfall rule the direct kernel
        path applies for large batch asks)."""
        if decor is not None and req.count >= 256:
            from ..ops.select import decorrelation_slice
            lane, lanes = decor
            with self._cv:
                cache = self._solo_decor_cache
            slice_mask, cache = decorrelation_slice(
                req, lane, lanes, cache)
            with self._cv:
                self._solo_decor_cache = cache
            if slice_mask is not None:
                original = req.feasible
                req.feasible = slice_mask
                # the sliced mask no longer matches the resident copy
                req.feas_token = None
                req.feas_residue = None
                res = self._kernel.select(req)
                if res.placed < req.count:
                    req.feasible = original
                    res = self._kernel.select(req)
                return res
        return self._kernel.select(req)


def check_same_device(gateway, device) -> None:
    """A gateway's kernel and the lane's planner must share a device: the
    lane's feasibility tokens park on its kernel's device and the table
    mirror lives on the device that dispatches first, so a mixed pair
    would ship state across devices. Raises instead of copying."""
    import torch
    gdev = gateway.device
    if gdev is not None and torch.device(gdev) != torch.device(device):
        raise ValueError(f"the gateway's kernel runs on {gdev}, the "
                         f"eval's planner on {device}")


class EvalLane:
    """Planner bound to ONE in-flight eval (worker.go binds this state
    to the worker itself; concurrent batch lanes each need their own
    token/snapshot-index). `device` is where the eval's placements run:
    the schedulers build their PlacementEngine's SelectKernel on it."""

    def __init__(self, server, ev: Evaluation, token: str, device=None):
        self.server = server
        self.eval = ev
        self.token = token
        self.snapshot_index = 0
        self.device = server.device if device is None else device

    # -- Planner interface --------------------------------------------
    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        from ..utils import metrics
        t0 = time.monotonic()
        plan.eval_token = self.token
        plan.snapshot_index = self.snapshot_index
        # flight recorder: the applier/committer threads attribute their
        # verify/commit spans through the plan, not thread-locals
        plan._trace = trace.current()
        future = self.server.plan_queue.enqueue(plan)
        # no timeout (worker.go SubmitPlan waits on the plan's future): a
        # plan still in flight when its submitter gave up could commit
        # after its eval re-ran without it; the applier resolves every
        # future it takes, with a result or the error that refused it
        result: PlanResult = future.result()
        if chaos_faults.ACTIVE:
            # chaos hook: the plan IS committed at this point but the
            # eval is not acked — an armed worker-kill fault raises here,
            # modeling a scheduler worker dying mid-commit. The broker's
            # nack path redelivers the eval and the retry's reconcile
            # must see these placements
            chaos_faults.fire(
                "worker.plan_committed", eval_id=self.eval.id,
                placements=sum(len(a) for a in
                               plan.node_allocation.values()))
        metrics.measure_since("nomad.worker.submit_plan", t0)
        # if some placements were rejected, wait for the refresh index so
        # the next attempt sees why (worker.go:318-340)
        if result.refresh_index:
            self.server.store.block_min_index(result.refresh_index - 1,
                                              timeout_s=RAFT_SYNC_LIMIT)
        return result

    def refreshed_state(self, index: int):
        return self.server.store.snapshot_min_index(index,
                                                    timeout_s=RAFT_SYNC_LIMIT)

    def update_eval(self, ev: Evaluation) -> None:
        self.server.raft_apply("eval_update", dict(evals=[ev]))

    def create_eval(self, ev: Evaluation) -> None:
        ev.snapshot_index = self.snapshot_index
        self.server.raft_apply("eval_update", dict(evals=[ev]))

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.blocked_evals.block(ev)


class Worker:
    def __init__(self, server, enabled_schedulers: List[str], wid: int = 0):
        self.server = server
        self.schedulers = list(enabled_schedulers)
        self.id = wid
        self.device = server.device
        self.batch_size = max(1, getattr(server.config,
                                         "eval_batch_size", 1))
        self.broker = server.eval_broker
        # snapshot-fence budget: how long to wait for the store to reach
        # the eval's modify index before nacking
        self.fence_timeout_s = RAFT_SYNC_LIMIT
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # gated_drains: drains of more than one eval run one by one
        # because the cost model said batched lanes do not pay;
        # gateway_dispatches / gateway_batches / gateway_lanes: the
        # fires of this worker's per-drain BatchGateways, those of more
        # than one lane, and the lanes they carried
        self.stats = {"processed": 0, "failed": 0, "batches": 0,
                      "gated_drains": 0, "fence_timeouts": 0,
                      "gateway_dispatches": 0, "gateway_batches": 0,
                      "gateway_lanes": 0}
        # broker enqueue -> ack of every eval this worker acked (s)
        self.latencies_s: deque = deque(maxlen=LATENCY_KEEP)
        # pipelined dispatch: eval N's terminal bookkeeping (broker
        # ack + latency accounting) runs on a finisher thread while
        # this thread dequeues eval N+1 and starts its host phase —
        # bounded to a DOUBLE BUFFER (one finish in flight + one
        # queued) so a wedged ack applies backpressure instead of
        # accumulating unacked evals
        self._finish_q: queue.Queue = queue.Queue(maxsize=2)
        self._finisher: Optional[threading.Thread] = None
        # one kernel, on the server's device, shared by this worker's
        # BatchGateways and its profitability question
        from ..ops.select import SelectKernel
        self._kernel = SelectKernel(self.device)
        if getattr(server, "gateway", None) is not None:
            check_same_device(server.gateway, self.device)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._finisher = threading.Thread(
            target=self._finish_loop, daemon=True,
            name=f"worker-{self.id}-finisher")
        self._finisher.start()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"worker-{self.id}")
        self._thread.start()

    def request_stop(self) -> None:
        """Ask the loop to end after its current eval, without waiting
        (a server stops all its workers at once, then joins each)."""
        self._stop.set()

    def stop(self) -> None:
        self.request_stop()
        if self._thread:
            # an eval in flight runs to its end (its plan still commits)
            self._thread.join(timeout=STOP_JOIN_S)
            if self._thread.is_alive():
                LOG.warning("worker %d: still running at shutdown",
                            self.id)
        if self._finisher:
            # drain: the sentinel rides behind any pending finishes, so
            # deferred acks land before shutdown returns
            try:
                self._finish_q.put(None, timeout=5.0)
            except queue.Full:
                LOG.warning(
                    "worker %d: finish queue wedged at shutdown; "
                    "pending deferred acks will be dropped (evals "
                    "redeliver after nack timeout)", self.id)
            self._finisher.join(timeout=5)
            if self._finisher.is_alive():
                LOG.warning(
                    "worker %d: finisher did not drain at shutdown",
                    self.id)

    def _finish_loop(self) -> None:
        while True:
            fn = self._finish_q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:       # pragma: no cover — defensive
                LOG.exception("worker %d: deferred finish failed",
                              self.id)

    def set_pause(self, paused: bool) -> None:
        if paused:
            self._paused.set()
        else:
            self._paused.clear()

    def run(self) -> None:
        # GC safepoints (utils/gcsafe.py): automatic collections on a
        # large heap land mid-eval and cost scheduling latency; when
        # enabled, collection happens between evals instead —
        # coordinated across workers, restored on exit
        use_safepoints = getattr(self.server.config,
                                 "gc_safepoints", False)
        if use_safepoints:
            gcsafe.enter()
        try:
            self._run_loop(use_safepoints)
        finally:
            if use_safepoints:
                gcsafe.exit_()

    def _run_loop(self, use_safepoints: bool) -> None:
        while not self._stop.is_set():
            if self._paused.is_set():
                time.sleep(0.05)
                continue
            # NOTE: workers never consume the failed queue — the leader's
            # reaper turns those into delayed follow-up evals
            # (leader.go reapFailedEvaluations:766 / Server._reap_failed_evals)
            ev, token = self.broker.dequeue(
                self.schedulers, DEQUEUE_TIMEOUT_S)
            if ev is None:
                continue
            batch = [(ev, token)]
            batch_size = self._effective_batch_size()
            if batch_size > 1 and ev.type != JOB_TYPE_CORE:
                # drain already-READY compatible evals without waiting
                # (eval_broker.go:329 Dequeue; the queue depth IS the
                # batching opportunity)
                while len(batch) < batch_size:
                    ev2, tok2 = self.broker.dequeue(
                        self.schedulers, timeout_s=0)
                    if ev2 is None:
                        break
                    if ev2.type == JOB_TYPE_CORE:
                        # core evals don't place; run solo afterwards
                        self.process_eval(ev2, tok2)
                        continue
                    batch.append((ev2, tok2))
            if len(batch) == 1:
                self.process_eval(ev, token)
            else:
                self.process_eval_batch(batch)
            if use_safepoints:
                gcsafe.safepoint()

    def _effective_batch_size(self) -> int:
        """The lane width of the next drain: the configured width, shrunk
        to solo dispatches while the governor signals backpressure — wide
        lanes multiply in-flight host work exactly when the sampled p99
        says the host is the bottleneck; the width recovers when the
        gauge clears (FollowerWorker drains one)."""
        if self.batch_size <= 1:
            return self.batch_size
        gov = getattr(self.server, "governor", None)
        if gov is not None and gov.backpressure():
            return 1
        return self.batch_size

    def _micro_gateway(self):
        """The server-wide micro-batch gateway, or None when the server
        has none (gateway_window_us=0). A gateway on another device than
        this worker's raises."""
        gw = getattr(self.server, "gateway", None)
        if gw is not None:
            check_same_device(gw, self.device)
        return gw

    def _make_lane(self, ev: Evaluation, token: str) -> "EvalLane":
        """Planner-lane factory seam: FollowerWorker returns a
        RemoteEvalLane whose plans travel over Plan.Submit."""
        return EvalLane(self.server, ev, token, device=self.device)

    def _note_fence(self, seconds: float) -> None:
        """Fence-wait observation hook (FollowerWorker feeds its
        fence_wait_p99_ms reservoir through this)."""

    # -- single eval ---------------------------------------------------
    def process_eval(self, ev: Evaluation, token: str,
                     dispatch=None, lat_scale: int = 1) -> None:
        from ..utils import metrics
        lane = self._make_lane(ev, token)
        if dispatch is None and ev.type != JOB_TYPE_CORE:
            # continuous micro-batching: every eval's kernel dispatches
            # flow through the server-wide gateway, where requests that
            # overlap within the adaptive window coalesce into one
            # batched launch — across lanes AND across workers. The
            # gateway's solo path keeps the cross-worker decorrelation
            # the direct kernel path applies
            gw = self._micro_gateway()
            if gw is not None:
                n_workers = len(getattr(self.server, "workers", []) or [])
                if n_workers > 1:
                    from functools import partial
                    dispatch = partial(gw.dispatch,
                                       decorrelate=(self.id, n_workers))
                else:
                    dispatch = gw.dispatch
        # flight recorder: one span tree per eval, anchored back at
        # broker enqueue. The context installs the trace as this
        # thread's span target, so the stage report sites inside the
        # fence + Process() window (reconcile, table_build, kernel,
        # sched_host) attribute to THIS eval; the plan applier and the
        # gateway attach their spans through the plan / dispatch entry
        # instead. Core evals don't place — not traced
        tr = None
        if ev.type != JOB_TYPE_CORE:
            tr = trace.begin(ev, track=f"worker-{self.id}")
        try:
            with trace.use(tr):
                if stages.enabled and ev.type != JOB_TYPE_CORE:
                    stages.add("queue_wait",
                               getattr(ev, "queue_wait_s", 0.0) or 0.0)
                # the snapshot fence: wait for the state store to catch
                # up to the eval's modify index, or to the later index a
                # remote dequeue names (follower_sched.wait_index)
                t0 = time.monotonic()
                snap = self.server.store.snapshot_min_index(
                    max(ev.modify_index, getattr(ev, "wait_index", 0)),
                    timeout_s=self.fence_timeout_s)
                fence_dt = time.monotonic() - t0
                metrics.measure_since("nomad.worker.wait_for_index", t0)
                if stages.enabled and ev.type != JOB_TYPE_CORE:
                    stages.add("fence_wait", fence_dt)
                self._note_fence(fence_dt)
                lane.snapshot_index = snap.latest_index()
                if ev.type != JOB_TYPE_CORE:
                    # refresh the resident table NOW: the committed
                    # plans' host row deltas apply here, before this
                    # thread builds the scheduler and its masks (the
                    # device mirror follows at the eval's first
                    # dispatch). build=False: a stale snapshot must not
                    # pay a private full build just to warm a cache it
                    # can't use
                    snap.node_table(build=False)
                if ev.type == JOB_TYPE_CORE:
                    # worker.go invokeScheduler: _core evals get the GC
                    # pseudo-scheduler, not a placement scheduler
                    from .core_sched import CoreScheduler
                    sched = CoreScheduler(snap, self.server)
                else:
                    sched = new_scheduler(self._scheduler_for(ev), snap,
                                          lane)
                    if dispatch is not None and \
                            hasattr(sched, "kernel_dispatch"):
                        sched.kernel_dispatch = dispatch
                    # cross-worker decorrelation: concurrent workers
                    # must not all argmax onto the same winners
                    # (ops/select.py SelectKernel.decorrelate)
                    n_workers = len(getattr(self.server, "workers", [])
                                    or [])
                    if n_workers > 1:
                        sched.kernel_decorrelate = (self.id, n_workers)
                t0 = time.monotonic()
                sched.process(ev)
                if stages.enabled and ev.type != JOB_TYPE_CORE:
                    stages.add("sched_host", time.monotonic() - t0)
            metrics.measure_since(
                f"nomad.worker.invoke_scheduler_{self._scheduler_for(ev)}"
                if ev.type != JOB_TYPE_CORE
                else "nomad.worker.invoke_scheduler_core", t0)
            gov = getattr(self.server, "governor", None)
            elapsed = time.monotonic() - t0
            # the broker stamps how long the eval sat in the READY queue:
            # it feeds the governor's FULL-latency reservoir only — the
            # backpressure p99 gauge stays host-processing-only, or a
            # backlog would inflate the very gauge that sheds enqueues
            # and shrinks lanes (positive feedback)
            q_wait = getattr(ev, "queue_wait_s", 0.0)

            def _finish():
                if gov is not None and ev.type != JOB_TYPE_CORE:
                    # lat_scale normalizes batched lanes: B concurrent
                    # GIL-sharing lanes each see ~B x their own host
                    # work in wall clock, and feeding that raw into the
                    # p99 gauge would engage backpressure on healthy
                    # wide batches
                    gov.observe_eval_latency(elapsed / lat_scale,
                                             queue_wait_s=q_wait)
                a0 = time.perf_counter() if stages.enabled else 0.0
                with trace.use(tr):
                    self.broker.ack(ev.id, token)
                    if stages.enabled:
                        stages.add("broker_ack", time.perf_counter() - a0)
                # the ack closes the span tree: enqueue -> ... -> ack
                trace.finish(tr, status="acked")
                entered = getattr(ev, "_entered_broker_t", None)
                if entered is not None and ev.type != JOB_TYPE_CORE:
                    self.latencies_s.append(time.monotonic() - entered)
                self.stats["processed"] += 1
                metrics.incr_counter("nomad.worker.eval_processed")

            # overlap the ack-side bookkeeping with the next eval's
            # dequeue + host phase (double-buffered)
            self._finish_q.put(_finish)
        except Exception as e:
            if isinstance(e, chaos_faults.WorkerKilled):
                # an INJECTED kill (chaos cell), not a scheduler bug:
                # the nack below is exactly the redelivery the cell's
                # no-double-commit invariant exercises
                LOG.warning("worker %d: %s", self.id, e)
            elif isinstance(e, TimeoutError):
                # snapshot fence expired: the store never reached the
                # eval's modify index. NACK — never drop — so the eval
                # redelivers
                self.stats["fence_timeouts"] += 1
                LOG.debug("worker %d: eval %s fence timed out; nacked",
                          self.id, ev.id)
            elif isinstance(e, (ConnectionError, RpcError, RpcRefused)):
                # the plan queue refused (a server shutting down): nack
                # and let the broker redeliver
                LOG.debug("worker %d: eval %s lost its transport (%s);"
                          " nacked", self.id, ev.id, e)
            else:
                LOG.exception("worker %d: eval %s failed", self.id,
                              ev.id)
            self.stats["failed"] += 1
            try:
                self.broker.nack(ev.id, token)
            except Exception:
                pass
            trace.finish(tr, status="failed")

    # -- batched evals -------------------------------------------------
    def process_eval_batch(self, batch: List) -> None:
        """Process B dequeued evals as concurrent lanes. With the
        micro-batch gateway live, the lanes simply run concurrently and
        their kernel dispatches flow into the server-wide gateway, where
        the window/occupancy triggers — not a per-drain pre-decision —
        determine coalescing (lanes from OTHER workers join the same
        batches). Without one (gateway_window_us=0): one per-drain
        BatchGateway rendezvous, whose kernel dispatches coalesce into
        select_many calls. Host-side work (reconcile, plan build)
        interleaves under the GIL; the device sees whole batches. When
        the kernel's cost model says one batched dispatch does not beat
        per-lane solo dispatches at this table shape, the drained evals
        are processed sequentially instead — lanes would only add thread
        overhead there."""
        micro = self._micro_gateway() is not None
        if not self._kernel.batch_dispatch_profitable(
                self.server.store.node_count(),
                tolerance=(MicroBatchGateway.COST_TOLERANCE
                           if micro else 1.0)):
            self.stats["gated_drains"] += 1
            for ev, token in batch:
                self.process_eval(ev, token)
            return
        if micro:
            # bounded lane concurrency: the gateway only needs ENOUGH
            # overlap to coalesce (its occupancy grows with load via
            # the drain trigger), while every extra GIL-sharing host
            # phase inflates ALL of them — lane threads PULL from the
            # drained batch instead of one-thread-per-eval
            lanes = min(MICRO_LANES, len(batch))
            lock = make_lock()
            it = iter(batch)

            def lane_run():
                while True:
                    with lock:
                        ev_tok = next(it, None)
                    if ev_tok is None:
                        return
                    self.process_eval(ev_tok[0], ev_tok[1],
                                      lat_scale=lanes)

            threads = [threading.Thread(
                target=lane_run, daemon=True,
                name=f"worker-{self.id}-lane-{i}")
                for i in range(lanes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return
        n_workers = max(1, len(getattr(self.server, "workers", []) or []))
        gateway = BatchGateway(self._kernel, lanes=len(batch),
                               lane_base=self.id * len(batch),
                               lane_total=n_workers * len(batch))
        threads = []

        def lane_run(ev, token):
            try:
                self.process_eval(ev, token, dispatch=gateway.dispatch,
                                  lat_scale=len(batch))
            finally:
                gateway.lane_finished()

        for ev, token in batch:
            t = threading.Thread(target=lane_run, args=(ev, token),
                                 daemon=True,
                                 name=f"worker-{self.id}-lane-{ev.id[:8]}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        self.stats["batches"] += 1
        self.stats["gateway_dispatches"] += gateway.stats["dispatches"]
        self.stats["gateway_batches"] += gateway.stats["batches"]
        self.stats["gateway_lanes"] += gateway.stats["lanes_sum"]

    @staticmethod
    def _scheduler_for(ev: Evaluation) -> str:
        return ev.type if ev.type in ("service", "batch", "system") else "batch"
