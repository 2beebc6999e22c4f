"""EvalBroker: priority queue of pending evaluations with the
at-most-one-outstanding-eval-per-job invariant.

Reference semantics: nomad/eval_broker.go — Enqueue:181, Dequeue:329,
Ack:531, Nack:595, nack re-enqueue delays:644, delayed-eval heap:751,
per-job blocked heaps, delivery limit -> failed queue.

Its timer threads carry names (eval-broker-nack, -wait, -delay), and
flush() — set_enabled(False), the server's shutdown and a revoked
leadership — joins every timer it cancels, so no broker thread outlives
a flush; the JAX package's copy leaves the cancelled timers to exit on
their own.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..models import Evaluation, JOB_TYPE_CORE
from ..utils.ids import generate_uuid
from ..utils.locks import make_condition

FAILED_QUEUE = "_failed"

DEFAULT_NACK_TIMEOUT_S = 60.0
DEFAULT_DELIVERY_LIMIT = 3
DEFAULT_INITIAL_NACK_DELAY_S = 1.0
DEFAULT_SUBSEQUENT_NACK_DELAY_S = 20.0
# admission-control deferral while the governor signals backpressure:
# shed enqueues park on the delayed heap this long before re-testing
# the pressure gauge
DEFAULT_ADMISSION_DELAY_S = 0.25
# how long flush() waits for each timer it cancelled to exit
TIMER_JOIN_S = 2.0


class AdmissionOverloadError(Exception):
    """Backpressure escalation (ROADMAP open item): raised by the HTTP
    job-register path when the broker's delayed/requeue heap itself has
    crossed its watermark — the shed valve is full, so new work must be
    refused at the edge (429 + Retry-After) instead of parked."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class _PQ:
    """Priority heap: highest priority first, FIFO by create index."""

    def __init__(self):
        self._h: List[Tuple[int, int, int, Evaluation]] = []
        self._seq = 0

    def push(self, ev: Evaluation) -> None:
        self._seq += 1
        heapq.heappush(self._h, (-ev.priority, ev.create_index, self._seq, ev))

    def pop(self) -> Evaluation:
        return heapq.heappop(self._h)[3]

    def peek(self) -> Optional[Evaluation]:
        return self._h[0][3] if self._h else None

    def __len__(self):
        return len(self._h)


class _Unack:
    __slots__ = ("eval", "token", "nack_timer")

    def __init__(self, ev, token, nack_timer):
        self.eval = ev
        self.token = token
        self.nack_timer = nack_timer


class BrokerStats:
    def __init__(self):
        self.total_ready = 0
        self.total_unacked = 0
        self.total_blocked = 0
        self.total_waiting = 0
        self.total_shed = 0     # admission-control deferrals (governor)

    def as_dict(self):
        return {"ready": self.total_ready, "unacked": self.total_unacked,
                "blocked": self.total_blocked,
                "waiting": self.total_waiting,
                "shed": self.total_shed}


class EvalBroker:
    def __init__(self, nack_timeout_s: float = DEFAULT_NACK_TIMEOUT_S,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
                 initial_nack_delay_s: float = DEFAULT_INITIAL_NACK_DELAY_S,
                 subsequent_nack_delay_s: float = DEFAULT_SUBSEQUENT_NACK_DELAY_S):
        self.nack_timeout_s = nack_timeout_s
        self.delivery_limit = delivery_limit
        self.initial_nack_delay_s = initial_nack_delay_s
        self.subsequent_nack_delay_s = subsequent_nack_delay_s

        self._l = make_condition()
        self._enabled = False
        self._ready: Dict[str, _PQ] = {}               # queue -> heap
        self._unack: Dict[str, _Unack] = {}            # eval id -> unack
        self._evals: Dict[str, int] = {}               # eval id -> dequeues
        self._job_evals: Dict[Tuple[str, str], str] = {}   # (ns,job)->eval id
        self._blocked: Dict[Tuple[str, str], _PQ] = {} # per-job pending heaps
        self._requeue: Dict[str, Evaluation] = {}      # token -> reblocked eval
        self._time_wait: Dict[str, threading.Timer] = {}
        # wait_until heaps, split by type: core evals (rare, must admit
        # on schedule even under backpressure) park separately so the
        # pressured pop cycle can leave the non-core heap untouched
        self._delayed: List[Tuple[float, int, Evaluation]] = []
        self._delayed_core_q: List[Tuple[float, int, Evaluation]] = []
        self._delay_seq = 0
        self._delay_timer: Optional[threading.Timer] = None
        self._delay_timer_at = 0.0      # absolute fire time when armed
        # governor backpressure: when this returns True, fresh enqueues
        # shed onto the admission-controlled delayed path instead of
        # the ready queue (recovering as soon as the gauge clears)
        self.pressure_fn = None
        self.admission_delay_s = DEFAULT_ADMISSION_DELAY_S
        # escalation stage: when the delayed heap ITSELF exceeds this
        # depth, register_admission() refuses new work (the HTTP path
        # turns that into 429 + Retry-After). 0 disables.
        self.delayed_depth_high = 0
        self.stats = BrokerStats()

    # -- admission escalation ------------------------------------------
    def delayed_depth(self) -> int:
        """Depth of the non-core delayed/requeue heap (the shed
        valve's backlog) — the escalation gauge."""
        return len(self._delayed)

    def check_register_admission(self) -> None:
        """Raise AdmissionOverloadError when the shed valve is full.
        Called by edge paths that CREATE new work (job register); the
        broker's own requeues/nacks are never refused — refusing those
        would lose work already admitted. Retry-After scales with how
        far past the watermark the heap is, in admission windows: the
        deeper the backlog, the longer a well-behaved client should
        stay away."""
        high = self.delayed_depth_high
        if high <= 0:
            return
        depth = len(self._delayed)
        if depth < high:
            return
        retry = max(1.0, self.admission_delay_s
                    * (4.0 * min(depth / high, 8.0)))
        raise AdmissionOverloadError(
            f"eval broker overloaded: {depth} deferred evaluations "
            f"(watermark {high}); retry after {retry:.0f}s",
            retry_after_s=retry)

    # -- lifecycle -----------------------------------------------------
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            self._enabled = enabled
        if not enabled:
            self.flush()

    def flush(self) -> None:
        with self._l:
            cancelled = [u.nack_timer for u in self._unack.values()]
            cancelled += list(self._time_wait.values())
            if self._delay_timer:
                cancelled.append(self._delay_timer)
                self._delay_timer = None
            for timer in cancelled:
                timer.cancel()
            self._ready.clear()
            self._unack.clear()
            self._evals.clear()
            self._job_evals.clear()
            self._blocked.clear()
            self._requeue.clear()
            self._time_wait.clear()
            self._delayed.clear()
            self._delayed_core_q.clear()
            self.stats = BrokerStats()
            self._l.notify_all()
        # outside the lock: a timer that already fired is running its
        # callback, which takes the lock
        me = threading.current_thread()
        for timer in cancelled:
            if timer is not me:
                timer.join(TIMER_JOIN_S)

    # -- enqueue -------------------------------------------------------
    def enqueue(self, ev: Evaluation) -> None:
        with self._l:
            self._process_enqueue(ev, "")

    def enqueue_all(self, evals: Dict[str, Tuple[Evaluation, str]]) -> None:
        """{eval_id: (eval, token)} — token set when reblocking."""
        with self._l:
            for ev, token in evals.values():
                self._process_enqueue(ev, token)

    def _process_enqueue(self, ev: Evaluation, token: str) -> None:
        if not self._enabled:
            return
        # flight-recorder anchor: FIRST broker entry, kept
        # across blocked/delayed parking and requeues — dequeue derives
        # broker_wait_s from it, so an eval that sat on the per-job
        # blocked heap or the delayed heap shows that time in its span
        # tree (queue_wait_s below stays READY-queue-only: it feeds
        # the governor's latency reservoir and must keep its meaning)
        if getattr(ev, "_entered_broker_t", None) is None:
            ev._entered_broker_t = time.monotonic()
        if ev.id in self._evals:
            if token == "":
                return
            unack = self._unack.get(ev.id)
            if unack is not None and unack.token == token:
                self._requeue[token] = ev
            return
        self._evals[ev.id] = 0

        if ev.wait_s > 0:
            self._process_waiting(ev)
            return
        if ev.wait_until > 0:
            self._delay_seq += 1
            q = (self._delayed_core_q if ev.type == JOB_TYPE_CORE
                 else self._delayed)
            heapq.heappush(q, (ev.wait_until, self._delay_seq, ev))
            self.stats.total_waiting += 1
            self._reset_delay_timer()
            return
        if self._admission_defer(ev):
            return
        self._enqueue_locked(ev, ev.type)

    def _admission_defer(self, ev: Evaluation) -> bool:
        """Backpressure shed: while the governor's pressure gauge is
        over its watermark, fresh (non-core) enqueues park on the
        delayed heap for admission_delay_s instead of joining the
        ready queue; the pop cycle re-tests the gauge, so work admits
        the moment it clears. Bounded memory (the delayed heap) traded
        for bounded queue depth and dispatch latency — the nack/requeue
        analog of the reference's plan-apply admission control.
        total_shed counts these shed DECISIONS once per eval; the pop
        cycle's re-parks don't come back through here."""
        fn = self.pressure_fn
        if fn is None or ev.type == JOB_TYPE_CORE:
            return False
        try:
            if not fn():
                return False
        except Exception:       # pragma: no cover — defensive
            return False
        self.stats.total_shed += 1
        self._delay_seq += 1
        heapq.heappush(self._delayed,
                       (time.time() + self.admission_delay_s,
                        self._delay_seq, ev))
        self.stats.total_waiting += 1
        self._reset_delay_timer()
        return True

    def _process_waiting(self, ev: Evaluation) -> None:
        timer = threading.Timer(ev.wait_s, self._enqueue_waiting, args=(ev,))
        timer.name = "eval-broker-wait"
        timer.daemon = True
        timer.start()
        self._time_wait[ev.id] = timer
        self.stats.total_waiting += 1

    def _enqueue_waiting(self, ev: Evaluation) -> None:
        with self._l:
            self._time_wait.pop(ev.id, None)
            self.stats.total_waiting -= 1
            self._enqueue_locked(ev, ev.type)

    def _arm_delay_timer(self, delay: float) -> None:
        if self._delay_timer:
            self._delay_timer.cancel()
        self._delay_timer = threading.Timer(delay, self._pop_delayed)
        self._delay_timer.name = "eval-broker-delay"
        self._delay_timer.daemon = True
        self._delay_timer_at = time.time() + delay
        self._delay_timer.start()

    def _reset_delay_timer(self) -> None:
        nxt = self._delayed[0][0] if self._delayed else None
        if self._delayed_core_q and \
                (nxt is None or self._delayed_core_q[0][0] < nxt):
            nxt = self._delayed_core_q[0][0]
        if nxt is None:
            if self._delay_timer:
                self._delay_timer.cancel()
                self._delay_timer = None
            return
        # an armed timer already fires at/before the heap head: leave
        # it — re-arming here would cancel and spawn a fresh OS timer
        # thread per shed enqueue, thread churn proportional to the
        # very overload admission control is relieving
        if self._delay_timer is not None and self._delay_timer_at <= nxt:
            return
        self._arm_delay_timer(max(0.0, nxt - time.time()))

    def _pop_delayed(self) -> None:
        with self._l:
            # we ARE the fired timer: forget it so _reset_delay_timer
            # re-arms instead of trusting a dead timer's deadline
            self._delay_timer = None
            now = time.time()
            # core evals admit on schedule regardless of pressure —
            # GC work keeps the overloaded server healthy
            while self._delayed_core_q and \
                    self._delayed_core_q[0][0] <= now:
                _, _, ev = heapq.heappop(self._delayed_core_q)
                self.stats.total_waiting -= 1
                self._enqueue_locked(ev, ev.type)
            # pressure is tested ONCE per cycle: under sustained
            # pressure due non-core evals simply stay parked — the
            # heap is untouched, so a 50k-deep parked set costs one
            # function call per admission window, not 50k heap pops +
            # pushes inside the broker lock. When the gauge clears,
            # everything due admits in one batch
            pressured = False
            fn = self.pressure_fn
            if fn is not None and self._delayed:
                try:
                    pressured = bool(fn())
                except Exception:   # pragma: no cover — defensive
                    pressured = False
            if pressured:
                delay = self.admission_delay_s
                if self._delayed_core_q:
                    delay = min(delay, max(
                        0.0, self._delayed_core_q[0][0] - now))
                self._arm_delay_timer(delay)
                return
            while self._delayed and self._delayed[0][0] <= now:
                _, _, ev = heapq.heappop(self._delayed)
                self.stats.total_waiting -= 1
                self._enqueue_locked(ev, ev.type)
            self._reset_delay_timer()

    def _enqueue_locked(self, ev: Evaluation, queue: str) -> None:
        if not self._enabled:
            return
        key = (ev.namespace, ev.job_id)
        pending = self._job_evals.get(key, "")
        if pending == "":
            self._job_evals[key] = ev.id
        elif pending != ev.id:
            blocked = self._blocked.setdefault(key, _PQ())
            blocked.push(ev)
            self.stats.total_blocked += 1
            return
        q = self._ready.setdefault(queue, _PQ())
        # queue-wait attribution: stamp READY-queue
        # entry so dequeue can report how long the eval waited — the
        # workers fold it into the sampled p99, where a backed-up
        # queue was previously invisible
        ev._brokered_t = time.monotonic()
        q.push(ev)
        self.stats.total_ready += 1
        self._l.notify_all()

    # -- dequeue -------------------------------------------------------
    def dequeue(self, schedulers: List[str],
                timeout_s: Optional[float] = None
                ) -> Tuple[Optional[Evaluation], str]:
        deadline = (time.monotonic() + timeout_s) if timeout_s is not None else None
        with self._l:
            while True:
                best_queue = None
                best = None
                for sched in schedulers:
                    q = self._ready.get(sched)
                    if q is None or len(q) == 0:
                        continue
                    head = q.peek()
                    if best is None or (-head.priority, head.create_index) < \
                            (-best.priority, best.create_index):
                        best = head
                        best_queue = sched
                if best is not None:
                    return self._dequeue_for_sched(best_queue)
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None, ""
                self._l.wait(remaining if remaining is not None else 1.0)
                if deadline is None and not self._enabled:
                    return None, ""

    def _dequeue_for_sched(self, sched: str) -> Tuple[Evaluation, str]:
        q = self._ready[sched]
        ev = q.pop()
        now = time.monotonic()
        ev.queue_wait_s = max(
            0.0, now - getattr(ev, "_brokered_t", now))
        ev.broker_wait_s = max(
            ev.queue_wait_s,
            now - (getattr(ev, "_entered_broker_t", None) or now))
        token = generate_uuid()
        timer = threading.Timer(self.nack_timeout_s, self.nack,
                                args=(ev.id, token))
        timer.name = "eval-broker-nack"
        timer.daemon = True
        timer.start()
        self._unack[ev.id] = _Unack(ev, token, timer)
        self._evals[ev.id] = self._evals.get(ev.id, 0) + 1
        self.stats.total_ready -= 1
        self.stats.total_unacked += 1
        return ev, token

    # -- ack/nack ------------------------------------------------------
    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._l:
            unack = self._unack.get(eval_id)
            return unack.token if unack else None

    def ack(self, eval_id: str, token: str) -> None:
        with self._l:
            try:
                unack = self._unack.get(eval_id)
                if unack is None:
                    raise KeyError("Evaluation ID not found")
                if unack.token != token:
                    raise ValueError("Token does not match for Evaluation ID")
                unack.nack_timer.cancel()
                self.stats.total_unacked -= 1
                del self._unack[eval_id]
                self._evals.pop(eval_id, None)
                key = (unack.eval.namespace, unack.eval.job_id)
                self._job_evals.pop(key, None)
                blocked = self._blocked.get(key)
                if blocked is not None and len(blocked):
                    ev = blocked.pop()
                    if not len(blocked):
                        del self._blocked[key]
                    self.stats.total_blocked -= 1
                    self._enqueue_locked(ev, ev.type)
                requeued = self._requeue.pop(token, None)
                if requeued is not None:
                    self._process_enqueue(requeued, "")
            finally:
                self._requeue.pop(token, None)

    def nack(self, eval_id: str, token: str,
             delay_s: Optional[float] = None) -> None:
        """Return an outstanding eval to READY. `delay_s` overrides the
        delivery-count backoff: the scheduler plane's lease sweeper
        passes 0.0 when a remote FOLLOWER died holding the
        eval — the eval did nothing wrong and should redeliver
        immediately, not serve the failed-attempt penalty."""
        with self._l:
            self._requeue.pop(token, None)
            unack = self._unack.get(eval_id)
            if unack is None or unack.token != token:
                return
            unack.nack_timer.cancel()
            del self._unack[eval_id]
            self.stats.total_unacked -= 1
            dequeues = self._evals.get(eval_id, 0)
            if dequeues >= self.delivery_limit:
                self._enqueue_locked(unack.eval, FAILED_QUEUE)
            else:
                ev = unack.eval
                ev.wait_s = (self._nack_reenqueue_delay(dequeues)
                             if delay_s is None else delay_s)
                if ev.wait_s > 0:
                    self._process_waiting(ev)
                else:
                    self._enqueue_locked(ev, ev.type)

    def _nack_reenqueue_delay(self, prev_dequeues: int) -> float:
        if prev_dequeues <= 0:
            return 0.0
        if prev_dequeues == 1:
            return self.initial_nack_delay_s
        return (prev_dequeues - 1) * self.subsequent_nack_delay_s
