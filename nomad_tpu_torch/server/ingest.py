"""IngestGateway: the write-side twin of the micro-batch gateway.

The read/schedule side is batched end to end (plan group commit,
micro-batch dispatch, compiled feasibility), but without this every
write walks in alone: register -> one raft entry -> one store
transaction -> one event flush, per object. This gateway coalesces the
three north-bound write kinds — job registers, client alloc-status
updates, and desired-transition writes — so that writes arriving while
a raft apply is in flight PARK and land together as ONE `ingest_batch`
raft entry, ONE store transaction (`upsert_jobs_batch` /
`update_allocs_from_client_batch`), and ONE event flush, with
per-request futures demultiplexed back to each submitter exactly like
the plan applier's group commit.

Trigger discipline mirrors the MicroBatchGateway (worker.py):

  - drain:     entries that parked while the previous batch's raft
               apply was in flight fire immediately on its completion —
               the in-flight apply WAS the batching window (the same
               self-clocking the plan applier gets from its queue);
  - occupancy: the window fills to `ingest_batch_max` -> fire early;
  - immediate: nothing else is streaming in -> a lone write never
               waits (idle-path latency unchanged from no gateway);
  - deadline:  while a burst is streaming, the oldest waiter bounds
               the wait at the (scaled) window.

`shrink_window` halves the window (a deep ingest queue means the
committer is saturated and window-waiting only adds latency; drain
already self-clocks batch formation) and a clean streak
(GROUP_RECOVER_CLEAN batches under the watermark) re-widens it.
`check_admission` sheds with AdmissionOverloadError (429 / Retry-After
at an HTTP edge) BEFORE body decode when queue depth or queued bytes
cross the watermark.

`ServerConfig(ingest_window_us=-1)` keeps the gateway from being
constructed at all — every write takes the one-entry-per-object path.
Single-entry batches also take the singleton raft entries, so an idle
server's WAL is bit-identical with the gateway on or off. The JAX
package's copy also reads the NOMAD_TPU_INGEST_BATCH switch; this one
does not.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

from .eval_broker import AdmissionOverloadError
from .plan_applier import GROUP_RECOVER_CLEAN, fail_futures
from ..utils import metrics
from ..utils.locks import make_condition, make_lock

# the three write kinds that may coalesce; each value is the singleton
# raft msg_type the entry demotes to when it commits alone
INGEST_KINDS = ("job_register", "alloc_client_update",
                "alloc_desired_transition")

# window scale floor under shrink_window: 1/8th of the configured
# window — below that the deadline trigger is indistinguishable from
# immediate and shrinking further just burns reclaim rounds
SCALE_MIN = 0.125

class _Entry:
    __slots__ = ("kind", "payload", "future", "arrival_t", "nbytes")

    def __init__(self, kind: str, payload: dict, nbytes: int):
        self.kind = kind
        self.payload = payload
        self.future: Future = Future()
        self.arrival_t = time.monotonic()
        self.nbytes = nbytes


class IngestGateway:
    # commit-latency reservoir bound: enough for a p99 over a burst
    # without unbounded growth
    LAT_WINDOW = 4096

    def __init__(self, server, batch_max: int = 64,
                 window_us: float = 200.0, queue_high: int = 256):
        self.server = server          # provides .raft_apply()
        self.batch_max = max(1, int(batch_max))
        self.base_window_s = max(float(window_us), 0.0) / 1e6
        self.queue_high = max(1, int(queue_high))
        # queued-bytes watermark derived from depth: watermark depth x
        # a conservative 64 KiB mean body keeps a few huge bulk bodies
        # from hiding behind a shallow queue
        self.queue_bytes_high = self.queue_high * 64 * 1024
        self._cv = make_condition()
        self._pending: List[_Entry] = []
        self._pending_bytes = 0
        self._stopped = False
        # entries present at loop-top right after a batch landed parked
        # during its raft apply -> drain trigger
        self._drain_ready = False
        # window reclaim state (the shrink/recover idiom, inverted:
        # pressure SHRINKS the window, clean batches re-widen it)
        self._scale = 1.0
        self._clean_batches = 0
        self._lat_l = make_lock()
        self._lat: deque = deque(maxlen=self.LAT_WINDOW)   # seconds/write
        # counters are += read-modify-writes from the gateway thread
        # (_note_batch), request threads (submit_async, under _cv), and
        # the shed path (check_admission, which deliberately avoids
        # _cv) — no shared lock between them, so they get their own
        self._stats_l = make_lock()
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "entries_sum": 0,
            "coalesced_writes": 0, "shed": 0,
            "immediate_dispatches": 0, "occupancy_dispatches": 0,
            "drain_dispatches": 0, "deadline_dispatches": 0,
            "wait_s_sum": 0.0,
        }
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ingest-gateway")
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
        with self._cv:
            leftovers, self._pending = self._pending, []
            self._pending_bytes = 0
        fail_futures([(e.future, None) for e in leftovers],
                     RuntimeError("ingest gateway stopped"))

    # -- gauges and the window's reclaim hook --------------------------
    def queue_depth(self) -> int:
        return len(self._pending)

    def queue_bytes(self) -> int:
        return self._pending_bytes

    def window_us(self) -> float:
        return self.base_window_s * self._scale * 1e6

    def mean_batch_size(self) -> float:
        b = self.stats["batches"]
        return self.stats["entries_sum"] / b if b else 0.0

    def write_p99_ms(self) -> float:
        with self._lat_l:
            if not self._lat:
                return 0.0
            xs = sorted(self._lat)
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1000.0

    def shrink_window(self) -> dict:
        """Reclaim hook for a queue-depth watermark: a deep
        queue means the committer is the bottleneck and window-waiting
        only adds latency (the drain trigger already self-clocks batch
        formation) — halve the window. Recovery is automatic
        (_note_batch re-widens after a clean streak)."""
        was = self._scale
        self._scale = max(SCALE_MIN, self._scale / 2.0)
        self._clean_batches = 0
        return {"ingest_window_us": round(self.window_us(), 1),
                "was_us": round(self.base_window_s * was * 1e6, 1)}

    def _note_batch(self, size: int, wait_s: float, trigger: str) -> None:
        with self._stats_l:
            self.stats["batches"] += 1
            self.stats["entries_sum"] += size
            self.stats[f"{trigger}_dispatches"] += 1
            self.stats["wait_s_sum"] += wait_s
            if size > 1:
                # every request beyond the first shared a raft entry
                # with a neighbor — the headline coalescing gauge
                self.stats["coalesced_writes"] += size - 1
        # counter totals a rate reader turns into writes/s
        metrics.incr_counter("nomad.ingest.writes", size)
        metrics.incr_counter("nomad.ingest.batches")
        if len(self._pending) * 4 < self.queue_high:
            self._clean_batches += 1
            if self._scale < 1.0 and \
                    self._clean_batches >= GROUP_RECOVER_CLEAN:
                self._clean_batches = 0
                self._scale = min(1.0, self._scale * 2.0)
        else:
            self._clean_batches = 0

    # -- admission (runs BEFORE body decode) ---------------------------
    def check_admission(self, bytes_hint: int = 0) -> None:
        """Shed valve for the real ingest backlog: refuse new writes at
        the edge (429 + Retry-After) when the queue has crossed its
        depth or byte watermark. Called with the Content-Length hint
        BEFORE the body is decoded, so an overloaded server never pays
        msgpack/model materialization for work it is about to refuse."""
        depth = len(self._pending)
        qbytes = self._pending_bytes + max(0, int(bytes_hint))
        over_depth = depth >= self.queue_high
        over_bytes = qbytes > self.queue_bytes_high
        if not over_depth and not over_bytes:
            return
        with self._stats_l:
            self.stats["shed"] += 1
        metrics.incr_counter("nomad.ingest.shed")
        # back-off scales with overshoot (capped 8x, floor 1s) — the
        # broker valve's Retry-After discipline
        ratio = max(depth / self.queue_high, qbytes / self.queue_bytes_high)
        retry = max(1.0, min(ratio, 8.0))
        what = (f"{depth} queued writes (watermark {self.queue_high})"
                if over_depth else
                f"{qbytes} queued bytes (watermark {self.queue_bytes_high})")
        raise AdmissionOverloadError(
            f"ingest gateway overloaded: {what}; "
            f"retry after {retry:.0f}s", retry_after_s=retry)

    # -- submission -----------------------------------------------------
    def submit_async(self, kind: str, payload: dict,
                     nbytes: int = 0) -> Future:
        """Park one write for the next batch. The future resolves to
        the raft index its batch (or singleton entry) committed at."""
        if kind not in INGEST_KINDS:
            raise ValueError(f"unknown ingest kind {kind!r}")
        entry = _Entry(kind, payload, nbytes)
        with self._cv:
            if self._stopped:
                raise RuntimeError("ingest gateway stopped")
            started = self._thread is not None
            if started:
                self._pending.append(entry)
                self._pending_bytes += entry.nbytes
            with self._stats_l:
                self.stats["requests"] += 1
            if started:
                self._cv.notify_all()
        if not started:
            # gateway thread not running (library/test servers that
            # never call Server.start()): the caller thread commits its
            # own singleton — the same per-kind raft entry the loop's
            # immediate trigger emits, so nothing parks forever
            self._commit([entry], 0.0, "immediate")
        return entry.future

    def submit(self, kind: str, payload: dict, nbytes: int = 0) -> int:
        return self.submit_async(kind, payload, nbytes).result()

    # -- the gateway loop ----------------------------------------------
    def _streaming(self) -> bool:
        """More than one waiter, or one that just arrived while another
        batch was landing — a burst worth a window wait."""
        return len(self._pending) > 1

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._drain_ready = False
                    self._cv.wait(0.2)
                if self._stopped:
                    return
                trigger = None
                if len(self._pending) >= self.batch_max:
                    trigger = "occupancy"
                elif self._drain_ready:
                    # these parked while the previous apply was in
                    # flight: the apply WAS their window
                    trigger = "drain"
                elif not self._streaming():
                    trigger = "immediate"
                else:
                    # burst streaming in: bound the wait by the oldest
                    # waiter + the scaled window
                    window = self.base_window_s * self._scale
                    while True:
                        if len(self._pending) >= self.batch_max:
                            trigger = "occupancy"
                            break
                        oldest = self._pending[0].arrival_t
                        remaining = oldest + window - time.monotonic()
                        if remaining <= 0:
                            trigger = "deadline"
                            break
                        self._cv.wait(remaining)
                        if self._stopped:
                            return
                batch = self._pending[:self.batch_max]
                del self._pending[:len(batch)]
                self._pending_bytes -= sum(e.nbytes for e in batch)
                now = time.monotonic()
                wait_s = sum(now - e.arrival_t for e in batch)
            self._commit(batch, wait_s, trigger)
            with self._cv:
                # anything queued right now parked during the apply
                self._drain_ready = bool(self._pending)

    def _commit(self, batch: List[_Entry], wait_s: float,
                trigger: str) -> None:
        try:
            if len(batch) == 1:
                # singleton fast path: the unchanged per-kind raft
                # entry, so an idle server's WAL is bit-identical with
                # the gateway off (the singleton-fallback idiom)
                e = batch[0]
                index = self.server.raft_apply(e.kind, e.payload)
            else:
                entries = [dict(e.payload, kind=e.kind) for e in batch]
                index = self.server.raft_apply(
                    "ingest_batch", {"entries": entries})
        except Exception as exc:
            fail_futures([(e.future, None) for e in batch], exc)
            return
        finally:
            self._note_batch(len(batch), wait_s, trigger)
        # full write latency as each submitter saw it: park + window +
        # apply — the `ingest.write_p99_ms` source
        t1 = time.monotonic()
        with self._lat_l:
            for e in batch:
                self._lat.append(t1 - e.arrival_t)
        # demultiplex: every submitter gets the group's commit index,
        # in submission order (the plan applier's committer idiom)
        for e in batch:
            if not e.future.done():
                e.future.set_result(index)
