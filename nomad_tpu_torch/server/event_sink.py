"""Durable event sinks: at-least-once webhook delivery of the event
stream with raft-committed progress.

Reference semantics: nomad/stream/sink.go (SinkWriter + progress),
nomad/stream/webhook_sink.go (NDJSON POST), nomad/event_sink_manager.go
(the leader runs one managed writer per registered sink; progress is
periodically committed through raft so a new leader resumes where the
old one stopped — redelivery of the tail is allowed, loss is not).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.event_sink")

SINK_WEBHOOK = "webhook"

PROGRESS_COMMIT_EVERY_S = 2.0
RETRY_BASE_S = 0.5
RETRY_MAX_S = 15.0


@dataclass
class EventSink:
    """structs.EventSink (nomad/stream/sink.go)."""
    id: str = ""
    type: str = SINK_WEBHOOK
    address: str = ""               # webhook URL
    # topic -> keys filter, same shape the broker's subscriptions use
    topics: Dict[str, List[str]] = field(default_factory=dict)
    latest_index: int = 0           # committed delivery progress
    create_index: int = 0
    modify_index: int = 0

    def stub(self) -> Dict:
        return {"ID": self.id, "Type": self.type, "Address": self.address,
                "Topics": dict(self.topics),
                "LatestIndex": self.latest_index,
                "CreateIndex": self.create_index,
                "ModifyIndex": self.modify_index}


def _post_ndjson(address: str, events: List, timeout_s: float) -> None:
    from ..utils.codec import to_wire
    body = "".join(json.dumps(to_wire(e)) + "\n"
                   for e in events).encode()
    req = urllib.request.Request(
        address, data=body, method="POST",
        headers={"Content-Type": "application/x-ndjson"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        if resp.status >= 300:
            raise RuntimeError(f"webhook returned {resp.status}")


class _SinkWorker:
    """One managed writer: broker subscription from the sink's
    committed progress, delivery with retry/backoff, periodic progress
    commits through raft."""

    def __init__(self, manager: "EventSinkManager", sink: EventSink):
        self.manager = manager
        self.sink = sink
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"event-sink-{sink.id[:8]}")
        self._delivered_index = sink.latest_index
        self._committed_index = sink.latest_index

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout_s: float) -> None:
        if self._thread.ident is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout_s)

    def _lost_marker(self, reason: str):
        """A synthetic frame telling the consumer events were
        unrecoverable — loss past the broker's replay horizon can
        happen (restart with cold buffer, consumer slower than the
        ring), but it must never happen SILENTLY."""
        from .event_broker import Event
        from ..utils import metrics
        metrics.incr_counter("nomad.event_sink.events_lost")
        LOG.warning("sink %s: events lost (%s)", self.sink.id[:8], reason)
        return Event(topic="_sink", type="EventsLost", key=self.sink.id,
                     index=self._delivered_index,
                     payload={"reason": reason})

    def _subscribe(self, server, inclusive: bool = False):
        """(sub, initial_pending) from the committed progress, with
        replay-gap detection: trimmed_through is the highest index the
        broker has PROVABLY dropped, and epoch_floor marks where this
        broker's event history begins (restarts don't republish) —
        progress at or below either means unrecoverable events, which
        must surface as an EventsLost frame, never a silent skip.
        `inclusive` replays events AT the progress index too (overflow
        recovery: a same-index batch can split, and redelivery is the
        at-least-once answer)."""
        topics = self.sink.topics or None
        from_idx = self._delivered_index - 1 if inclusive \
            else self._delivered_index
        sub, backlog = server.events.subscribe(
            topics, from_index=max(from_idx, 0), max_queued=8192)
        pending: List = []
        if self._delivered_index > 0:
            trimmed = server.events.trimmed_through
            if trimmed > self._delivered_index:
                pending.append(self._lost_marker(
                    f"ring buffer trimmed through index {trimmed}, "
                    f"progress was {self._delivered_index}"))
            elif server.events.epoch_floor > self._delivered_index:
                pending.append(self._lost_marker(
                    "progress predates this server's event history"))
        pending.extend(backlog)
        return sub, pending

    def _run(self) -> None:
        server = self.manager.server
        sub, pending = self._subscribe(server)
        try:
            last_commit = time.monotonic()
            backoff = RETRY_BASE_S
            while not self._stop.is_set():
                if sub.overflowed:
                    # slow-consumer drop: resubscribe INCLUSIVE of the
                    # delivered index — a same-index batch may have
                    # split across the drop, and redelivering already-
                    # sent events is what at-least-once permits; the
                    # ring usually still covers the gap, and
                    # _subscribe marks the loss if it doesn't
                    sub.unsubscribe()
                    sub, replay = self._subscribe(server, inclusive=True)
                    pending.extend(e for e in replay
                                   if e.index >= self._delivered_index
                                   or e.type == "EventsLost")
                if not pending:
                    fresh = sub.next_events(timeout_s=0.5)
                    pending = [e for e in fresh
                               if e.index > self._delivered_index]
                if pending:
                    try:
                        _post_ndjson(self.sink.address, pending,
                                     timeout_s=10.0)
                        self._delivered_index = max(
                            self._delivered_index,
                            max(e.index for e in pending))
                        pending = []
                        backoff = RETRY_BASE_S
                    except Exception as e:
                        LOG.warning("sink %s delivery failed: %s "
                                    "(retrying)", self.sink.id[:8], e)
                        if self._stop.wait(backoff):
                            break
                        backoff = min(backoff * 2, RETRY_MAX_S)
                        continue
                now = time.monotonic()
                if self._delivered_index > self._committed_index and \
                        now - last_commit >= PROGRESS_COMMIT_EVERY_S:
                    last_commit = now
                    if self._commit_progress():
                        self._committed_index = self._delivered_index
        finally:
            sub.unsubscribe()
            # best-effort final progress commit on clean shutdown
            if self._delivered_index > self._committed_index:
                self._commit_progress()

    def _commit_progress(self) -> bool:
        try:
            self.manager.server.raft_apply(
                "event_sink_progress",
                dict(sink_id=self.sink.id,
                     index=self._delivered_index))
            return True
        except Exception as e:
            LOG.warning("sink %s progress commit failed: %s",
                        self.sink.id[:8], e)
            return False


class EventSinkManager:
    """Leader-only lifecycle of sink workers (event_sink_manager.go):
    enabled on establishLeadership, disabled on revoke; watches the
    sink set and reconciles workers. Every watcher and writer it
    stopped is kept until join() waits for it (the server's
    shutdown)."""

    def __init__(self, server):
        self.server = server
        self._l = make_lock()
        self._enabled = False
        self._gen = 0               # retires stale watcher threads
        self._workers: Dict[str, _SinkWorker] = {}
        # wakes the current watcher out of its sleep when disabled
        self._wake = threading.Event()
        self._watchers: List[threading.Thread] = []
        self._stopped: List[_SinkWorker] = []

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            self._gen += 1
            if not enabled:
                self._wake.set()
                for w in self._workers.values():
                    w.stop()
                    self._stopped.append(w)
                self._workers.clear()
                return
            self._wake = threading.Event()
            t = threading.Thread(target=self._watch,
                                 args=(self._gen, self._wake),
                                 daemon=True, name="event-sink-mgr")
            self._watchers.append(t)
            t.start()

    def join(self, timeout_s: float) -> None:
        """Wait for every watcher and writer stopped so far (each
        writer commits its last progress on the way out)."""
        with self._l:
            watchers, self._watchers = self._watchers, []
            stopped, self._stopped = self._stopped, []
        for t in watchers:
            if t is not threading.current_thread():
                t.join(timeout_s)
        for w in stopped:
            w.join(timeout_s)

    def _watch(self, gen: int, wake: threading.Event) -> None:
        # generation guard (the drainer's pattern): a leadership flap
        # inside our sleep must retire THIS thread, or every flap
        # leaks one reconciler forever
        while True:
            with self._l:
                if not self._enabled or self._gen != gen:
                    return
            try:
                self.reconcile()
            except Exception:       # pragma: no cover - defensive
                LOG.exception("sink reconcile failed")
            wake.wait(1.0)

    def reconcile(self) -> None:
        sinks = {s.id: s for s in self.server.store.event_sinks()}
        with self._l:
            if not self._enabled:
                return
            self._stopped = [w for w in self._stopped
                             if w._thread.is_alive()]
            for sid in list(self._workers):
                w = self._workers[sid]
                cur = sinks.get(sid)
                if cur is None or cur.address != w.sink.address or \
                        cur.topics != w.sink.topics:
                    w.stop()
                    self._stopped.append(w)
                    del self._workers[sid]
            for sid, sink in sinks.items():
                if sid not in self._workers:
                    w = _SinkWorker(self, sink)
                    self._workers[sid] = w
                    w.start()
