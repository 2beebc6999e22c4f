"""Node heartbeat TTLs on one thread.

Reference semantics: nomad/heartbeat.go — every registered node has a
TTL timer, reset by each heartbeat; when it fires the node is marked
down (resetHeartbeatTimer:87, invalidateHeartbeat:126). The JAX package
arms one threading.Timer (one OS thread) per node. Here one thread keeps
every node's deadline in a heap, so a server that restores 10,000 nodes
arms 10,000 deadlines, not 10,000 threads (a host that commits thread
stacks spends about 1.1 MB on each, and hosts cap a process's threads).
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.locks import make_condition

LOG = logging.getLogger("nomad_tpu.server")

# rebuild the heap from the live deadlines once stale entries (deadlines a
# later reset replaced) outnumber live ones by this factor
COMPACT_RATIO = 4


class HeartbeatTimers:
    """`reset(node_id)` arms (or re-arms) a node's deadline `ttl_s` from
    now; at the deadline `on_expire(node_id)` runs on the timers' thread
    (one node after another, outside the lock). `stop()` disarms every
    node and joins the thread."""

    def __init__(self, ttl_s: float, on_expire: Callable[[str], None]):
        self.ttl_s = ttl_s
        self._on_expire = on_expire
        self._cv = make_condition()
        self._deadline: Dict[str, float] = {}
        self._heap: List[Tuple[float, str]] = []
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def reset(self, node_id: str) -> None:
        with self._cv:
            if self._stopped:
                return
            deadline = time.monotonic() + self.ttl_s
            self._deadline[node_id] = deadline
            heapq.heappush(self._heap, (deadline, node_id))
            if len(self._heap) > COMPACT_RATIO * len(self._deadline) + 64:
                self._heap = [(d, n) for n, d in self._deadline.items()]
                heapq.heapify(self._heap)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="heartbeat-timers")
                self._thread.start()
            if self._heap[0] == (deadline, node_id):
                # the thread waits for an earlier deadline, or for none
                self._cv.notify()

    def _next_due(self) -> Optional[str]:
        """Under the lock: wait until a live deadline passes and return
        its node, or None once stopped."""
        while not self._stopped:
            heap = self._heap
            # entries a later reset replaced are stale
            while heap and self._deadline.get(heap[0][1]) != heap[0][0]:
                heapq.heappop(heap)
            now = time.monotonic()
            if heap and heap[0][0] <= now:
                _deadline, node_id = heapq.heappop(heap)
                del self._deadline[node_id]
                return node_id
            self._cv.wait(heap[0][0] - now if heap else None)
        return None

    def _run(self) -> None:
        while True:
            with self._cv:
                node_id = self._next_due()
            if node_id is None:
                return
            try:
                self._on_expire(node_id)
            except Exception:
                LOG.exception("heartbeat expiry for %s", node_id[:8])

    def stop(self, timeout_s: float = 10.0) -> None:
        with self._cv:
            self._stopped = True
            self._deadline.clear()
            self._heap = []
            self._cv.notify()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)
