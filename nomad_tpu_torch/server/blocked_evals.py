"""BlockedEvals: evals that failed placement, woken when capacity frees.

Reference semantics: nomad/blocked_evals.go — Block:166 (captured by
computed class vs escaped), Unblock:418 on node updates,
UnblockClassAndQuota:470, UnblockNode:501, per-job dedup:255,
missed-unblock index check:316.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..models import Evaluation, TRIGGER_MAX_PLANS
from ..utils.locks import make_lock

UNBLOCK_CH_SIZE = 256


class _BlockedStats:
    def __init__(self):
        self.total_blocked = 0
        self.total_escaped = 0
        self.total_quota_limit = 0


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[Evaluation], None]):
        """enqueue_fn pushes an unblocked eval back into the EvalBroker."""
        self._l = make_lock()
        self._enabled = False
        self._enqueue = enqueue_fn
        # eval id -> (eval, token-ignored)
        self._captured: Dict[str, Evaluation] = {}
        self._escaped: Dict[str, Evaluation] = {}
        # job dedup: (ns, job) -> eval id
        self._job_evals: Dict[Tuple[str, str], str] = {}
        # class -> highest index at which that class was unblocked
        self._unblock_indexes: Dict[str, int] = {}
        # duplicate blocked evals to cancel (leader reaps them)
        self.duplicates: List[Evaluation] = []
        self.stats = _BlockedStats()

    def set_enabled(self, enabled: bool) -> None:
        with self._l:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._escaped.clear()
                self._job_evals.clear()
                self._unblock_indexes.clear()
                self.duplicates.clear()
                self.stats = _BlockedStats()

    # -- blocking ------------------------------------------------------
    def block(self, ev: Evaluation) -> None:
        with self._l:
            if not self._enabled:
                return
            if ev.id in self._captured or ev.id in self._escaped:
                return
            key = (ev.namespace, ev.job_id)
            existing = self._job_evals.get(key)
            if existing is not None and existing != ev.id:
                # one blocked eval per job: newer wins, older is a duplicate
                old = self._captured.pop(existing, None)
                if old is None:
                    old = self._escaped.pop(existing, None)
                    if old is not None:
                        self.stats.total_escaped -= 1
                if old is not None:
                    self.duplicates.append(old)
                    self.stats.total_blocked -= 1
            self._job_evals[key] = ev.id

            # missed-unblock check: if any eligible class was unblocked at
            # an index beyond the eval's snapshot, immediately unblock
            if self._missed_unblock(ev):
                self._enqueue(ev)
                self._job_evals.pop(key, None)
                return

            if ev.escaped_computed_class:
                self._escaped[ev.id] = ev
                self.stats.total_escaped += 1
            else:
                self._captured[ev.id] = ev
            self.stats.total_blocked += 1

    def _missed_unblock(self, ev: Evaluation) -> bool:
        for cls, index in self._unblock_indexes.items():
            if index <= ev.snapshot_index:
                continue
            elig = ev.class_eligibility.get(cls)
            if elig is None and not ev.escaped_computed_class:
                # untracked class counts as a potential miss only for
                # escaped evals; for captured ones unknown class is skipped
                continue
            if elig is not False:
                return True
        return False

    def untrack(self, namespace: str, job_id: str) -> None:
        """Job updated: blocked evals for it are stale (blocked_evals.go Untrack)."""
        with self._l:
            key = (namespace, job_id)
            eval_id = self._job_evals.pop(key, None)
            if eval_id is None:
                return
            old = self._captured.pop(eval_id, None)
            if old is None:
                old = self._escaped.pop(eval_id, None)
                if old is not None:
                    self.stats.total_escaped -= 1
            if old is not None:
                self.stats.total_blocked -= 1

    # -- unblocking ----------------------------------------------------
    def unblock(self, computed_class: str, index: int) -> None:
        """Capacity changed for a node class: requeue eligible evals."""
        with self._l:
            if not self._enabled:
                return
            self._unblock_indexes[computed_class] = index
            unblock: List[Evaluation] = []
            for eid, ev in list(self._captured.items()):
                elig = ev.class_eligibility.get(computed_class)
                if elig is not False:
                    # eligible or unknown class -> wake it
                    unblock.append(ev)
                    del self._captured[eid]
            for eid, ev in list(self._escaped.items()):
                unblock.append(ev)
                del self._escaped[eid]
                self.stats.total_escaped -= 1
            for ev in unblock:
                self._job_evals.pop((ev.namespace, ev.job_id), None)
                self.stats.total_blocked -= 1
                self._enqueue(ev)

    def unblock_all(self, index: int) -> None:
        with self._l:
            if not self._enabled:
                return
            evals = list(self._captured.values()) + list(self._escaped.values())
            self._captured.clear()
            self._escaped.clear()
            self._job_evals.clear()
            self.stats.total_blocked = 0
            self.stats.total_escaped = 0
            for ev in evals:
                self._enqueue(ev)

    def unblock_quota(self, quota: str, index: int) -> None:
        with self._l:
            if not self._enabled:
                return
            woken = []
            for store in (self._captured, self._escaped):
                for eid, ev in list(store.items()):
                    if ev.quota_limit_reached == quota:
                        woken.append(ev)
                        del store[eid]
                        if store is self._escaped:
                            self.stats.total_escaped -= 1
            for ev in woken:
                self._job_evals.pop((ev.namespace, ev.job_id), None)
                self.stats.total_blocked -= 1
                self._enqueue(ev)

    def unblock_failed(self) -> int:
        """Requeue the evals blocked because their scheduler ran out of
        plan attempts (blocked_evals.go UnblockFailed, which the leader
        runs on a timer): plan conflicts blocked them, not capacity, so
        no capacity change need ever come to wake them. The enqueue runs
        outside the lock: on a clustered leader it waits for its write's
        commit, and the FSM may need this lock to apply entries before
        that. Returns how many were requeued."""
        with self._l:
            if not self._enabled:
                return 0
            woken = []
            for store in (self._captured, self._escaped):
                for eid, ev in list(store.items()):
                    if ev.triggered_by == TRIGGER_MAX_PLANS:
                        woken.append(ev)
                        del store[eid]
                        if store is self._escaped:
                            self.stats.total_escaped -= 1
            for ev in woken:
                self._job_evals.pop((ev.namespace, ev.job_id), None)
                self.stats.total_blocked -= 1
        for ev in woken:
            self._enqueue(ev)
        return len(woken)

    def get_duplicates(self) -> List[Evaluation]:
        with self._l:
            dups = self.duplicates
            self.duplicates = []
            return dups

    def blocked_count(self) -> int:
        with self._l:
            return len(self._captured) + len(self._escaped)
