"""Multi-server consensus: leader election + log replication + snapshot
install over the wire RPC layer.

Reference shape: nomad/server.go setupRaft:1214 (hashicorp/raft),
nomad/leader.go monitorLeadership:54 (establish/revoke hooks),
nomad/fsm.go Snapshot/Restore:1360-1374, rpc.go forward() (writes go to
the leader). SURVEY §7.2 step 7 blesses a "single-leader Raft-lite":

  - terms + randomized election timeouts + majority votes with the
    log-up-to-date check (Raft §5.2/§5.4.1); vote RPCs are issued in
    parallel (hashicorp/raft electSelf) so unreachable peers cannot
    stretch one election round past the election timeout
  - **apply-at-commit**: the leader appends entries to its log but the
    FSM applies them only once the commit index covers them — leader
    and follower share one applier loop (_fsm_loop), so neither role
    can ever serve reads or publish change events for a write that a
    majority does not hold (hashicorp/raft processLogs runs the FSM
    only up to commitIndex)
  - **commit means commit**: the leader acks a write only once a
    majority of the cluster holds the entry (match-index quorum over
    per-peer replication threads, Raft §5.3/§5.4) AND the local FSM has
    applied it, with the current-term commit rule (§5.4.2, figure 8)
    enforced via a no-op entry appended on election (the hashicorp/raft
    noop). A leader that cannot reach a majority times out the ack
    instead of claiming durability
  - replication runs in one dedicated thread per peer (hashicorp/raft
    replication.go shape) so a dead peer or an in-flight snapshot
    install can never starve heartbeats to healthy followers
  - because only committed entries reach the FSM, a follower's
    conflicting uncommitted suffix truncates freely (Raft §5.3); a
    full snapshot reseed (store.dump()/restore()) is needed only when
    the leader's log has been compacted past what the follower needs
  - membership is static configuration (no serf/autopilot)

Write forwarding: a non-leader server forwards (msg_type, payload)
through Raft.Forward; the client-facing RPC layer additionally forwards
whole write RPCs to the leader (rpc.go forward()).

Chaos hooks (chaos/faults.py): `raft.election` within CHAOS_HOLD_S of an
election deadline (a truthy verdict resets the deadline instead of
campaigning, early enough that a healed victim hears the leader before
its deadline)
and `raft.replicate` before each AppendEntries round trip (a truthy
verdict drops it on the leader's side; an armed wire latency sleeps
inside the interposer).
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from .persistence import decode_payload, encode_payload
from ..chaos import faults as chaos_faults
from ..rpc.codec import RpcRefused
from ..utils.locks import make_condition, make_lock, make_rlock

LOG = logging.getLogger("nomad_tpu.raft")

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

HEARTBEAT_S = 0.1
ELECTION_MIN_S = 0.5
ELECTION_MAX_S = 1.0
# how long before its election deadline a follower asks the raft.election
# chaos hook: more than a heartbeat interval and a tick
CHAOS_HOLD_S = 2 * HEARTBEAT_S
MAX_BATCH = 256


class RaftNode:
    def __init__(self, server, self_addr: str, peers: List[str],
                 data_dir: str = "", multiplier: float = 1.0):
        self.server = server
        # scales the election timeout (Nomad's raft_multiplier)
        self.multiplier = max(float(multiplier), 1.0)
        self.self_addr = self_addr
        self.peers = [p for p in peers if p != self_addr]
        self.cluster_size = len(self.peers) + 1
        self.data_dir = data_dir

        self._lock = make_rlock()
        self.role = FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader_addr: Optional[str] = None
        # entries AFTER the compaction base: (index, term, type, enc)
        self.log: List[Tuple[int, int, str, dict]] = []
        self.base_index = server._raft_index
        self.base_term = 0
        self.needs_snapshot = False
        self.removed = False        # kicked from membership -> inert
        # a snapshot install in progress: the leader's heartbeats to
        # this node wait behind it, so the election timer must too
        self._installing = False

        self._last_heartbeat = time.monotonic()
        self._election_deadline = self._new_deadline()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # per-peer replication state (leader)
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        self._clients: Dict[str, object] = {}
        # quorum commit tracking: an entry is committed once a majority
        # of match indexes cover it and it belongs to the current term
        self.commit_index = self.base_index
        self._commit_cv = make_condition(self._lock)
        self._repl_gen = 0            # invalidates stale repl threads
        self._repl_events: Dict[str, threading.Event] = {}
        self._snap_gen = 0            # invalidates an in-flight FSM batch
        # last successful replication round trip per peer (leader):
        # the autopilot's liveness signal (nomad/autopilot.go reads
        # serf health; here replication contact plays that role)
        self.last_contact: Dict[str, float] = {}
        # leader-side replication counters (under the lock):
        # AppendEntries round trips, entries they carried, snapshots
        # sent
        self.stats: Dict[str, int] = {"append_entries": 0,
                                      "entries_sent": 0,
                                      "snapshots_sent": 0}
        self._load_vote_state()

    # -- persistence of (term, votedFor) — Raft §5.1 -------------------
    def _vote_path(self) -> str:
        return os.path.join(self.data_dir, "raft_vote.json") \
            if self.data_dir else ""

    def _load_vote_state(self) -> None:
        path = self._vote_path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                d = json.load(f)
            self.term = int(d.get("term", 0))
            self.voted_for = d.get("voted_for")
        except (OSError, json.JSONDecodeError):
            pass

    def _save_vote_state(self) -> None:
        path = self._vote_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for}, f)
        os.replace(tmp, path)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        t = threading.Thread(target=self._ticker, daemon=True,
                             name="raft-ticker")
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._fsm_loop, daemon=True,
                             name="raft-fsm")
        t.start()
        self._threads.append(t)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the node and join its ticker and FSM applier, so no
        committed entry reaches the store or the WAL once this returns
        (the per-peer replication pumps and vote threads are not kept:
        they exit on the stop flag or their generation)."""
        self._stop.set()
        with self._lock:
            self._repl_gen += 1
            for ev in self._repl_events.values():
                ev.set()
            self._commit_cv.notify_all()
        for c in list(self._clients.values()):
            try:
                c.close()
            except Exception:
                pass
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout_s)

    # -- helpers -------------------------------------------------------
    def _new_deadline(self) -> float:
        return time.monotonic() + self.multiplier * random.uniform(
            ELECTION_MIN_S, ELECTION_MAX_S)

    def is_leader(self) -> bool:
        return self.role == LEADER

    def last_log(self) -> Tuple[int, int]:
        with self._lock:
            if self.log:
                e = self.log[-1]
                return e[0], e[1]
            return self.base_index, self.base_term

    def _client(self, addr: str):
        from ..rpc.client import RpcClient
        c = self._clients.get(addr)
        if c is None:
            c = RpcClient(addr, dial_timeout_s=1.0)
            self._clients[addr] = c
        return c

    # -- the leader append hook (called from Server.raft_apply) --------
    def append_entry(self, msg_type: str, payload: dict) -> Tuple[int, int]:
        """Append a leader log entry; assigns the next log index and
        returns (index, term). The FSM does NOT run here — _fsm_loop
        applies the entry once it commits. Raises if this node is no
        longer the leader — a deposed leader must NOT append (the entry
        would carry the new term, so a follower would treat the real
        leader's entry at that index as already present and silently
        diverge). The payload is encoded before the lock is taken: a
        plan of thousands of allocs takes a second to encode, and the
        replication pumps need the lock to send their heartbeats."""
        enc = encode_payload(msg_type, payload)
        with self._lock:
            if self.role != LEADER:
                raise RuntimeError("not the leader")
            last, _ = (self.log[-1][0], self.log[-1][1]) if self.log \
                else (self.base_index, self.base_term)
            index = last + 1
            term = self.term
            self.log.append((index, term, msg_type, enc))
            if not self.peers:
                self._advance_commit()
            for ev in self._repl_events.values():
                ev.set()
            return index, term

    # -- quorum commit -------------------------------------------------
    def _advance_commit(self) -> None:
        """Advance the commit index to the highest entry a majority
        holds, restricted to current-term entries (Raft §5.4.2). Called
        with self._lock held."""
        if self.role != LEADER:
            return
        last, _ = (self.log[-1][0], self.log[-1][1]) if self.log \
            else (self.base_index, self.base_term)
        matches = sorted(
            [self._match_index.get(p, 0) for p in self.peers] + [last],
            reverse=True)
        n = matches[self.cluster_size // 2]
        if n <= self.commit_index:
            return
        if n > self.base_index:
            pos = n - self.base_index - 1
            if pos < len(self.log) and self.log[pos][1] != self.term:
                return          # figure-8 guard: never count replicas
                                # to commit a prior-term entry
        self.commit_index = n
        self._commit_cv.notify_all()

    # -- committed-entry FSM applier (leader and follower) -------------
    def _fsm_loop(self) -> None:
        """Single applier: runs the FSM over entries in log order as the
        commit index advances — hashicorp/raft runFSM/processLogs. The
        apply itself runs with the raft lock RELEASED (the FSM has its
        own serialization and may re-enter append_entry for side-effect
        writes); a snapshot install invalidates the in-flight batch via
        _snap_gen."""
        while not self._stop.is_set():
            with self._commit_cv:
                while (not self._stop.is_set()
                       and self.commit_index <= self.server._raft_index):
                    self._commit_cv.wait(0.5)
                if self._stop.is_set():
                    return
                gen = self._snap_gen
                applied = max(self.server._raft_index, self.base_index)
                start = applied - self.base_index
                stop = min(self.commit_index - self.base_index,
                           len(self.log))
                batch = list(self.log[start:stop])
            if not batch:
                # committed entries we don't hold yet (post-reseed gap);
                # replication refills the log shortly
                time.sleep(HEARTBEAT_S / 4)
                continue
            for idx, _eterm, mtype, enc in batch:
                with self._lock:
                    if self._snap_gen != gen:
                        break
                try:
                    self.server.apply_replicated(idx, mtype, enc)
                except Exception:
                    # an applier error must not kill the ONLY applier
                    # thread (that would wedge the node forever while
                    # the commit index keeps advancing). The entry is
                    # counted applied — the reference FSM logs apply
                    # errors and moves on too (a deterministic error
                    # fails identically on every replica)
                    LOG.exception("FSM apply of entry %d (%s) failed",
                                  idx, mtype)
                    with self.server._raft_l:
                        if self.server._raft_index < idx:
                            self.server._raft_index = idx
            # group-fsync barrier: the committed batch is the
            # WAL's commit unit — one fsync covers every entry recorded
            # above instead of one per frame (wal_group_fsync)
            if self.server.persistence is not None:
                try:
                    self.server.persistence.commit_barrier()
                except OSError:     # pragma: no cover — best effort
                    LOG.exception("WAL group fsync failed")
            with self._commit_cv:
                self._commit_cv.notify_all()   # wake wait_for_applied

    def wait_for_applied(self, index: int, term: Optional[int] = None,
                         timeout_s: Optional[float] = 10.0) -> None:
        """Block until `index` is replicated to a majority AND applied
        by the local FSM. Raises if leadership is lost or the term moves
        before the entry commits (a stepdown + truncation in between
        means the entry may no longer exist), or on quorum timeout. The
        caller must not treat the write as durable on any raise. Once
        the entry is committed in the term it was stamped with, it is
        durable — the remaining wait is only for the local applier to
        catch up, and survives role changes. `timeout_s=None` waits
        while this node leads in that term, however long the commit
        takes: an entry whose wait timed out is still in the log and may
        yet commit, so its outcome is unknown, not failed (the plan
        applier waits so, as hashicorp/raft's Apply future does)."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._commit_cv:
            while self.commit_index < index:
                if self._stop.is_set():
                    raise RpcRefused("raft node stopped")
                if self.role != LEADER:
                    # stepdown mid-wait: a protocol outcome — the
                    # caller must treat the write as not durable and
                    # retry through the new leader; RpcRefused keeps
                    # forwarded writes traceback-free in the dispatcher
                    raise RpcRefused(
                        f"leadership lost before commit of {index}")
                if term is not None and self.term != term:
                    raise RpcRefused(
                        f"term moved ({term} -> {self.term}) before "
                        f"commit of {index}")
                remaining = (0.5 if deadline is None
                             else deadline - time.monotonic())
                if remaining <= 0:
                    raise RuntimeError(
                        f"no quorum: commit of {index} timed out "
                        f"after {timeout_s}s")
                self._commit_cv.wait(remaining)
            # committed: verify it is still OUR entry (the log cannot
            # have been truncated below the commit index, but a
            # stepdown + reseed may have replaced and compacted it —
            # base_index == index with a different base_term means the
            # NEW leader's entry took our index)
            if term is not None:
                if index <= self.base_index:
                    if self.role == LEADER and self.term == term:
                        pass    # a leader never loses its own entry
                                # while it stays leader in that term
                    elif index == self.base_index and \
                            self.base_term == term:
                        pass
                    else:
                        raise RuntimeError(
                            f"entry {index} compacted/superseded; "
                            f"cannot verify term {term}")
                elif self._term_of(index) != term:
                    raise RuntimeError(
                        f"entry {index} superseded (term {term} -> "
                        f"{self._term_of(index)})")
            while self.server._raft_index < index:
                if self._stop.is_set():
                    raise RpcRefused("raft node stopped")
                remaining = (0.5 if deadline is None
                             else deadline - time.monotonic())
                if remaining <= 0:
                    raise RuntimeError(
                        f"apply of committed entry {index} timed out")
                self._commit_cv.wait(remaining)

    # -- follower write forwarding ------------------------------------
    def forward_apply(self, msg_type: str, payload: dict,
                      timeout_s: float = 15.0) -> int:
        leader = self.leader_addr
        if not leader:
            raise RpcRefused("no cluster leader")
        res = self._client(leader).call(
            "Raft.Forward",
            {"msg_type": msg_type,
             "payload": encode_payload(msg_type, payload)},
            timeout_s=timeout_s)
        return int(res["index"])

    def forward_rpc(self, method: str, args: dict, timeout_s: float = 30.0):
        leader = self.leader_addr
        if not leader:
            raise RpcRefused("no cluster leader")
        return self._client(leader).call(method, args, timeout_s=timeout_s)

    # -- role transitions ----------------------------------------------
    def _become_follower(self, term: int, leader: Optional[str]) -> None:
        was_leader = self.role == LEADER
        self.role = FOLLOWER
        self._repl_gen += 1            # retire replication threads
        self._repl_events.clear()
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._save_vote_state()
        if leader:
            self.leader_addr = leader
        self._election_deadline = self._new_deadline()
        self._commit_cv.notify_all()   # fail pending acks fast
        if was_leader:
            LOG.warning("stepping down (term %d)", self.term)
            self.server.revoke_leadership()

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_addr = self.self_addr
        last, _ = self.last_log()
        self._next_index = {p: last + 1 for p in self.peers}
        self._match_index = {p: 0 for p in self.peers}
        # autopilot's contact clock starts at election for EVERY peer:
        # a server that died before this term would otherwise default
        # to age 0 forever and never be reaped
        now = time.monotonic()
        for p in self.peers:
            self.last_contact.setdefault(p, now)
        self._repl_gen += 1
        gen = self._repl_gen
        self._repl_events = {}
        for peer in self.peers:
            ev = threading.Event()
            ev.set()
            self._repl_events[peer] = ev
            # not retained: retired generations exit via the gen check,
            # and retaining them would grow without bound under flapping
            threading.Thread(target=self._repl_loop,
                             args=(peer, gen, ev), daemon=True,
                             name=f"raft-repl-{peer}").start()
        LOG.warning("elected leader (term %d)", self.term)
        if self.peers:
            # current-term no-op so prior-term entries become
            # committable (§5.4.2; hashicorp/raft appends LogNoop), and
            # leadership is established only once it is applied
            threading.Thread(target=self._establish_after_barrier,
                             args=(self.term,), daemon=True,
                             name="raft-noop").start()
        else:
            self.server.establish_leadership()

    def _establish_after_barrier(self, term: int) -> None:
        """The raft Barrier before establishLeadership (nomad/leader.go
        leaderLoop): every entry of an earlier term that this leader's
        log holds commits with the current term's no-op and is applied
        before the broker restores evals from the store. Without it a
        plan the old leader replicated but had not applied could land
        after the new leader's scheduler read the store without it, and
        the job would be placed twice."""
        try:
            self.server.raft_apply("noop", {})
        except Exception as e:      # stepped down again before commit
            LOG.debug("noop append failed: %s", e)
            return
        with self._lock:
            if self.role == LEADER and self.term == term \
                    and not self._stop.is_set():
                self.server.establish_leadership()

    # -- ticker: election timeouts (replication is per-peer threads) ---
    def _ticker(self) -> None:
        while not self._stop.is_set():
            time.sleep(HEARTBEAT_S / 2)
            with self._lock:
                role = self.role
                if self.removed:
                    continue        # inert: never campaign
                if self._installing:
                    # the leader is busy sending us its state: its
                    # silence is not a failure (hashicorp/raft's
                    # follower loop is blocked on the same RPC)
                    self._election_deadline = self._new_deadline()
                    continue
            if role != LEADER and chaos_faults.ACTIVE and \
                    time.monotonic() > self._election_deadline - CHAOS_HOLD_S \
                    and chaos_faults.fire("raft.election",
                                          addr=self.self_addr):
                # chaos hook (the follower_fence cell): a
                # replication-lagged victim must STAY a lagging
                # follower — without this its missed heartbeats
                # would trigger a campaign, bump the term, and
                # depose the very leader the cell is measuring. Asked
                # CHAOS_HOLD_S before the deadline, so that once the lag
                # heals the leader's first heartbeat lands before it
                self._election_deadline = self._new_deadline()
                continue
            if role != LEADER and \
                    time.monotonic() > self._election_deadline:
                self._run_election()

    def _run_election(self) -> None:
        """One election round with PARALLEL vote RPCs (hashicorp/raft
        electSelf): unreachable peers cost nothing extra — the round
        lasts at most one vote-RPC timeout, not one per dead peer."""
        with self._lock:
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.self_addr
            self._save_vote_state()
            term = self.term
            self._election_deadline = self._new_deadline()
        last_index, last_term = self.last_log()
        tally_l = make_lock()
        votes = [1]                       # self-vote
        higher_term = [0]
        outcome = threading.Event()       # majority reached or must step down

        def ask(peer: str) -> None:
            try:
                res = self._client(peer).call(
                    "Raft.RequestVote",
                    {"term": term, "candidate": self.self_addr,
                     "last_log_index": last_index,
                     "last_log_term": last_term},
                    timeout_s=0.5)
            except Exception:
                return
            with tally_l:
                if res["term"] > term:
                    higher_term[0] = max(higher_term[0], res["term"])
                    outcome.set()
                    return
                if res.get("granted"):
                    votes[0] += 1
                    if votes[0] * 2 > self.cluster_size:
                        outcome.set()

        for peer in self.peers:
            threading.Thread(target=ask, args=(peer,), daemon=True,
                             name=f"raft-vote-{peer}").start()
        outcome.wait(0.6)
        with self._lock:
            with tally_l:
                bumped, got = higher_term[0], votes[0]
            if bumped > self.term:
                self._become_follower(bumped, None)
                return
            if self.role == CANDIDATE and self.term == term and \
                    got * 2 > self.cluster_size:
                self._become_leader()

    # -- leader replication: one thread per peer ----------------------
    def _repl_loop(self, peer: str, gen: int,
                   wake: threading.Event) -> None:
        """Dedicated replication pump for one peer (hashicorp/raft
        replication.go). Wakes on new entries or every heartbeat
        interval; keeps draining while the peer is behind. A stuck or
        snapshotting peer only ever blocks its own thread."""
        while not self._stop.is_set():
            with self._lock:
                if self.role != LEADER or self._repl_gen != gen \
                        or self._repl_events.get(peer) is not wake:
                    return          # retired or membership removed us
            wake.wait(HEARTBEAT_S)
            wake.clear()
            try:
                while self._replicate_peer(peer):
                    pass
            except Exception as e:
                LOG.debug("replicate to %s failed: %s", peer, e)
                time.sleep(HEARTBEAT_S / 2)     # redial backoff

    def _replicate_peer(self, peer: str) -> bool:
        """One AppendEntries (or snapshot) round trip. Returns True if
        the peer still has a backlog and the caller should continue."""
        if chaos_faults.ACTIVE and chaos_faults.fire("raft.replicate",
                                                     target=peer):
            # chaos hook: an armed replication-lag fault drops this
            # round trip on the LEADER side — the victim's log (and
            # store) falls behind while its process stays healthy,
            # which is exactly the state the follower snapshot fence
            # exists to handle. Interposing the victim's AppendEntries
            # handler instead would either hot-loop the pump (rejection
            # => immediate resend) or corrupt the leader's match-index
            # accounting (fake success)
            return False
        with self._lock:
            if self.role != LEADER:
                return False
            term = self.term
            next_idx = self._next_index.get(peer, self.base_index + 1)
            if next_idx <= self.base_index:
                self._send_snapshot(peer, term)
                return False
            offset = next_idx - self.base_index - 1
            entries = self.log[offset:offset + MAX_BATCH]
            if offset > len(self.log):
                entries = []
            if offset == 0:
                prev_index, prev_term = self.base_index, self.base_term
            elif offset - 1 < len(self.log):
                e = self.log[offset - 1]
                prev_index, prev_term = e[0], e[1]
            else:
                last = self.log[-1] if self.log else None
                prev_index = last[0] if last else self.base_index
                prev_term = last[1] if last else self.base_term
            commit = min(self.commit_index,
                         self.log[-1][0] if self.log else self.base_index)
        res = self._client(peer).call(
            "Raft.AppendEntries",
            {"term": term, "leader": self.self_addr,
             "prev_index": prev_index, "prev_term": prev_term,
             "entries": [[e[0], e[1], e[2], e[3]] for e in entries],
             "leader_commit": commit},
            timeout_s=5.0)
        with self._lock:
            self.stats["append_entries"] += 1
            self.stats["entries_sent"] += len(entries)
            if res["term"] > self.term:
                self._become_follower(res["term"], None)
                return False
            if self.role != LEADER or self.term != term:
                return False
            if res.get("needs_snapshot"):
                self._send_snapshot(peer, term)
                return False
            if res.get("success"):
                self.last_contact[peer] = time.monotonic()
                matched = entries[-1][0] if entries else prev_index
                if matched > self._match_index.get(peer, 0):
                    self._match_index[peer] = matched
                    self._advance_commit()
                if entries:
                    self._next_index[peer] = matched + 1
                last = self.log[-1][0] if self.log else self.base_index
                return self._next_index.get(peer, last + 1) <= last
            self._next_index[peer] = max(
                self.base_index + 1,
                min(self._next_index.get(peer, 1) - 1,
                    int(res.get("hint", 0)) + 1))
            return True

    def _term_of(self, index: int) -> int:
        """Term of a log entry by index (lock held); base_term for the
        compaction base or anything at/below it."""
        pos = index - self.base_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos][1]
        return self.base_term

    def _send_snapshot(self, peer: str, term: int) -> None:
        """Full-state reseed of a lagging peer. The serialization + long
        transfer run with the raft lock RELEASED — only this peer's
        replication thread blocks on it. The snapshot's base index is
        the APPLIED index captured atomically with an O(1) MVCC store
        snapshot under the server's apply lock, so the label can never
        run ahead of the state it describes — a too-high base would
        make followers skip committed entries forever. (With
        apply-at-commit the applied index never exceeds the commit
        index, so the label also never covers an uncommitted entry.)"""
        self._lock.release()
        try:
            with self.server._raft_l:
                snap = self.server.store.snapshot()
                snap_index = self.server._raft_index
            with self._lock:
                if self.role != LEADER or self.term != term:
                    return
                snap_term = self._term_of(snap_index)
            data = snap.dump()
            res = self._client(peer).call(
                "Raft.InstallSnapshot",
                {"term": term, "leader": self.self_addr,
                 "snapshot": data, "base_index": snap_index,
                 "base_term": snap_term},
                timeout_s=30.0)
        finally:
            self._lock.acquire()
        self.stats["snapshots_sent"] += 1
        if res["term"] > self.term:
            self._become_follower(res["term"], None)
            return
        if self.role != LEADER or self.term != term:
            return
        self._next_index[peer] = snap_index + 1
        if snap_index > self._match_index.get(peer, 0):
            self._match_index[peer] = snap_index
            self._advance_commit()

    # -- dynamic membership (nomad/serf.go + setupSerf; membership
    # itself rides the replicated log, liveness is leader-local) ------
    def update_members(self, members: List[str]) -> None:
        """Adopt a new replicated member list. New peers get
        replication threads (when leader); removed peers' pumps retire;
        quorum math follows the new cluster size. Called from the FSM
        applier, so every replica converges on the same view."""
        with self._lock:
            members = list(dict.fromkeys(members))
            if self.self_addr not in members:
                # we were removed (autopilot dead-server cleanup or an
                # operator leave): go INERT — no elections, no
                # self-cluster takeover (a left nomad server shuts its
                # raft down the same way)
                LOG.warning("removed from cluster membership; isolating")
                self.peers = []
                self.cluster_size = 1
                self.removed = True
                if self.role == LEADER:
                    self._become_follower(self.term, None)
                return
            self.removed = False
            new_peers = [m for m in members if m != self.self_addr]
            added = [p for p in new_peers if p not in self.peers]
            removed = [p for p in self.peers if p not in new_peers]
            self.peers = new_peers
            self.cluster_size = len(new_peers) + 1
            for peer in removed:
                self._repl_events.pop(peer, None)
                self._next_index.pop(peer, None)
                self._match_index.pop(peer, None)
                self.last_contact.pop(peer, None)
            if self.role == LEADER:
                last, _ = (self.log[-1][0], self.log[-1][1]) if self.log \
                    else (self.base_index, self.base_term)
                gen = self._repl_gen
                for peer in added:
                    self._next_index[peer] = last + 1
                    self._match_index[peer] = 0
                    self.last_contact[peer] = time.monotonic()
                    ev = threading.Event()
                    ev.set()
                    self._repl_events[peer] = ev
                    threading.Thread(target=self._repl_loop,
                                     args=(peer, gen, ev), daemon=True,
                                     name=f"raft-repl-{peer}").start()
                if removed:
                    self._advance_commit()

    # -- compaction ----------------------------------------------------
    def compact(self, keep: int = 4096) -> None:
        """Drop applied log prefix. Never compacts past the locally
        APPLIED index — the _fsm_loop still needs committed-but-
        unapplied entries, and a reseeded base above the applied state
        would reissue already-used indexes (an index-below-base
        corruption)."""
        with self._lock:
            limit = min(self.server._raft_index, self.commit_index)
            if len(self.log) <= keep:
                return
            drop = len(self.log) - keep
            drop = min(drop, max(0, limit - self.base_index))
            if drop <= 0:
                return
            e = self.log[drop - 1]
            self.base_index, self.base_term = e[0], e[1]
            self.log = self.log[drop:]

    # -- RPC handlers --------------------------------------------------
    def rpc_methods(self) -> Dict:
        def gated(fn):
            # a stopped raft node must refuse RPCs: established
            # connections outlive the listener, and answering
            # AppendEntries after shutdown makes a "dead" server look
            # alive to the leader's contact clock (and to autopilot).
            # RpcRefused keeps the refusal an error on the caller's
            # side without tripping the dispatcher's traceback logging
            # — staggered ring teardown is a clean path
            def handler(args):
                if self._stop.is_set():
                    raise RpcRefused("raft node stopped")
                return fn(args)
            return handler

        return {
            "Raft.RequestVote": gated(self._handle_request_vote),
            "Raft.AppendEntries": gated(self._handle_append_entries),
            "Raft.InstallSnapshot": gated(self._handle_install_snapshot),
            "Raft.Forward": gated(self._handle_forward),
            "Raft.Status": self._handle_status,
        }

    def _handle_status(self, _args) -> dict:
        with self._lock:
            last_index, last_term = self.last_log()
            return {"role": self.role, "term": self.term,
                    "leader": self.leader_addr,
                    "last_log_index": last_index,
                    "last_log_term": last_term,
                    "commit_index": self.commit_index,
                    "applied_index": self.server._raft_index}

    def _handle_request_vote(self, args: dict) -> dict:
        term = int(args["term"])
        candidate = args["candidate"]
        with self._lock:
            if term > self.term:
                self._become_follower(term, None)
            if term < self.term:
                return {"term": self.term, "granted": False}
            last_index, last_term = self.last_log()
            up_to_date = (args["last_log_term"], args["last_log_index"]) \
                >= (last_term, last_index)
            if up_to_date and self.voted_for in (None, candidate):
                self.voted_for = candidate
                self._save_vote_state()
                self._election_deadline = self._new_deadline()
                return {"term": self.term, "granted": True}
            return {"term": self.term, "granted": False}

    def _handle_append_entries(self, args: dict) -> dict:
        term = int(args["term"])
        with self._lock:
            if term < self.term:
                return {"term": self.term, "success": False}
            if term > self.term or self.role != FOLLOWER:
                self._become_follower(term, args["leader"])
            self.leader_addr = args["leader"]
            self._election_deadline = self._new_deadline()
            if self.needs_snapshot:
                return {"term": self.term, "success": False,
                        "needs_snapshot": True}

            prev_index = int(args["prev_index"])
            prev_term = int(args["prev_term"])
            last_index, _ = self.last_log()
            committed = max(self.commit_index, self.server._raft_index)
            # consistency check at prev_index
            if prev_index > last_index:
                return {"term": self.term, "success": False,
                        "hint": last_index}
            if prev_index > self.base_index:
                e = self.log[prev_index - self.base_index - 1]
                if e[1] != prev_term:
                    if prev_index <= committed:
                        # a committed entry can never conflict (leader
                        # completeness, §5.4.3) — if it appears to, our
                        # commit accounting is damaged: full reseed
                        self.needs_snapshot = True
                        return {"term": self.term, "success": False,
                                "needs_snapshot": True}
                    # uncommitted conflicting suffix truncates freely —
                    # nothing was applied (§5.3)
                    del self.log[prev_index - self.base_index - 1:]
                    return {"term": self.term, "success": False,
                            "hint": prev_index - 1}
            elif prev_index < self.base_index:
                return {"term": self.term, "success": False,
                        "needs_snapshot": True}

            for idx, eterm, mtype, enc in args.get("entries", []):
                idx = int(idx)
                if idx <= self.base_index:
                    continue        # covered by the installed snapshot
                pos = idx - self.base_index - 1
                if pos < len(self.log):
                    if self.log[pos][1] == eterm:
                        continue                  # already have it
                    if idx <= committed:
                        self.needs_snapshot = True
                        return {"term": self.term, "success": False,
                                "needs_snapshot": True}
                    del self.log[pos:]
                self.log.append((idx, int(eterm), mtype, enc))
            # follower commit rule (§5.3): commit up to the leader's
            # commit index, bounded by what we actually hold; _fsm_loop
            # applies from there — never before
            last_index, _ = self.last_log()
            new_commit = min(int(args.get("leader_commit", 0)), last_index)
            if new_commit > self.commit_index:
                self.commit_index = new_commit
                self._commit_cv.notify_all()
        return {"term": self.term, "success": True}

    def _handle_install_snapshot(self, args: dict) -> dict:
        term = int(args["term"])
        with self._lock:
            if term < self.term:
                return {"term": self.term}
            self._become_follower(term, args["leader"])
            self._election_deadline = self._new_deadline()
            self._installing = True
        base_index = int(args["base_index"])
        # restore the store AND pin the applied index to the snapshot's
        # base — store.latest_index() alone undercounts (no-op entries
        # touch no table), which would reissue already-used log indexes
        # if this node later won an election
        try:
            self.server.install_snapshot(args["snapshot"], base_index)
        finally:
            with self._lock:
                self._installing = False
                self._election_deadline = self._new_deadline()
        with self._lock:
            self.base_index = base_index
            self.base_term = int(args["base_term"])
            self.log = []
            self.commit_index = base_index
            self.needs_snapshot = False
            self._snap_gen += 1       # invalidate in-flight FSM batch
            self._commit_cv.notify_all()
        LOG.warning("installed snapshot at index %d", self.base_index)
        return {"term": self.term}

    def _handle_forward(self, args: dict) -> dict:
        if not self.is_leader():
            # protocol refusal, not a fault: the forwarder rehomes to
            # the new leader (or its caller nacks and the eval is
            # redelivered) — no traceback for a routine stepdown
            raise RpcRefused("not the leader")
        payload = decode_payload(args["msg_type"], args["payload"])
        index = self.server.raft_apply(args["msg_type"], payload)
        return {"index": index}
