"""Deterministic fault injection for the scenario matrix.

Jepsen-style chaos needs two halves: a WORKLOAD (chaos/scenarios.py)
and a NEMESIS. This module is the nemesis — a seeded schedule of
injections delivered through explicit hook points compiled into the
production code:

  worker.plan_committed   EvalLane.submit_plan, after the plan future
                          resolved (plan IS committed) and BEFORE the
                          worker acks the eval — raising here is a
                          worker dying mid-commit; the broker's nack
                          path redelivers the eval and the retry must
                          reconcile, not double-place
  swim.probe              SwimDetector._ping/_indirect_ping — a truthy
                          interposer verdict fails the probe, so a
                          victim set partitions away at the SWIM layer
                          while its process stays healthy
  server.heartbeat        Server.heartbeat — a truthy verdict drops
                          the beat in transit (the client believes it
                          beat; the TTL timer and the stale-stats
                          clock both keep running)
  raft.replicate          RaftNode._replicate_peer, before the round
                          trip — a truthy verdict drops the whole
                          AppendEntries exchange on the LEADER side,
                          so the victim's log/store lags while its
                          process stays healthy (the follower
                          snapshot-fence fault)
  raft.election           RaftNode._ticker, at an expired election
                          deadline — a truthy verdict resets the
                          deadline instead of campaigning, so a
                          replication-lagged victim stays a lagging
                          follower instead of deposing the leader
  plan.group_commit       PlanApplier.apply_group, after the group's
                          raft entry is appended but before any
                          submitter future resolves — the observation
                          point for killing a leader mid-group-commit

plus two direct actions that need no hook: `corrupt_wal_tail` (flip a
byte range at the end of raft.log between a shutdown and a reboot) and
`FaultInjector.force_governor_reclaim` (drive a registered reclaim
callback mid-wave — the governor-pressure fault).

Cost discipline: the hook points guard on the module-level `ACTIVE`
bool, so production traffic pays one attribute read + branch per hook
site and the interposer dictionary is consulted only while an injector
is installed. This module imports nothing from the server tree —
server/worker/swim import IT, the matrix imports them.

Every injection is recorded on the injector (`injector.events`) with a
monotonic timestamp, so a cell's artifact section carries the exact
fault schedule its invariants were judged under.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, Dict, List, Optional, Set

from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.chaos")

# fast-path gate read by the production hook sites; flipped only by
# FaultInjector.install/uninstall below
ACTIVE = False

_INSTALL_L = make_lock()
_INJECTOR: Optional["FaultInjector"] = None

# ServerConfig wiring (the race.configure idiom): Server.__init__
# pushes its chaos_* knobs here so cells that don't pin their own get
# the operator-configured defaults
DEFAULTS = {
    "seed": 0,
    "visibility_bound_s": 15.0,
}


def configure(seed: Optional[int] = None,
              visibility_bound_s: Optional[float] = None) -> None:
    """Install ServerConfig.chaos_* knob values as module defaults."""
    if seed is not None:
        DEFAULTS["seed"] = int(seed)
    if visibility_bound_s is not None:
        DEFAULTS["visibility_bound_s"] = float(visibility_bound_s)


class WorkerKilled(Exception):
    """Raised at the worker.plan_committed hook: the worker 'dies'
    after its plan committed but before it acked the eval. The
    process_eval exception path nacks, the broker redelivers, and the
    retried eval's reconcile must find the committed placements."""


def fire(point: str, **kw):
    """Called from the production hook sites (guarded on ACTIVE).
    Returns the installed injector's verdict for `point`, or None when
    no interposer covers it. An interposer may raise (worker kill)."""
    inj = _INJECTOR
    if inj is None:
        return None
    fn = inj._interposers.get(point)
    if fn is None:
        return None
    return fn(**kw)


class FaultInjector:
    """One cell's seeded nemesis. Use as a context manager:

        with FaultInjector(seed=7) as inj:
            inj.kill_worker_on_commit(nth=2)
            ... drive the workload ...

    Only one injector is installed at a time (cells are sequential);
    installing a second raises."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = DEFAULTS["seed"] if seed is None else int(seed)
        self.rng = random.Random(0xFA117 ^ (self.seed * 2654435761))
        self.events: List[dict] = []
        self._l = make_lock()
        self._interposers: Dict[str, Callable] = {}
        # worker-kill arm state
        self._kill_at: Optional[int] = None
        self._commits_seen = 0
        self.killed_evals: List[str] = []
        # partition arm state
        self._victims: Set[str] = set()
        # heartbeat arm state
        self._hb_victims: Optional[Set[str]] = None   # None == all
        self._hb_drop_prob = 0.0
        self.dropped_beats = 0
        # replication-lag arm state
        self._repl_victims: Set[str] = set()
        self.dropped_replications = 0
        # wire-latency arm state: per-round-trip delay on
        # the leader's replication pumps, modelling inter-server RTT
        self._wire_rtt_s = 0.0
        # group-commit trip arm state: the cell's MAIN
        # thread waits on this and performs the leader kill itself —
        # killing from inside the hook would deadlock the shutdown
        # join against the very committer thread the hook runs on
        import threading as _threading
        self.group_commit_tripped = _threading.Event()
        self._trip_at: Optional[int] = None
        self._groups_seen = 0
        self.tripped_group_index = 0

    # -- lifecycle -----------------------------------------------------
    def install(self) -> "FaultInjector":
        global ACTIVE, _INJECTOR
        with _INSTALL_L:
            if _INJECTOR is not None and _INJECTOR is not self:
                raise RuntimeError("a FaultInjector is already installed")
            _INJECTOR = self
            ACTIVE = True
        return self

    def uninstall(self) -> None:
        global ACTIVE, _INJECTOR
        with _INSTALL_L:
            if _INJECTOR is self:
                _INJECTOR = None
                ACTIVE = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def record(self, kind: str, **detail) -> None:
        with self._l:
            self.events.append({"kind": kind, "t": time.monotonic(),
                                **detail})

    # -- worker kill mid-commit ----------------------------------------
    def kill_worker_on_commit(self, nth: int = 1) -> None:
        """Arm: the nth plan commit observed after arming kills its
        worker (raises WorkerKilled between commit and ack)."""
        self._kill_at = max(1, int(nth))
        self._commits_seen = 0
        self._interposers["worker.plan_committed"] = self._on_commit
        self.record("arm", fault="worker_kill", nth=self._kill_at)

    def _on_commit(self, eval_id: str = "", placements: int = 0):
        with self._l:
            self._commits_seen += 1
            due = (self._kill_at is not None
                   and self._commits_seen == self._kill_at)
            if due:
                self._kill_at = None        # one-shot
                self.killed_evals.append(eval_id)
        if due:
            self.record("worker_kill", eval_id=eval_id,
                        placements=placements)
            raise WorkerKilled(
                f"chaos: worker killed mid-commit (eval {eval_id[:8]}, "
                f"{placements} placements committed, ack withheld)")
        return None

    # -- SWIM partition ------------------------------------------------
    def partition(self, victims) -> None:
        """Probes (direct and indirect) to any victim address fail
        until heal_partition(). The victim processes stay healthy —
        this is the network's fault, not theirs."""
        self._victims = set(victims)
        self._interposers["swim.probe"] = self._on_probe
        self.record("partition", victims=sorted(self._victims))

    def heal_partition(self) -> None:
        healed = sorted(self._victims)
        self._victims = set()
        self.record("heal_partition", victims=healed)

    def _on_probe(self, target: str = "", **_kw):
        if target in self._victims:
            self.record("probe_dropped", target=target)
            return True     # truthy == fail the probe
        return None

    # -- heartbeat delay/drop ------------------------------------------
    def drop_heartbeats(self, node_ids=None, prob: float = 1.0) -> None:
        """Beats from the given nodes (all when None) are dropped in
        transit with probability `prob` (seeded RNG — deterministic
        per injector seed). Trips the TTL -> node-down path and ages
        the heartbeat stats payloads into `stale_heartbeats`."""
        self._hb_victims = None if node_ids is None else set(node_ids)
        self._hb_drop_prob = float(prob)
        self._interposers["server.heartbeat"] = self._on_heartbeat
        self.record("arm", fault="heartbeat_drop",
                    nodes=(sorted(n[:8] for n in self._hb_victims)
                           if self._hb_victims is not None else "all"),
                    prob=prob)

    def allow_heartbeats(self) -> None:
        self._hb_victims = set()
        self._hb_drop_prob = 0.0
        self.record("heal", fault="heartbeat_drop")

    def _on_heartbeat(self, node_id: str = "", **_kw):
        victims = self._hb_victims
        if victims is not None and node_id not in victims:
            return None
        if self._hb_drop_prob >= 1.0 or \
                self.rng.random() < self._hb_drop_prob:
            with self._l:
                self.dropped_beats += 1
            return True     # truthy == drop the beat
        return None

    # -- replication lag -----------------------------------------------
    def lag_replication(self, victims) -> None:
        """AppendEntries round trips from the leader to any victim
        address are dropped until heal_replication() — the victim's
        raft log (and MVCC store) falls behind while its process, RPC
        listener, and SWIM probes all stay healthy. The same arming
        suppresses the victims' election timeouts: a lagging follower
        must stay a follower, not bump the term and depose the leader
        whose lag the cell is measuring."""
        self._repl_victims = set(victims)
        self._interposers["raft.replicate"] = self._on_replicate
        self._interposers["raft.election"] = self._on_election
        self.record("replication_lag", victims=sorted(self._repl_victims))

    def wire_latency(self, rtt_s: float) -> None:
        """Arm: every AppendEntries round trip from the leader is
        stretched by `rtt_s` before dispatch — a stand-in for real
        inter-server network distance on the commit path. Unlike
        lag_replication nothing is dropped: commit latency rises
        uniformly. A benchmark that compares two arms of a ring arms
        this identically in both, so a loopback ring exercises the
        LAN-ring latencies the follower plane exists to hide."""
        self._wire_rtt_s = float(rtt_s)
        self._interposers["raft.replicate"] = self._on_replicate
        self.record("wire_latency", rtt_s=rtt_s)

    def heal_replication(self) -> None:
        healed = sorted(self._repl_victims)
        self._repl_victims = set()
        self.record("heal_replication", victims=healed)

    def _on_replicate(self, target: str = "", **_kw):
        if self._wire_rtt_s > 0.0:
            time.sleep(self._wire_rtt_s)
        if target in self._repl_victims:
            with self._l:
                self.dropped_replications += 1
            return True     # truthy == drop the round trip
        return None

    def _on_election(self, addr: str = "", **_kw):
        if addr in self._repl_victims:
            self.record("election_suppressed", addr=addr)
            return True     # truthy == reset deadline, don't campaign
        return None

    # -- leader kill mid-group-commit ----------------------------------
    def trip_on_group_commit(self, nth: int = 1) -> None:
        """Arm: the nth plan-group commit observed after arming sets
        `group_commit_tripped` (and records the group's raft index).
        The hook itself only OBSERVES — the cell's main thread waits on
        the event and kills the leader from outside, because a kill
        from the committer/applier thread would join against itself."""
        self._trip_at = max(1, int(nth))
        self._groups_seen = 0
        self.group_commit_tripped.clear()
        self._interposers["plan.group_commit"] = self._on_group_commit
        self.record("arm", fault="group_commit_trip", nth=self._trip_at)

    def _on_group_commit(self, index: int = 0, plans: int = 0):
        with self._l:
            self._groups_seen += 1
            due = (self._trip_at is not None
                   and self._groups_seen == self._trip_at)
            if due:
                self._trip_at = None            # one-shot
                self.tripped_group_index = index
        if due:
            self.record("group_commit_trip", index=index, plans=plans)
            self.group_commit_tripped.set()
        return None

    # -- governor pressure ---------------------------------------------
    def force_governor_reclaim(self, server, structure: str = "") -> List[dict]:
        """Drive registered reclaim callbacks NOW (watermark and rate
        limit bypassed) — the mid-wave memory-pressure fault. With
        `structure` empty every reclaimable registration fires; the
        reclaims are the same closures the real watermarks run, so a
        cell proves the workload survives reclamation at the worst
        moment, not just at idle."""
        gov = getattr(server, "governor", None)
        if gov is None:
            self.record("governor_reclaim", skipped="no governor")
            return []
        fired = gov.force_reclaim(structure or None)
        self.record("governor_reclaim", structure=structure or "all",
                    fired=[f["structure"] for f in fired])
        return fired


def corrupt_wal_tail(data_dir: str, span: int = 48,
                     seed: Optional[int] = None) -> dict:
    """Flip every byte in the last `span` bytes of the WAL (XOR with a
    seeded byte stream, guaranteed non-identity) — the torn/corrupt
    tail a crash or bad disk leaves. Run between a shutdown and a
    reboot; RaftLog.replay treats the first undecodable frame as the
    end of history, so the committed prefix must fully recover and the
    lost tail is what the scheduler re-derives from intent."""
    path = os.path.join(data_dir, "raft.log")
    size = os.path.getsize(path)
    span = min(int(span), size)
    if span <= 0:
        return {"path": path, "corrupted_bytes": 0, "wal_bytes": size}
    rng = random.Random(0xBADF ^ ((seed or 0) * 2654435761))
    with open(path, "r+b") as f:
        f.seek(size - span)
        tail = bytearray(f.read(span))
        for i in range(len(tail)):
            tail[i] ^= rng.randint(1, 255)
        f.seek(size - span)
        f.write(tail)
        f.flush()
        os.fsync(f.fileno())
    LOG.warning("chaos: corrupted %d WAL tail bytes of %s", span, path)
    return {"path": path, "corrupted_bytes": span, "wal_bytes": size}
