"""SWIM-style peer failure detection.

Reference: nomad/serf.go + hashicorp/serf's SWIM implementation —
every server probes random peers directly, falls back to indirect
probes through other members, moves unresponsive peers through
SUSPECT to FAILED, and the leader's autopilot consumes the verdicts.
Failure detection is a peer-to-peer
property: ANY member can detect and report a failed server, and the
leader removes it after verifying it can't reach the target either —
no dependence on the leader's replication threads.

Simplifications vs full SWIM, at cluster sizes the reference targets
(3-9 servers): verdict dissemination is a direct report to the leader
(Server.ReportFailed) instead of gossip piggybacking, and refutation
is implicit — a reachable target answers the leader's verification
probe and the report is dropped.

Chaos hook (chaos/faults.py): `swim.probe` before every direct and
indirect probe; a truthy verdict fails it, so a partitioned victim is
unreachable while its process stays up.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Optional

from ..chaos import faults as chaos_faults
from ..rpc.codec import RpcRefused

LOG = logging.getLogger("nomad_tpu.swim")

PROBE_INTERVAL_S = 0.5
PROBE_TIMEOUT_S = 0.5
SUSPICION_S = 1.5
INDIRECT_K = 2

STATE_ALIVE = "alive"
STATE_SUSPECT = "suspect"
STATE_FAILED = "failed"


class SwimDetector:
    def __init__(self, server,
                 probe_interval_s: float = PROBE_INTERVAL_S,
                 probe_timeout_s: float = PROBE_TIMEOUT_S,
                 suspicion_s: float = SUSPICION_S,
                 indirect_k: int = INDIRECT_K):
        self.server = server
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.suspicion_s = suspicion_s
        self.indirect_k = indirect_k
        # addr -> {"state", "suspect_since", "last_ack"}
        self.states: Dict[str, Dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._probe_order: List[str] = []
        self.stats = {"probes": 0, "indirect": 0, "reported": 0}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True, name="swim")
            self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout_s)

    # -- probing -------------------------------------------------------
    def _members(self) -> List[str]:
        raft = self.server.raft
        if raft is None:
            return []
        members = self.server.store.server_members() or \
            [raft.self_addr] + list(raft.peers)
        return [m for m in members if m != raft.self_addr]

    def live_members(self) -> List[str]:
        """Members not currently under a FAILED verdict — the
        scheduler plane's re-homing directory: a follower
        hunting for the new leader skips peers this detector already
        condemned instead of eating their dial timeouts."""
        return [m for m in self._members()
                if self.states.get(m, {}).get("state") != STATE_FAILED]

    def _ping(self, addr: str) -> bool:
        if chaos_faults.ACTIVE and \
                chaos_faults.fire("swim.probe", target=addr,
                                  via=""):
            # chaos hook: an installed partition fault fails probes to
            # its victim set — the network is down, the victim process
            # is not
            return False
        from ..rpc.client import RpcClient
        try:
            c = RpcClient(addr, dial_timeout_s=self.probe_timeout_s)
            try:
                c.call("Status.Ping", {},
                       timeout_s=self.probe_timeout_s)
                return True
            finally:
                c.close()
        except Exception:
            return False

    def _indirect_ping(self, via: str, target: str) -> bool:
        if chaos_faults.ACTIVE and \
                chaos_faults.fire("swim.probe", target=target, via=via):
            # a partitioned victim is unreachable via relays too: the
            # ping-req's last hop crosses the same cut
            return False
        from ..rpc.client import RpcClient
        try:
            c = RpcClient(via, dial_timeout_s=self.probe_timeout_s)
            try:
                res = c.call("Server.IndirectPing", {"target": target},
                             timeout_s=self.probe_timeout_s * 3)
                return bool(res.get("ok"))
            finally:
                c.close()
        except Exception:
            return False

    def probe_for_peer(self, target: str) -> bool:
        """Serve another member's indirect probe (SWIM ping-req)."""
        return self._ping(target)

    def _next_target(self, members: List[str]) -> Optional[str]:
        """Round-robin over a shuffled member ring (SWIM's probe
        schedule: every member probed once per cycle, random order)."""
        self._probe_order = [m for m in self._probe_order
                             if m in members]
        if not self._probe_order:
            self._probe_order = list(members)
            random.shuffle(self._probe_order)
        return self._probe_order.pop() if self._probe_order else None

    def _loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self._tick()
            except RpcRefused as e:
                # a suspect/dead raft write hit a raft node that has
                # already stopped (staggered teardown, mid-transfer
                # fencing) — a protocol refusal, not a probe fault
                LOG.debug("swim tick refused: %s", e)
            except Exception:       # pragma: no cover — keep probing
                LOG.exception("swim tick failed")

    def _tick(self) -> None:
        members = self._members()
        for gone in set(self.states) - set(members):
            self.states.pop(gone, None)
        target = self._next_target(members)
        if target is None:
            return
        self.stats["probes"] += 1
        now = time.monotonic()
        st = self.states.setdefault(
            target, {"state": STATE_ALIVE, "suspect_since": 0.0,
                     "last_ack": now})
        if self._ping(target):
            st.update(state=STATE_ALIVE, suspect_since=0.0,
                      last_ack=now)
            return
        # direct probe failed: try K indirect routes (SWIM ping-req)
        others = [m for m in members if m != target]
        random.shuffle(others)
        for via in others[:self.indirect_k]:
            self.stats["indirect"] += 1
            if self._indirect_ping(via, target):
                st.update(state=STATE_ALIVE, suspect_since=0.0,
                          last_ack=now)
                return
        if st["state"] == STATE_ALIVE:
            st.update(state=STATE_SUSPECT, suspect_since=now)
            LOG.warning("swim: %s is SUSPECT", target)
            return
        if st["state"] == STATE_SUSPECT and \
                now - st["suspect_since"] >= self.suspicion_s:
            st["state"] = STATE_FAILED
            LOG.warning("swim: %s is FAILED, reporting", target)
        if st["state"] == STATE_FAILED:
            self._report(target)

    def _report(self, target: str) -> None:
        """Deliver the verdict to the leader (repeats every probe cycle
        until the membership change lands)."""
        self.stats["reported"] += 1
        server = self.server
        raft = server.raft
        if raft is not None and raft.is_leader():
            server.handle_peer_failure_report(target,
                                              reporter=raft.self_addr)
            return
        from ..rpc.client import RpcClient
        leader = getattr(raft, "leader_addr", None) if raft else None
        candidates = ([leader] if leader else []) + \
            [m for m in self._members() if m != target]
        for addr in candidates:
            try:
                c = RpcClient(addr, dial_timeout_s=self.probe_timeout_s)
                try:
                    c.call("Server.ReportFailed",
                           {"addr": target,
                            "reporter": raft.self_addr if raft else ""},
                           timeout_s=2.0)
                    return
                finally:
                    c.close()
            except Exception:
                continue
