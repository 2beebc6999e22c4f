"""Client-side vault token management.

Reference: client/vaultclient/vaultclient.go — the client keeps every
derived token in a renewal heap, renews each at half its lease, and
surfaces renewal failure to the task's vault hook, which re-derives and
applies the task's change_mode. Here the renewer is one daemon thread
over the agent's server transport (Node.DeriveVaultToken /
Node.RenewVaultToken)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple
from ..utils.locks import make_lock

LOG = logging.getLogger("nomad_tpu.client.vault")


def _normalize(info) -> dict:
    """Accept the lease dict, a legacy bare token string, or a missing
    entry (-> empty token, nothing exported)."""
    if isinstance(info, dict):
        return dict(info)
    if info is None:
        return {"token": "", "accessor": "", "ttl_s": 0.0}
    return {"token": str(info), "accessor": "", "ttl_s": 0.0}


class VaultTokenRenewer:
    """Tracks derived tokens and renews each at renew_fraction of its
    TTL; on renewal failure re-derives and hands the fresh lease to the
    task's callback (the vault_hook change_mode path)."""

    def __init__(self, transport, renew_fraction: float = 0.5,
                 tick_s: float = 0.05):
        self.transport = transport
        self.renew_fraction = renew_fraction
        self.tick_s = tick_s
        self._tracked: Dict[Tuple[str, str], dict] = {}
        self._lock = make_lock()
        self._stop = threading.Event()
        self._wake = threading.Event()   # set on track() / stop()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"renewals": 0, "rederives": 0, "failures": 0}

    # -- derivation ----------------------------------------------------
    def derive(self, alloc_id: str, task: str) -> dict:
        tokens = self.transport.derive_vault_token(alloc_id, [task])
        return _normalize(tokens.get(task))

    # -- tracking ------------------------------------------------------
    def track(self, alloc_id: str, task: str, lease: dict,
              on_new_token: Optional[Callable[[dict], None]] = None,
              renew_now: bool = False) -> None:
        """`renew_now` schedules an immediate renewal — used for leases
        restored from the client state DB, whose remaining TTL is
        unknown (renewal either refreshes it or fails into re-derive)."""
        lease = _normalize(lease)
        ttl = float(lease.get("ttl_s") or 0.0)
        if ttl <= 0 or not lease.get("accessor"):
            return      # legacy/no-lease token: nothing to renew
        entry = {"alloc_id": alloc_id, "task": task, "lease": lease,
                 "next_renew": time.monotonic() if renew_now
                 else time.monotonic() + ttl * self.renew_fraction,
                 "fails": 0,
                 "on_new_token": on_new_token}
        with self._lock:
            self._tracked[(alloc_id, task)] = entry
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="vault-renewer")
                self._thread.start()
        self._wake.set()

    def untrack(self, alloc_id: str, task: str) -> None:
        with self._lock:
            self._tracked.pop((alloc_id, task), None)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    # -- renewal loop --------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                entries = list(self._tracked.values())
            due = [e for e in entries if now >= e["next_renew"]]
            for e in due:
                self._renew_one(e)
            # sleep until the earliest next renewal (coarse 30 s cap so
            # freshly-derived hour-long leases don't pin the wakeup),
            # waking early when track()/stop() changes the set
            with self._lock:
                nexts = [e["next_renew"] for e in self._tracked.values()]
            wait = min([n - time.monotonic() for n in nexts] + [30.0])
            self._wake.wait(max(wait, self.tick_s))
            self._wake.clear()

    def _renew_one(self, e: dict) -> None:
        key = (e["alloc_id"], e["task"])
        lease = e["lease"]
        try:
            ttl = self.transport.renew_vault_token(
                lease["accessor"], lease["token"])
            e["next_renew"] = time.monotonic() \
                + float(ttl) * self.renew_fraction
            e["fails"] = 0
            self.stats["renewals"] += 1
            return
        except Exception as renew_err:
            # retry transient failures (network blip, leader election)
            # with a short backoff before giving up on the lease — only
            # a persistent failure re-derives and fires change_mode
            # (vaultclient.go renewal backoff)
            e["fails"] += 1
            if e["fails"] < 3:
                ttl = float(lease.get("ttl_s") or 1.0)
                e["next_renew"] = time.monotonic() \
                    + min(1.0, ttl * 0.1)
                return
            LOG.info("vault renewal for %s failed (%s); re-deriving",
                     key, renew_err)
        # renewal failed persistently: re-derive, hand the new token to
        # the task (vault_hook.go: renewal failure -> deriveVaultToken
        # -> change_mode)
        try:
            fresh = self.derive(e["alloc_id"], e["task"])
            e["lease"] = fresh
            e["fails"] = 0
            ttl = float(fresh.get("ttl_s") or 0.0)
            e["next_renew"] = time.monotonic() \
                + max(ttl, 0.1) * self.renew_fraction
            self.stats["rederives"] += 1
            cb = e.get("on_new_token")
            if cb is not None:
                cb(fresh)
        except Exception as derive_err:
            # alloc gone/terminal: stop tracking
            self.stats["failures"] += 1
            LOG.warning("vault re-derive for %s failed: %s; untracking",
                        key, derive_err)
            self.untrack(*key)
