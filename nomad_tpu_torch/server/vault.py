"""Vault token lifecycle — the embedded token authority.

Reference: nomad/vault.go:176 (vaultClient: CreateToken with TTL,
RenewToken, RevokeTokens, the revocation daemon) plus the
state-store accessor tracking (nomad/state/state_store.go
UpsertVaultAccessor / VaultAccessorsByAlloc) that lets ANY leader
revoke tokens it never minted.

No external Vault exists in this build, so the token backend is the
replicated store itself: a token is valid iff its accessor row exists,
is unrevoked, and `now < expire_time` (extended by renewals). That
collapses the reference's two-system dance (Vault holds leases, Nomad
tracks accessors in raft) into one replicated table with the same
observable semantics — derivation, periodic renewal, revocation on
alloc termination, orphan reaping, and failover (a new leader reads
the same table).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


@dataclass
class VaultAccessor:
    """One derived token lease (structs.go VaultAccessor + the lease
    state Vault itself would hold)."""
    accessor: str = ""
    token: str = ""             # the secret id (vault's own storage role)
    alloc_id: str = ""
    task: str = ""
    node_id: str = ""
    policies: List[str] = field(default_factory=list)
    ttl_s: float = 0.0
    create_time: float = 0.0    # wall clock (epoch s)
    expire_time: float = 0.0    # advanced by every renewal
    create_index: int = 0
    modify_index: int = 0

    def expired(self, now: float = None) -> bool:
        return (now if now is not None else time.time()) >= self.expire_time
