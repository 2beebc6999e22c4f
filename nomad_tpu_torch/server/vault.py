"""The Vault accessor record the state store holds and a snapshot
carries: one derived token lease (reference: structs.go VaultAccessor and
nomad/state/state_store.go UpsertVaultAccessor).

The token authority beside it in the JAX package's server/vault.py
(derivation, renewal, revocation) is not ported yet.
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
