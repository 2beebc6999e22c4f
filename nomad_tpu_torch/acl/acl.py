"""The ACL records the state store holds and a snapshot carries: a
policy and a token (reference: nomad/structs ACLPolicy, ACLToken).

The policy engine beside them in the JAX package's acl/acl.py (rule
parsing, the compiled ACL object, capability checks) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class AclPolicy:
    """structs.ACLPolicy: named policy with raw rules."""
    name: str = ""
    description: str = ""
    rules: str = ""                    # HCL or JSON text, as submitted
    create_index: int = 0
    modify_index: int = 0


@dataclass
class AclToken:
    """structs.ACLToken."""
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = "client"               # "client" | "management"
    policies: List[str] = field(default_factory=list)
    global_: bool = False
    create_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def stub(self) -> dict:
        return {"accessor_id": self.accessor_id, "name": self.name,
                "type": self.type, "policies": list(self.policies),
                "global": self.global_,
                "create_index": self.create_index,
                "modify_index": self.modify_index}
