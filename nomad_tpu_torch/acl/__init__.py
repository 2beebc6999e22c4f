"""The ACL records the state store holds (policies and tokens). The
policy engine of the JAX package's acl/ is not ported yet."""

from .acl import AclPolicy, AclToken

__all__ = ["AclPolicy", "AclToken"]
