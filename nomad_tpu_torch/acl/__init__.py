from .acl import (ACL, ACL_MANAGEMENT, AclPolicy, AclToken, ParseError,
                  compile_acl, new_token, parse_policy_rules)

__all__ = ["ACL", "ACL_MANAGEMENT", "AclPolicy", "AclToken",
           "ParseError", "compile_acl", "new_token",
           "parse_policy_rules"]
