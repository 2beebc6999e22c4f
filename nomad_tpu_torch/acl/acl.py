"""The ACL policy engine.

Reference: acl/policy.go (policy rules: namespace
blocks with policy levels or capability lists, node/agent/operator/
quota levels, glob namespace matching) and acl/acl.go
(compiled ACL object answering capability questions; exact-match
namespaces take precedence over glob matches, with the longest-prefix
glob winning ties).

Rules are accepted as JSON/dict (the wire form) or HCL text parsed by
the in-tree HCL parser (jobspec/hcl.py).
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# policy levels (policy.go:14-18)
POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_LIST = "list"
POLICY_WRITE = "write"
POLICY_SCALE = "scale"

# namespace capabilities (policy.go:27-47)
CAP_DENY = "deny"
NS_READ_CAPS = [
    "list-jobs", "read-job", "csi-list-volume", "csi-read-volume",
    "read-job-scaling", "list-scaling-policies", "read-scaling-policy",
]
NS_WRITE_CAPS = NS_READ_CAPS + [
    "scale-job", "submit-job", "dispatch-job", "read-logs", "read-fs",
    "alloc-exec", "alloc-lifecycle", "csi-mount-volume",
    "csi-write-volume", "submit-recommendation",
]
NS_SCALE_CAPS = [
    "list-scaling-policies", "read-scaling-policy", "read-job-scaling",
    "scale-job",
]
VALID_NS_CAPS = set(NS_WRITE_CAPS) | {CAP_DENY, "alloc-node-exec",
                                      "csi-register-plugin",
                                      "sentinel-override"}


class ParseError(Exception):
    pass


def expand_namespace_policy(policy: str) -> List[str]:
    """expandNamespacePolicy (policy.go:166)."""
    if policy == POLICY_DENY:
        return [CAP_DENY]
    if policy == POLICY_READ:
        return list(NS_READ_CAPS)
    if policy == POLICY_WRITE:
        return list(NS_WRITE_CAPS)
    if policy == POLICY_SCALE:
        return list(NS_SCALE_CAPS)
    raise ParseError(f"invalid namespace policy: {policy!r}")


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


def parse_policy_rules(rules) -> dict:
    """Normalize policy rules into
    {namespaces: {name: set(caps)}, node: level, agent: level,
     operator: level, quota: level, host_volumes: {name: set(caps)}}.
    Accepts a dict (wire form) or HCL text (policy.go Parse)."""
    if isinstance(rules, str):
        rules = rules.strip()
        if not rules:
            return _normalize({})
        if rules.startswith("{"):
            import json
            return _normalize(json.loads(rules))
        from ..jobspec.hcl import parse_hcl
        return _normalize(parse_hcl(rules))
    return _normalize(rules or {})


def _as_blocks(v) -> List[Tuple[str, dict]]:
    """HCL labeled blocks arrive as {label: body} or lists of them."""
    out = []
    if isinstance(v, dict):
        for label, body in v.items():
            if isinstance(body, list):
                for b in body:
                    out.append((label, b or {}))
            else:
                out.append((label, body or {}))
    elif isinstance(v, list):
        for item in v:
            out.extend(_as_blocks(item))
    return out


def _level(body, what: str, allowed) -> Optional[str]:
    lvl = body.get("policy") if isinstance(body, dict) else body
    if lvl is None:
        return None
    if lvl not in allowed:
        raise ParseError(f"invalid {what} policy: {lvl!r}")
    return lvl


def _normalize(data: dict) -> dict:
    out = {"namespaces": {}, "host_volumes": {},
           "node": None, "agent": None, "operator": None, "quota": None,
           "plugin": None}
    for label, body in _as_blocks(data.get("namespace", {})):
        caps = set()
        if isinstance(body, dict) and body.get("capabilities"):
            for c in body["capabilities"]:
                if c not in VALID_NS_CAPS:
                    raise ParseError(f"invalid namespace capability: {c!r}")
                caps.add(c)
        lvl = _level(body, "namespace",
                     (POLICY_DENY, POLICY_READ, POLICY_WRITE, POLICY_SCALE))
        if lvl:
            caps.update(expand_namespace_policy(lvl))
        out["namespaces"][label] = caps
    for label, body in _as_blocks(data.get("host_volume", {})):
        caps = set(body.get("capabilities", [])) if isinstance(body, dict) \
            else set()
        lvl = _level(body, "host_volume",
                     (POLICY_DENY, POLICY_READ, POLICY_WRITE))
        if lvl == POLICY_DENY:
            caps.add(CAP_DENY)
        elif lvl == POLICY_READ:
            caps.add("mount-readonly")
        elif lvl == POLICY_WRITE:
            caps.update(("mount-readonly", "mount-readwrite"))
        out["host_volumes"][label] = caps
    for key, levels in (("node", (POLICY_DENY, POLICY_READ, POLICY_WRITE)),
                        ("agent", (POLICY_DENY, POLICY_READ, POLICY_WRITE)),
                        ("operator", (POLICY_DENY, POLICY_READ,
                                      POLICY_WRITE)),
                        ("quota", (POLICY_DENY, POLICY_READ, POLICY_LIST)),
                        ("plugin", (POLICY_DENY, POLICY_READ,
                                    POLICY_LIST))):
        v = data.get(key)
        if v is None:
            continue
        body = v[0] if isinstance(v, list) else v
        out[key] = _level(body, key, levels)
    return out


_LEVEL_ORDER = {None: 0, POLICY_DENY: -1, POLICY_LIST: 1, POLICY_READ: 2,
                POLICY_WRITE: 3}


class ACL:
    """Compiled capability set over one or more policies (acl/acl.go).
    Exact namespace rules take precedence over glob rules; among glob
    matches the one with the fewest wildcard-expanded characters (the
    most specific pattern) wins."""

    def __init__(self, management: bool = False):
        self.management = management
        self.namespaces: Dict[str, set] = {}
        self.wildcard_namespaces: Dict[str, set] = {}
        self.host_volumes: Dict[str, set] = {}
        self.wildcard_host_volumes: Dict[str, set] = {}
        self.node = None
        self.agent = None
        self.operator = None
        self.quota = None
        self.plugin = None

    # -- compile -------------------------------------------------------
    def merge(self, parsed: dict) -> None:
        for name, caps in parsed["namespaces"].items():
            target = self.wildcard_namespaces if "*" in name \
                else self.namespaces
            cur = target.setdefault(name, set())
            cur.update(caps)
        for name, caps in parsed["host_volumes"].items():
            target = self.wildcard_host_volumes if "*" in name \
                else self.host_volumes
            target.setdefault(name, set()).update(caps)
        for key in ("node", "agent", "operator", "quota", "plugin"):
            new = parsed[key]
            if _LEVEL_ORDER.get(new, 0) == -1:
                setattr(self, key, POLICY_DENY)
            elif getattr(self, key) != POLICY_DENY and \
                    _LEVEL_ORDER.get(new, 0) > \
                    _LEVEL_ORDER.get(getattr(self, key), 0):
                setattr(self, key, new)

    # -- namespace checks ---------------------------------------------
    def _ns_caps(self, ns: str) -> set:
        caps = self.namespaces.get(ns)
        if caps is not None:
            return caps
        best = None
        best_len = -1
        for pattern, caps in self.wildcard_namespaces.items():
            if fnmatch.fnmatchcase(ns, pattern):
                specificity = len(pattern.replace("*", ""))
                if specificity > best_len:
                    best, best_len = caps, specificity
        return best or set()

    def allow_namespace_operation(self, ns: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._ns_caps(ns)
        if CAP_DENY in caps:
            return False
        return cap in caps

    def allow_namespace(self, ns: str) -> bool:
        """Any capability at all in the namespace."""
        if self.management:
            return True
        caps = self._ns_caps(ns)
        return bool(caps) and CAP_DENY not in caps

    # -- host volumes --------------------------------------------------
    def allow_host_volume_operation(self, vol: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self.host_volumes.get(vol)
        if caps is None:
            best_len = -1
            caps = set()
            for pattern, c in self.wildcard_host_volumes.items():
                if fnmatch.fnmatchcase(vol, pattern):
                    spec = len(pattern.replace("*", ""))
                    if spec > best_len:
                        caps, best_len = c, spec
        if CAP_DENY in caps:
            return False
        return cap in caps

    # -- coarse checks -------------------------------------------------
    def _allow(self, level, want: str) -> bool:
        if self.management:
            return True
        return _LEVEL_ORDER.get(level, 0) >= _LEVEL_ORDER[want] and \
            level != POLICY_DENY

    def allow_node_read(self) -> bool:
        return self._allow(self.node, POLICY_READ)

    def allow_node_write(self) -> bool:
        return self._allow(self.node, POLICY_WRITE)

    def allow_agent_read(self) -> bool:
        return self._allow(self.agent, POLICY_READ)

    def allow_agent_write(self) -> bool:
        return self._allow(self.agent, POLICY_WRITE)

    def allow_operator_read(self) -> bool:
        return self._allow(self.operator, POLICY_READ)

    def allow_operator_write(self) -> bool:
        return self._allow(self.operator, POLICY_WRITE)

    def is_management(self) -> bool:
        return self.management


ACL_MANAGEMENT = ACL(management=True)
ACL_DENY_ALL = ACL()


def compile_acl(policies: List[AclPolicy]) -> ACL:
    """Compile an ACL from policy objects (acl.go NewACL)."""
    acl = ACL()
    for p in policies:
        acl.merge(parse_policy_rules(p.rules))
    return acl


def new_token(name: str = "", type_: str = "client",
              policies: Optional[List[str]] = None,
              global_: bool = False) -> AclToken:
    from ..utils.ids import generate_uuid
    return AclToken(accessor_id=generate_uuid(),
                    secret_id=generate_uuid(),
                    name=name, type=type_,
                    policies=list(policies or []),
                    global_=global_, create_time=time.time())
