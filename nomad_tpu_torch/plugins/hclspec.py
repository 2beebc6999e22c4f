"""Typed plugin/driver config schemas — the hclspec analog.

Reference: plugins/shared/hclspec (hcl_spec.proto) — plugins declare a
schema for their config block; the client decodes the user's raw config
against it, applying defaults and failing loudly on unknown keys or
type mismatches, instead of passing raw dicts around. The reference
expresses specs as protobuf-encoded HCL decoding instructions; here a
spec is a small tree of Attr/Block nodes with the same semantics
(typed attributes, defaults, required, nested blocks, lists).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


class SpecError(ValueError):
    """Config did not match the declared spec."""


@dataclasses.dataclass
class Attr:
    """One typed attribute (hclspec.Attr): type is one of 'string',
    'number', 'bool', 'list(string)', 'list(number)', 'any'."""
    type: str = "string"
    required: bool = False
    default: Any = None


@dataclasses.dataclass
class Block:
    """A nested object with its own spec (hclspec.Block)."""
    spec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    required: bool = False


def _coerce(path: str, typ: str, value: Any) -> Any:
    if typ == "any":
        return value
    if typ == "string":
        if isinstance(value, str):
            return value
        if isinstance(value, (int, float, bool)):
            return str(value)
        raise SpecError(f"{path}: expected string, got "
                        f"{type(value).__name__}")
    if typ == "number":
        if isinstance(value, bool):
            raise SpecError(f"{path}: expected number, got bool")
        if isinstance(value, (int, float)):
            return value
        if isinstance(value, str):
            try:
                return float(value) if "." in value else int(value)
            except ValueError:
                raise SpecError(f"{path}: expected number, got {value!r}")
        raise SpecError(f"{path}: expected number, got "
                        f"{type(value).__name__}")
    if typ == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise SpecError(f"{path}: expected bool, got "
                        f"{type(value).__name__}")
    if typ.startswith("list(") and typ.endswith(")"):
        inner = typ[5:-1]
        if not isinstance(value, (list, tuple)):
            raise SpecError(f"{path}: expected {typ}, got "
                            f"{type(value).__name__}")
        return [_coerce(f"{path}[{i}]", inner, v)
                for i, v in enumerate(value)]
    if typ.startswith("map(") and typ.endswith(")"):
        # hclspec map(T): string keys, T values (e.g. qemu port_map)
        inner = typ[4:-1]
        if isinstance(value, (list, tuple)):
            # HCL's repeated-block shape: [{k: v}, ...] flattens
            merged: Dict[str, Any] = {}
            for entry in value:
                if not isinstance(entry, dict):
                    raise SpecError(f"{path}: expected {typ}, got list "
                                    f"of {type(entry).__name__}")
                merged.update(entry)
            value = merged
        if not isinstance(value, dict):
            raise SpecError(f"{path}: expected {typ}, got "
                            f"{type(value).__name__}")
        return {str(k): _coerce(f"{path}[{k}]", inner, v)
                for k, v in value.items()}
    raise SpecError(f"{path}: unknown spec type {typ!r}")


def decode(spec: Dict[str, Any], raw: Optional[Dict],
           path: str = "config") -> Dict[str, Any]:
    """Validate `raw` against `spec`: unknown keys fail, required keys
    must be present, defaults fill in, values coerce to their declared
    types. Returns the decoded config."""
    raw = dict(raw or {})
    out: Dict[str, Any] = {}
    for key, node in spec.items():
        present = key in raw
        value = raw.pop(key, None)
        if isinstance(node, Attr):
            if not present:
                if node.required:
                    raise SpecError(f"{path}.{key}: required")
                if node.default is not None:
                    # copy: handing out the spec's own default object
                    # would let one task's in-place mutation poison
                    # every later decode
                    import copy
                    out[key] = copy.deepcopy(node.default)
                continue
            out[key] = _coerce(f"{path}.{key}", node.type, value)
        elif isinstance(node, Block):
            if not present:
                if node.required:
                    raise SpecError(f"{path}.{key}: required block")
                continue
            if not isinstance(value, dict):
                raise SpecError(f"{path}.{key}: expected block, got "
                                f"{type(value).__name__}")
            out[key] = decode(node.spec, value, f"{path}.{key}")
        else:
            raise SpecError(f"{path}.{key}: bad spec node "
                            f"{type(node).__name__}")
    if raw:
        unknown = ", ".join(sorted(raw))
        raise SpecError(f"{path}: unknown keys: {unknown}")
    return out


def describe(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Wire-friendly description of a spec (the plugin boundary ships
    this as the ConfigSchema answer, plugins/base/plugin.go
    ConfigSchema)."""
    out = {}
    for key, node in spec.items():
        if isinstance(node, Attr):
            out[key] = {"type": node.type, "required": node.required,
                        "default": node.default}
        else:
            out[key] = {"block": describe(node.spec),
                        "required": node.required}
    return out


def spec_from_wire(data: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of describe() — rebuilds a spec tree shipped over the
    plugin boundary."""
    out: Dict[str, Any] = {}
    for key, node in (data or {}).items():
        if "block" in node:
            out[key] = Block(spec=spec_from_wire(node["block"]),
                             required=bool(node.get("required")))
        else:
            out[key] = Attr(type=node.get("type", "string"),
                            required=bool(node.get("required")),
                            default=node.get("default"))
    return out
