"""HCL2 jobspec features: variables, locals, functions, dynamic blocks.

Reference: jobspec2/parse.go — hashicorp/hcl/v2 + cty evaluation with
`variable`/`locals` blocks, `var.*`/`local.*` references, the function
library (jobspec2/functions.go), and Terraform-style `dynamic` blocks.

This layer evaluates the raw dict produced by the in-tree HCL parser
(jobspec/hcl.py) before job mapping:
  - `variable "name" { default, type, description }` declarations with
    caller-supplied overrides (-var / NOMAD_VAR_* in the CLI)
  - `locals { ... }` evaluated after variables (may reference them)
  - `${...}` expressions in any string: literals, var./local./each.
    references, indexing, arithmetic/comparison/logic, conditionals,
    and ~30 stdlib functions
  - bare `var.x` / `local.x` attribute values
  - `dynamic "block" { for_each, labels, content {} }` expansion with
    each.key/each.value (iterator named after the block label)
  - runtime interpolations (${node.*}, ${attr.*}, ${meta.*}, ${env.*},
    ${NOMAD_*}) pass through untouched for the client to resolve

Expressions outside plain references must be written inside "${...}"
(the parser dialect keeps attribute values literal otherwise).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from .hcl import HclError

_RUNTIME_ROOTS = ("node", "attr", "meta", "env", "NOMAD_")
_BARE_REF = re.compile(r"^([A-Za-z_]\w*)\.[A-Za-z_][\w.\-]*$")


class Hcl2Error(HclError):
    pass


# -- function library (jobspec2/functions.go subset) --------------------
def _fn_format(fmt, *args):
    # cty %s/%d/%v-style: map to python
    return re.sub(r"%[vds]", "{}", fmt).format(*args) \
        if "%" in fmt else fmt.format(*args)


FUNCTIONS = {
    "upper": lambda s: str(s).upper(),
    "lower": lambda s: str(s).lower(),
    "title": lambda s: str(s).title(),
    "trimspace": lambda s: str(s).strip(),
    "trimprefix": lambda s, p: str(s)[len(p):]
        if str(s).startswith(p) else str(s),
    "trimsuffix": lambda s, p: str(s)[:-len(p)]
        if p and str(s).endswith(p) else str(s),
    "replace": lambda s, a, b: str(s).replace(a, b),
    "regex_replace": lambda s, pat, rep: re.sub(pat, rep, str(s)),
    "split": lambda sep, s: str(s).split(sep),
    "join": lambda sep, parts: sep.join(str(p) for p in parts),
    "format": _fn_format,
    "substr": lambda s, off, ln: str(s)[off:off + ln]
        if ln >= 0 else str(s)[off:],
    "length": lambda x: len(x),
    "min": lambda *a: min(a),
    "max": lambda *a: max(a),
    "abs": abs,
    "ceil": lambda x: -(-int(x) // 1) if x == int(x) else int(x) + 1,
    "floor": lambda x: int(x) if x >= 0 or x == int(x) else int(x) - 1,
    "concat": lambda *lists: [x for lst in lists for x in lst],
    "contains": lambda lst, v: v in lst,
    "distinct": lambda lst: list(dict.fromkeys(lst)),
    "flatten": lambda lst: [x for sub in lst
                            for x in (sub if isinstance(sub, list)
                                      else [sub])],
    "keys": lambda m: sorted(m.keys()),
    "values": lambda m: [m[k] for k in sorted(m.keys())],
    "lookup": lambda m, k, default=None: m.get(k, default),
    "merge": lambda *ms: {k: v for m in ms for k, v in m.items()},
    "range": lambda *a: list(range(*a)),
    "reverse": lambda lst: list(reversed(lst)),
    "sort": lambda lst: sorted(lst, key=str),
    "coalesce": lambda *a: next((x for x in a if x not in (None, "")),
                                None),
    "compact": lambda lst: [x for x in lst if x not in (None, "")],
    "element": lambda lst, i: lst[int(i) % len(lst)],
    "index": lambda lst, v: lst.index(v),
    "jsonencode": lambda v: json.dumps(v),
    "jsondecode": lambda s: json.loads(s),
    "base64encode": lambda s: __import__("base64")
        .b64encode(str(s).encode()).decode(),
    "base64decode": lambda s: __import__("base64")
        .b64decode(s).decode(),
    "tostring": lambda v: str(v),
    "tonumber": lambda v: float(v) if "." in str(v) else int(v),
    "toset": lambda lst: list(dict.fromkeys(lst)),
    "chunklist": lambda lst, n: [lst[i:i + n]
                                 for i in range(0, len(lst), n)],
}


# -- expression evaluator ----------------------------------------------
_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<op>==|!=|<=|>=|&&|\|\||[-+*/%<>?:(),\[\]{}.!])
  | (?P<ident>[A-Za-z_][\w-]*)
""", re.X)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out = []
    i = 0
    while i < len(src):
        m = _TOKEN.match(src, i)
        if not m:
            raise Hcl2Error(f"bad expression near {src[i:]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _ExprParser:
    """Pratt-ish parser for the ${...} expression language."""

    def __init__(self, tokens: List[Tuple[str, str]], scope: Dict):
        self.toks = tokens
        self.i = 0
        self.scope = scope

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str):
        t = self.next()
        if t[1] != val:
            raise Hcl2Error(f"expected {val!r}, got {t[1]!r}")

    def parse(self):
        v = self.ternary()
        if self.peek()[0] != "eof":
            raise Hcl2Error(f"trailing tokens at {self.peek()[1]!r}")
        return v

    def ternary(self):
        cond = self.or_()
        if self.peek()[1] == "?":
            self.next()
            a = self.ternary()
            self.expect(":")
            b = self.ternary()
            return a if cond else b
        return cond

    def or_(self):
        v = self.and_()
        while self.peek()[1] == "||":
            self.next()
            rhs = self.and_()
            v = bool(v) or bool(rhs)
        return v

    def and_(self):
        v = self.cmp()
        while self.peek()[1] == "&&":
            self.next()
            rhs = self.cmp()
            v = bool(v) and bool(rhs)
        return v

    def cmp(self):
        v = self.add()
        while self.peek()[1] in ("==", "!=", "<", ">", "<=", ">="):
            op = self.next()[1]
            rhs = self.add()
            v = {"==": v == rhs, "!=": v != rhs, "<": v < rhs,
                 ">": v > rhs, "<=": v <= rhs, ">=": v >= rhs}[op]
        return v

    def add(self):
        v = self.mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            rhs = self.mul()
            v = v + rhs if op == "+" else v - rhs
        return v

    def mul(self):
        v = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            rhs = self.unary()
            if op == "*":
                v = v * rhs
            elif op == "/":
                v = v / rhs
            else:
                v = v % rhs
        return v

    def unary(self):
        if self.peek()[1] == "!":
            self.next()
            return not self.unary()
        if self.peek()[1] == "-":
            self.next()
            return -self.unary()
        return self.postfix()

    def postfix(self):
        v = self.primary()
        while True:
            t = self.peek()
            if t[1] == "[":
                self.next()
                idx = self.ternary()
                self.expect("]")
                v = v[idx]
            elif t[1] == ".":
                self.next()
                attr = self.next()[1]
                if isinstance(v, dict):
                    v = v[attr]
                else:
                    v = getattr(v, attr)
            else:
                return v

    def primary(self):
        kind, val = self.next()
        if kind == "num":
            return float(val) if "." in val else int(val)
        if kind == "str":
            return json.loads(val)
        if val == "(":
            v = self.ternary()
            self.expect(")")
            return v
        if val == "[":
            out = []
            while self.peek()[1] != "]":
                out.append(self.ternary())
                if self.peek()[1] == ",":
                    self.next()
            self.next()
            return out
        if kind == "ident":
            if val in ("true", "false"):
                return val == "true"
            if val == "null":
                return None
            if self.peek()[1] == "(":
                self.next()
                args = []
                while self.peek()[1] != ")":
                    args.append(self.ternary())
                    if self.peek()[1] == ",":
                        self.next()
                self.next()
                fn = FUNCTIONS.get(val)
                if fn is None:
                    raise Hcl2Error(f"unknown function {val!r}")
                return fn(*args)
            # root reference
            root = self.scope.get(val)
            if root is None and val not in self.scope:
                raise Hcl2Error(f"unknown reference {val!r}")
            return root
        raise Hcl2Error(f"unexpected token {val!r}")


def eval_expr(src: str, scope: Dict) -> Any:
    return _ExprParser(_tokenize(src), scope).parse()


_INTERP = re.compile(r"\$\{([^{}]+)\}")


def _is_runtime(expr: str) -> bool:
    e = expr.strip()
    return e.startswith(_RUNTIME_ROOTS)


def interpolate_value(s: str, scope: Dict) -> Any:
    """Evaluate ${...} segments in a string. A string that is exactly
    one expression returns the typed value (cty semantics); mixed text
    concatenates. Runtime interpolations pass through."""
    if "${" not in s:
        return s
    m = _INTERP.fullmatch(s)
    if m is not None:
        if _is_runtime(m.group(1)):
            return s
        return eval_expr(m.group(1), scope)

    def sub(m: re.Match) -> str:
        if _is_runtime(m.group(1)):
            return m.group(0)
        v = eval_expr(m.group(1), scope)
        return str(v)

    return _INTERP.sub(sub, s)


# -- dynamic block expansion -------------------------------------------
def _expand_dynamic(body: dict, scope: Dict) -> dict:
    """Terraform-style dynamic blocks: dynamic "tag" { for_each,
    labels, content {} } -> repeated "tag" blocks with each.* bound."""
    dyn = body.pop("dynamic", None)
    if dyn is None:
        return body
    for label, variants in (dyn or {}).items():
        variants = variants if isinstance(variants, list) else [variants]
        for spec in variants:
            items = _walk(spec.get("for_each"), scope)
            if isinstance(items, dict):
                pairs = list(items.items())
            else:
                pairs = list(enumerate(items or []))
            out = []
            labeled = {}
            for k, v in pairs:
                each = {"key": k, "value": v}
                inner_scope = {**scope, "each": each, label: each}
                content = _walk_dict(dict(spec.get("content") or {}),
                                     inner_scope)
                labels = spec.get("labels")
                if labels:
                    lbls = [_walk(x, inner_scope) for x in labels]
                    tgt = labeled
                    for lbl in lbls[:-1]:
                        tgt = tgt.setdefault(str(lbl), {})
                    tgt[str(lbls[-1])] = content
                else:
                    out.append(content)
            existing = body.get(label)
            if labeled:
                merged = dict(existing) if isinstance(existing, dict) else {}
                merged.update(labeled)
                body[label] = merged
            elif out:
                if existing is None:
                    body[label] = out if len(out) > 1 else out[0]
                else:
                    cur = existing if isinstance(existing, list) \
                        else [existing]
                    body[label] = cur + out
    return body


def _walk_dict(d: dict, scope: Dict) -> dict:
    d = _expand_dynamic(d, scope)
    return {k: _walk(v, scope) for k, v in d.items()}


def _walk(v, scope: Dict):
    if isinstance(v, str):
        m = _BARE_REF.match(v)
        if m and m.group(1) in scope:
            return eval_expr(v, scope)
        return interpolate_value(v, scope)
    if isinstance(v, dict):
        return _walk_dict(dict(v), scope)
    if isinstance(v, list):
        return [_walk(x, scope) for x in v]
    return v


# -- entry --------------------------------------------------------------
def evaluate(parsed: dict,
             variables: Optional[Dict[str, Any]] = None) -> dict:
    """Evaluate variables/locals/expressions/dynamic blocks over a
    parsed HCL dict; returns the evaluated dict with the declaration
    blocks removed (jobspec2/parse.go decode ordering)."""
    parsed = dict(parsed)
    var_decls = parsed.pop("variable", {}) or {}
    values: Dict[str, Any] = {}
    for name, decl in var_decls.items():
        decl = decl if isinstance(decl, dict) else {}
        if variables and name in variables:
            values[name] = variables[name]
        elif "default" in decl:
            values[name] = decl["default"]
        else:
            raise Hcl2Error(f"missing value for required variable {name!r}")
    if variables:
        for name in variables:
            if name not in var_decls:
                raise Hcl2Error(f"undeclared variable {name!r}")

    scope: Dict[str, Any] = {"var": values}
    locals_blocks = parsed.pop("locals", None)
    if locals_blocks:
        blocks = locals_blocks if isinstance(locals_blocks, list) \
            else [locals_blocks]
        local_vals: Dict[str, Any] = {}
        scope["local"] = local_vals
        for blk in blocks:
            for k, v in (blk or {}).items():
                local_vals[k] = _walk(v, scope)
    return _walk_dict(parsed, scope)
