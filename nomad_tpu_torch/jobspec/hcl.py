"""A compact HCL parser covering the jobspec grammar.

Reference: jobspec/parse.go consumes HCL1; jobspec2/ consumes HCL2.
This implements the common subset both accept for job files: blocks
(`job "name" { ... }`), attributes (`key = value`), strings with
escapes, numbers, bools, lists, objects, heredocs, comments (#, //,
/* */), and duration-literal passthrough (durations stay strings for
the caller to interpret).

Output shape matches hashicorp/hcl's JSON form: a block `b "x" "y" {..}`
becomes nested dicts {"b": {"x": {"y": {...}}}}; repeated blocks
accumulate into lists.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class HclError(ValueError):
    pass


class _Lexer:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.line = 1

    def error(self, msg: str):
        raise HclError(f"line {self.line}: {msg}")

    def _peek(self, offset=0) -> str:
        j = self.i + offset
        return self.src[j] if j < len(self.src) else ""

    def _advance(self) -> str:
        ch = self.src[self.i]
        self.i += 1
        if ch == "\n":
            self.line += 1
        return ch

    def skip_ws(self, skip_newlines=True):
        while self.i < len(self.src):
            ch = self._peek()
            if ch in " \t\r" or (skip_newlines and ch == "\n"):
                self._advance()
            elif ch == "#" or (ch == "/" and self._peek(1) == "/"):
                while self.i < len(self.src) and self._peek() != "\n":
                    self._advance()
            elif ch == "/" and self._peek(1) == "*":
                self._advance(); self._advance()
                while self.i < len(self.src):
                    if self._peek() == "*" and self._peek(1) == "/":
                        self._advance(); self._advance()
                        break
                    self._advance()
                else:
                    self.error("unterminated block comment")
            else:
                return

    def next_token(self) -> Tuple[str, Any]:
        """Returns (kind, value). Kinds: ident, string, number, bool,
        lbrace, rbrace, lbracket, rbracket, assign, comma, newline,
        heredoc, eof."""
        self.skip_ws(skip_newlines=False)
        if self.i >= len(self.src):
            return ("eof", None)
        ch = self._peek()
        if ch == "\n":
            self._advance()
            return ("newline", None)
        if ch == "{":
            self._advance()
            return ("lbrace", None)
        if ch == "}":
            self._advance()
            return ("rbrace", None)
        if ch == "[":
            self._advance()
            return ("lbracket", None)
        if ch == "]":
            self._advance()
            return ("rbracket", None)
        if ch == "=":
            self._advance()
            return ("assign", None)
        if ch == ",":
            self._advance()
            return ("comma", None)
        if ch == ":":
            self._advance()
            return ("colon", None)
        if ch == '"':
            return ("string", self._string())
        if ch == "<" and self._peek(1) == "<":
            return ("heredoc", self._heredoc())
        if ch.isdigit() or (ch == "-" and self._peek(1).isdigit()):
            return self._number_or_duration()
        if ch.isalpha() or ch == "_":
            ident = self._ident()
            if ident == "true":
                return ("bool", True)
            if ident == "false":
                return ("bool", False)
            if ident == "null":
                return ("null", None)
            return ("ident", ident)
        self.error(f"unexpected character {ch!r}")

    def _string(self) -> str:
        self._advance()  # opening quote
        out = []
        while True:
            if self.i >= len(self.src):
                self.error("unterminated string")
            ch = self._advance()
            if ch == '"':
                return "".join(out)
            if ch == "\\":
                esc = self._advance()
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                            "r": "\r"}.get(esc, esc))
            else:
                out.append(ch)

    def _heredoc(self) -> str:
        self._advance(); self._advance()  # <<
        indent = False
        if self._peek() == "-":
            self._advance()
            indent = True
        marker = []
        while self.i < len(self.src) and self._peek() not in "\n":
            marker.append(self._advance())
        marker_s = "".join(marker).strip()
        if self._peek() == "\n":
            self._advance()
        lines: List[str] = []
        while True:
            if self.i >= len(self.src):
                self.error(f"unterminated heredoc <<{marker_s}")
            start = self.i
            while self.i < len(self.src) and self._peek() != "\n":
                self._advance()
            line = self.src[start:self.i]
            if self._peek() == "\n":
                self._advance()
            if line.strip() == marker_s:
                break
            lines.append(line)
        if indent:
            strip = min((len(l) - len(l.lstrip()) for l in lines if l.strip()),
                        default=0)
            lines = [l[strip:] for l in lines]
        return "\n".join(lines) + ("\n" if lines else "")

    def _number_or_duration(self):
        start = self.i
        if self._peek() == "-":
            self._advance()
        while self.i < len(self.src) and (self._peek().isdigit()
                                          or self._peek() in ".eE+-"):
            # stop at duration suffixes
            if self._peek() in "eE" and not self._peek(1).isdigit() \
                    and self._peek(1) not in "+-":
                break
            if self._peek() in "+-" and self.src[self.i - 1] not in "eE":
                break
            self._advance()
        text = self.src[start:self.i]
        # duration suffix? (5s, 10m, 300ms, 1h30m)
        if self.i < len(self.src) and (self._peek().isalpha()):
            while self.i < len(self.src) and (self._peek().isalnum()):
                self._advance()
            return ("string", self.src[start:self.i])
        try:
            if any(c in text for c in ".eE"):
                return ("number", float(text))
            return ("number", int(text))
        except ValueError:
            self.error(f"bad number {text!r}")

    def _ident(self) -> str:
        start = self.i
        while self.i < len(self.src) and (self._peek().isalnum()
                                          or self._peek() in "_-."):
            self._advance()
        return self.src[start:self.i]


class _Parser:
    def __init__(self, src: str):
        self.lex = _Lexer(src)
        self._pushed: Optional[Tuple[str, Any]] = None

    def _next(self, skip_newlines=False) -> Tuple[str, Any]:
        if self._pushed is not None:
            tok = self._pushed
            self._pushed = None
            if not (skip_newlines and tok[0] == "newline"):
                return tok
        while True:
            tok = self.lex.next_token()
            if skip_newlines and tok[0] == "newline":
                continue
            return tok

    def _push(self, tok: Tuple[str, Any]):
        self._pushed = tok

    def parse(self) -> dict:
        body = self._body(top=True)
        return body

    def _body(self, top=False) -> dict:
        out: dict = {}
        while True:
            tok = self._next(skip_newlines=True)
            if tok[0] == "eof":
                if not top:
                    self.lex.error("unexpected EOF inside block")
                return out
            if tok[0] == "rbrace":
                if top:
                    self.lex.error("unexpected '}'")
                return out
            if tok[0] not in ("ident", "string"):
                self.lex.error(f"expected identifier, got {tok[0]}")
            key = tok[1]
            self._statement(out, key)

    def _statement(self, out: dict, key: str):
        labels: List[str] = []
        while True:
            tok = self._next()
            if tok[0] == "assign":
                value = self._value()
                self._set_attr(out, key, value)
                return
            if tok[0] == "string" or tok[0] == "ident":
                labels.append(tok[1])
                continue
            if tok[0] == "lbrace":
                block = self._body()
                self._set_block(out, key, labels, block)
                return
            self.lex.error(f"expected '=', label or '{{' after {key!r}, "
                           f"got {tok[0]}")

    @staticmethod
    def _set_attr(out: dict, key: str, value):
        out[key] = value

    @staticmethod
    def _set_block(out: dict, key: str, labels: List[str], block: dict):
        target = out
        path = [key] + labels
        for part in path[:-1]:
            nxt = target.get(part)
            if not isinstance(nxt, dict) or part not in target:
                nxt = target.setdefault(part, {})
            if isinstance(nxt, list):
                # mixed labeled/unlabeled: append dict container
                container = {}
                nxt.append(container)
                nxt = container
            target = nxt
        last = path[-1]
        existing = target.get(last)
        if existing is None:
            target[last] = block
        elif isinstance(existing, list):
            existing.append(block)
        else:
            target[last] = [existing, block]

    def _value(self):
        tok = self._next(skip_newlines=True)
        kind, val = tok
        if kind in ("string", "number", "bool", "heredoc"):
            return val
        if kind == "null":
            return None
        if kind == "ident":
            return val  # bare word treated as string
        if kind == "lbracket":
            return self._list()
        if kind == "lbrace":
            return self._object()
        self.lex.error(f"unexpected {kind} in value position")

    def _list(self) -> list:
        out = []
        while True:
            tok = self._next(skip_newlines=True)
            if tok[0] == "rbracket":
                return out
            if tok[0] == "comma":
                continue
            self._push(tok)
            out.append(self._value())

    def _object(self) -> dict:
        out = {}
        while True:
            tok = self._next(skip_newlines=True)
            if tok[0] == "rbrace":
                return out
            if tok[0] == "comma":
                continue
            if tok[0] not in ("ident", "string"):
                self.lex.error(f"expected key in object, got {tok[0]}")
            key = tok[1]
            eq = self._next(skip_newlines=True)
            if eq[0] not in ("assign", "colon"):
                self.lex.error("expected '=' or ':' in object")
            out[key] = self._value()


def parse_hcl(src: str) -> dict:
    return _Parser(src).parse()
