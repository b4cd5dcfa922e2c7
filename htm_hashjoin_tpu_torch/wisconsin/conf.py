"""Parser for the libconfig subset used by the reference's ``.conf`` files.

The reference drives its multijoin binary with libconfig files
(mc/wisconsin-src/main.cpp:203-226; examples conf/000001_no.conf,
conf/002048_radix1.conf).  Vendoring libconfig would be pointless on the
Python side, so this is a ~100-line recursive-descent parser for exactly the
grammar those files use:

    setting   :=  NAME (':' | '=') value (';' | ',')?
    value     :=  scalar | group | list | array
    group     :=  '{' setting* '}'
    list      :=  '(' value (',' value)* ')'        # heterogeneous
    array     :=  '[' scalar (',' scalar)* ']'      # homogeneous
    scalar    :=  int | float | "string" | true | false
    comments  :=  '#...' | '//...' | '/* ... */'

Groups parse to dicts, lists/arrays to Python lists.  This makes the
reference's own conf files loadable verbatim.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<float>[-+]?(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<int>[-+]?\d+)
  | (?P<bool>\btrue\b|\bfalse\b)
  | (?P<name>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<punct>[:={}()\[\];,])
""", re.VERBOSE | re.DOTALL)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"conf parse error at char {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        tokens.append((kind, m.group()))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, text: str):
        kind, val = self.next()
        if val != text:
            raise ValueError(f"expected {text!r}, got {val!r}")

    def settings(self, until: str | None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            kind, val = self.peek()
            if kind is None or val == until:
                return out
            if kind != "name":
                raise ValueError(f"expected setting name, got {val!r}")
            self.next()
            kind, sep = self.next()
            if sep not in (":", "="):
                raise ValueError(f"expected ':' or '=' after {val!r}, got {sep!r}")
            out[val] = self.value()
            if self.peek()[1] in (";", ","):
                self.next()

    def value(self) -> Any:
        kind, val = self.peek()
        if val == "{":
            self.next()
            group = self.settings(until="}")
            self.expect("}")
            return group
        if val == "(":
            return self._seq("(", ")")
        if val == "[":
            return self._seq("[", "]")
        self.next()
        if kind == "string":
            return val[1:-1].encode().decode("unicode_escape")
        if kind == "int":
            return int(val)
        if kind == "float":
            return float(val)
        if kind == "bool":
            return val == "true"
        if kind == "name":  # bare word (libconfig disallows it; be lenient)
            return val
        raise ValueError(f"unexpected token {val!r}")

    def _seq(self, open_: str, close: str) -> List[Any]:
        self.expect(open_)
        items: List[Any] = []
        while self.peek()[1] != close:
            items.append(self.value())
            if self.peek()[1] == ",":
                self.next()
        self.expect(close)
        return items


def parse_conf_string(text: str) -> Dict[str, Any]:
    """Parse libconfig text to a nested dict."""
    return _Parser(_tokenize(text)).settings(until=None)


def parse_conf(path: str) -> Dict[str, Any]:
    """Parse a libconfig ``.conf`` file (the format of
    mc/wisconsin-src/conf/*.conf)."""
    with open(path) as f:
        return parse_conf_string(f.read())
