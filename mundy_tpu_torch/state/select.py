"""Selector algebra: "(partA | partB) & !partC" -> boolean mask.

Port of mundy_tpu/state/select.py (ref: `StringToSelector.hpp` and its
lexer/parser/evaluator): union `|`, intersection `&` (binds tighter),
complement `!`, parentheses, evaluated against an EntitySet's part masks
and intersected with its active mask.
"""

from __future__ import annotations

import re

import torch

from mundy_tpu_torch.core.errors import MundyError
from mundy_tpu_torch.state.world import EntitySet

_TOKEN = re.compile(r"\s*([()&|!]|[A-Za-z_][A-Za-z0-9_.-]*)")


def _tokenize(expr: str):
    pos = 0
    tokens = []
    while pos < len(expr):
        m = _TOKEN.match(expr, pos)
        if not m:
            raise MundyError(f"selector: bad token at '{expr[pos:]}'")
        tokens.append(m.group(1))
        pos = m.end()
    return tokens


class _Parser:
    """Recursive descent: expr := term (('|'|'&') term)* ; term := '!' term |
    '(' expr ')' | name. & binds tighter than |."""

    def __init__(self, tokens, parts):
        self.tokens = tokens
        self.i = 0
        self.parts = parts

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def eat(self, tok=None):
        t = self.peek()
        if t is None or (tok is not None and t != tok):
            raise MundyError(f"selector: expected {tok or 'token'}, got {t}")
        self.i += 1
        return t

    def parse(self):
        out = self.parse_union()
        if self.peek() is not None:
            raise MundyError(f"selector: trailing tokens at '{self.peek()}'")
        return out

    def parse_union(self):
        left = self.parse_intersection()
        while self.peek() == "|":
            self.eat("|")
            left = left | self.parse_intersection()
        return left

    def parse_intersection(self):
        left = self.parse_unary()
        while self.peek() == "&":
            self.eat("&")
            left = left & self.parse_unary()
        return left

    def parse_unary(self):
        t = self.peek()
        if t == "!":
            self.eat("!")
            return ~self.parse_unary()
        if t == "(":
            self.eat("(")
            out = self.parse_union()
            self.eat(")")
            return out
        name = self.eat()
        if name in ("&", "|", ")"):
            raise MundyError(f"selector: unexpected '{name}'")
        if name not in self.parts:
            raise MundyError(
                f"selector: unknown part '{name}'; known: {sorted(self.parts)}")
        return self.parts[name]


def select(es: EntitySet, expr: str) -> torch.Tensor:
    """Evaluate a selector expression to a (capacity,) bool mask (active-only)."""
    mask = _Parser(_tokenize(expr), es.parts).parse()
    return mask & es.active
