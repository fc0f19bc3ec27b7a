"""Minimal yacs-style config node (own copy of ``siammot_tpu.configs.node``).

Attribute access, ``merge_from_file``, ``merge_from_list`` and ``clone``,
so the reference's YAML overlays translate 1:1.  The machine with the
card has no ``yaml``, so ``merge_from_file`` reads the recipes with
:func:`read_yaml`, a reader of the YAML subset the repo's recipes use.
"""

from __future__ import annotations

import ast
import copy
import json
import re
from typing import Any


class CfgNode(dict):
    """A dict with attribute access and YAML merge support."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def _merge_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], CfgNode):
                    self[k] = CfgNode()
                self[k]._merge_dict(v)
            else:
                if isinstance(v, str):
                    v = _maybe_literal(v)
                if isinstance(v, list):
                    v = tuple(v)
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        """Merge a YAML recipe (:func:`read_yaml`); unknown keys merge as
        new nodes, as in ``siammot_tpu.configs.node``."""
        data = read_yaml(path)
        if data:
            self._merge_dict(data)

    def merge_from_list(self, opts: list) -> None:
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key {key}")
            if isinstance(value, str):
                value = _maybe_literal(value)
            if isinstance(value, list):
                value = tuple(value)
            node[parts[-1]] = value


def _maybe_literal(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


# -- a reader for the YAML subset of the repo's recipes ----------------------

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": float("inf"), "+.inf": float("inf"),
                   "-.inf": float("-inf"), ".nan": float("nan")}
_NULL = {"~", "null", "Null", "NULL"}
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False,
         "False": False, "FALSE": False}
# plain scalars YAML 1.1 would read as something else than the above
_AMBIGUOUS = re.compile(
    r"^([yY]|[yY]es|YES|[nN]|[nN]o|NO|[oO]n|ON|[oO]ff|OFF"
    r"|[-+]?0[0-9_]+|[-+]?0[xXoObB].*|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+"
    r"|[-+]?[0-9][0-9_]*_[0-9_]*|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*"
    r"|[-+]?(\.[iI][nN][fF]|\.[nN][aA][nN])|.*[0-9]\.[0-9_]*_.*)$")


class YamlSubsetError(ValueError):
    """A recipe line outside the YAML subset :func:`read_yaml` reads."""


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (one at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str, in_list: bool = False) -> Any:
    """One scalar as ``yaml.safe_load`` reads it, for the subset: quoted
    strings, null, true/false, decimal ints and floats, plain strings."""
    if text.startswith('"'):
        if len(text) < 2 or not text.endswith('"'):
            raise YamlSubsetError(f"{where}: unterminated string {text!r}")
        try:
            return json.loads(text)
        except ValueError as e:
            raise YamlSubsetError(f"{where}: string {text!r}: {e}") from e
    if text.startswith("'"):
        body = text[1:-1]
        if len(text) < 2 or not text.endswith("'") \
                or "'" in body.replace("''", ""):
            raise YamlSubsetError(f"{where}: bad quoted string {text!r}")
        return body.replace("''", "'")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _AMBIGUOUS.match(text):
        raise YamlSubsetError(f"{where}: {text!r} has a YAML 1.1 meaning "
                              f"outside the subset; quote it")
    bad = "[]{},&*!|>%@`\"'" if in_list else "[]{}&*!|>%@`\"'"
    if text[0] in bad or text[0] in "-?:" or ": " in text \
            or text.endswith(":") or (in_list and any(c in text for c in
                                                      "[]{}")):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML "
                              f"subset")
    return text


def _flow_list(text: str, where: str) -> list:
    """``[a, b, ...]`` of scalars (no nesting)."""
    body = text[1:-1].strip()
    if not body:
        return []
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "\"'" and not cur.strip():
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if quote:
        raise YamlSubsetError(f"{where}: unterminated string in {text!r}")
    items.append(cur.strip())
    if any(not it for it in items):
        raise YamlSubsetError(f"{where}: empty list item in {text!r}")
    return [_scalar(it, where, in_list=True) for it in items]


def _value(text: str, where: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: list {text!r} must close on "
                                  f"its line")
        return _flow_list(text, where)
    return _scalar(text, where)


def read_yaml(path: str) -> Any:
    """Read a YAML recipe without ``yaml``: the subset the repo's recipes
    use, read as ``yaml.safe_load`` reads it.  Nested mappings by
    indentation (spaces), ``#`` comments, quoted and plain scalars
    (strings, ints, floats, true/false, null), ``[a, b]`` lists of
    scalars; ``(a, b)`` tuples stay strings, as in YAML (``CfgNode``
    turns them into tuples when it merges).  Anything else (block lists,
    flow mappings, anchors, tags, multi-line scalars, tabs, duplicate
    keys, plain scalars that YAML 1.1 reads as octal, sexagesimal, dates
    or yes/no booleans) raises :class:`YamlSubsetError` with the file and
    line.  An empty file gives None."""
    root: dict = {}
    # open mappings: (indent of the key that opened it, mapping, indent of
    # its own keys or None until the first)
    stack = [[-1, root, None]]
    pending = None             # (indent, mapping, key) of a bare "key:"
    with open(path) as f:
        lines = f.read().splitlines()
    for lineno, raw in enumerate(lines, 1):
        where = f"{path}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        lead = line[:len(line) - len(line.lstrip())]
        if "\t" in lead:
            raise YamlSubsetError(f"{where}: tab in the indentation")
        indent, text = len(lead), line.strip()
        if text in ("---", "...") or text.startswith(("- ", "? ")) \
                or text == "-":
            raise YamlSubsetError(f"{where}: {text!r} is outside the YAML "
                                  f"subset (documents, block lists, "
                                  f"complex keys)")
        m = _KEY.match(text)
        if not m:
            raise YamlSubsetError(f"{where}: expected 'KEY: value', got "
                                  f"{text!r}")
        key, val = m.group(1), (m.group(2) or "").strip()
        if pending is not None:
            p_indent, p_map, p_key = pending
            if indent > p_indent:
                child: dict = {}
                p_map[p_key] = child
                stack.append([p_indent, child, None])
            pending = None
        while indent <= stack[-1][0]:
            stack.pop()
        top = stack[-1]
        if top[2] is None:
            top[2] = indent
        elif top[2] != indent:
            raise YamlSubsetError(f"{where}: indentation {indent} does not "
                                  f"match its mapping's {top[2]}")
        if key in top[1]:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if _INT.match(key) or key in _BOOL or key in _NULL:
            raise YamlSubsetError(f"{where}: key {key!r} is not a plain "
                                  f"string")
        if val:
            top[1][key] = _value(val, where)
        else:
            top[1][key] = None          # a mapping if indented lines follow
            pending = (indent, top[1], key)
    return root or None
