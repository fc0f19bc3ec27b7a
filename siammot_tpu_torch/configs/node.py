"""Minimal yacs-style config node (own copy of ``siammot_tpu.configs.node``).

Attribute access, ``merge_from_file``, ``merge_from_list`` and ``clone``,
so the reference's YAML overlays translate 1:1.  ``yaml`` is imported
only inside ``merge_from_file``: the inference path never reads a file,
and the machine with the card has no ``yaml``.
"""

from __future__ import annotations

import ast
import copy
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
        import yaml  # lazy: not installed where the port runs on the card
        with open(path) as f:
            data = yaml.safe_load(f)
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
