"""Flat-key parameter trees (own copy of ``siammot_tpu.utils.checkpoint``'s
``_unflatten``)."""

from __future__ import annotations


def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": v}`` -> ``{"a": {"b": {"c": v}}}``."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
