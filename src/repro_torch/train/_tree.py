"""Trees of tensors: dicts, lists, tuples and dataclasses of tensors (the
LM's parameters, the AdamW state, a checkpointed carry). Dict keys are
visited sorted, the reference's ``jax.tree.leaves`` order; a leaf is named
by its path, the keys joined with dots (``layers.3.attn.wq``)."""
from __future__ import annotations

import dataclasses
from typing import Callable


def _children(node) -> dict | None:
    """A node's named children, or None for a leaf."""
    if isinstance(node, dict):
        return {str(k): node[k] for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return {str(i): v for i, v in enumerate(node)}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
    return None


def _walk(node, prefix, out):
    kids = _children(node)
    if kids is None:
        out[prefix] = node
        return
    for name, sub in kids.items():
        _walk(sub, f"{prefix}.{name}" if prefix else name, out)


def named_leaves(tree) -> dict:
    """{dotted path: leaf}, depth first. (Module-level recursion: a nested
    function that calls itself is a reference cycle, which would keep the
    leaves, a step's gradients among them, alive until Python's cycle
    collector runs.)"""
    out = {}
    _walk(tree, "", out)
    return out


def leaves(tree) -> list:
    return list(named_leaves(tree).values())


def _build(node, prefix, named):
    kids = _children(node)
    if kids is None:
        return named[prefix]
    built = {name: _build(sub, f"{prefix}.{name}" if prefix else name, named)
             for name, sub in kids.items()}
    if isinstance(node, dict):
        return {k: built[str(k)] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(built[str(i)] for i in range(len(node)))
    return type(node)(**built)


def rebuild(like, named: dict):
    """The leaves ``named`` by their paths, in the structure of ``like``."""
    return _build(like, "", named)


def unflatten(like, flat: list):
    """The leaves ``flat`` (in :func:`leaves` order) in the structure of ``like``."""
    return rebuild(like, dict(zip(named_leaves(like), flat, strict=True)))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of its structure
    in ``rest``, in a tree of that structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])
