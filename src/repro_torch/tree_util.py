"""Nested containers of tensors ("trees") in `jax.tree_util`'s order,
and `block_until_ready`.

The training state mirrors the JAX package's pytrees, and checkpoints
store one file per leaf in flattening order, so the two packages must
agree on that order to read each other's checkpoints: dict keys sorted,
`NamedTuple` fields and tuple/list items in order, `None` and empty
containers without leaves.  Everything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


class TreeDef:
    """The structure of a tree with its leaves taken out."""

    def __init__(self, node):
        self._node = node   # ("leaf",) | (kind, keys, children)

    def __str__(self) -> str:
        def show(node):
            if node[0] == "leaf":
                return "*"
            kind, keys, kids = node
            if kind is None:
                return "None"
            if kind is dict:
                return "{" + ", ".join(f"{k!r}: {show(c)}" for k, c in zip(keys, kids)) + "}"
            inner = ", ".join(show(c) for c in kids)
            return f"{kind.__name__}({inner})"

        return show(self._node)

    def unflatten(self, leaves: List[Any]):
        it = iter(leaves)

        def build(node):
            if node[0] == "leaf":
                return next(it)
            kind, keys, kids = node
            if kind is None:
                return None
            if kind is dict:
                return {k: build(c) for k, c in zip(keys, kids)}
            vals = [build(c) for c in kids]
            return kind(*vals) if hasattr(kind, "_fields") else kind(vals)

        out = build(self._node)
        if next(it, None) is not None:
            raise ValueError("more leaves than the tree holds")
        return out


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        if isinstance(node, (tuple, list)):
            return (type(node), None, [walk(c) for c in node])
        if node is None:
            return (None, None, [])
        leaves.append(node)
        return ("leaf",)

    return leaves, TreeDef(walk(tree))


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """`jax.tree.map`: `fn` over the leaves of `tree` and, leaf for leaf,
    of `rest` (trees of the same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(flat, *others)])


def block_until_ready(tree):
    """`jax.block_until_ready`: wait until the work that produces the
    tree's tensors is done (a card's whole queue; CPU tensors are ready
    when they exist).  Returns the tree."""
    for dev in {x.device for x in leaves(tree) if isinstance(x, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree
