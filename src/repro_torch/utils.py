"""Small shared utilities (the port's copy of `repro/utils/__init__.py`)."""
from __future__ import annotations

import logging
import sys
from typing import Any


def get_logger(name: str = "repro_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(name)s %(levelname)s] %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


# The port's pytrees: nested dicts, lists and tuples whose leaves are
# tensors or arrays (None is an empty subtree), walked as
# `jax.tree_util` walks them: dicts in sorted key order.


def module_tree(module) -> dict:
    """A module's parameters (the Parameters themselves) as a nested dict
    along their dotted names."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def tree_flatten_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)], each path the tuple of keys and indices down to it."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in tree_flatten_with_paths(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in tree_flatten_with_paths(x, prefix + (i,))]
    return [] if tree is None else [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves in `jax.tree_util.tree_leaves`' order; an `nn.Module`
    contributes its parameters."""
    if hasattr(tree, "parameters") and callable(tree.parameters):
        return list(tree.parameters())
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` and the same positions of ``rest``
    (trees of its structure, or with a subtree where ``tree`` has a leaf,
    as `jax.tree_util.tree_map` takes them), in ``tree``'s structure; fn
    is called in `tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_num_params(tree: Any) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
    return total


def human_count(n: float) -> str:
    for unit, div in (("T", 1e12), ("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f}{unit}"
    return str(int(n))
