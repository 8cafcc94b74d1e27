"""Nested trees of tensors (parameters, optimizer states, checkpoints), walked
as ``jax.tree_util`` walks the JAX package's trees: dict keys in sorted
order, NamedTuple fields in order, list and tuple items by index; ``None``
is an empty subtree. ``flatten`` names each leaf by its path as
``repro/checkpoint/store.py`` does (``blocks/attn/wq``, ``opt/.mu/embed``,
``opt/.count``), so checkpoints of either package carry the same keys.
"""
from __future__ import annotations


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree) -> list[tuple[str, object]] | None:
    """(key name, subtree) pairs of a node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if tree is None:
        return []
    return None


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out += flatten(sub, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def map_tree(fn, tree, *rest, is_leaf=None):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure;
    a node for which ``is_leaf`` is true is handed to ``fn`` whole."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kw = {"is_leaf": is_leaf}
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest), **kw) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, *xs, **kw) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs, **kw) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` leaf by leaf, the paths as ``flatten`` names them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), f"{prefix}/.{f}" if prefix
                                          else f".{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)
