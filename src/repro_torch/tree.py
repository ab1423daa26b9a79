"""Nested containers of tensors ("trees"), flattened as `jax.tree_util`
flattens them: dict keys in sorted order, list and tuple items in order,
every other object a leaf (or, as jax's `is_leaf`, whatever a given
predicate accepts: an axes tuple, a spec).  The optimizer works on the flat leaves, and a
checkpoint names each leaf by its path, written as `jax.tree_util.keystr`
writes it (`['opt']['m']`, `['blocks'][0]`), so both packages give a
leaf of the same plain nested dict the same name."""
from __future__ import annotations


def leaves_with_paths(tree, path=(), is_leaf=None) -> list:
    """[(path, leaf)] in flattening order; a path is a tuple of dict keys
    and list indices."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], path + (k,), is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, path + (i,), is_leaf)]
    return [(path, tree)]


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def unflatten(tree, new_leaves, is_leaf=None):
    """`tree`'s structure holding `new_leaves` (in flattening order)."""
    it = iter(new_leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}       # the caller's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, is_leaf=None):
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree, is_leaf)],
                     is_leaf)
