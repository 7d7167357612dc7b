"""The port's param trees: nested dicts and lists with tensors at the leaves
(the LM keeps one dict per layer in a list); anything else, a tuple
included, is a leaf. What jax.tree does for the
reference's pytrees, for these: map over leaves in order, list them, and
name each by its path, dict keys and list indices joined by "/"
("blocks/3/ffn/bin_in/w_latent")."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure) -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_dicts_with(key: str, fn, tree):
    """``tree`` with ``fn`` applied to each dict that holds ``key``, found
    through dicts and lists. Every other node is rebuilt around the same
    leaves."""
    if isinstance(tree, dict):
        if key in tree:
            return fn(tree)
        return {k: map_dicts_with(key, fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_dicts_with(key, fn, v) for v in tree]
    return tree


def map_binary_denses(fn, tree):
    """``fn`` on each binary dense: each dict that holds a ``w_latent`` leaf
    (core/binary_dense.py)."""
    return map_dicts_with("w_latent", fn, tree)


def map_binary_moe(fn, tree):
    """``fn`` on each binary MoE layer: each dict that holds ``s_mid``
    beside its expert stacks (models/moe.py)."""
    return map_dicts_with("s_mid", fn, tree)


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)] in tree_map's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure with ``leaves`` (in tree_map's order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
