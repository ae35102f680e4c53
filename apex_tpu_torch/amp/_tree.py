"""The small tree walk of the amp layer: nested dicts, lists, tuples and
NamedTuples of tensors and other leaves, as the JAX package's pytrees.

A path is the tuple of components from the root to a leaf: a dict key, a
NamedTuple field name, or a list or tuple index.  Leaves come in the JAX
order: dict keys sorted, sequences and NamedTuple fields in order.
``tree_flatten`` is :func:`apex_tpu_torch.utils.tree.tree_flatten`, the
port's one flatten (``None`` an empty subtree, as in JAX).
"""

from __future__ import annotations

from typing import Any, Callable, List

from apex_tpu_torch.utils.tree import _is_namedtuple, tree_flatten

__all__ = ["tree_map_with_path", "tree_map", "tree_leaves", "tree_flatten"]


def tree_map_with_path(fn: Callable[..., Any], tree, *rest, path=()):
    """``fn(path, leaf, *leaves_of_rest)`` over every leaf of ``tree``;
    the trees of ``rest`` have its structure.  The containers are rebuilt
    with ``tree``'s types."""
    if isinstance(tree, dict):
        return type(tree)(
            (k, tree_map_with_path(fn, v, *(r[k] for r in rest),
                                   path=path + (k,)))
            for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (f,))
            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` over every leaf."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
