"""Walking nested NamedTuples of tensors (the port's state containers)."""
from __future__ import annotations


def _is_node(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply fn leaf by leaf over one or more NamedTuple trees of the same
    structure; returns a tree of the first one's types."""
    if _is_node(tree):
        return type(tree)(*[
            tree_map(fn, getattr(tree, f), *[getattr(r, f) for r in rest])
            for f in tree._fields])
    return fn(tree, *rest)


def tree_leaves(tree, prefix=None):
    """The leaves of a NamedTuple tree in field order (JAX's flatten order);
    with a prefix (a string), (dotted field path, leaf) pairs instead."""
    out = []
    for f, x in zip(tree._fields, tree):
        path = None if prefix is None else f"{prefix}{f}."
        if _is_node(x):
            out += tree_leaves(x, path)
        else:
            out.append(x if prefix is None else (path[:-1], x))
    return out


def tree_leaves_with_path(tree):
    """[(dotted field path, leaf)] in field order."""
    return tree_leaves(tree, "")
