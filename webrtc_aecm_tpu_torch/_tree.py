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


def tree_leaves_with_path(tree, prefix=""):
    """[(dotted field path, leaf)] in field order (JAX's flatten order for
    NamedTuples)."""
    if _is_node(tree):
        out = []
        for f in tree._fields:
            out += tree_leaves_with_path(getattr(tree, f),
                                         f"{prefix}{f}.")
        return out
    return [(prefix[:-1], tree)]

