"""Leaves of a parameter or state tree, by name.

The port's trees are ``nn.Module`` parameter trees (a model's
``nn.ModuleDict``) and nested dicts, lists, tuples and named tuples of
tensors, numpy arrays and Python scalars.  :func:`named_leaves` walks one
in a fixed order and names each leaf by its path: a module's parameters
in ``named_parameters`` order (its dotted name split into parts), a
dict's keys sorted (as ``jax.tree_util`` orders them), a sequence by
index, a named tuple by field.  ``None`` holds no leaf, as in the
reference's pytrees.
"""

from __future__ import annotations

from torch import nn

__all__ = ["named_leaves"]


def named_leaves(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)] of ``tree``; a path is a tuple of str keys."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [(prefix + tuple(name.split(".")), p)
                for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=str)
                for leaf in named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for k in tree._fields
                for leaf in named_leaves(getattr(tree, k), prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree)
                for leaf in named_leaves(t, prefix + (str(i),))]
    return [(prefix, tree)]
