"""Leaves of a parameter or state tree, by name.

The port's trees are ``nn.Module`` parameter trees (a model's
``nn.ModuleDict``) and nested dicts, lists, tuples and named tuples of
tensors, numpy arrays and Python scalars.  :func:`named_leaves` walks one
in a fixed order and names each leaf by its path: a module's parameters
in ``named_parameters`` order (its dotted name split into parts), a
dict's keys sorted (as ``jax.tree_util`` orders them), a sequence by
index, a named tuple by field.  ``None`` holds no leaf, as in the
reference's pytrees.  :func:`map_leaves` rebuilds a tree leaf by leaf
(a checkpoint's restore, a state's placement on a mesh);
:func:`by_dotted_name` looks leaves up by their dotted path.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["named_leaves", "map_leaves", "by_dotted_name"]


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


def by_dotted_name(tree) -> dict:
    """{path joined by ".": leaf}: a module's parameter and the same leaf
    kept in a dict under its dotted ``named_parameters`` name map alike
    (how a shardings tree names the parameters of a state)."""
    return {".".join(path): leaf for path, leaf in named_leaves(tree)}


def map_leaves(tree, fn, prefix: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (paths as
    :func:`named_leaves` gives them).  A module's parameters are written
    in place: copied into where ``fn`` keeps the device and dtype, their
    data replaced where it moves them; the module itself is returned."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, p in tree.named_parameters():
                new = fn(prefix + tuple(name.split(".")), p)
                if new is p:
                    continue
                if new.device == p.device and new.dtype == p.dtype:
                    p.copy_(new)
                else:
                    p.data = new
        return tree
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(getattr(tree, k), fn, prefix + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
