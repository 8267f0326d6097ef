"""Trees of tensors: nested dicts, lists and tuples, flattened in the JAX
package's order (dict keys sorted, sequences in order), so a flat-buffer
layout (core/flatbuf.py) lists the leaves of a tree as the reference
does."""
from __future__ import annotations

_LEAF = object()


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _walk(t, out: list):
    if isinstance(t, dict):
        return {k: _walk(t[k], out) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(x, out) for x in t)
    out.append(t)
    return _LEAF


def flatten(tree):
    """tree -> (leaves, treedef). `treedef` is the tree with every leaf
    replaced by a marker; `unflatten` refills it. (Module-level recursion:
    a recursive closure would hold the leaves in a reference cycle, alive
    until the garbage collector runs.)"""
    leaves = []
    return leaves, _walk(tree, leaves)


def _fill(t, it):
    if isinstance(t, dict):
        return {k: _fill(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_fill(x, it) for x in t)
    return next(it)


def unflatten(treedef, leaves):
    it = iter(leaves)
    out = _fill(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
