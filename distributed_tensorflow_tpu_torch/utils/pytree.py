"""Nested-container trees in ``jax.tree`` order, without jax.

The port's trees are the JAX package's: nested dicts (and lists or tuples)
of arrays with flax's names, as :func:`..training.state.checkpoint_tree`
builds them.  These helpers walk them as ``jax.tree.leaves`` /
``flatten`` / ``unflatten`` / ``map`` walk a pytree of dicts, so that a
flat buffer built here lines up, leaf for leaf and byte for byte, with the
JAX package's: dict keys sorted at every level, sequences in order, and
``None`` an empty subtree (no leaves).
"""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    out: list = []
    _collect(tree, out)
    return out


def _collect(tree: Any, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _collect(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _collect(item, out)
    else:
        out.append(tree)


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; the treedef is the tree itself, which
    :func:`tree_unflatten` reads only for its structure."""
    return tree_leaves(tree), tree


def tree_unflatten(treedef: Any, leaves) -> Any:
    """A tree shaped like ``treedef`` with ``leaves`` in leaf order."""
    it = iter(leaves)
    out = _rebuild(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def _rebuild(node: Any, it) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        built = {key: _rebuild(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(item, it) for item in node)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree has")
    return leaf


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf-wise over trees of one structure (the first
    tree's)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    for other in others:
        if len(other) != len(leaves):
            raise ValueError(f"trees of {len(leaves)} and {len(other)} "
                             "leaves")
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order, the path's keys joined by ``/``
    (the JAX package's ``parallel.sharding.path_str``)."""
    out: list = []
    if tree is None:
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += tree_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            out += tree_paths(item, f"{prefix}{i}/")
    else:
        out.append((prefix[:-1], tree))
    return out
