"""JAX-style pytrees over dicts, tuples and lists, for the training path.

The reference keeps its parameters, gradients and optimizer state as
pytrees and flattens them with `jax.tree_util`: dict keys sorted, tuples
and lists in order, None an empty subtree.  The port flattens the same way,
so a checkpoint's leaves, their paths, and the order in which the global
gradient norm sums its leaves are the reference's.

The reference stacks each position of the layer pattern over the pattern's
cycles into one array; the port keeps one parameter a layer.  A `Stacked`
(a tuple of the per-cycle tensors) stands where the reference has a stacked
array: it is one leaf of the tree, so paths and order agree, and a
checkpoint writes it as the stacked array.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


class Stacked(tuple):
    """One leaf of the reference's tree held as its per-cycle slices (the
    reference's [n_cycles, ...] array is `torch.stack(self)`)."""

    def __repr__(self) -> str:
        return f"Stacked({list(self)!r})"


def _children(tree) -> List[Tuple[str, Any]]:
    """(path key, child) pairs of a node, as `tree_flatten_with_path`
    names them; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if type(tree) in (tuple, list):     # not a Stacked or a NamedTuple
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's order; a path reads as the reference's
    checkpoint manifest writes it ("['opt']/['mu']/['embed']")."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_paths(child, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """`jax.tree.map`: fn over the leaves of `tree` and the matching
    leaves of `rest` (same structure), called in flatten order;
    containers keep their type."""
    if tree is None:
        return None
    if _children(tree) is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in sorted(tree))
    return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                      for i, c in enumerate(tree))


def unflatten(tree, new_leaves: list):
    """`tree` with its leaves replaced, in order, by `new_leaves`."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def treedef_str(tree) -> str:
    """`str(jax.tree_util.tree_structure(tree))` of the same tree."""
    def node(t):
        if t is None:
            return "None"
        if _children(t) is None:
            return "*"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        inner = ", ".join(node(c) for c in t)
        if isinstance(t, list):
            return f"[{inner}]"
        return f"({inner},)" if len(t) == 1 else f"({inner})"
    return f"PyTreeDef({node(tree)})"


def members(leaf) -> tuple:
    """The tensors a leaf holds: a Stacked's slices, or the leaf itself."""
    return tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)
