"""Plain walks over diff trees: nested dicts, lists and tuples whose
leaves are numpy arrays or scalars. They take the place of the
``jax.tree_util`` walks in the JAX package's mix plane, with the same
leaf order: dict keys sorted, sequences in order, ``None`` an empty
subtree.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in jax.tree_util order."""
    out: List[Any] = []

    def walk(node: Any) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(tree)
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over ``tree`` and the trees in ``rest``,
    which must have its structure; the result has it too."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys()
               for r in rest):
            raise ValueError("tree structures differ")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree)
               for r in rest):
            raise ValueError("tree structures differ")
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)
