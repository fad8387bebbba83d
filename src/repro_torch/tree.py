"""Trees of tensors: nested dicts, lists and tuples, walked in JAX's order
(``jax.tree`` flattens dicts by sorted key and lists in order), so that leaf
i is the same leaf in both packages. The one walker of the port: the paged
cache, the engine, the optimizer and the checkpoints all flatten here."""
from __future__ import annotations

__all__ = ["flatten", "unflatten", "tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]


def flatten(tree, paths: list | None = None, is_leaf=None):
    """(leaves, spec) of ``tree``; ``unflatten(spec, leaves)`` rebuilds it.
    With ``paths`` given, each leaf's keys and indices joined with "/"
    (``groups/0/sub0/ffn/w1``, as the reference's checkpoints name them)
    are appended to it in the same order. ``is_leaf(node)`` True stops the
    walk at a node (a ``PartitionSpec``, itself a tuple)."""
    leaves = []
    return leaves, _flatten_into(tree, leaves, paths, "", is_leaf)


def _flatten_into(t, leaves: list, paths, prefix: str, is_leaf=None):
    # a module-level recursion: a nested recursive function would form a
    # reference cycle holding ``leaves`` (a step's 0.6 GB batch view at full
    # width) until the cyclic garbage collector runs
    if is_leaf is None or not is_leaf(t):
        if isinstance(t, dict):
            return {k: _flatten_into(t[k], leaves, paths, f"{prefix}{k}/", is_leaf)
                    for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(_flatten_into(v, leaves, paths, f"{prefix}{i}/", is_leaf)
                           for i, v in enumerate(t))
    leaves.append(t)
    if paths is not None:
        paths.append(prefix[:-1])
    return len(leaves) - 1


def unflatten(spec, leaves):
    if isinstance(spec, dict):
        return {k: unflatten(v, leaves) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(unflatten(v, leaves) for v in spec)
    return leaves[spec]


def tree_leaves(tree) -> list:
    return flatten(tree)[0]


def tree_paths(tree) -> list:
    """(path, leaf) pairs in ``tree_leaves`` order (see ``flatten``)."""
    paths = []
    leaves, _ = flatten(tree, paths)
    return list(zip(paths, leaves))


def tree_map(fn, tree):
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(leaf) for leaf in leaves])


def tree_unflatten(tree, leaves: list):
    """``leaves``, in ``tree_leaves`` order, in the structure of ``tree``."""
    return unflatten(flatten(tree)[1], leaves)
