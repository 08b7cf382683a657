"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors
(or arrays), walked in jax's flatten order — dict keys sorted, sequences in
index order — so that the port's leaves line up with the JAX package's."""

from __future__ import annotations


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def seq_like(node, items):
    """A list, tuple or NamedTuple of ``node``'s type holding ``items``."""
    items = list(items)
    return type(node)(*items) if is_namedtuple(node) else type(node)(items)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def fill_like(template, new_leaves):
    """``template``'s structure (empty containers included) with its leaves
    replaced, in flatten order, by ``new_leaves``."""
    it = iter(new_leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return seq_like(node, (walk(v) for v in node))
        return next(it)

    out = walk(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-structured ``rest``),
    rebuilt in ``tree``'s structure."""
    columns = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return fill_like(tree, [fn(*xs) for xs in zip(*columns)])
