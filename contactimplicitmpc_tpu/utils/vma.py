"""Varying-manual-axes (VMA) helper for shard_map compatibility.

Under ``jax.shard_map`` every loop carry must have consistent
device-varying types: a carry seeded from a compile-time constant (an
iteration counter, a regularization scalar) is *unvarying* on entry but
becomes *varying* once the body mixes it with sharded data, which
``lax.scan`` / ``lax.while_loop`` reject. ``unify_varying`` promotes all
leaves of a carry pytree to the union of the varying axes already present
— a no-op outside shard_map.
"""

from __future__ import annotations

import jax


def unify_varying(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    axes = set()
    for leaf in leaves:
        axes |= set(getattr(jax.typeof(leaf), "vma", frozenset()))
    if not axes:
        return tree

    def fix(x):
        vma = getattr(jax.typeof(x), "vma", frozenset())
        missing = tuple(a for a in axes if a not in vma)
        if not missing:
            return x
        return jax.lax.pcast(x, missing, to="varying")

    return jax.tree_util.tree_map(fix, tree)
