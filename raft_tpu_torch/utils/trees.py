"""Byte-identical comparison of State-like trees: the one definition
behind every engine-differential gate of the port (triage, checkpoint
hops, the search's divergence reproducers), with the leaf-level report
that names the first divergent leaf.

A tree is a NamedTuple (walked by `_fields`), a tuple or list, a dict
(walked in sorted key order) or a leaf: a torch tensor, a numpy array
or a scalar. A None field is no leaf, so optional slots (PreVote
mailbox rows, client state, a Flight) do not shift leaf indices. Paths
and messages are those of the JAX package's `utils/trees.py`
(`.nodes.term`, `int32[8, 3]`): a tensor is compared as the numpy array
`sim.state.to_numpy` gives (int64 lanes are the u32 digests, read back
as uint32), so a reproducer artifact written by either package names
its leaf in the same words.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a
    return np.asarray(x)


def named_leaves(tree, path: str = ""):
    """(path, leaf) pairs in flatten order, paths as JAX's `keystr`
    writes them."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in named_leaves(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in named_leaves(v, f"{path}[{i}]")]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in named_leaves(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def trees_equal(a, b) -> bool:
    """True iff the two trees have the same leaf count and every leaf
    pair is byte-identical (np.array_equal semantics: NaN != NaN)."""
    ok, _ = trees_equal_why(a, b)
    return ok


def trees_equal_values(a, b) -> bool:
    """The values-only form: blind to integer/bool widths."""
    ok, _ = trees_equal_why(a, b, values_only=True)
    return ok


def leaf_mismatch(x, y, values_only: bool = False) -> str | None:
    """None when the two leaves are byte-identical; otherwise a one-line
    description with dtype, shape, the count of differing elements and
    the first differing index with both values.

    `values_only=True` compares integer/bool leaves by value through an
    exact int64 lift, so a narrow u16/i8 leaf can be held against its
    int32 twin; a shape mismatch, or a dtype mismatch that is not such a
    lift, still fails."""
    if (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and x.dtype == y.dtype and x.shape == y.shape
            and x.device == y.device and torch.equal(x, y)):
        return None   # the common case, without a copy to the host
    x, y = _as_numpy(x), _as_numpy(y)
    meta_x = f"{x.dtype}{list(x.shape)}"
    meta_y = f"{y.dtype}{list(y.shape)}"
    if x.shape != y.shape:
        return f"shape mismatch: {meta_x} vs {meta_y}"
    if x.dtype != y.dtype:
        int_like = all(np.issubdtype(d, np.integer)
                       or np.issubdtype(d, np.bool_)
                       for d in (x.dtype, y.dtype))
        if not (values_only and int_like):
            return f"dtype mismatch: {meta_x} vs {meta_y}"
        # int64 holds every integer dtype of a State (the widest lane is
        # u32) exactly.
        x, y = x.astype(np.int64), y.astype(np.int64)
    neq = x != y
    n_bad = int(np.count_nonzero(neq))
    if n_bad == 0:
        return None
    if neq.ndim == 0:
        return f"{meta_x}: {x!r} != {y!r}"
    first = np.unravel_index(int(np.argmax(neq)), neq.shape)
    idx = ",".join(str(int(i)) for i in first)
    return (f"{meta_x}: {n_bad}/{x.size} elements differ, first at "
            f"[{idx}]: {x[first]!r} != {y[first]!r}")


def trees_equal_why(a, b, names=None, values_only: bool = False):
    """(equal, why): `why` names the first divergent leaf by its path
    (`.nodes.log_term` for a State) with its dtype/shape and first
    differing element, or the leaf-count mismatch. `names` (e.g. a
    NamedTuple's `_fields`) overrides the path labels when given."""
    pa, pb = named_leaves(a), named_leaves(b)
    if len(pa) != len(pb):
        return False, f"leaf count {len(pa)} != {len(pb)}"
    for n, ((path, x), (_, y)) in enumerate(zip(pa, pb)):
        why = leaf_mismatch(x, y, values_only=values_only)
        if why is not None:
            if names and n < len(names):
                label = names[n]
            else:
                label = path or f"leaf {n}"
            return False, f"first divergent leaf: {label} — {why}"
    return True, ""
