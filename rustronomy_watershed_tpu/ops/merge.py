"""Region merging for the merging (void-filling) watershed variant.

Replaces the reference's ``find_merge`` (pair detection via 3x3 windows,
/root/reference/src/lib.rs:393-445), the serial quadratic connected-component
union ``make_colour_map`` (src/lib.rs:467-542) and the LUT ``recolour``
(src/lib.rs:589-592) with a device pipeline:

1. **Adjacency scatter-min** — for every interior coloured pixel, the minimum
   differently-coloured 4-neighbour label is scatter-min'ed into a per-label
   table ``adj`` (one fused stencil + scatter, no dynamic pair list).
2. **Hook** — ``parent[u] = min(parent[u], parent[adj[u]])``.
3. **Pointer jumping** — ``parent = parent[parent]`` to a fixed point
   (log-depth path compression).
4. Repeat 1-3 until no differently-labelled adjacent coloured pairs remain.
   (A single min-adjacency per label can drop edges of the label-adjacency
   graph, so re-deriving adjacency from the compressed labels each round is
   required for transitive correctness; each round strictly lowers some root,
   so the loop terminates, in practice in O(log) rounds.)

Merged label id is pinned to **min-label-wins**.  The reference uses "first
element of the merge-set" (src/lib.rs:539) which is the sorted minimum in the
common single-region branch (src/lib.rs:513) but not guaranteed after
two-region appends; this rebuild pins the deterministic min rule (SURVEY.md
Q9).  Pixels with label 0 (UNCOLOURED) never participate, preserving the
``colours[UNCOLOURED] == UNCOLOURED`` invariant (src/lib.rs:1461).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INT32_MAX, UNCOLOURED
from .stencil import interior_mask, roll4

_BIG = np.int32(INT32_MAX)


def _pointer_jump(parent: jnp.ndarray) -> jnp.ndarray:
    """Compress ``parent`` until parent == parent[parent] (log depth)."""

    def cond(state):
        p, changed = state
        return changed

    def body(state):
        p, _ = state
        p2 = p[p]
        return p2, jnp.any(p2 != p)

    parent, _ = jax.lax.while_loop(cond, body, (parent, jnp.bool_(True)))
    return parent


def _adjacency_min(cur: jnp.ndarray, n_labels: int) -> jnp.ndarray:
    """Per-label min partner over the reference's merge pairs.

    ``cur`` is the current (compressed) label image.  Returns ``adj`` of shape
    (n_labels + 1,), with INT32_MAX where a label touches no other label.
    Pairs follow the reference's window semantics exactly (src/lib.rs:
    411-436): one pair per (interior coloured centre, differing coloured
    4-neighbour) — the NEIGHBOUR may be a border pixel (a 3x3 window centred
    next to the border still sees it), but two *border* pixels are never
    paired (no window is centred on a border pixel, SURVEY.md §2 #5).

    Every pair is scattered into BOTH labels' table entries: the reference's
    ``Merge([own, other])`` lowers both sides to the set minimum, and the
    one-directional hook ``parent[u] <- parent[adj[u]]`` only converges when
    each pair is visible from each side.  Centre-centre pairs are symmetric
    by construction; centre-border pairs are NOT (the border label has no
    centre of its own), which under-merged user-painted border seeds until
    r8 — caught by tests/test_component_shortcut.py's border-seed case.
    """
    valid = (cur != UNCOLOURED) & interior_mask(cur.shape[-2:])
    adj = jnp.full((n_labels + 1,), _BIG, dtype=jnp.int32)
    oob = jnp.int32(n_labels + 1)  # mode="drop" discards masked scatters
    for n in roll4(cur):
        pair = valid & (n != UNCOLOURED) & (n != cur)
        # centre -> neighbour ...
        adj = adj.at[jnp.where(pair, cur, oob).reshape(-1)].min(
            jnp.where(pair, n, _BIG).reshape(-1), mode="drop"
        )
        # ... and neighbour -> centre (covers border-pixel neighbours).
        adj = adj.at[jnp.where(pair, n, oob).reshape(-1)].min(
            jnp.where(pair, cur, _BIG).reshape(-1), mode="drop"
        )
    return adj


def merge_touching(labels: jnp.ndarray, n_labels: int) -> jnp.ndarray:
    """Merge all 4-adjacent differently-coloured regions (min label wins).

    Equivalent to one reference merge phase: find_merge + make_colour_map +
    recolour (src/lib.rs:1446-1466), but transitively correct in one call.
    Returns the relabelled image.
    """
    ident = jnp.arange(n_labels + 1, dtype=jnp.int32)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        parent, _ = state
        cur = parent[labels]
        adj = _adjacency_min(cur, n_labels)
        # parent[u] <- min(parent[u], parent[adj[u]]) where adjacency exists.
        safe = jnp.minimum(adj, jnp.int32(n_labels))
        cand = jnp.where(adj != _BIG, parent[safe], _BIG)
        new_parent = jnp.minimum(parent, cand)
        new_parent = _pointer_jump(new_parent)
        return new_parent, jnp.any(new_parent != parent)

    parent, _ = jax.lax.while_loop(cond, body, (ident, jnp.bool_(True)))
    return parent[labels]


def resolve_merges(colour_map: jnp.ndarray, pairs: jnp.ndarray) -> jnp.ndarray:
    """Apply an explicit merge-pair list to a colour LUT (min label wins).

    Host/test-facing equivalent of the reference's ``make_colour_map``
    (src/lib.rs:467-542): entries of ``colour_map`` whose *value* belongs to a
    transitive merge set are remapped to the set's minimum.  ``pairs`` has
    shape (P, 2); order-insensitive and duplicate-tolerant, like the
    reference's shuffled-input unit test (src/lib.rs:544-587).
    """
    colour_map = jnp.asarray(colour_map, dtype=jnp.int32)
    pairs = jnp.asarray(pairs, dtype=jnp.int32).reshape(-1, 2)
    n = int(colour_map.shape[0])
    ident = jnp.arange(n, dtype=jnp.int32)

    lo = jnp.minimum(pairs[:, 0], pairs[:, 1])
    hi = jnp.maximum(pairs[:, 0], pairs[:, 1])

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        parent, _ = state
        cand = parent.at[hi].min(parent[lo], mode="drop")
        cand = cand.at[lo].min(parent[hi], mode="drop")
        new_parent = _pointer_jump(cand)
        return new_parent, jnp.any(new_parent != parent)

    parent, _ = jax.lax.while_loop(cond, body, (ident, jnp.bool_(True)))
    # Remap by *value*, like the reference: base_map entries whose value merged
    # point at the merged representative.
    return parent[colour_map]


def recolour(labels: jnp.ndarray, colour_map: jnp.ndarray) -> jnp.ndarray:
    """Gather every pixel's label through the LUT (src/lib.rs:589-592)."""
    return jnp.asarray(colour_map, dtype=jnp.int32)[labels]


def touching_pairs(labels) -> set[tuple[int, int]]:
    """Test helper mirroring ``find_merge``'s deduplicated pair set
    (src/lib.rs:393-445): all unordered pairs of differing coloured labels
    where one of the two pixels is an interior centre 4-adjacent to the other.
    Host-side; for golden tests only.
    """
    import numpy as np

    lab = np.asarray(labels)
    h, w = lab.shape
    out: set[tuple[int, int]] = set()
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            c = lab[y, x]
            if c == UNCOLOURED:
                continue
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                n = lab[ny, nx]
                if n != UNCOLOURED and n != c:
                    out.add((min(c, n), max(c, n)))
    return out
