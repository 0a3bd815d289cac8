"""Priority-relaxation engine: the whole segmenting transform in ONE fixed point.

The reference's level loop claims pixel p at the key
``key(p) = (L(p), d(p))`` ordered lexicographically, where

* ``L(p)`` — the water level at which p floods: the minimax (bottleneck)
  path value ``min over 4-paths to a seed of max(v(x))`` — level sweeps
  (src/lib.rs:1379-1438) compute exactly this implicitly;
* ``d(p)`` — the Jacobi ring index at level L(p): the BFS distance through
  the equal-level plateau to the nearest pixel claimed at a lower level;
* ``label(p)`` — the reference (under the pinned min tie-break) paints p
  with the **minimum label among neighbours already coloured when p is
  claimed**, i.e. ``min{ label(q) : key(q) <lex key(p) }``.

These satisfy local recurrences, so chaotic Jacobi relaxation over the
triple (L, d, label) converges to the unique fixed point in O(longest claim
chain) sweeps — typically 10-100x fewer whole-image passes than the level
loop's per-level ring sums, with **bit-identical labels**:

  from neighbour q:  Lc = max(v(p), L(q));  dc = d(q)+1 if L(q) == Lc else 1
  key(p)   = min over q of (Lc, dc)            (keys only decrease: monotone)
  label(p) = min over q with key(q) <lex key(p) of label(q)
             (each accepted candidate's source q satisfies key(q) < key(p),
              so the min is nonempty whenever key(p) is finite)

Seeds initialise at key (0, 0) with their colour and never update (every
candidate key is lexicographically greater).  NEVER_FILL and border pixels
get v_eff = 255 > max level, so their keys stay unclaimable.  Segmenting
only — the merging variant recolours claimed pixels, which breaks the
"labels are final at claim time" invariant this engine exploits.

Per-level statistics come post-hoc from L: pixel p is coloured at all levels
>= L(p), so lake sizes per level are a (level, label) bincount cumsum and
history snapshots are ``where(L <= lvl, label, 0)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import NEVER_FILL, UNCOLOURED
from .stencil import roll4

_BIG_L = np.int32(NEVER_FILL + 1)  # > any claimable level
_BIG_D = np.int32(2**30)
_BIG_LAB = np.int32(2**30)


def _lex_lt(l1, d1, l2, d2):
    return (l1 < l2) | ((l1 == l2) & (d1 < d2))


def relax_sweep(v_eff, state):
    """One Jacobi relaxation sweep over (L, d, label)."""
    L, d, lab = state
    seeds = (L == 0) & (d == 0) & (lab != UNCOLOURED)

    best_l, best_d = L, d
    lab_min = jnp.full_like(lab, _BIG_LAB)

    for Lq, dq, labq in zip(roll4(L), roll4(d), roll4(lab)):
        lc = jnp.maximum(v_eff, Lq)
        dc = jnp.where(Lq == lc, dq + 1, jnp.int32(1))
        take = _lex_lt(lc, dc, best_l, best_d)
        best_l = jnp.where(take, lc, best_l)
        best_d = jnp.where(take, dc, best_d)

    # Labels: min over neighbours claimed strictly before OUR (new) key.
    for Lq, dq, labq in zip(roll4(L), roll4(d), roll4(lab)):
        qualifies = _lex_lt(Lq, dq, best_l, best_d)
        lab_min = jnp.minimum(lab_min, jnp.where(qualifies, labq, _BIG_LAB))

    new_lab = jnp.where(lab_min == _BIG_LAB, lab, lab_min)
    # Seeds are immutable.
    L2 = jnp.where(seeds, L, best_l)
    d2 = jnp.where(seeds, d, best_d)
    lab2 = jnp.where(seeds, lab, new_lab)
    return L2, d2, lab2


def init_state(img, labels0):
    """(v_eff, (L, d, label)) for the relaxation.

    v_eff forces the 1-px border to NEVER_FILL (the reference never paints
    border pixels, src/lib.rs:220-233); seeds start claimed at key (0, 0).
    """
    v = jnp.asarray(img).astype(jnp.int32)
    v = v.at[0, :].set(NEVER_FILL)
    v = v.at[-1, :].set(NEVER_FILL)
    v = v.at[:, 0].set(NEVER_FILL)
    v = v.at[:, -1].set(NEVER_FILL)
    labels0 = jnp.asarray(labels0, dtype=jnp.int32)
    seeds = labels0 != UNCOLOURED
    L = jnp.where(seeds, jnp.int32(0), _BIG_L)
    d = jnp.where(seeds, jnp.int32(0), _BIG_D)
    return v, (L, d, labels0)


def relax_transform(img, labels0, *, max_water_level: int = 254, collect_sweeps=False):
    """Full segmenting transform by priority relaxation.

    Returns (labels, claim_levels[, n_sweeps]): labels is bit-identical to
    the level-sweep drivers; claim_levels is L(p) (NEVER_FILL+1 where never
    claimed) for post-hoc per-level statistics.
    """
    v, state = init_state(img, labels0)

    def cond(s):
        return s[1]

    def body(s):
        (L, d, lab), _, n = s
        L2, d2, lab2 = relax_sweep(v, (L, d, lab))
        changed = jnp.any((L2 != L) | (d2 != d) | (lab2 != lab))
        return (L2, d2, lab2), changed, n + 1

    (L, d, lab), _, n = jax.lax.while_loop(
        cond, body, (state, jnp.bool_(True), jnp.int32(0))
    )
    labels = jnp.where(L <= max_water_level, lab, UNCOLOURED)
    if collect_sweeps:
        return labels, L, n
    return labels, L


def sizes_from_levels(labels, claim_levels, n_labels: int, max_water_level: int):
    """(levels, K+1) per-level lake sizes from one (L, label) pass: a pixel
    is coloured at every level >= L(p), so counts are a 2-D bincount with a
    cumulative sum over levels; column 0 (uncoloured) is the complement."""
    levels = max_water_level + 1
    lab = labels.reshape(-1)
    lv = jnp.clip(claim_levels.reshape(-1), 0, levels)  # `levels` = never row
    counts = jnp.zeros((levels + 1, n_labels + 1), dtype=jnp.int32)
    counts = counts.at[lv, lab].add(jnp.ones_like(lab), mode="drop")
    cum = jnp.cumsum(counts[:levels], axis=0)
    total = labels.size
    coloured = jnp.sum(cum[:, 1:], axis=1)
    return cum.at[:, 0].set(total - coloured)
