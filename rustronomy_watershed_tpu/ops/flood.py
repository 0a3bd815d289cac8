"""Flood (colouring) kernels: one Jacobi sweep and the per-level fixed point.

Device reformulation of the reference's ``find_flooded_px`` + serial paint
(/root/reference/src/lib.rs:196-257, :1394-1438): instead of collecting a
dynamic list of pixels and painting them serially, one sweep is a pure
whole-image 5-point stencil.  A pixel is painted when it is

1. flooded        (``img <= lvl``,                 src/lib.rs:224)
2. uncoloured     (``labels == UNCOLOURED``,        src/lib.rs:226)
3. adjacent to a coloured 4-neighbour               (src/lib.rs:228-231)
4. an interior pixel (window centres only,          src/lib.rs:220-233)

The painted colour is the **minimum** coloured 4-neighbour label.  The
reference picks a uniformly-random coloured neighbour on ties
(src/lib.rs:249-253); that is non-deterministic run-to-run, so this rebuild
pins the documented deterministic tie-break rule *min-label-wins* (SURVEY.md
Q2).  On tie-free pixels the two rules agree exactly.

An OPT-IN stochastic mode (``TransformBuilder.set_tie_break('random', seed)``)
reproduces the reference's randomized plateau partition distributionally —
``flood_sweep_random`` picks uniformly among the coloured 4-neighbour
*positions* (like the reference's random element of its coloured-neighbour
list, so a label held by two neighbour positions gets double weight), keyed
by jax.random so runs are reproducible given the seed.  One uniform draw per
pixel per transform suffices: a pixel is painted exactly once, so its draw is
consumed at exactly one sweep, and draws are independent across pixels.

One sweep advances the wavefront by exactly one 4-connected ring, preserving
the reference's plateau-claiming order (SURVEY.md Q3): within a sweep all
decisions read the label image from the *start* of the sweep (Jacobi), which
matches the reference's find-then-paint two-phase structure.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import INT32_MAX, UNCOLOURED
from .stencil import interior_mask, roll4


def flood_sweep(img: jnp.ndarray, labels: jnp.ndarray, lvl, mask=None) -> jnp.ndarray:
    """One Jacobi flood sweep.  ``img`` int32 (0..255), ``labels`` int32.

    ``mask`` restricts paintable pixels; defaults to the local interior mask.
    The tiled (shard_map) driver passes a *global*-interior mask in halo
    coordinates instead.
    """
    cand, nmin, _ = flood_candidates(img, labels, lvl, mask)
    return paint(labels, cand, nmin)


def flood_fixed_point(img: jnp.ndarray, labels: jnp.ndarray, lvl, sweep_fn=None):
    """Run flood sweeps until no pixel changes (the per-level 'colouring_loop',
    /root/reference/src/lib.rs:1394-1438).

    ``sweep_fn(img, labels, lvl) -> labels`` may be supplied to swap in an
    accelerated (e.g. multi-step) sweep; it must be semantically equal to
    ``flood_sweep`` iterated >= 1 times (information moves <=1 px per sweep,
    so any k-step fusion reaches the same fixed point).

    Returns (labels, painted_any): whether this level painted any pixel —
    when False, the merge phase can be skipped (no labels changed, so no new
    label adjacencies can exist).
    """
    if sweep_fn is None:
        sweep_fn = flood_sweep

    def cond(state):
        return state[1]

    def body(state):
        lab, _, painted = state
        new = sweep_fn(img, lab, lvl)
        changed = jnp.any(new != lab)
        return new, changed, painted | changed

    # Do-while: always run at least one sweep per level, like the reference.
    labels, _, painted = jax.lax.while_loop(
        cond, body, (labels, jnp.bool_(True), jnp.bool_(False))
    )
    return labels, painted


def flood_candidates(img: jnp.ndarray, labels: jnp.ndarray, lvl, mask=None):
    """The reference's ``find_flooded_px`` phase alone (src/lib.rs:196-257):
    returns (cand, nmin, any_cand) without painting — the single home of the
    claim rule, shared by flood_sweep and the debug path's separate
    candidate/paint timers (src/lib.rs:1404-1436)."""
    if mask is None:
        mask = interior_mask(labels.shape[-2:])
    up, down, left, right = roll4(labels)
    big = jnp.int32(INT32_MAX)

    def masked(n):
        return jnp.where(n != UNCOLOURED, n, big)

    nmin = jnp.minimum(
        jnp.minimum(masked(up), masked(down)),
        jnp.minimum(masked(left), masked(right)),
    )
    cand = (labels == UNCOLOURED) & (img <= lvl) & (nmin != big) & mask
    return cand, nmin, jnp.any(cand)


def paint(labels: jnp.ndarray, cand: jnp.ndarray, nmin: jnp.ndarray) -> jnp.ndarray:
    """The paint phase (src/lib.rs:1428-1436): apply the found candidates."""
    return jnp.where(cand, nmin, labels)


def flood_candidates_random(img, labels, lvl, u, mask=None):
    """``flood_candidates`` with the reference's stochastic tie-break
    (src/lib.rs:235-254): the painted colour is a uniformly-random coloured
    4-neighbour *position* instead of the minimum label.

    ``u`` is a per-pixel uniform [0, 1) plane (one draw per pixel per
    transform — see the module docstring on why that is unbiased).  Returns
    (cand, choice, any_cand); ``choice`` is only meaningful where ``cand``.
    """
    if mask is None:
        mask = interior_mask(labels.shape[-2:])
    neigh = roll4(labels)
    valid = [(n != UNCOLOURED).astype(jnp.int32) for n in neigh]
    n_valid = valid[0] + valid[1] + valid[2] + valid[3]
    # j uniform over {0..n_valid-1}; the min() guards the u*n == n float
    # rounding corner.  n_valid == 0 => j == -1 => no rank matches (cand is
    # False there anyway: nmin-style "has a coloured neighbour" check below).
    j = jnp.minimum(
        (u * n_valid.astype(jnp.float32)).astype(jnp.int32), n_valid - 1
    )
    choice = jnp.zeros_like(labels)
    rank = jnp.zeros_like(n_valid)
    for v, n in zip(valid, neigh):
        choice = jnp.where((v > 0) & (rank == j), n, choice)
        rank = rank + v
    cand = (labels == UNCOLOURED) & (img <= lvl) & (n_valid > 0) & mask
    return cand, choice, jnp.any(cand)


def flood_sweep_random(img, labels, lvl, *, u, mask=None):
    """One Jacobi flood sweep under the stochastic tie-break (opt-in via
    ``set_tie_break('random', seed)``).  Signature-compatible with
    ``flood_sweep`` once ``u`` is bound (functools.partial)."""
    cand, choice, _ = flood_candidates_random(img, labels, lvl, u, mask)
    return paint(labels, cand, choice)
