"""Scan-based component-min labelling: the merging variant's final labels.

At the final water level the merging (void-filling) transform's output is
"every 4-connected component of the claimed set takes its minimum seed
label" (reference merge semantics under the pinned min-label tie-break,
/root/reference/src/lib.rs:1446-1470 + SURVEY.md Q9): each flood claim at
level L makes the claimant adjacent to all its earlier-claimed neighbours,
so by the last level every within-component label pair has merged
transitively.  Component-min is therefore equivalent to iterating the
reference's find_merge/make_colour_map/recolour to exhaustion — but is
computed with **segmented min-scans** instead of per-label union tables:

* a vertical pass replaces every maximal claimed run of each column by the
  run's min (forward then backward inclusive segmented min scans,
  ``lax.associative_scan``);
* a horizontal pass does the same along rows;
* alternate until a fixed point.  Each pass moves label information across
  an entire run, so convergence takes O(staircase complexity of the
  components) rounds, not O(component diameter) stencil sweeps.

Edge rule: the reference only detects merge pairs through 3x3 windows
centred on interior pixels, so an adjacent pair of two *border* pixels never
merges (ops/merge.py, SURVEY.md §2 #5).  Exactly the vertical edges inside
columns {0, W-1} and the horizontal edges inside rows {0, H-1} connect two
border pixels; each directional pass restores those lines afterwards (a
directional scan never leaks values across columns/rows, so restoring the
line undoes every blocked-edge propagation).

UNCOLOURED (= 0) pixels are the segment barriers; labels are positive.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _vscan(lab):
    """Segmented run-min per column via associative scan."""
    big = jnp.int32(2**30)

    def combine(a, b):
        va, ra = a
        vb, rb = b
        return jnp.where(rb, vb, jnp.minimum(va, vb)), ra | rb

    def run_min(x, reverse):
        reset = x == 0
        y = jnp.where(reset, big, x)
        v, _ = jax.lax.associative_scan(
            combine, (y, reset), axis=0, reverse=reverse
        )
        return jnp.where(reset, 0, v)

    return run_min(run_min(lab, False), True)


def component_min_labels(labels, *, collect_rounds: bool = False):
    """Replace every 4-connected component of nonzero labels (blocked
    border-border edges excluded) by its minimum label.

    Bit-equivalent to iterating ops.merge.merge_touching to exhaustion; this
    is the merging variant's final-level output given segmenting labels.
    ``collect_rounds=True`` also returns the number of v+h rounds run (the
    last one observes the fixed point).
    """
    labels = jnp.asarray(labels, dtype=jnp.int32)
    h, w = labels.shape

    def vscan(x):
        out = _vscan(x)
        # Blocked vertical edges: both endpoints in column 0 / W-1 are
        # border pixels.  The scan is per-column, so restoring the two
        # columns removes exactly those propagations.
        out = jax.lax.dynamic_update_slice(out, x[:, :1], (0, 0))
        out = jax.lax.dynamic_update_slice(out, x[:, -1:], (0, w - 1))
        return out

    def hscan(x):
        xt = x.T
        out = _vscan(xt)
        # Blocked horizontal edges: rows 0 / H-1 become columns here.
        out = jax.lax.dynamic_update_slice(out, xt[:, :1], (0, 0))
        out = jax.lax.dynamic_update_slice(out, xt[:, -1:], (0, h - 1))
        return out.T

    def body(state):
        lab, _, n = state
        new = hscan(vscan(lab))
        return new, jnp.any(new != lab), n + 1

    out, _, n = jax.lax.while_loop(
        lambda s: s[1], body, (labels, jnp.bool_(True), jnp.int32(0))
    )
    return (out, n) if collect_rounds else out
