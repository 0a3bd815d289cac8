"""The water-level sweep driver: the whole transform as one jitted program.

Restructures the reference's per-level loop
(/root/reference/src/lib.rs:1379-1521 merging, :1689-1807 segmenting) for a
device:

* ``lax.fori_loop`` over water levels 0..=max_water_level,
* nested ``lax.while_loop`` flood fixed point (ops.flood),
* merge phase on-device (ops.merge) for the merging variant,
* per-level statistics accumulated into pre-allocated stacked arrays instead
  of host-side hook callbacks (``transform_to_list`` -> (levels, K+1) lake
  sizes; ``transform_history`` -> (levels, H, W) snapshots), so the fast path
  never leaves the device.

Two compute backends with bit-identical results:

* ``backend='jnp'`` — whole-image fused stencil sweeps per level (XLA
  fusion), one HBM round-trip per Jacobi sweep.
* ``backend='relax'`` — the priority-relaxation fixed point (ops.priority):
  the whole transform in O(longest claim chain) sweeps.

Per-level early exit: a level L > 0 at which no pixel has value exactly L is
skipped via ``lax.cond`` (see ops.histogram.value_histogram) — its flood fixed
point is immediate and no merge pairs can appear, so labels and statistics are
unchanged.  Level 0 always runs (seeds + ALWAYS_FILL pixels).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .._compat import cache_resilient
from .flood import flood_fixed_point
from .histogram import lake_sizes, value_histogram
from .merge import merge_touching


def level_step(img, labels, lvl, *, merging: bool, n_labels: int, sweep_fn=None):
    """One complete water level: flood to fixed point (+ merge).

    The merge phase is skipped when the level painted nothing (labels
    unchanged => no new label adjacencies), except at level 0 where
    pre-painted seeds may already touch."""
    labels, painted = flood_fixed_point(img, labels, lvl, sweep_fn=sweep_fn)
    if merging:
        labels = jax.lax.cond(
            painted | (lvl == 0),
            lambda l: merge_touching(l, n_labels),
            lambda l: l,
            labels,
        )
    return labels


def level_step_counted(img, labels, lvl, *, merging: bool, n_labels: int, sweep_fn=None):
    """level_step that also returns the flood-sweep count of the level (the
    reference's PerfReport 'loops' counter, src/lib.rs:1400-1402)."""
    from .flood import flood_sweep

    sweep = sweep_fn or flood_sweep

    def cond(state):
        return state[1]

    def body(state):
        lab, _, n = state
        new = sweep(img, lab, lvl)
        return new, jnp.any(new != lab), n + 1

    labels, _, loops = jax.lax.while_loop(
        cond, body, (labels, jnp.bool_(True), jnp.int32(0))
    )
    if merging:
        labels = merge_touching(labels, n_labels)
    return labels, loops


def _collect_loop(step, labels0, *, levels, vhist, collect, n_labels):
    """Shared level loop: run `step` per level, accumulate statistics."""

    def run_lvl(lvl, lab):
        return jax.lax.cond(
            (lvl == 0) | (vhist[lvl] > 0), lambda l: step(l, lvl), lambda l: l, lab
        )

    if collect == "none":
        return jax.lax.fori_loop(0, levels, run_lvl, labels0)

    if collect == "sizes":
        out0 = jnp.zeros((levels, n_labels + 1), dtype=jnp.int32)

        def body(lvl, carry):
            lab, out = carry
            lab = run_lvl(lvl, lab)
            out = out.at[lvl].set(lake_sizes(lab, n_labels))
            return lab, out

        return jax.lax.fori_loop(0, levels, body, (labels0, out0))

    if collect == "history":
        out0 = jnp.zeros((levels,) + labels0.shape, dtype=jnp.int32)

        def body(lvl, carry):
            lab, out = carry
            lab = run_lvl(lvl, lab)
            out = out.at[lvl].set(lab)
            return lab, out

        return jax.lax.fori_loop(0, levels, body, (labels0, out0))

    raise ValueError(f"unknown collect mode {collect!r}")


def run_levels_impl(
    img,
    labels0,
    *,
    n_labels: int,
    max_water_level: int,
    merging: bool,
    collect: str = "none",
    sweep_fn=None,
    backend: str = "jnp",
):
    """Run the full transform.

    Args:
      img: (H, W) u8/int input image (cast to int32 internally).
      labels0: (H, W) int32 initial labels (seeds painted, 0 elsewhere).
      n_labels: number of seeds K (static; labels in 1..K).
      max_water_level: inclusive final level (1..=254).
      merging: merging (void-filling) variant if True, else segmenting.
      collect: 'none' | 'sizes' | 'history'.
      backend: 'jnp' (the level sweep) | 'relax' (the priority-relaxation
        fixed point) — bit-identical results.

    Returns final labels, or (final labels, collected stack).
    """
    img = jnp.asarray(img).astype(jnp.int32)
    labels0 = jnp.asarray(labels0, dtype=jnp.int32)
    levels = max_water_level + 1

    if backend == "relax" and merging and collect != "none":
        # Per-level MERGED statistics need the incremental per-level unions,
        # which the one-shot relaxation cannot produce — fall back to the
        # level sweep instead of raising (same steering as the public API's
        # _resolved_backend).  NB the public ``transform_to_list`` uses the
        # much faster merge_curve path (one relax pass + host Kruskal) —
        # this on-device fallback exists for direct run_levels callers.
        backend = "jnp"

    if backend == "relax":
        # The whole transform as ONE priority-relaxation fixed point
        # (ops.priority) — bit-identical to the level sweep, in O(longest
        # claim chain) whole-image passes instead of the per-level ring sums.
        #
        # Merging variant: which pixels are claimed (and when) is
        # label-independent, and the merging output at the final level is
        # "each 4-connected component of the claimed set takes its minimum
        # seed label" — i.e. one transitive merge_touching over the
        # segmenting labels (ops.scan_merge).
        from .priority import relax_transform, sizes_from_levels

        labels, claim_levels = relax_transform(
            img, labels0, max_water_level=max_water_level
        )
        if merging:
            from .scan_merge import component_min_labels

            return component_min_labels(labels)
        if collect == "none":
            return labels
        if collect == "sizes":
            return labels, sizes_from_levels(
                labels, claim_levels, n_labels, max_water_level
            )
        if collect == "history":
            lvls = jnp.arange(levels, dtype=jnp.int32)[:, None, None]
            return labels, jnp.where(claim_levels[None] <= lvls, labels[None], 0)
        raise ValueError(f"unknown collect mode {collect!r}")

    if backend != "jnp":
        raise ValueError(f"unknown backend {backend!r}")

    vhist = value_histogram(img)

    def step(labels, lvl):
        return level_step(
            img, labels, lvl, merging=merging, n_labels=n_labels, sweep_fn=sweep_fn
        )

    return _collect_loop(
        step,
        labels0,
        levels=levels,
        vhist=vhist,
        collect=collect,
        n_labels=n_labels,
    )


_run_levels_jit = cache_resilient(
    partial(
        jax.jit,
        static_argnames=(
            "n_labels",
            "max_water_level",
            "merging",
            "collect",
            "sweep_fn",
            "backend",
        ),
    )(run_levels_impl)
)


def run_levels(
    img,
    labels0,
    *,
    n_labels: int,
    max_water_level: int,
    merging: bool,
    collect: str = "none",
    sweep_fn=None,
    backend: str = "jnp",
):
    """Public jitted entry (arguments as run_levels_impl).

    Every call reaches the jitted function with the SAME keyword set: on jax
    0.9.0 CPU, calling one jitted function with different subsets of its
    static keywords can corrupt its executable cache ("Execution supplied N
    buffers but compiled program expected M"), and every later call then
    pays a cache clear and a recompile (_compat.cache_resilient).  Nothing
    inside this package jits an already-jitted function for the same
    reason; jitted callers (e.g. ops.pipeline.watershed_e2e) call
    run_levels_impl directly.
    """
    return _run_levels_jit(
        img,
        labels0,
        n_labels=n_labels,
        max_water_level=max_water_level,
        merging=merging,
        collect=collect,
        sweep_fn=sweep_fn,
        backend=backend,
    )
