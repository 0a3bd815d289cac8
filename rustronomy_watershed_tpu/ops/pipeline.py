"""Fully-jittable end-to-end watershed: seeds -> level sweep -> labels.

One device program for the whole README-quickstart flow
(/root/reference/README.md quickstart; reference calls find_local_minima then
transform): the seed *coordinate list* never materialises on the host — seeds
are numbered 1..K in row-major order with a cumsum over the extrema mask,
which matches the reference's enumeration exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .._compat import cache_resilient
from .level_driver import run_levels_impl
from .seeds import local_extrema_mask, seed_labels_from_mask


def max_seed_count(shape: tuple[int, int]) -> int:
    """Static upper bound on the number of seeds: strict 8-connected local
    maxima are pairwise non-adjacent (Chebyshev distance >= 2), so at most
    ceil(H-2 / 2) * ceil(W-2 / 2) interior pixels qualify."""
    h, w = shape
    return max(1, ((h - 1) // 2) * ((w - 1) // 2))


def watershed_e2e_impl(
    img,
    *,
    max_water_level: int = 254,
    merging: bool = False,
    collect: str = "none",
    n_labels: int | None = None,
    sweep_fn=None,
    backend: str = "jnp",
):
    """Seeds from the image itself (reference find_local_minima semantics),
    then the full transform.  Returns what run_levels returns."""
    img = jnp.asarray(img)
    labels0 = seed_labels_from_mask(local_extrema_mask(img))
    if n_labels is None:
        n_labels = max_seed_count(img.shape[-2:])
    return run_levels_impl(
        img,
        labels0,
        n_labels=n_labels,
        max_water_level=max_water_level,
        merging=merging,
        collect=collect,
        sweep_fn=sweep_fn,
        backend=backend,
    )


# Public jitted entry (see ops.level_driver on why impls stay unjitted).
watershed_e2e = cache_resilient(
    partial(
        jax.jit,
        static_argnames=(
            "max_water_level",
            "merging",
            "collect",
            "n_labels",
            "sweep_fn",
            "backend",
        ),
    )(watershed_e2e_impl)
)
