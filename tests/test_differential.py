"""Randomised differential testing: every engine vs the C++ oracle on a
stream of random configurations (shapes, dynamic ranges, max levels,
variants).  Catches interaction bugs the fixed-fixture tests miss."""

import numpy as np
import pytest

import jax.numpy as jnp

from rustronomy_watershed_tpu.ops import paint_seeds, run_levels

native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")


@pytest.mark.parametrize("trial", range(10))
def test_random_config_vs_oracle(trial):
    rng = np.random.default_rng(1000 + trial)
    h = int(rng.integers(12, 70))
    w = int(rng.integers(12, 70))
    hi = int(rng.choice([3, 5, 16, 64, 254]))
    maxlvl = int(rng.choice([1, 2, hi // 2 + 1, 254]))
    merging = bool(rng.integers(0, 2))
    img = rng.integers(0, hi, size=(h, w)).astype(np.uint8)
    # sprinkle ALWAYS_FILL / NEVER_FILL sentinels
    img[rng.random((h, w)) < 0.02] = 0
    img[rng.random((h, w)) < 0.02] = 255
    seeds = native.native_find_local_minima(img)
    if not seeds:
        seeds = [(2, 2), (h - 3, w - 3)]
    want = native.native_transform(img, seeds, maxlvl, merging=merging)
    lab0 = paint_seeds((h, w), seeds)
    for backend in ("jnp", "relax"):
        got = np.asarray(
            run_levels(jnp.asarray(img), lab0, n_labels=len(seeds),
                       max_water_level=maxlvl, merging=merging, backend=backend)
        )
        np.testing.assert_array_equal(
            got, want,
            err_msg=f"trial={trial} {h}x{w} hi={hi} maxlvl={maxlvl} "
                    f"merging={merging} backend={backend}",
        )


@pytest.mark.parametrize("shape,merging", [
    ((288, 24), False),   # tall thin: height >> width
    ((288, 24), True),
    ((24, 288), False),   # short wide
    ((20, 1030), True),   # a long sliver, 20 rows tall
])
def test_extreme_aspect_ratio_vs_oracle(rng, shape, merging):
    """Tall/thin and short/wide geometries through the relax engine (both
    variants) against the C++ oracle."""
    h, w = shape
    img = rng.integers(0, 40, size=(h, w)).astype(np.uint8)
    img[rng.random((h, w)) < 0.03] = 0
    img[rng.random((h, w)) < 0.03] = 255
    seeds = native.native_find_local_minima(img)
    if not seeds:
        seeds = [(2, 2), (h - 3, w - 3)]
    want = native.native_transform(img, seeds, 254, merging=merging)
    lab0 = paint_seeds((h, w), seeds)
    got = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=len(seeds),
                   max_water_level=254, merging=merging, backend="relax")
    )
    np.testing.assert_array_equal(got, want)
