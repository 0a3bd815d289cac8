"""Opt-in stochastic plateau tie-break (``set_tie_break('random', seed)``).

Reproduces the reference's thread_rng tie behaviour
(/root/reference/src/lib.rs:249-253) distributionally but reproducibly
(jax.random keyed).  The default everywhere stays the pinned deterministic
min-label rule (SURVEY.md Q2).
"""

import numpy as np
import pytest

from rustronomy_watershed_tpu.prelude import TransformBuilder


def _tie_field(rows: int):
    """(img, seeds): ``rows`` independent 7-px plateau corridors separated by
    NEVER_FILL rows.  In each corridor, seeds sit at x=1 and x=5; the pixel
    at x=3 is claimed at sweep 2 with BOTH wavefronts adjacent — a pure
    two-way tie.  Min-label always awards it to the row's first seed."""
    h = 2 * rows + 1
    img = np.full((h, 7), 255, dtype=np.uint8)
    seeds = []
    for i in range(rows):
        y = 2 * i + 1
        img[y, :] = 0
        seeds.append((y, 1))
        seeds.append((y, 5))
    return img, seeds


def test_min_default_awards_first_seed():
    img, seeds = _tie_field(32)
    ws = TransformBuilder.default().set_max_water_lvl(1).build_segmenting()
    out = np.asarray(ws.transform(img, seeds))
    for i in range(32):
        y = 2 * i + 1
        assert out[y, 3] == 2 * i + 1  # min of the two competing labels


def test_random_tie_break_uniform_chi_square():
    rows = 400
    img, seeds = _tie_field(rows)
    ws = (
        TransformBuilder.default()
        .set_max_water_lvl(1)
        .set_tie_break("random", seed=7)
        .build_segmenting()
    )
    out = np.asarray(ws.transform(img, seeds))
    n_first = 0
    for i in range(rows):
        y = 2 * i + 1
        got = out[y, 3]
        assert got in (2 * i + 1, 2 * i + 2), (i, got)
        n_first += got == 2 * i + 1
    # chi-square, 1 dof, p = 0.001 critical value 10.83: under uniform
    # choice n_first ~ Binomial(400, 1/2).
    e = rows / 2.0
    chi2 = (n_first - e) ** 2 / e + ((rows - n_first) - e) ** 2 / e
    assert chi2 < 10.83, (n_first, chi2)
    # ... and the stochastic rule actually differs from min-label somewhere.
    assert n_first < rows


def test_random_tie_break_reproducible_and_seed_sensitive():
    img, seeds = _tie_field(64)
    mk = lambda s: (
        TransformBuilder.default()
        .set_max_water_lvl(1)
        .set_tie_break("random", seed=s)
        .build_segmenting()
    )
    a1 = np.asarray(mk(3).transform(img, seeds))
    a2 = np.asarray(mk(3).transform(img, seeds))
    b = np.asarray(mk(4).transform(img, seeds))
    np.testing.assert_array_equal(a1, a2)
    assert np.any(a1 != b)


def test_random_claimed_set_and_merging_invariant():
    """Which pixels get claimed (and when) is tie-break independent, and the
    merging variant's final labels are too (label adjacency at each level
    does not depend on which lake claimed a boundary pixel)."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 30, size=(40, 40)).astype(np.uint8)
    ws_min = TransformBuilder.default().build_segmenting()
    seeds = ws_min.find_local_minima(img)
    ws_rnd = (
        TransformBuilder.default().set_tie_break("random", 1).build_segmenting()
    )
    out_min = np.asarray(ws_min.transform(img, seeds))
    out_rnd = np.asarray(ws_rnd.transform(img, seeds))
    np.testing.assert_array_equal(out_min != 0, out_rnd != 0)

    wm_min = TransformBuilder.default().build_merging()
    wm_rnd = (
        TransformBuilder.default().set_tie_break("random", 1).build_merging()
    )
    np.testing.assert_array_equal(
        np.asarray(wm_min.transform(img, seeds)),
        np.asarray(wm_rnd.transform(img, seeds)),
    )


def test_builder_validation():
    with pytest.raises(ValueError):
        TransformBuilder.default().set_tie_break("bogus")
    with pytest.raises(ValueError):
        (
            TransformBuilder.default()
            .set_tie_break("random")
            .set_backend("relax")
            .build_segmenting()
        )
    with pytest.raises(ValueError):
        (
            TransformBuilder.default()
            .set_tie_break("random")
            .set_sweep_impl(lambda img, lab, lvl: lab)
            .build_segmenting()
        )
    # min (the default) composes with everything, unchanged.
    TransformBuilder.default().set_tie_break("min").set_backend(
        "relax"
    ).build_segmenting()


# -- transform_batch under the stochastic rule (VERDICT r3 #4) ---------------


def test_batch_random_tie_break_distribution_and_claimed_set():
    """Batched stochastic tie-break: per-image independent uniform planes
    (batch index folded into the seed).  Pins (a) every tie lands on one of
    the two competing labels, (b) the choice is uniform (chi-square over the
    whole batch), (c) images differ from each other (independent planes),
    (d) the claimed set per image matches the min-label rule exactly."""
    rows = 50
    img, seeds = _tie_field(rows)
    b = 8
    imgs = np.stack([img] * b)
    seeds_list = [seeds] * b
    ws = (
        TransformBuilder.default()
        .set_max_water_lvl(1)
        .set_tie_break("random", seed=7)
        .build_segmenting()
    )
    out = np.asarray(ws.transform_batch(imgs, seeds_list))
    assert out.shape == imgs.shape
    n_first = 0
    for k in range(b):
        for i in range(rows):
            y = 2 * i + 1
            got = out[k, y, 3]
            assert got in (2 * i + 1, 2 * i + 2), (k, i, got)
            n_first += got == 2 * i + 1
    n = b * rows
    e = n / 2.0
    chi2 = (n_first - e) ** 2 / e + ((n - n_first) - e) ** 2 / e
    assert chi2 < 10.83, (n_first, chi2)  # 1 dof, p = 0.001
    # Independent per-image planes: not every image partitions identically.
    assert any(np.any(out[k] != out[0]) for k in range(1, b))
    # Claimed set is tie-break independent.
    ws_min = (
        TransformBuilder.default().set_max_water_lvl(1).build_segmenting()
    )
    out_min = np.asarray(ws_min.transform_batch(imgs, seeds_list))
    np.testing.assert_array_equal(out != 0, out_min != 0)


def test_batch_random_reproducible_and_seed_sensitive():
    img, seeds = _tie_field(64)
    imgs = np.stack([img] * 3)
    seeds_list = [seeds] * 3
    mk = lambda s: (
        TransformBuilder.default()
        .set_max_water_lvl(1)
        .set_tie_break("random", seed=s)
        .build_segmenting()
    )
    a1 = np.asarray(mk(3).transform_batch(imgs, seeds_list))
    a2 = np.asarray(mk(3).transform_batch(imgs, seeds_list))
    b = np.asarray(mk(4).transform_batch(imgs, seeds_list))
    np.testing.assert_array_equal(a1, a2)
    assert np.any(a1 != b)


def test_batch_random_merging_invariant_and_edge_correction(rng=None):
    """The merging variant's final labels are tie-break independent (label
    adjacency per level does not depend on which lake claimed a boundary
    pixel) — batched, and composed with edge correction."""
    gen = np.random.default_rng(5)
    imgs = gen.integers(0, 25, size=(3, 24, 24)).astype(np.uint8)
    util = TransformBuilder.default().build_segmenting()
    seeds_list = [util.find_local_minima(im) for im in imgs]
    for edge in (False, True):

        def mk(tb, edge=edge):
            bld = TransformBuilder.default().set_tie_break(*tb)
            if edge:
                bld = bld.enable_edge_correction()
            return bld.build_merging()

        out_rnd = np.asarray(
            mk(("random", 1)).transform_batch(imgs, seeds_list)
        )
        out_min = np.asarray(mk(("min",)).transform_batch(imgs, seeds_list))
        np.testing.assert_array_equal(out_rnd, out_min)
