"""Merging final labels on the component structures that matter.

At full depth the merged labels are "each 4-connected component of the
claimed set takes its minimum seed label" (ops.scan_merge).  These tests pin
the relax merging path against the level-sweep driver and the C++ oracle
on the structures that decide the component count: a dense field (one
component), interior NEVER_FILL walls, border seeds (which merge
horizontally only), images with no interior, and transform_batch's stacked
plane (per-image NEVER_FILL borders + separator rows must keep images apart).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rustronomy_watershed_tpu.constants import NEVER_FILL
from rustronomy_watershed_tpu.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu.ops.priority import relax_transform
from rustronomy_watershed_tpu.ops.seeds import (
    local_extrema_mask,
    seed_labels_from_mask,
)


def _merging_both_backends(img, lab0, n):
    got = run_levels_impl(
        img, lab0, n_labels=n, max_water_level=254, merging=True,
        backend="relax",
    )
    want = run_levels_impl(
        img, lab0, n_labels=n, max_water_level=254, merging=True,
        backend="jnp",
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    return got


def test_dense_field_merges_to_one_component(rng):
    img = rng.integers(0, 254, (64, 96)).astype(np.uint8)
    lab0 = np.asarray(
        seed_labels_from_mask(local_extrema_mask(jnp.asarray(img, jnp.int32)))
    )
    n = int(lab0.max())
    merged = _merging_both_backends(img, lab0, n)
    inner = np.asarray(merged)[1:-1, 1:-1]
    assert (inner == 1).all()  # row-major numbering: label 1 is the global min


def test_interior_barriers_keep_components_apart(rng):
    """A NEVER_FILL wall in the interior splits the claimed set: the merged
    labels must be multi-component and match the level sweep."""
    img = rng.integers(0, 200, (64, 96)).astype(np.uint8)
    img[20:44, 40:44] = NEVER_FILL  # a wall splitting the domain
    lab0 = np.asarray(
        seed_labels_from_mask(local_extrema_mask(jnp.asarray(img, jnp.int32)))
    )
    n = int(lab0.max())
    merged = np.asarray(_merging_both_backends(img, lab0, n))
    assert len(np.unique(merged[1:-1, 1:-1])) > 1


def test_border_seed_merging_matches_level_sweep(rng):
    """A claimed border pixel merges horizontally only (quirk semantics)."""
    img = rng.integers(0, 254, (48, 64)).astype(np.uint8)
    lab0 = np.array(
        seed_labels_from_mask(local_extrema_mask(jnp.asarray(img, jnp.int32)))
    )
    lab0[0, 10] = int(lab0.max()) + 1  # inject a border seed
    n = int(lab0.max())
    merged = np.asarray(_merging_both_backends(img, lab0, n))
    assert merged[0, 10] != 0


def test_empty_interior_merging(rng):
    """2-row images have no interior: nothing is claimed, border seeds stay
    put, and both engines agree."""
    img = rng.integers(0, 254, (2, 64)).astype(np.uint8)
    lab0 = np.zeros((2, 64), np.int32)
    out = np.asarray(_merging_both_backends(img, lab0, 1))
    assert (out == 0).all()
    lab0[0, 5], lab0[1, 9] = 1, 2
    out = np.asarray(_merging_both_backends(img, lab0, 2))
    np.testing.assert_array_equal(out, lab0)


# -- transform_batch's stacked merging plane --------------------------------


def _stacked_merging_case(rng, b=3, h=20, w=24, border_seed=False, nan_blob=False):
    """Build the exact stacked plane transform_batch's merging path builds."""
    from rustronomy_watershed_tpu.ops.seeds import paint_seeds

    imgs = rng.integers(0, 254, size=(b, h, w)).astype(np.uint8)
    if nan_blob:
        imgs[1, 5:9, 6:10] = NEVER_FILL  # interior barrier in image 1
    seeds_list = [
        [(3, 4), (h - 4, w - 5), (7, 9)],
        [(2, 2), (6, 11)],
        # image 2: seed 1's coordinate is overwritten by seed 3 (keep-last
        # dedup), so the surviving minimum label is 2, NOT 1.
        [(4, w - 4), (9, 9), (4, w - 4), (h - 3, 3)],
    ][:b]
    if border_seed:
        seeds_list[1] = seeds_list[1] + [(0, 5)]
    labels0 = jnp.stack([paint_seeds((h, w), s) for s in seeds_list])
    imgs[:, 0, :] = NEVER_FILL
    imgs[:, -1, :] = NEVER_FILL
    imgs[:, :, 0] = NEVER_FILL
    imgs[:, :, -1] = NEVER_FILL
    hs = h + 1
    sep = np.full((b, hs, w), NEVER_FILL, dtype=np.uint8)
    sep[:, :h] = imgs
    labels0 = jnp.pad(labels0, ((0, 0), (0, 1), (0, 0)))
    stacked_img = jnp.asarray(sep.reshape(b * hs, w))
    stacked_lab = labels0.reshape(b * hs, w)
    return stacked_img, stacked_lab, seeds_list, (b, hs, h, w)


def test_batched_stack_unclaimed_cells_are_structural(rng):
    """On a clean stacked batch every per-image interior cell is claimed:
    the unclaimed interior cells are exactly the stacking structure's
    (3b-2)*(w-2) NEVER_FILL cells."""
    stacked_img, stacked_lab, _, (b, hs, h, w) = _stacked_merging_case(rng)
    _, L = relax_transform(stacked_img, stacked_lab)
    L = np.asarray(L)[1:-1, 1:-1]
    assert int((L > 254).sum()) == (3 * b - 2) * (w - 2)


@pytest.mark.parametrize("case", ["clean", "border_seed", "nan_blob"])
def test_batched_stack_matches_per_image(rng, case):
    """Relax merging on the stacked plane must equal per-image transforms
    (and the level sweep) — border seeds of adjacent images and NaN blobs
    included."""
    stacked_img, stacked_lab, _, (b, hs, h, w) = _stacked_merging_case(
        rng, border_seed=(case == "border_seed"), nan_blob=(case == "nan_blob")
    )
    kw = dict(n_labels=16, max_water_level=254, merging=True)
    got = run_levels_impl(stacked_img, stacked_lab, backend="relax", **kw)
    got3 = np.asarray(got).reshape(b, hs, w)[:, :h]
    for i in range(b):
        img_i = np.asarray(stacked_img).reshape(b, hs, w)[i, :h]
        lab_i = np.asarray(stacked_lab).reshape(b, hs, w)[i, :h]
        single = run_levels_impl(
            jnp.asarray(img_i), jnp.asarray(lab_i), backend="jnp", **kw
        )
        np.testing.assert_array_equal(got3[i], np.asarray(single))


def test_transform_batch_merging_matches_per_image(rng):
    """Public API: batched merging (auto engine) is bit-identical to
    per-image transforms on a clean batch."""
    from rustronomy_watershed_tpu import TransformBuilder

    b, h, w = 3, 18, 22
    imgs = rng.integers(0, 254, size=(b, h, w)).astype(np.uint8)
    ws = TransformBuilder.default().build_merging()
    seeds_list = [ws.find_local_minima(im) for im in imgs]
    batched = ws.transform_batch(imgs, seeds_list)
    for i in range(b):
        single = ws.transform(imgs[i], seeds_list[i])
        np.testing.assert_array_equal(batched[i], single, err_msg=f"img{i}")


def test_nan_corner_merging_matches_oracle(rng):
    """A NaN-laced corner (the general component tail is live) through the
    public merging transform equals the C++ oracle."""
    native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    from rustronomy_watershed_tpu import TransformBuilder

    img = rng.integers(0, 254, (64, 96)).astype(np.uint8)
    img[20:28, 30:50] = 255
    ws = TransformBuilder.default().build_merging()
    seeds = ws.find_local_minima(img)
    want = native.native_transform(img, seeds, 254, merging=True)
    np.testing.assert_array_equal(ws.transform(img, seeds), want)
