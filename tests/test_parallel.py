"""Multi-device tests on the 8-device virtual CPU mesh: the tiled shard_map
path must produce bit-identical labels to the single-device driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from rustronomy_watershed_tpu.ops import paint_seeds, run_levels
from rustronomy_watershed_tpu.parallel import make_mesh, tiled_transform

MAXLVL = 10


def _case(rng, shape=(32, 32)):
    img = rng.integers(0, MAXLVL + 2, size=shape).astype(np.uint8)
    # A handful of fixed seeds scattered around
    seeds = [(3, 3), (3, shape[1] - 4), (shape[0] - 4, 5), (16, 16), (20, 9)]
    labels0 = paint_seeds(shape, seeds)
    return img, labels0, len(seeds)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("halo", [1, 3])
def test_tiled_matches_single_device(rng, merging, halo):
    img, labels0, k = _case(rng)
    want = np.asarray(
        run_levels(
            jnp.asarray(img),
            labels0,
            n_labels=k,
            max_water_level=MAXLVL,
            merging=merging,
        )
    )
    mesh = make_mesh(8)  # 2 x 4 over virtual CPU devices
    assert mesh.shape == {"y": 2, "x": 4}
    got = np.asarray(
        tiled_transform(
            img,
            labels0,
            mesh,
            n_labels=k,
            max_water_level=MAXLVL,
            merging=merging,
            halo=halo,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_tiled_sizes_match_single_device(rng):
    img, labels0, k = _case(rng)
    _, want = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=True, collect="sizes",
    )
    mesh = make_mesh(8)
    final, sizes = tiled_transform(
        img, labels0, mesh, n_labels=k, max_water_level=MAXLVL,
        merging=True, halo=2, collect="sizes",
    )
    np.testing.assert_array_equal(np.asarray(sizes), np.asarray(want)[:, : k + 1])


def test_tiled_batched_with_dp_axis(rng):
    # batch x spatial: mesh ('batch', 'y', 'x') = (2, 2, 2); each batch element
    # must match its own single-device transform.
    imgs = rng.integers(0, MAXLVL + 2, size=(4, 16, 16)).astype(np.uint8)
    seeds = [(3, 3), (12, 12), (8, 4)]
    labels0 = np.stack([np.asarray(paint_seeds((16, 16), seeds))] * 4)
    devs = np.asarray(jax.devices()).reshape(2, 2, 2)
    mesh = Mesh(devs, ("batch", "y", "x"))
    got = np.asarray(
        tiled_transform(
            imgs, labels0, mesh, n_labels=len(seeds), max_water_level=MAXLVL,
            merging=True, halo=2, axis_batch="batch",
        )
    )
    for i in range(4):
        want = np.asarray(
            run_levels(
                jnp.asarray(imgs[i]), jnp.asarray(labels0[i]),
                n_labels=len(seeds), max_water_level=MAXLVL, merging=True,
            )
        )
        np.testing.assert_array_equal(got[i], want, err_msg=f"batch {i}")


def test_vmap_batching_matches_loop(rng):
    # Pure vmap batching (single device) of the jitted driver.
    from functools import partial

    imgs = rng.integers(0, 8, size=(3, 12, 12)).astype(np.uint8)
    seeds = [(2, 2), (9, 9)]
    lab0 = jnp.asarray(np.stack([np.asarray(paint_seeds((12, 12), seeds))] * 3))
    f = jax.vmap(
        partial(run_levels, n_labels=2, max_water_level=7, merging=False)
    )
    got = np.asarray(f(jnp.asarray(imgs), lab0))
    for i in range(3):
        want = np.asarray(
            run_levels(jnp.asarray(imgs[i]), lab0[i], n_labels=2,
                       max_water_level=7, merging=False)
        )
        np.testing.assert_array_equal(got[i], want)


def test_indivisible_shape_pads_and_matches(rng):
    """Non-divisible shapes no longer raise (round-2 change): they embed in
    an inert padded plane and bit-match the single-device run."""
    img, labels0, k = _case(rng, shape=(30, 30))
    want = np.asarray(
        run_levels(
            jnp.asarray(img), labels0, n_labels=k, max_water_level=3,
            merging=False,
        )
    )
    got = np.asarray(
        tiled_transform(img, labels0, make_mesh(8), n_labels=k, max_water_level=3)
    )
    np.testing.assert_array_equal(got, want)


def test_model_transform_batch_and_mesh(rng):
    from rustronomy_watershed_tpu import TransformBuilder

    imgs = rng.integers(0, 10, size=(3, 16, 16)).astype(np.uint8)
    ws = TransformBuilder.default().set_max_water_lvl(8).build_segmenting()
    seeds_list = [ws.find_local_minima(im) for im in imgs]
    batched = ws.transform_batch(imgs, seeds_list)
    for i in range(3):
        single = ws.transform(imgs[i], seeds_list[i])
        np.testing.assert_array_equal(batched[i], single)

    # mesh-routed single transform matches
    mesh = make_mesh(8)
    wsm = (
        TransformBuilder.default().set_max_water_lvl(8).set_mesh(mesh).build_merging()
    )
    ws1 = TransformBuilder.default().set_max_water_lvl(8).build_merging()
    img = rng.integers(0, 9, size=(32, 32)).astype(np.uint8)
    seeds = ws1.find_local_minima(img)
    np.testing.assert_array_equal(wsm.transform(img, seeds), ws1.transform(img, seeds))

    # batch mesh axis
    devs = np.asarray(jax.devices()).reshape(2, 2, 2)
    bmesh = Mesh(devs, ("batch", "y", "x"))
    wsb = (
        TransformBuilder.default()
        .set_max_water_lvl(8)
        .set_mesh(bmesh)
        .build_segmenting()
    )
    imgs2 = rng.integers(0, 9, size=(2, 16, 16)).astype(np.uint8)
    seeds2 = [wsb.find_local_minima(im) for im in imgs2]
    # pad seed lists to equal length labels via bucket; per-image seeds differ
    out = wsb.transform_batch(imgs2, seeds2)
    for i in range(2):
        np.testing.assert_array_equal(out[i], ws.transform(imgs2[i], seeds2[i]))


def test_transform_batch_merging_and_edge_correction(rng):
    # The stacked-relax batch path (models/base.transform_batch): merging and
    # edge-corrected batches must match per-image transforms bit-exactly.
    from rustronomy_watershed_tpu import TransformBuilder

    imgs = rng.integers(0, 12, size=(3, 18, 14)).astype(np.uint8)
    for edge in (False, True):
        for build in ("build_merging", "build_segmenting"):
            b = TransformBuilder.default().set_max_water_lvl(11)
            if edge:
                b = b.enable_edge_correction()
            ws = getattr(b, build)()
            seeds_list = [ws.find_local_minima(im) for im in imgs]
            batched = ws.transform_batch(imgs, seeds_list)
            for i in range(3):
                single = ws.transform(imgs[i], seeds_list[i])
                np.testing.assert_array_equal(
                    batched[i], single, err_msg=f"{build} edge={edge} img{i}"
                )


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("halo", [2, 4])
def test_tiled_relax_matches_single_device(rng, merging, halo):
    # The tiled priority-relaxation engine (parallel/tiled._local_relax_driver)
    # must be bit-identical to the single-device driver.
    img, labels0, k = _case(rng)
    want = np.asarray(
        run_levels(jnp.asarray(img), labels0, n_labels=k,
                   max_water_level=MAXLVL, merging=merging)
    )
    got = np.asarray(
        tiled_transform(img, labels0, make_mesh(8), n_labels=k,
                        max_water_level=MAXLVL, merging=merging, halo=halo,
                        backend="relax")
    )
    np.testing.assert_array_equal(got, want)


def test_tiled_relax_sizes_and_history(rng):
    img, labels0, k = _case(rng)
    want_lab, want_sz = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=False, collect="sizes",
    )
    lab, sz = tiled_transform(img, labels0, make_mesh(8), n_labels=k,
                              max_water_level=MAXLVL, merging=False, halo=3,
                              collect="sizes", backend="relax")
    np.testing.assert_array_equal(np.asarray(lab), np.asarray(want_lab))
    np.testing.assert_array_equal(np.asarray(sz), np.asarray(want_sz))

    _, want_hist = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=False, collect="history",
    )
    _, hist = tiled_transform(img, labels0, make_mesh(8), n_labels=k,
                              max_water_level=MAXLVL, merging=False, halo=3,
                              collect="history", backend="relax")
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(want_hist))


def test_tiled_history_merging_sweep(rng):
    # Merging per-level history needs the sweep engine (per-level unions).
    img, labels0, k = _case(rng)
    _, want_hist = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=True, collect="history", backend="jnp",
    )
    _, hist = tiled_transform(img, labels0, make_mesh(8), n_labels=k,
                              max_water_level=MAXLVL, merging=True, halo=2,
                              collect="history")
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(want_hist))


@pytest.mark.parametrize("merging", [False, True])
def test_tiled_relax_2x2_wide_halo_matches_oracle(rng, merging):
    # The tiled relax engine on the 2x2 mesh with a halo as wide as half a
    # tile (many sweeps per exchange) must equal the C++ oracle.
    native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    img, labels0, k = _case(rng)
    seeds = [tuple(int(v) for v in c) for c in np.argwhere(np.asarray(labels0))]
    order = np.asarray(labels0)[tuple(np.asarray(seeds).T)]
    seeds = [seeds[i] for i in np.argsort(order)]
    want = native.native_transform(img, seeds, MAXLVL, merging=merging)
    mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    got = np.asarray(
        tiled_transform(img, labels0, mesh22, n_labels=k,
                        max_water_level=MAXLVL, merging=merging, halo=8,
                        backend="relax")
    )
    np.testing.assert_array_equal(got, want)


def test_tiled_relax_sizes_history_and_batch_2x2(rng):
    img, labels0, k = _case(rng)
    want_lab, want_sz = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=False, collect="sizes",
    )
    lab, sz = tiled_transform(img, labels0, make_mesh(8), n_labels=k,
                              max_water_level=MAXLVL, merging=False, halo=8,
                              collect="sizes", backend="relax")
    np.testing.assert_array_equal(np.asarray(lab), np.asarray(want_lab))
    np.testing.assert_array_equal(np.asarray(sz), np.asarray(want_sz))

    _, want_hist = run_levels(
        jnp.asarray(img), labels0, n_labels=k, max_water_level=MAXLVL,
        merging=False, collect="history",
    )
    mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    _, hist = tiled_transform(img, labels0, mesh22, n_labels=k,
                              max_water_level=MAXLVL, merging=False, halo=8,
                              collect="history", backend="relax")
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(want_hist))

    # batch(dp) x spatial mesh
    imgs = rng.integers(0, MAXLVL + 2, size=(4, 16, 16)).astype(np.uint8)
    seeds = [(3, 3), (12, 12), (8, 4)]
    lab0 = np.stack([np.asarray(paint_seeds((16, 16), seeds))] * 4)
    bmesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2), ("batch", "y", "x"))
    got = np.asarray(
        tiled_transform(imgs, lab0, bmesh, n_labels=3, max_water_level=MAXLVL,
                        merging=True, halo=8, axis_batch="batch",
                        backend="relax")
    )
    for i in range(4):
        want = np.asarray(
            run_levels(jnp.asarray(imgs[i]), jnp.asarray(lab0[i]), n_labels=3,
                       max_water_level=MAXLVL, merging=True)
        )
        np.testing.assert_array_equal(got[i], want, err_msg=f"batch {i}")


@pytest.mark.parametrize("backend", ["relax_pallas", "pallas"])
def test_tiled_removed_backend_raises(rng, backend):
    # Engines this package no longer has are refused by name, never run.
    img = rng.integers(0, 5, size=(16, 16)).astype(np.uint8)
    labels0 = paint_seeds((16, 16), [(3, 3), (12, 12)])
    with pytest.raises(ValueError, match="accepted"):
        tiled_transform(img, labels0, make_mesh(8), n_labels=2,
                        max_water_level=3, backend=backend)


@pytest.mark.parametrize("trial", range(4))
def test_tiled_relax_randomised(trial):
    # Randomised differential: the tiled relax engine vs the single-device
    # driver on random shapes/meshes/ranges (sentinels sprinkled in).
    rng = np.random.default_rng(7000 + trial)
    ny, nx = [(2, 2), (2, 4), (1, 4), (4, 2)][trial]
    h = int(rng.integers(2, 4)) * 8 * ny
    w = nx * max(8, int(rng.integers(1, 3)) * 16)
    hi = int(rng.choice([4, 16, 254]))
    maxlvl = int(rng.choice([2, hi // 2 + 1, 254]))
    merging = bool(rng.integers(0, 2))
    img = rng.integers(0, hi, size=(h, w)).astype(np.uint8)
    img[rng.random((h, w)) < 0.02] = 0
    img[rng.random((h, w)) < 0.02] = 255
    n_seeds = int(rng.integers(2, 7))
    coords = {(int(rng.integers(0, h)), int(rng.integers(0, w))) for _ in range(n_seeds)}
    seeds = sorted(coords)
    lab0 = paint_seeds((h, w), seeds)
    want = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=len(seeds),
                   max_water_level=maxlvl, merging=merging)
    )
    devs = np.asarray(jax.devices()[: ny * nx]).reshape(ny, nx)
    mesh = Mesh(devs, ("y", "x"))
    got = np.asarray(
        tiled_transform(img, lab0, mesh, n_labels=len(seeds),
                        max_water_level=maxlvl, merging=merging, halo=8,
                        backend="relax")
    )
    np.testing.assert_array_equal(
        got, want,
        err_msg=f"trial={trial} mesh={ny}x{nx} {h}x{w} hi={hi} "
                f"maxlvl={maxlvl} merging={merging}",
    )


def test_transform_batch_merging_border_seeds(rng):
    # Regression (r2 review): on the stacked batch plane an inner image's
    # rows 0/H-1 are not global-border rows, so the component scan would
    # merge border-seed pairs the per-image semantics keep apart — and
    # facing border seeds of ADJACENT images must never merge.
    from rustronomy_watershed_tpu import TransformBuilder

    h, w = 12, 16
    imgs = rng.integers(0, 6, size=(3, h, w)).astype(np.uint8)
    ws = TransformBuilder.default().set_max_water_lvl(5).build_merging()
    # border seeds: adjacent pair in each image's row 0, plus facing seeds
    # across the image-boundary rows of images 0/1.
    seeds_list = [
        [(0, 4), (0, 5), (h - 1, 7), (6, 6)],
        [(0, 7), (0, 2), (5, 5)],
        [(0, 1), (h - 1, 3), (4, 9)],
    ]
    batched = ws.transform_batch(imgs, seeds_list)
    for i in range(3):
        single = ws.transform(imgs[i], seeds_list[i])
        np.testing.assert_array_equal(batched[i], single, err_msg=f"img{i}")


def test_auto_backend_resolution():
    """Tiled 'auto': the relax engine wherever it applies, the per-level
    sweep only for merging statistics — decided by the call, not the
    platform or the tile geometry."""
    from rustronomy_watershed_tpu.parallel.tiled import _auto_backend

    for collect in ("none", "sizes", "history", "claims"):
        assert _auto_backend(False, collect) == "relax"
    assert _auto_backend(True, "none") == "relax"
    assert _auto_backend(True, "sizes") == "sweep"
    assert _auto_backend(True, "history") == "sweep"


@pytest.mark.parametrize("merging", [False, True])
def test_tiled_nondivisible_shapes_match_single_device(rng, merging):
    """tiled_transform embeds non-divisible images in an inert padded plane
    (VERDICT r1 missing #3): results must bit-match the single-device run."""
    shape = (35, 29)  # not divisible by the 2x4 mesh
    img = rng.integers(0, MAXLVL + 2, size=shape).astype(np.uint8)
    seeds = [(3, 3), (33, 27), (16, 14), (1, 28), (34, 1)]  # incl. border seeds
    labels0 = paint_seeds(shape, seeds)
    if merging:
        want_lab, want_sizes = (
            run_levels(jnp.asarray(img), labels0, n_labels=5,
                       max_water_level=MAXLVL, merging=True),
            None,
        )
    else:
        want_lab, want_sizes = run_levels(
            jnp.asarray(img), labels0, n_labels=5, max_water_level=MAXLVL,
            merging=False, collect="sizes",
        )
    mesh = make_mesh(8)
    got = tiled_transform(
        img, labels0, mesh, n_labels=5, max_water_level=MAXLVL,
        merging=merging, collect="none" if merging else "sizes",
    )
    if merging:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want_lab))
    else:
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want_lab))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want_sizes))


def test_tiled_nondivisible_history_and_sweep_backend(rng):
    shape = (13, 21)
    img = rng.integers(0, 6, size=shape).astype(np.uint8)
    seeds = [(2, 2), (10, 18), (6, 11)]
    labels0 = paint_seeds(shape, seeds)
    _, want = run_levels(
        jnp.asarray(img), labels0, n_labels=3, max_water_level=5,
        merging=True, collect="history",
    )
    mesh = make_mesh(8)
    _, got = tiled_transform(
        img, labels0, mesh, n_labels=3, max_water_level=5,
        merging=True, collect="history",
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("merging", [False, True])
def test_mesh_hook_views_match_single_device(rng, merging):
    """VERDICT r1 missing #2: hooks must run under the mesh runtime with
    per-level HookCtx views bit-matching the single-device host-stepped run."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 8, size=(24, 24)).astype(np.uint8)

    def snap(ctx):
        return (ctx.water_level, ctx.colours.copy(), ctx.image.copy(), ctx.seeds)

    def build(mesh):
        b = (TransformBuilder.default().set_max_water_lvl(7)
             .set_wlvl_hook(snap))
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_merging() if merging else b.build_segmenting()

    ws_single = build(None)
    seeds = ws_single.find_local_minima(img) or [(3, 3), (20, 20)]
    want = ws_single.transform_with_hook(img, seeds)
    got = build(make_mesh(8)).transform_with_hook(img, seeds)
    assert len(got) == len(want) == 8
    for (lw, cw, iw, sw), (lg, cg, ig, sg) in zip(want, got):
        assert lw == lg
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(ig, iw)
        assert sg == sw


def test_mesh_edge_correction_transform_and_to_list(rng):
    """VERDICT r1 missing #3: edge correction ((H+2, W+2) domain) must
    compose with a mesh the padded shape does not divide by."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    # (29+2, 27+2) = (31, 29): neither divides by the 2x4 mesh.
    img = rng.integers(1, 10, size=(29, 27)).astype(np.uint8)

    def build(mesh):
        b = (TransformBuilder.default().set_max_water_lvl(9)
             .enable_edge_correction())
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_merging()

    ws_single = build(None)
    seeds = ws_single.find_local_minima(img) or [(5, 5)]
    want = np.asarray(ws_single.transform(img, seeds))
    got = np.asarray(build(make_mesh(8)).transform(img, seeds))
    np.testing.assert_array_equal(got, want)

    want_list = ws_single.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    got_list = build(make_mesh(8)).transform_to_list(
        img, seeds, counts_length=len(seeds) + 1
    )
    for (lw, cw), (lg, cg) in zip(want_list, got_list):
        assert lw == lg
        np.testing.assert_array_equal(cg, cw)


def test_mesh_segmenting_to_list_matches_single(rng):
    """Segmenting transform_to_list on a mesh now rides the same
    collect='claims' compact-planes path as merging (one tiled relax pass +
    host cumulative counts, zero edges) — must match the single-device
    level-sweep result row-for-row, including on a non-dividing shape."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 12, size=(29, 27)).astype(np.uint8)

    def build(mesh):
        b = TransformBuilder.default().set_max_water_lvl(11)
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_segmenting()

    ws_single = build(None)
    seeds = ws_single.find_local_minima(img) or [(5, 5), (20, 20)]
    want = ws_single.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    got = build(make_mesh(8)).transform_to_list(
        img, seeds, counts_length=len(seeds) + 1
    )
    assert len(got) == len(want) == 12
    for (lw, cw), (lg, cg) in zip(want, got):
        assert lw == lg
        np.testing.assert_array_equal(cg, cw)


@pytest.mark.parametrize("merging", [False, True])
def test_mesh_transform_history_matches_single(rng, merging):
    """Public transform_history on a mesh rides the collect='claims'
    compact-planes rebuild — must match the single-device result
    plane-for-plane (non-dividing shape)."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 10, size=(27, 29)).astype(np.uint8)

    def build(mesh):
        b = TransformBuilder.default().set_max_water_lvl(9)
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_merging() if merging else b.build_segmenting()

    ws_single = build(None)
    seeds = ws_single.find_local_minima(img) or [(5, 5), (20, 20)]
    want = ws_single.transform_history(img, seeds)
    got = build(make_mesh(8)).transform_history(img, seeds)
    assert len(got) == len(want) == 10
    for (lw, cw), (lg, cg) in zip(want, got):
        assert lw == lg
        np.testing.assert_array_equal(cg, cw, err_msg=f"lvl={lw}")


def test_mesh_hook_with_edge_correction_and_progress(rng, tmp_path, capsys):
    """Full observability stack (hook + progress + plots) on the mesh with
    edge correction: views bit-match the single-device run (padded shape,
    Q7 semantics)."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 6, size=(21, 19)).astype(np.uint8)

    def build(mesh, plots):
        b = (TransformBuilder.default().set_max_water_lvl(5)
             .enable_edge_correction().enable_progress()
             .set_wlvl_hook(lambda ctx: ctx.colours.copy()))
        if plots:
            b = b.set_plot_folder(plots)
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_segmenting()

    ws_single = build(None, None)
    seeds = ws_single.find_local_minima(img) or [(4, 4)]
    want = ws_single.transform_with_hook(img, seeds)
    plot_dir = tmp_path / "plots"
    plot_dir.mkdir()
    got = build(make_mesh(8), plot_dir).transform_with_hook(img, seeds)
    capsys.readouterr()  # swallow progress bar output
    assert len(got) == len(want) == 6
    for cw, cg in zip(want, got):
        assert cw.shape == (23, 21)  # padded (H+2, W+2) view — Q7
        np.testing.assert_array_equal(cg, cw)
    assert sorted(p.name for p in plot_dir.iterdir()) == [
        f"ws_lvl{i}.png" for i in range(6)
    ]


@pytest.mark.parametrize("use_mesh", [False, True])
def test_batch_edge_correction_matches_per_image(rng, use_mesh):
    """transform_batch composes with edge correction (padded (H+2, W+2)
    domains) with and without a dp x spatial mesh (VERDICT r1 missing #3)."""
    from jax.sharding import Mesh
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    imgs = rng.integers(0, 10, size=(2, 15, 17)).astype(np.uint8)

    def build(mesh):
        b = (TransformBuilder.default().set_max_water_lvl(9)
             .enable_edge_correction())
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_merging()

    single = build(None)
    seeds_list = [single.find_local_minima(im) or [(3, 3)] for im in imgs]
    mesh = None
    if use_mesh:
        devs = np.asarray(jax.devices()[:8]).reshape(2, 2, 2)
        mesh = Mesh(devs, ("batch", "y", "x"))
    batched = build(mesh).transform_batch(imgs, seeds_list)
    assert batched.shape == (2, 17, 19)
    for i in range(2):
        want = np.asarray(single.transform(imgs[i], seeds_list[i]))
        np.testing.assert_array_equal(np.asarray(batched[i]), want)


def test_checkpoint_resume_on_mesh(tmp_path, rng):
    """Checkpoint/resume through the mesh-driven host-stepped loop: snapshots
    store the cropped domain and resume re-embeds it in the mesh-padded
    plane (MeshLevelStepper.prepare)."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 10, size=(21, 19)).astype(np.uint8)  # non-divisible
    mesh = make_mesh(8)
    base = (TransformBuilder.default().set_max_water_lvl(9)
            .build_segmenting())
    seeds = base.find_local_minima(img) or [(4, 4)]
    full = np.asarray(base.transform(img, seeds))

    ws = (TransformBuilder.default().set_max_water_lvl(5).set_mesh(mesh)
          .set_checkpoint(tmp_path, every=3)
          .set_wlvl_hook(lambda ctx: ctx.water_level).build_segmenting())
    assert ws.transform_with_hook(img, seeds) == list(range(6))

    hook_levels = []
    ws2 = (TransformBuilder.default().set_max_water_lvl(9).set_mesh(mesh)
           .set_checkpoint(tmp_path, every=3)
           .set_wlvl_hook(
               lambda ctx: hook_levels.append(ctx.water_level) or ctx.colours.copy()
           ).build_segmenting())
    out2 = ws2.transform_with_hook(img, seeds)
    assert hook_levels[0] == 4
    np.testing.assert_array_equal(out2[-1], full)


@pytest.mark.parametrize("trial", range(3))
def test_mesh_merging_to_list_differential(rng, trial):
    """Randomised differential for the mesh merge-curve path (collect='claims'
    + host Kruskal) vs the single-device entry point, varying shape/content."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    shape = [(24, 24), (19, 33), (40, 22)][trial]
    hi = [6, 14, 30][trial]
    img = rng.integers(0, hi, size=shape).astype(np.uint8)

    def build(mesh):
        b = TransformBuilder.default().set_max_water_lvl(hi - 1)
        if mesh is not None:
            b = b.set_mesh(mesh)
        return b.build_merging()

    single = build(None)
    seeds = single.find_local_minima(img) or [(2, 2)]
    want = single.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    got = build(make_mesh(8)).transform_to_list(
        img, seeds, counts_length=len(seeds) + 1
    )
    for (lw, cw), (lg, cg) in zip(want, got):
        assert lw == lg
        np.testing.assert_array_equal(cg, cw, err_msg=f"trial {trial} lvl {lw}")


def test_with_stats_rounds_and_parity(rng):
    """tiled_transform(with_stats=True) returns the replicated exchange-round
    count without perturbing the labels; other engines refuse it."""
    img = rng.integers(0, 40, size=(64, 64)).astype(np.uint8)
    from rustronomy_watershed_tpu.ops.seeds import (
        local_extrema_mask,
        seed_labels_from_mask,
    )

    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    k = int(np.asarray(lab0).max())
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    out, rounds = tiled_transform(
        img, lab0, mesh, n_labels=k, max_water_level=254,
        backend="relax", halo=8, with_stats=True,
    )
    assert np.asarray(rounds).shape == () and int(rounds) >= 2
    want = tiled_transform(
        img, lab0, mesh, n_labels=k, max_water_level=254, backend="relax", halo=8,
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    with pytest.raises(ValueError):
        tiled_transform(
            img, lab0, mesh, n_labels=k, max_water_level=254,
            backend="sweep", with_stats=True,
        )


@pytest.mark.parametrize("halo", [None, 4])
def test_exchange_rounds_equal_across_mesh_shapes(rng, halo):
    """k local relax sweeps on a k-px halo are k global sweeps, so every
    mesh shape runs exactly as many exchange rounds as the 1x1 mesh (at the
    default halo and a narrow one), with bit-identical labels."""
    img = rng.integers(0, 254, size=(64, 64)).astype(np.uint8)
    from rustronomy_watershed_tpu.ops.seeds import (
        local_extrema_mask,
        seed_labels_from_mask,
    )

    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    k = int(np.asarray(lab0).max())
    devs = jax.devices()

    def rounds_for(ny, nx):
        mesh = Mesh(np.asarray(devs[: ny * nx]).reshape(ny, nx), ("y", "x"))
        out, rounds = tiled_transform(
            img, lab0, mesh, n_labels=k, max_water_level=254,
            backend="relax", halo=halo, with_stats=True,
        )
        return np.asarray(out), int(rounds)

    ref, r11 = rounds_for(1, 1)
    for ny, nx in ((1, 2), (2, 2), (2, 4)):
        out, r = rounds_for(ny, nx)
        np.testing.assert_array_equal(out, ref)
        assert r == r11, (ny, nx, r, r11)
