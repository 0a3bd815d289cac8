"""Fast merging engine: scan-based component-min + edge-union level curves.

Pins bit-parity of the relax-based merging paths (ops.scan_merge,
ops.merge_curve) against the level-sweep merging driver and the C++ oracle
(parity/oracle.cc, /root/reference/src/lib.rs:1446-1470 semantics), and the
component-min tail against ops.merge.merge_touching and a host union-find.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rustronomy_watershed_tpu.ops.level_driver import run_levels
from rustronomy_watershed_tpu.ops.merge import merge_touching
from rustronomy_watershed_tpu.ops.merge_curve import (
    merge_edges,
    merged_sizes_host,
    relax_merging_sizes,
)
from rustronomy_watershed_tpu.ops.scan_merge import component_min_labels
from rustronomy_watershed_tpu.ops.seeds import (
    local_extrema_mask,
    paint_seeds,
    seed_labels_from_mask,
)


def _native():
    return pytest.importorskip("rustronomy_watershed_tpu.parity.native")


def _seeds_of(lab0):
    """Seed coordinates in label order (labels are row-major numbered)."""
    return [tuple(int(v) for v in c) for c in np.argwhere(np.asarray(lab0))]


def _union_find_component_min(lab):
    """Host oracle: min label per 4-connected component of nonzero pixels,
    border-border pairs blocked (reference window-centre rule)."""
    h, w = lab.shape
    parent = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    idx = lambda y, x: y * w + x  # noqa: E731
    for y in range(h):
        for x in range(w):
            if lab[y, x] == 0:
                continue
            # blocked border-border pairs: h-edges in rows {0, h-1},
            # v-edges in cols {0, w-1} (reference window-centre rule)
            if x + 1 < w and lab[y, x + 1] != 0 and y not in (0, h - 1):
                union(idx(y, x), idx(y, x + 1))
            if y + 1 < h and lab[y + 1, x] != 0 and x not in (0, w - 1):
                union(idx(y, x), idx(y + 1, x))
    comp_min = {}
    for y in range(h):
        for x in range(w):
            if lab[y, x]:
                r = find(idx(y, x))
                comp_min[r] = min(comp_min.get(r, 1 << 30), int(lab[y, x]))
    want = np.zeros_like(lab)
    for y in range(h):
        for x in range(w):
            if lab[y, x]:
                want[y, x] = comp_min[find(idx(y, x))]
    return want


def _field(rng, shape, hi):
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    k = int(jnp.max(lab0))
    if k == 0:
        lab0 = paint_seeds(shape, [(2, 2), (shape[0] - 3, shape[1] - 3)])
        k = 2
    return img, lab0, k


@pytest.mark.parametrize("shape,hi,maxlvl", [((40, 52), 20, 18), ((32, 32), 254, 254), ((50, 44), 4, 2)])
@pytest.mark.parametrize("oracle", ["level_sweep", "native"])
def test_component_min_matches_level_sweep_merging(rng, shape, hi, maxlvl, oracle):
    img, lab0, k = _field(rng, shape, hi)
    if oracle == "native":
        want = _native().native_transform(img, _seeds_of(lab0), maxlvl, merging=True)
    else:
        want = np.asarray(
            run_levels(jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
                       merging=True, backend="jnp")
        )
    seg = run_levels(jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
                     merging=False, backend="relax")
    got = np.asarray(component_min_labels(jnp.asarray(seg)))
    np.testing.assert_array_equal(got, want)


def test_component_min_blocked_border_edges():
    # Two seeds adjacent along the top border: the reference's interior-
    # centred windows never detect the pair, so they must NOT merge.
    lab = np.zeros((6, 8), np.int32)
    lab[0, 3], lab[0, 4] = 5, 9
    out = np.asarray(component_min_labels(jnp.asarray(lab)))
    assert out[0, 3] == 5 and out[0, 4] == 9
    # ... but a border pixel connected through an interior pixel does merge.
    lab2 = np.zeros((6, 8), np.int32)
    lab2[0, 3], lab2[1, 3], lab2[1, 4], lab2[0, 4] = 5, 5, 9, 9
    out2 = np.asarray(component_min_labels(jnp.asarray(lab2)))
    assert (out2[lab2 > 0] == 5).all()


@pytest.mark.parametrize("shape,hi,maxlvl", [((40, 52), 20, 18), ((48, 36), 254, 254), ((56, 56), 4, 3)])
@pytest.mark.parametrize("oracle", ["level_sweep", "native"])
def test_relax_merging_sizes_matches_level_sweep(rng, shape, hi, maxlvl, oracle):
    img, lab0, k = _field(rng, shape, hi)
    if oracle == "native":
        want_lab, want_sz = _native().native_transform(
            img, _seeds_of(lab0), maxlvl, merging=True, with_sizes=True
        )
    else:
        want_lab, want_sz = run_levels(
            jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
            merging=True, backend="jnp", collect="sizes",
        )
    got_lab, got_sz = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
    )
    np.testing.assert_array_equal(np.asarray(got_lab), np.asarray(want_lab))
    np.testing.assert_array_equal(np.asarray(got_sz), np.asarray(want_sz))


@pytest.mark.parametrize(
    "shape,hi,maxlvl",
    [((40, 52), 20, 18), ((48, 36), 254, 254), ((56, 56), 4, 3)],
)
@pytest.mark.parametrize("oracle", ["level_sweep", "native"])
def test_relax_segmenting_sizes_matches_level_sweep(rng, shape, hi, maxlvl, oracle):
    """merging=False: the segmenting curves from ONE relax pass (cumulative
    claim counts, zero edges) must match the per-level sweep driver and the
    C++ oracle column-for-column — this is the compact-planes path the
    public segmenting transform_to_list takes."""
    img, lab0, k = _field(rng, shape, hi)
    if oracle == "native":
        want_lab, want_sz = _native().native_transform(
            img, _seeds_of(lab0), maxlvl, merging=False, with_sizes=True
        )
    else:
        want_lab, want_sz = run_levels(
            jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
            merging=False, backend="jnp", collect="sizes",
        )
    got_lab, got_sz = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=maxlvl,
        merging=False,
    )
    np.testing.assert_array_equal(np.asarray(got_lab), np.asarray(want_lab))
    np.testing.assert_array_equal(np.asarray(got_sz), np.asarray(want_sz))


def test_relax_segmenting_sizes_never_fill(rng):
    """NEVER_FILL (255) pixels stay uncoloured at every level: the compact
    path's uncoloured column must track the sweep driver's exactly."""
    img = rng.integers(0, 200, size=(44, 40)).astype(np.uint8)
    img[::7, ::5] = 255
    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    k = int(jnp.max(lab0))
    _, want = run_levels(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=254,
        merging=False, backend="jnp", collect="sizes",
    )
    _, got = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=254, merging=False,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_segmenting_transform_to_list_public_api(rng):
    # Public surface: segmenting transform_to_list identical between the
    # compact-planes fast path (auto backend) and the level-sweep driver.
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 30, size=(28, 36)).astype(np.uint8)
    fast = TransformBuilder.default().set_max_water_lvl(29).build_segmenting()
    slow = (
        TransformBuilder.default()
        .set_max_water_lvl(29)
        .set_backend("jnp")
        .build_segmenting()
    )
    seeds = fast.find_local_minima(img)
    a = fast.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    b = slow.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    assert len(a) == len(b) == 30
    for (la, ca), (lb, cb) in zip(a, b):
        assert la == lb
        np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("oracle", ["level_sweep", "native"])
def test_relax_history_matches_level_sweep(rng, merging, oracle):
    """Per-level snapshots rebuilt from the compact planes (segmenting:
    claim-level mask; merging: incremental union LUT gather) must equal the
    sweep driver's device-stacked history plane-for-plane, and the C++
    oracle's transform stopped at each level."""
    from rustronomy_watershed_tpu.ops.merge_curve import relax_history

    img, lab0, k = _field(rng, (40, 52), 20)
    if oracle == "native":
        seeds = _seeds_of(lab0)
        want = np.stack([
            _native().native_transform(img, seeds, lvl, merging=merging)
            for lvl in range(1, 19)
        ])
        first = 1  # the oracle needs max_water_level >= 1
    else:
        _, want = run_levels(
            jnp.asarray(img), lab0, n_labels=k, max_water_level=18,
            merging=merging, backend="jnp", collect="history",
        )
        want = np.asarray(want)
        first = 0
    snaps = relax_history(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=18, merging=merging,
    )
    assert len(snaps) == 19
    for lvl, snap in snaps[first:]:
        assert snap.dtype == np.int32
        np.testing.assert_array_equal(snap, want[lvl - first], err_msg=f"lvl={lvl}")


def test_relax_history_never_fill_full_depth(rng):
    from rustronomy_watershed_tpu.ops.merge_curve import relax_history

    img = rng.integers(0, 200, size=(36, 44)).astype(np.uint8)
    img[::6, ::7] = 255
    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    k = int(jnp.max(lab0))
    _, want = run_levels(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=254,
        merging=True, backend="jnp", collect="history",
    )
    want = np.asarray(want)
    snaps = relax_history(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=254, merging=True,
    )
    for lvl, snap in snaps:
        np.testing.assert_array_equal(snap, want[lvl], err_msg=f"lvl={lvl}")


def test_transform_history_public_api_both_variants(rng):
    # Public surface: transform_history identical between the compact-planes
    # fast path (auto backend) and the level-sweep driver, both variants.
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 14, size=(26, 30)).astype(np.uint8)
    for build in ("build_segmenting", "build_merging"):
        fast = getattr(
            TransformBuilder.default().set_max_water_lvl(13), build
        )()
        slow = getattr(
            TransformBuilder.default().set_max_water_lvl(13).set_backend("jnp"),
            build,
        )()
        seeds = fast.find_local_minima(img)
        a = fast.transform_history(img, seeds)
        b = slow.transform_history(img, seeds)
        assert len(a) == len(b) == 14
        for (la, ca), (lb, cb) in zip(a, b):
            assert la == lb
            np.testing.assert_array_equal(ca, cb, err_msg=build)


def test_relax_merging_sizes_packed_wire_tier(rng):
    """Label buckets in [2^16, 2^24) ship ONE packed uint32 plane (label |
    lv8<<24, merge_curve._device_curves) — n_labels is static, so forcing a
    big bucket on a small image exercises exactly the tier real >=65k-seed
    images take.  Sizes must match the small-bucket run column-for-column,
    and out_width must ride through."""
    img, lab0, k = _field(rng, (40, 52), 20)
    _, small = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=k, max_water_level=18,
    )
    _, packed = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=70_000, max_water_level=18,
    )
    assert packed.shape == (19, 70_001)
    np.testing.assert_array_equal(packed[:, : k + 1], small)
    assert (packed[:, k + 1 :] == 0).all()
    _, narrow = relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=70_000, max_water_level=18,
        out_width=k + 1,
    )
    np.testing.assert_array_equal(narrow, small)


def test_unpack_wire_roundtrip():
    from rustronomy_watershed_tpu.ops.merge_curve import unpack_wire

    r = np.random.default_rng(7)
    lab = r.integers(0, 2**24, size=257).astype(np.int32)
    lv = r.integers(0, 256, size=257).astype(np.uint8)
    wire = lab.astype(np.uint32) | (lv.astype(np.uint32) << 24)
    got_lab, got_lv = unpack_wire(wire)
    np.testing.assert_array_equal(got_lab, lab)
    np.testing.assert_array_equal(got_lv, lv)
    # Non-packed tiers pass through.
    got_lab, got_lv = unpack_wire(lab.astype(np.uint16), lv)
    assert got_lab.dtype == np.uint16 and got_lv is not None


def test_merge_edges_dedup_and_activation(rng):
    # Hand-checkable: two regions meeting along a line, claimed at known
    # levels -> one unique edge with the minimal activation level.
    s = jnp.asarray(np.array([
        [0, 0, 0, 0, 0],
        [0, 1, 1, 2, 0],
        [0, 1, 1, 2, 0],
        [0, 0, 0, 0, 0],
    ], np.int32))
    L = jnp.asarray(np.array([
        [9, 9, 9, 9, 9],
        [9, 0, 1, 3, 9],
        [9, 1, 2, 4, 9],
        [9, 9, 9, 9, 9],
    ], np.int32))
    lo, hi, act, n = merge_edges(s, L, max_water_level=8)
    n = int(n)
    assert n == 1
    assert (int(lo[0]), int(hi[0])) == (1, 2)
    # pairs (1@L1,2@L3) act 3 and (1@L2,2@L4) act 4 -> min 3
    assert int(act[0]) == 3


def test_merging_transform_to_list_public_api(rng):
    # Public surface: merging transform_to_list identical between the fast
    # relax path (backend auto on CPU -> relax) and the level-sweep backend.
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 30, size=(48, 48)).astype(np.uint8)
    ws_fast = TransformBuilder.default().set_max_water_lvl(29).build_merging()
    ws_slow = TransformBuilder.default().set_max_water_lvl(29).build_merging()
    ws_slow.backend = "jnp"
    seeds = ws_fast.find_local_minima(img)
    a = ws_fast.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    b = ws_slow.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    assert len(a) == len(b) == 30
    for (la, ca), (lb, cb) in zip(a, b):
        assert la == lb
        np.testing.assert_array_equal(ca, cb)


def test_relax_merging_full_depth_matches_level_sweep(rng):
    """The relax merging path (fixed point + component-min tail) at full
    depth must bit-match the level-sweep merging driver, with seeds next to
    the border."""
    img = rng.integers(0, 254, size=(40, 56)).astype(np.uint8)
    seeds = [(3, 3), (30, 50), (17, 22), (38, 5), (1, 54), (20, 33)]
    lab0 = paint_seeds(img.shape, seeds)
    want = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=6, max_water_level=254,
                   merging=True, backend="jnp")
    )
    got = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=6, max_water_level=254,
                   merging=True, backend="relax")
    )
    np.testing.assert_array_equal(got, want)


def test_component_min_spiral_needs_multiple_rounds(rng):
    """A serpentine component with high staircase complexity: the scan loop
    must NOT exit before the true component-min fixed point."""
    h = w = 48
    lab = np.zeros((h, w), np.int32)
    # serpentine corridor: rows 2,4,6,... filled, connected alternately at
    # the left/right ends; distinct labels along the way, min deep inside.
    nxt = 1000
    for r in range(2, h - 2, 2):
        lab[r, 2:-2] = nxt
        nxt += 7
        if r + 2 < h - 2:
            col = 2 if (r // 2) % 2 == 0 else w - 3
            lab[r + 1, col] = nxt
            nxt += 3
    lab[h - 4, w // 2] = 5  # the minimum, far (in scan rounds) from the ends
    want = np.asarray(merge_touching(jnp.asarray(lab), int(lab.max())))
    got, rounds = component_min_labels(jnp.asarray(lab), collect_rounds=True)
    np.testing.assert_array_equal(np.asarray(got), want)
    # every corridor turn costs a round: the loop must not stop early
    assert int(rounds) > 2


def test_native_merged_curve_matches_numpy(rng):
    """The C++ one-pass to_list tail (parity/oracle.cc merged_curve_oracle)
    must be bit-identical to the NumPy host_cumulative_counts +
    merged_sizes_host pair on randomized planes/edge sets, including
    never-claimed pixels, labels masked above max level, and multi-edge
    transitive unions."""
    native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    from rustronomy_watershed_tpu.ops.merge_curve import host_cumulative_counts

    for trial in range(5):
        r = np.random.default_rng(500 + trial)
        npx, k = 4000, 37
        maxlvl = int(r.choice([5, 40, 254]))
        levels = maxlvl + 1
        labels = r.integers(0, k + 1, size=npx).astype(np.int32)
        lv8 = r.integers(0, levels + 1, size=npx).astype(np.uint8)
        # claimed-ness invariant: label 0 <=> never-claimed bucket
        lv8[labels == 0] = levels
        labels[lv8 == levels] = 0
        ne = int(r.integers(0, 60))
        lo = r.integers(1, k, size=ne).astype(np.int32)
        hi = (lo + r.integers(1, k - 1, size=ne)).astype(np.int32) % k + 1
        keep = lo != hi
        lo2 = np.minimum(lo, hi)[keep]
        hi2 = np.maximum(lo, hi)[keep]
        act = r.integers(0, maxlvl + 1, size=lo2.size).astype(np.int32)
        cum = host_cumulative_counts(labels, lv8, k, maxlvl)
        want = merged_sizes_host(cum, lo2.astype(np.int64), hi2.astype(np.int64), act)
        got = native.native_merged_curve(labels, lv8, k, maxlvl, lo2, hi2, act)
        np.testing.assert_array_equal(got, want, err_msg=f"trial={trial}")

        # out_width contract: rows at result width directly.  Wider =
        # zero-padded (untouched calloc tail); narrower = representatives
        # >= out_width truncated — exactly what _expand_rows applied.
        wide = native.native_merged_curve(
            labels, lv8, k, maxlvl, lo2, hi2, act, out_width=k + 9
        )
        assert wide.shape == (levels, k + 9)
        np.testing.assert_array_equal(wide[:, : k + 1], want)
        assert (wide[:, k + 1 :] == 0).all()
        narrow_w = max(2, k - 7)
        narrow = native.native_merged_curve(
            labels, lv8, k, maxlvl, lo2, hi2, act, out_width=narrow_w
        )
        np.testing.assert_array_equal(
            narrow, want[:, :narrow_w], err_msg=f"trial={trial} narrow"
        )


def test_alternating_rounds_match_union_find_on_maze(rng):
    """The alternating v/h round schedule must reach the same unique fixed
    point as an independent host union-find on adversarial hole-laced
    'maze' fields (30% barriers — the NaN-masked astronomy regime)."""
    lab = rng.integers(1, 400, size=(48, 80)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.3] = 0
    got = np.asarray(component_min_labels(jnp.asarray(lab)))
    np.testing.assert_array_equal(got, _union_find_component_min(lab))


def test_merging_tail_nan_and_border_seeds_vs_oracle(rng):
    """The relax merging path on dense, NaN-laced and border-seed fields
    (including seeds in all four corners) must equal the C++ oracle."""
    native = _native()
    cases = []
    img = rng.integers(0, 254, size=(64, 128)).astype(np.uint8)
    cases.append((img, None))
    img = rng.integers(0, 254, size=(96, 128)).astype(np.uint8)
    img[rng.random((96, 128)) < 0.2] = 255
    cases.append((img, None))
    img = rng.integers(0, 40, size=(48, 64)).astype(np.uint8)
    img[rng.random((48, 64)) < 0.1] = 255
    cases.append(
        (img, [(0, 5), (0, 63), (47, 3), (7, 0), (47, 63), (24, 32), (0, 0)])
    )
    img = rng.integers(0, 254, size=(96, 192)).astype(np.uint8)
    img[rng.random((96, 192)) < 0.15] = 255
    cases.append((img, None))
    for img, seeds in cases:
        if seeds is None:
            seeds = native.native_find_local_minima(img)
        lab0 = paint_seeds(img.shape, seeds)
        got = run_levels(jnp.asarray(img), lab0, n_labels=len(seeds),
                         max_water_level=254, merging=True, backend="relax")
        want = native.native_transform(img, seeds, 254, merging=True)
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("trial", range(6))
def test_merging_tail_randomized_vs_oracle(trial):
    """Randomized relax-merging vs C++ oracle differential: random dynamic
    ranges, sentinel densities up to 60%, painted border/corner seeds."""
    native = _native()
    gen = np.random.default_rng(1000 + trial)
    h, w = [(32, 64), (48, 192), (64, 64)][trial % 3]
    hi = int(gen.choice([3, 60, 254]))
    img = gen.integers(0, hi, size=(h, w)).astype(np.uint8)
    img[gen.random((h, w)) < float(gen.choice([0.05, 0.3, 0.6]))] = 255
    if trial % 2:
        seeds = sorted(
            {(int(gen.integers(0, h)), int(gen.integers(0, w))) for _ in range(8)}
        )
    else:
        seeds = native.native_find_local_minima(img) or [(2, 2), (h - 3, w - 3)]
    lab0 = paint_seeds((h, w), seeds)
    got = run_levels(jnp.asarray(img), lab0, n_labels=len(seeds),
                     max_water_level=254, merging=True, backend="relax")
    want = native.native_transform(img, seeds, 254, merging=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_component_min_labels_maze_vs_union_find(rng):
    """component_min_labels on 30%-barrier mazes with claimed border rows
    must equal the host union-find."""
    lab = rng.integers(1, 300, size=(64, 96)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.3] = 0
    got = np.asarray(component_min_labels(jnp.asarray(lab)))
    np.testing.assert_array_equal(got, _union_find_component_min(lab))


def test_component_min_labels_two_columns(rng):
    """w == 2: both columns are border columns, so only the per-row
    horizontal pairs (interior rows) merge."""
    for w in (2, 3):
        lab = rng.integers(0, 5, size=(32, w)).astype(np.int32)
        lab[0, :] = [1, 2][:w] if w == 2 else [1, 2, 3]
        got = np.asarray(component_min_labels(jnp.asarray(lab)))
        np.testing.assert_array_equal(got, _union_find_component_min(lab))


def test_cache_resilient_retries_once():
    """_compat.cache_resilient: one clear-and-retry on the jax 0.9
    executable-cache corruption error, re-raised if it persists, and every
    other error passes through untouched."""
    import warnings

    from rustronomy_watershed_tpu import _compat

    calls = {"n": 0}

    @_compat.cache_resilient
    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("Execution supplied 2 buffers but compiled program expected 3")
        return 42

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert flaky() == 42
        assert calls["n"] == 2

        @_compat.cache_resilient
        def broken():
            raise ValueError("Execution supplied 2 buffers but compiled program expected 3")

        with pytest.raises(ValueError, match="buffers"):
            broken()

    @_compat.cache_resilient
    def other():
        calls["n"] += 1
        raise ValueError("something else")

    calls["n"] = 0
    with pytest.raises(ValueError, match="something else"):
        other()
    assert calls["n"] == 1


def test_component_min_serpentine_vs_union_find(rng):
    """A full-height serpentine (one component threading every row) and
    random 35%-barrier content must equal the oracles."""
    h, w = 96, 160
    lab = np.zeros((h, w), np.int32)
    # serpentine corridor: full even rows, alternating end columns connect
    for r in range(1, h - 1, 2):
        lab[r, 1:-1] = 1
    for r in range(2, h - 1, 2):
        c = w - 2 if (r // 2) % 2 == 0 else 1
        lab[r, c] = 1
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w) + 2
    lab = np.where(lab > 0, idx, 0)
    got = np.asarray(component_min_labels(jnp.asarray(lab)))
    np.testing.assert_array_equal(got, _union_find_component_min(lab))

    lab2 = rng.integers(0, 400, size=(96, 136)).astype(np.int32)
    lab2[rng.random(lab2.shape) < 0.35] = 0
    got2 = np.asarray(component_min_labels(jnp.asarray(lab2)))
    np.testing.assert_array_equal(got2, _union_find_component_min(lab2))
