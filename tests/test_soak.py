"""Seeded randomized geometry soak vs the C++ oracle (regression form of the
round-6 120-trial ad-hoc soak — VERDICT r2 #8).

Coverage the fixed-fixture tests miss: randomized CONTENT on a pool of
extreme geometries (tall/thin, short/wide, square), sentinel-laced and
NaN/inf-preprocessed fields, both variants, both device engines, and on a
rotating subset the public builder path.  The shape pool is FIXED so jit
compile caches hit across trials and the whole soak stays fast; content,
dynamic range, variant, and sentinel density are drawn per-trial from a
pinned seed.  Reference semantics per /root/reference/src/lib.rs:196-635;
the oracle is the independent C++ implementation (parity/oracle.cc).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rustronomy_watershed_tpu.models.base import _label_bucket
from rustronomy_watershed_tpu.ops import paint_seeds, run_levels

native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")

# Fixed geometry pool: tall/thin, short/wide, square, and a wide sliver.
# Content varies per trial; shapes do not, so each (shape, variant,
# backend) compiles once for the whole soak.
_SHAPES = [(288, 24), (24, 288), (160, 40), (48, 48), (20, 520)]


def _random_field(rng, h, w):
    """(u8 field, max_water_level).  Random dynamic range with sentinel
    lacing; one in three trials builds the field via pre_process from a
    NaN/inf-laced float field (quirk Q4 path) instead of directly.  The max
    level matches the field's dynamic range (254 only when values reach
    it), drawn from a two-value set so the static-arg compile cache hits."""
    kind = rng.integers(0, 3)
    if kind < 2:
        hi = int(rng.choice([4, 16, 40, 254]))
        img = rng.integers(0, hi, size=(h, w)).astype(np.uint8)
        img[rng.random((h, w)) < 0.03] = 0
        img[rng.random((h, w)) < 0.03] = 255
        return img, (254 if hi == 254 else 40)
    from rustronomy_watershed_tpu.ops.preprocess import pre_process

    f = rng.normal(size=(h, w)).astype(np.float64)
    f[rng.random((h, w)) < 0.05] = np.nan
    f[rng.random((h, w)) < 0.02] = np.inf
    f[rng.random((h, w)) < 0.02] = -np.inf
    return np.asarray(pre_process(f)), 254


@pytest.mark.parametrize("trial", range(20))
def test_geometry_soak_vs_oracle(trial):
    rng = np.random.default_rng(60_000 + trial)
    h, w = _SHAPES[trial % len(_SHAPES)]
    merging = bool(trial % 2)
    img, max_lvl = _random_field(rng, h, w)
    seeds = native.native_find_local_minima(img)
    if not seeds:
        seeds = [(2, 2), (h - 3, w - 3)]
    want = native.native_transform(img, seeds, max_lvl, merging=merging)
    lab0 = paint_seeds((h, w), seeds)
    bucket = _label_bucket(len(seeds))
    backends = ["jnp", "relax"]
    # The public builder (auto engine, host seed painting) on a rotating
    # subset — one trial per pool shape, alternating variants.
    if trial < len(_SHAPES):
        backends.append("public")
    for backend in backends:
        if backend == "public":
            from rustronomy_watershed_tpu import TransformBuilder

            ws = getattr(
                TransformBuilder.default().set_max_water_lvl(max_lvl),
                "build_merging" if merging else "build_segmenting",
            )()
            got = ws.transform(img, seeds)
        else:
            got = np.asarray(
                run_levels(
                    jnp.asarray(img),
                    lab0,
                    n_labels=bucket,
                    max_water_level=max_lvl,
                    merging=merging,
                    backend=backend,
                )
            )
        np.testing.assert_array_equal(
            got,
            want,
            err_msg=(
                f"trial={trial} {h}x{w} merging={merging} backend={backend}"
            ),
        )
