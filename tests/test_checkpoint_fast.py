"""Fast-path checkpoint / resume (ops/ckpt_relax.py).

The relax engine's (L, d, label) planes snapshot between chunks of sweeps;
a forced mid-transform interrupt must resume from the snapshot BIT-EXACTLY —
the fixed point is unique, so the resumed run's final labels equal the
uninterrupted run's.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rustronomy_watershed_tpu.ops import paint_seeds, run_levels
from rustronomy_watershed_tpu.ops.ckpt_relax import ckpt_transform
from rustronomy_watershed_tpu.utils.checkpoint import TransformCheckpointer

pytest.importorskip("orbax.checkpoint")


def _field(rng, shape=(64, 80)):
    img = rng.integers(0, 60, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255  # NaN lacing: long claim chains
    seeds = [(3, 3), (40, 70), (20, 40), (60, 10)]
    return img, paint_seeds(shape, seeds), len(seeds)


@pytest.mark.parametrize("merging", [False, True])
def test_interrupt_resume_bit_exact(rng, tmp_path, merging):
    img, lab0, k = _field(rng)
    want = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=k, max_water_level=254,
                   merging=merging, backend="relax")
    )

    # One sweep per chunk on a 10%-laced field: the interrupt genuinely
    # lands mid-transform, after >= 1 snapshot.
    ckpt = TransformCheckpointer(tmp_path, every=1)
    with pytest.raises(RuntimeError, match="forced interrupt"):
        ckpt_transform(
            jnp.asarray(img), lab0, merging=merging, checkpointer=ckpt,
            _interrupt_after_calls=3,
        )
    ckpt.wait()
    snap = ckpt.latest_planes()
    assert snap is not None and snap["calls"] == 3

    # Resume from the snapshot (with a different chunk length); the final
    # labels must equal the uninterrupted engine's bit-for-bit.
    ckpt2 = TransformCheckpointer(tmp_path, every=1000)
    got = ckpt_transform(
        jnp.asarray(img), lab0, merging=merging, checkpointer=ckpt2,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_public_builder_fast_checkpoint(rng, tmp_path):
    """set_checkpoint composes with the relax fast path through the public
    builder (no host-stepped loop), and stays bit-identical to the
    un-checkpointed transform."""
    from rustronomy_watershed_tpu.prelude import TransformBuilder

    img = rng.integers(0, 40, size=(48, 64)).astype(np.uint8)
    plain = TransformBuilder.default().build_merging()
    seeds = plain.find_local_minima(img)
    want = np.asarray(plain.transform(img, seeds))
    ws = TransformBuilder.default().set_checkpoint(tmp_path, every=1).build_merging()
    assert ws._resolved_backend() == "relax"
    got = np.asarray(ws.transform(img, seeds))
    np.testing.assert_array_equal(got, want)
    # the run left plane snapshots behind, not per-level ones
    assert TransformCheckpointer(tmp_path).latest_planes() is not None


def test_stale_snapshot_geometry_ignored(rng, tmp_path):
    """A snapshot from a different image geometry must be ignored (fresh
    start), not crash or corrupt the resume."""
    img, lab0, k = _field(rng, shape=(64, 80))
    ckpt = TransformCheckpointer(tmp_path, every=1)
    ckpt.save_planes(
        3,
        np.zeros((10, 128), np.int32),
        np.zeros((10, 128), np.int32),
        np.zeros((10, 128), np.int32),
        meta=[10, 128],
    )
    ckpt.wait()
    got = ckpt_transform(
        jnp.asarray(img), lab0, merging=False,
        checkpointer=TransformCheckpointer(tmp_path, every=1000),
    )
    want = np.asarray(
        run_levels(jnp.asarray(img), lab0, n_labels=k, max_water_level=254,
                   merging=False, backend="relax")
    )
    np.testing.assert_array_equal(np.asarray(got), want)
