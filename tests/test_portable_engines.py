"""The portable engines: one engine choice on every platform, removed
engines refused, seed numbering by integer cumsum, the fast checkpoint path,
the compile-cache placement and the on-card smoke script (its phases run
here on the CPU device at tiny sizes)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustronomy_watershed_tpu import BuildErr, TransformBuilder
from rustronomy_watershed_tpu.ops import (
    local_extrema_mask,
    paint_seeds,
    run_levels,
    seed_labels_from_mask,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "other"])
@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_auto_backend_same_on_every_platform(monkeypatch, platform, variant):
    """'auto' picks its engine from the call, never from the platform."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    ws = getattr(TransformBuilder.default(), f"build_{variant}")()
    for collect in ("none", "sizes", "history"):
        assert ws._resolved_backend(collect) == "relax"
    # per-level merged statistics outside those collects: the level sweep
    assert ws._resolved_backend("levels") == (
        "jnp" if variant == "merging" else "relax"
    )
    rnd = getattr(TransformBuilder.default().set_tie_break("random", 1),
                  f"build_{variant}")()
    assert rnd._resolved_backend() == "jnp"


@pytest.mark.parametrize("backend", ["relax_pallas", "pallas", "bogus"])
def test_removed_backend_raises_builderr(backend):
    with pytest.raises(BuildErr) as e:
        TransformBuilder.default().set_backend(backend)
    assert e.value.kind == BuildErr.UNKNOWN_BACKEND
    msg = str(e.value)
    assert repr(backend) in msg
    for accepted in ("auto", "relax", "jnp", "native"):
        assert repr(accepted) in msg


@pytest.mark.parametrize("backend", ["auto", "relax", "jnp", "native"])
def test_accepted_backends_agree_with_oracle(rng, backend):
    native = pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    img = rng.integers(0, 30, size=(24, 28)).astype(np.uint8)
    for variant in ("segmenting", "merging"):
        ws = getattr(
            TransformBuilder.default().set_backend(backend), f"build_{variant}"
        )()
        seeds = ws.find_local_minima(img)
        want = native.native_transform(
            img, seeds, 254, merging=variant == "merging"
        )
        np.testing.assert_array_equal(ws.transform(img, seeds), want)


@pytest.mark.parametrize(
    "shape", [(2048, 2048), (37, 53), (3, 40, 50), (5, 7)]
)
def test_seed_numbering_cumsum_matches_numpy(rng, shape):
    """Row-major 1..K numbering per trailing (H, W) plane, exactly."""
    img = rng.integers(0, 254, size=shape).astype(np.uint8)
    mask = np.asarray(local_extrema_mask(jnp.asarray(img)))
    got = np.asarray(jax.jit(seed_labels_from_mask)(jnp.asarray(mask)))
    flat = mask.reshape((-1,) + mask.shape[-2:])
    want = np.stack([
        np.where(m, np.cumsum(m.ravel()).reshape(m.shape), 0) for m in flat
    ]).reshape(mask.shape)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("every", [None, 1, 4, 64])
def test_ckpt_transform_any_chunk_length(rng, tmp_path, every):
    """The chunked relax loop reaches the same fixed point whatever the
    chunk length, and without a checkpointer."""
    from rustronomy_watershed_tpu.ops.ckpt_relax import ckpt_transform

    img = rng.integers(0, 60, size=(40, 48)).astype(np.uint8)
    img[rng.random(img.shape) < 0.1] = 255
    lab0 = paint_seeds(img.shape, [(3, 3), (30, 40), (20, 10)])
    for merging in (False, True):
        ckpt = None
        if every is not None:
            pytest.importorskip("orbax.checkpoint")
            from rustronomy_watershed_tpu.utils.checkpoint import (
                TransformCheckpointer,
            )

            ckpt = TransformCheckpointer(tmp_path / f"m{merging}", every=every)
        want = run_levels(jnp.asarray(img), lab0, n_labels=3,
                          max_water_level=254, merging=merging, backend="relax")
        got = ckpt_transform(jnp.asarray(img), lab0, merging=merging,
                             checkpointer=ckpt)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("backend", ["jnp", "relax"])
@pytest.mark.parametrize("merging", [False, True])
def test_watershed_e2e_matches_public_api(rng, backend, merging):
    """The one-program pipeline (seeds from the image, device numbering)
    equals find_local_minima + transform."""
    from rustronomy_watershed_tpu.ops import watershed_e2e

    img = rng.integers(0, 40, size=(32, 36)).astype(np.uint8)
    got = watershed_e2e(jnp.asarray(img), max_water_level=39, merging=merging,
                        backend=backend)
    ws = getattr(TransformBuilder.default().set_max_water_lvl(39),
                 "build_merging" if merging else "build_segmenting")()
    np.testing.assert_array_equal(
        np.asarray(got), ws.transform(img, ws.find_local_minima(img))
    )


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    from rustronomy_watershed_tpu.utils.compile_cache import place_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert place_compile_cache(str(tmp_path)) == str(tmp_path / "env")
            # left to JAX: the code sets no path of its own
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(str(tmp_path), ".jax_cache")
            assert place_compile_cache(str(tmp_path)) == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gitignore_lists_checkout_cache():
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {line.strip() for line in f}
    assert ".jax_cache/" in lines


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds only the script (no package), it fails
    without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "phase", ["numbering", "parity", "transform", "batch", "four_cards"]
)
def test_chip_smoke_phases_on_cpu(capsys, phase):
    pytest.importorskip("rustronomy_watershed_tpu.parity.native")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    if phase == "numbering":
        cs.phase_numbering(64)
    elif phase == "parity":
        cs.phase_parity(64)
    elif phase == "transform":
        rates = cs.phase_transform(64, "cpu")
        assert set(rates) == {"segmenting", "merging"}
    elif phase == "batch":
        cs.phase_batch(4, 32, "cpu")
    else:
        cs.phase_four_cards(64, 8, 32, "cpu")
    out = capsys.readouterr().out
    assert out.startswith("(")


@pytest.mark.parametrize("backend", ["relax_pallas", "pallas"])
def test_run_levels_refuses_removed_backend(backend):
    img = jnp.zeros((8, 8), jnp.uint8)
    with pytest.raises(ValueError, match=backend):
        run_levels(img, jnp.zeros((8, 8), jnp.int32), n_labels=1,
                   max_water_level=3, merging=False, backend=backend)


def test_component_min_rounds_on_dense_and_laced_fields(rng):
    """The tail's round counter: a dense claimed set converges in the first
    round (plus the observing one); a laced one needs more."""
    from rustronomy_watershed_tpu.ops.scan_merge import component_min_labels

    img = rng.integers(0, 254, size=(64, 64)).astype(np.uint8)
    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    seg = run_levels(jnp.asarray(img), lab0, n_labels=1024,
                     max_water_level=254, merging=False, backend="relax")
    _, rounds = component_min_labels(seg, collect_rounds=True)
    assert int(rounds) == 2
    laced = np.asarray(seg).copy()
    laced[rng.random(laced.shape) < 0.35] = 0
    out, rounds = component_min_labels(jnp.asarray(laced), collect_rounds=True)
    assert int(rounds) > 2
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(component_min_labels(jnp.asarray(laced)))
    )


def test_repeated_transforms_compile_once(rng):
    """A warm public transform reuses its executable, whichever keyword set
    reached run_levels first (jax 0.9 CPU corrupts a jitted function's cache
    when its static keywords arrive in different subsets)."""
    import warnings

    from rustronomy_watershed_tpu.ops.level_driver import _run_levels_jit

    img = rng.integers(0, 254, size=(40, 44)).astype(np.uint8)
    lab0 = paint_seeds(img.shape, [(5, 5), (30, 30)])
    ws = TransformBuilder.default().build_segmenting()
    seeds = ws.find_local_minima(img)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        run_levels(jnp.asarray(img), lab0, n_labels=2, max_water_level=254,
                   merging=False, backend="relax")
        ws.transform(img, seeds)
        n = _run_levels_jit.__wrapped__._cache_size()
        for _ in range(3):
            ws.transform(img, seeds)
            run_levels(jnp.asarray(img), lab0, n_labels=2, max_water_level=254,
                       merging=False, collect="none", sweep_fn=None,
                       backend="relax")
        assert _run_levels_jit.__wrapped__._cache_size() == n


def test_tiled_program_built_once_per_configuration(rng):
    """tiled_transform reuses its jitted shard_map program across calls
    with the same mesh and static configuration."""
    from jax.sharding import Mesh

    from rustronomy_watershed_tpu.parallel import tiled_transform
    from rustronomy_watershed_tpu.parallel.tiled import _sharded_program

    img = rng.integers(0, 20, size=(32, 32)).astype(np.uint8)
    lab0 = paint_seeds(img.shape, [(3, 3), (20, 25)])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    kw = dict(n_labels=2, max_water_level=19, merging=True, halo=3)
    first = np.asarray(tiled_transform(img, lab0, mesh, **kw))
    misses = _sharded_program.cache_info().misses
    again = np.asarray(tiled_transform(img, lab0, mesh, **kw))
    assert _sharded_program.cache_info().misses == misses
    np.testing.assert_array_equal(again, first)
