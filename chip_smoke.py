"""Smoke run of the watershed on an NVIDIA GPU, through the public API only.

    python chip_smoke.py                # one card: phases (a)-(e)
    python chip_smoke.py --four-cards   # four cards: phase (f) only

(a) the device, and the card's name and power limit from nvidia-smi;
(b) seed numbering of a 4096² field equals a host NumPy cumsum over the
    C++ oracle's seed mask;
(c) labels at 2048² equal the C++ oracle (parity/oracle.cc) for segmenting,
    dense merging, merging with 10% NEVER_FILL dots, and the merging
    ``transform_to_list`` curves;
(d) the 4096² public ``transform`` for both variants: cold (compile
    included) and warm wall time, Mpix/s, two warm runs bit-identical;
(e) ``transform_batch`` of 64 x 1024² merging cutouts equals per-image
    transforms;
(f) ``--four-cards``: ``set_mesh`` + ``transform`` at 8192² on a 2x2
    ('y', 'x') mesh, and ``transform_batch`` of 64 x 1024² over a 4-way
    'batch' mesh, each bit-identical to one card, with the output sharded
    over 4 distinct devices.

Tolerance is zero throughout: the pipeline is integer-only.  Nothing falls
back: with no GPU the script exits non-zero before any result, and any
failed check raises.  The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
preceded by the nvidia-smi card line(s).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rustronomy_watershed_tpu import NEVER_FILL, TransformBuilder
from rustronomy_watershed_tpu.ops import local_extrema_mask, seed_labels_from_mask
from rustronomy_watershed_tpu.parity import native
from rustronomy_watershed_tpu.utils.compile_cache import place_compile_cache

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    """``name, power.limit`` per card, exactly as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def field(rng, shape, nan_frac: float = 0.0) -> np.ndarray:
    """Uniform random u8 field (BASELINE config 1), optionally laced with
    NEVER_FILL dots (what the pre-processor maps NaN to)."""
    img = rng.integers(0, 254, size=shape).astype(np.uint8)
    if nan_frac:
        img[rng.random(shape) < nan_frac] = NEVER_FILL
    return img


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


def _equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    _check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    n_bad = int(np.count_nonzero(got != want))
    _check(n_bad == 0, f"{what}: {n_bad} pixels differ")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_numbering(size: int) -> None:
    """(b) device seed mask + row-major numbering vs the host."""
    import jax

    img = field(np.random.default_rng(SEED), (size, size))
    mask, labels = jax.jit(
        lambda im: (local_extrema_mask(im), seed_labels_from_mask(local_extrema_mask(im)))
    )(jax.device_put(img))
    want_mask = np.zeros((size, size), bool)
    coords = np.asarray(native.native_find_local_minima(img), np.int64).reshape(-1, 2)
    want_mask[coords[:, 0], coords[:, 1]] = True
    _equal(mask, want_mask, f"seed mask {size}²")
    want = np.where(
        want_mask, np.cumsum(want_mask.ravel()).reshape(size, size), 0
    ).astype(np.int32)
    _equal(labels, want, f"seed numbering {size}²")
    log(f"(b) seed numbering {size}²: {len(coords)} seeds, equal to host cumsum")


def phase_parity(size: int) -> None:
    """(c) public transforms vs the C++ oracle, both variants."""
    rng = np.random.default_rng(SEED + 1)
    dense = field(rng, (size, size))
    dots = field(rng, (size, size), nan_frac=0.1)
    seg = TransformBuilder.default().build_segmenting()
    mrg = TransformBuilder.default().build_merging()
    seeds = seg.find_local_minima(dense)
    seeds_dots = seg.find_local_minima(dots)
    # The oracle's own seeds also build its shared library once, before the
    # threads below call into it.
    _check(native.native_find_local_minima(dense) == seeds, "find_local_minima")
    _check(native.native_find_local_minima(dots) == seeds_dots, "find_local_minima (dots)")
    with ThreadPoolExecutor(3) as pool:  # ctypes releases the GIL
        f_seg = pool.submit(native.native_transform, dense, seeds, 254, False)
        f_mrg = pool.submit(
            native.native_transform, dense, seeds, 254, True, with_sizes=True
        )
        f_dots = pool.submit(native.native_transform, dots, seeds_dots, 254, True)
        got_seg = seg.transform(dense, seeds)
        got_mrg = mrg.transform(dense, seeds)
        got_dots = mrg.transform(dots, seeds_dots)
        got_list = mrg.transform_to_list(dense, seeds, counts_length=len(seeds) + 1)
        want_mrg, want_sizes = f_mrg.result()
        _equal(got_seg, f_seg.result(), f"segmenting {size}²")
        _equal(got_mrg, want_mrg, f"dense merging {size}²")
        _equal(got_dots, f_dots.result(), f"merging with 10% dots {size}²")
    _check([lvl for lvl, _ in got_list] == list(range(255)), "to_list levels")
    _equal(np.stack([row for _, row in got_list]), want_sizes, f"to_list curves {size}²")
    log(
        f"(c) oracle parity {size}²: segmenting, dense merging, merging with "
        "10% NEVER_FILL dots, merging transform_to_list curves — all equal"
    )


def phase_transform(size: int, card: str, warm_runs: int = 3) -> dict:
    """(d) cold and warm wall time of the public transform, both variants."""
    rng = np.random.default_rng(SEED + 2)
    img = field(rng, (size, size))
    rates = {}
    for variant in ("segmenting", "merging"):
        ws = getattr(TransformBuilder.default(), f"build_{variant}")()
        seeds, t_seeds = _timed(lambda: ws.find_local_minima(img))
        first, cold = _timed(lambda: ws.transform(img, seeds))
        warm, outs = [], []
        for _ in range(warm_runs):
            out, t = _timed(lambda: ws.transform(img, seeds))
            warm.append(t)
            outs.append(out)
        _equal(outs[-1], outs[0], f"{variant} {size}² run to run")
        _equal(outs[0], first, f"{variant} {size}² cold vs warm")
        _check(outs[0].dtype == np.int32, f"{variant} dtype {outs[0].dtype}")
        mid = float(np.median(warm))
        rates[variant] = size * size / mid / 1e6
        log(
            f"(d) {variant} {size}² transform: find_local_minima {t_seeds:.6f} s "
            f"({len(seeds)} seeds), cold {cold:.6f} s, warm "
            + " ".join(f"{t:.6f}" for t in warm)
            + f" s, median {mid:.6f} s = {rates[variant]:.3f} Mpix/s on {card}; "
            "warm runs bit-identical"
        )
    return rates


def phase_batch(n: int, size: int, card: str) -> None:
    """(e) transform_batch of merging cutouts vs per-image transforms."""
    rng = np.random.default_rng(SEED + 3)
    imgs = field(rng, (n, size, size))
    ws = TransformBuilder.default().build_merging()
    seeds_list = [ws.find_local_minima(im) for im in imgs]
    out, cold = _timed(lambda: ws.transform_batch(imgs, seeds_list))
    again, warm = _timed(lambda: ws.transform_batch(imgs, seeds_list))
    _equal(again, out, f"batch {n}x{size}² run to run")
    for i in sorted({0, n // 2, n - 1}):
        _equal(out[i], ws.transform(imgs[i], seeds_list[i]), f"batch image {i}")
    log(
        f"(e) transform_batch {n}x{size}² merging: cold {cold:.6f} s, warm "
        f"{warm:.6f} s = {n * size * size / warm / 1e6:.3f} Mpix/s on {card}; "
        "equal to per-image transforms"
    )


def _check_sharded(arr, devices, what: str) -> None:
    """The array is split over exactly ``devices``, one distinct part each."""
    shards = arr.addressable_shards
    on = {s.device for s in shards}
    _check(on == set(devices), f"{what}: shards on {sorted(d.id for d in on)}")
    _check(
        all(s.data.size < arr.size for s in shards),
        f"{what}: replicated, not sharded",
    )


def phase_four_cards(size: int, n: int, bsize: int, card: str) -> None:
    """(f) the mesh paths on 4 devices vs one device."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()[:4]
    _check(len(devs) == 4, f"need 4 devices, found {len(jax.devices())}")
    rng = np.random.default_rng(SEED + 4)
    img = field(rng, (size, size))
    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("y", "x"))
    for variant in ("segmenting", "merging"):
        one = getattr(TransformBuilder.default(), f"build_{variant}")()
        four = getattr(TransformBuilder.default().set_mesh(mesh), f"build_{variant}")()
        seeds = one.find_local_minima(img)
        want, t_one = _timed(lambda: one.transform(img, seeds))
        got, cold = _timed(lambda: four.transform(img, seeds, device_output=True))
        got, warm = _timed(
            lambda: jax.block_until_ready(four.transform(img, seeds, device_output=True))
        )
        _check_sharded(got, devs, f"{variant} {size}² on the 2x2 mesh")
        _equal(got, want, f"{variant} {size}² 2x2 mesh vs one card")
        log(
            f"(f) {variant} {size}² on a 2x2 mesh: cold {cold:.6f} s, warm "
            f"{warm:.6f} s (one card, cold: {t_one:.6f} s) on {card}; "
            "bit-identical to one card, sharded over 4 devices"
        )

    imgs = field(rng, (n, bsize, bsize))
    bmesh = Mesh(np.asarray(devs).reshape(4, 1, 1), ("batch", "y", "x"))
    one = TransformBuilder.default().build_merging()
    four = TransformBuilder.default().set_mesh(bmesh).build_merging()
    seeds_list = [one.find_local_minima(im) for im in imgs]
    want, t_one = _timed(lambda: one.transform_batch(imgs, seeds_list))
    got, cold = _timed(lambda: four.transform_batch(imgs, seeds_list, device_output=True))
    got, warm = _timed(
        lambda: jax.block_until_ready(
            four.transform_batch(imgs, seeds_list, device_output=True)
        )
    )
    _check_sharded(got, devs, f"batch {n}x{bsize}² on the batch mesh")
    _equal(got, want, f"batch {n}x{bsize}² batch mesh vs one card")
    log(
        f"(f) transform_batch {n}x{bsize}² merging on a 4-way batch mesh: cold "
        f"{cold:.6f} s, warm {warm:.6f} s (one card, cold: {t_one:.6f} s) on "
        f"{card}; bit-identical to one card, sharded over 4 devices"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card mesh paths and their one-card comparison",
    )
    args = ap.parse_args(argv)

    import jax

    place_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
            file=sys.stderr,
        )
        return 1
    cards = card_lines()
    card = cards[0]
    log(f"(a) device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; card: {card}")
    if args.four_cards:
        phase_four_cards(8192, 64, 1024, card)
    else:
        phase_numbering(4096)
        phase_parity(2048)
        phase_transform(4096, card)
        phase_batch(64, 1024, card)
    for line in cards:
        print(line)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
