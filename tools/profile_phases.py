"""Per-layer times of the device path: seeding, relax fixed point, merge tail.

    python tools/profile_phases.py [size ...]        (default: 4096)

For each size, on a uniform random u8 field and on the same field with 10%
NEVER_FILL dots, prints per layer: the device time of the jitted layer
(median of several runs, input already on the device, each run ending in
``block_until_ready``), the relax sweep count and time per sweep, the
share of the published HBM bandwidth at 28 bytes per pixel per sweep (four
int32 plane reads: image, L, d, label; three writes: L, d, label), and the
merge tail's round count.  Then splits one warm public segmenting
``transform`` at the same size into its host and device steps.  Needs a
GPU: the bandwidth table is keyed by ``device_kind`` and an unknown device
is an error.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

# Published HBM bandwidth, bytes/s (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
BYTES_PER_PX_SWEEP = 4 * 4 + 3 * 4


def device_ms(fn, *args, runs=5):
    """Median wall ms of fn(*args) to block_until_ready (compiled first)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_ms(fn, runs=3):
    """Median wall ms of fn() (which must itself finish its device work)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def public_transform_split(size, card):
    """Host and device steps of one warm public segmenting transform."""
    import jax.numpy as jnp

    from rustronomy_watershed_tpu import TransformBuilder
    from rustronomy_watershed_tpu.models.base import _label_bucket
    from rustronomy_watershed_tpu.ops import paint_seeds, run_levels

    img = np.random.default_rng(0).integers(0, 254, size=(size, size)).astype(np.uint8)
    ws = TransformBuilder.default().build_segmenting()
    seeds = ws.find_local_minima(img)
    ws.transform(img, seeds)  # compile
    dev_img = jax.device_put(img)
    lab0 = paint_seeds(img.shape, seeds)
    kw = dict(n_labels=_label_bucket(len(seeds)), max_water_level=254,
              merging=False, backend="relax")
    out = jax.block_until_ready(run_levels(dev_img, lab0, **kw))
    print(
        json.dumps(
            {
                "public_transform": f"segmenting_{size}x{size}",
                "card": card,
                "transform_ms": host_ms(lambda: ws.transform(img, seeds)),
                "find_local_minima_ms": host_ms(lambda: ws.find_local_minima(img)),
                "paint_seeds_ms": host_ms(
                    lambda: jax.block_until_ready(paint_seeds(img.shape, seeds))
                ),
                "h2d_image_ms": host_ms(
                    lambda: jax.block_until_ready(jnp.asarray(img))
                ),
                "device_run_levels_ms": device_ms(
                    lambda: run_levels(dev_img, lab0, **kw)
                ),
                "d2h_labels_ms": host_ms(lambda: np.asarray(out + 0)),
            }
        ),
        flush=True,
    )


def main():
    from rustronomy_watershed_tpu.constants import NEVER_FILL
    from rustronomy_watershed_tpu.ops.priority import relax_transform
    from rustronomy_watershed_tpu.ops.scan_merge import component_min_labels
    from rustronomy_watershed_tpu.ops.seeds import (
        local_extrema_mask,
        seed_labels_from_mask,
    )
    dev = jax.devices()[0]
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()

    seed_fn = jax.jit(lambda im: seed_labels_from_mask(local_extrema_mask(im)))
    relax_fn = jax.jit(lambda im, lab: relax_transform(im, lab, collect_sweeps=True))
    tail_fn = jax.jit(lambda lab: component_min_labels(lab, collect_rounds=True))

    for size in [int(a) for a in sys.argv[1:]] or [4096]:
        rng = np.random.default_rng(0)
        dense = rng.integers(0, 254, size=(size, size)).astype(np.uint8)
        dots = dense.copy()
        dots[rng.random((size, size)) < 0.1] = NEVER_FILL
        for name, img in (("uniform", dense), ("dots10", dots)):
            img = jax.device_put(img)
            lab0 = seed_fn(img)
            seg, _, sweeps = relax_fn(img, lab0)
            _, rounds = tail_fn(seg)
            t_seed = device_ms(seed_fn, img)
            t_relax = device_ms(relax_fn, img, lab0)
            t_tail = device_ms(tail_fn, seg)
            sweeps, rounds = int(sweeps), int(rounds)
            per_sweep = t_relax / sweeps
            share = size * size * BYTES_PER_PX_SWEEP / (per_sweep / 1e3) / peak
            print(
                json.dumps(
                    {
                        "field": f"{name}_{size}x{size}",
                        "card": card,
                        "seeding_ms": t_seed,
                        "relax_ms": t_relax,
                        "relax_sweeps": sweeps,
                        "relax_ms_per_sweep": per_sweep,
                        "relax_hbm_share": share,
                        "merge_tail_ms": t_tail,
                        "merge_tail_rounds": rounds,
                    }
                ),
                flush=True,
            )
        public_transform_split(size, card)


if __name__ == "__main__":
    main()
