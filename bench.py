"""Headline benchmark: watershed throughput on one accelerator.

BASELINE.md metric: 4096x4096 u8 uniform random field, seeds from
find_local_minima, full 255-level segmenting transform, Mpix/s per device.

Throughput is measured device-side: BENCH_INNER back-to-back transforms run
inside ONE jitted program (a lax.fori_loop whose iterations are serially
data-dependent, so XLA cannot CSE or overlap them), forced by one scalar
fetch at the end.  Each iteration computes an int32 weighted checksum of its
label image (sum + position-hashed sum, exact modular arithmetic — no float
collisions); determinism is asserted across all iterations and outer reps.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpix/s", "vs_baseline": N/500,
   "device": {"platform": ..., "kind": ..., "count": ..., "card": ...}}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _card() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it, or
    None where there is no nvidia-smi (a CPU run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from rustronomy_watershed_tpu.ops.pipeline import watershed_e2e_impl
    from rustronomy_watershed_tpu.utils.compile_cache import place_compile_cache

    place_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    size = int(os.environ.get("BENCH_SIZE", "4096"))
    max_lvl = int(os.environ.get("BENCH_LEVELS", "254"))
    merging = os.environ.get("BENCH_MERGING", "0") == "1"
    backend = os.environ.get("BENCH_BACKEND", "auto")
    if backend == "auto":
        # What the public API resolves for final labels on every platform.
        backend = "relax"
    reps = int(os.environ.get("BENCH_REPS", "3"))
    inner = int(os.environ.get("BENCH_INNER", "4"))

    rng = np.random.default_rng(0)
    img = rng.integers(0, 254, size=(size, size)).astype(np.uint8)
    # BENCH_NANFRAC=0.1: NaN-mask the field (NEVER_FILL sentinels, what the
    # reference's pre_processor maps NaN to — integration.rs:343-428) so the
    # merging tail works on a multi-component claimed set.  Real astronomy
    # data is NaN-heavy.  BENCH_NANSHAPE picks the mask morphology:
    # 'dots' (default — salt-and-pepper bad pixels, the ADVERSARIAL case
    # for the scan tail's run lengths) or 'blobs' (a few contiguous
    # elliptical regions — coverage boundaries; runs stay long).
    nanfrac = float(os.environ.get("BENCH_NANFRAC", "0"))
    nanshape = os.environ.get("BENCH_NANSHAPE", "dots")
    if nanfrac > 0 and nanshape == "dots":
        img[rng.random((size, size)) < nanfrac] = 255
    elif nanfrac > 0:
        yy, xx = np.mgrid[0:size, 0:size]
        mask = np.zeros((size, size), dtype=bool)
        # ~8 ellipses sized so the union covers ~nanfrac of the area.
        r_mean = size * np.sqrt(nanfrac / (8 * np.pi))
        for _ in range(8):
            cy, cx = rng.integers(0, size, 2)
            ry, rx = rng.uniform(0.5, 1.5, 2) * r_mean
            mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img[mask] = 255
    # Stage the input on-device once: this number is device-side throughput.
    img = jax.device_put(jnp.asarray(img))
    jax.block_until_ready(img)

    def checksum(lab):
        # Exact int32 modular hash: plain sum + position-weighted sum
        # (odd multiplier => bijective mixing), immune to the float-mantissa
        # collisions of a f32 sum.
        lab = lab.reshape(-1).astype(jnp.int32)
        pos = jax.lax.iota(jnp.int32, lab.shape[0]) * jnp.int32(-1640531527)
        return jnp.sum(lab) ^ jnp.sum(lab * pos)

    @partial(jax.jit, static_argnames=("n",))
    def run_many(img, n):
        def body(i, carry):
            chk_prev, acc = carry
            # Serial data dependency (always 0 at runtime, unprovable at
            # compile time): forces n genuine back-to-back executions.
            salt = jnp.where(chk_prev == jnp.int32(-123456789), 1, 0).astype(
                jnp.uint8
            )
            out = watershed_e2e_impl(
                img + salt,
                max_water_level=max_lvl,
                merging=merging,
                backend=backend,
            )
            chk = checksum(out)
            return chk, acc.at[i].set(chk)

        _, acc = jax.lax.fori_loop(
            0, n, body, (jnp.int32(0), jnp.zeros((n,), jnp.int32))
        )
        return acc

    acc = np.asarray(run_many(img, inner))  # compile + warm
    assert np.all(acc == acc[0]), f"nondeterministic result: {acc}"
    chk0 = acc[0]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = np.asarray(run_many(img, inner))
        times.append(time.perf_counter() - t0)
        assert np.all(acc == chk0), f"nondeterministic result: {acc} vs {chk0}"

    dt = min(times) / inner
    mpix_s = size * size / dt / 1e6
    dev = jax.devices()[0]
    variant = "merging" if merging else "segmenting"
    if nanfrac > 0:
        variant += f"_nan{round(nanfrac * 100)}"
        if nanshape != "dots":
            variant += f"_{nanshape}"
    print(
        json.dumps(
            {
                "metric": f"{variant}_{size}x{size}_u8_throughput",
                "value": round(mpix_s, 2),
                "unit": "Mpix/s",
                "vs_baseline": round(mpix_s / 500.0, 4),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                    "card": _card(),
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
