"""Shared driver logic for the segmenting / merging watershed transforms.

Mirrors the reference's ``Watershed`` trait surface
(/root/reference/src/lib.rs:1206-1238): ``transform``,
``transform_with_hook``, ``transform_to_list``, ``transform_history`` — plus
the ``WatershedUtils`` mixin (src/lib.rs:1069-1201).

Two execution paths with identical numerics:

* **Fast path** (no hook / plots / progress / debug): the entire level sweep
  is one jitted device program (ops.level_driver.run_levels); per-level
  statistics are accumulated on-device.
* **Hook path**: levels are stepped from the host (one jitted ``level_step``
  per level) so arbitrary Python hooks receive a ``HookCtx`` view each level,
  like the reference's ``fn(HookCtx) -> T`` hooks (src/lib.rs:1509-1518).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .._compat import cache_resilient
from ..constants import ALWAYS_FILL, NORMAL_MAX, UNCOLOURED
from ..ops.level_driver import level_step, level_step_counted, run_levels
from ..ops.preprocess import pre_process
from ..ops.seeds import local_extrema_mask, paint_seeds
from ..utils.perf import PerfReport
from ..utils.progress import ProgressBar


@dataclasses.dataclass(frozen=True)
class HookCtx:
    """Per-water-level context handed to hooks (src/lib.rs:843-862).

    ``colours`` is the label image *after* this level's fixed point (and merge
    phase, for the merging variant); ``seeds`` is the (colour, (y, x)) list
    with the original colour ids.  Under edge correction the views keep the
    padded shape, replicating the reference (SURVEY.md Q7).
    """

    water_level: int
    max_water_level: int
    image: np.ndarray
    colours: np.ndarray
    seeds: tuple[tuple[int, tuple[int, int]], ...]


# Jitted per-shape: one device program instead of one dispatch per jnp op.
_extrema_mask_jit = cache_resilient(
    partial(jax.jit, static_argnames=("mode",))(local_extrema_mask)
)


def _batch_random_impl(imgs, labels0, us, *, n_labels, max_water_level, merging):
    """Batched stochastic-tie-break transform: vmap of the jnp level sweep
    with ONE independent uniform plane per image (reference randomness,
    src/lib.rs:249-253, applied per transform).  ``us`` is (B, H, W) —
    per-image planes derived by folding the batch index into the user's
    seed (see transform_batch), so image i's draws are independent of
    image j's and of the batch size."""
    from ..ops.flood import flood_sweep_random
    from ..ops.level_driver import run_levels_impl

    def one(img, lab, u):
        return run_levels_impl(
            img,
            lab,
            n_labels=n_labels,
            max_water_level=max_water_level,
            merging=merging,
            collect="none",
            sweep_fn=lambda im, la, lv: flood_sweep_random(im, la, lv, u=u),
            backend="jnp",
        )

    return jax.vmap(one)(imgs, labels0, us)


_batch_random = cache_resilient(
    partial(
        jax.jit, static_argnames=("n_labels", "max_water_level", "merging")
    )(_batch_random_impl)
)


def _label_bucket(n_seeds: int) -> int:
    """Static parent/histogram table size: next power of two >= n_seeds + 1.

    Using a padded static bound instead of the exact seed count keeps XLA
    recompilation to one program per bucket instead of one per image.
    """
    n = max(2, n_seeds + 1)
    return 1 << (n - 1).bit_length()


def _expand_rows(
    sizes: np.ndarray,
    counts_length: int,
    max_water_level: int,
    copy: bool = False,
) -> list[tuple[int, np.ndarray]]:
    """[(level, counts-row)] with reference-length rows (src/lib.rs:630).

    One vectorised (levels, counts_length) allocation + block copy instead
    of a per-level zeros/copy loop: at 1024² the reference-length default is
    255 x (n_pixels+1) int64 ≈ 2 GB of rows, and the loop dominated the
    whole entry point.

    Small results (< ~64 MB) are returned as independent per-row copies;
    huge reference-length blocks stay views of one base array (copying
    would double the 2 GB) — a caller retaining a single huge row keeps
    the base alive, and mutating one row through an overlapping view could
    surprise.  That trade is documented at the public surface
    (docs/API.md, transform_to_list) and ``copy=True`` opts out of it:
    every row is then an independent allocation regardless of size."""
    levels = max_water_level + 1
    sizes = np.asarray(sizes)
    if sizes.shape == (levels, counts_length) and sizes.dtype == np.int64:
        # Already at result width and dtype (the native merged-curve tail
        # writes rows at counts_length directly): every caller hands a
        # freshly-allocated table, so the rows can ship as views without
        # the 2x block copy (~0.15 s of the 1024² to_list wall).
        if copy:
            return [(lvl, sizes[lvl].copy()) for lvl in range(levels)]
        return list(enumerate(sizes))
    out = np.zeros((levels, counts_length), dtype=np.int64)
    k = min(sizes.shape[1], counts_length)
    out[:, :k] = sizes[:levels, :k]
    if copy or out.nbytes < 64 * 1024 * 1024:
        return [(lvl, out[lvl].copy()) for lvl in range(levels)]
    return list(enumerate(out))


class WatershedUtils:
    """Image-preparation helpers (src/lib.rs:1069-1201)."""

    def pre_processor(self, img) -> np.ndarray:
        """Normalise any numeric array to u8 [0, NORMAL_MAX] with the
        reference's special-value mapping (SURVEY.md Q4)."""
        return pre_process(img, NORMAL_MAX)

    def pre_processor_with_max(self, img, max_val: int) -> np.ndarray:
        return pre_process(img, max_val)

    def find_local_minima(self, img, mode: str = "reference") -> list[tuple[int, int]]:
        """Seed coordinates in row-major order.

        Replicates the reference code: strict local *maxima* by value despite
        the name (src/lib.rs:1190, SURVEY.md Q1).  Pass ``mode='minima'`` for
        the documented intent.
        """
        mask = np.asarray(_extrema_mask_jit(jnp.asarray(img), mode=mode))
        return list(map(tuple, np.argwhere(mask).tolist()))


class _WatershedBase(WatershedUtils):
    """Common implementation; subclasses set ``_merging``."""

    _merging: bool = False

    def __init__(
        self,
        max_water_level: int = NORMAL_MAX,
        edge_correction: bool = False,
        wlvl_hook: Optional[Callable[[HookCtx], Any]] = None,
        plot_path=None,
        plot_colour_map=None,
        progress: bool = False,
        debug: bool = False,
        sweep_fn=None,
        backend: str = "auto",
        mesh=None,
        checkpoint_dir=None,
        checkpoint_every: int = 16,
        tie_break: str = "min",
        tie_break_seed: int = 0,
    ):
        self.max_water_level = int(max_water_level)
        self.edge_correction = bool(edge_correction)
        self.wlvl_hook = wlvl_hook
        self.plot_path = plot_path
        self.plot_colour_map = plot_colour_map
        self.progress = progress
        self.debug = debug
        self.sweep_fn = sweep_fn
        self.backend = backend
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.tie_break = tie_break
        self.tie_break_seed = tie_break_seed
        # Per-shape cache of the bound stochastic sweep (a stable object per
        # shape so jit's static sweep_fn arg hits its compile cache).
        self._tie_sweep_cache: dict = {}

    def _effective_sweep_fn(self, shape):
        """The flood sweep the level-sweep engines should run: the user's
        override, or the jax.random-keyed stochastic tie-break sweep when
        ``set_tie_break('random', seed)`` is configured (SURVEY.md Q2 —
        reference src/lib.rs:249-253)."""
        if self.tie_break != "random":
            return self.sweep_fn
        key = tuple(shape)
        fn = self._tie_sweep_cache.get(key)
        if fn is None:
            from ..ops.flood import flood_sweep_random

            u = jax.random.uniform(
                jax.random.PRNGKey(self.tie_break_seed), key, dtype=jnp.float32
            )
            fn = partial(flood_sweep_random, u=u)
            self._tie_sweep_cache[key] = fn
        return fn

    def _resolved_backend(self, collect: str = "none") -> str:
        """The device engine for a call, the same on every platform.

        'auto': the priority-relaxation engine wherever it applies
        (segmenting always; merging final labels, curves and history, which
        rebuild on the host from its compact planes — ops.merge_curve), else
        the jnp level sweep."""
        if self.backend == "native":
            # The C++ engine serves transform / transform_to_list directly
            # (special-cased before run_levels); every other path needs a
            # device backend — fall back to the portable level sweep.
            return "jnp"
        if self.backend != "auto":
            return self.backend
        if self.tie_break == "random":
            # The relaxation engine is structurally min-label; the
            # stochastic rule runs on the jnp level sweep (builder
            # validation already restricts the combination).
            return "jnp"
        if not self._merging or collect in ("none", "sizes", "history"):
            return "relax"
        return "jnp"

    # -- construction helpers -------------------------------------------------

    def _clone_with_hook(self, hook):
        return type(self)(
            max_water_level=self.max_water_level,
            edge_correction=self.edge_correction,
            wlvl_hook=hook,
            plot_path=self.plot_path,
            plot_colour_map=self.plot_colour_map,
            progress=self.progress,
            debug=self.debug,
            sweep_fn=self.sweep_fn,
            backend=self.backend,
            mesh=self.mesh,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
            tie_break=self.tie_break,
            tie_break_seed=self.tie_break_seed,
        )

    def _prepare(self, input_img, seeds):
        """Apply edge correction + paint seeds (src/lib.rs:1329-1369)."""
        img = np.asarray(input_img, dtype=np.uint8)
        if self.edge_correction:
            # 1-px zero border; zeros are ALWAYS_FILL so the padding floods at
            # level 0 once it touches a coloured pixel.  Seed coordinates are
            # painted WITHOUT the +1 shift, replicating the reference quirk
            # (src/lib.rs:1365-1367, SURVEY.md Q7).
            img = np.pad(img, 1, constant_values=ALWAYS_FILL)
        labels0 = paint_seeds(img.shape, seeds)
        return jnp.asarray(img), labels0

    def _needs_host_loop(self) -> bool:
        return (
            self.wlvl_hook is not None
            or self.plot_path is not None
            or self.progress
            or self.debug
            or self.checkpoint_dir is not None
        )

    # -- core API --------------------------------------------------------------

    def transform(self, input_img, seeds, device_output: bool = False):
        """Final label image.

        ``device_output=True`` returns the labels as a device array instead
        of host numpy — pipelines that keep post-processing on the device
        skip the host-bound result transfer entirely.

        Implements the documented intent.  Reference divergence (SURVEY.md
        Q6): the reference's ``SegmentingWatershed::transform`` panics for
        ``max_water_level > 0`` (indexes the level-0 hook output) and
        ``MergingWatershed::transform`` is a constant-123 stub; both are bugs
        with no useful behaviour to replicate.
        """
        out = jnp.asarray if device_output else np.asarray
        if self.backend == "native" and not self._needs_host_loop():
            # Production CPU path: the C++ level-sweep engine
            # (parity/oracle.cc) — the framework's native-runtime counterpart
            # of the reference's rayon+jemalloc story.  Bit-identical to the
            # device backends (pinned by tests/test_native_oracle.py).
            from ..parity import native

            return out(
                native.native_transform(
                    np.asarray(input_img, dtype=np.uint8),
                    seeds,
                    self.max_water_level,
                    merging=self._merging,
                    edge_correction=self.edge_correction,
                ).astype(np.int32)
            )
        if (
            self.checkpoint_dir is not None
            and self.wlvl_hook is None
            and self.plot_path is None
            and not self.progress
            and not self.debug
            and self.mesh is None
            and self.tie_break == "min"
            and self.sweep_fn is None
            and self._resolved_backend() == "relax"
        ):
            # Fast-path checkpointing: set_checkpoint alone does not force
            # the host-stepped per-level loop — the relax engine's carried
            # planes snapshot between chunks of sweeps and resume
            # bit-exactly (ops/ckpt_relax.py).  Any OTHER observability
            # option still routes the host loop below (its semantics ARE
            # the per-level stepping).
            from ..ops.ckpt_relax import ckpt_transform
            from ..utils.checkpoint import TransformCheckpointer

            img, labels0 = self._prepare(input_img, seeds)
            labels = ckpt_transform(
                img,
                labels0,
                merging=self._merging,
                max_water_level=self.max_water_level,
                checkpointer=TransformCheckpointer(
                    self.checkpoint_dir, self.checkpoint_every
                ),
            )
            return out(labels)
        if self._needs_host_loop():
            # Observability (hook/plots/progress/debug/checkpoint) runs the
            # host-stepped loop, like the reference's clone_with_hook canned
            # hooks (src/lib.rs:1810-1822); we take the LAST level's view
            # (the documented intent — the reference's [0] indexing panics,
            # SURVEY.md Q6).
            clone = self._clone_with_hook(
                lambda ctx: ctx.colours.copy()
                if ctx.water_level == ctx.max_water_level
                else None
            )
            return out(clone._host_stepped(input_img, seeds)[-1])
        img, labels0 = self._prepare(input_img, seeds)
        if self.mesh is not None:
            from ..parallel.tiled import tiled_transform

            labels = tiled_transform(
                img,
                labels0,
                self.mesh,
                n_labels=_label_bucket(len(seeds)),
                max_water_level=self.max_water_level,
                merging=self._merging,
            )
            return out(labels)
        labels = run_levels(
            img,
            labels0,
            n_labels=_label_bucket(len(seeds)),
            max_water_level=self.max_water_level,
            merging=self._merging,
            collect="none",
            sweep_fn=self._effective_sweep_fn(img.shape),
            backend=self._resolved_backend(),
        )
        return out(labels)

    def transform_batch(self, input_imgs, seeds_list, device_output: bool = False):
        """Batched transform over a stack of same-shaped cutouts
        (BASELINE config 5: 64 x 1024² cutouts across a slice).

        ``seeds_list`` is one coordinate list per image.  Batching runs via
        ``jax.vmap`` of the jitted driver; with a mesh that has a 'batch'
        axis set on the builder, the batch is sharded over it (dp) and each
        image additionally tiles over the mesh's ('y', 'x') axes.
        ``device_output=True`` skips the host-bound result transfer (see
        ``transform``).
        """
        imgs = np.asarray(input_imgs, dtype=np.uint8)
        if imgs.ndim != 3:
            raise ValueError("transform_batch expects (B, H, W)")
        if len(seeds_list) != imgs.shape[0]:
            raise ValueError("one seed list per image required")
        if self.edge_correction:
            imgs = np.pad(
                imgs, ((0, 0), (1, 1), (1, 1)), constant_values=ALWAYS_FILL
            )
        labels0 = jnp.stack(
            [paint_seeds(imgs.shape[1:], s) for s in seeds_list]
        )
        bucket = _label_bucket(max((len(s) for s in seeds_list), default=0))
        ret = jnp.asarray if device_output else np.asarray

        if self.tie_break == "random":
            # Stochastic tie-break per image: fold the batch index into the
            # user's seed so every image gets an INDEPENDENT uniform plane
            # (a shared plane would correlate plateau partitions across the
            # batch), then vmap the jnp level sweep (the relax engine is
            # structurally min-label; builder validation
            # already blocks mesh + random).  Reference randomness applies
            # per transform: src/lib.rs:249-253.
            b, hh, ww = imgs.shape
            base_key = jax.random.PRNGKey(self.tie_break_seed)
            us = jax.vmap(
                lambda i: jax.random.uniform(
                    jax.random.fold_in(base_key, i), (hh, ww), dtype=jnp.float32
                )
            )(jnp.arange(b))
            out = _batch_random(
                jnp.asarray(imgs, jnp.int32),
                labels0,
                us,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
            )
            return ret(out)

        if self.mesh is not None and "batch" in self.mesh.axis_names:
            from ..parallel.tiled import tiled_transform

            out = tiled_transform(
                imgs,
                labels0,
                self.mesh,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
                axis_batch="batch",
            )
            return ret(out)

        if self._resolved_backend() == "relax":
            # Stack the batch VERTICALLY with per-image NEVER_FILL borders:
            # border pixels are unclaimable barriers in the relax engine
            # (exactly its own border rule), so claims, labels and the
            # component-min merge can never cross image boundaries — one
            # relax pass over the (B*H, W) plane is bit-identical to B
            # independent transforms.
            from ..constants import NEVER_FILL

            b, h, w = imgs.shape
            imgs = np.asarray(imgs).copy()
            imgs[:, 0, :] = NEVER_FILL
            imgs[:, -1, :] = NEVER_FILL
            imgs[:, :, 0] = NEVER_FILL
            imgs[:, :, -1] = NEVER_FILL
            # The MERGING variant additionally needs the component-min scans
            # segmented per image: on the bare stacked plane an inner
            # image's rows 0/H-1 are not global-border rows, so facing
            # BORDER SEEDS of adjacent images would be 4-adjacent and the
            # scans would join them (claims/labels themselves never cross —
            # border pixels are unclaimable, and seeds are immutable).  One
            # NEVER_FILL separator row per image (label 0 forever = a scan
            # barrier/reset row) restores per-image semantics, so the whole
            # merging path runs on the stack in ONE program.
            hs = h + 1 if self._merging else h
            if self._merging:
                sep_imgs = np.full((b, hs, w), NEVER_FILL, dtype=np.uint8)
                sep_imgs[:, :h] = imgs
                imgs = sep_imgs
                labels0 = jnp.pad(labels0, ((0, 0), (0, 1), (0, 0)))
            out = run_levels(
                jnp.asarray(imgs.reshape(b * hs, w)),
                labels0.reshape(b * hs, w),
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
                collect="none",
                backend="relax",
            )
            out = jnp.asarray(out).reshape(b, hs, w)[:, :h]
            return ret(out)

        # Level sweep: vmap over the jnp driver (merging label tables are
        # per-image under vmap).
        run = jax.vmap(
            partial(
                run_levels,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
                collect="none",
                sweep_fn=self.sweep_fn,
                backend="jnp",
            )
        )
        return ret(run(jnp.asarray(imgs), labels0))

    def transform_with_hook(self, input_img, seeds) -> list:
        """Run the transform, calling the configured hook each water level;
        returns the collected hook results (empty if no hook is set), like
        the reference (src/lib.rs:1509-1521)."""
        if self.wlvl_hook is None and not self._needs_host_loop():
            # Nothing observes the levels: run the fast path for side-effect
            # parity and return the empty collection like the reference.
            img, labels0 = self._prepare(input_img, seeds)
            run_levels(
                img,
                labels0,
                n_labels=_label_bucket(len(seeds)),
                max_water_level=self.max_water_level,
                merging=self._merging,
                collect="none",
                sweep_fn=self._effective_sweep_fn(img.shape),
                backend=self._resolved_backend(),
            )
            return []
        return self._host_stepped(input_img, seeds)

    def transform_to_list(
        self,
        input_img,
        seeds,
        counts_length: Optional[int] = None,
        copy: bool = False,
    ) -> list[tuple[int, np.ndarray]]:
        """Per-level lake-size histograms, fully on-device.

        Returns ``[(water_level, counts)]`` where ``counts[label]`` is the
        pixel count of that label and ``counts[0]`` the uncoloured count.
        ``counts_length=None`` replicates the reference's ``n_pixels + 1``
        vector length (src/lib.rs:630, SURVEY.md Q10); pass e.g.
        ``len(seeds) + 1`` for a compact result.

        Memory note (reference-length results): rows of a > 64 MB result
        share one (levels, counts_length) base array — retaining a single
        row keeps the whole block alive, and writing through one row's
        view writes the block.  Copy rows you intend to mutate or retain,
        or pass ``copy=True`` to get independent per-row allocations
        (doubles peak host memory on ~2 GB reference-length results).
        """
        if self.backend == "native" and not self._needs_host_loop():
            from ..parity import native

            _, sizes = native.native_transform(
                np.asarray(input_img, dtype=np.uint8),
                seeds,
                self.max_water_level,
                merging=self._merging,
                edge_correction=self.edge_correction,
                with_sizes=True,
            )
            if counts_length is None:
                n_px = int(np.prod(np.asarray(input_img).shape))
                if self.edge_correction:
                    n_px = int(
                        (np.asarray(input_img).shape[0] + 2)
                        * (np.asarray(input_img).shape[1] + 2)
                    )
                counts_length = n_px + 1
            return _expand_rows(sizes, counts_length, self.max_water_level, copy)
        if self._needs_host_loop():
            # The reference implements transform_to_list as
            # clone_with_hook(find_lake_sizes) (src/lib.rs:1551-1561); the
            # host-stepped loop gives debug/plots/progress their per-level
            # views and times the hook into PerfReport.lake_count_ms.
            length = counts_length

            def find_lake_sizes(ctx):
                n = length if length is not None else ctx.colours.size + 1
                counts = np.bincount(
                    ctx.colours.reshape(-1).astype(np.int64), minlength=n
                )[:n]
                row = np.zeros(n, dtype=np.int64)
                row[: len(counts)] = counts
                return (ctx.water_level, row)

            return self._clone_with_hook(find_lake_sizes)._host_stepped(
                input_img, seeds
            )
        img, labels0 = self._prepare(input_img, seeds)
        bucket = _label_bucket(len(seeds))
        if counts_length is None:
            # Reference row length: n_pixels + 1 (src/lib.rs:630, Q10) —
            # resolved HERE so the host merged-curve tail can write rows at
            # result width directly (no expand/truncate copy afterwards).
            counts_length = int(np.prod(img.shape)) + 1
        if self.mesh is not None:
            # Curves on a mesh (BOTH variants): ONE tiled relax pass exposes
            # the (labels, claim levels) planes (collect='claims'); the host
            # rebuilds the per-level histograms exactly like the
            # single-device merge_curve path — instead of replaying 255
            # per-level sweep rounds over the mesh.  The merging variant adds the
            # adjacency edges + Kruskal union; segmenting labels never merge,
            # so its histograms are the cumulative claim counts (zero edges).
            from ..ops.merge_curve import (
                clip_levels_u8,
                merge_edges,
                merged_curve_host,
            )
            from ..parallel.tiled import tiled_transform

            labels, L = tiled_transform(
                img,
                labels0,
                self.mesh,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=False,
                collect="claims",
            )
            if self._merging:
                lo, hi, act, n = merge_edges(
                    labels, L, max_water_level=self.max_water_level
                )
                n = int(n)
                lo, hi, act = (
                    np.asarray(lo[:n]),
                    np.asarray(hi[:n]),
                    np.asarray(act[:n]),
                )
            else:
                lo = hi = act = np.zeros((0,), np.int32)
            sizes = merged_curve_host(
                np.asarray(labels),
                np.asarray(
                    clip_levels_u8(L, max_water_level=self.max_water_level)
                ),
                bucket,
                self.max_water_level,
                lo,
                hi,
                act,
                out_width=counts_length,
            )
        else:
            backend = self._resolved_backend("sizes")
            if backend == "relax":
                # Per-level curves via ONE relax pass + compact planes to the
                # host (plus, for merging, the host union over deduplicated
                # label-adjacency edges) instead of a per-level sweep replay
                # and a (levels, K+1) device table (ops.merge_curve).
                from ..ops.merge_curve import relax_merging_sizes

                _, sizes = relax_merging_sizes(
                    img,
                    labels0,
                    n_labels=bucket,
                    max_water_level=self.max_water_level,
                    with_final=False,  # curves only — skip the merged plane
                    out_width=counts_length,
                    merging=self._merging,
                )
            else:
                _, sizes = run_levels(
                    img,
                    labels0,
                    n_labels=bucket,
                    max_water_level=self.max_water_level,
                    merging=self._merging,
                    collect="sizes",
                    sweep_fn=self._effective_sweep_fn(img.shape),
                    backend=backend,
                )
        sizes = np.asarray(sizes)
        return _expand_rows(sizes, counts_length, self.max_water_level, copy)

    def transform_history(self, input_img, seeds) -> list[tuple[int, np.ndarray]]:
        """Per-level label snapshots (src/lib.rs:1233-1237); memory-heavy:
        (levels, H, W) int32 accumulated on device — the reference carries
        the same ×max_water_level factor in host RAM (src/lib.rs:1229-1232).

        On the level-sweep backend, images whose device snapshot stack would
        exceed a fixed device-memory budget (e.g. 4096² at 255 levels =
        17 GB) route through the host-stepped loop, which ships one label
        plane per level and accumulates in host RAM instead."""
        route_host = self._needs_host_loop()
        backend = self._resolved_backend("history")
        compact = self.mesh is not None or backend == "relax"
        if not route_host and not compact:
            levels = self.max_water_level + 1
            # np.shape, NOT np.asarray(...).shape: the latter would force a
            # full device->host copy of a device array just to read a shape.
            # (The compact-planes paths never build the device snapshot
            # stack, so the HBM ceiling only gates the level-sweep
            # backends.)
            stack_bytes = 4 * levels * int(np.prod(np.shape(input_img)))
            # Conservative per-device HBM budget: the transform itself needs
            # a few plane-sized buffers on top of the snapshot stack.
            route_host = stack_bytes > 8 * 1024**3
        if route_host:
            return self._clone_with_hook(
                lambda ctx: (ctx.water_level, ctx.colours.copy())
            )._host_stepped(input_img, seeds)
        img, labels0 = self._prepare(input_img, seeds)
        bucket = _label_bucket(len(seeds))
        if self.mesh is not None:
            # History on a mesh: the same collect='claims' tiled pass as
            # transform_to_list; every per-level snapshot is rebuilt on the
            # host from the compact planes (plus the merge edges for the
            # merging variant) instead of stacking (levels, H, W) snapshots
            # on device and downloading them.
            from ..ops.merge_curve import (
                clip_levels_u8,
                history_from_planes,
                merge_edges,
            )
            from ..parallel.tiled import tiled_transform

            labels, L = tiled_transform(
                img,
                labels0,
                self.mesh,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=False,
                collect="claims",
            )
            lv8 = np.asarray(
                clip_levels_u8(L, max_water_level=self.max_water_level)
            )
            if self._merging:
                lo, hi, act, n = merge_edges(
                    labels, L, max_water_level=self.max_water_level
                )
                n = int(n)
                return history_from_planes(
                    np.asarray(labels),
                    lv8,
                    self.max_water_level,
                    np.asarray(lo[:n]),
                    np.asarray(hi[:n]),
                    np.asarray(act[:n]),
                    n_labels=bucket,
                )
            return history_from_planes(
                np.asarray(labels), lv8, self.max_water_level
            )
        if backend == "relax":
            from ..ops.merge_curve import relax_history

            return relax_history(
                img,
                labels0,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
            )
        _, hist = run_levels(
            img,
            labels0,
            n_labels=bucket,
            max_water_level=self.max_water_level,
            merging=self._merging,
            collect="history",
            sweep_fn=self._effective_sweep_fn(img.shape),
            backend=backend,
        )
        hist = np.asarray(hist)
        return [(lvl, hist[lvl]) for lvl in range(self.max_water_level + 1)]

    # -- host-stepped path (hooks / plots / progress / debug) ------------------

    def _fast_observer_ok(self) -> bool:
        """Pure per-level OBSERVERS (hook / plots) can replay bit-identical
        snapshots rebuilt from the relax engine's compact planes — one
        device pass instead of 255 host-stepped round trips, each with a
        plane download.  Anything that
        interacts with the stepping itself stays on the real loop:
        progress (per-colouring-iteration ticks), debug (split-phase
        timers), checkpointing (incremental saves are the failure-recovery
        point), stochastic tie-break / custom sweeps (level-sweep-engine
        semantics)."""
        return (
            not self.debug
            and not self.progress
            and self.checkpoint_dir is None
            and self.tie_break == "min"
            and self.sweep_fn is None
            and self.backend != "native"
            and (
                self.mesh is not None
                or self._resolved_backend("history") == "relax"
            )
        )

    def _replayed_observers(self, input_img, seeds) -> list:
        """Hook/plot replay over compact-plane snapshots (one live at a
        time): identical HookCtx views and plot files to the host-stepped
        loop — parity pinned by tests/test_merge_fast.py and the history
        tests (same rebuild machinery)."""
        img, labels0 = self._prepare(input_img, seeds)
        bucket = _label_bucket(len(seeds))
        if self.mesh is not None:
            from ..ops.merge_curve import (
                clip_levels_u8,
                iter_history_from_planes,
                merge_edges,
            )
            from ..parallel.tiled import tiled_transform

            labels, L = tiled_transform(
                img,
                labels0,
                self.mesh,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=False,
                collect="claims",
            )
            lv8 = np.asarray(
                clip_levels_u8(L, max_water_level=self.max_water_level)
            )
            if self._merging:
                lo, hi, act, n = merge_edges(
                    labels, L, max_water_level=self.max_water_level
                )
                n = int(n)
                snaps = iter_history_from_planes(
                    np.asarray(labels),
                    lv8,
                    self.max_water_level,
                    np.asarray(lo[:n]),
                    np.asarray(hi[:n]),
                    np.asarray(act[:n]),
                    n_labels=bucket,
                )
            else:
                snaps = iter_history_from_planes(
                    np.asarray(labels), lv8, self.max_water_level
                )
        else:
            from ..ops.merge_curve import relax_history

            snaps = relax_history(
                img,
                labels0,
                n_labels=bucket,
                max_water_level=self.max_water_level,
                merging=self._merging,
                as_iter=True,
            )
        seed_colours = tuple(
            (col, (int(y), int(x))) for col, (y, x) in enumerate(seeds, start=1)
        )
        img_np = np.asarray(img)
        results = []
        for lvl, labels_np in snaps:
            if self.plot_path is not None:
                self._plot_level(labels_np, lvl)
            if self.wlvl_hook is not None:
                results.append(
                    self.wlvl_hook(
                        HookCtx(
                            water_level=lvl,
                            max_water_level=self.max_water_level,
                            image=img_np,
                            colours=labels_np,
                            seeds=seed_colours,
                        )
                    )
                )
        return results

    def _host_stepped(self, input_img, seeds) -> list:
        if self._fast_observer_ok():
            return self._replayed_observers(input_img, seeds)
        img, labels = self._prepare(input_img, seeds)
        bucket = _label_bucket(len(seeds))
        seed_colours = tuple(
            (col, (int(y), int(x))) for col, (y, x) in enumerate(seeds, start=1)
        )
        img_np = np.asarray(img)

        mesh_stepper = None
        if self.mesh is not None:
            # Observability on the mesh: the host loop drives a per-level
            # tiled step (shard_map flood fixed point + merge phase) so
            # hooks/plots/progress/debug work on images that need tiling,
            # like the reference's hooks firing under its parallel runtime
            # (src/lib.rs:1509-1518).  Hook views are cropped back to the
            # (padded-for-edge-correction) domain shape and bit-match the
            # single-device host-stepped run.  Debug mode times whole levels
            # (the split-phase timers are single-device granularity).
            from ..parallel.tiled import MeshLevelStepper

            mesh_stepper = MeshLevelStepper(
                self.mesh, n_labels=bucket, merging=self._merging
            )
            img, labels = mesh_stepper.prepare(img, labels)
        elif self.debug:
            # Split-phase jits so the PerfReport can time candidate search,
            # paint and merge separately, mirroring the reference's
            # instrumentation points (src/lib.rs:1404-1436, :1446-1470).
            from ..ops.flood import flood_candidates, paint
            from ..ops.merge import merge_touching

            if self.tie_break == "random":
                # Debug split-phase timers under the stochastic rule: the
                # candidate search returns the random choice instead of the
                # neighbour min; the paint phase is identical.
                from ..ops.flood import flood_candidates_random

                u = jax.random.uniform(
                    jax.random.PRNGKey(self.tie_break_seed),
                    tuple(img.shape),
                    dtype=jnp.float32,
                )
                cand_fn = partial(flood_candidates_random, u=u)
            else:
                cand_fn = flood_candidates
            cand_jit = cache_resilient(jax.jit(cand_fn))
            paint_jit = cache_resilient(jax.jit(paint))
            merge_jit = (
                cache_resilient(
                    jax.jit(partial(merge_touching, n_labels=bucket))
                )
                if self._merging
                else None
            )
        else:
            # One jitted program per level; level_step_counted additionally
            # returns the colouring-iteration count so the progress bar can
            # tick once per fixed-point iteration (src/lib.rs:1395-1398).
            step = cache_resilient(jax.jit(
                partial(
                    level_step_counted if self.progress else level_step,
                    merging=self._merging,
                    n_labels=bucket,
                    sweep_fn=self._effective_sweep_fn(img.shape),
                )
            ))

        bar = ProgressBar(self.max_water_level) if self.progress else None
        if self.debug:
            # Reference prints the initial lake count (src/lib.rs:1371-1372).
            print(f"starting with {len(seeds) + 1} lakes")

        ckpt = None
        start_lvl = 0
        if self.checkpoint_dir is not None:
            from ..utils.checkpoint import TransformCheckpointer

            ckpt = TransformCheckpointer(self.checkpoint_dir, self.checkpoint_every)
            latest = ckpt.latest()
            if latest is not None:
                start_lvl, lab_np = latest
                if mesh_stepper is not None:
                    # Checkpoints store the cropped domain; re-embed in the
                    # mesh-padded plane.
                    img, labels = mesh_stepper.prepare(img_np, lab_np)
                else:
                    labels = jnp.asarray(lab_np)
                # Resume at the level after the snapshot; a snapshot taken AT
                # the final level re-runs that level (idempotent: the flood
                # fixed point and merge are no-ops on converged labels) so
                # hooks/plots for the final level still fire.
                start_lvl = min(start_lvl + 1, self.max_water_level)

        results = []
        for lvl in range(start_lvl, self.max_water_level + 1):
            perf = PerfReport() if self.debug else None
            t_level = time.perf_counter()
            if mesh_stepper is not None:
                t0 = time.perf_counter()
                labels, loops = mesh_stepper.step(img, labels, lvl)
                labels.block_until_ready()
                if perf is not None:
                    perf.loops = int(loops)
                    perf.big_iter_ms.append(
                        int((time.perf_counter() - t0) * 1e3)
                    )
                if bar is not None:
                    # One tick per halo-exchange round (the mesh analogue of
                    # the reference's per-colouring-iteration ticks).
                    for _ in range(int(loops)):
                        bar.tick()
            elif self.debug:
                # Host-stepped colouring loop with per-phase timers and
                # per-iteration progress ticks, like the reference's 'debug'
                # feature (src/lib.rs:1379-1438).  Slow (one dispatch per
                # sweep) — that is the point of a debug mode.
                lvl_j = jnp.int32(lvl)
                painted_any = False
                while True:
                    if bar is not None:
                        bar.tick()
                    perf.loops += 1
                    t0 = time.perf_counter()
                    cand, nmin, any_p = cand_jit(img, labels, lvl_j)
                    any_p = bool(any_p)  # forces the candidate search
                    perf.big_iter_ms.append(
                        int((time.perf_counter() - t0) * 1e3)
                    )
                    if not any_p:
                        break
                    t0 = time.perf_counter()
                    labels = paint_jit(labels, cand, nmin)
                    labels.block_until_ready()
                    perf.colouring_mus.append(
                        int((time.perf_counter() - t0) * 1e6)
                    )
                    painted_any = True
                if merge_jit is not None and (painted_any or lvl == 0):
                    t0 = time.perf_counter()
                    labels = merge_jit(labels)
                    labels.block_until_ready()
                    perf.merge_ms = int((time.perf_counter() - t0) * 1e3)
            elif self.progress:
                labels, loops = step(img, labels, jnp.int32(lvl))
                labels.block_until_ready()
                # Per-colouring-iteration ticks (src/lib.rs:1395-1398); the
                # loop count comes back from the single jitted level program.
                for _ in range(int(loops)):
                    bar.tick()
            else:
                labels = step(img, labels, jnp.int32(lvl))
                labels.block_until_ready()

            labels_np = (
                mesh_stepper.crop(labels)
                if mesh_stepper is not None
                else np.asarray(labels)
            )
            if ckpt is not None:
                ckpt.maybe_save(lvl, labels_np)
            if self.plot_path is not None:
                self._plot_level(labels_np, lvl)
            if bar is not None:
                bar.inc()
            if self.wlvl_hook is not None:
                ctx = HookCtx(
                    water_level=lvl,
                    max_water_level=self.max_water_level,
                    image=img_np,
                    colours=labels_np,
                    seeds=seed_colours,
                )
                t0 = time.perf_counter()
                results.append(self.wlvl_hook(ctx))
                if perf is not None:
                    # Hook timing (find_lake_sizes is the transform_to_list
                    # hook).  NB divergence: the reference DECLARES and
                    # prints lake_count_ms but never assigns it
                    # (src/lib.rs:649, :682 — no write site); we populate it.
                    perf.lake_count_ms = int((time.perf_counter() - t0) * 1e3)
            if perf is not None:
                perf.total_ms = int((time.perf_counter() - t_level) * 1e3)
                print(perf)
        if bar is not None:
            bar.finish()
        if ckpt is not None:
            ckpt.wait()
        return results

    def _plot_level(self, labels_np: np.ndarray, lvl: int):
        from ..utils import plotting

        view = labels_np
        if self.edge_correction:
            # Plots are cropped to the unpadded image (src/lib.rs:1476-1481).
            view = labels_np[1:-1, 1:-1]
        cmap = self.plot_colour_map or plotting.viridis
        import os

        plotting.plot_slice(
            view, os.path.join(str(self.plot_path), f"ws_lvl{lvl}.png"), cmap
        )
