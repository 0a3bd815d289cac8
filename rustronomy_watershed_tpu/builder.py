"""The public builder API: configure, then build a transform.

Mirrors the reference's ``TransformBuilder`` surface
(/root/reference/src/lib.rs:864-1065): chainable setters, water-level
validation (``BuildErr``), and ``build_merging`` / ``build_segmenting``
producing the two transform objects.  The reference's compile-time cargo
features map to runtime switches (``enable_progress`` / ``enable_debug``;
plots activate when a folder is set, matching the reference's "no folder, no
plots" behaviour, src/lib.rs:987-994).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .constants import ALWAYS_FILL, NORMAL_MAX
from .models.base import HookCtx
from .models.merging import MergingWatershed
from .models.segmenting import SegmentingWatershed


BACKENDS = ("auto", "relax", "jnp", "native")


class BuildErr(Exception):
    """Configuration error raised by build_* (src/lib.rs:1049-1065) and by
    ``set_backend`` for an engine this package does not have."""

    MAX_TOO_HIGH = "MaxToHigh"
    MAX_TOO_LOW = "MaxToLow"
    UNKNOWN_BACKEND = "UnknownBackend"

    def __init__(self, kind: str, value):
        self.kind = kind
        if kind == self.UNKNOWN_BACKEND:
            self.backend = value
            msg = (
                f"unknown backend {value!r}; accepted values are "
                + ", ".join(repr(b) for b in BACKENDS)
            )
        else:
            self.max_water_level = value
            if kind == self.MAX_TOO_HIGH:
                msg = (
                    f"Maximum water level set to {value}, which is higher "
                    f"than the maximum allowed value {NORMAL_MAX}"
                )
            else:
                msg = (
                    f"Maximum water level set to {value}, which is lower "
                    f"than the minimum allowed value {ALWAYS_FILL + 1}"
                )
        super().__init__(msg)


class TransformBuilder:
    """Chainable configuration for a watershed transform."""

    def __init__(self):
        self.max_water_level = NORMAL_MAX
        self.edge_correction = False
        self.wlvl_hook: Optional[Callable[[HookCtx], Any]] = None
        self.plot_path = None
        self.plot_colour_map = None
        self.progress = False
        self.debug = False
        self.sweep_fn = None
        self.backend = "auto"
        self.mesh = None
        self.checkpoint_dir = None
        self.checkpoint_every = 16
        self.tie_break = "min"
        self.tie_break_seed = 0

    # ``new()`` and ``default()`` both exist in the reference purely to work
    # around Rust type inference (src/lib.rs:875-892); kept as aliases.
    @classmethod
    def new(cls) -> "TransformBuilder":
        return cls()

    @classmethod
    def default(cls) -> "TransformBuilder":
        return cls()

    def set_max_water_lvl(self, max_water_lvl: int) -> "TransformBuilder":
        self.max_water_level = int(max_water_lvl)
        return self

    def enable_edge_correction(self) -> "TransformBuilder":
        self.edge_correction = True
        return self

    def set_wlvl_hook(self, hook: Callable[[HookCtx], Any]) -> "TransformBuilder":
        self.wlvl_hook = hook
        return self

    def set_plot_colour_map(self, colour_map) -> "TransformBuilder":
        self.plot_colour_map = colour_map
        return self

    def set_plot_folder(self, path) -> "TransformBuilder":
        self.plot_path = path
        return self

    def enable_progress(self) -> "TransformBuilder":
        """Runtime equivalent of the reference's ``progress`` cargo feature."""
        self.progress = True
        return self

    def enable_debug(self) -> "TransformBuilder":
        """Runtime equivalent of the reference's ``debug`` cargo feature."""
        self.debug = True
        return self

    def set_sweep_impl(self, sweep_fn) -> "TransformBuilder":
        """Advanced: override the flood sweep of the level-sweep engine;
        must be semantically >= 1 Jacobi sweeps."""
        self.sweep_fn = sweep_fn
        return self

    def set_backend(self, backend: str) -> "TransformBuilder":
        """'auto' (default: the priority-relaxation engine wherever it
        applies, the jnp level sweep otherwise — the same choice on every
        platform), 'relax', 'jnp' (the level sweep), or 'native' (the C++
        engine on the host) — all bit-identical.  Anything else raises
        ``BuildErr``."""
        if backend not in BACKENDS:
            raise BuildErr(BuildErr.UNKNOWN_BACKEND, backend)
        self.backend = backend
        return self

    def set_tie_break(self, mode: str, seed: int = 0) -> "TransformBuilder":
        """Plateau tie-break rule when a floodable pixel has differently
        coloured 4-neighbours.

        ``'min'`` (default): the minimum label wins — the pinned
        deterministic rule every engine implements (SURVEY.md Q2).
        ``'random'``: a uniformly-random coloured 4-neighbour position wins,
        reproducing the reference's thread_rng behaviour distributionally
        (src/lib.rs:249-253) but reproducibly (jax.random keyed by ``seed``)
        — e.g. for sensitivity analysis of lake statistics under plateau
        partitioning.  Runs on the jnp level-sweep engine (the relaxation
        engines are inherently min-label), single-device, and is mutually
        exclusive with ``set_sweep_impl``.  ``transform_batch`` supports it
        too: each image draws an independent uniform plane (the batch index
        is folded into ``seed``), so per-image statistics match a looped
        single-image run distributionally."""
        if mode not in ("min", "random"):
            raise ValueError(f"unknown tie-break mode {mode!r}")
        self.tie_break = mode
        self.tie_break_seed = int(seed)
        return self

    def set_checkpoint(self, directory, every: int = 16) -> "TransformBuilder":
        """Snapshot (water_level, labels) every N levels (orbax) on the
        host-stepped path and resume bit-exactly from the newest snapshot
        (no reference counterpart — SURVEY.md §5 lists checkpoint/resume as
        absent upstream)."""
        self.checkpoint_dir = directory
        self.checkpoint_every = every
        return self

    def set_mesh(self, mesh) -> "TransformBuilder":
        """Tile the transform over a 2-D ('y','x') jax.sharding.Mesh with
        halo exchange between devices (parallel.tiled_transform).  Applies to the
        fast paths (transform / transform_to_list); hook-observed runs stay
        single-device."""
        self.mesh = mesh
        return self

    def _validate(self):
        if self.max_water_level > NORMAL_MAX:
            raise BuildErr(BuildErr.MAX_TOO_HIGH, self.max_water_level)
        if self.max_water_level <= ALWAYS_FILL:
            raise BuildErr(BuildErr.MAX_TOO_LOW, self.max_water_level)
        if self.tie_break == "random":
            if self.sweep_fn is not None:
                raise ValueError(
                    "set_tie_break('random') replaces the flood sweep and is "
                    "mutually exclusive with set_sweep_impl"
                )
            if self.backend not in ("auto", "jnp"):
                raise ValueError(
                    "set_tie_break('random') runs on the jnp level-sweep "
                    f"engine; backend {self.backend!r} is min-label only"
                )
            if self.mesh is not None:
                raise ValueError(
                    "set_tie_break('random') is single-device (the tiled "
                    "engines pin the min-label rule)"
                )

    def _kwargs(self):
        return dict(
            max_water_level=self.max_water_level,
            edge_correction=self.edge_correction,
            wlvl_hook=self.wlvl_hook,
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

    def build_merging(self) -> MergingWatershed:
        self._validate()
        return MergingWatershed(**self._kwargs())

    def build_segmenting(self) -> SegmentingWatershed:
        self._validate()
        return SegmentingWatershed(**self._kwargs())
