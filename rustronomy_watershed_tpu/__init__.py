"""rustronomy_watershed_tpu — a JAX/XLA rebuild of the segmenting and merging
watershed transforms of ``smups/rustronomy-watershed``.

The reference's rayon-parallel window sweeps become fused whole-image stencil
kernels under ``jit``; its serial union-find becomes scatter-min +
pointer-jumping on device; large mosaics tile over a ``jax.sharding.Mesh``
with halo exchange between devices, and stacks of cutouts are stacked into
one device plane.

Public surface mirrors the reference crate: ``TransformBuilder``,
``SegmentingWatershed`` / ``MergingWatershed`` (``transform``,
``transform_with_hook``, ``transform_to_list``, ``transform_history``),
``WatershedUtils`` (``pre_processor``, ``find_local_minima``), the label
constants, and the plotting colour maps.
"""

from .builder import BuildErr, TransformBuilder
from .constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX, UNCOLOURED
from .models import HookCtx, MergingWatershed, SegmentingWatershed, WatershedUtils

__version__ = "0.1.0"

__all__ = [
    "ALWAYS_FILL",
    "NEVER_FILL",
    "NORMAL_MAX",
    "UNCOLOURED",
    "BuildErr",
    "TransformBuilder",
    "HookCtx",
    "MergingWatershed",
    "SegmentingWatershed",
    "WatershedUtils",
    "prelude",
]

from . import prelude  # noqa: E402  (re-export module, mirrors the crate)
