"""Tiled multi-device watershed: shard_map over a 2-D mesh with halo exchange.

The device counterpart of the reference's shared-memory rayon parallelism
(SURVEY.md §2 "Parallelism & communication"): the image is tiled over a
('y', 'x') device mesh; each step exchanges a k-px halo between devices
(``lax.ppermute``), runs k local Jacobi sweeps (bit-identical to k global
sweeps — information moves one 4-connected pixel per sweep), and reduces a
global "any pixel changed" flag with ``lax.psum``.  Region merging keeps the
parent table replicated: local adjacency scatter-mins are combined with
``lax.pmin`` and pointer jumping runs redundantly (and identically) on every
device, avoiding host round-trips.

Two tiled engines:

* **relax** (default wherever it applies): the priority-relaxation engine
  (ops.priority) tiled — each round exchanges k-px halos of the (L, d,
  label) planes and runs k local relax sweeps.  k local sweeps on a
  k-px halo equal k global sweeps (wrap-ghost corruption penetrates at most
  k-1 rings into the k-wide halo, which is cropped), so every mesh shape
  walks the single-device trajectory, and the global fixed point is
  detected with a psum'd centre-change flag.  O(longest claim chain / k)
  exchanges for the whole transform instead of per-level ring sums.
* **sweep**: the per-water-level flood loop (needed for the merging
  variant's per-level statistics, whose merge phase is inherently
  per-level).

An optional leading batch axis composes (dp-style): each device may hold a
(B_local, h, w) stack (BASELINE config 5: 64x1024² cutouts), with per-batch
parent tables.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import INT32_MAX, NEVER_FILL, UNCOLOURED
from ..ops.flood import flood_sweep
from ..ops.priority import relax_sweep
from .halo import exchange_halo, global_interior_mask

_BIG = np.int32(INT32_MAX)
_BIG_L = NEVER_FILL + 1
_BIG_D = 2**30
# Default halo = local relax sweeps per exchange round: rounds shrink as
# ~chain/k while the halo strips stay a few percent of a 1024-px tile.
_DEFAULT_HALO = 16


def _take_per_batch(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather table[b, idx[b, ...]] for a (B, K+1) table and (B, ...) indices."""
    b = table.shape[0]
    flat = jnp.take_along_axis(table, idx.reshape(b, -1), axis=1)
    return flat.reshape(idx.shape)


def _batched_bincount(values: jnp.ndarray, length: int) -> jnp.ndarray:
    """(B, ...) int values -> (B, length) counts."""
    b = values.shape[0]
    flat = values.reshape(b, -1)
    rows = jax.lax.broadcasted_iota(jnp.int32, flat.shape, 0)
    out = jnp.zeros((b, length), dtype=jnp.int32)
    return out.at[rows.reshape(-1), flat.reshape(-1)].add(
        jnp.ones(flat.size, dtype=jnp.int32), mode="drop"
    )


def _merge_fixed_point(
    lab, *, n_labels, merge_mask, axes, control_axes
):
    """Transitive min-label union of all touching regions, mesh-globally.

    The parent table is replicated: per-device adjacency scatter-mins combine
    with ``lax.pmin``; pointer jumping runs identically everywhere.
    ``lab`` is (B, h, w); returns the relabelled tile.
    """
    b = lab.shape[0]
    ident = jnp.broadcast_to(
        jnp.arange(n_labels + 1, dtype=jnp.int32), (b, n_labels + 1)
    )

    def cond(state):
        return state[1]

    def body(state):
        parent, _ = state
        cur = _take_per_batch(parent, lab)
        cur_p = exchange_halo(cur, 1, *axes, off_grid_fill=UNCOLOURED)

        def differing(n):
            return jnp.where((n != UNCOLOURED) & (n != cur_p), n, _BIG)

        hp, wp = cur_p.shape[-2:]
        pad = [(0, 0), (1, 1), (1, 1)]
        pp = jnp.pad(cur_p, pad, constant_values=UNCOLOURED)
        diff_min = _BIG
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb = pp[:, 1 + dy : 1 + dy + hp, 1 + dx : 1 + dx + wp]
            diff_min = jnp.minimum(diff_min, differing(nb))
        valid = (cur_p != UNCOLOURED) & merge_mask
        diff_min = jnp.where(valid, diff_min, _BIG)

        adj = jnp.full((b, n_labels + 1), _BIG, dtype=jnp.int32)
        rows = jax.lax.broadcasted_iota(jnp.int32, (b, hp * wp), 0)
        adj = adj.at[rows.reshape(-1), cur_p.reshape(-1)].min(
            diff_min.reshape(-1), mode="drop"
        )
        adj = lax.pmin(adj, axes)

        safe = jnp.minimum(adj, jnp.int32(n_labels))
        cand = jnp.where(adj != _BIG, _take_per_batch(parent, safe), _BIG)
        new_parent = jnp.minimum(parent, cand)

        def jcond(s):
            return s[1]

        def jbody(s):
            p, _ = s
            p2 = _take_per_batch(p, p)
            return p2, jnp.any(p2 != p)

        new_parent, _ = lax.while_loop(jcond, jbody, (new_parent, jnp.bool_(True)))
        changed = (
            lax.psum(
                jnp.any(new_parent != parent).astype(jnp.int32), control_axes
            )
            > 0
        )
        return new_parent, changed

    parent, _ = lax.while_loop(cond, body, (ident, jnp.bool_(True)))
    return _take_per_batch(parent, lab)


def _batched_sizes_from_levels(lab, lv, n_labels, max_water_level):
    """Per-tile (B, levels, K+1) cumulative claim counts (no column-0 fix —
    the caller psums across tiles first, then complements column 0)."""
    b = lab.shape[0]
    levels = max_water_level + 1
    labf = lab.reshape(b, -1)
    lvf = jnp.clip(lv.reshape(b, -1), 0, levels)
    rows = jax.lax.broadcasted_iota(jnp.int32, labf.shape, 0)
    counts = jnp.zeros((b, levels + 1, n_labels + 1), dtype=jnp.int32)
    counts = counts.at[rows.reshape(-1), lvf.reshape(-1), labf.reshape(-1)].add(
        jnp.ones(labf.size, dtype=jnp.int32), mode="drop"
    )
    return jnp.cumsum(counts[:, :levels], axis=1)


def _local_relax_driver(
    img_tile,
    lab_tile,
    *,
    global_shape,
    n_labels,
    max_water_level,
    merging,
    halo,
    collect,
    axis_y,
    axis_x,
    control_axes,
    with_stats=False,
):
    """Tiled priority relaxation (runs under shard_map).  Shapes: (B, h, w).

    Each round exchanges k-px halos and runs k local sweeps, which equal k
    global sweeps; convergence is declared on a globally change-free round.
    ``with_stats=True`` also returns the number of exchange rounds run.
    """
    axes = (axis_y, axis_x)
    b, h, w = lab_tile.shape
    k = halo

    # Static image halo (exchange once) with the GLOBAL border rule: v_eff is
    # NEVER_FILL outside the global interior (the reference never paints
    # border pixels, src/lib.rs:220-233) — which also covers off-grid cells.
    v_p = exchange_halo(
        img_tile.astype(jnp.int32), k, axis_y, axis_x, off_grid_fill=NEVER_FILL
    )
    interior = global_interior_mask((h, w), global_shape, k, axis_y, axis_x)
    v_p = jnp.where(interior, v_p, NEVER_FILL)

    lab_tile = lab_tile.astype(jnp.int32)
    seeds = lab_tile != UNCOLOURED
    L = jnp.where(seeds, jnp.int32(0), jnp.int32(_BIG_L))
    d = jnp.where(seeds, jnp.int32(0), jnp.int32(_BIG_D))

    def body(state):
        (L, d, lab), _, rounds = state
        Lp = exchange_halo(L, k, axis_y, axis_x, off_grid_fill=_BIG_L)
        dp = exchange_halo(d, k, axis_y, axis_x, off_grid_fill=_BIG_D)
        labp = exchange_halo(lab, k, axis_y, axis_x, off_grid_fill=UNCOLOURED)
        # A loop, not k unrolled sweeps: same result, a k-times smaller
        # program to compile.
        st = lax.fori_loop(
            0, k, lambda _, st: relax_sweep(v_p, st), (Lp, dp, labp)
        )
        L2, d2, lab2 = (a[..., k:-k, k:-k] for a in st)
        changed = (
            lax.psum(
                jnp.any((L2 != L) | (d2 != d) | (lab2 != lab)).astype(jnp.int32),
                control_axes,
            )
            > 0
        )
        return (L2, d2, lab2), changed, rounds + 1

    (L, d, lab), _, rounds = lax.while_loop(
        lambda s: s[1], body, ((L, d, lab_tile), jnp.bool_(True), jnp.int32(0))
    )
    labels = jnp.where(L <= max_water_level, lab, UNCOLOURED)
    out = _relax_collect_tail(
        labels,
        L,
        global_shape=global_shape,
        n_labels=n_labels,
        max_water_level=max_water_level,
        merging=merging,
        collect=collect,
        axis_y=axis_y,
        axis_x=axis_x,
        control_axes=control_axes,
    )
    return (out, rounds) if with_stats else out


def _relax_collect_tail(
    labels,
    L,
    *,
    global_shape,
    n_labels,
    max_water_level,
    merging,
    collect,
    axis_y,
    axis_x,
    control_axes,
):
    """Statistics/merge tail of the tiled relax engine: per-level
    curves and history snapshots come post-hoc from the claim levels L.

    ``collect='claims'`` skips the tail entirely and returns the raw
    (labels, claim levels) planes — the mesh merge-curve path
    (models/base.transform_to_list) derives merged per-level statistics
    from them with ONE relax pass instead of the per-level sweep loop."""
    axes = (axis_y, axis_x)
    h, w = labels.shape[-2:]

    if collect == "claims":
        return labels, L

    if merging:
        # Final merged labels: transitive union over the claimed set (the
        # per-level merge curve needs the sweep engine; final labels do not).
        merge_mask = global_interior_mask((h, w), global_shape, 1, axis_y, axis_x)
        labels = _merge_fixed_point(
            labels,
            n_labels=n_labels,
            merge_mask=merge_mask,
            axes=axes,
            control_axes=control_axes,
        )
        if collect != "none":
            raise ValueError("tiled relax: merging supports collect='none' only")

    if collect == "none":
        return labels

    if collect == "sizes":
        cum = _batched_sizes_from_levels(labels, L, n_labels, max_water_level)
        cum = lax.psum(cum, axes)
        total = global_shape[0] * global_shape[1]
        coloured = jnp.sum(cum[:, :, 1:], axis=2)
        cum = cum.at[:, :, 0].set(total - coloured)
        return labels, jnp.swapaxes(cum, 0, 1)  # (levels, B, K+1)

    if collect == "history":
        levels = max_water_level + 1
        lvls = jnp.arange(levels, dtype=jnp.int32)[:, None, None, None]
        hist = jnp.where(L[None] <= lvls, labels[None], UNCOLOURED)
        return labels, hist  # (levels, B, h, w)

    raise ValueError(f"unknown collect mode {collect!r}")


def _tiled_flood_fixed_point(
    img_p, lab, lvl, *, halo, paint_mask, axis_y, axis_x, control_axes
):
    """Flood one water level to the mesh-global fixed point: per round,
    exchange a halo-px label halo, run ``halo`` local Jacobi
    sweeps (bit-identical to halo global sweeps), psum the change flag.
    Returns (labels, rounds) — shared by the whole-transform driver and
    the per-level observability step so their semantics can never drift."""

    def body(state):
        lab, _, n = state
        lab_p = exchange_halo(lab, halo, axis_y, axis_x, off_grid_fill=UNCOLOURED)
        lab_p = lax.fori_loop(
            0, halo, lambda i, lp: flood_sweep(img_p, lp, lvl, paint_mask), lab_p
        )
        new = lab_p[..., halo:-halo, halo:-halo]
        changed = (
            lax.psum(jnp.any(new != lab).astype(jnp.int32), control_axes) > 0
        )
        return new, changed, n + 1

    lab, _, rounds = lax.while_loop(
        lambda s: s[1], body, (lab, jnp.bool_(True), jnp.int32(0))
    )
    return lab, rounds


def _local_level_driver(
    img_tile,
    lab_tile,
    *,
    global_shape,
    n_labels,
    max_water_level,
    merging,
    halo,
    collect,
    axis_y,
    axis_x,
    control_axes,
):
    """Per-device level-sweep body (runs under shard_map).  Shapes: (B, h, w).

    ``control_axes`` covers ALL mesh axes (incl. a batch axis): every loop
    predicate is reduced over it so all devices execute identical collective
    sequences — divergent trip counts across batch groups deadlock the
    in-process CPU communicator and serialize poorly across devices.  Converged
    groups simply run no-op sweeps.
    """
    axes = (axis_y, axis_x)
    img_tile = img_tile.astype(jnp.int32)
    b, h, w = lab_tile.shape

    # Image halo is static across the whole transform: exchange once.
    img_p = exchange_halo(img_tile, halo, axis_y, axis_x, off_grid_fill=NEVER_FILL)
    paint_mask = global_interior_mask((h, w), global_shape, halo, axis_y, axis_x)
    merge_mask = global_interior_mask((h, w), global_shape, 1, axis_y, axis_x)

    # Global per-level pixel-value counts for the level-skip early exit
    # (reduced over ALL axes: the skip decision must be mesh-uniform).
    vhist = lax.psum(_batched_bincount(img_tile, 256), control_axes)

    def step(lab, lvl):
        lab, _ = _tiled_flood_fixed_point(
            img_p, lab, lvl, halo=halo, paint_mask=paint_mask,
            axis_y=axis_y, axis_x=axis_x, control_axes=control_axes,
        )
        if merging:
            lab = _merge_fixed_point(
                lab,
                n_labels=n_labels,
                merge_mask=merge_mask,
                axes=axes,
                control_axes=control_axes,
            )
        return lab

    levels = max_water_level + 1

    def run_lvl(lvl, lab):
        return lax.cond(
            (lvl == 0) | jnp.any(vhist[:, lvl] > 0),
            lambda l: step(l, lvl),
            lambda l: l,
            lab,
        )

    if collect == "none":
        final = lax.fori_loop(0, levels, run_lvl, lab_tile)
        return final

    if collect == "sizes":
        out = jnp.zeros((levels, b, n_labels + 1), dtype=jnp.int32)

        # Column 0 is the COMPLEMENT against the original domain size, not a
        # direct bincount: mesh padding pixels are UNCOLOURED forever and
        # must not inflate the uncoloured count (same rule as
        # _relax_collect_tail).
        total = global_shape[0] * global_shape[1]

        def body(lvl, carry):
            lab, out = carry
            lab = run_lvl(lvl, lab)
            counts = lax.psum(_batched_bincount(lab, n_labels + 1), axes)
            counts = counts.at[:, 0].set(
                total - jnp.sum(counts[:, 1:], axis=1)
            )
            return lab, out.at[lvl].set(counts)

        final, out = lax.fori_loop(0, levels, body, (lab_tile, out))
        return final, out

    if collect == "history":
        out = jnp.zeros((levels, b, h, w), dtype=jnp.int32)

        def body(lvl, carry):
            lab, out = carry
            lab = run_lvl(lvl, lab)
            return lab, out.at[lvl].set(lab)

        final, out = lax.fori_loop(0, levels, body, (lab_tile, out))
        return final, out

    raise ValueError(f"unknown collect mode {collect!r}")


def _mesh_pad(img, labels0, ny: int, nx: int):
    """Embed (B, H, W) arrays in a mesh-divisible domain with INERT padding.

    Padding pixels get NEVER_FILL values / UNCOLOURED labels at the bottom /
    right; every driver applies its interior rule against the ORIGINAL
    (gh, gw) via ``global_interior_mask``, so padded cells (like the original
    1-px border) can never claim, donate, or act as merge centres — the crop
    back to (gh, gw) is bit-identical to the exact-divisible run.
    """
    _, gh, gw = img.shape
    pad_h = -gh % ny
    pad_w = -gw % nx
    if pad_h == 0 and pad_w == 0:
        return img, labels0
    pads = ((0, 0), (0, pad_h), (0, pad_w))
    img = jnp.pad(img, pads, constant_values=NEVER_FILL)
    labels0 = jnp.pad(labels0, pads, constant_values=UNCOLOURED)
    return img, labels0


def tiled_transform(
    img,
    labels0,
    mesh: Mesh,
    *,
    n_labels: int,
    max_water_level: int,
    merging: bool = False,
    halo: int | None = None,
    collect: str = "none",
    axis_y: str = "y",
    axis_x: str = "x",
    axis_batch: str | None = None,
    backend: str = "auto",
    with_stats: bool = False,
):
    """Run the full watershed tiled over ``mesh``.

    ``img``/``labels0``: (H, W) or (B, H, W) with any H and W — non-divisible
    shapes (e.g. the (H+2, W+2) edge-corrected domain on an even mesh) are
    embedded in a mesh-divisible plane with inert padding (``_mesh_pad``) and
    cropped on exit.  With ``axis_batch`` set, the leading batch axis is
    additionally sharded over that mesh axis (dp x spatial).  Returns final
    labels, plus (levels, B, K+1) lake sizes when ``collect='sizes'`` or
    (levels, B, H, W) snapshots when ``collect='history'``.

    ``backend``: 'relax' | 'sweep' | 'auto'.  'auto' uses the tiled
    relaxation engine wherever it applies (segmenting always; merging final
    labels) and the per-level sweep loop for merging statistics.  Both are
    bit-identical to the single-device drivers.

    ``halo=None`` runs ``_DEFAULT_HALO`` local sweeps per exchange, clamped
    to the local tile extents.  Pass an explicit k to trade strip width
    against round count.

    ``with_stats=True`` (relax + collect='none' only) additionally returns
    the replicated int32 count of exchange rounds the relax engine ran.
    """
    img = jnp.asarray(img)
    labels0 = jnp.asarray(labels0, dtype=jnp.int32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
        labels0 = labels0[None]
    _, gh, gw = img.shape
    ny = mesh.shape[axis_y]
    nx = mesh.shape[axis_x]
    img, labels0 = _mesh_pad(img, labels0, ny, nx)
    _, gh2, gw2 = img.shape
    h_local, w_local = gh2 // ny, gw2 // nx

    if halo is None:
        halo = max(1, min(_DEFAULT_HALO, h_local, w_local))

    if backend == "auto":
        backend = _auto_backend(merging, collect)
    if backend not in ("relax", "sweep"):
        raise ValueError(
            f"unknown tiled backend {backend!r}; accepted: 'auto', 'relax', "
            "'sweep'"
        )
    if with_stats and (backend != "relax" or collect != "none"):
        raise ValueError("with_stats=True needs backend='relax' and collect='none'")

    extra = {}
    if backend == "relax":
        driver = _local_relax_driver
        if with_stats:
            extra["with_stats"] = True
    else:
        driver = _local_level_driver

    spec = P(axis_batch, axis_y, axis_x)
    static = dict(
        # ORIGINAL shape, not the padded one: every driver derives its
        # interior / paint / merge masks and the sizes column-0 complement
        # from it (global_interior_mask), which is what keeps the padding
        # inert (see _mesh_pad).
        global_shape=(gh, gw),
        n_labels=n_labels,
        max_water_level=max_water_level,
        merging=merging,
        halo=halo,
        collect=collect,
        axis_y=axis_y,
        axis_x=axis_x,
        control_axes=tuple(mesh.axis_names),
        **extra,
    )
    if collect == "none":
        out_specs = (spec, P()) if with_stats else spec
    elif collect == "sizes":
        out_specs = (spec, P(None, axis_batch, None))
    elif collect == "claims":
        if merging or backend != "relax":
            raise ValueError(
                "collect='claims' is the relax engine's raw (labels, claim "
                "levels) output; use merging=False with the relax backend"
            )
        out_specs = (spec, spec)
    else:  # history
        out_specs = (spec, P(None, axis_batch, axis_y, axis_x))

    fn = _sharded_program(
        mesh, driver, spec, out_specs, tuple(sorted(static.items()))
    )
    out = fn(img, labels0)
    if collect == "none":
        if with_stats:
            out, rounds = out
            out = out[..., :gh, :gw]
            return (out[0] if squeeze else out), rounds
        out = out[..., :gh, :gw]
        return out[0] if squeeze else out
    labels, stats = out[0][..., :gh, :gw], out[1]
    if collect in ("history", "claims"):
        stats = stats[..., :gh, :gw]
    if squeeze:
        if collect == "claims":
            return labels[0], stats[0]
        return labels[0], stats[:, 0]
    return labels, stats


@lru_cache(maxsize=64)
def _sharded_program(mesh, driver, spec, out_specs, static):
    """The jitted shard_map program for one mesh and static configuration,
    built once: a fresh jax.jit per call would retrace and recompile the
    whole tiled transform on every call."""
    return jax.jit(
        jax.shard_map(
            partial(driver, **dict(static)),
            mesh=mesh,
            in_specs=(spec, spec),
            out_specs=out_specs,
            check_vma=False,
        )
    )


def _auto_backend(merging: bool, collect: str) -> str:
    """backend='auto' resolution: the tiled relax engine wherever it applies,
    the per-level sweep for merging statistics (per-level unions)."""
    if merging and collect != "none":
        return "sweep"
    return "relax"


def _local_level_step(
    img_tile,
    lab_tile,
    lvl,
    *,
    global_shape,
    n_labels,
    merging,
    halo,
    axis_y,
    axis_x,
    control_axes,
):
    """ONE water level on a mesh tile (runs under shard_map): flood to the
    global fixed point, then the merge phase (merging variant).  Shapes
    (B, h, w); returns (labels, rounds) where ``rounds`` counts the
    halo-exchange iterations (the mesh path's analogue of the reference's
    per-colouring-iteration progress ticks, src/lib.rs:1395-1398)."""
    axes = (axis_y, axis_x)
    img_tile = img_tile.astype(jnp.int32)
    h, w = lab_tile.shape[-2:]
    img_p = exchange_halo(img_tile, halo, axis_y, axis_x, off_grid_fill=NEVER_FILL)
    paint_mask = global_interior_mask((h, w), global_shape, halo, axis_y, axis_x)

    lab, rounds = _tiled_flood_fixed_point(
        img_p, lab_tile, lvl, halo=halo, paint_mask=paint_mask,
        axis_y=axis_y, axis_x=axis_x, control_axes=control_axes,
    )
    if merging:
        merge_mask = global_interior_mask((h, w), global_shape, 1, axis_y, axis_x)
        lab = _merge_fixed_point(
            lab,
            n_labels=n_labels,
            merge_mask=merge_mask,
            axes=axes,
            control_axes=control_axes,
        )
    return lab, rounds


class MeshLevelStepper:
    """Host-stepped per-level driver over a mesh: the observability loop
    (hooks / plots / progress / debug / checkpoints) calls ``step`` once per
    water level, exactly like the single-device ``level_step``, but with the
    level's flood fixed point + merge phase running tiled over the mesh
    (halo exchange, psum convergence, replicated merge tables).
    Mirrors the reference, whose hooks fire under its parallel runtime
    (src/lib.rs:1509-1518).

    ``prepare`` embeds the (H, W) domain in a mesh-divisible padded plane
    (``_mesh_pad`` — inert padding, original-shape interior rule); ``crop``
    restores the (H, W) view for hooks/plots/checkpoints.  The padded label
    state stays on device between levels.
    """

    def __init__(
        self,
        mesh: Mesh,
        *,
        n_labels: int,
        merging: bool,
        halo: int = 4,
        axis_y: str = "y",
        axis_x: str = "x",
    ):
        self.mesh = mesh
        self.axis_y, self.axis_x = axis_y, axis_x
        self.ny = mesh.shape[axis_y]
        self.nx = mesh.shape[axis_x]
        self._shape = None
        self._step = None  # built in prepare (needs the domain shape)
        self._kw = dict(
            n_labels=n_labels,
            merging=merging,
            halo=halo,
            axis_y=axis_y,
            axis_x=axis_x,
            control_axes=tuple(mesh.axis_names),
        )

    def prepare(self, img, labels0):
        """(padded device img, padded device labels); records the crop.

        Re-preparing with the SAME domain shape (e.g. a checkpoint resume)
        reuses the compiled step — a fresh jax.jit would recompile an
        identical program."""
        from .._compat import cache_resilient

        img = jnp.asarray(img)[None]
        labels0 = jnp.asarray(labels0, dtype=jnp.int32)[None]
        shape = img.shape[1:]
        img2, lab2 = _mesh_pad(img, labels0, self.ny, self.nx)
        if self._step is None or shape != self._shape:
            self._shape = shape
            spec = P(None, self.axis_y, self.axis_x)
            self._step = cache_resilient(
                jax.jit(
                    jax.shard_map(
                        partial(
                            _local_level_step, global_shape=shape, **self._kw
                        ),
                        mesh=self.mesh,
                        in_specs=(spec, spec, P()),
                        out_specs=(spec, P()),
                        check_vma=False,
                    )
                )
            )
        return img2, lab2

    def step(self, img, labels, lvl):
        """One water level; returns (padded labels, iteration count)."""
        labels, rounds = self._step(img, labels, jnp.int32(lvl))
        return labels, rounds

    def crop(self, labels) -> np.ndarray:
        gh, gw = self._shape
        return np.asarray(labels)[0, :gh, :gw]


def make_mesh(n_devices: int | None = None, axis_names=("y", "x")) -> Mesh:
    """A near-square 2-D mesh over the available devices."""
    devs = np.asarray(jax.devices()[: n_devices or len(jax.devices())])
    n = devs.size
    ny = int(np.floor(np.sqrt(n)))
    while n % ny:
        ny -= 1
    return Mesh(devs.reshape(ny, n // ny), axis_names)
