"""Per-level merged statistics for the merging variant, from ONE relax pass.

The reference's primary merging entry point is ``transform_to_list``
(/root/reference/src/lib.rs:1551-1561): per water level, the lake-size
histogram of the *merged* label image.  The level-sweep backends replay the
whole flood per level; this module instead derives the curves from the
relax engine's (label, claim_level) output:

* two regions with (segmenting) labels a != b first merge at water level
  ``w = max(L(p), L(q))`` minimised over adjacent claimed pixel pairs
  (p, q) with labels (a, b) — at that level both pixels are first coloured
  simultaneously and the reference's find_merge detects the pair
  (src/lib.rs:1446-1470).  Pairs of two border pixels are never detected
  (3x3 interior-centre windows), so horizontal edges in rows {0, H-1} and
  vertical edges in columns {0, W-1} are excluded;
* the per-level merged labelling is then the union-find over edges with
  activation <= level (min-label representative, SURVEY.md Q9), and the
  merged histogram at each level redistributes the *segmenting* per-level
  counts onto representatives.

The device does the plane-scale work (relax + per-level segmenting counts +
edge extraction + dedup by sort); the union-find runs on the host over the
deduplicated label-graph edges (O(K) entries — a planar adjacency graph),
which is where ``transform_to_list``'s Python-list result lives anyway.
Bit-parity with the level-sweep merging driver is pinned by tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .._compat import cache_resilient


def merge_edges_impl(seg_labels, claim_levels, *, max_water_level: int):
    """Deduplicated label-adjacency edges with minimal activation levels.

    Returns (lo, hi, w, n): int32 arrays sorted by (lo, hi) with unique
    (lo, hi) pairs in the first ``n`` slots (w = minimal activation level of
    that pair).  Fetch ``n`` to the host and slice ``[:n]``.
    """
    s = jnp.asarray(seg_labels, dtype=jnp.int32)
    L = jnp.asarray(claim_levels, dtype=jnp.int32)
    h, w_ = s.shape
    big = jnp.int32(2**30)

    def direction(a, b, wa, wb, blocked):
        valid = (a > 0) & (b > 0) & (a != b) & ~blocked
        act = jnp.maximum(wa, wb)
        valid = valid & (act <= max_water_level)
        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)
        lo = jnp.where(valid, lo, big)
        hi = jnp.where(valid, hi, big)
        act = jnp.where(valid, act, big)
        return lo.reshape(-1), hi.reshape(-1), act.reshape(-1)

    # Horizontal edges (p, p+x̂): blocked when the pair lies in row 0 / H-1.
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w_ - 1), 0)
    lo1, hi1, w1 = direction(
        s[:, :-1], s[:, 1:], L[:, :-1], L[:, 1:], (rows == 0) | (rows == h - 1)
    )
    # Vertical edges (p, p+ŷ): blocked when the pair lies in column 0 / W-1.
    cols = jax.lax.broadcasted_iota(jnp.int32, (h - 1, w_), 1)
    lo2, hi2, w2 = direction(
        s[:-1, :], s[1:, :], L[:-1, :], L[1:, :], (cols == 0) | (cols == w_ - 1)
    )

    lo = jnp.concatenate([lo1, lo2])
    hi = jnp.concatenate([hi1, hi2])
    act = jnp.concatenate([w1, w2])
    # Sort by (lo, hi, act): the first slot of each (lo, hi) run carries the
    # minimal activation level.
    lo, hi, act = jax.lax.sort((lo, hi, act), num_keys=3)
    first = jnp.concatenate(
        [
            jnp.ones((1,), jnp.bool_),
            (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1]),
        ]
    )
    first = first & (lo != big)
    # Stable-compact unique edges to the front.
    rank = jnp.where(first, jnp.int32(0), jnp.int32(1))
    _, lo, hi, act = jax.lax.sort((rank, lo, hi, act), num_keys=1, is_stable=True)
    n = jnp.sum(first.astype(jnp.int32))
    return lo, hi, act, n


# Public jitted entry (impl stays unjitted so jitted callers can inline it).
merge_edges = cache_resilient(
    partial(jax.jit, static_argnames=("max_water_level",))(merge_edges_impl)
)


def _clip_levels_u8_impl(L, *, max_water_level: int):
    """Claim levels clipped to the level range as uint8 (lossless: levels
    <= 255 and the clip reserves max+1 for never-claimed pixels)."""
    return jnp.clip(L, 0, max_water_level + 1).astype(jnp.uint8)


clip_levels_u8 = cache_resilient(
    partial(jax.jit, static_argnames=("max_water_level",))(_clip_levels_u8_impl)
)


@cache_resilient
@partial(
    jax.jit,
    static_argnames=("n_labels", "max_water_level", "with_final", "with_edges"),
)
def _device_curves(
    img, labels0, *, n_labels, max_water_level, with_final=True, with_edges=True,
):
    """One device program: relax + edges + final labels + compact planes.

    ``with_edges=False`` serves the SEGMENTING curves (labels never merge,
    so the per-level histograms are pure cumulative claim counts — no
    adjacency edges needed): the merge-edge extraction is skipped and
    zero-length edge arrays come back.

    Deliberately does NOT build the (levels, K+1) cumulative count table on
    device: at 1024² that table is ~134 MB, while the (H, W) label plane
    (uint16 wire format when K+1 < 2^16, else int32) and claim levels
    (clipped to the level range, uint8) are ~3 MB at 1024².  The host
    rebuilds the exact same table with one bincount + cumsum
    (host_cumulative_counts).
    """
    from .priority import relax_transform
    from .scan_merge import component_min_labels

    labels, claim_levels = relax_transform(
        img, labels0, max_water_level=max_water_level
    )
    if with_edges:
        lo, hi, act, n = merge_edges_impl(
            labels, claim_levels, max_water_level=max_water_level
        )
    else:
        lo = jnp.zeros((0,), jnp.int32)
        hi = jnp.zeros((0,), jnp.int32)
        act = jnp.zeros((0,), jnp.int32)
        n = jnp.int32(0)
    # The final merged plane is OPTIONAL: transform_to_list only returns the
    # curves, and the component-min scan rounds would otherwise run (and
    # write a plane) for a result the caller discards.
    final = component_min_labels(labels) if with_final else labels
    # levels <= 255 and the clip reserves `levels` for never-claimed pixels,
    # so uint8 is lossless (max_water_level <= 254 by construction).
    lv8 = jnp.clip(claim_levels, 0, max_water_level + 1).astype(jnp.uint8)
    # Wire format: label buckets < 2^16 ship the label plane as uint16 +
    # the uint8 level plane (3 B/px); buckets < 2^24 PACK label and level
    # into one uint32 plane (4 B/px vs 5 for int32+uint8 — the lv8 fetch
    # is skipped entirely, unpack_wire splits on arrival); only buckets
    # >= 2^24 ship int32+uint8.  The host tail re-widens on arrival
    # (native_merged_curve / host_cumulative_counts coerce dtypes anyway).
    if n_labels + 1 < 2**16:
        wire = labels.astype(jnp.uint16)
    elif n_labels + 1 < 2**24:
        wire = labels.astype(jnp.uint32) | (lv8.astype(jnp.uint32) << 24)
    else:
        wire = labels
    return final, wire, lv8, lo, hi, act, n


def unpack_wire(wire_np: np.ndarray, lv8_np=None):
    """(int32 labels, uint8 claim levels) from the device wire format.

    uint32 wire = the packed tier (label in bits 0-23, clipped claim level
    in bits 24-31 — see _device_curves); other dtypes are the label plane
    itself, with ``lv8_np`` carrying the levels."""
    w = np.asarray(wire_np)
    if w.dtype == np.uint32:
        return (
            (w & np.uint32(0xFFFFFF)).astype(np.int32),
            (w >> np.uint32(24)).astype(np.uint8),
        )
    return w, np.asarray(lv8_np)


def host_cumulative_counts(
    labels: np.ndarray, lv8: np.ndarray, n_labels: int, max_water_level: int
) -> np.ndarray:
    """Host twin of ops.priority.sizes_from_levels: (levels, K+1) cumulative
    segmenting counts from the two compact planes (exact integer arithmetic;
    bit-identical values to the device table)."""
    levels = max_water_level + 1
    k1 = n_labels + 1
    # int32 flat index is ~4x faster to form than int64; fall back to int64
    # when 256 * (K+1) would overflow (label buckets >= 2^23).
    dt = np.int32 if (levels + 1) * k1 < 2**31 else np.int64
    lv = lv8.astype(dt).reshape(-1)
    lab = np.asarray(labels, dtype=dt).reshape(-1)
    counts = np.bincount(lv * dt(k1) + lab, minlength=(levels + 1) * k1)
    counts = counts[: (levels + 1) * k1].reshape(levels + 1, k1)
    # NOT np.cumsum(axis=0): the strided-axis cumsum walks column-major over
    # a (255, 131k) array and measures ~50x slower than this row loop.
    cum = np.empty((levels, k1), dtype=np.int64)
    running = np.zeros(k1, dtype=np.int64)
    for lvl in range(levels):
        running += counts[lvl]
        cum[lvl] = running
    total = lab.size
    cum[:, 0] = total - cum[:, 1:].sum(axis=1)
    return cum


def merged_curve_host(
    labels_np, lv8_np, n_labels: int, max_water_level: int, lo, hi, act,
    out_width: int | None = None,
) -> np.ndarray:
    """(levels, out_width or K+1) merged sizes from the compact planes: the
    native C++ single pass (parity/oracle.cc merged_curve_oracle —
    counting-sorted level streaming + incremental per-root sums, ~10x the
    NumPy tail) when the toolchain is available, else the bit-identical
    NumPy pair below.

    ``out_width`` = the public counts_length: rows come back already at
    result width (no second expand/truncate pass; columns beyond K+1 stay
    calloc-lazy zeros; representatives >= out_width are truncated exactly
    like the expand path did)."""
    try:
        from ..parity.native import native_merged_curve

        return native_merged_curve(
            labels_np, lv8_np, n_labels, max_water_level, lo, hi, act,
            out_width=out_width,
        )
    except Exception:
        # No g++ (or a broken build cache): the NumPy tail is bit-identical,
        # just slower.
        cum = host_cumulative_counts(
            np.asarray(labels_np), np.asarray(lv8_np), n_labels, max_water_level
        )
        sizes = merged_sizes_host(
            cum, np.asarray(lo), np.asarray(hi), np.asarray(act)
        )
        if out_width is None or out_width == sizes.shape[1]:
            return sizes
        out = np.zeros((sizes.shape[0], out_width), dtype=sizes.dtype)
        k = min(sizes.shape[1], out_width)
        out[:, :k] = sizes[:, :k]
        return out


def _level_edge_buckets(levels: int, lo, hi, act):
    """Edges sorted by activation level + per-level start offsets."""
    order = np.argsort(act, kind="stable")
    lo, hi, act = lo[order], hi[order], act[order]
    starts = np.searchsorted(act, np.arange(levels + 1))
    return lo, hi, starts


def _union_level(parent: np.ndarray, el: np.ndarray, eh: np.ndarray):
    """Union one level's edge subgraph into ``parent`` (min-label reps).

    Works on a MINI graph over just the roots the edges touch (parent is
    fully compressed between levels, so parent[e*] are roots):
    min-propagate representatives over the per-level edges until stable,
    then write the touched roots once and re-compress with a single
    full-table gather (compressed non-roots point AT old roots, which now
    point at final reps — one hop suffices).  This keeps the O(K) work at
    one gather per level instead of repeated full-table pointer-jump
    rounds and np.minimum.at scatters.  Returns the compressed parent.
    """
    ra, rb = parent[el], parent[eh]
    nodes, inv = np.unique(np.concatenate([ra, rb]), return_inverse=True)
    ia, ib = inv[: el.size], inv[el.size :]
    rep = np.arange(nodes.size, dtype=np.int64)
    while True:
        m = np.minimum(rep[ia], rep[ib])
        np.minimum.at(rep, ia, m)
        np.minimum.at(rep, ib, m)
        r2 = rep[rep]
        while not np.array_equal(r2, rep):
            rep = r2
            r2 = rep[rep]
        rep = r2
        if (rep[ia] == rep[ib]).all():
            break
    parent[nodes] = nodes[rep]
    return parent[parent]


def merged_sizes_host(
    cum: np.ndarray, lo: np.ndarray, hi: np.ndarray, act: np.ndarray
) -> np.ndarray:
    """(levels, K+1) merged per-level lake sizes from segmenting counts.

    ``cum`` is ops.priority.sizes_from_levels output (cumulative segmenting
    counts; column 0 = uncoloured).  Kruskal-style: per level, union the
    edges activating at that level (min-label representative), then
    redistribute that level's counts onto representatives.
    """
    levels, k1 = cum.shape
    parent = np.arange(k1, dtype=np.int64)
    lo, hi, starts = _level_edge_buckets(levels, lo, hi, act)

    out = np.zeros_like(cum)
    for lvl in range(levels):
        el, eh = lo[starts[lvl] : starts[lvl + 1]], hi[starts[lvl] : starts[lvl + 1]]
        if el.size:
            parent = _union_level(parent, el, eh)
        out[lvl] = np.bincount(
            parent, weights=cum[lvl], minlength=k1
        ).astype(cum.dtype)
    return out


def relax_merging_sizes(
    img,
    labels0,
    *,
    n_labels: int,
    max_water_level: int,
    with_final: bool = True,
    out_width: int | None = None,
    merging: bool = True,
):
    """``transform_to_list`` data via the relax engine (BOTH variants).

    Returns (final merged labels, (levels, K+1) merged per-level sizes) —
    bit-identical to run_levels(..., merging=True, collect='sizes') on the
    level sweep.  ``with_final=False`` skips the merged-plane computation
    entirely (first element is then the UNMERGED segmenting plane) — the
    public transform_to_list discards it, so its scan rounds are pure waste
    there.

    ``merging=False`` computes the SEGMENTING curves (the reference's
    segmenting ``transform_to_list``, src/lib.rs:1551-1561 with the
    non-merging watershed): labels never change once claimed, so the
    per-level histograms are exactly the cumulative claim counts the host
    tail already builds — the edge extraction and union steps degenerate
    away (zero edges), and the same one-relax-pass + compact-planes wire
    replaces the per-level device table (a (255, K+1) int32 table is
    ~134 MB at 1024²; the planes are ~4 MB).
    """
    img = jnp.asarray(img)
    labels0 = jnp.asarray(labels0, dtype=jnp.int32)
    final, labels, lv8, lo, hi, act, n = _device_curves(
        img,
        labels0,
        n_labels=n_labels,
        max_water_level=max_water_level,
        # component-min is the MERGED plane — meaningless for segmenting.
        with_final=with_final and merging,
        with_edges=merging,
    )
    labels_np, lv8_np, lo_np, hi_np, act_np = _fetch_curve_planes(
        labels, lv8, lo, hi, act, n
    )
    sizes = merged_curve_host(
        labels_np, lv8_np, n_labels, max_water_level, lo_np, hi_np, act_np,
        out_width=out_width,
    )
    return final, sizes


def _fetch_curve_planes(labels, lv8, lo, hi, act, n):
    """Download the compact curve planes + sliced edges in ONE batched
    device_get (the edge count rides a first small fetch because it gates
    the edge slice)."""
    n = int(jax.device_get(n))
    edges = (lo[:n], hi[:n], act[:n].astype(jnp.uint8))
    if labels.dtype == jnp.uint32:
        # Packed wire tier: the level plane rides the label plane's top byte.
        wire_np, lo_np, hi_np, act_np = jax.device_get((labels,) + edges)
        labels_np, lv8_np = unpack_wire(wire_np)
    else:
        labels_np, lv8_np, lo_np, hi_np, act_np = jax.device_get(
            (labels, lv8) + edges
        )
    return labels_np, lv8_np, lo_np, hi_np, act_np


def iter_history_from_planes(
    labels_np,
    lv8_np,
    max_water_level: int,
    lo=None,
    hi=None,
    act=None,
    *,
    n_labels: int | None = None,
):
    """Yield (level, int32 label snapshot) rebuilt from the compact planes.

    The per-level snapshot the sweep driver records is exactly
    ``where(claim <= lvl, rep_lvl[label], 0)``: segmenting labels never
    change once claimed, and the merging variant's level-``lvl`` labelling
    is the min-label union of edges activating at <= lvl applied to the
    segmenting plane (the same Kruskal the curve tail runs —
    src/lib.rs:1446-1470 semantics).  Pass ``lo/hi/act`` for merging;
    omit for segmenting (no unions — the gather is skipped entirely).

    This replaces a (levels, H, W) on-device snapshot stack whose download
    is ~levels x the plane size (1 GB at 1024²/255 levels); the planes are
    ~4 MB and the rebuild is host-local numpy.  A generator
    so per-level observers (hooks, plots) hold ONE snapshot at a time;
    transform_history materialises the list (the API's contract and the
    reference's own xmax_water_level memory factor, src/lib.rs:1263-1268).
    """
    labels_np = np.asarray(labels_np).astype(np.int32, copy=False)
    lv8_np = np.asarray(lv8_np)
    levels = max_water_level + 1
    if lo is None:
        for lvl in range(levels):
            yield lvl, np.where(lv8_np <= lvl, labels_np, np.int32(0))
        return
    k1 = (int(n_labels) + 1) if n_labels is not None else int(labels_np.max()) + 1
    parent = np.arange(k1, dtype=np.int64)
    lo, hi, starts = _level_edge_buckets(
        levels, np.asarray(lo), np.asarray(hi), np.asarray(act)
    )
    rep_plane = labels_np  # identity LUT until the first union fires
    for lvl in range(levels):
        el, eh = lo[starts[lvl] : starts[lvl + 1]], hi[starts[lvl] : starts[lvl + 1]]
        if el.size:
            parent = _union_level(parent, el, eh)
            rep_plane = parent[labels_np].astype(np.int32)
        yield lvl, np.where(lv8_np <= lvl, rep_plane, np.int32(0))


def history_from_planes(
    labels_np, lv8_np, max_water_level, lo=None, hi=None, act=None,
    *, n_labels=None,
) -> list:
    """List form of iter_history_from_planes (see its docstring)."""
    return list(
        iter_history_from_planes(
            labels_np, lv8_np, max_water_level, lo, hi, act, n_labels=n_labels
        )
    )


def relax_history(
    img,
    labels0,
    *,
    n_labels: int,
    max_water_level: int,
    merging: bool = True,
    as_iter: bool = False,
):
    """``transform_history`` data via ONE relax pass + host rebuild.

    Returns [(level, snapshot)] — bit-identical to
    run_levels(..., collect='history') but shipping ~4 MB of compact planes
    instead of the (levels, H, W) snapshot stack (and with no device-memory
    ceiling on the stack).  ``as_iter=True`` returns a lazy generator
    instead of the list (one snapshot live at a time — the per-level
    observer replay path)."""
    img = jnp.asarray(img)
    labels0 = jnp.asarray(labels0, dtype=jnp.int32)
    _, labels, lv8, lo, hi, act, n = _device_curves(
        img,
        labels0,
        n_labels=n_labels,
        max_water_level=max_water_level,
        with_final=False,
        with_edges=merging,
    )
    labels_np, lv8_np, lo_np, hi_np, act_np = _fetch_curve_planes(
        labels, lv8, lo, hi, act, n
    )
    make = iter_history_from_planes if as_iter else history_from_planes
    if merging:
        return make(
            labels_np, lv8_np, max_water_level, lo_np, hi_np, act_np,
            n_labels=n_labels,
        )
    return make(labels_np, lv8_np, max_water_level)
