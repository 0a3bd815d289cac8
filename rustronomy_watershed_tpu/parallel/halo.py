"""Halo exchange over the device mesh for tiled stencil sweeps.

The reference is single-address-space (rayon threads); this rebuild tiles
large mosaics over a 2-D ``jax.sharding.Mesh`` and exchanges k-px halos with
``lax.ppermute`` (neighbour shifts between devices) each flood block
(SURVEY.md §2 "Parallelism & communication").

Because one Jacobi sweep moves information exactly one 4-connected pixel, a
k-px halo lets each device run k *local* sweeps per exchange with results
bit-identical to k global sweeps — amortising the exchange latency
(SURVEY.md §7 "Hard parts").  Corners ride along by exchanging rows first, then columns of
the row-extended tile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_from_prev(x, axis_name: str, n: int):
    """Each device receives ``x`` from its predecessor along ``axis_name``
    (device 0 receives zeros)."""
    if n == 1:
        return jnp.zeros_like(x)
    return lax.ppermute(x, axis_name, perm=[(i, i + 1) for i in range(n - 1)])


def _shift_from_next(x, axis_name: str, n: int):
    """Each device receives ``x`` from its successor (device n-1 gets zeros)."""
    if n == 1:
        return jnp.zeros_like(x)
    return lax.ppermute(x, axis_name, perm=[(i + 1, i) for i in range(n - 1)])


def exchange_halo(
    tile: jnp.ndarray,
    k: int,
    axis_y: str,
    axis_x: str,
    off_grid_fill=0,
):
    """Pad a local (h, w) tile to (h + 2k, w + 2k) with neighbour data.

    Off-grid halo cells (beyond the global image) are filled with
    ``off_grid_fill`` (0/UNCOLOURED for labels, NEVER_FILL for images so ghost
    cells can never flood).
    """
    ny = lax.axis_size(axis_y)
    nx = lax.axis_size(axis_x)
    iy = lax.axis_index(axis_y)
    ix = lax.axis_index(axis_x)
    fill = jnp.asarray(off_grid_fill, dtype=tile.dtype)

    # Rows first: top halo comes from the previous row-device's bottom strip.
    from_up = _shift_from_prev(tile[..., -k:, :], axis_y, ny)
    from_down = _shift_from_next(tile[..., :k, :], axis_y, ny)
    if off_grid_fill != 0:
        from_up = jnp.where(iy > 0, from_up, fill)
        from_down = jnp.where(iy < ny - 1, from_down, fill)
    ext = jnp.concatenate([from_up, tile, from_down], axis=-2)

    # Columns second, on the row-extended tile: corners come along.
    from_left = _shift_from_prev(ext[..., :, -k:], axis_x, nx)
    from_right = _shift_from_next(ext[..., :, :k], axis_x, nx)
    if off_grid_fill != 0:
        from_left = jnp.where(ix > 0, from_left, fill)
        from_right = jnp.where(ix < nx - 1, from_right, fill)
    return jnp.concatenate([from_left, ext, from_right], axis=-1)


def global_interior_mask(
    local_shape: tuple[int, int],
    global_shape: tuple[int, int],
    halo: int,
    axis_y: str,
    axis_x: str,
) -> jnp.ndarray:
    """Interior mask (global 1-px border excluded) in halo-padded local
    coordinates: padded cell (ly, lx) maps to global
    (iy * h + ly - halo, ix * w + lx - halo)."""
    h, w = local_shape
    gh, gw = global_shape
    iy = lax.axis_index(axis_y)
    ix = lax.axis_index(axis_x)
    gy = (
        jax.lax.broadcasted_iota(jnp.int32, (h + 2 * halo, w + 2 * halo), 0)
        + iy * h
        - halo
    )
    gx = (
        jax.lax.broadcasted_iota(jnp.int32, (h + 2 * halo, w + 2 * halo), 1)
        + ix * w
        - halo
    )
    return (gy >= 1) & (gy <= gh - 2) & (gx >= 1) & (gx <= gw - 2)
