"""Shared 2-D stencil helpers for the watershed kernels.

The reference crate iterates 3x3 ``ndarray`` windows with rayon
(/root/reference/src/lib.rs:196-257, :393-445, :1178-1197).  On the device the
same neighbourhoods are expressed as whole-array shifted reads so XLA fuses
each sweep into a single elementwise pass; window *centres* are restricted to the interior
(the 1-px border is never a centre) exactly like 3x3 windows are.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp


def shift4(a: jnp.ndarray, fill) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The four 4-connected neighbour reads of every pixel.

    Returns arrays ``(up, down, left, right)`` where ``up[y, x] = a[y-1, x]``
    etc.; out-of-bounds reads yield ``fill``.
    """
    h, w = a.shape[-2], a.shape[-1]
    p = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)], constant_values=fill)
    up = p[..., 0:h, 1 : w + 1]
    down = p[..., 2 : h + 2, 1 : w + 1]
    left = p[..., 1 : h + 1, 0:w]
    right = p[..., 1 : h + 1, 2 : w + 2]
    return up, down, left, right


def roll4(a: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """4-neighbour reads with WRAP-AROUND instead of padding (no copies).

    Out-of-bounds reads see the opposite edge, which is only ever observed by
    pixels on the array border.  Callers must therefore mask the border out of
    the candidate set (the watershed kernels already never paint/seed/merge
    border *centres*, matching the reference's 3x3-window semantics), making
    the wrap unobservable: border labels are invariant, so wrapped values read
    by interior ring-1 pixels are the true border values.
    """
    up = jnp.roll(a, 1, axis=-2)
    down = jnp.roll(a, -1, axis=-2)
    left = jnp.roll(a, 1, axis=-1)
    right = jnp.roll(a, -1, axis=-1)
    return up, down, left, right


def roll8(a: jnp.ndarray):
    """8-neighbour wrap-around reads (same masking contract as roll4)."""
    out = []
    for dy in (-1, 0, 1):
        ay = jnp.roll(a, -dy, axis=-2) if dy else a
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out.append(jnp.roll(ay, -dx, axis=-1) if dx else ay)
    return tuple(out)


def shift8(a: jnp.ndarray, fill):
    """All eight 8-connected neighbour reads (out-of-bounds -> ``fill``)."""
    h, w = a.shape[-2], a.shape[-1]
    p = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 1), (1, 1)], constant_values=fill)
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out.append(p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _interior_mask_np(shape: tuple[int, int]):
    import numpy as np

    m = np.zeros(shape, dtype=bool)
    if shape[0] > 2 and shape[1] > 2:
        m[1:-1, 1:-1] = True
    return m


def interior_mask(shape: tuple[int, int]) -> jnp.ndarray:
    """Boolean mask that is True except on the 1-px border.

    Replicates the reference's window-centre restriction: pixels on the border
    are never candidates for flooding, merging, or seeding
    (/root/reference/src/lib.rs:220-233 — window index + (1,1)).
    """
    return jnp.asarray(_interior_mask_np(tuple(shape)))
