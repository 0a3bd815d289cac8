"""Fast-path checkpoint / resume for the relax engine.

The priority relaxation's carried state is exactly three planes — claim
level ``L``, ring index ``d`` and label (ops/priority.py) — so a long
transform can be snapshotted between chunks of sweeps and an interrupted run
resumed BIT-EXACTLY: the relaxation is a monotone fixed-point iteration with
a unique fixed point, so continuing from any intermediate state reaches the
same final planes.  The reference's closest capability is per-level history
(/root/reference/src/lib.rs:1233-1237); this goes beyond it (SURVEY.md §5
"checkpoint/resume: none").

One device call runs up to ``every`` sweeps (a bounded ``while_loop`` that
stops early at the fixed point); the host saves the planes after each call
and stops once a call reports no change.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .._compat import cache_resilient
from ..constants import UNCOLOURED
from .priority import init_state, relax_sweep

_init = cache_resilient(jax.jit(init_state))


@cache_resilient
@partial(jax.jit, static_argnames=("sweeps",))
def _relax_chunk(v, L, d, lab, *, sweeps):
    """Up to ``sweeps`` relaxation sweeps; returns the planes and whether
    the last sweep changed anything (False = fixed point reached)."""

    def body(s):
        (L, d, lab), _, n = s
        L2, d2, lab2 = relax_sweep(v, (L, d, lab))
        changed = jnp.any((L2 != L) | (d2 != d) | (lab2 != lab))
        return (L2, d2, lab2), changed, n + 1

    (L, d, lab), changed, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < sweeps),
        body,
        ((L, d, lab), jnp.bool_(True), jnp.int32(0)),
    )
    return L, d, lab, changed


@cache_resilient
@partial(jax.jit, static_argnames=("max_water_level", "merging"))
def _finish(L, lab, *, max_water_level, merging):
    labels = jnp.where(L <= max_water_level, lab, UNCOLOURED)
    if merging:
        from .scan_merge import component_min_labels

        labels = component_min_labels(labels)
    return labels


def ckpt_transform(
    img,
    labels0,
    *,
    merging: bool,
    max_water_level: int = 254,
    checkpointer=None,
    _interrupt_after_calls: int | None = None,
):
    """Checkpointed transform on the relax engine.

    Bit-identical to ``run_levels(backend='relax')`` (the fixed point is
    unique; the merging tail is ops.scan_merge.component_min_labels).
    ``checkpointer`` is a utils.checkpoint.TransformCheckpointer (or None
    for an unsaved run in chunks of 16 sweeps); its ``every`` counts relax
    SWEEPS here, not water levels: the chunk length between snapshots.
    ``_interrupt_after_calls`` is the forced-interrupt test hook: raise
    after N chunk calls, mid-transform.
    """
    img = jnp.asarray(img)
    h, w = img.shape
    every = checkpointer.every if checkpointer is not None else 16
    v, (L, d, lab) = _init(img, labels0)

    calls = 0
    resume = checkpointer.latest_planes() if checkpointer is not None else None
    if resume is not None and list(resume["meta"]) == [h, w]:
        L = jnp.asarray(resume["L"])
        d = jnp.asarray(resume["d"])
        lab = jnp.asarray(resume["lab"])
        calls = int(resume["calls"])

    while True:
        L, d, lab, changed = _relax_chunk(v, L, d, lab, sweeps=every)
        calls += 1
        if checkpointer is not None:
            checkpointer.save_planes(calls, L, d, lab, meta=[h, w])
        if _interrupt_after_calls is not None and calls >= _interrupt_after_calls:
            raise RuntimeError(f"forced interrupt after {calls} calls")
        if not bool(changed):
            break

    labels = _finish(L, lab, max_water_level=max_water_level, merging=merging)
    if checkpointer is not None:
        checkpointer.wait()
    return labels
