"""Workaround for an upstream runtime bug.

jax 0.9.0 (XLA:CPU runtime): after certain sequences of compiles and replays
of one pjit-wrapped function under several static-argument combinations, a
cached executable can be re-invoked with a corrupted argument table and fail
with ``INVALID_ARGUMENT: Execution supplied N buffers but compiled program
expected M buffers``.  The trigger is content-dependent (identical call
structures pass or fail depending on unrelated runtime values), pointing at
memory corruption in the executable cache rather than anything semantic;
``jax.clear_caches()`` followed by a recompile always recovers and the
recomputed results are bit-identical (verified against pre-corruption
checksums).  Wrap public jitted entry points so a corrupted cache costs one
recompile instead of a crash.
"""

from __future__ import annotations

import functools
import warnings

import jax

_MARKER = "buffers but compiled program expected"


def cache_resilient(jitted):
    """Retry ``jitted`` once after clearing jax caches on executable-cache
    corruption (see module docstring).  Transparent otherwise."""

    @functools.wraps(jitted)
    def call(*args, **kwargs):
        try:
            return jitted(*args, **kwargs)
        except ValueError as e:
            # jaxlib surfaces XLA INVALID_ARGUMENT as ValueError
            if _MARKER not in str(e):
                raise
            warnings.warn(
                "jax executable-cache corruption detected "
                f"({type(e).__name__}); clearing caches and retrying once",
                RuntimeWarning,
                stacklevel=2,
            )
            jax.clear_caches()
            return jitted(*args, **kwargs)

    return call
