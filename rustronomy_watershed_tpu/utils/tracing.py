"""Profiler tracing helpers.

Device-side analogue of the reference's Instant::now() instrumentation points
(SURVEY.md §5 'Tracing / profiling'): wraps ``jax.profiler`` so a transform
can be traced into TensorBoard/XPlane format, plus named step annotations for
the host-stepped level loop.

Capture is verified, not assumed: ``trace`` warns LOUDLY (RuntimeWarning)
when the profiler fails to start or when no XPlane artifact materialises in
the log dir — a silently-empty trace on an unsupported backend is worse
than no trace.  ``trace_artifacts(log_dir)`` lists the
captured ``*.xplane.pb`` files so callers (and tests) can assert on them.
"""

from __future__ import annotations

import contextlib
import pathlib
import warnings


def trace_artifacts(log_dir) -> list:
    """The XPlane protobuf files a successful capture leaves under
    ``log_dir`` (jax.profiler layout: plugins/profile/<run>/<host>.xplane.pb).
    Empty list == nothing was captured."""
    return sorted(pathlib.Path(str(log_dir)).glob("**/*.xplane.pb"))


@contextlib.contextmanager
def trace(log_dir: str, check: bool = True):
    """Capture a jax.profiler trace of the enclosed block into ``log_dir``.

    Never raises out of profiler plumbing (the enclosed computation runs
    regardless), but any capture failure is a loud RuntimeWarning:
    * the profiler refusing to start (unsupported platform), or
    * ``check=True`` (default) finding no new ``*.xplane.pb`` artifact at
      stop time — e.g. a backend that accepts the session but exports
      nothing.
    """
    import jax

    before = set(trace_artifacts(log_dir)) if check else set()
    started = False
    try:
        jax.profiler.start_trace(str(log_dir))
        started = True
    except Exception as e:  # noqa: BLE001 — reported, not swallowed
        warnings.warn(
            f"jax.profiler.start_trace failed on this platform ({e!r}); "
            "the transform will run UNTRACED",
            RuntimeWarning,
            stacklevel=3,
        )
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"jax.profiler.stop_trace failed ({e!r}); the trace in "
                    f"{log_dir} may be incomplete",
                    RuntimeWarning,
                    stacklevel=3,
                )
            else:
                if check and not (
                    set(trace_artifacts(log_dir)) - before
                ):
                    warnings.warn(
                        "profiler session completed but produced no XPlane "
                        f"artifact under {log_dir} — this backend exports "
                        "nothing; treat the trace as absent",
                        RuntimeWarning,
                        stacklevel=3,
                    )


def step_annotation(name: str):
    """Named annotation for one water level (shows up in trace viewers)."""
    import jax

    return jax.profiler.StepTraceAnnotation(name)
