"""ctypes binding for the native C++ oracle (builds on first use).

The reference crate's native-performance story is rayon + jemalloc inside
Rust; this framework's host-side native component is a small C++ engine with
the exact reference semantics (pinned min-label tie-break), used to
cross-check the device engines at scale and as a CPU fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "oracle.cc")
_LIB = None


def _build() -> str:
    # NOT named after the package: a directory called
    # "rustronomy_watershed_tpu" under /tmp shadows the real package as a
    # namespace package for any script run from /tmp (bitten in round 4).
    cache_dir = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.join(tempfile.gettempdir())),
        "rwt-native-oracle",
    )
    os.makedirs(cache_dir, exist_ok=True)
    src_mtime = int(os.path.getmtime(_SRC))
    so_path = os.path.join(cache_dir, f"oracle_{src_mtime}.so")
    if not os.path.exists(so_path):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", so_path],
            check=True,
            capture_output=True,
        )
    return so_path


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        lib.watershed_oracle.restype = ctypes.c_int
        lib.watershed_oracle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.local_extrema_oracle.restype = ctypes.c_int
        lib.local_extrema_oracle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.merged_curve_oracle.restype = ctypes.c_int
        lib.merged_curve_oracle.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _LIB = lib
    return _LIB


def native_transform(
    img,
    seeds,
    max_water_level: int = 254,
    merging: bool = False,
    edge_correction: bool = False,
    with_sizes: bool = False,
):
    """Run the native oracle.  Returns labels (int64) or (labels, sizes)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if edge_correction:
        img = np.pad(img, 1, constant_values=0)
    h, w = img.shape
    labels = np.zeros((h, w), dtype=np.int64)
    for col, (y, x) in enumerate(seeds, start=1):
        labels[y, x] = col  # no +1 shift under edge correction (Q7)
    k = len(seeds)
    sizes = (
        np.zeros((max_water_level + 1, k + 1), dtype=np.int64) if with_sizes else None
    )
    rc = _lib().watershed_oracle(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        k,
        int(max_water_level),
        int(bool(merging)),
        sizes.ctypes.data if with_sizes else None,
    )
    if rc != 0:
        raise RuntimeError(f"native oracle failed rc={rc}")
    return (labels, sizes) if with_sizes else labels


def native_merged_curve(
    labels, lv8, n_labels: int, max_water_level: int, lo, hi, act,
    out_width: int | None = None,
) -> np.ndarray:
    """(levels, out_width) merged per-level lake sizes from the compact
    planes — the one-pass native twin of
    ops.merge_curve.host_cumulative_counts + merged_sizes_host
    (bit-identical integer arithmetic, pinned by
    tests/test_merge_fast.py::test_native_merged_curve_matches_numpy).

    ``out_width`` (default K+1) is the caller's counts_length: rows come
    back already at the public result width (reference rows are n_pixels+1
    long, src/lib.rs:630), written in place by the native pass — no second
    expand/truncate copy.  Representatives >= out_width are dropped, the
    same truncation the expand path applied."""
    labels = np.ascontiguousarray(labels, dtype=np.int32).reshape(-1)
    lv8 = np.ascontiguousarray(lv8, dtype=np.uint8).reshape(-1)
    lo = np.ascontiguousarray(lo, dtype=np.int32)
    hi = np.ascontiguousarray(hi, dtype=np.int32)
    act = np.ascontiguousarray(act, dtype=np.int32)
    levels = max_water_level + 1
    k1 = n_labels + 1
    if out_width is None:
        out_width = k1
    # np.zeros is calloc-lazy: the native pass never touches columns in
    # [k1, out_width), so a huge reference-length width costs no writes.
    out = np.zeros((levels, out_width), dtype=np.int64)
    rc = _lib().merged_curve_oracle(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lv8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.size,
        k1,
        levels,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        act.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lo.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_width,
    )
    if rc != 0:
        raise RuntimeError(f"native merged_curve failed rc={rc}")
    return out


def native_find_local_minima(img) -> list[tuple[int, int]]:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    mask = np.zeros((h, w), dtype=np.uint8)
    rc = _lib().local_extrema_oracle(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"native oracle failed rc={rc}")
    return [tuple(c) for c in np.argwhere(mask.astype(bool))]
