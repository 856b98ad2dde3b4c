"""Build + load the native library; typed wrappers."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from burn_raymarching.config import DensityConfig

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "burn_native.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libburn_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _DensityRules(ctypes.Structure):
    _fields_ = [
        ("prune_min_radius", ctypes.c_float),
        ("prune_max_radius_base", ctypes.c_float),
        ("prune_max_radius_decay", ctypes.c_float),
        ("prune_flyaway_dist_sq", ctypes.c_float),
        ("prune_black_color_sum", ctypes.c_float),
        ("split_radius_base", ctypes.c_float),
        ("split_radius_decay", ctypes.c_float),
        ("split_move_dist", ctypes.c_float),
        ("split_child_radius_scale", ctypes.c_float),
        ("split_child_min_radius", ctypes.c_float),
    ]


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", _SO, _SRC, "-lpthread"],
            check=True, capture_output=True, timeout=120,
        )
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.prune_and_split_native.restype = ctypes.c_int
        lib.prune_and_split_native.argtypes = [
            f32p, f32p, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(_DensityRules), f32p, f32p, f32p, f32p, i32p,
        ]
        lib.camera_rays_native.restype = None
        lib.camera_rays_native.argtypes = [
            ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_float,
            f32p, f32p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def prune_and_split_native(
    raw_centers: np.ndarray,
    raw_colors: np.ndarray,
    raw_radii: np.ndarray,
    init_centers: np.ndarray,
    stage: int,
    stages: int,
    seed: int = 0,
    cfg: DensityConfig = DensityConfig(),
    dirs: Optional[np.ndarray] = None,
):
    """C++ density control → (centers, colors, radii, stats dict).

    ``dirs`` ([M,3]) injects split directions (for exact cross-checks against
    the NumPy implementation); None draws from the library's own RNG.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    m = int(np.asarray(raw_centers).reshape(-1, 3).shape[0])
    c = np.ascontiguousarray(raw_centers, np.float32).reshape(m, 3)
    col = np.ascontiguousarray(raw_colors, np.float32).reshape(m, 3)
    r = np.ascontiguousarray(raw_radii, np.float32).reshape(m)
    init = np.ascontiguousarray(init_centers, np.float32).reshape(m, 3)
    rules = _DensityRules(
        cfg.prune_min_radius, cfg.prune_max_radius_base,
        cfg.prune_max_radius_decay, cfg.prune_flyaway_dist_sq,
        cfg.prune_black_color_sum, cfg.split_radius_base,
        cfg.split_radius_decay, cfg.split_move_dist,
        cfg.split_child_radius_scale, cfg.split_child_min_radius,
    )
    out_c = np.empty((2 * m, 3), np.float32)
    out_col = np.empty((2 * m, 3), np.float32)
    out_r = np.empty((2 * m,), np.float32)
    stats = np.zeros((5,), np.int32)
    d_ptr = (
        _fp(np.ascontiguousarray(dirs, np.float32)) if dirs is not None
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    )
    n = lib.prune_and_split_native(
        _fp(c), _fp(col), _fp(r), _fp(init), m, stage, stages,
        ctypes.c_uint64(seed), ctypes.byref(rules), d_ptr,
        _fp(out_c), _fp(out_col), _fp(out_r),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return (
        out_c[:n].copy(), out_col[:n].copy(), out_r[:n, None].copy(),
        {"pruned_size": int(stats[0]), "pruned_flyaway": int(stats[1]),
         "pruned_black": int(stats[2]), "split": int(stats[3]),
         "kept": int(stats[4])},
    )


def camera_rays_native(width: int, height: int, eye, target, fov_deg: float,
                       num_threads: int = 0):
    """C++ threaded ray generation → (org [N,3], dir [N,3]) float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    eye = np.ascontiguousarray(eye, np.float32).reshape(3)
    target = np.ascontiguousarray(target, np.float32).reshape(3)
    out_org = np.empty((width * height, 3), np.float32)
    out_dir = np.empty((width * height, 3), np.float32)
    lib.camera_rays_native(width, height, _fp(eye), _fp(target),
                           ctypes.c_float(fov_deg), _fp(out_org),
                           _fp(out_dir), num_threads)
    return out_org, out_dir
