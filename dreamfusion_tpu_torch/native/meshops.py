"""ctypes binding of the host-side mesh library (``native/src/meshops.cpp``,
the port's copy of ``dreamfusion_tpu/native/src/meshops.cpp``): marching
cubes, clean, decimate and the UV unwrap.

Host C++ in both packages, not a device kernel.  At first use ``g++``
builds it into ``build/meshops/`` at the root of the checkout; the
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a fresh checkout starts from nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "meshops"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the library (cached by content) → its path."""
    src = SRC_DIR / "meshops.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in (SRC_DIR / "mc_tables.h", src):
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libmeshops_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            P = ctypes.POINTER
            f32p, i32p, i64p = (P(ctypes.c_float), P(ctypes.c_int32),
                                P(ctypes.c_int64))
            i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
            sigs = {
                "mops_marching_cubes": ([f32p, i32, i32, i32, f32],
                                        ctypes.c_void_p),
                "mops_clean": ([f32p, i64, i32p, i64, f32, i32, f32],
                               ctypes.c_void_p),
                "mops_decimate": ([f32p, i64, i32p, i64, i64],
                                  ctypes.c_void_p),
                "mops_unwrap": ([f32p, i64, i32p, i64, i32, f32, f32],
                                ctypes.c_void_p),
                "mops_counts": ([ctypes.c_void_p, i64p, i64p], None),
                "mops_copy": ([ctypes.c_void_p, f32p, i32p], None),
                "mops_get_uv": ([ctypes.c_void_p, f32p], None),
                "mops_get_src": ([ctypes.c_void_p, i32p], None),
                "mops_free": ([ctypes.c_void_p], None),
            }
            for name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
    return _LIB


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _take(lib, handle, with_uv=False, with_src=False):
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    lib.mops_counts(handle, ctypes.byref(nv), ctypes.byref(nt))
    verts = np.empty((nv.value, 3), np.float32)
    tris = np.empty((nt.value, 3), np.int32)
    lib.mops_copy(handle, _f32p(verts), _i32p(tris))
    out = [verts, tris]
    if with_uv:
        uv = np.empty((nv.value, 2), np.float32)
        lib.mops_get_uv(handle, _f32p(uv))
        out.append(uv)
    if with_src:
        src = np.empty((nv.value,), np.int32)
        lib.mops_get_src(handle, _i32p(src))
        out.append(src)
    lib.mops_free(handle)
    return tuple(out)


def _mesh_args(verts, tris):
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    return verts, tris, (_f32p(verts), len(verts), _i32p(tris), len(tris))


def marching_cubes(grid: np.ndarray, iso: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """grid [X,Y,Z] float; surface of {grid > iso}.  Returns vertices in
    index space [nv,3] float32 and triangles [nt,3] int32 (outward CCW)."""
    grid = np.ascontiguousarray(grid, np.float32)
    lib = _lib()
    h = lib.mops_marching_cubes(_f32p(grid), *grid.shape, float(iso))
    return _take(lib, h)


def clean_mesh(verts: np.ndarray, tris: np.ndarray, weld_eps: float = 1e-5,
               min_faces: int = 8, min_frac: float = 0.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Weld near-duplicate vertices, drop degenerate faces and connected
    components smaller than max(min_faces, min_frac·largest)."""
    verts, tris, args = _mesh_args(verts, tris)
    lib = _lib()
    return _take(lib, lib.mops_clean(*args, float(weld_eps), int(min_faces),
                                     float(min_frac)))


def decimate_mesh(verts: np.ndarray, tris: np.ndarray, target_faces: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge-collapse decimation to ~target_faces."""
    verts, tris, args = _mesh_args(verts, tris)
    lib = _lib()
    return _take(lib, lib.mops_decimate(*args, int(target_faces)))


def unwrap_uv(verts: np.ndarray, tris: np.ndarray, atlas_res: int = 1024,
              padding_px: float = 2.0, max_angle_deg: float = 45.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Chart-growth UV atlas → (verts', tris', uv, src): verts' duplicates
    chart-boundary vertices and src maps each back to its input vertex."""
    verts, tris, args = _mesh_args(verts, tris)
    lib = _lib()
    return _take(lib, lib.mops_unwrap(*args, int(atlas_res),
                                      float(padding_px),
                                      float(max_angle_deg)),
                 with_uv=True, with_src=True)
