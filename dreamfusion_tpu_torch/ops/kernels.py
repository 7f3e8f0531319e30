"""Build, load and count the port's CUDA kernels.

The CUDA C++ kernels under ``dreamfusion_tpu_torch/csrc/*.cu`` have a
plain C interface.  At first use, ``cuda_lib()`` compiles all of them in
ONE ``nvcc -shared`` call for ``sm_90a`` into ``build/torch_kernels/`` at
the root of the checkout and loads the library with ``ctypes``.  No source
includes PyTorch's headers: a build takes seconds rather than the minutes a
``torch/extension.h`` translation unit costs, and a fresh checkout
starts from an empty build directory.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets it with ``reset_launch_counts()`` and reads it afterwards to show
that a path went through the kernels.  It is process-wide state by design:
the counters must see launches from every caller.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

# kernel name → launches by its wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {
    "triplane_fwd": 0, "triplane_bwd": 0,       # K1, CUDA C++
    "march_rays": 0,                            # K2, CUDA C++
    "composite_fwd": 0, "composite_bwd": 0,     # K3, CUDA C++
    "field_head_fwd": 0, "field_head_bwd": 0,   # K4, Triton
    "attention_fwd": 0, "attention_bwd": 0,     # K10, CUDA C++
    "groupnorm_fwd": 0, "groupnorm_bwd": 0,     # K11, Triton
    "conv_fwd": 0, "conv_dgrad": 0,             # K12, CUDA C++
    "raster_fwd": 0, "raster_bwd": 0,           # K7, CUDA C++
    "interpolate_fwd": 0, "interpolate_bwd": 0,  # K7, CUDA C++
    "marching_tets_fwd": 0, "marching_tets_bwd": 0,          # K8, CUDA C++
    "vertex_normals_fwd": 0, "vertex_normals_bwd": 0,        # K8
    "laplacian_fwd": 0, "laplacian_bwd": 0,                  # K8
    "normal_consistency_fwd": 0, "normal_consistency_bwd": 0,  # K8
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point (all return int = cudaError_t)
_SIGNATURES = {
    "triplane_fwd": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "triplane_bwd": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "march_rays": [_P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _P, _I, _I, _I,
                   _P, _P, _P, _P],
    "composite_fwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P,
                      _P],
    "composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                      _P, _P, _P],
    "conv_fwd": [_P] * 4 + [_I] * 16 + [_P, _P],
    "conv_dgrad": [_P] * 3 + [_I] * 16 + [_P, _P],
    "attention_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_bwd": [_P] * 12 + [_I] * 5 + [_F, _P],
    "raster_fwd": [_P] * 5 + [_I] * 6 + [_F] + [_P] * 7 + [_P],
    "raster_bwd": [_P] * 10 + [_I] * 2 + [_F] + [_P] * 3 + [_P],
    "interpolate_fwd": [_P] * 4 + [_I] * 2 + [_P, _P],
    "interpolate_bwd": [_P] * 5 + [_I] * 2 + [_P] * 2 + [_P],
    "marching_tets_fwd": [_P] * 5 + [_I] * 4 + [_P] * 5 + [_P],
    "marching_tets_bwd": [_P] * 3 + [_I] + [_P] * 3 + [_P],
    "vertex_normals_fwd": [_P] * 3 + [_I] * 2 + [_P] * 2 + [_P],
    "vertex_normals_bwd": [_P] * 6 + [_I] * 2 + [_P] * 2 + [_P],
    "laplacian_fwd": [_P] * 3 + [_I] * 2 + [_P] * 3 + [_P],
    "laplacian_bwd": [_P] * 6 + [_I] * 2 + [_P] * 2 + [_P],
    "normal_consistency_fwd": [_P] * 3 + [_I] * 2 + [_P] * 8 + [_P],
    "normal_consistency_bwd": [_P] * 6 + [_I] + [_P] * 2 + [_P],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    home = CUDA_HOME or os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _build() -> Path:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    global BUILD_LOG
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in headers + sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libdftorch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    (BUILD_DIR / (out.stem + ".log")).write_text(BUILD_LOG)
    os.replace(tmp, out)
    return out


def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def ptr(t) -> int | None:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call C entry point `name`, count the launch, raise on a CUDA error."""
    err = getattr(cuda_lib(), name)(*args, stream())
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_cuda(*tensors) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
