"""Build, load and count the port's CUDA kernels.

The CUDA C++ kernels under ``dreamfusion_tpu_torch/csrc/*.cu`` have a
plain C interface.  At first use, ``cuda_lib()`` compiles them for
``sm_90a`` into ``build/torch_kernels/`` at the root of the checkout, one
``nvcc -c`` per source, all started together, then links them into one
shared library and loads it with ``ctypes``.  No source
includes PyTorch's headers: a build takes seconds rather than the minutes a
``torch/extension.h`` translation unit costs, and a fresh checkout
starts from an empty build directory.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run
resets it with ``reset_launch_counts()`` and reads it afterwards to show
that a path went through the kernels.  It is process-wide state by design:
the counters must see launches from every caller.  A kernel with several
routes (K10's and K12's forwards, chosen by shape) counts each route under
its own name, which is also its C entry point's; so do K10's backward (by
head dim and dtype), K12's dgrad and wgrad, K11's resident and streaming
routes (each with and without the affine gradients), K1's and K6's
backwards (the table-only route and the ``_dx`` route that also gives the
positions' gradient, the second derivative too where the jacobian has
cotangents), K2's (the occupancy march, and the vanilla render's coarse
and resample launches) and K4's three entry point pairs (the head alone,
the head with the normals and the shading, and the head with given
normals and the select).

The Hopper routes encode TMA tensor maps, whose encoder is a driver API
call: ``csrc/hopper.cuh`` fetches it through ``cudaGetDriverEntryPoint``,
so the library links the CUDA runtime alone (no ``-lcuda``).
"""

from __future__ import annotations

import ctypes
import functools
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
              "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC"]

# kernel name → launches by its wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {
    "triplane_fwd": 0, "triplane_bwd": 0,       # K1, CUDA C++
    "triplane_bwd_dx": 0,                       # K1 + the positions' grad
    "march_rays": 0,                            # K2, CUDA C++
    "vanilla_coarse": 0, "vanilla_resample": 0,  # K2's vanilla region
    "composite_fwd": 0, "composite_bwd": 0,     # K3, CUDA C++
    "field_head_fwd": 0, "field_head_bwd": 0,   # K4, CUDA C++
    "field_shade_fwd": 0, "field_shade_bwd": 0,  # K4 + normals and shading
    "field_select_fwd": 0, "field_select_bwd": 0,  # K4 + given normals
    "attention_fwd_wgmma": 0,                   # K10 d = 64, CUDA C++
    "attention_fwd_wgmma_d40": 0,               # K10 d = 40, CUDA C++
    "attention_fwd_wgmma_d80": 0,               # K10 d = 80, CUDA C++
    "attention_fwd_wgmma_d160": 0,              # K10 d = 160, CUDA C++
    "attention_fwd_wgmma_d512": 0,              # K10 d = 512, CUDA C++
    "attention_fwd_fp32": 0,                    # K10 fp32 (DPT), CUDA C++
    "attention_bwd_wgmma": 0,                   # K10 backward d = 512
    "attention_bwd_flash": 0,                   # K10 backward d = 64
    "attention_bwd_flash_d40": 0,               # K10 backward d = 40
    "attention_bwd_flash_d80": 0,               # K10 backward d = 80
    "attention_bwd_flash_d160": 0,              # K10 backward d = 160
    "attention_bwd_fp32": 0,                    # K10 fp32 backward (DPT)
    "groupnorm_fwd_resident": 0, "groupnorm_fwd_stream": 0,  # K11, CUDA C++
    "groupnorm_bwd_resident": 0, "groupnorm_bwd_stream": 0,  # K11, CUDA C++
    "groupnorm_bwd_resident_affine": 0,         # K11 + dscale, dbias
    "groupnorm_bwd_stream_affine": 0,           # K11 + dscale, dbias
    "conv_fwd_wgmma": 0, "conv_fwd_wgmma_i8": 0,  # K12, CUDA C++
    "conv_fwd_mma": 0,                          # K12, CUDA C++
    "conv_fwd_fp32": 0,                         # K12, CUDA C++
    "conv_fwd_fp32_tiled": 0,                   # K12 fp32 (DPT), CUDA C++
    "conv_dgrad_wgmma": 0, "conv_dgrad_narrow": 0,  # K12 dgrad, CUDA C++
    "conv_dgrad_fp32": 0, "conv_dgrad": 0,      # K12 dgrad, CUDA C++
    "conv_dgrad_fp32_tiled": 0,                 # K12 fp32 dgrad (DPT)
    "conv_wgrad_wgmma": 0, "conv_wgrad_mma": 0,  # K12 wgrad, CUDA C++
    "conv_wgrad_wgmma_i8": 0,                   # K12 wgrad of the conv_ins
    "conv_wgrad_fp32_tiled": 0,                 # K12 fp32 wgrad
    "raster_fwd": 0, "raster_bwd": 0,           # K7, CUDA C++
    "interpolate_fwd": 0, "interpolate_bwd": 0,  # K7, CUDA C++
    "marching_tets_fwd": 0, "marching_tets_bwd": 0,          # K8, CUDA C++
    "vertex_normals_fwd": 0, "vertex_normals_bwd": 0,        # K8
    "laplacian_fwd": 0, "laplacian_bwd": 0,                  # K8
    "normal_consistency_fwd": 0, "normal_consistency_bwd": 0,  # K8
    "hashgrid_fwd": 0, "hashgrid_bwd": 0,                    # K6, CUDA C++
    "hashgrid_bwd_dx": 0,                       # K6 + the positions' grad
    "hashgrid_tv_fwd": 0, "hashgrid_tv_bwd": 0,              # K6
    "hashgrid_wd_fwd": 0, "hashgrid_wd_bwd": 0,              # K6
    "clip_grad_bwd": 0,                                      # K5, CUDA C++
    "signed_distance": 0,                                    # K9, CUDA C++
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C signature of every entry point (all return int = cudaError_t)
_SIGNATURES = {
    "triplane_fwd": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "triplane_bwd": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    "triplane_bwd_dx": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    "march_rays": [_P, _L, _L, _P, _L, _L, _F, _P, _I, _I, _F, _P, _I, _P,
                   _L, _I, _I, _I, _P, _P, _P, _P, _P],
    "composite_fwd": [_P] * 5 + [_I, _I, _F, _I, _P, _F, _I, _I] +
    [_P] * 12,
    "composite_bwd": [_P] * 7 + [_I, _I, _F] + [_P] * 5 + [_F, _I, _I] +
    [_P] * 10,
    "vanilla_coarse": [_P, _L, _L, _P, _L, _L, _F, _P, _P, _L, _I, _I, _P,
                       _P, _P, _P],
    "vanilla_resample": [_P, _L, _L, _P, _L, _L, _F, _P, _P, _P, _L, _I, _I,
                         _I, _P, _P, _P, _P],
    "field_head_fwd": [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P],
    "field_head_bwd": [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "field_shade_fwd": [_P] * 3 + [_I, _I, _I, _P, _I, _P, _F, _P, _I] +
    [_F] * 3 + [_P] * 4,
    "field_shade_bwd": [_P] * 3 + [_I, _I, _I, _P, _I, _P, _F, _P, _I] +
    [_F] * 3 + [_P] * 6,
    "field_select_fwd": [_P] * 3 + [_I, _I, _I, _P, _I, _P, _F, _P, _I] +
    [_F] * 2 + [_P] * 3,
    "field_select_bwd": [_P] * 3 + [_I, _I, _I, _P, _I, _P, _F, _P, _I] +
    [_F] * 2 + [_P] * 5,
    "conv_fwd_mma": [_P] * 4 + [_I] * 15 + [_P, _P],
    "conv_fwd_wgmma": [_P] * 4 + [_I] * 20 + [_P, _P],
    "conv_fwd_wgmma_i8": [_P] * 5 + [_I] * 17 + [_P],
    "conv_fwd_fp32": [_P] * 4 + [_I] * 14 + [_P],
    "conv_fwd_fp32_tiled": [_P] * 4 + [_I] * 16 + [_P, _P],
    "conv_dgrad": [_P] * 3 + [_I] * 15 + [_P, _P],
    "conv_dgrad_wgmma": [_P] * 3 + [_I] * 21 + [_P, _P],
    "conv_dgrad_narrow": [_P] * 3 + [_I] * 13 + [_P],
    "conv_dgrad_fp32": [_P] * 3 + [_I] * 13 + [_P],
    "conv_dgrad_fp32_tiled": [_P] * 3 + [_I] * 16 + [_P, _P],
    "conv_wgrad_mma": [_P] * 4 + [_I] * 15 + [_P],
    "conv_wgrad_fp32_tiled": [_P] * 4 + [_I] * 15 + [_P],
    "conv_wgrad_wgmma": [_P] * 4 + [_I] * 19 + [_P],
    "conv_wgrad_wgmma_i8": [_P] * 5 + [_I] * 16 + [_P],
    "clip_grad_bwd": [_P, _P, _L, _F, _I, _P],
    "attention_fwd_wgmma": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_fwd_wgmma_d40": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_fwd_wgmma_d80": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_fwd_wgmma_d160": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_fwd_wgmma_d512": [_P] * 5 + [_I] * 5 + [_P, _P, _F, _P],
    "attention_fwd_fp32": [_P] * 5 + [_I] * 5 + [_F, _P],
    "attention_bwd_wgmma": [_P] * 13 + [_I] * 6 + [_F, _P],
    "attention_bwd_flash": [_P] * 13 + [_I] * 6 + [_F, _P],
    "attention_bwd_flash_d40": [_P] * 13 + [_I] * 6 + [_F, _P],
    "attention_bwd_flash_d80": [_P] * 13 + [_I] * 6 + [_F, _P],
    "attention_bwd_flash_d160": [_P] * 13 + [_I] * 6 + [_F, _P],
    "attention_bwd_fp32": [_P] * 10 + [_I] * 5 + [_F, _P],
    "groupnorm_fwd_resident": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "groupnorm_bwd_resident": [_P] * 6 + [_I] * 10 + [_P],
    "groupnorm_fwd_stream": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    "groupnorm_bwd_stream": [_P] * 8 + [_I] * 9 + [_P],
    "groupnorm_bwd_resident_affine": [_P] * 9 + [_I] * 10 + [_P],
    "groupnorm_bwd_stream_affine": [_P] * 11 + [_I] * 9 + [_P],
    "raster_fwd": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 10 + [_P],
    "raster_bwd": [_P] * 12 + [_I] * 4 + [_F] + [_P] + [_P],
    "interpolate_fwd": [_P] * 4 + [_I] * 2 + [_P, _P],
    "interpolate_bwd": [_P] * 8 + [_I] * 6 + [_P] * 2 + [_P],
    "marching_tets_fwd": [_P] * 5 + [_I] * 3 + [_P] * 9 + [_P],
    "marching_tets_bwd": [_P] * 3 + [_I] * 2 + [_P] * 3 + [_I, _P],
    "vertex_normals_fwd": [_P] * 6 + [_I] + [_P] * 2 + [_P],
    "vertex_normals_bwd": [_P] * 10 + [_I] * 2 + [_P] * 2 + [_P],
    "laplacian_fwd": [_P] * 6 + [_I] + [_P] * 5 + [_P],
    "laplacian_bwd": [_P] * 9 + [_I] * 2 + [_P] * 2 + [_P],
    "normal_consistency_fwd": [_P] * 6 + [_I] + [_P] * 6 + [_P],
    "normal_consistency_bwd": [_P] * 11 + [_I] * 2 + [_P] * 2 + [_P],
    "hashgrid_fwd": [_P] * 3 + [_I] * 6 + [_P] * 4 + [_I, _P],
    "hashgrid_bwd": [_P] * 2 + [_I] * 6 + [_P] * 4 + [_I, _P, _P],
    "hashgrid_bwd_dx": [_P] * 3 + [_I] * 6 + [_P] * 4 + [_I, _P, _P, _P],
    "hashgrid_tv_fwd": [_P] * 3 + [_I] * 4 + [_F, _P, _P],
    "hashgrid_tv_bwd": [_P] * 3 + [_I] * 4 + [_F, _P, _P, _P],
    "hashgrid_wd_fwd": [_P] * 2 + [_I] * 3 + [_P, _P],
    "hashgrid_wd_bwd": [_P] * 2 + [_I] * 3 + [_P, _P, _P],
    "signed_distance": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
_fns: Dict[str, object] = {}    # entry point → its ctypes function
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
    tag = f"{out.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    # one compiler a source, all at once: the build takes the longest
    # source's time, not the sum
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    BUILD_LOG = "".join(logs)
    failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        BUILD_LOG += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["the link"]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{BUILD_LOG}")
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


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Multiprocessors of `device` (the persistent and split routes' grid)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t) -> int | None:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    """The current device's current stream, as a raw handle (without the
    ``torch.cuda.Stream`` object that ``current_stream()`` builds)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, *args) -> None:
    """Call C entry point `name`, count the launch, raise on a CUDA error."""
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(cuda_lib(), name)
    err = fn(*args, stream())
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


_ZEROED: Dict[tuple, torch.Tensor] = {}


def zeroed(dev, name: str, n: int, dtype=torch.int32) -> torch.Tensor:
    """A zeroed device buffer kept across calls: look-back flags and
    last-block counters, which the kernels leave zero when they finish (so
    a launch replays in a CUDA graph)."""
    key = (dev, name)
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < n:
        buf = _ZEROED[key] = torch.zeros(max(n, 1), dtype=dtype, device=dev)
    return buf


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


def check_aligned(*tensors) -> None:
    """Tables read (or reduced into) as 16-byte vectors start on a 16-byte
    boundary."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("expected a 16-byte aligned tensor")


def cotangents(*gs):
    """Cotangents as the field backwards read them → (list, bf16 flag): one
    dtype, bf16 where every given one is bf16 and fp32 otherwise (a cast
    only then), contiguous and 16-byte aligned (a copy only where a view
    is not); None stays None."""
    live = [g for g in gs if g is not None]
    bf16 = bool(live) and all(g.dtype == torch.bfloat16 for g in live)
    dtype = torch.bfloat16 if bf16 else torch.float32
    out = []
    for g in gs:
        if g is not None:
            g = g.to(dtype).contiguous()
            if g.data_ptr() % 16:
                g = g.clone()
        out.append(g)
    return out, int(bf16)
