"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc -c`` per source, all started together, then linked into one shared
library with a plain C interface, ``raytpu_torch/_build/libraytpu_torch_kernels.so``,
and loaded with ``ctypes``.  The build runs the first time a kernel is used
and again whenever a source, a shared header (``csrc/*.cuh``) or a flag
changes (a hash of them is kept beside the library).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libraytpu_torch_kernels.so"

#: No FMA contraction and no fast math: common.cuh's header says why.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
#: What the last build printed (ptxas register and shared-memory use), or "".
last_build_log = ""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or stale.  Returns the
    seconds spent compiling (0.0 when the library was current)."""
    global last_build_log
    lib_path, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src.name for src, p in zip(_sources(), procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs),
                               "-o", str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    last_build_log = "\n".join(logs)
    return time.perf_counter() - t0


def load():
    """The kernel library, built first if needed, with its C signatures set."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        lib.raytpu_mega_render.argtypes = [c_ptr, c_int, c_int, c_int, c_int, c_int, c_int,
                                           c_int, c_int, c_float, c_float, c_float, c_int, c_int,
                                           c_ptr, c_ptr]
        lib.raytpu_mega_render.restype = c_int
        # scene, S, P, T | wl, cnt, wl_cols, W, H, tiled, tile0, tiles
        tiles_in = [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int, c_int]
        # feed, mode, shadows, tmin, offset, shadow_dim, acc, out, stream
        shade_out = [c_int, c_int, c_int, c_float, c_float, c_float, c_ptr, c_ptr, c_ptr]
        # scene, S, P, T, boxes | tiles_in | tmin, offset, acc, part, done, bounds, stream
        lib.raytpu_mega2_closest.argtypes = ([c_ptr, c_int, c_int, c_int, c_ptr] + tiles_in
                                             + [c_float, c_float] + [c_ptr] * 5)
        lib.raytpu_mega2_closest.restype = c_int
        lib.raytpu_closest_blocks_per_tile.argtypes = []
        lib.raytpu_closest_blocks_per_tile.restype = c_int
        # scene, S, P, T, L, boxes
        lib.raytpu_mega2_shade.argtypes = ([c_ptr, c_int, c_int, c_int, c_int, c_ptr] + tiles_in
                                           + shade_out)
        lib.raytpu_mega2_shade.restype = c_int
        # scene, S, P, T, blob, boxes | tiles_in | tmin, offset, acc, part, done, bounds,
        # stream
        lib.raytpu_mega3_closest.argtypes = ([c_ptr, c_int, c_int, c_int, c_ptr, c_ptr] + tiles_in
                                             + [c_float, c_float] + [c_ptr] * 5)
        lib.raytpu_mega3_closest.restype = c_int
        # scene, S, P, T, L, blob, boxes
        lib.raytpu_mega3_shade.argtypes = ([c_ptr, c_int, c_int, c_int, c_int, c_ptr, c_ptr]
                                           + tiles_in + shade_out)
        lib.raytpu_mega3_shade.restype = c_int
        # ro, rd, R, spheres, S, planes, P, triangles, T, boxes, wl, cnt, wl_cols, tmin,
        # t, idx, normal, material, stream
        lib.raytpu_packed_closest.argtypes = [c_ptr, c_ptr, c_int, c_ptr, c_int, c_ptr, c_int,
                                              c_ptr, c_int, c_ptr, c_ptr, c_ptr, c_int, c_float,
                                              c_ptr, c_ptr, c_ptr, c_ptr, c_ptr]
        lib.raytpu_packed_closest.restype = c_int
        # p, dirs, mags, R, L, spheres, S, planes, P, triangles, T, boxes, wl, cnt,
        # wl_cols, tmin, occ, stream
        lib.raytpu_packed_anyhit.argtypes = [c_ptr, c_ptr, c_ptr, c_int, c_int, c_ptr, c_int, c_ptr,
                                             c_int, c_ptr, c_int, c_ptr, c_ptr, c_ptr, c_int,
                                             c_float, c_ptr, c_ptr]
        lib.raytpu_packed_anyhit.restype = c_int
        soft_in = [c_ptr, c_ptr, c_ptr, c_int, c_int]  # p, dirs, mags, R, L
        soft_wl = [c_ptr, c_ptr, c_int, c_float, c_float]  # wl, cnt, wl_cols, tmin, beta
        sp_tri = [c_ptr, c_int, c_ptr, c_int, c_ptr, c_int]  # spheres, planes, triangles
        lib.raytpu_soft_trans.argtypes = soft_in + sp_tri + [c_ptr] + soft_wl + [c_ptr, c_ptr]
        lib.raytpu_soft_trans.restype = c_int
        # ... boxes, wl, cnt, wl_cols, tmin, beta, g, trans, g_p, g_dirs, g_mags, scratch,
        # stream
        lib.raytpu_soft_dray.argtypes = soft_in + sp_tri + [c_ptr] + soft_wl + [c_ptr] * 7
        lib.raytpu_soft_dray.restype = c_int
        # ... triangles, T, boxes, wl, cnt, wl_cols, tmin, beta, g, trans, out, stream
        lib.raytpu_soft_dprim.argtypes = soft_in + [c_ptr, c_int, c_ptr] + soft_wl + [c_ptr] * 4
        lib.raytpu_soft_dprim.restype = c_int
        # ro, rd, tmax, R, ... boxes, wl, cnt, wl_cols, tmin, shadow, t, idx, normal,
        # material, stream
        lib.raytpu_chunked_min_t.argtypes = ([c_ptr, c_ptr, c_ptr, c_int] + sp_tri
                                             + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_int]
                                             + [c_ptr] * 5)
        lib.raytpu_chunked_min_t.restype = c_int
        # ... boxes, wl, cnt, wl_cols, tmin, occ, stream
        lib.raytpu_chunked_anyhit_lights.argtypes = (soft_in + sp_tri + [c_ptr, c_ptr, c_ptr, c_int,
                                                                         c_float, c_ptr, c_ptr])
        lib.raytpu_chunked_anyhit_lights.restype = c_int
        lib.raytpu_chunked_shadow_shade.argtypes = (
            [c_ptr] * 8 + [c_int, c_int, c_ptr, c_ptr, c_int] + sp_tri
            + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_int, c_int, c_float, c_ptr, c_ptr])
        lib.raytpu_chunked_shadow_shade.restype = c_int
        # tri, wl, T, tiles, worklist, staged, out, stream
        lib.raytpu_probe_smem_fold.argtypes = [c_ptr, c_ptr] + [c_int] * 4 + [c_ptr, c_ptr]
        lib.raytpu_probe_smem_fold.restype = c_int
        # blob, ng, wl, wl_stride, wl_cols, cnt, cnt_stride, blocks, out, stream
        lib.raytpu_probe_dma_ring.argtypes = ([c_ptr, c_int, c_ptr, c_int, c_int, c_ptr, c_int,
                                               c_int, c_ptr, c_ptr])
        lib.raytpu_probe_dma_ring.restype = c_int
        lib.raytpu_cuda_error_string.argtypes = [c_int]
        lib.raytpu_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_tensors(what: str, device, tensors: dict) -> None:
    """Raise ValueError unless ``device`` is a CUDA device and each entry
    ``name: (tensor, dtype, shape)`` is a contiguous tensor of that dtype
    and shape on it: what a kernel's C interface takes."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {device}")
    for name, (x, dtype, shape) in tensors.items():
        if (x.device != torch.device(device) or x.dtype != dtype or not x.is_contiguous()
                or tuple(x.shape) != tuple(shape)):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {tuple(shape)} tensor "
                             f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def check_aligned(what: str, name: str, x, nbytes: int) -> None:
    """Raise ValueError unless ``x``'s data starts on an ``nbytes`` boundary,
    as a kernel's vector loads need."""
    if x.data_ptr() % nbytes:
        raise ValueError(f"{what}: {name} must be {nbytes}-byte aligned for the kernel's loads")


def cuda_error_name(lib, err: int) -> str:
    return f"{err} ({lib.raytpu_cuda_error_string(err).decode()})"
