"""ctypes bindings and the on-demand build of ``src/native.cpp``: the OBJ
parser, the SAH order, the Morton order, the CPU BVH closest hit, the BMP
writer and the monotonic clock.

The library is compiled with g++ and raytpu's flags
(``raytpu/native/runtime.py``) into ``raytpu_torch/_build/`` the first time
it is used, and again whenever the source or a flag changes (a hash of both
and of the host, since ``-march=native`` builds for the host's CPU, is kept
beside the library).  There is no fallback: without a C++ compiler
the OBJ scenes and the large-mesh reorder cannot be built, and the call
raises, because another triangle order would change the scene's tie-breaks.
``available()`` says whether the library builds; every other binding raises
when it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libraytpu_torch_native.so"

#: raytpu's flags, so that both libraries round the SAH build's float math alike
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def _build(lib_path: Path, stamp: Path, digest: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp_lib)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)


def load():
    """The native library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".sha256")
        key = f"{' '.join(GXX_FLAGS)}\n{platform.node()}\n".encode() + SRC.read_bytes()
        digest = hashlib.sha256(key).hexdigest()
        if not (lib_path.exists() and stamp.exists() and stamp.read_text() == digest):
            _build(lib_path, stamp, digest)
        lib = ctypes.CDLL(str(lib_path))
        f_p, i_p, c_int = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int
        f_pp, i_pp = ctypes.POINTER(f_p), ctypes.POINTER(i_p)
        lib.rt_parse_obj.restype = c_int
        lib.rt_parse_obj.argtypes = [ctypes.c_char_p, f_pp, ctypes.POINTER(c_int), f_pp, i_pp,
                                     ctypes.POINTER(c_int)]
        lib.rt_build_bvh.restype = c_int
        lib.rt_build_bvh.argtypes = [f_p, c_int, c_int, c_int, f_p, i_p, i_p]
        lib.rt_monotonic.restype = ctypes.c_double
        lib.rt_monotonic.argtypes = []
        lib.rt_morton_order.restype = None
        lib.rt_morton_order.argtypes = [f_p, c_int, i_p]
        lib.rt_bvh_closest_hit.restype = c_int
        lib.rt_bvh_closest_hit.argtypes = [f_p, f_p, i_p, i_p, c_int, f_p, f_p, ctypes.c_float, f_p]
        lib.rt_write_bmp.restype = c_int
        lib.rt_write_bmp.argtypes = [ctypes.c_char_p, c_int, c_int, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds (or is built) here."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def monotonic() -> float:
    """Seconds on the host's steady clock (``std::chrono::steady_clock``)."""
    return load().rt_monotonic()


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_obj(path: str):
    """Native OBJ parse -> (positions (V,3) f32, normals (F,3) f32, indices (3F,) i32)."""
    lib = load()
    pos_p = ctypes.POINTER(ctypes.c_float)()
    nrm_p = ctypes.POINTER(ctypes.c_float)()
    idx_p = ctypes.POINTER(ctypes.c_int32)()
    n_pos, n_faces = ctypes.c_int(), ctypes.c_int()
    rc = lib.rt_parse_obj(str(path).encode(), ctypes.byref(pos_p), ctypes.byref(n_pos),
                          ctypes.byref(nrm_p), ctypes.byref(idx_p), ctypes.byref(n_faces))
    if rc != 0:
        raise FileNotFoundError(path)
    V, F = n_pos.value, n_faces.value
    # copies: the library keeps only the last parse's buffers alive
    positions = np.ctypeslib.as_array(pos_p, (V, 3)).copy() if V else np.zeros((0, 3), np.float32)
    normals = np.ctypeslib.as_array(nrm_p, (F, 3)).copy() if F else np.zeros((0, 3), np.float32)
    indices = np.ctypeslib.as_array(idx_p, (F * 3,)).copy() if F else np.zeros((0,), np.int32)
    return positions, normals, indices


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 8, bins: int = 8):
    """Binned-SAH BVH over a (T, 3, 3) or (T, 9) soup.  Returns
    ``(node_bounds (N,6) f32, node_meta (N,3) i32 [first, count, left],
    prim_order (T,) i32)``; ``prim_order`` is the leaf order."""
    tv = np.ascontiguousarray(np.asarray(tri_verts, np.float32).reshape(-1, 9))
    T = tv.shape[0]
    nb = np.empty((2 * max(T, 1), 6), np.float32)
    nm = np.empty((2 * max(T, 1), 3), np.int32)
    order = np.empty(T, np.int32)
    n = load().rt_build_bvh(_fptr(tv), T, leaf_size, bins, _fptr(nb), _iptr(nm), _iptr(order))
    if n < 0:
        raise RuntimeError("BVH build failed")
    return nb[:n].copy(), nm[:n].copy(), order


def morton_order(tri_verts: np.ndarray) -> np.ndarray:
    """Morton permutation of a (T, 3, 3) or (T, 9) soup: triangles sorted
    (stably) by the 30-bit Morton code of their centroid in the soup's
    centroid box."""
    tv = np.ascontiguousarray(np.asarray(tri_verts, np.float32).reshape(-1, 9))
    perm = np.empty(tv.shape[0], np.int32)
    load().rt_morton_order(_fptr(tv), tv.shape[0], _iptr(perm))
    return perm


def bvh_closest_hit(tri_verts, node_bounds, node_meta, prim_order, ro, rd, tmin=1e-4):
    """Closest hit of one ray through a ``build_bvh`` tree on the CPU:
    ``(triangle id or -1, t)``.  Moller-Trumbore without culling, strict
    ``<`` against the best t, children pushed right then left; ids in the
    soup's own numbering."""
    tv = np.ascontiguousarray(np.asarray(tri_verts, np.float32).reshape(-1, 9))
    nb = np.ascontiguousarray(node_bounds, np.float32)
    nm = np.ascontiguousarray(node_meta, np.int32)
    po = np.ascontiguousarray(prim_order, np.int32)
    if nb.shape != (nm.shape[0], 6) or nm.shape[1:] != (3,) or po.shape != (tv.shape[0],):
        raise ValueError(f"bvh_closest_hit: bounds {nb.shape}, meta {nm.shape}, order "
                         f"{po.shape} do not fit {tv.shape[0]} triangles")
    ro = np.ascontiguousarray(ro, np.float32).reshape(3)
    rd = np.ascontiguousarray(rd, np.float32).reshape(3)
    t_out = ctypes.c_float()
    tid = load().rt_bvh_closest_hit(_fptr(tv), _fptr(nb), _iptr(nm), _iptr(po), nm.shape[0],
                                    _fptr(ro), _fptr(rd), tmin, ctypes.byref(t_out))
    return tid, t_out.value


def write_bmp(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB to a 24-bit bottom-up BI_RGB BMP."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rc = load().rt_write_bmp(str(path).encode(), w, h,
                             img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise OSError(f"cannot write {path}")
