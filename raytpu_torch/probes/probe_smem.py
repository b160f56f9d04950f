"""P1: the cost of the bare per-(ray, triangle) fold loop on the card.

Counterpart of ``probes/probe_smem.py`` (raytpu's TPU probe of a loop over
triangle scalars in SMEM).  The kernel is ``render/csrc/probes.cu``
(``smem_fold_kernel``): synthetic rays in 1024-ray tiles, one raytpu
(8, 128) tile each; each ray folds ``T`` triangles of 12 floats (9 vertex
coordinates, an id, 2 pads) with a Moller-Trumbore test and keeps a running
(min t, id), then writes ``t + id`` (1e30 on a miss).  Each thread folds
FOLD_RAYS rays of one tile row, reading each triangle once for all of them
(``thread_rays`` is its map).  Four variants: the triangles staged in shared
memory (K11's way) or read from device memory as a broadcast (K2's way), in
order or through a worklist.

``smem_fold`` launches the kernel for CUDA tensors and takes the plain
version, ``smem_fold_plain``, only for CPU tensors.  ``run`` times one
variant with CUDA events over 8 back-to-back launches and prints raytpu's
line: ms per dispatch, ns per (tile, triangle), G ray-triangle tests/s.

    python -m raytpu_torch.probes.probe_smem [T ...] [--tiles 300] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from raytpu_torch.core import math3d
from raytpu_torch.render import build

#: Launches of the kernel, counted where the wrapper launches it.
P1_LAUNCHES = 0

TILE = 1024  #: rays a block: one (8, 128) tile
TRI_COLS = 12
#: Shared memory one block may take on an H100 (the staged variants' cap).
MAX_SMEM_BYTES = 232448
#: Launches timed back to back per repeat, as raytpu's 8-step scan.
DISPATCHES = 8
#: The kernel's rays a thread and threads a block (probes.cu kFoldRays,
#: kFoldBlock).
FOLD_RAYS, FOLD_BLOCK = 4, 128


def thread_rays(tiles: int, rays: int = FOLD_RAYS, block: int = FOLD_BLOCK):
    """(blocks, block, rays) long: the output index (tile * 1024 + sub * 128
    + lane) of each ray of each thread of the kernel's grid, -1 for threads
    past the last tile (probes.cu:smem_fold_kernel).  Thread g takes lanes
    g % (128 // rays) + m * (128 // rays) of row (g % (1024 // rays)) //
    (128 // rays) of tile g // (1024 // rays)."""
    per_tile, per_row = TILE // rays, 128 // rays
    blocks = -(-tiles * per_tile // block)
    g = torch.arange(blocks * block)
    tile, sub, lane0 = g // per_tile, (g % per_tile) // per_row, g % per_row
    idx = (tile * TILE + sub * 128 + lane0)[:, None] + torch.arange(rays)[None, :] * per_row
    return torch.where((g < tiles * per_tile)[:, None], idx, -1).reshape(blocks, block, rays)


def make_triangles(T: int, seed: int = 0, front: bool = False) -> np.ndarray:
    """(T, 12) float32 triangles from a seeded draw.  By default raytpu's
    uniform [0, 1) draw, which every probe ray misses (the rays leave z = 1
    going +z).  ``front`` places the triangles in front of the first tiles'
    rays: vertices in [-1, 3) in x and y and [2, 3) in z, id = the row."""
    rng = np.random.default_rng(seed)
    if not front:
        return rng.random((T, TRI_COLS), dtype=np.float32)
    tri = np.zeros((T, TRI_COLS), np.float32)
    xy = rng.uniform(-1.0, 3.0, (T, 3, 2))
    z = rng.uniform(2.0, 3.0, (T, 3, 1))
    tri[:, :9] = np.concatenate([xy, z], axis=-1).reshape(T, 9)
    tri[:, 9] = np.arange(T)
    return tri


def make_worklist(T: int, seed: int = 0) -> np.ndarray:
    """(1, T) int32 seeded permutation, raytpu's worklist shape."""
    return np.random.default_rng(seed + 1).permutation(T).astype(np.int32)[None, :]


def _check(tri, wl, tiles: int, worklist: bool, staged: bool) -> int:
    T = tri.shape[0]
    build.check_tensors("P1", tri.device, {"tri": (tri, torch.float32, (T, TRI_COLS)),
                                           "wl": (wl, torch.int32, (1, T))})
    if tiles < 1:
        raise ValueError(f"P1 needs at least one tile, got {tiles}")
    build.check_aligned("P1", "tri", tri, 16)  # the kernel reads each triangle as float4s
    if staged and 4 * T * (TRI_COLS + int(worklist)) > MAX_SMEM_BYTES:
        raise ValueError(f"P1 staged: {T} triangles do not fit in {MAX_SMEM_BYTES} B of "
                         "shared memory")
    return T


def smem_fold(tri, wl, tiles: int, worklist: bool = False, staged: bool = True):
    """P1 over ``tiles`` tiles -> (8 * tiles, 128) float32 of ``t + id``.
    ``tri`` (T, 12) float32, 16-byte aligned, ``wl`` (1, T) int32 (read when ``worklist``;
    entries outside [0, T) are skipped); ``staged`` stages the triangles in
    shared memory, else every thread reads them from device memory."""
    global P1_LAUNCHES
    if tri.device.type == "cpu" and wl.device.type == "cpu":
        return smem_fold_plain(tri, wl, tiles, worklist, staged)
    T = _check(tri, wl, tiles, worklist, staged)
    out = torch.empty((8 * tiles, 128), dtype=torch.float32, device=tri.device)
    lib = build.load()
    with torch.cuda.device(tri.device):
        err = lib.raytpu_probe_smem_fold(tri.data_ptr(), wl.data_ptr(), T, tiles, int(worklist),
                                         int(staged), out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"P1 launch failed: {build.cuda_error_name(lib, err)}")
    P1_LAUNCHES += 1
    return out


def smem_fold_plain(tri, wl, tiles: int, worklist: bool = False, staged: bool = True):
    """What the kernel computes, vectorised over the rays and looped over
    the triangles, on ``tri``'s device.  Every operation rounds on its own
    and divides by a tensor (IEEE division), as the kernel does; ``staged``
    changes nothing here."""
    dev = tri.device
    tid = torch.arange(TILE, device=dev)
    lane, sub = (tid % 128).to(torch.float32), (tid // 128).to(torch.float32)
    rx = (lane * math3d.scalar(0.01, dev))[None, :] + torch.arange(
        tiles, dtype=torch.float32, device=dev)[:, None]
    ry = (sub * math3d.scalar(0.1, dev))[None, :]
    rz = 1.0
    one = math3d.scalar(1.0, dev)
    eps, tmin = math3d.scalar(1e-8, dev), math3d.scalar(1e-4, dev)
    t_best = torch.full((tiles, TILE), 1e30, dtype=torch.float32, device=dev)
    idx_best = torch.zeros((tiles, TILE), dtype=torch.float32, device=dev)
    rows = tri
    if worklist:
        idx = wl.reshape(-1).long()
        rows = tri[idx[(idx >= 0) & (idx < tri.shape[0])]]
    for v in rows:
        ex, ey, ez = v[3] - v[0], v[4] - v[1], v[5] - v[2]
        fx, fy, fz = v[6] - v[0], v[7] - v[1], v[8] - v[2]
        px = ry * fz - rz * fy
        py = rz * fx - rx * fz
        pz = rx * fy - ry * fx
        det = ex * px + ey * py + ez * pz
        inv = one / torch.where(det.abs() < eps, one, det)
        sx, sy, sz = rx - v[0], ry - v[1], rz - v[2]
        u = (sx * px + sy * py + sz * pz) * inv
        qx = sy * ez - sz * ey
        qy = sz * ex - sx * ez
        qz = sx * ey - sy * ex
        w = (rx * qx + ry * qy + rz * qz) * inv
        t = (fx * qx + fy * qy + fz * qz) * inv
        ok = (u >= 0.0) & (w >= 0.0) & (u + w <= 1.0) & (t > tmin) & (t < t_best)
        t_best = torch.where(ok, t, t_best)
        idx_best = torch.where(ok, v[9], idx_best)
    return (t_best + idx_best).reshape(8 * tiles, 128)


def run(T: int, tiles: int, worklist: bool, staged: bool = True, reps: int = 3,
        device="cuda", seed: int = 0) -> dict:
    """Time one variant on raytpu's triangle draw: the best of ``reps``
    repeats of DISPATCHES back-to-back launches (CUDA events on the card,
    the host clock on the CPU), per launch.  Prints raytpu's line and
    returns its numbers."""
    dev = torch.device(device)
    tri = torch.from_numpy(make_triangles(T, seed)).to(dev)
    wl = torch.from_numpy(make_worklist(T, seed)).to(dev)
    smem_fold(tri, wl, tiles, worklist, staged)  # builds the kernels on first use
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(DISPATCHES):
                smem_fold(tri, wl, tiles, worklist, staged)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(DISPATCHES):
                smem_fold(tri, wl, tiles, worklist, staged)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / DISPATCHES)
    res = {"T": T, "tiles": tiles, "worklist": worklist, "staged": staged, "device": dev.type,
           "ms": best * 1e3, "ns_per_tile_tri": best / (tiles * T) * 1e9 if T else 0.0,
           "tests_per_s": tiles * T * TILE / best}
    print(f"T={T:5d} wl={int(worklist)} staged={int(staged)} ({T * TRI_COLS * 4 / 1024:6.1f} KB) "
          f"tiles={tiles} on {dev.type}: {res['ms']:8.4f} ms/dispatch, "
          f"{res['ns_per_tile_tri']:6.2f} ns/(tile,tri), "
          f"{res['tests_per_s'] / 1e9:8.2f} G ray-tri tests/s", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probe_smem", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("T", type=int, nargs="*", default=[64, 384, 1024], help="triangle counts")
    p.add_argument("--tiles", type=int, default=300, help="1024-ray tiles (blocks)")
    p.add_argument("--reps", type=int, default=3, help="timed repeats of 8 launches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run the kernel on the CUDA card (default) or the plain version on the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; pass --device cpu to run "
              "the plain version", file=sys.stderr)
        return 2
    for T in args.T:
        for wl in (False, True):
            for staged in (True, False):
                run(T, args.tiles, wl, staged, args.reps, args.device, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
