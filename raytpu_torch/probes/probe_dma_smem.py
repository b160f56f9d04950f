"""P2: a worklist-driven ring of asynchronous copies into shared memory.

Counterpart of ``probes/probe_dma_smem.py`` (raytpu's TPU probe of DMAs
with a dynamic source offset into an SMEM ring, the design of its mega3
route).  The kernel is ``render/csrc/probes.cu`` (``dma_ring_kernel``), the
ring of K11 (``render/csrc/mega3.cu``): each block walks the first ``cnt``
entries of its worklist row; entry ``g`` copies the 8 KB row-block
``blob[8g:8g+8, :]`` into one of 4 shared-memory slots with ``cp.async``;
the block adds ``slot[0, 0] + slot[7, 255]`` of each landed row-block to a
float32 sum, in worklist order, and fills its (8, 128) output block with
the sum.

Two shapes:
  * raytpu's own: 128 row-blocks of ``arange``, a seeded permutation, cnt =
    37, 4 blocks walking the same row.  Every partial sum is an integer
    below 2^24, so the float32 sum is exact and must equal numpy's float64
    sum (``expected``).
  * a timed one, on a blob larger than the card's 50 MB L2: ``blocks``
    worklist rows of ``per_block`` entries each, a seeded permutation of
    every row-block, so each row-block is read once per launch; reported in
    bytes/s against 3.35 TB/s.

``dma_ring_sum`` launches the kernel for CUDA tensors and takes the plain
version, ``dma_ring_sum_plain``, only for CPU tensors.

    python -m raytpu_torch.probes.probe_dma_smem [--blocks 528 --per-block 36] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from raytpu_torch.render import build

#: Launches of the kernel, counted where the wrapper launches it.
P2_LAUNCHES = 0

ROWS, COLS = 8, 256  #: one row-block, one worklist entry: 8 KB
OUT_COLS = 128
RAYTPU_NG, RAYTPU_CNT, RAYTPU_BLOCKS = 128, 37, 4
#: H100 SXM memory rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12


def _rows_of(wl, cnt, blocks: int):
    """``wl`` as (blocks, n) and ``cnt`` as (blocks,): a (n,) worklist and a
    (1,) count are shared by every block, as raytpu's grid steps share them."""
    wl2 = wl.reshape(1, -1).expand(blocks, -1) if wl.dim() == 1 else wl
    c = cnt.expand(blocks) if cnt.numel() == 1 else cnt
    return wl2, c


def _check(blob, wl, cnt, blocks: int):
    dev = blob.device
    if blob.dim() != 2 or blob.shape[0] % ROWS or blob.shape[1] != COLS:
        raise ValueError(f"P2: blob must be (ng * {ROWS}, {COLS}), got {tuple(blob.shape)}")
    if blocks < 1:
        raise ValueError(f"P2 needs at least one block, got {blocks}")
    n = wl.shape[-1]
    wl_shape = (n,) if wl.dim() == 1 else (blocks, n)
    cnt_shape = (1,) if cnt.numel() == 1 and cnt.dim() == 1 else (blocks,)
    build.check_tensors("P2", dev, {"blob": (blob, torch.float32, tuple(blob.shape)),
                                    "wl": (wl, torch.int32, wl_shape),
                                    "cnt": (cnt, torch.int32, cnt_shape)})
    if blob.data_ptr() % 16:
        raise ValueError("P2: the blob must be 16-byte aligned for the kernel's copies")
    return n


def dma_ring_sum(blob, wl, cnt, blocks: int):
    """P2 -> (8 * blocks, 128) float32, block b's rows filled with its sum.
    ``blob`` (ng * 8, 256) float32; ``wl`` (n,) int32 shared by every block
    or (blocks, n); ``cnt`` (1,) int32 shared or (blocks,), clamped to
    [0, n] on the device.  Entries outside [0, ng) are skipped."""
    global P2_LAUNCHES
    if all(x.device.type == "cpu" for x in (blob, wl, cnt)):
        return dma_ring_sum_plain(blob, wl, cnt, blocks)
    n = _check(blob, wl, cnt, blocks)
    out = torch.empty((ROWS * blocks, OUT_COLS), dtype=torch.float32, device=blob.device)
    lib = build.load()
    with torch.cuda.device(blob.device):
        err = lib.raytpu_probe_dma_ring(
            blob.data_ptr(), blob.shape[0] // ROWS, wl.data_ptr(), 0 if wl.dim() == 1 else n, n,
            cnt.data_ptr(), 0 if cnt.shape[0] == 1 else 1, blocks, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"P2 launch failed: {build.cuda_error_name(lib, err)}")
    P2_LAUNCHES += 1
    return out


def dma_ring_sum_plain(blob, wl, cnt, blocks: int):
    """What the kernel computes, on ``blob``'s device: the same two values of
    each listed row-block added in worklist order, one rounding each."""
    ng = blob.shape[0] // ROWS
    flat = blob.reshape(ng, ROWS * COLS)
    wl2, c = _rows_of(wl, cnt, blocks)
    c = torch.clamp(c.long(), 0, wl2.shape[1])
    acc = torch.zeros(blocks, dtype=torch.float32, device=blob.device)
    for j in range(wl2.shape[1]):
        g = wl2[:, j].long()
        live = (g >= 0) & (g < ng) & (j < c)
        g = torch.where(live, g, 0)
        step = acc + flat[g, 0]
        step = step + flat[g, ROWS * COLS - 1]
        acc = torch.where(live, step, acc)
    return acc[:, None, None].expand(blocks, ROWS, OUT_COLS).reshape(ROWS * blocks, OUT_COLS)


def raytpu_shape(device):
    """raytpu's inputs: (blob, wl, cnt, blocks) of probe_dma_smem.py:main."""
    blob = torch.arange(RAYTPU_NG * ROWS * COLS, dtype=torch.float32).reshape(-1, COLS)
    wl = torch.from_numpy(np.random.default_rng(0).permutation(RAYTPU_NG).astype(np.int32))
    cnt = torch.tensor([RAYTPU_CNT], dtype=torch.int32)
    return blob.to(device), wl.to(device), cnt.to(device), RAYTPU_BLOCKS


def expected(wl: np.ndarray, cnt: int) -> float:
    """raytpu's float64 sum over the first ``cnt`` entries of an ``arange``
    blob (probe_dma_smem.py:94-95)."""
    w = np.asarray(wl)[:cnt].astype(np.float64)
    return float(np.sum(w * ROWS * COLS + ((w * ROWS + ROWS - 1) * COLS + COLS - 1)))


def timed_shape(device, blocks: int, per_block: int, seed: int = 0):
    """(blob, wl, cnt): ``blocks * per_block`` row-blocks of seeded uniform
    values made on ``device``, every one listed once in a seeded permutation
    split evenly over the blocks."""
    ng = blocks * per_block
    gen = torch.Generator(device=device).manual_seed(seed)
    blob = torch.rand((ng * ROWS, COLS), generator=gen, device=device)
    wl = torch.randperm(ng, generator=gen, device=device).to(torch.int32).reshape(blocks, -1)
    cnt = torch.full((blocks,), per_block, dtype=torch.int32, device=device)
    return blob, wl, cnt


def time_ms(blob, wl, cnt, blocks: int, iters: int = 20, reps: int = 3) -> float:
    """Best of ``reps`` repeats of ``iters`` back-to-back launches, ms per
    launch: CUDA events on the card, the host clock on the CPU."""
    best = float("inf")
    dma_ring_sum(blob, wl, cnt, blocks)
    for _ in range(reps):
        if blob.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                dma_ring_sum(blob, wl, cnt, blocks)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                dma_ring_sum(blob, wl, cnt, blocks)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="probe_dma_smem", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--blocks", type=int, default=132 * 4,
                   help="blocks of the timed shape (default: 4 per SM of an H100)")
    p.add_argument("--per-block", type=int, default=36,
                   help="row-blocks each block walks in the timed shape")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run the kernel on the CUDA card (default) or the plain version on the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; pass --device cpu to run "
              "the plain version", file=sys.stderr)
        return 2
    blob, wl, cnt, blocks = raytpu_shape(args.device)
    t0 = time.perf_counter()
    out = dma_ring_sum(blob, wl, cnt, blocks).cpu()
    val = float(out[0, 0])
    exp = expected(wl.cpu().numpy(), RAYTPU_CNT)
    match = bool((out == val).all()) and val == exp
    print(f"built+ran in {time.perf_counter() - t0:.1f}s on {args.device}")
    print(f"probe value {val}, expected {exp}, match={match}", flush=True)
    blob, wl, cnt = timed_shape(args.device, args.blocks, args.per_block, args.seed)
    ms = time_ms(blob, wl, cnt, args.blocks)
    nbytes = blob.numel() * 4
    print(f"timed: {args.blocks} blocks x {args.per_block} row-blocks ({nbytes / 1e6:.1f} MB) on "
          f"{args.device}: {ms:.4f} ms/launch, {nbytes / (ms / 1e3) / 1e9:.1f} GB/s "
          f"({nbytes / (ms / 1e3) / PEAK_BYTES_PER_S:.3f} of 3.35 TB/s)", flush=True)
    return 0 if match else 1


if __name__ == "__main__":
    sys.exit(main())
