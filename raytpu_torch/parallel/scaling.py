"""Scaling harness: primary rays/s of the sharded render on 1 rank and on
more.

Counterpart of ``raytpu/parallel/scaling.py``.  Every rank of the group
runs it; for each count c of ranks (1, 2, 4, ... up to the world size,
multiples of ``prim``) the first c ranks render on a (c / prim, prim) mesh
while the others wait, and rank 0 times the frames on the host clock, to a
synchronize on the card.  ``multihost.initialize`` binds rank r to card r
modulo the host's cards.  Ranks that share one card, or the CPU, measure
function, not scaling.

Usage: python -m raytpu_torch.parallel.scaling --scene reference --size 640x480
       (one process; several: ``launch.py``'s address, world size and rank)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from raytpu_torch.core import scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.parallel import multihost
from raytpu_torch.parallel.sharding import make_mesh, render_pixels_sharded


def measure(scene, config: RenderConfig, mesh, frames: int = 4, repeats: int = 2) -> float:
    """Primary rays/s of the sharded render on ``mesh``: the best of
    ``repeats`` runs of ``frames`` frames, after one warm-up frame."""
    def sync():
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)

    render_pixels_sharded(scene, config, mesh)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(frames):
            render_pixels_sharded(scene, config, mesh)
        sync()
        best = min(best, (time.perf_counter() - t0) / frames)
    return config.width * config.height / best


def scaling_report(scene_name: str = "reference", size=(256, 192), prim: int = 1,
                   frames: int = 4, device: str = "cuda") -> list:
    """Rows of ``{"devices", "primary_rays_per_s", "speedup", "efficiency"}``
    on rank 0 (other ranks return [])."""
    scene = scenes.get(scene_name).build(device)
    config = RenderConfig(width=size[0], height=size[1])
    n = dist.get_world_size() if dist.is_initialized() else 1
    rows, base = [], None
    for c in (1, 2, 4, 8, 16, 32):
        if c > n or c % prim:
            continue
        mesh = make_mesh(px=c // prim, prim=prim, ranks=c)
        if mesh is not None:
            rps = measure(scene, config, mesh, frames=frames)
            base = base or rps
            rows.append({"devices": c, "primary_rays_per_s": rps, "speedup": rps / base,
                         "efficiency": rps / (base * c)})
        if dist.is_initialized():
            dist.barrier()
    return rows if multihost.is_primary() else []


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu_torch.parallel.scaling")
    p.add_argument("--scene", default="reference")
    p.add_argument("--size", default="256x192")
    p.add_argument("--prim", type=int, default=1)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--init-method", default=None, help="e.g. tcp://127.0.0.1:29500")
    p.add_argument("--world-size", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    multihost.initialize(args.init_method, args.world_size, args.rank)
    w, h = (int(x) for x in args.size.lower().split("x"))
    for row in scaling_report(args.scene, (w, h), args.prim, args.frames, args.device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
