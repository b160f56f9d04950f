"""Command-line frame loop (reference: source/main.cpp:23-121).

Counterpart of ``raytpu/app/cli.py``.  The reference's #defines and F-keys
become flags:
  --scene       scene registry name        (was: editing main.cpp:48)
  --size WxH    resolution                 (was: literals main.cpp:32-33)
  --mode        lighting debug mode        (was: F3 cycle)
  --no-shadows  disable shadow rays        (was: F2 toggle)
  --soft-shadows  sigmoid soft-shadow visibility, the differentiable form
  --soft-beta B   its sharpness (default 300; lower is softer)
  --screenshot  save the last frame, BMP or PNG (was: X key)
  --benchmark N FPS benchmark -> file      (was: F6)
  --frames N    run N animated frames
  --frames-per-dispatch K  enqueue K animated frames with no host read
                between them and read back only the last (raytpu's lax.scan)
  --renderer    kernel (default, "auto" too): the route through the CUDA
                kernels; eager: plain tensor ops
  --ssaa N      NxN supersampling per pixel, through the chosen renderer
  --watch       print FPS once per second  (was: main.cpp:95-100)
  --device      cuda (default) or cpu
  --shard PXxPRIM  render on a (px, prim) mesh of ranks: rays over px,
                triangles over prim; one process per rank, each given
                --dist-init and --rank (parallel/launch.py spawns them);
                rank r renders on card r modulo the host's cards

Usage: python -m raytpu_torch.app.cli --scene reference --size 640x480 --frames 64
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np
import torch

from raytpu_torch.core import math3d, scenes
from raytpu_torch.core.types import LightingMode, RenderConfig
from raytpu_torch.render import cuda_kernel, renderer
from raytpu_torch.utils import image as image_io
from raytpu_torch.utils.profiling import Benchmark, FrameTimer, RayStats

_MODES = {
    "observed_area": LightingMode.OBSERVED_AREA,
    "radiance": LightingMode.RADIANCE,
    "brdf": LightingMode.BRDF,
    "combined": LightingMode.COMBINED,
}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default="reference", choices=sorted(scenes.REGISTRY), help="scene fixture")
    p.add_argument("--size", default="640x480", help="WxH resolution")
    p.add_argument("--mode", default="combined", choices=list(_MODES),
                   help="lighting debug mode (reference: F3)")
    p.add_argument("--no-shadows", action="store_true", help="disable shadow rays (reference: F2)")
    p.add_argument("--soft-shadows", action="store_true",
                   help="sigmoid soft-shadow visibility (the differentiable renderer's)")
    p.add_argument("--soft-beta", type=float, default=None, metavar="B",
                   help="soft-shadow sigmoid sharpness (default 300; lower = softer)")
    p.add_argument("--frames", type=int, default=1, help="number of animated frames to render")
    p.add_argument("--frames-per-dispatch", type=int, default=1, metavar="K",
                   help="enqueue K animated frames with no host read between them and read back "
                        "only the last; animation times within a dispatch advance by the "
                        "previous dispatch's wall time per frame")
    p.add_argument("--screenshot", metavar="PATH", default=None, help="save the last frame (BMP or PNG)")
    p.add_argument("--benchmark", type=int, metavar="N", default=0,
                   help="run an N-sample FPS benchmark (reference: F6)")
    p.add_argument("--benchmark-out", default="benchmark.txt", help="benchmark report path")
    p.add_argument("--watch", action="store_true", help="print FPS once per second")
    p.add_argument("--renderer", default="auto", choices=["auto", "eager", "kernel"],
                   help="forward path: the route through the CUDA kernels (auto, kernel) or "
                        "plain tensor ops (eager)")
    p.add_argument("--ssaa", type=int, default=1, metavar="N", help="NxN supersampling per pixel")
    p.add_argument("--time", type=float, default=0.0, help="animation start time (seconds)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the CUDA card (default) or, asked for, the CPU")
    p.add_argument("--shard", metavar="PXxPRIM", default=None,
                   help="render on a (px, prim) mesh of PX*PRIM ranks (e.g. 2x1: rays over 2 "
                        "ranks); the analog of the reference's CPU-thread pixel fan-out "
                        "(source/Renderer.cpp:42-92)")
    p.add_argument("--dist-init", metavar="URL", default=None,
                   help="with --shard over several ranks: the group's address, "
                        "e.g. tcp://127.0.0.1:29500")
    p.add_argument("--rank", type=int, default=0, help="with --shard: this process's rank")
    return p


def make_render_fn(renderer_name: str):
    """(render_fn -> uint8, render_f32_fn, backend name) for ``--renderer``:
    the kernel route (``auto``, ``kernel``) or the eager path.  A kernel
    that fails to build raises; nothing falls back to the eager path."""
    if renderer_name == "eager":
        return renderer.render_image, renderer.render_image_f32, "eager"
    return cuda_kernel.render_image, cuda_kernel.render_image_f32, "kernel"


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"error: --size must be WxH (got {args.size!r})", file=sys.stderr)
        return 2
    if w <= 0 or h <= 0:
        print(f"error: --size must be positive (got {args.size!r})", file=sys.stderr)
        return 2
    if args.ssaa < 1:
        print(f"error: --ssaa must be >= 1 (got {args.ssaa})", file=sys.stderr)
        return 2
    if args.frames_per_dispatch < 1:
        print(f"error: --frames-per-dispatch must be >= 1 (got {args.frames_per_dispatch})",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; "
              "pass --device cpu to render on the CPU", file=sys.stderr)
        return 2
    soft_kw = {}
    if args.soft_shadows:
        soft_kw["soft_shadows"] = True
        if args.soft_beta is not None:
            soft_kw["soft_beta"] = float(args.soft_beta)
    config = RenderConfig(width=w, height=h, lighting_mode=_MODES[args.mode],
                          shadows=not args.no_shadows, **soft_kw)
    render_fn, render_f32, backend = make_render_fn(args.renderer)
    if args.shard:
        from raytpu_torch.parallel import multihost, render_image_sharded, sharding

        try:
            px, prim = (int(x) for x in args.shard.lower().split("x"))
            multihost.initialize(args.dist_init, px * prim, args.rank)
            if args.device == "cpu":  # ranks on one host split its cores
                torch.set_num_threads(max(1, (os.cpu_count() or 1) // (px * prim)))
            mesh = multihost.pod_mesh(prim)
        except ValueError as e:
            print(f"error: --shard must be PXxPRIM over PX*PRIM ranks, each given --dist-init "
                  f"and --rank ({e})", file=sys.stderr)
            return 2
        render_fn = functools.partial(render_image_sharded, mesh=mesh)
        # the supersampled grid is a larger ray grid for the px axis
        render_f32 = functools.partial(sharding.render_pixels_sharded, mesh=mesh)
        backend = f"shard({px}x{prim})"
    if args.ssaa > 1:
        render_fn = functools.partial(renderer.render_image_ssaa, samples=args.ssaa,
                                      render_fn=render_f32)
    spec = scenes.get(args.scene)
    scene = spec.build(args.device)
    dev = scene.device
    print(f"raytpu_torch: scene={args.scene} {w}x{h} mode={args.mode} "
          f"shadows={config.shadows} soft={config.soft_shadows} device={args.device} "
          f"backend={backend} ssaa={args.ssaa}")

    def frame(t):
        # the time filled on the device: a copy from the host would wait for
        # every queued frame (math3d.scalar)
        return render_fn(spec.animate(scene, math3d.scalar(t, dev)), config)

    # warm-up: builds the kernels on first use; .cpu() waits for the frame
    t0 = time.perf_counter()
    img = frame(args.time).cpu().numpy()
    warm_s = time.perf_counter() - t0
    print(f"build+first frame: {warm_s:.2f}s")

    K = args.frames_per_dispatch
    timer = FrameTimer()
    bench = Benchmark(args.benchmark) if args.benchmark else None
    if bench:
        print(f"**BENCHMARK STARTED ({args.benchmark} samples)**")
        bench.start()
    stats = RayStats()
    n_frames = max(args.frames, 1)
    dispatches = 0
    # per-frame wall estimate for the animation times inside a dispatch,
    # clamped like the reference's elapsed upper bound (source/Timer.cpp:83-89)
    dt_est = min(warm_s, 0.5)
    done = False
    while not done:
        t = np.float32(args.time + timer.total)
        # the frames this dispatch renders: a tail dispatch renders only the
        # frames still due (a benchmark renders and counts whole dispatches)
        j = K if bench else min(K, n_frames - stats.frames)
        ft0 = time.perf_counter()
        for i in range(j):  # enqueued back to back, no host read between them
            out = frame(float(t + np.float32(dt_est) * np.float32(i)))
        img = out.cpu().numpy()  # the dispatch's one host read: its last frame
        dispatches += 1
        dt_est = (time.perf_counter() - ft0) / j
        for _ in range(j):
            timer.tick()
            stats.add_frame(w, h, scene.lights.count, dt_est, config.shadows)
            if timer.fps_window_closed:
                if args.watch:
                    print(f"dFPS: {timer.dfps:.1f}  "
                          f"({stats.primary_rays_per_s / 1e6:.1f} M primary rays/s)")
                if bench and bench.record(timer.dfps):
                    print("**BENCHMARK FINISHED**")
                    print(bench.report(), end="")
                    bench.write(args.benchmark_out)
                    done = True  # the dispatch's other frames are counted too
        if not bench and stats.frames >= n_frames:
            done = True

    print(f"frames={stats.frames} dispatches={dispatches} "
          f"avg_ms={1e3 * stats.seconds / max(stats.frames, 1):.2f} "
          f"primary_rays/s={stats.primary_rays_per_s:.3e} total_rays/s={stats.total_rays_per_s:.3e}")
    if args.screenshot and (not args.shard or args.rank == 0):
        image_io.write_image(args.screenshot, img)
        print(f"screenshot saved: {args.screenshot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
