"""The interactive viewer: a window with the reference's controls
(reference: source/main.cpp:23-121).

Counterpart of ``raytpu/app/interactive.py``.  Key bindings, as the
reference's:
  X   screenshot -> RayTracing_Buffer.bmp (reference: source/main.cpp:70-71)
  F2  toggle shadows                       (reference: source/main.cpp:73-74)
  F3  cycle lighting mode                  (reference: source/main.cpp:76-77)
  F6  start a 10-sample FPS benchmark      (reference: source/main.cpp:79-81)
  WASD / arrows + Shift, mouse LMB / RMB   fly camera (reference: source/Camera.h:68-106)
  ESC quit

The window is pygame's (SDL), imported inside ``main``; frames render on the
CUDA card by default.  ``FramePipeline`` double-buffers the dispatch: frame
N + 1 is enqueued before frame N is shown (one frame of input latency;
``--sync`` turns it off).  Run headless with SDL_VIDEODRIVER=dummy.

Usage: python -m raytpu_torch.app.interactive --scene reference --size 640x480
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from raytpu_torch.core import math3d, scenes
from raytpu_torch.core.camera import CameraInput, FlyCamera
from raytpu_torch.core.types import LightingMode, RenderConfig
from raytpu_torch.utils.profiling import Benchmark, FrameTimer


class FramePipeline:
    """Double-buffered frame dispatch.  ``step(scene, config)`` enqueues
    frame N + 1 and hands back frame N as a uint8 numpy array.

    Right after a frame's kernels are enqueued, its copy into a fresh pinned
    host buffer is enqueued with ``non_blocking=True`` and an event recorded
    behind it; a step waits on the previous frame's event only.  (A plain
    ``.cpu()`` of frame N after frame N + 1 was enqueued would wait for
    frame N + 1's kernels too, on the same stream: the pipeline would be
    synchronous without saying so.)  The first step has no frame in flight
    and hands back its own frame, which the second step hands back again.
    A frame rendered on the CPU takes the same order, without copies; with
    ``sync`` each step hands back its own frame.
    """

    def __init__(self, render_fn, sync: bool = False):
        self.render_fn = render_fn
        self.sync = sync
        self._in_flight = None  # (host frame, the event behind its copy or None)

    def step(self, scene, config) -> np.ndarray:
        img = self.render_fn(scene, config)
        if self.sync:
            return img.cpu().numpy()
        copied = None
        if img.device.type == "cuda":
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        else:
            host = img
        shown, self._in_flight = self._in_flight or (host, copied), (host, copied)
        if shown[1] is not None:
            shown[1].synchronize()
        return shown[0].numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytpu_torch.app.interactive", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default="reference", choices=sorted(scenes.REGISTRY))
    p.add_argument("--size", default="640x480")
    p.add_argument("--renderer", default="auto", choices=["auto", "eager", "kernel"])
    p.add_argument("--max-frames", type=int, default=0,
                   help="exit after N frames (0 = run until quit)")
    p.add_argument("--sync", action="store_true",
                   help="fetch each frame before dispatching the next (no double buffering)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the CUDA card (default) or, asked for, the CPU")
    args = p.parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"error: --size must be WxH (got {args.size!r})", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; "
              "pass --device cpu to render on the CPU", file=sys.stderr)
        return 2

    import pygame

    from raytpu_torch.app.cli import make_render_fn

    render_fn, _, backend = make_render_fn(args.renderer)
    spec = scenes.get(args.scene)
    scene = spec.build(args.device)
    dev = scene.device
    fov0 = float(np.arctan(float(scene.camera.fov_scale)) * 2 * 180 / np.pi)
    fly = FlyCamera(origin=tuple(scene.camera.origin.tolist()), fov_degrees=fov0)

    config = RenderConfig(width=w, height=h)
    pygame.init()
    screen = pygame.display.set_mode((w, h))
    pygame.display.set_caption(f"raytpu_torch - {args.scene} [{backend}]")

    timer = FrameTimer()
    bench = Benchmark(10)
    pipeline = FramePipeline(render_fn, sync=args.sync)
    frames = 0
    frame = None  # the frame on screen (None until the first render)
    print(f"raytpu_torch interactive: {args.scene} {w}x{h} backend={backend} device={args.device}")
    running = True
    while running:
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                running = False
            elif event.type == pygame.KEYDOWN:
                if event.key == pygame.K_ESCAPE:
                    running = False
                elif event.key == pygame.K_x:
                    if frame is None:
                        print("screenshot skipped: no frame rendered yet")
                    else:
                        from raytpu_torch.utils.image import write_bmp

                        write_bmp("RayTracing_Buffer.bmp", frame)
                        print("screenshot saved: RayTracing_Buffer.bmp")
                elif event.key == pygame.K_F2:
                    config = dataclasses.replace(config, shadows=not config.shadows)
                    print(f"shadows: {config.shadows}")
                elif event.key == pygame.K_F3:
                    config = dataclasses.replace(
                        config, lighting_mode=LightingMode((int(config.lighting_mode) + 1) % 4))
                    print(f"lighting mode: {config.lighting_mode.name}")
                elif event.key == pygame.K_F6:
                    print("**BENCHMARK STARTED**")
                    bench.start()

        keys = pygame.key.get_pressed()
        mouse_dx, mouse_dy = pygame.mouse.get_rel()
        buttons = pygame.mouse.get_pressed()
        inp = CameraInput(
            forward=keys[pygame.K_w] or keys[pygame.K_UP],
            backward=keys[pygame.K_s] or keys[pygame.K_DOWN],
            right=keys[pygame.K_d] or keys[pygame.K_RIGHT],
            left=keys[pygame.K_a] or keys[pygame.K_LEFT],
            shift=keys[pygame.K_LSHIFT] or keys[pygame.K_RSHIFT],
            mouse_dx=mouse_dx, mouse_dy=mouse_dy, lmb=buttons[0], rmb=buttons[2])
        fly = fly.update(inp, timer.elapsed)

        s = spec.animate(scene, math3d.scalar(timer.total, dev)).with_camera(fly.camera(dev))
        frame = pipeline.step(s, config)
        surf = pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
        screen.blit(surf, (0, 0))
        pygame.display.flip()

        timer.tick()
        frames += 1
        if timer.fps_window_closed:
            print(f"dFPS: {timer.dfps:.1f}")
            if bench.record(timer.dfps):
                print("**BENCHMARK FINISHED**")
                print(bench.report(), end="")
                bench.write("benchmark.txt")
        if args.max_frames and frames >= args.max_frames:
            running = False

    pygame.quit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
