"""Geometry fitting on raytpu_torch: recover mesh vertex positions from a
target image.

Renders a ground-truth image of the bunny scene, perturbs the mesh's vertex
positions with noise, then optimizes them back with Adam through the
differentiable renderer: gradients flow through the detached closest hit
(the winning triangle re-derived with autograd) and through the soft-shadow
transmittance.  On a card the bunny's 292 triangles take the kernels
(``grad/diff_render.py``): K3's winner search and K5's transmittance
forward, K6 (the rays' VJP) and K7 (the triangles' VJP, these vertex
cotangents) backward.  The port's counterpart of
``examples/geometry_fit.py``: the same flags, defaults, noise and printed
lines, ``--device`` in place of ``--platform``.

Usage: python examples/torch_geometry_fit.py [--steps 120] [--size 96x72]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root


def with_positions(s, prm):
    """``s`` with the mesh vertices ``prm["positions"]`` (face normals refreshed)."""
    return s.with_meshes(s.meshes.with_positions(prm["positions"]))


def run(argv=None) -> dict:
    """The example; returns its exit code (``rc``: 0 when the image loss at
    least halves), the losses of every step and the vertex RMSEs, for
    callers that check more than the printed lines."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--size", default="96x72")
    p.add_argument("--noise", type=float, default=0.15)
    p.add_argument("--out", default="geometry_fit.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render
    from raytpu_torch.utils.image import write_png

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; pass --device cpu",
              file=sys.stderr)
        return {"rc": 2}
    w, h = (int(x) for x in args.size.lower().split("x"))
    # a gentler sigmoid than the default: wider shadow-edge support gives the
    # vertex gradients a larger basin of attraction
    cfg = RenderConfig(width=w, height=h, soft_shadows=True, soft_beta=60.0)
    truth = scenes.get("bunny").build(args.device)
    with torch.no_grad():
        target = diff_render.render_soft(truth, cfg)

    rng = np.random.default_rng(0)
    truth_pos = truth.meshes.positions
    noise = torch.as_tensor(rng.normal(0.0, args.noise, tuple(truth_pos.shape)),
                            dtype=torch.float32, device=truth_pos.device)
    start_positions = truth_pos + noise

    params = diff_render.trainable({"positions": start_positions})
    opt = torch.optim.Adam(params.values(), lr=5e-3)
    step = diff_render.make_train_step(cfg, opt, with_positions)

    with torch.no_grad():
        start_img = diff_render.render_soft(with_positions(truth, params), cfg)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        loss = step(params, truth, target)
        losses.append(float(loss))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    dt = time.time() - t0
    loss0, final_loss = losses[0], losses[-1]
    positions = params["positions"].detach()
    vert_rmse0 = float(torch.sqrt(torch.mean((start_positions - truth_pos) ** 2)))
    vert_rmse = float(torch.sqrt(torch.mean((positions - truth_pos) ** 2)))
    print(f"{args.steps} steps in {dt:.1f}s | image loss {loss0:.6f} -> {final_loss:.6f} "
          f"| vertex RMSE {vert_rmse0:.4f} -> {vert_rmse:.4f}")

    with torch.no_grad():
        final_img = diff_render.render_soft(with_positions(truth, params), cfg)
    strip = np.concatenate([x.cpu().numpy() for x in (target, start_img, final_img)], axis=1)
    write_png(args.out, (np.clip(strip, 0.0, 1.0) * 255).astype(np.uint8))
    print(f"wrote {args.out} (target | start | recovered)")
    return {"rc": 0 if final_loss < loss0 * 0.5 else 1, "losses": losses,
            "vertex_rmse": (vert_rmse0, vert_rmse)}


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
