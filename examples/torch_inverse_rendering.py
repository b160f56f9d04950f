"""Inverse rendering on raytpu_torch: recover scene parameters from a target
image.

Renders a ground-truth image of the w3_test scene, perturbs the material
colors and both lights' positions, then optimizes them back with Adam
through the differentiable renderer (soft shadows).  Saves a 3-panel strip
(target | start | recovered).  The port's counterpart of
``examples/inverse_rendering.py``: the same flags, defaults, perturbation
and printed lines, ``--device`` in place of ``--platform``.  w3_test has
spheres and planes only, so each step runs the eager soft path.

Usage: python examples/torch_inverse_rendering.py [--steps 200] [--size 96x72]
       [--device cpu] [--checkpoint-dir DIR --checkpoint-every 50]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

#: the perturbation of the first two lights' positions (the JAX example's)
LIGHT_OFFSETS = [[1.5, -1.0, 0.5], [-1.0, 0.5, 1.0]]


def setup(size: str, device: str):
    """(config, truth, target image, perturbed scene) of the example."""
    import torch

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render

    w, h = (int(x) for x in size.lower().split("x"))
    cfg = RenderConfig(width=w, height=h, soft_shadows=True, soft_beta=60.0)
    truth = scenes.get("w3_test").build(device)
    with torch.no_grad():
        target = diff_render.render_soft(truth, cfg)

    # perturb: wrong albedos + wrong light positions, from the JAX example's draws
    rng = np.random.default_rng(0)
    color = truth.materials.color
    noise = torch.as_tensor(rng.uniform(-0.5, 0.5, tuple(color.shape)), dtype=torch.float32,
                            device=color.device)
    bad_mats = dataclasses.replace(truth.materials, color=torch.clamp(color + noise, 0.05, 1.0))
    offsets = torch.as_tensor(LIGHT_OFFSETS, dtype=torch.float32, device=color.device)
    bad_lights = dataclasses.replace(truth.lights, position=truth.lights.position + offsets)
    broken = dataclasses.replace(truth, materials=bad_mats, lights=bad_lights)
    return cfg, truth, target, broken


def params_of(s):
    return {"color": s.materials.color, "light_pos": s.lights.position}


def merge(s, prm):
    mats = dataclasses.replace(s.materials, color=prm["color"])
    lights = dataclasses.replace(s.lights, position=prm["light_pos"])
    return dataclasses.replace(s, materials=mats, lights=lights)


def run(argv=None) -> dict:
    """The example; returns its exit code (``rc``), the step it resumed from
    (``start_step``), the first and final losses of this run and the
    parameter errors, for callers that check more than the printed lines."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--size", default="96x72")
    p.add_argument("--out", default="inverse_rendering.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--checkpoint-dir", default=None,
                   help="save/resume optimization state under this directory")
    p.add_argument("--checkpoint-every", type=int, default=50)
    args = p.parse_args(argv)

    import torch

    from raytpu_torch.grad import diff_render
    from raytpu_torch.utils.image import write_png

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch finds no CUDA device; pass --device cpu",
              file=sys.stderr)
        return {"rc": 2}
    cfg, truth, target, broken = setup(args.size, args.device)
    with torch.no_grad():
        start_img = diff_render.render_soft(broken, cfg)

    params = diff_render.trainable(params_of(broken))
    opt = torch.optim.Adam(params.values(), lr=2e-2)
    step = diff_render.make_train_step(cfg, opt, merge)

    mgr = None
    start_step = 0
    if args.checkpoint_dir:
        from raytpu_torch.utils.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        resumed, state = mgr.restore_latest(like={"params": params, "opt_state": opt.state_dict()})
        if resumed is not None:
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(state["params"][k])
            opt.load_state_dict(state["opt_state"])
            start_step = resumed
            print(f"resumed from checkpoint step {start_step}")

    t0 = time.perf_counter()
    loss = float("nan")
    losses = []
    for i in range(start_step, args.steps):
        loss = step(params, broken, target)
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d}  loss {float(loss):.6f}")
        if mgr and (i + 1) % args.checkpoint_every == 0:
            mgr.save_step(i + 1, {"params": {k: v.detach() for k, v in params.items()},
                                  "opt_state": opt.state_dict()})
    print(f"final loss {float(loss):.6f} in {time.perf_counter()-t0:.1f}s")

    with torch.no_grad():
        recovered = diff_render.render_soft(merge(broken, params), cfg)
    strip = np.concatenate([x.cpu().numpy() for x in (target, start_img, recovered)], axis=1)
    write_png(args.out, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out} (target | start | recovered)")

    err_color = float((params["color"].detach() - truth.materials.color).abs().max())
    err_light = float((params["light_pos"].detach() - truth.lights.position).abs().max())
    print(f"max param error: color {err_color:.3f}, light position {err_light:.3f}")
    return {"rc": 0, "start_step": start_step, "losses": losses, "err_color": err_color,
            "err_light": err_light}


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
