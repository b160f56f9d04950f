"""Frame times of raytpu_torch's routes, with host-to-device copies per frame,
for comparing two trees of the repo on one CUDA card.

    python3 frame_ab.py            # from the root of a tree; prints one JSON line

It times animated 640x480 frames through ``render_image`` with CUDA events,
as ``chip_smoke.py`` phase 4 does: reference (64 frames), bunny and
optional (16) and bunny50k (4), and, where the tree's ``chip_smoke.py``
builds them, the chunked route's fixtures optional_l12 (16), bunny18k_l12
(4) and reference_s106 (16); each REPEATS times, with the median, the
least and the most.  For each it counts, under torch.profiler, the
``Memcpy HtoD`` activities of one frame: each copies from pageable host
memory and so waits for every kernel queued before it.  Then it times
optional's material train step at 640x480 (chip_smoke.py's first grad
path: SGD, payload_grad True) on the host clock to a synchronize, STEPS
steps REPEATS times.

An A/B compares two trees in one call on one card, in turns, with the
other tree unpacked under ``_work/`` (``git archive <commit> | tar -x -C
_work/parent``):

    for t in _work/parent . . _work/parent; do (cd $t && python3 $OLDPWD/frame_ab.py); done
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())


REPEATS = 5
STEPS = 8


def _spread(xs: list) -> dict:
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1], "all": xs}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import render_image
    from raytpu_torch.utils.profiling import device_ms

    if not torch.cuda.is_available():
        print("frame_ab: this needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = RenderConfig()
    built = {n: scenes.get(n).build(dev) for n in ("reference", "bunny", "optional", "bunny50k")}
    cases = [("reference", "reference", 64), ("bunny", "bunny", 16), ("optional", "optional", 16),
             ("bunny50k", "bunny50k", 4)]
    try:
        import chip_smoke as cs
    except ImportError:
        cs = None
    if hasattr(cs, "nine_lights"):
        built["optional_l12"] = cs.nine_lights(built["optional"])
        built["bunny18k_l12"] = cs.nine_lights(scenes.scene_bunny_subdiv(3, device=dev))
        built["reference_s106"] = cs.sphere_grid(built["reference"])
        cases += [("optional_l12", "optional", 16), ("bunny18k_l12", "bunny", 4),
                  ("reference_s106", "reference", 16)]
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"tree": os.path.basename(os.getcwd()), "card": smi}
    for name, base, frames in cases:
        spec, scene = scenes.get(base), built[name]
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)
        i = [0]

        def frame():
            render_image(spec.animate(scene, ts[i[0] % frames]), cfg)
            i[0] += 1

        ms = [device_ms(frame, iters=frames, warmup=2) for _ in range(REPEATS)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            frame()
            torch.cuda.synchronize()
        h2d = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy HtoD"))
        out[name] = {"frame_ms": _spread(ms), "h2d_per_frame": h2d}
    out["optional_material_step_ms"] = _spread(_material_steps(built["optional"], dev))
    print(json.dumps(out), flush=True)
    return 0


def _material_steps(scene, dev) -> list:
    """ms per step of REPEATS runs of STEPS material train steps."""
    import time

    import torch

    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render as dr

    cfg = RenderConfig()
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    params = dr.trainable(dr.material_params(scene))
    step = dr.make_train_step(cfg, torch.optim.SGD(params.values(), lr=1e-2),
                              dr.merge_material_params, payload_grad=True)
    step(params, scene, target)  # the first step, not counted
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(params, scene, target)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / STEPS)
    return out


if __name__ == "__main__":
    sys.exit(main())
