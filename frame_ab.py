"""Frame times of raytpu_torch's routes, with host-to-device copies per frame,
for comparing two trees of the repo on one CUDA card.

    python3 frame_ab.py            # from the root of a tree; prints one JSON line

It times animated 640x480 frames through ``render_image`` with CUDA events,
as ``chip_smoke.py`` phase 4 does: reference (64 frames), optional (16) and
bunny50k (4), and, where the tree's ``chip_smoke.py`` builds them, the
chunked route's fixtures optional_l12 (16), bunny18k_l12 (4) and
reference_s106 (16).  For each it counts, under torch.profiler, the
``Memcpy HtoD`` activities of one frame: each copies from pageable host
memory and so waits for every kernel queued before it.

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
    built = {n: scenes.get(n).build(dev) for n in ("reference", "optional", "bunny50k")}
    cases = [("reference", "reference", 64), ("optional", "optional", 16),
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
    out = {"tree": os.path.basename(os.getcwd())}
    for name, base, frames in cases:
        spec, scene = scenes.get(base), built[name]
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)
        i = [0]

        def frame():
            render_image(spec.animate(scene, ts[i[0] % frames]), cfg)
            i[0] += 1

        ms = device_ms(frame, iters=frames, warmup=2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            frame()
            torch.cuda.synchronize()
        h2d = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy HtoD"))
        out[name] = {"frame_ms": ms, "h2d_per_frame": h2d}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
