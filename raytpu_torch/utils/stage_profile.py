"""Per-stage timing of a frame: the pipeline's cumulative prefixes (raygen |
+closest hit | +shadow | full frame), each run over animated frames and
reduced to one scalar that is read back, then differenced into per-stage
times.

Counterpart of ``raytpu/utils/stage_profile.py``, with its report keys and
format.  raytpu jits each prefix and scans K frames per dispatch; here each
prefix runs ``frames`` animated frames back to back, timed on the card with
CUDA events (on the host clock for a scene on the CPU), best of
``repeats``.  ``kernels=True`` takes K8 for the closest hit and K9 for the
shadows (``render/chunked.py``) and the router for the full frame
(``render/cuda_kernel.py``), as raytpu's ``pallas=True`` takes
``closest_hit_pallas``, ``any_hit_lights_pallas`` and its router;
``kernels=False`` takes the eager path.

Usage:
    from raytpu_torch.utils.stage_profile import format_report, profile_stages
    print(format_report(profile_stages(spec, scene, config)))
"""

from __future__ import annotations

import math
import time

import torch

STAGES = ("raygen", "closest_hit", "shadow", "shade")


def _finite_sum(x):
    return torch.where(torch.isfinite(x), x, 0.0).sum(dtype=torch.float32)


def prefix_fns(config, kernels: bool) -> dict:
    """The cumulative prefixes, keyed by their last stage: each takes a scene
    and returns a 0-dim float32 tensor."""
    from raytpu_torch.ops import intersect
    from raytpu_torch.render import chunked, cuda_kernel, renderer

    if kernels:
        closest_fn, full_fn = chunked.closest_hit_chunked, cuda_kernel.render_image_f32
        any_lights = chunked.any_hit_lights_chunked
    else:
        closest_fn, full_fn = intersect.closest_hit, renderer.render_image_f32

        def any_lights(scene, p, dirs, mags, tmin):
            return torch.stack([intersect.any_hit(scene, p, dirs[li], tmin, mags[li])
                                for li in range(dirs.shape[0])])

    def records(scene):
        ro, rd = renderer.generate_rays(scene.camera, config)
        return closest_fn(scene, ro.expand_as(rd), rd, config.ray_min)

    def raygen(scene):
        return _finite_sum(renderer.generate_rays(scene.camera, config)[1])

    def closest(scene):
        rec = records(scene)
        return _finite_sum(rec.t) + _finite_sum(rec.normal)

    def shadow(scene):
        rec = records(scene)
        p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, config)
        if dirs is None:
            return _finite_sum(rec.t)
        occ = any_lights(scene, p_off, dirs, mags, config.ray_min)
        return _finite_sum(rec.t) + occ.sum(dtype=torch.float32)

    def full(scene):
        return _finite_sum(full_fn(scene, config))

    return {"raygen": raygen, "closest_hit": closest, "shadow": shadow, "shade": full}


def _time_fn(fn, spec, scene, frames: int, repeats: int) -> float:
    """Best-of-repeats seconds per frame of ``fn`` over animated frames,
    ``spec.animate`` varying the scene per frame; the frames' summed scalar
    is read back."""
    ts = torch.linspace(0.0, 2.0 * math.pi, frames, device=scene.device)

    def run():
        total = torch.zeros((), dtype=torch.float32, device=scene.device)
        for i in range(frames):
            total = total + fn(spec.animate(scene, ts[i]))
        return total

    float(run())  # warm
    best = float("inf")
    for _ in range(repeats):
        if scene.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            total = run()
            end.record()
            float(total)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            float(run())
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / frames


def profile_stages(spec, scene, config, *, kernels: bool = True, frames: int = 16,
                   repeats: int = 3) -> dict:
    """Per-stage ms per frame and rays/s of ``scene`` (built, on its device)
    animated by ``spec.animate``: raytpu's report, with the device it was
    measured on."""
    fns = prefix_fns(config, kernels)
    cum = {name: _time_fn(fn, spec, scene, frames, repeats) for name, fn in fns.items()}
    n_rays = config.width * config.height
    n_shadow = n_rays * scene.lights.count if config.shadows else 0
    stage_s, prev = {}, 0.0
    for name in STAGES:
        stage_s[name] = max(cum[name] - prev, 0.0)
        prev = max(cum[name], prev)

    def rate(n, s):
        return n / s if s else float("inf")

    return {
        "frame_ms": cum["shade"] * 1e3,
        "stages_ms": {k: v * 1e3 for k, v in stage_s.items()},
        "cumulative_ms": {k: v * 1e3 for k, v in cum.items()},
        "primary_rays_per_s": n_rays / cum["shade"] if cum["shade"] else 0.0,
        "stage_rays_per_s": {"closest_hit": rate(n_rays, stage_s["closest_hit"]),
                             "shadow": rate(n_shadow, stage_s["shadow"])},
        "device": (torch.cuda.get_device_name(scene.device) if scene.device.type == "cuda"
                   else str(scene.device)),
    }


def format_report(report: dict) -> str:
    lines = [f"frame: {report['frame_ms']:.2f} ms  "
             f"({report['primary_rays_per_s'] / 1e6:.1f} M primary rays/s)"]
    for k, v in report["stages_ms"].items():
        rps = report["stage_rays_per_s"].get(k)
        extra = f"  ({rps / 1e6:.1f} M rays/s)" if rps and math.isfinite(rps) else ""
        lines.append(f"  {k:<12} {v:8.2f} ms{extra}")
    return "\n".join(lines)
