"""Drive raytpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each passes or raises; nothing is caught):
  0. environment: the card's name and power limit, torch and CUDA versions;
  1. build every kernel from raytpu_torch/render/csrc with nvcc;
  2. each kernel against its plain PyTorch version on the card, on the cases
     the main path and the scenes give it, under the megakernel budget;
  3. the main path: 64 animated frames of the reference scene at 640x480
     through render_image, with the launch counts read around them; frames
     t=0 and t=1.25 against the committed goldens; the CLI once;
  4. times on the card (CUDA events) beside each kernel's bound.
The last line is {"ok": true, "device": {...}}; it prints only if every phase
passed.  Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
W, H = 640, 480
FRAMES = 64

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def close_u8(a: np.ndarray, b: np.ndarray, budget: float, mean_max: float):
    """(flip fraction, mean abs diff): pixels differing by more than one u8
    step in some channel, as tests/test_pallas.py:_close and
    tests/test_golden.py:_check_golden count them."""
    d = np.abs(a.astype(int) - b.astype(int))
    flips = float((d > 1).any(axis=-1).mean())
    mean = float(d.mean())
    if flips > budget or mean > mean_max:
        raise AssertionError(f"{flips:.4%} pixels flipped (budget {budget:.2%}), "
                             f"mean abs diff {mean:.4f} (max {mean_max})")
    return flips, mean


def phase_env() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"nvidia_smi": smi.splitlines()[0]}


def phase_build() -> None:
    from raytpu_torch.render import build

    seconds = build.build(force=True)
    ptxas = [ln.strip() for ln in build.last_build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    print(f"phase 1: built {build.LIB_NAME} in {seconds:.2f}s: " + " | ".join(ptxas))


def _directional_scene(device):
    from raytpu_torch.core.types import SceneBuilder

    b = SceneBuilder()
    lam = b.add_lambert((0.8, 0.7, 0.6), 1.0)
    floor = b.add_lambert((0.4, 0.45, 0.5), 1.0)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), floor)
    b.add_sphere((0.0, 0.0, 4.0), 1.0, lam)
    b.add_directional_light((0.3, -1.0, 0.2), 2.5, (1.0, 0.95, 0.9))
    b.set_camera((0.0, 0.5, -2.0), fov_degrees=50.0)
    return b.build(device)


def phase_compare(dev) -> dict:
    """K1 against its plain version on the card, under the megakernel budget
    (tests/test_pallas.py:31-35: <=1% of pixels off by more than one u8
    step, mean abs diff <=0.5).  Not exact: the two round alike op for op,
    but powf and the plain version's pow may differ in the last bit, and a
    near-tie decides a closest hit or a shadow differently on a boundary."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import LightingMode, RenderConfig
    from raytpu_torch.render import cuda_kernel as ck

    ref = scenes.get("reference")
    ref_scene = ref.build(dev)
    full = RenderConfig(width=W, height=H)
    cases = [(f"reference {m.name.lower()}", ref_scene, RenderConfig(width=W, height=H, lighting_mode=m))
             for m in LightingMode]
    cases += [
        ("reference no shadows", ref_scene, RenderConfig(width=W, height=H, shadows=False)),
        ("reference t=1.25", ref.animate(ref_scene, 1.25), full),
        ("w2", scenes.get("w2").build(dev), full),
        ("w3_test", scenes.get("w3_test").build(dev), full),
        ("w1 (no lights)", scenes.get("w1").build(dev), full),
        ("directional light", _directional_scene(dev), full),
        ("reference 50x37", ref_scene, RenderConfig(width=50, height=37)),
    ]
    worst = {"max_abs_diff": 0.0, "flip_frac": 0.0}
    for name, scene, cfg in cases:
        a = ck.render_image_mega_f32(scene, cfg)
        b = ck.render_image_mega_f32_plain(scene, cfg)
        torch.cuda.synchronize()
        if a.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: kernel output {tuple(a.shape)} is not finite (H, W, 3)")
        diff = float((a - b).abs().max())
        flips, mean = close_u8(math3d.quantize_u8(a).cpu().numpy(),
                               math3d.quantize_u8(b).cpu().numpy(), 0.01, 0.5)
        print(f"phase 2: {name:24s} max|f32 diff| {diff:.3e}  flips {flips:.5f}  mean {mean:.5f}")
        worst["max_abs_diff"] = max(worst["max_abs_diff"], diff)
        worst["flip_frac"] = max(worst["flip_frac"], flips)
    return worst


def phase_main_path(dev) -> dict:
    from raytpu_torch.app import cli
    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import render_image
    from raytpu_torch.utils import image as image_io

    spec = scenes.get("reference")
    scene = spec.build(dev)
    config = RenderConfig(width=W, height=H)
    ts = torch.linspace(0.0, 2.0 * np.pi, FRAMES, device=dev)  # as bench.py:92
    first = None
    ck.MEGA_LAUNCHES = 0
    for i in range(FRAMES):
        img = render_image(spec.animate(scene, ts[i]), config)
        first = img if i == 0 else first
    torch.cuda.synchronize()
    launches = ck.MEGA_LAUNCHES
    if launches != FRAMES:
        raise AssertionError(f"{FRAMES} frames launched the megakernel {launches} times")
    if img.shape != (H, W, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"frame is {tuple(img.shape)} {img.dtype}")
    # golden budget (tests/test_golden.py:16-24): <=0.2% flipped, mean <=0.1
    g0 = close_u8(first.cpu().numpy(), image_io.read_png(str(GOLDEN / "reference_640x480.png")),
                  0.002, 0.1)
    t125 = render_image(spec.animate(scene, 1.25), config).cpu().numpy()
    g1 = close_u8(t125, image_io.read_png(str(GOLDEN / "reference_t1.25_640x480.png")), 0.002, 0.1)
    print(f"phase 3: {FRAMES} frames, {launches} megakernel launches; golden t=0 flips "
          f"{g0[0]:.5f} mean {g0[1]:.5f}; t=1.25 flips {g1[0]:.5f} mean {g1[1]:.5f}")
    with tempfile.TemporaryDirectory() as tmp:
        shot = Path(tmp) / "shot.png"
        rc = cli.main(["--scene", "reference", "--size", f"{W}x{H}", "--frames", "4",
                       "--screenshot", str(shot)])
        if rc != 0 or image_io.read_png(str(shot)).shape != (H, W, 3):
            raise AssertionError(f"CLI returned {rc} or wrote no {W}x{H} screenshot")
    return {"frames": FRAMES, "launches": launches, "golden_t0": g0, "golden_t1.25": g1}


# FP32 operations (add, sub, mul, div, sqrt, pow, min/max, abs) of one call of
# each piece of mega.cu, counted from its source.  Comparisons and selects are
# not counted, nor the few operations of a closest-hit winner's update, so
# the operation bound is a slight underestimate: still a lower bound.
OPS_RAYGEN = 32
OPS_SPHERE, OPS_PLANE, OPS_TRI, OPS_TRI_SHADOW = 18, 12, 53, 54
OPS_HIT = 6 + 6 + 3 + 2  # hit point, offset point, shadow dim, tonemap max
OPS_SPHERE_NORMAL = 10
OPS_LIGHT_POINT, OPS_LIGHT_DIR = 12, 0
OPS_SHADE_BASE = {0: 6, 1: 0, 2: 6, 3: 6}  # ndl + oa; RADIANCE needs only the radiance
OPS_RADIANCE = 9
OPS_BRDF = {0: 0, 1: 6, 2: 24}  # solid, Lambert, Lambert+Phong
OPS_CT, OPS_CT_DIELECTRIC, OPS_CT_METAL = 63, 24, 15
OPS_COMBINED = 9
OPS_ACCUMULATE = 3


def count_ops(scene, config) -> float:
    """FP32 operations mega.cu does on this frame's data: the closest-hit
    tests of every ray, and for each hit ray the shadow tests up to its first
    occluder and the shading of each lit light.  The per-ray decisions come
    from the eager path (raytpu_torch.ops) on the same data."""
    from raytpu_torch.ops import intersect
    from raytpu_torch.render.renderer import generate_rays, shadow_query_inputs

    S, P, T, L = scene.spheres.count, scene.planes.count, scene.triangles.count, scene.lights.count
    R = config.width * config.height
    ops = R * (OPS_RAYGEN + S * OPS_SPHERE + P * OPS_PLANE + T * OPS_TRI)
    ro, rd = generate_rays(scene.camera, config)
    ro = ro.expand_as(rd)
    tmat = intersect.scene_t_matrix(scene, ro, rd, config.ray_min, math.inf, shadow_pass=False)
    idx = torch.argmin(tmat, dim=1)
    rec = intersect.closest_hit(scene, ro, rd, config.ray_min)
    hit = rec.hit
    n_hit = int(hit.sum())
    ops += n_hit * OPS_HIT + int((hit & (idx < S)).sum()) * OPS_SPHERE_NORMAL
    kind = scene.materials.kind[rec.material.long()]
    metal = scene.materials.params[rec.material.long(), 0] != 0.0
    mode = int(config.lighting_mode)
    brdf_ops = torch.zeros_like(idx, dtype=torch.float64)
    for k, v in OPS_BRDF.items():
        brdf_ops[kind == k] = v
    brdf_ops[kind == 3] = OPS_CT + OPS_CT_DIELECTRIC
    brdf_ops[(kind == 3) & metal] = OPS_CT + OPS_CT_METAL
    shadow_cost = torch.tensor([OPS_SPHERE] * S + [OPS_PLANE] * P + [OPS_TRI_SHADOW] * T,
                               dtype=torch.float64, device=rd.device).cumsum(0)
    p_off, dirs, mags = shadow_query_inputs(scene, rec, config)
    for li in range(L):
        is_point = int(scene.lights.kind[li]) == 0
        ops += n_hit * (OPS_LIGHT_POINT if is_point else OPS_LIGHT_DIR)
        lit = torch.ones_like(hit)
        if config.shadows and S + P + T:
            smat = intersect.scene_t_matrix(scene, p_off, dirs[li], config.ray_min, mags[li],
                                            shadow_pass=True)
            occ = torch.isfinite(smat)
            first = torch.where(occ.any(dim=1), occ.to(torch.int8).argmax(dim=1), S + P + T - 1)
            ops += float(shadow_cost[first][hit].sum())
            lit = ~occ.any(dim=1)
        shaded = hit & lit
        n_sh = int(shaded.sum())
        per = OPS_SHADE_BASE[mode] + OPS_ACCUMULATE
        if mode in (1, 3) and is_point:
            per += OPS_RADIANCE
        if mode == 1:
            per += 3
        ops += n_sh * per
        if mode in (2, 3):
            ops += float(brdf_ops[shaded].sum()) + (n_sh * OPS_COMBINED if mode == 3 else 0)
    return float(ops)


def frame_breakdown(frame, n: int):
    """(device activities per frame, device-busy ms per frame) over ``n``
    calls of ``frame`` under torch.profiler, or (None, None) when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            frame()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None
    return len(dev) / n, sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n


def phase_times(dev, env: dict, worst: dict, main: dict) -> None:
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import render_image
    from raytpu_torch.utils.profiling import device_ms

    spec = scenes.get("reference")
    scene = spec.build(dev)
    config = RenderConfig(width=W, height=H)
    buf, counts = ck.mega_pack(scene, config)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    kernel_ms = device_ms(lambda: ck.launch_mega(buf, counts, config, out), iters=200, warmup=10)
    ts = torch.linspace(0.0, 2.0 * np.pi, FRAMES, device=dev)
    frame_i = [0]

    def frame():
        render_image(spec.animate(scene, ts[frame_i[0] % FRAMES]), config)
        frame_i[0] += 1

    frame_ms = device_ms(frame, iters=FRAMES, warmup=4)
    acts, busy_ms = frame_breakdown(frame, 8)
    idle = None if busy_ms is None else 1.0 - busy_ms / frame_ms
    plain_ms = device_ms(lambda: math3d.quantize_u8(ck.render_image_mega_f32_plain(scene, config)),
                         iters=5, warmup=1)
    ops = count_ops(scene, config)
    nbytes = buf.numel() * 4 + out.numel() * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    rays_per_s = W * H / (frame_ms / 1e3)
    print(f"phase 4: kernel {kernel_ms:.4f} ms, frame {frame_ms:.4f} ms "
          f"({rays_per_s:.4e} primary rays/s), plain {plain_ms:.3f} ms; "
          f"{ops:.4e} FP32 ops -> {ops_ms:.4f} ms at 67 TFLOP/s, {nbytes} B -> "
          f"{bytes_ms:.6f} ms at 3.35 TB/s ({env['nvidia_smi']}); per frame {acts} device "
          f"activities, busy {busy_ms} ms, idle share {idle}")
    kernel = {
        "name": "mega", "id": "K1", "route": "cuda",
        "source": "raytpu_torch/render/csrc/mega.cu",
        "replaces": "raytpu/render/pallas_kernel.py:879",
        "launches": main["launches"],
        "max_abs_err": worst["max_abs_diff"], "max_abs_diff": worst["max_abs_diff"],
        "flip_frac": worst["flip_frac"],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "ops": ops, "bytes": nbytes,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"main_path": {
        "scene": "reference", "size": f"{W}x{H}", "frames": FRAMES, "launches": main["launches"],
        "kernel_ms": kernel_ms, "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
        "plain_ms": plain_ms, "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
        "device_idle_share": idle, "golden_t0": main["golden_t0"],
        "golden_t1.25": main["golden_t1.25"], "card": env["nvidia_smi"]}}))


def main() -> int:
    t0 = time.perf_counter()
    env = phase_env()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    worst = phase_compare(dev)
    main_path = phase_main_path(dev)
    phase_times(dev, env, worst, main_path)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s "
          f"on {env['nvidia_smi']}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
