"""Drive raytpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each passes or raises; nothing is caught):
  0. environment: the card's name and power limit, torch and CUDA versions;
  1. build every kernel from raytpu_torch/render/csrc with nvcc;
  2. each kernel against its plain PyTorch version on the card: K1 on the
     small scenes and the OBJ scene w4_test, K2a + K2b (the mega2 route) on
     bunny and optional, K3 and K4 (the packed route) on bunny50k's and
     bunny300k's camera rays at 640x480 (the main path's shapes), 160x128
     and 50x37, and the packed route against the eager path;
  3. the main paths, each with the launch counts set to 0 just before it and
     read just after: 64 animated frames of the reference scene at 640x480
     (K1) with frames t=0 and t=1.25 against the committed goldens, 16 of
     bunny and of optional (K2a, K2b), 4 of bunny50k and 2 of bunny300k
     (K3, K4), as bench.py counts them; the CLI once on reference and on
     optional;
  4. times on the card (CUDA events) of every kernel beside its bound, and
     of each scene's frame, with the device's idle share from torch.profiler.
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
#: the big-mesh main paths: scene, frames (bench.py:45-49), route
BIG_PATHS = [("bunny", 16, "mega2"), ("optional", 16, "mega2"), ("bunny50k", 4, "packed"),
             ("bunny300k", 2, "packed")]
#: K3's and K4's comparison sizes: the main path's frame, 160x128 (20 tiles
#: of 32x32 pixels) and a ragged untiled frame.  Each kernel launches on the
#: whole frame; the plain versions check every ray of a frame of up to
#: CMP_MAX_RAYS rays, and every CMP_TILE_STRIDE-th 1024-ray tile of a larger
#: one (30 of the main path's 300 tiles), which keeps their cost to seconds.
PACKED_CMP_SIZES = ((W, H), (160, 128), (50, 37))
CMP_MAX_RAYS = 32 * 1024
CMP_TILE_STRIDE = 10
#: the size at which the plain versions are timed and the packed route is
#: held against the eager path: the first that they see whole
PACKED_PLAIN_SIZE = PACKED_CMP_SIZES[1]
#: the kernels each route launches once per frame
ROUTE_KERNELS = {"mega": ["K1"], "mega2": ["K2a", "K2b"], "packed": ["K3", "K4"]}

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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import mega2, packed

    return {"K1": ck.MEGA_LAUNCHES, "K2a": mega2.MEGA2_CLOSEST_LAUNCHES,
            "K2b": mega2.MEGA2_SHADE_LAUNCHES, "K3": packed.PACKED_CLOSEST_LAUNCHES,
            "K4": packed.PACKED_ANYHIT_LAUNCHES}


def reset_launch_counts() -> None:
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import mega2, packed

    ck.MEGA_LAUNCHES = 0
    mega2.MEGA2_CLOSEST_LAUNCHES = mega2.MEGA2_SHADE_LAUNCHES = 0
    packed.PACKED_CLOSEST_LAUNCHES = packed.PACKED_ANYHIT_LAUNCHES = 0


def build_scenes(dev) -> dict:
    """Every scene of the main paths, built once on the card."""
    from raytpu_torch.core import scenes

    out = {}
    for name in ["reference"] + [n for n, _, _ in BIG_PATHS]:
        t0 = time.perf_counter()
        out[name] = scenes.get(name).build(dev)
        print(f"built {name}: {out[name].triangles.count} triangles in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    return out


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
        ("w4_test (OBJ)", scenes.get("w4_test").build(dev), full),
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


def _worst(worst: dict, diff: float, flips: float) -> None:
    worst["max_abs_diff"] = max(worst["max_abs_diff"], diff)
    worst["flip_frac"] = max(worst["flip_frac"], flips)


def _acc_diff(a, b):
    """(max |diff| over the entries finite in both, the row holding it,
    share of rays whose t or hit differs) between two K2a buffers (rows: t,
    normal xyz, material kind r g b p0 p1 p2)."""
    d = torch.where(torch.isfinite(a) & torch.isfinite(b), (a - b).abs(), 0.0)
    diff = float(d.max())
    row = int(d.amax(dim=1).argmax())
    t_a, t_b = a[0], b[0]
    differ = (torch.isfinite(t_a) != torch.isfinite(t_b)) | (
        torch.isfinite(t_b) & ((t_a - t_b).abs() > 1e-6 * t_b.abs()))
    return diff, row, float(differ.float().mean())


def phase_compare_mega2(dev, built: dict) -> dict:
    """K2a and K2b against their plain versions on bunny and optional at
    640x480 in the four lighting modes, without shadows, at t=1.25, and at
    50x37 (untiled, ragged).  K2a's buffer and boxes against the plain
    version's; K2b against its plain version on K2a's buffer; the route
    (K2a then K2b) against the plain route, under the megakernel budget."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import LightingMode, RenderConfig
    from raytpu_torch.render import mega2, plain

    worst = {k: {"max_abs_diff": 0.0, "flip_frac": 0.0} for k in ("K2a", "K2b", "route")}
    for name in ("bunny", "optional"):
        scene = built[name]
        cases = [(m.name.lower(), scene, RenderConfig(width=W, height=H, lighting_mode=m))
                 for m in LightingMode]
        cases += [("no shadows", scene, RenderConfig(width=W, height=H, shadows=False)),
                  ("t=1.25", scenes.get(name).animate(scene, 1.25), RenderConfig(width=W, height=H)),
                  ("50x37", scene, RenderConfig(width=50, height=37))]
        for case, sc, cfg in cases:
            buf, counts = plain.mega_pack(sc, cfg)
            wl, cnt = mega2.primary_worklists(sc, cfg)
            acc, bounds = mega2.mega2_closest(buf, counts, wl, cnt, cfg)
            wl_s, cnt_s = mega2.shadow_worklists(sc, cfg, bounds)
            img = mega2.mega2_shade(buf, counts, wl_s, cnt_s, acc, cfg)
            acc_p, bounds_p = mega2.mega2_closest_plain(buf, counts, cfg)
            img_on_acc = mega2.mega2_shade_plain(buf, counts, acc, cfg)
            img_p = (img_on_acc if torch.equal(acc, acc_p)
                     else mega2.mega2_shade_plain(buf, counts, acc_p, cfg))
            torch.cuda.synchronize()
            if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all():
                raise AssertionError(f"K2 {name} {case}: output {tuple(img.shape)} is not finite")
            a_diff, a_row, a_flips = _acc_diff(acc, acc_p)
            box_diff, _, _ = _acc_diff(bounds.T, bounds_p.T)
            if a_flips > 0.01:
                raise AssertionError(f"K2a {name} {case}: {a_flips:.5f} of rays differ")
            _worst(worst["K2a"], max(a_diff, box_diff), a_flips)
            got = {}
            for key, ref in (("K2b", img_on_acc), ("route", img_p)):
                diff = float((img - ref).abs().max())
                flips, mean = close_u8(math3d.quantize_u8(img).cpu().numpy(),
                                       math3d.quantize_u8(ref).cpu().numpy(), 0.01, 0.5)
                _worst(worst[key], diff, flips)
                got[key] = f"max|f32 diff| {diff:.3e} flips {flips:.5f} mean {mean:.5f}"
            print(f"phase 2: K2 {name} {case:11s} K2a max|diff| {a_diff:.3e} (row {a_row}), boxes "
                  f"{box_diff:.3e}, rays differing {a_flips:.5f}; K2b {got['K2b']}; route "
                  f"{got['route']}", flush=True)
    return worst


def _folded_rays(scene, cfg):
    """The packed route's camera rays: 32x32 pixel tiles when they fit."""
    from raytpu_torch.render import packed, renderer

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if cfg.width % 32 == 0 and cfg.height % 32 == 0:
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    return ro.expand_as(rd).contiguous(), rd


def _cmp_rays(R: int, dev):
    """Indices of the rays the plain versions check (PACKED_CMP_SIZES)."""
    if R <= CMP_MAX_RAYS:
        return torch.arange(R, device=dev)
    tiles = torch.arange(0, -(-R // 1024), CMP_TILE_STRIDE, device=dev)
    rays = (tiles[:, None] * 1024 + torch.arange(1024, device=dev)).flatten()
    return rays[rays < R]


def phase_compare_packed(dev, built: dict) -> dict:
    """K3 and K4 against their plain versions on bunny50k's and bunny300k's
    camera rays at 640x480 (the main path's shapes), 160x128 (tiled) and
    50x37: K3 must pick the plain version's winner on >= 99.99% of rays,
    with t within 1e-6 relative, the same material and the normal within
    1e-6 where it does; K4, on the shadow rays of K3's hits, must agree on
    >= 99.9% of (light, ray) pairs.  Then the packed route against the
    eager path at 160x128: the pixels that differ are counted (raytpu's
    packed route equals its jnp path) and held to the megakernel budget."""
    from raytpu_torch.core import math3d
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import packed, renderer

    out = {"K3": {"max_abs_diff": 0.0, "flip_frac": 0.0},
           "K4": {"max_abs_diff": 0.0, "flip_frac": 0.0}, "packed_vs_eager": {}}
    for name in ("bunny50k", "bunny300k"):
        scene = built[name]
        blobs = packed.soft_packs(scene)
        for w, h in PACKED_CMP_SIZES:
            cfg = RenderConfig(width=w, height=h)
            ro, rd = _folded_rays(scene, cfg)
            t, idx, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, cfg.ray_min)
            sub = _cmp_rays(rd.shape[0], dev)
            tp, idxp, normalp, matp = packed.winner_search_plain(ro[sub], rd[sub], *blobs, cfg.ray_min)
            torch.cuda.synchronize()
            same = idx[sub] == idxp
            agree = float(same.float().mean())
            both = same & torch.isfinite(tp)
            t_rel = float(((t[sub] - tp).abs() / tp.abs())[both].max()) if both.any() else 0.0
            t_diff = float((t[sub] - tp).abs()[both].max()) if both.any() else 0.0
            n_diff = float((normal[sub] - normalp).abs()[same].max()) if same.any() else 0.0
            if (agree < 0.9999 or t_rel > 1e-6 or n_diff > 1e-6
                    or not torch.equal(torch.isfinite(t[sub]), torch.isfinite(tp))
                    or not torch.equal(mat[sub][same], matp[same])):
                raise AssertionError(f"K3 {name} {w}x{h}: winners agree on {agree:.6f} of rays, "
                                     f"t within {t_rel:.3e} relative, normals within {n_diff:.3e}, "
                                     f"or the materials differ")
            # K4 on the shadow rays of K3's hits, launched on the whole frame;
            # its plain version on the same rays of the checked tiles
            rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
            p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
            occ = packed.any_hit_lights_mega2(scene, p_off, dirs, mags, cfg.ray_min)
            occp = packed.any_hit_lights_plain(p_off[sub].contiguous(), dirs[:, sub].contiguous(),
                                               mags[:, sub].contiguous(), *blobs, cfg.ray_min)
            torch.cuda.synchronize()
            k4_flip = float((occ[:, sub] != occp).float().mean())
            if k4_flip > 0.001:
                raise AssertionError(f"K4 {name} {w}x{h}: {k4_flip:.5f} of (light, ray) pairs differ")
            print(f"phase 2: K3 {name} {w}x{h} ({sub.numel()} of {rd.shape[0]} rays checked): "
                  f"winners agree {agree:.6f}, max|t diff| {t_diff:.3e} (rel {t_rel:.3e}), "
                  f"max|normal diff| {n_diff:.3e}; K4 on {tuple(occ.shape)} (L, R): {k4_flip:.6f} "
                  f"of pairs differ, occluded share {float(occp.float().mean()):.4f}", flush=True)
            _worst(out["K3"], max(t_diff, n_diff), 1.0 - agree)
            _worst(out["K4"], float((occ[:, sub] != occp).any()), k4_flip)
        cfg = RenderConfig(width=PACKED_PLAIN_SIZE[0], height=PACKED_PLAIN_SIZE[1])
        a = packed.render_image_packed_f32(scene, cfg)
        b = renderer.render_image_f32(scene, cfg)
        torch.cuda.synchronize()
        qa, qb = math3d.quantize_u8(a).cpu().numpy(), math3d.quantize_u8(b).cpu().numpy()
        differ = int((qa != qb).any(axis=-1).sum())
        flips, mean = close_u8(qa, qb, 0.01, 0.5)
        out["packed_vs_eager"][name] = {"pixels_differing": differ,
                                        "max_abs_diff": float((a - b).abs().max())}
        print(f"phase 2: packed route vs eager path, {name} {cfg.width}x{cfg.height}: {differ} "
              f"pixels differ "
              f"(max|f32 diff| {out['packed_vs_eager'][name]['max_abs_diff']:.3e})", flush=True)
    return out


def _check_counts(name: str, route: str, frames: int, counts: dict) -> None:
    """Each kernel of the route launched once per frame, no other kernel."""
    want = {k: 0 for k in counts}
    for k in ROUTE_KERNELS[route]:
        want[k] = frames
    if counts != want:
        raise AssertionError(f"{name}: {frames} frames launched {counts}, expected {want}")


def phase_main_path(dev, built: dict) -> dict:
    """The reference scene through K1: 64 animated frames, the goldens, the
    CLI.  The launch counts are set to 0 just before the frames and read just
    after."""
    from raytpu_torch.app import cli
    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import render_image
    from raytpu_torch.utils import image as image_io

    spec = scenes.get("reference")
    scene = built["reference"]
    config = RenderConfig(width=W, height=H)
    ts = torch.linspace(0.0, 2.0 * np.pi, FRAMES, device=dev)  # as bench.py:92
    first = None
    reset_launch_counts()
    for i in range(FRAMES):
        img = render_image(spec.animate(scene, ts[i]), config)
        first = img if i == 0 else first
    torch.cuda.synchronize()
    counts = launch_counts()
    _check_counts("reference", "mega", FRAMES, counts)
    if img.shape != (H, W, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"frame is {tuple(img.shape)} {img.dtype}")
    # golden budget (tests/test_golden.py:16-24): <=0.2% flipped, mean <=0.1
    g0 = close_u8(first.cpu().numpy(), image_io.read_png(str(GOLDEN / "reference_640x480.png")),
                  0.002, 0.1)
    t125 = render_image(spec.animate(scene, 1.25), config).cpu().numpy()
    g1 = close_u8(t125, image_io.read_png(str(GOLDEN / "reference_t1.25_640x480.png")), 0.002, 0.1)
    print(f"phase 3: reference: {FRAMES} frames, launches {counts}; golden t=0 flips "
          f"{g0[0]:.5f} mean {g0[1]:.5f}; t=1.25 flips {g1[0]:.5f} mean {g1[1]:.5f}", flush=True)
    _run_cli("reference")
    return {"frames": FRAMES, "launches": counts["K1"], "golden_t0": g0, "golden_t1.25": g1}


def _run_cli(scene: str) -> None:
    from raytpu_torch.app import cli
    from raytpu_torch.utils import image as image_io

    with tempfile.TemporaryDirectory() as tmp:
        shot = Path(tmp) / "shot.png"
        rc = cli.main(["--scene", scene, "--size", f"{W}x{H}", "--frames", "4",
                       "--screenshot", str(shot)])
        if rc != 0 or image_io.read_png(str(shot)).shape != (H, W, 3):
            raise AssertionError(f"CLI on {scene} returned {rc} or wrote no {W}x{H} screenshot")


def phase_big_paths(dev, built: dict) -> dict:
    """bunny and optional (K2a, K2b) and bunny50k and bunny300k (K3, K4) at
    640x480 with bench.py's frame counts, each with the launch counts set to
    0 just before its frames and read just after; each frame must be a
    finite (H, W, 3) uint8 image that is not black.  The first frame of
    bunny and optional is held against the plain version of its route."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import mega2, render_image

    config = RenderConfig(width=W, height=H)
    out = {}
    for name, frames, route in BIG_PATHS:
        spec = scenes.get(name)
        scene = built[name]
        if ck.route_kind(scene, config) != route:
            raise AssertionError(f"{name} routes to {ck.route_kind(scene, config)}, not {route}")
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)  # as bench.py:92
        t0 = time.perf_counter()
        reset_launch_counts()
        imgs = [render_image(spec.animate(scene, ts[i]), config) for i in range(frames)]
        torch.cuda.synchronize()
        counts = launch_counts()
        seconds = time.perf_counter() - t0
        _check_counts(name, route, frames, counts)
        for img in imgs:
            if img.shape != (H, W, 3) or img.dtype != torch.uint8 or not bool(img.any()):
                raise AssertionError(f"{name}: frame is {tuple(img.shape)} {img.dtype} or black")
        line = f"phase 3: {name}: {frames} frames through {route} in {seconds:.2f}s, launches {counts}"
        if route == "mega2":
            ref = math3d.quantize_u8(mega2.render_image_mega2_f32_plain(spec.animate(scene, ts[0]),
                                                                        config))
            flips, mean = close_u8(imgs[0].cpu().numpy(), ref.cpu().numpy(), 0.01, 0.5)
            line += f"; frame 0 vs plain: flips {flips:.5f} mean {mean:.5f}"
        print(line, flush=True)
        out[name] = {"frames": frames, "route": route, "launches": counts}
    _run_cli("optional")
    return out


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


def _bound(ops: float, nbytes: float) -> dict:
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def time_frames(spec, scene, config, frames: int, dev):
    """(frame ms, primary rays/s, device activities and busy ms per frame,
    idle share): animated frames through render_image, as a user's loop."""
    from raytpu_torch.render import render_image
    from raytpu_torch.utils.profiling import device_ms

    ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)
    frame_i = [0]

    def frame():
        render_image(spec.animate(scene, ts[frame_i[0] % frames]), config)
        frame_i[0] += 1

    frame_ms = device_ms(frame, iters=frames, warmup=1)
    acts, busy_ms = frame_breakdown(frame, min(frames, 8))
    idle = None if busy_ms is None else 1.0 - busy_ms / frame_ms
    return frame_ms, W * H / (frame_ms / 1e3), acts, busy_ms, idle


def time_k1(dev, env: dict, built: dict, worst: dict, main: dict):
    """K1's entry and the reference scene's main-path line."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.utils.profiling import device_ms

    scene = built["reference"]
    config = RenderConfig(width=W, height=H)
    buf, counts = ck.mega_pack(scene, config)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    kernel_ms = device_ms(lambda: ck.launch_mega(buf, counts, config, out), iters=200, warmup=10)
    frame_ms, rays_per_s, acts, busy_ms, idle = time_frames(scenes.get("reference"), scene,
                                                             config, FRAMES, dev)
    plain_ms = device_ms(lambda: math3d.quantize_u8(ck.render_image_mega_f32_plain(scene, config)),
                         iters=5, warmup=1)
    bound = _bound(count_ops(scene, config), buf.numel() * 4 + out.numel() * 4)
    print(f"phase 4: K1 reference: kernel {kernel_ms:.4f} ms, frame {frame_ms:.4f} ms "
          f"({rays_per_s:.4e} primary rays/s), plain {plain_ms:.3f} ms at {W}x{H}; "
          f"{bound['ops']:.4e} FP32 ops -> {bound['ops_ms']:.4f} ms at 67 TFLOP/s, "
          f"{bound['bytes']} B -> {bound['bytes_ms']:.6f} ms at 3.35 TB/s; per frame {acts} "
          f"device activities, busy {busy_ms} ms, idle share {idle}", flush=True)
    kernel = {"name": "mega", "id": "K1", "route": "cuda",
              "source": "raytpu_torch/render/csrc/mega.cu",
              "replaces": "raytpu/render/pallas_kernel.py:879", "launches": main["launches"],
              "max_abs_err": worst["max_abs_diff"], "max_abs_diff": worst["max_abs_diff"],
              "flip_frac": worst["flip_frac"], "ms": kernel_ms, "plain_ms": plain_ms,
              "plain_size": f"{W}x{H}", "library_ms": None, **bound}
    line = {"scene": "reference", "size": f"{W}x{H}", "frames": FRAMES, "route": "mega",
            "launches": {"K1": main["launches"]}, "kernel_ms": {"K1": kernel_ms},
            "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
            "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
            "device_idle_share": idle, "golden_t0": main["golden_t0"],
            "golden_t1.25": main["golden_t1.25"], "card": env["nvidia_smi"]}
    return kernel, line


def _group_tris(T: int, dev):
    """Triangles in each 8-triangle group (the last one may hold fewer)."""
    ng = -(-T // 8)
    return torch.clamp(T - 8 * torch.arange(ng, device=dev), max=8).to(torch.float64)


def _worklist_tris(wl, cnt, T: int):
    """Triangles each worklist row walks: its passing groups' sizes summed."""
    used = torch.arange(wl.shape[-1], device=wl.device) < cnt[..., None]
    return torch.where(used, _group_tris(T, wl.device)[wl.long()], 0.0).sum(dim=-1)


def _shade_ops(config, is_point: bool, kind, metal):
    """Per-ray FP32 operations of one lit light's shading (mega.cu's
    shade_one_light and the accumulate), by material kind."""
    mode = int(config.lighting_mode)
    per = OPS_SHADE_BASE[mode] + OPS_ACCUMULATE + (OPS_RADIANCE if mode in (1, 3) and is_point else 0)
    per += 3 if mode == 1 else 0
    ops = torch.full(kind.shape, float(per), dtype=torch.float64, device=kind.device)
    if mode in (2, 3):
        brdf = torch.zeros_like(ops)
        for k, v in OPS_BRDF.items():
            brdf[kind == k] = v
        brdf[kind == 3] = OPS_CT + OPS_CT_DIELECTRIC
        brdf[(kind == 3) & metal] = OPS_CT + OPS_CT_METAL
        ops = ops + brdf + (OPS_COMBINED if mode == 3 else 0)
    return ops


def _shadow_ops(S: int, P: int, occ, hit, tris, tiles: int):
    """FP32 operations of the shadow queries of one light: every test of the
    worklist for a query that finds no occluder; for one that does, a single
    plane test (it stops at its first occluder, where it is is not counted,
    so this is a lower bound)."""
    unocc = (hit & ~occ).reshape(tiles, -1)
    ops = float(unocc.sum()) * (S * OPS_SPHERE + P * OPS_PLANE)
    ops += float((unocc.sum(dim=1).to(torch.float64) * tris).sum()) * OPS_TRI_SHADOW
    return ops + float((hit & occ).sum()) * OPS_PLANE


def time_mega2(dev, built: dict, name: str):
    """K2a's and K2b's times at 640x480 beside their bounds, counted from
    this frame's worklists; the plain versions' times at the size they were
    compared at (640x480)."""
    from raytpu_torch.core import math3d
    from raytpu_torch.core.types import LightKind, RenderConfig
    from raytpu_torch.ops import accel, shading
    from raytpu_torch.render import mega2, packed, plain
    from raytpu_torch.utils.profiling import device_ms

    scene = built[name]
    cfg = RenderConfig(width=W, height=H)
    buf, counts = plain.mega_pack(scene, cfg)
    S, P, T, L = counts
    wl, cnt = mega2.primary_worklists(scene, cfg)
    acc, bounds = mega2.mega2_closest(buf, counts, wl, cnt, cfg)
    wl_s, cnt_s = mega2.shadow_worklists(scene, cfg, bounds)
    ms_a = device_ms(lambda: mega2.mega2_closest(buf, counts, wl, cnt, cfg), iters=50, warmup=3)
    ms_b = device_ms(lambda: mega2.mega2_shade(buf, counts, wl_s, cnt_s, acc, cfg), iters=50,
                     warmup=3)
    plain_a = device_ms(lambda: mega2.mega2_closest_plain(buf, counts, cfg), iters=1, warmup=0)
    plain_b = device_ms(lambda: mega2.mega2_shade_plain(buf, counts, acc, cfg), iters=1, warmup=0)

    nt = mega2.num_tiles(cfg)
    px, py, valid = accel.tile_pixels(W, H, mega2.is_tiled(cfg), dev)
    rays = float(valid.sum())
    hit = torch.isfinite(acc[0]) & valid
    n_hit = float(hit.sum())
    tile_rays = valid.reshape(nt, -1).sum(dim=1).to(torch.float64)
    ops_a = rays * (OPS_RAYGEN + S * OPS_SPHERE + P * OPS_PLANE) + n_hit * 6
    ops_a += float((tile_rays * _worklist_tris(wl, cnt, T)).sum()) * OPS_TRI
    bytes_a = (buf.numel() + int(cnt.sum()) + cnt.numel() + acc.numel() + bounds.numel()) * 4

    # which shadow queries find an occluder: K4 on K2a's shadow rays (the
    # same arithmetic as K2b's; K4 is held against its plain version in
    # phase 2)
    cam, _, _, _, _ = plain.mega_unpack(buf, counts)
    ro, rd = plain.camera_rays(cam, px, py, W, H)
    rd = torch.stack(rd, dim=1)
    ts = torch.where(hit, acc[0], 0.0)
    p_off = math3d.fma(acc[1:4].T, float(cfg.normal_offset),
                       math3d.fma(rd, ts[:, None], torch.stack(ro)[None, :]))
    lds = [shading.direction_to_light(scene.lights, li, p_off) for li in range(L)]
    dirs = torch.stack([d for d, _ in lds]).contiguous()
    mags = torch.stack([m for _, m in lds]).contiguous()
    occ = packed.any_hit_lights_mega2(scene, p_off.contiguous(), dirs, mags, cfg.ray_min)
    tris_s = _worklist_tris(wl_s, cnt_s, T)
    kind, metal = acc[4], acc[8] != 0.0
    ops_b = rays * OPS_RAYGEN + n_hit * OPS_HIT
    for li in range(L):
        is_point = int(scene.lights.kind[li]) == int(LightKind.POINT)
        ops_b += n_hit * (OPS_LIGHT_POINT if is_point else OPS_LIGHT_DIR)
        ops_b += _shadow_ops(S, P, occ[li], hit, tris_s[:, li], nt)
        ops_b += float(_shade_ops(cfg, is_point, kind, metal)[hit & ~occ[li]].sum())
    bytes_b = (buf.numel() + int(cnt_s.sum()) + cnt_s.numel() + acc.numel() + H * W * 3) * 4
    out = {}
    for key, ms, plain_ms, bound in (("K2a", ms_a, plain_a, _bound(ops_a, bytes_a)),
                                     ("K2b", ms_b, plain_b, _bound(ops_b, bytes_b))):
        out[key] = {"ms": ms, "plain_ms": plain_ms, "plain_size": f"{W}x{H}", **bound}
        print(f"phase 4: {key} {name}: {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({bound['ops']:.4e} FP32 ops, {bound['bytes']} B), "
              f"plain {plain_ms:.2f} ms at {W}x{H}", flush=True)
    out["tests_per_ray"] = float((tile_rays * _worklist_tris(wl, cnt, T)).sum()) / rays
    out["occluded_share"] = float((occ & hit[None]).sum()) / max(n_hit * L, 1.0)
    return out


def time_packed(dev, built: dict, name: str):
    """K3's and K4's times at 640x480 beside their bounds, counted from this
    frame's worklists; the plain versions' times on the first whole frame
    they were compared at (PACKED_PLAIN_SIZE)."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import packed, renderer
    from raytpu_torch.utils.profiling import device_ms

    scene = built[name]
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    blobs = packed.soft_packs(scene)
    out = {}
    plain_size = PACKED_PLAIN_SIZE
    for w, h in ((W, H), plain_size):
        cfg = RenderConfig(width=w, height=h)
        ro, rd = _folded_rays(scene, cfg)
        tmin = cfg.ray_min
        if (w, h) == plain_size:
            ms3 = device_ms(lambda: packed.winner_search_plain(ro, rd, *blobs, tmin), iters=1, warmup=0)
            t, idx, normal, mat = packed.winner_search_plain(ro, rd, *blobs, tmin)
            rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
            p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
            ms4 = device_ms(lambda: packed.any_hit_lights_plain(p_off, dirs, mags, *blobs, tmin),
                            iters=1, warmup=0)
            out["K3"]["plain_ms"], out["K4"]["plain_ms"] = ms3, ms4
            continue
        R, nt = rd.shape[0], -(-rd.shape[0] // 1024)
        wl, cnt = packed.closest_worklists(scene, ro, rd, tmin)
        t, idx, normal, mat = packed.winner_search(ro, rd, *blobs, wl, cnt, tmin)
        ms3 = device_ms(lambda: packed.winner_search(ro, rd, *blobs, wl, cnt, tmin), iters=20,
                        warmup=2)
        rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
        p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
        p_off, dirs, mags = p_off.contiguous(), dirs.contiguous(), mags.contiguous()
        wl4, cnt4 = packed.shadow_worklists(scene, p_off, dirs, mags, tmin)
        occ = packed.any_hit_lights(p_off, dirs, mags, *blobs, wl4, cnt4, tmin)
        ms4 = device_ms(lambda: packed.any_hit_lights(p_off, dirs, mags, *blobs, wl4, cnt4, tmin),
                        iters=20, warmup=2)
        tile_rays = torch.full((nt,), 1024.0, dtype=torch.float64, device=dev)
        tile_rays[-1] = R - 1024 * (nt - 1)
        tris3 = _worklist_tris(wl, cnt, T)
        ops3 = R * (S * OPS_SPHERE + P * OPS_PLANE) + float((tile_rays * tris3).sum()) * OPS_TRI
        blob_bytes = sum(b.numel() for b in blobs) * 4
        bytes3 = R * 24 + blob_bytes + (int(cnt.sum()) + cnt.numel()) * 4 + R * 24
        tris4 = _worklist_tris(wl4, cnt4, T)
        every = torch.ones((R,), dtype=torch.bool, device=dev)
        ops4 = sum(_shadow_ops(S, P, occ[li], every, tris4[:, li], nt) for li in range(L))
        bytes4 = R * 12 + L * R * 16 + blob_bytes + (int(cnt4.sum()) + cnt4.numel()) * 4 + L * R
        size = f"{plain_size[0]}x{plain_size[1]}"
        out["K3"] = {"ms": ms3, "plain_size": size, **_bound(ops3, bytes3)}
        out["K4"] = {"ms": ms4, "plain_size": size, **_bound(ops4, bytes4)}
        out["tests_per_ray"] = float((tile_rays * tris3).sum()) / R
        out["occluded_share"] = float(occ.float().mean())
    for key in ("K3", "K4"):
        e = out[key]
        print(f"phase 4: {key} {name}: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']} ({e['ops']:.4e} FP32 ops, {e['bytes']} B), plain "
              f"{e['plain_ms']:.2f} ms at {e['plain_size']}", flush=True)
    return out


KERNEL_INFO = {
    "K2a": ("mega2_closest", "raytpu_torch/render/csrc/mega2.cu", "raytpu/render/pallas_kernel.py:1192"),
    "K2b": ("mega2_shade", "raytpu_torch/render/csrc/mega2.cu", "raytpu/render/pallas_kernel.py:1300"),
    "K3": ("packed_closest", "raytpu_torch/render/csrc/packed.cu", "raytpu/render/pallas_soft.py:1033"),
    "K4": ("packed_anyhit", "raytpu_torch/render/csrc/packed.cu", "raytpu/render/pallas_soft.py:822"),
}
#: the scene whose numbers head each kernel's entry: the largest it serves
HEADLINE = {"K2a": "optional", "K2b": "optional", "K3": "bunny300k", "K4": "bunny300k"}


def phase_times(dev, env: dict, built: dict, worst: dict, main: dict, big: dict) -> None:
    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig

    k1, k1_line = time_k1(dev, env, built, worst["K1"], main)
    config = RenderConfig(width=W, height=H)
    per_scene, lines = {}, [k1_line]
    for name, frames, route in BIG_PATHS:
        timed = (time_mega2 if route == "mega2" else time_packed)(dev, built, name)
        per_scene[name] = timed
        frame_ms, rays_per_s, acts, busy_ms, idle = time_frames(scenes.get(name), built[name],
                                                                config, frames, dev)
        kernels = ROUTE_KERNELS[route]
        lines.append({"scene": name, "size": f"{W}x{H}", "frames": frames, "route": route,
                      "launches": {k: big[name]["launches"][k] for k in kernels},
                      "kernel_ms": {k: timed[k]["ms"] for k in kernels},
                      "bound_ms": {k: timed[k]["bound_ms"] for k in kernels},
                      "triangle_tests_per_ray": timed["tests_per_ray"],
                      "occluded_share": timed["occluded_share"],
                      "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
                      "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
                      "device_idle_share": idle, "card": env["nvidia_smi"]})
        print(f"phase 4: {name}: frame {frame_ms:.4f} ms ({rays_per_s:.4e} primary rays/s); per "
              f"frame {acts} device activities, busy {busy_ms} ms, idle share {idle}", flush=True)
    entries = [k1]
    for key, (kname, source, replaces) in KERNEL_INFO.items():
        head = per_scene[HEADLINE[key]][key]
        cmp = worst[key]
        entries.append({
            "name": kname, "id": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(v["launches"][key] for v in big.values()),
            "max_abs_err": cmp["max_abs_diff"], "max_abs_diff": cmp["max_abs_diff"],
            "flip_frac": cmp["flip_frac"], "scene": HEADLINE[key], "library_ms": None,
            **head,
            "per_scene": {n: v[key] for n, v in per_scene.items() if key in v}})
    for line in lines:
        print(json.dumps({"main_path": line}))
    print(json.dumps({"kernels": entries}))


def main() -> int:
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"chip_smoke: {name} took {seconds[name]:.1f}s", flush=True)
        return result

    env = phase_env()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timed("phase 1 (build)", phase_build)
    built = timed("scene builds", build_scenes, dev)
    worst = {"K1": timed("phase 2 (K1)", phase_compare, dev)}
    mega2_worst = timed("phase 2 (K2a, K2b)", phase_compare_mega2, dev, built)
    packed_cmp = timed("phase 2 (K3, K4)", phase_compare_packed, dev, built)
    worst.update({"K2a": mega2_worst["K2a"], "K2b": mega2_worst["K2b"], "K3": packed_cmp["K3"],
                  "K4": packed_cmp["K4"]})
    main_path = timed("phase 3 (reference)", phase_main_path, dev, built)
    big = timed("phase 3 (big meshes)", phase_big_paths, dev, built)
    timed("phase 4 (times)", phase_times, dev, env, built, worst, main_path, big)
    print(json.dumps({"phase_seconds": seconds,
                      "packed_vs_eager_160x128": packed_cmp["packed_vs_eager"],
                      "mega2_route_vs_plain": mega2_worst["route"]}))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s "
          f"on {env['nvidia_smi']}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
