"""Drive raytpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each passes or raises; nothing is caught):
  0. environment: the card's name and power limit, torch and CUDA versions;
  1. build every kernel from raytpu_torch/render/csrc with nvcc;
  2. each kernel against its plain PyTorch version on the card: K1 on the
     small scenes and the OBJ scene w4_test (and its whole frame equal bit
     for bit to its own tile ranges on reference at 640x480 and 50x37), K2a + K2b (the mega2 route) on
     bunny and optional (K2b bit for bit, and equal to K11b's image and to
     its own launch over records that pass every group; K2a's buffer and
     boxes equal bit for bit to K11a's, to its own launch over such records
     and, on the pixel-sharded bunny render's tile ranges, to K11a's on
     each range and to the whole frame's), K3 and K4 (the
     packed route) on bunny50k's and
     bunny300k's camera rays at 640x480 (the main path's shapes), 160x128
     and 50x37 (K3 also equal, bit for bit, to its own launch over records
     that pass every group), and the packed route against the eager path;
     K5, K6 and K7
     (the soft-shadow kernels) on the soft shadow queries of optional at
     640x480 (the main path's shapes), of optional with a light just above
     its ceiling (so that g_mags is not zero), of bunny50k at 160x128 and of
     bunny300k at 64x64;
     and the autograd Function around them, with its sphere and plane
     cotangents, against plain autograd on reference at 160x128 (K7 and K6
     on the gradient records also against their walks over records that
     pass every group, and against themselves run twice: K6 bit for bit);
     K8 (both
     modes), K9 and K10 (the chunked route) on optional_l12 at 640x480 and
     on bunny18k_l12 and reference_s106 at 160x128 (K9 exactly, and equal to
     its launches over every listed triangle; K8's walks in both modes
     equal, bit for bit, to its fold over every listed triangle and to its
     walk over records that pass every group), K9 on shade_rays' row-major
     rays of optional_l12 at 640x480, and the route's 24-light boundary (24
     render, 25 raise); K11a and K11b (the streamed whole-frame
     route) on optional, bunny50k and bunny300k at 640x480 (every 10th tile)
     and 160x128, and against K2a and K2b on the same frames (buffer, boxes
     and image equal, bit for bit; K11a also equal to its own launch over
     records that pass every group); the tile ranges of K1, K2 and K11 (the
     px-sharded render's per-rank bodies) against their whole frames; the
     probes: P1 in its four variants at T = 64, 384, 1024 over 300 tiles on
     raytpu's uniform triangles and on triangles in front of the rays, and
     P2 at raytpu's shape (against numpy, cnt 37, 0, 3) and at its timed
     shape, all bit for bit;
  3. the main paths, each with the launch counts set to 0 just before it and
     read just after: 64 animated frames of the reference scene at 640x480
     (K1) with frames t=0 and t=1.25 against the committed goldens, 16 of
     bunny and of optional (K2a, K2b), 4 of bunny50k and 2 of bunny300k
     (K3, K4), as bench.py counts them; the CLI once on reference and on
     optional; the differentiable path's train steps (bench.py:50-54), a
     material fit on optional at 640x480 with payload_grad True and False
     (K3 and K5 once a step, no K6 or K7), a light and mesh fit (K3, K5,
     K6 with its light sum, K7 once a step), the material fit on bunny50k
     and bunny300k; and
     the kernel route's gradients against the eager route's on optional at
     160x128; the chunked route (K8, K10) on optional_l12 and reference_s106
     (16 frames) and bunny18k_l12 (4), frame 0 of each against the eager
     path, chunked.shade_rays (K8, K9) against the route on optional_l12, and
     the per-stage profiler on reference and optional_l12;
     render_image_mega3_f32 (K11a, K11b) over 16 frames of optional, 4 of
     bunny50k and 2 of bunny300k, frame 0 against K2's; the sharded paths
     on two gloo ranks sharing the card (raytpu_torch/parallel/launch.py):
     (px, prim) = (2, 1) on reference (K1 tiles), bunny (K2 tiles) and
     bunny50k (K11 tiles, by name), (1, 2) on bunny50k (K3 and K4 on each
     triangle shard, merged) and on optional_l12 (K9 on each shard), and a
     sharded train step on optional's materials, each against the
     single-process render or step; the probes' entry points (main() in
     this process with the counts around it, then ``python -m`` of each);
     the CLI's --ssaa 2 through K1 against the committed SSAA golden and
     --frames-per-dispatch 4 over 10 frames (frames, K1 launches and
     device-to-host copies counted); the viewer's FramePipeline over 16
     frames of bunny with a moving fly camera against the synchronous loop;
     the tools and examples (9a-9f): examples/torch_geometry_fit.py at
     640x480 for 8 steps on bunny (K3, K5, K6, K7 every step; the loss
     falls), examples/torch_inverse_rendering.py at 640x480 (10 steps with
     a checkpoint every 5, resumed to 15, within 1e-5 of an uninterrupted
     run), the port's oracle against K1 on reference at 64x48, the native
     BVH closest hit against K3 on 256 camera rays of bunny50k,
     utils.profiling.trace of a bunny frame naming K2a's and K2b's
     symbols, and utils.debug.nan_check around a geometry-fit step (clean;
     a NaN vertex raises);
  4. times on the card (CUDA events) of every kernel beside its bound, and
     of each scene's frame, with the device's idle share from torch.profiler;
     for K4 and K11b, which test each shadow ray's segment against the
     group boxes before a group's triangles, two bounds (the count of every
     listed triangle, as for the other culled kernels, and the box-culled
     count: the triangles of the groups whose padded box the segment
     crosses, no box tests) and, per light on bunny50k and bunny300k, the
     groups listed per query, those whose padded box the segment crosses,
     those whose box widened for the ray it crosses (the kernels' test),
     the union of the latter over each warp and the occluded share; for
     K3 and K11a, which test each ray's segment up to its current closest
     hit against the group records, the same two bounds (the box-culled
     count: the triangles of the groups whose record, widened for the ray,
     its segment up to its final closest hit crosses) and per scene the
     groups listed per ray, those crossed up to the hit, those its whole
     line crosses and the union over each warp; for K2b and K9, on the
     same walk with the normal records (8-triangle groups; 128-triangle
     chunks), the same two bounds and statistics, the bytes of the
     box-culled one counting only the triangles of the groups some query
     crosses and the listed groups' records (K9 also timed on row-major
     rays); for K8, on the closest walk over 128-triangle chunks, and
     K2a, K11a's closest pass, K3's bound and statistics; for K7 and K6,
     on the gradient walk, the triangles of the groups whose gradient
     record the segment crosses (K6 adding every sphere and plane), and
     K5's statistics over the gradient records;
     the same for K5, K6 and K7, and each train step's milliseconds, idle
     share and peak memory; K8, K9 and K10 and the chunked fixtures' frames;
     K11a and K11b beside K2a's and K2b's times on the same frames, and the
     mega3 frames with their idle share; P1 in each variant and T against
     its operation bound (and the non-FMA issue rate, and its fold loop's
     SASS instructions a test at that rate), P2's bytes/s on a 155.7 MB
     blob against 3.35 TB/s; K1 and P1 with ptxas's registers and spills,
     K1 with its tests' SASS instructions a ray (cuobjdump).

The chunked route's fixtures are registry scenes carried across with
``convert`` and edited (raytpu's registry has no scene past its caps):
optional_l12 and bunny18k_l12 add nine white point lights to optional and
to bunny subdivided 3 times (18,688 triangles), reference_s106 adds a grid
of 100 spheres to reference.
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
ROUTE_KERNELS = {"mega": ["K1"], "mega2": ["K2a", "K2b"], "packed": ["K3", "K4"],
                 "chunked": ["K8", "K10"], "mega3": ["K11a", "K11b"]}
#: the streamed whole-frame route (K11a, K11b), reached by name: scene and
#: frames, bench.py's counts for the scene; K11 is held against its plain
#: versions and against K2 on each, and timed beside K2 on the same frames
MEGA3_PATHS = (("optional", 16), ("bunny50k", 4), ("bunny300k", 2))
#: the size at which K11's plain versions see the whole frame, and are
#: timed, on the stress meshes
MEGA3_PLAIN_SIZE = (160, 128)
#: the chunked fixtures' nine extra lights (``nine_lights``)
NINE_LIGHTS = [[x, 8.0, z] for x in (-3.0, 0.0, 3.0) for z in (0.0, 3.0, 6.0)]
#: the sharded paths, two gloo ranks on the one card at 640x480 (the cases
#: of raytpu_torch/parallel/launch.py): the fused tile ranges of K1, K2 and
#: K11 (px = 2), the prim-sharded K3 and K4 with the merge (prim = 2), the
#: prim-sharded K9 past K4's 8 lights (optional_l12: the closest hit takes
#: the eager t-matrix there, as in raytpu) and a sharded train step; each
#: against the single-process render or step (optional_l12 against the
#: sharded path on one rank, which runs K9 on every triangle)
SHARDED_CASES = (
    {"name": "reference_px", "scene": "reference", "size": [W, H], "mesh": "px"},
    {"name": "bunny_px", "scene": "bunny", "size": [W, H], "mesh": "px"},
    {"name": "bunny50k_mega3_px", "scene": "bunny50k", "size": [W, H], "mesh": "px",
     "kind": "mega3"},
    {"name": "bunny50k_prim", "scene": "bunny50k", "size": [W, H], "mesh": "prim", "ref": "route"},
    {"name": "optional_l12_prim", "scene": "optional", "lights": NINE_LIGHTS, "size": [W, H],
     "mesh": "prim", "ref": "single"},
    {"name": "optional_train", "scene": "optional", "size": [W, H], "mesh": "px",
     "train": "material"},
)
#: the kernels each sharded case launches once on each rank
SHARDED_KERNELS = {"reference_px": ["K1"], "bunny_px": ["K2a", "K2b"],
                   "bunny50k_mega3_px": ["K11a", "K11b"], "bunny50k_prim": ["K3", "K4"],
                   "optional_l12_prim": ["K9"],
                   "optional_train": ["K3", "K5"]}
#: the soft kernels' comparison cases: the main path's frame, optional
#: with a light just above its ceiling (``far_light``), and the stress
#: meshes' band, at sizes whose plain versions take seconds
SOFT_CMP = (("optional", (W, H)), ("optional_far_light", (160, 128)), ("bunny50k", (160, 128)),
            ("bunny300k", (64, 64)))
#: the autograd Function against plain autograd of the eager transmittance:
#: a scene of spheres, planes and triangles, and one whose shadow rays
#: cross a plane (its plane cotangents are not zero)
SOFT_FUNCTION_CMP = (("reference", (160, 128)), ("optional_far_light", (160, 128)))
#: the differentiable main paths (bench.py:50-54): scene, steps, fit,
#: payload_grad, learning rate
GRAD_PATHS = (("optional", 8, "material", True, 1e-2), ("optional", 8, "material", False, 1e-2),
              ("optional", 4, "light+mesh", True, 1e-1), ("bunny50k", 2, "material", True, 1e-2),
              ("bunny300k", 1, "material", True, 1e-2))
#: the kernel route against the eager route: a size at which the eager
#: route's (rays x triangles) residuals fit, in chunks of rays
GRAD_VS_EAGER = ("optional", (160, 128), 1024)

#: the chunked route's main paths: fixture, frames at 640x480, the size of
#: its kernels' comparisons with their plain versions (every
#: CMP_TILE_STRIDE-th tile at 640x480), the registry scene that animates it
CHUNKED_PATHS = (("optional_l12", 16, (W, H), "optional"),
                 ("bunny18k_l12", 4, (160, 128), "bunny"),
                 ("reference_s106", 16, (160, 128), "reference"))
ANIMATED_BY = {name: base for name, _, _, base in CHUNKED_PATHS}
#: the chunked kernels' comparisons with their plain versions: each
#: fixture's size, and optional_l12 on a frame that does not fold (K10's
#: 8x4 warps on rows of 50)
CHUNKED_CMP = tuple((name, size) for name, _, size, _ in CHUNKED_PATHS) + (
    ("optional_l12", (50, 37)),)
#: the size at which the chunked route is held against the eager path and
#: the plain versions are timed
CHUNKED_PLAIN_SIZE = (160, 128)
#: the fixtures the per-stage profiler runs on
STAGE_SCENES = ("reference", "optional_l12")

#: the probes (raytpu_torch.probes): P1's triangle counts and tiles
#: (probes/probe_smem.py's), and P2's timed shape: blocks (4 per SM) and the
#: row-blocks each walks, 19,008 of 8 KB, 155.7 MB, past the 50 MB L2
P1_TS = (64, 384, 1024)
P1_TILES = 300
P2_BLOCKS, P2_PER_BLOCK = 132 * 4, 36
#: FP32 operations of one P1 test, counted from probes.cu (its source note)
OPS_P1_TEST = 53
#: the viewer's double-buffered pipeline: scene and frames
PIPELINE_SCENE, PIPELINE_FRAMES = "bunny", 16
#: phase 3 (tools and examples): the geometry fit's steps at 640x480; the
#: inverse-rendering runs (10 steps saving every 5, resumed to 15, against
#: 15 uninterrupted) and their final losses' relative tolerance (CUDA's
#: index_add_ is not deterministic); the oracle's frame against K1; the
#: camera rays of bunny50k held to the native BVH closest hit
GEOMETRY_FIT_STEPS = 8
INVERSE_STEPS, INVERSE_EVERY, INVERSE_RESUME_TO, INVERSE_RTOL = 10, 5, 15, 1e-5
ORACLE_SIZE = (64, 48)
BVH_RAYS = 256

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: FP32 lanes of an H100 SXM: 132 SMs x 128; one add or multiply a lane a
#: clock when nothing is fused (-fmad=false)
FP32_LANES = 132 * 128


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
    """Every kernel wrapper's launch count, K1 to K11b."""
    from raytpu_torch import render

    return render.launch_counts()


def reset_launch_counts() -> None:
    from raytpu_torch import render

    render.reset_launch_counts()


def build_scenes(dev) -> dict:
    """Every scene of the main paths, built once on the card."""
    from raytpu_torch.core import scenes

    out = {}
    for name in ["reference"] + [n for n, _, _ in BIG_PATHS]:
        t0 = time.perf_counter()
        out[name] = scenes.get(name).build(dev)
        print(f"built {name}: {out[name].triangles.count} triangles in "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    out["optional_far_light"] = far_light(out["optional"])
    t0 = time.perf_counter()
    out["optional_l12"] = nine_lights(out["optional"])
    out["bunny18k_l12"] = nine_lights(scenes.scene_bunny_subdiv(3, device=dev))
    out["reference_s106"] = sphere_grid(out["reference"])
    print(f"built the chunked fixtures in {time.perf_counter() - t0:.2f}s", flush=True)
    return out


def _appended(scene, rows: dict):
    """``scene`` carried across with ``convert`` and rebuilt on its device,
    with ``rows[leaf]`` appended to each leaf named ``"group.field"``."""
    from raytpu_torch.core import convert

    arrays = convert.scene_to_arrays(scene)
    for key, new in rows.items():
        arrays[key] = np.concatenate([arrays[key], np.asarray(new, arrays[key].dtype)])
    return convert.scene_from_arrays(arrays, scene.device)


def nine_lights(scene):
    """The chunked fixtures' lights: nine white point lights of intensity
    15 at y = 8, x in {-3, 0, 3} (outer), z in {0, 3, 6} (inner)."""
    from raytpu_torch.core import convert

    return convert.with_point_lights(scene, NINE_LIGHTS, 15.0)


def sphere_grid(scene):
    """reference_s106: 100 Lambert spheres of radius 0.2 in the scene's
    white material (id 2) at x = -4.05 + 0.9 i, y = 0.5, z = 1.5 + 0.8 j."""
    centers = [(-4.05 + 0.9 * i, 0.5, 1.5 + 0.8 * j) for i in range(10) for j in range(10)]
    return _appended(scene, {"spheres.center": centers, "spheres.radius": [0.2] * 100,
                             "spheres.material": [2] * 100})


def far_light(scene):
    """``scene`` (optional) with its first light 3 cm above the ceiling
    (y = 10): every shadow ray toward it crosses the ceiling just before the
    light, where the plane's margin is the light's distance minus t, the
    branch of K6 that writes g_mags."""
    import dataclasses

    pos = scene.lights.position.clone()
    pos[0] = torch.tensor([0.0, 10.03, 5.0], device=pos.device)
    return dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, position=pos))


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
    for cfg in (full, RenderConfig(width=50, height=37)):
        # the whole frame (32x32 pixel tiles at 640x480) against row-major
        # tile ranges, the last ending past the frame
        whole = ck.render_image_mega_f32(ref_scene, cfg)
        nt = -(-(cfg.width * cfg.height) // 1024)
        cuts = sorted({0, 1, nt // 3, nt - 1, nt + 1})
        flat = torch.cat([ck.render_image_mega_f32(ref_scene, cfg, tile0=a, tiles=b - a)
                          for a, b in zip(cuts, cuts[1:])])
        n = cfg.width * cfg.height
        if (not torch.equal(flat[:n].view(torch.int32), whole.reshape(-1, 3).view(torch.int32))
                or flat[n:].any()):
            raise AssertionError(f"K1 reference {cfg.width}x{cfg.height}: the whole frame is not "
                                 f"its tile ranges {cuts}, bit for bit")
        print(f"phase 2: K1 reference {cfg.width}x{cfg.height}: the whole frame equals its tile "
              f"ranges {cuts} bit for bit, black past the frame", flush=True)
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
    version's; K2b equal bit for bit to its plain version on K2a's buffer,
    to K11b's image on the same buffer and worklists and to its own launch
    over records that pass every group (the box tests drop no occluder);
    K2a's buffer and boxes equal bit for bit to K11a's and to its own
    launch's over such records, and on the pixel-sharded bunny render's
    tile ranges (``_k2a_tile_ranges``); the route (K2a then K2b) against
    the plain route, under the megakernel budget."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import LightingMode, RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, packed, plain

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
            glo, ghi, records = accel.normal_boxes(sc.triangles)
            wl, cnt = mega2.primary_worklists(sc, cfg, group_bounds=(glo, ghi))
            acc, bounds = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg)
            # K2a is K11a's closest pass: its buffer and boxes equal K11a's on
            # the same worklists and records, and its own launch's over open
            # records (the fold over every listed triangle), bit for bit
            blob = mega3.pack_groups(buf, counts)
            for other, what in ((mega3.mega3_closest(buf, counts, blob, records, wl, cnt, cfg),
                                 "K11a's"),
                                (mega2.mega2_closest(buf, counts, open_records(records), wl, cnt,
                                                     cfg), "its own over open records")):
                if not (_same_bits(acc, other[0]) and _same_bits(bounds, other[1])):
                    raise AssertionError(f"K2a {name} {case}: buffer or boxes not {what}")
            wl_s, cnt_s = mega2.shadow_worklists(sc, cfg, bounds, (glo, ghi))
            img = mega2.mega2_shade(buf, counts, records, wl_s, cnt_s, acc, cfg)
            img_o = mega2.mega2_shade(buf, counts, open_records(records), wl_s, cnt_s, acc, cfg)
            img11 = mega3.mega3_shade(buf, counts, blob, packed.shadow_records(records), wl_s,
                                      cnt_s, acc, cfg)
            acc_p, bounds_p = mega2.mega2_closest_plain(buf, counts, cfg)
            img_on_acc = mega2.mega2_shade_plain(buf, counts, acc, cfg)
            if not all(_same_bits(img, x) for x in (img_o, img11, img_on_acc)):
                raise AssertionError(f"K2b {name} {case}: not its plain version's image, its own "
                                     f"launch's over open records or K11b's, bit for bit")
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
                  f"{box_diff:.3e}, rays differing {a_flips:.5f}, buffer and boxes equal bit for "
                  f"bit to K11a's and to K2a's over open records; K2b {got['K2b']}, equal bit for "
                  f"bit to its plain version, K11b's image and K2b over open records; route "
                  f"{got['route']}", flush=True)
    _k2a_tile_ranges(built["bunny"])
    return worst


def _k2a_tile_ranges(scene) -> None:
    """K2a on the pixel-sharded bunny render's tile ranges at 640x480 (the
    two ranks' [0, nt // 2) and [nt // 2, nt), and a range ending in a
    padded tile past the frame): each range's buffer and boxes equal K11a's
    on the same range bit for bit, and the whole frame's columns and rows
    of its tiles; a padded tile's rays miss and its box is empty."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, plain

    cfg = RenderConfig(width=W, height=H)
    buf, counts = plain.mega_pack(scene, cfg)
    blob = mega3.pack_groups(buf, counts)
    glo, ghi, records = accel.normal_boxes(scene.triangles)
    nt = mega2.num_tiles(cfg)
    whole = mega2.mega2_closest(buf, counts, records,
                                *mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi)), cfg)
    for t0, k in ((0, nt // 2), (nt // 2, nt - nt // 2), (nt - 2, 3)):
        wl, cnt = mega2.primary_worklists(scene, cfg, t0, k, (glo, ghi))
        acc, bounds = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg, t0, k)
        acc11, bounds11 = mega3.mega3_closest(buf, counts, blob, records, wl, cnt, cfg, t0, k)
        inside = min(k, nt - t0)
        if not (_same_bits(acc, acc11) and _same_bits(bounds, bounds11)
                and _same_bits(acc[:, :inside * 1024],
                               whole[0][:, t0 * 1024:(t0 + inside) * 1024].contiguous())
                and _same_bits(bounds[:inside], whole[1][t0:t0 + inside])):
            raise AssertionError(f"K2a bunny tiles [{t0}, {t0 + k}): not K11a's on the range, or "
                                 f"not the whole frame's")
        if k > inside and not (torch.isinf(acc[0, inside * 1024:]).all()
                               and torch.isinf(bounds[inside:]).all()):
            raise AssertionError(f"K2a bunny tiles [{t0}, {t0 + k}): a padded tile hit something")
    print(f"phase 2: K2a bunny {W}x{H} tile ranges [0, {nt // 2}), [{nt // 2}, {nt}), "
          f"[{nt - 2}, {nt + 1}): buffer and boxes equal bit for bit to K11a's on each range and "
          f"to the whole frame's", flush=True)


def phase_compare_mega3(dev, built: dict) -> dict:
    """K11a and K11b against their plain versions (K2's) and against K2a and
    K2b on optional, bunny50k and bunny300k: at 640x480 (the main path's
    shapes) every CMP_TILE_STRIDE-th tile, through the plain versions' tile
    ranges, and at MEGA3_PLAIN_SIZE whole; K11's buffer, boxes and image
    must equal K2's bit for bit.  Then the tile ranges of K1 (reference),
    K2 (bunny) and K11 (bunny50k), two ranges and a padded tile past the
    frame, against their whole frames at 640x480, bit for bit."""
    from raytpu_torch.core import math3d
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.render import mega2, mega3, packed, plain

    worst = {k: {"max_abs_diff": 0.0, "flip_frac": 0.0} for k in ("K11a", "K11b")}
    for name, _ in MEGA3_PATHS:
        scene = built[name]
        for w, h in ((W, H), MEGA3_PLAIN_SIZE):
            cfg = RenderConfig(width=w, height=h)
            buf, counts = plain.mega_pack(scene, cfg)
            blob = mega3.pack_groups(buf, counts)
            wl, cnt = mega2.primary_worklists(scene, cfg)
            records = accel.normal_boxes(scene.triangles)[2]
            acc, bounds = mega3.mega3_closest(buf, counts, blob, records, wl, cnt, cfg)
            # the walk over records that pass every group: the fold over every
            # listed triangle, which the walk must equal bit for bit
            acc_o, bounds_o = mega3.mega3_closest(buf, counts, blob, open_records(records), wl,
                                                  cnt, cfg)
            wl_s, cnt_s = mega2.shadow_worklists(scene, cfg, bounds)
            boxes = packed.shadow_records(records)
            img = mega3.mega3_shade(buf, counts, blob, boxes, wl_s, cnt_s, acc, cfg)
            acc2, bounds2 = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg)
            img2 = mega2.mega2_shade(buf, counts, records, wl_s, cnt_s, acc2, cfg)
            torch.cuda.synchronize()
            if img.shape != (h, w, 3) or not torch.isfinite(img).all():
                raise AssertionError(f"K11 {name} {w}x{h}: output {tuple(img.shape)} not finite")
            differ = int((img != img2).any(dim=-1).sum())
            if not (torch.equal(acc, acc2) and torch.equal(bounds, bounds2)) or differ:
                raise AssertionError(f"K11 {name} {w}x{h}: not K2's buffer, boxes or image "
                                     f"({differ} pixels differ)")
            if not (_same_bits(acc, acc_o) and _same_bits(bounds, bounds_o)):
                raise AssertionError(f"K11a {name} {w}x{h}: not its own launch over open records")
            nt = mega2.num_tiles(cfg)
            tiles = range(0, nt, CMP_TILE_STRIDE) if w * h > CMP_MAX_RAYS else range(nt)
            step = CMP_TILE_STRIDE if w * h > CMP_MAX_RAYS else nt
            px, py, valid = accel.tile_pixels(w, h, mega2.is_tiled(cfg), dev)
            a_worst = b_worst = flips_worst = 0.0
            for t0 in range(0, nt, step):
                k = 1 if step != nt else nt
                sl = slice(t0 * 1024, (t0 + k) * 1024)
                acc_p, bounds_p = mega2.mega2_closest_plain(buf, counts, cfg, t0, k)
                a_diff, _, a_flips = _acc_diff(acc[:, sl], acc_p)
                box_diff, _, _ = _acc_diff(bounds[t0:t0 + k].T, bounds_p.T)
                if a_flips > 1e-4:
                    raise AssertionError(f"K11a {name} {w}x{h} tile {t0}: {a_flips:.5f} of rays "
                                         f"differ")
                # K11b's plain version on K11a's buffer, at the tiles' pixels
                cols = mega2.mega2_shade_plain(buf, counts, acc[:, sl].contiguous(), cfg, t0, k)
                v = valid[sl]
                got = img[py[sl][v], px[sl][v]]
                b_diff = float((got - cols[v]).abs().max())
                flips, _ = close_u8(math3d.quantize_u8(got).cpu().numpy()[None],
                                    math3d.quantize_u8(cols[v]).cpu().numpy()[None], 0.01, 0.5)
                a_worst = max(a_worst, a_diff, box_diff)
                b_worst, flips_worst = max(b_worst, b_diff), max(flips_worst, flips)
            _worst(worst["K11a"], a_worst, 0.0)
            _worst(worst["K11b"], b_worst, flips_worst)
            print(f"phase 2: K11 {name} {w}x{h} ({len(tiles)} of {nt} tiles checked): K11a vs "
                  f"plain max|diff| {a_worst:.3e}, K11b vs plain {b_worst:.3e} (flips "
                  f"{flips_worst:.5f}); vs K2: buffer, boxes and image equal (0 pixels differ); "
                  f"K11a over open records: buffer and boxes equal, bit for bit", flush=True)
    cfg = RenderConfig(width=W, height=H)
    nt = mega2.num_tiles(cfg)
    for key, name, fn in (("K1", "reference", ck.render_image_mega_f32),
                          ("K2", "bunny", mega2.render_image_mega2_f32),
                          ("K11", "bunny50k", mega3.render_image_mega3_f32)):
        whole = fn(built[name], cfg)
        split = nt // 3
        flat = torch.cat([fn(built[name], cfg, tile0=0, tiles=split),
                          fn(built[name], cfg, tile0=split, tiles=nt + 1 - split)])
        if flat[W * H:].any():
            raise AssertionError(f"{key} tile range: rays past the frame are not black")
        flat = flat[:W * H]
        if key != "K1":
            flat = packed.mega2_unfold_rows(flat, H, W)
        if not torch.equal(flat.reshape(H, W, 3), whole):
            raise AssertionError(f"{key} tile ranges on {name} differ from the whole frame")
        print(f"phase 2: {key} tile ranges [0, {split}) + [{split}, {nt + 1}) on {name} {W}x{H}: "
              f"equal to the whole frame, bit for bit", flush=True)
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


def open_records(records):
    """Closest-walk records like ``records`` that pass every group
    (``accel.open_normal_boxes``): a walk over them folds every listed
    triangle."""
    from raytpu_torch.ops import accel

    return accel.open_normal_boxes(records.shape[0], records.device)[:, :records.shape[1]] \
        .contiguous()


def _same_bits(a, b) -> bool:
    """Equal bit for bit (NaN patterns and signed zeros included)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def phase_compare_packed(dev, built: dict) -> dict:
    """K3 and K4 against their plain versions on bunny50k's and bunny300k's
    camera rays at 640x480 (the main path's shapes), 160x128 (tiled) and
    50x37: K3 must pick the plain version's winner on >= 99.99% of rays,
    with t within 1e-6 relative, the same material and the normal within
    1e-6 where it does, and equal its own launch over records that pass
    every group bit for bit; K4, on the shadow rays of K3's hits, must agree on
    >= 99.9% of (light, ray) pairs.  Then the packed route against the
    eager path at 160x128: the pixels that differ are counted (raytpu's
    packed route equals its jnp path) and held to the megakernel budget."""
    from raytpu_torch.core import math3d
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, renderer

    out = {"K3": {"max_abs_diff": 0.0, "flip_frac": 0.0},
           "K4": {"max_abs_diff": 0.0, "flip_frac": 0.0}, "packed_vs_eager": {}}
    for name in ("bunny50k", "bunny300k"):
        scene = built[name]
        blobs = packed.soft_packs(scene)
        for w, h in PACKED_CMP_SIZES:
            cfg = RenderConfig(width=w, height=h)
            ro, rd = _folded_rays(scene, cfg)
            glo, ghi, records = accel.normal_boxes(scene.triangles)
            wl, cnt = packed.closest_worklists(scene, ro, rd, cfg.ray_min, group_bounds=(glo, ghi))
            t, idx, normal, mat = packed.winner_search(ro, rd, *blobs, records, wl, cnt,
                                                       cfg.ray_min)
            opened = packed.winner_search(ro, rd, *blobs, open_records(records), wl, cnt,
                                          cfg.ray_min)
            if not all(_same_bits(a, b) for a, b in zip((t, idx, normal, mat), opened)):
                raise AssertionError(f"K3 {name} {w}x{h}: not its own launch over open records")
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
                  f"max|normal diff| {n_diff:.3e}; equal to K3 over open records, bit for bit; "
                  f"K4 on {tuple(occ.shape)} (L, R): {k4_flip:.6f} "
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


def _soft_queries(scene, cfg):
    """The soft shadow queries ``(p, dirs, mags)`` of the differentiable main
    path at ``cfg``: camera rays in tile order, K3's closest hit, the offset
    points and each light's direction and distance."""
    from raytpu_torch.render import packed, renderer

    ro, rd = _folded_rays(scene, cfg)
    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, cfg.ray_min)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    return tuple(x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))


def _rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_compare_soft(dev, built: dict) -> dict:
    """K5, K6 and K7 against their plain versions on the soft shadow queries
    of optional at 640x480 (the main path's shapes), bunny50k at 160x128
    and bunny300k at 64x64, with a random cotangent.  Each kernel launches
    on the whole frame; K5 and K6 are checked on every CMP_TILE_STRIDE-th
    tile, K7 (a sum
    over every ray) against its plain version over every ray.  K5 must be
    within 1e-5, K6 and K7 within 1e-4 of each output's largest magnitude;
    K7 launches twice, to show how far its atomic sums move between runs,
    and K6 twice, whose launches must give the same bits (no atomics).
    K5 must equal itself bit for bit over records that pass every listed
    group (its soft box tests skip only factors of exactly 1), and K7 and
    K6 on the gradient records (``soft.grad_boxes``) their walks over such
    records (their box tests skip only partials of exactly 0): K7 within
    1e-4 of the largest (the order of its atomic sums changes), K6 bit for
    bit."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, soft

    out = {k: {"max_abs_diff": 0.0, "max_rel_err": 0.0} for k in ("K5", "K6", "K7")}
    out["K7_run_to_run"] = 0.0
    for name, (w, h) in SOFT_CMP:
        scene = built[name]
        cfg = RenderConfig(width=w, height=h, soft_shadows=True)
        tmin, beta = cfg.ray_min, cfg.soft_beta
        p, dirs, mags = _soft_queries(scene, cfg)
        blobs = packed.soft_packs(scene)
        gen = torch.Generator(device=dev).manual_seed(0)
        trans, (_, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, tmin, beta)
        every = soft.soft_trans_lights_cuda(
            p, dirs, mags, *blobs,
            accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), dev), wl, cnt, tmin,
            beta)
        if not torch.equal(trans, every):
            raise AssertionError(f"K5 {name}: the soft box tests changed "
                                 f"{int((trans != every).sum())} (light, ray) pairs")
        g = torch.rand(trans.shape, generator=gen, device=dev) * 2.0 - 1.0
        grad_boxes = soft.grad_boxes(scene, beta)
        opened = accel.open_normal_boxes(grad_boxes.shape[0], dev)
        ray = soft.soft_dray(p, dirs, mags, g, trans, *blobs, wl, cnt, tmin, beta, grad_boxes)
        ray2 = soft.soft_dray(p, dirs, mags, g, trans, *blobs, wl, cnt, tmin, beta, grad_boxes)
        ray_every = soft.soft_dray(p, dirs, mags, g, trans, *blobs, wl, cnt, tmin, beta, opened)
        prim = soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, tmin, beta, grad_boxes)
        prim2 = soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, tmin, beta,
                                grad_boxes)
        prim_every = soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, tmin, beta,
                                     opened)
        sub = _cmp_rays(p.shape[0], dev)
        ps, ds, ms, gs, ts = (p[sub].contiguous(), dirs[:, sub].contiguous(),
                              mags[:, sub].contiguous(), g[:, sub].contiguous(),
                              trans[:, sub].contiguous())
        t0 = time.perf_counter()
        trans_p = soft.soft_trans_plain(ps, ds, ms, *blobs, tmin, beta)
        ray_p = soft.soft_dray_plain(ps, ds, ms, gs, ts, *blobs, tmin, beta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prim_p = soft.soft_dprim_plain(p, dirs, mags, g, trans, blobs[2], tmin, beta)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for x in (trans, *ray, prim):
            if not torch.isfinite(x).all():
                raise AssertionError(f"soft kernels {name}: an output is not finite")
        errs = {"K5": (float((trans[:, sub] - trans_p).abs().max()), None),
                "K6": (max(float((a - b).abs().max()) for a, b in zip(
                    (ray[0][sub], ray[1][:, sub], ray[2][:, sub]), ray_p)),
                    max(_rel_err(a, b) for a, b in zip(
                        (ray[0][sub], ray[1][:, sub], ray[2][:, sub]), ray_p))),
                "K7": (float((prim - prim_p).abs().max()), _rel_err(prim, prim_p))}
        run_to_run = float((prim - prim2).abs().max())
        vs_every = _rel_err(prim, prim_every)
        # K6 sums no rays: two launches give the same bits, and over open
        # records it adds the same partials in the same order
        k6_repeat = all(_same_bits(a, b) for a, b in zip(ray, ray2))
        k6_every = all(_same_bits(a, b) for a, b in zip(ray, ray_every))
        g_mags_max = float(ray_p[2].abs().max())
        print(f"phase 2: K5-K7 {name} {w}x{h}, (L, R) {tuple(trans.shape)}, {sub.numel()} rays "
              f"checked for K5 and K6, all for K7: K5 max|diff| {errs['K5'][0]:.3e}, equal bit "
              f"for bit to its walk over every listed group; K6 max|diff| "
              f"{errs['K6'][0]:.3e} ({errs['K6'][1]:.3e} of the largest, g_mags max "
              f"{g_mags_max:.3e}), its two launches equal bit for bit: {k6_repeat}, to its walk "
              f"over every listed group: {k6_every}; K7 max|diff| {errs['K7'][0]:.3e} "
              f"({errs['K7'][1]:.3e} of the largest), run to run {run_to_run:.3e}, against its "
              f"walk over every listed group {vs_every:.3e} of the largest; transmittance < 1 on "
              f"{float((trans < 1.0).float().mean()):.4f} of pairs; plain K5+K6 {t1 - t0:.1f}s, "
              f"plain K7 {t2 - t1:.1f}s", flush=True)
        if (errs["K5"][0] > 1e-5 or errs["K6"][1] > 1e-4 or errs["K7"][1] > 1e-4
                or vs_every > 1e-4 or not (k6_repeat and k6_every)):
            raise AssertionError(f"soft kernels {name} {w}x{h} disagree with their plain versions: "
                                 f"{errs}")
        if name.endswith("far_light") and not g_mags_max > 0.0:
            raise AssertionError(f"soft kernels {name}: g_mags is zero, K6's far-end branch unheld")
        for k, (a, r) in errs.items():
            out[k]["max_abs_diff"] = max(out[k]["max_abs_diff"], a)
            out[k]["max_rel_err"] = max(out[k]["max_rel_err"], r or 0.0)
        out["K7_run_to_run"] = max(out["K7_run_to_run"], run_to_run)
    out["function_vs_autograd"] = _function_vs_autograd(dev, built)
    return out


def _function_vs_autograd(dev, built: dict) -> float:
    """The soft transmittance's autograd Function (K5 forward, K6, K7 and
    the sphere and plane cotangents of ``_scene_cotangent`` backward)
    against plain autograd of the eager transmittance, every input's
    gradient within 1e-3 of its largest magnitude (the VJP tolerance); the
    sphere and plane cotangents must be non-zero in some case."""
    import dataclasses

    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import soft as gsoft

    keys = ("p", "dirs", "mags", "sphere.center", "sphere.radius", "plane.origin", "plane.normal",
            "tri.v0", "tri.v1", "tri.v2")
    worst, largest = 0.0, dict.fromkeys(keys, 0.0)
    for name, (w, h) in SOFT_FUNCTION_CMP:
        scene = built[name]
        cfg = RenderConfig(width=w, height=h, soft_shadows=True)
        p, dirs, mags = _soft_queries(scene, cfg)
        gen = torch.Generator(device=dev).manual_seed(2)
        g = torch.rand(mags.shape, generator=gen, device=dev) * 2.0 - 1.0
        sph, pln, tri = scene.spheres, scene.planes, scene.triangles
        grads = {}
        for kernels in (True, False):
            leaves = [x.detach().clone().requires_grad_(True) for x in (
                p, dirs, mags, sph.center, sph.radius, pln.origin, pln.normal, tri.v0, tri.v1,
                tri.v2)]
            s = dataclasses.replace(
                scene, spheres=dataclasses.replace(sph, center=leaves[3], radius=leaves[4]),
                planes=dataclasses.replace(pln, origin=leaves[5], normal=leaves[6]),
                triangles=dataclasses.replace(tri, v0=leaves[7], v1=leaves[8], v2=leaves[9]))
            out = gsoft.soft_trans_lights(kernels, cfg.ray_min, cfg.soft_beta, s, *leaves[:3])
            got = torch.autograd.grad(out, leaves, g, allow_unused=True)
            grads[kernels] = [torch.zeros_like(x) if d is None else d for d, x in zip(got, leaves)]
        errs = {k: _rel_err(a, b) if b.numel() else 0.0
                for k, a, b in zip(keys, grads[True], grads[False])}
        big = {k: float(b.abs().max()) if b.numel() else 0.0 for k, b in zip(keys, grads[False])}
        print(f"phase 2: soft Function vs autograd, {name} {w}x{h}: worst diff over the largest "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; largest "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in big.items()})}", flush=True)
        if not all(torch.isfinite(x).all() for x in grads[True]) or max(errs.values()) > 1e-3:
            raise AssertionError(f"soft Function {name} disagrees with plain autograd: {errs}")
        worst = max(worst, *errs.values())
        largest = {k: max(largest[k], big[k]) for k in keys}
    if not all(largest[k] > 0.0 for k in ("sphere.center", "sphere.radius", "plane.origin",
                                           "plane.normal")):
        raise AssertionError(f"a sphere or plane cotangent is zero in every case: {largest}")
    return worst


def _first_hit_diff(t, tp, idx=None, idxp=None):
    """(share of rays whose winner agrees, max |t diff| and max relative t
    diff where they agree): winners by index when given, else by whether
    the ray hits."""
    same = (idx == idxp) if idx is not None else (torch.isfinite(t) == torch.isfinite(tp))
    both = same & torch.isfinite(tp)
    t_diff = float((t - tp).abs()[both].max()) if both.any() else 0.0
    t_rel = float(((t - tp).abs() / tp.abs())[both].max()) if both.any() else 0.0
    return float(same.float().mean()), t_diff, t_rel, same


def phase_compare_chunked(dev, built: dict) -> dict:
    """K8, K9 and K10 against their plain versions on optional_l12 at 640x480
    (the main path's shapes; every CMP_TILE_STRIDE-th tile checked) and on
    bunny18k_l12 and reference_s106 at 160x128.  K8's closest mode on the
    camera rays: the winner on >= 99.99% of rays, with t within 1e-6
    relative and the same material and normal (within 1e-6) where it
    agrees; its shadow mode on every light's shadow queries of those hits,
    flattened into one batch: the same first occluder on >= 99.99% of
    queries.  K9 on the same queries: every (light, ray) pair equal, and
    equal on the whole frame to its launches over every listed triangle
    (without records, and over records that pass every group); and so on
    optional_l12's row-major camera rays at 640x480 (``shade_rays``'
    order), with the share of its warps that mix misses and hits.
    K10 on K8's records: the megakernel budget, and equal bit for bit to
    itself over records that pass every group of every listed chunk (the box
    tests drop no occluder).  Also optional_l12 at 50x37, a frame that does
    not fold.  Then the route's light cap: optional with 24 lights renders,
    with 25 the route and K9 raise."""
    from raytpu_torch.core import convert, math3d
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked, cuda_kernel, packed, plain, renderer

    out = {k: {"max_abs_diff": 0.0, "flip_frac": 0.0} for k in ("K8", "K9", "K10")}
    for name, (w, h) in CHUNKED_CMP:
        scene = built[name]
        cfg = RenderConfig(width=w, height=h)
        tmin = cfg.ray_min
        if cuda_kernel.route_kind(scene, cfg) != "chunked":
            raise AssertionError(f"{name} does not take the chunked route")
        blobs = packed.soft_packs(scene)
        ro, rd = _folded_rays(scene, cfg)
        R, L = rd.shape[0], scene.lights.count
        sub = _cmp_rays(R, dev)
        records = chunked.frame_records(scene)
        t, idx, normal, mat = chunked.scene_min_t(scene, ro, rd, tmin, records=records)
        tp, idxp, normalp, matp = plain.chunked_min_t_plain(ro[sub], rd[sub], None, *blobs, tmin,
                                                            False)
        torch.cuda.synchronize()
        agree, t_diff, t_rel, same = _first_hit_diff(t[sub], tp, idx[sub], idxp)
        n_diff = float((normal[sub] - normalp).abs()[same].max()) if same.any() else 0.0
        if (agree < 0.9999 or t_rel > 1e-6 or n_diff > 1e-6
                or not torch.equal(mat[sub][same], matp[same])):
            raise AssertionError(f"K8 {name} {w}x{h}: winners agree on {agree:.6f} of rays, t "
                                 f"within {t_rel:.3e} relative, normals within {n_diff:.3e}, or "
                                 f"the materials differ")
        # the shadow queries of K8's hits, every light's flattened into one batch
        rec = chunked.closest_hit_chunked(scene, ro, rd, tmin)
        p_off, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
        t_s, *_ = chunked.scene_min_t(scene, p_off.repeat(L, 1), dirs.reshape(-1, 3), tmin,
                                      mags.reshape(-1), shadow=True, records=records)
        k8_same = _k8_walks_equal(scene, records, ro, rd, (t, idx, normal, mat), p_off, dirs,
                                  mags, t_s, tmin)
        sub_s = (torch.arange(L, device=dev)[:, None] * R + sub[None, :]).reshape(-1)
        tp_s, *_ = plain.chunked_min_t_plain(p_off.repeat(L, 1)[sub_s], dirs.reshape(-1, 3)[sub_s],
                                             mags.reshape(-1)[sub_s], *blobs, tmin, True)
        occ = chunked.any_hit_lights_chunked(scene, p_off, dirs, mags, tmin)
        occp = packed.any_hit_lights_plain(p_off[sub].contiguous(), dirs[:, sub].contiguous(),
                                           mags[:, sub].contiguous(), *blobs, tmin)
        boxes_s, wl_s, cnt_s = chunked.shadow_inputs(scene, p_off, dirs, mags, tmin)
        occ_every = _k9_every(p_off, dirs, mags, blobs, boxes_s, wl_s, cnt_s, tmin)
        torch.cuda.synchronize()
        s_agree, s_diff, s_rel, _ = _first_hit_diff(t_s[sub_s], tp_s)
        k9_flip = float((occ[:, sub] != occp).float().mean())
        if s_agree < 0.9999 or s_rel > 1e-6:
            raise AssertionError(f"K8 shadow mode {name}: {s_agree:.6f} of queries agree, first "
                                 f"occluder's t within {s_rel:.3e}")
        if k9_flip or not all(torch.equal(occ, x) for x in occ_every):
            raise AssertionError(f"K9 {name}: {k9_flip:.5f} of (light, ray) pairs differ from "
                                 f"the plain version, or its answers from its own launches "
                                 f"over every listed triangle")
        # K10 on K8's records, launched on the whole frame
        colors = chunked.shadow_shade_chunked(scene, rec, rd, cfg)
        colors_p = plain.shadow_shade_plain(
            rec.hit[sub], rec.normal[sub], rec.point[sub], rec.material[sub], rd[sub], p_off[sub],
            dirs[:, sub], mags[:, sub], plain.pack_lights(scene.lights),
            plain.material_table(scene.materials), *blobs, cfg)
        torch.cuda.synchronize()
        if not torch.isfinite(colors).all():
            raise AssertionError(f"K10 {name}: colors are not finite")
        k10_diff = float((colors[sub] - colors_p).abs().max())
        flips, mean = close_u8(math3d.quantize_u8(colors[sub]).cpu().numpy()[None],
                               math3d.quantize_u8(colors_p).cpu().numpy()[None], 0.01, 0.5)
        every = chunked.shadow_shade(
            rec.hit, rec.normal.contiguous(), rec.point.contiguous(), rec.material, rd, p_off,
            dirs, mags, plain.pack_lights(scene.lights), plain.material_table(scene.materials),
            *blobs, accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), dev), wl_s,
            cnt_s, cfg)
        if not torch.equal(colors, every):
            raise AssertionError(f"K10 {name} {w}x{h}: the box tests changed "
                                 f"{int((colors != every).any(dim=1).sum())} pixels")
        print(f"phase 2: K8 {name} {w}x{h} ({sub.numel()} of {R} rays checked): winners agree "
              f"{agree:.6f}, max|t diff| {t_diff:.3e} (rel {t_rel:.3e}), max|normal diff| "
              f"{n_diff:.3e}; shadow mode on {L} x {sub.numel()} queries: first occluders agree "
              f"{s_agree:.6f} (max|t diff| {s_diff:.3e}); {k8_same}; "
              f"K9 on {tuple(occ.shape)} (L, R): "
              f"{k9_flip:.6f} of pairs differ, occluded share {float(occp.float().mean()):.4f}, "
              f"equal to its launches over every listed triangle; "
              f"K10 max|f32 diff| {k10_diff:.3e} flips {flips:.5f} mean {mean:.5f}, equal bit "
              f"for bit to its walk over every listed group", flush=True)
        _worst(out["K8"], max(t_diff, n_diff, s_diff), max(1.0 - agree, 1.0 - s_agree))
        _worst(out["K9"], float((occ[:, sub] != occp).any()), k9_flip)
        _worst(out["K10"], k10_diff, flips)
    # K9 on shade_rays' rays: row-major, unfolded, at the main path's size
    scene, cfg = built["optional_l12"], RenderConfig(width=W, height=H)
    blobs = packed.soft_packs(scene)
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    ro = ro.expand_as(rd).contiguous()
    rec = chunked.closest_hit_chunked(scene, ro, rd, cfg.ray_min)
    p_off, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    sub = _cmp_rays(rd.shape[0], dev)
    occ = chunked.any_hit_lights_chunked(scene, p_off, dirs, mags, cfg.ray_min)
    occp = packed.any_hit_lights_plain(p_off[sub].contiguous(), dirs[:, sub].contiguous(),
                                       mags[:, sub].contiguous(), *blobs, cfg.ray_min)
    occ_every = _k9_every(p_off, dirs, mags, blobs,
                          *chunked.shadow_inputs(scene, p_off, dirs, mags, cfg.ray_min),
                          cfg.ray_min)
    torch.cuda.synchronize()
    differ = int((occ[:, sub] != occp).sum())
    if differ or not all(torch.equal(occ, x) for x in occ_every):
        raise AssertionError(f"K9 on shade_rays' rays: {differ} (light, ray) pairs differ from "
                             f"the plain version, or from its launches over every listed triangle")
    warps = rec.hit[:rd.shape[0] // 32 * 32].reshape(-1, 32)
    mixed = float((warps.any(dim=1) & ~warps.all(dim=1)).float().mean())
    print(f"phase 2: K9 optional_l12 {W}x{H} on shade_rays' row-major rays ({sub.numel()} of "
          f"{rd.shape[0]} rays checked): 0 pairs differ, equal to its launches over every listed "
          f"triangle; misses {int((~rec.hit).sum())}, warps mixing misses and hits {mixed:.4f}",
          flush=True)
    # the light cap: 24 lights render through the route, 25 raise
    cfg = RenderConfig(width=CHUNKED_PLAIN_SIZE[0], height=CHUNKED_PLAIN_SIZE[1])
    more = [(-3.0 + 1.5 * (k % 5), 8.0, float(k // 5)) for k in range(22)]
    l24, l25 = (convert.with_point_lights(built["optional"], more[:n], 5.0) for n in (21, 22))
    img = cuda_kernel.render_image(l24, cfg)
    torch.cuda.synchronize()
    if l24.lights.count != 24 or cuda_kernel.route_kind(l24, cfg) != "chunked" or not img.any():
        raise AssertionError("optional with 24 lights did not render through the chunked route")
    queries = (torch.zeros((8, 3), device=dev), torch.ones((25, 8, 3), device=dev),
               torch.ones((25, 8), device=dev))
    reset_launch_counts()
    refused = []
    for fn in (lambda: cuda_kernel.render_image(l25, cfg),
               lambda: chunked.any_hit_lights_chunked(l25, *queries, cfg.ray_min)):
        try:
            fn()
        except ValueError as e:
            refused.append(str(e))
    if len(refused) != 2 or any(launch_counts().values()):
        raise AssertionError(f"25 lights did not raise before a launch: {refused}, "
                             f"{launch_counts()}")
    print(f"phase 2: chunked route with 24 lights: {tuple(img.shape)} frame, mean "
          f"{float(img.float().mean()):.2f}; with 25: ValueError ({refused[0]}; {refused[1]})",
          flush=True)
    return out


def _k8_walks_equal(scene, records, ro, rd, closest, p_off, dirs, mags, t_s, tmin) -> str:
    """K8's answers of the route (``closest``, the closest mode's (t, idx,
    normal, material) of ``ro``, ``rd``, and ``t_s``, the shadow mode's t of
    every light's queries flattened) against its launches on the same
    worklists over every listed triangle: without records (the fold) and
    over records that pass every group (the walk).  Raises unless every
    word is equal."""
    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked, packed

    blobs = packed.soft_packs(scene)
    bounds = None if records is None else records[:2]
    L = dirs.shape[0]
    ps, ds, ms = p_off.repeat(L, 1), dirs.reshape(-1, 3), mags.reshape(-1).contiguous()
    wl, cnt = packed.closest_worklists(scene, ro, rd, tmin, group=chunked.CHUNK,
                                       group_bounds=bounds)
    wl_s, cnt_s = packed.closest_worklists(scene, ps, ds, tmin, ms, group=chunked.CHUNK,
                                           group_bounds=bounds)
    opened = accel.open_normal_boxes(-(-blobs[2].shape[0] // accel.GROUP), rd.device)
    for b in (None, opened):
        got = chunked.chunked_min_t(ro, rd, None, *blobs, wl, cnt, tmin, False, b)
        got_s = chunked.chunked_min_t(ps, ds, ms, *blobs, wl_s, cnt_s, tmin, True, b)[0]
        if not (all(_same_bits(a, c) for a, c in zip(got, closest)) and _same_bits(got_s, t_s)):
            raise AssertionError(f"K8 {'without records' if b is None else 'over open records'}:"
                                 f" its answers differ from the route's")
    return ("K8 both modes equal, bit for bit, to its fold over every listed triangle and its "
            "walk over open records" + ("" if records else " (no records: the fold)"))


def _k9_every(p, dirs, mags, blobs, boxes, wl, cnt, tmin) -> list:
    """K9's answers over every listed triangle: its launch without records
    and, where the scene has records, over records that pass every group
    (``accel.open_normal_boxes``)."""
    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked

    out = [chunked.any_hit_lights(p, dirs, mags, *blobs, None, wl, cnt, tmin)]
    if boxes is not None:
        out.append(chunked.any_hit_lights(p, dirs, mags, *blobs,
                                          accel.open_normal_boxes(boxes.shape[0], p.device), wl,
                                          cnt, tmin))
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


def phase_chunked_paths(dev, built: dict) -> dict:
    """The chunked route at 640x480 on its fixtures (CHUNKED_PATHS), each
    with the launch counts set to 0 just before its frames and read just
    after: one K8 and one K10 a frame, no other kernel; every frame a
    finite (H, W, 3) uint8 image that is not black; frame 0 against the
    eager path at 160x128 (the pixels that differ counted, the megakernel
    budget held).  Then chunked.shade_rays (one K8, one K9) on
    optional_l12's camera rays against the route's image, and the per-stage
    profiler on STAGE_SCENES with each prefix's launches."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import chunked, cuda_kernel, render_image, renderer
    from raytpu_torch.utils import stage_profile

    config = RenderConfig(width=W, height=H)
    small = RenderConfig(width=CHUNKED_PLAIN_SIZE[0], height=CHUNKED_PLAIN_SIZE[1])
    out = {}
    for name, frames, _, base in CHUNKED_PATHS:
        spec, scene = scenes.get(base), built[name]
        if cuda_kernel.route_kind(scene, config) != "chunked":
            raise AssertionError(f"{name} routes to {cuda_kernel.route_kind(scene, config)}")
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)  # as bench.py:92
        t0 = time.perf_counter()
        reset_launch_counts()
        imgs = [render_image(spec.animate(scene, ts[i]), config) for i in range(frames)]
        torch.cuda.synchronize()
        counts = launch_counts()
        seconds = time.perf_counter() - t0
        _check_counts(name, "chunked", frames, counts)
        for img in imgs:
            if img.shape != (H, W, 3) or img.dtype != torch.uint8 or not bool(img.any()):
                raise AssertionError(f"{name}: frame is {tuple(img.shape)} {img.dtype} or black")
        first = spec.animate(scene, ts[0])
        a = render_image(first, small).cpu().numpy()
        b = renderer.render_image(first, small).cpu().numpy()
        differ = int((a != b).any(axis=-1).sum())
        flips, mean = close_u8(a, b, 0.01, 0.5)
        print(f"phase 3: {name}: {frames} frames through chunked in {seconds:.2f}s, launches "
              f"{counts}; frame 0 vs the eager path at {small.width}x{small.height}: {differ} "
              f"pixels differ (flips {flips:.5f}, mean {mean:.5f})", flush=True)
        out[name] = {"frames": frames, "route": "chunked", "launches": counts,
                     "pixels_differing_vs_eager": differ}
    # chunked.shade_rays: K8 for the closest hit, K9 for every light's shadows
    scene = built["optional_l12"]
    ro, rd = renderer.generate_rays(scene.camera, config)
    reset_launch_counts()
    colors = chunked.shade_rays(scene, ro, rd, config)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: int(k in ("K8", "K9")) for k in counts}
    if counts != want:
        raise AssertionError(f"chunked.shade_rays launched {counts}, expected {want}")
    a = math3d.quantize_u8(colors.reshape(H, W, 3)).cpu().numpy()
    b = render_image(scene, config).cpu().numpy()
    flips, mean = close_u8(a, b, 0.01, 0.5)
    print(f"phase 3: chunked.shade_rays optional_l12 {W}x{H}: launches {counts}; vs the route: "
          f"{int((a != b).any(axis=-1).sum())} pixels differ (flips {flips:.5f}, mean "
          f"{mean:.5f})", flush=True)
    out["shade_rays"] = {"launches": counts}
    # the per-stage profiler, each prefix's launches counted on one frame
    out["stages"] = {}
    for name in STAGE_SCENES:
        spec = scenes.get(ANIMATED_BY.get(name, name))
        scene = built[name]
        prefix = {}
        for stage, fn in stage_profile.prefix_fns(config, kernels=True).items():
            reset_launch_counts()
            float(fn(scene))
            prefix[stage] = {k: v for k, v in launch_counts().items() if v}
        if prefix["closest_hit"] != {"K8": 1} or prefix["shadow"] != {"K8": 1, "K9": 1}:
            raise AssertionError(f"stage prefixes of {name} launched {prefix}")
        report = stage_profile.profile_stages(spec, scene, config, kernels=True, frames=16)
        print(f"phase 3: stages of {name} at {W}x{H} (kernels=True, 16 frames, best of 3), "
              f"launches per prefix {json.dumps(prefix)}:\n"
              + stage_profile.format_report(report), flush=True)
        out["stages"][name] = {"launches_per_prefix": prefix, "report": report}
    return out


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


def phase_mega3_paths(dev, built: dict) -> dict:
    """``render_image_mega3_f32`` over MEGA3_PATHS' animated frames at
    640x480, the launch counts set to 0 just before each scene's frames and
    read just after: one K11a and one K11b a frame, no other kernel; every
    frame a finite, not black image, and frame 0 equal to the mega2 route's
    (K2) frame, bit for bit."""
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import mega2, mega3

    config = RenderConfig(width=W, height=H)
    out = {}
    for name, frames in MEGA3_PATHS:
        spec, scene = scenes.get(name), built[name]
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)  # as bench.py:92
        t0 = time.perf_counter()
        reset_launch_counts()
        imgs = [math3d.quantize_u8(mega3.render_image_mega3_f32(spec.animate(scene, ts[i]),
                                                                config)) for i in range(frames)]
        torch.cuda.synchronize()
        counts = launch_counts()
        seconds = time.perf_counter() - t0
        _check_counts(name, "mega3", frames, counts)
        for img in imgs:
            if img.shape != (H, W, 3) or not bool(img.any()):
                raise AssertionError(f"{name}: mega3 frame is {tuple(img.shape)} or black")
        k2 = math3d.quantize_u8(mega2.render_image_mega2_f32(spec.animate(scene, ts[0]), config))
        differ = int((imgs[0] != k2).any(dim=-1).sum())
        if differ:
            raise AssertionError(f"{name}: mega3 frame 0 differs from K2's in {differ} pixels")
        print(f"phase 3: {name}: {frames} frames through mega3 in {seconds:.2f}s, launches "
              f"{counts}; frame 0 vs K2's: 0 pixels differ", flush=True)
        out[name] = {"frames": frames, "route": "mega3", "launches": counts}
    return out


def _gloo_cuda_collectives() -> dict:
    """Which collectives gloo takes on CUDA tensors, two ranks on the card."""
    from raytpu_torch.parallel import launch

    code = (
        "import json, sys, torch, torch.distributed as dist\n"
        "r = int(sys.argv[1]); dist.init_process_group('gloo', init_method=sys.argv[2], "
        "world_size=2, rank=r)\n"
        "x = torch.full((4,), float(r + 1), device='cuda'); out = {}\n"
        "for name, fn in (('all_reduce', lambda: dist.all_reduce(x.clone())),\n"
        "                 ('broadcast', lambda: dist.broadcast(x.clone(), 0)),\n"
        "                 ('all_gather', lambda: dist.all_gather(\n"
        "                     [torch.empty_like(x) for _ in range(2)], x))):\n"
        "    try:\n"
        "        fn(); out[name] = 'taken'\n"
        "    except Exception as e:\n"
        "        out[name] = 'refused: ' + str(e).splitlines()[0][:100]\n"
        "print(json.dumps(out)); dist.destroy_process_group()\n")
    url = f"tcp://127.0.0.1:{launch.free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), url], stdout=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError(f"gloo collective probe failed: {outs}")
    return json.loads(outs[0].strip().splitlines()[-1])


def phase_sharded(dev, built: dict) -> dict:
    """The sharded paths: SHARDED_CASES on two gloo ranks sharing the card
    (``parallel.launch.spawn``), each rank's launches counted around each
    sharded call.  Every image must equal the single-process render bit for
    bit, every kernel of the case launch once on each rank, and the
    sharded train step match the single-process step (loss rtol 2e-2, every
    parameter change within 3e-3 of the largest, the grad tests' rule) with the
    parameters equal on both ranks.  Times show function on one card, not
    scaling."""
    from raytpu_torch.parallel import launch

    taken = _gloo_cuda_collectives()
    print(f"phase 3: gloo on CUDA tensors: {taken}", flush=True)
    outdir = tempfile.mkdtemp(prefix="raytpu_torch_ranks_")
    t0 = time.perf_counter()
    results = launch.spawn(2, outdir, "cuda", SHARDED_CASES, timeout=600.0)
    seconds = time.perf_counter() - t0
    totals = {}
    for case in SHARDED_CASES:
        name = case["name"]
        for r in results:
            res = r["cases"][name]
            want = {k: 1 for k in SHARDED_KERNELS[name]}
            if res["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: launches {res['launches']}, "
                                     f"expected {want}")
            for k, n in res["launches"].items():
                totals[k] = totals.get(k, 0) + n
            if case.get("train"):
                if not (res["params_equal_on_ranks"] and res["delta_diff_over_largest"] <= 3e-3
                        and math.isclose(res["loss_sharded"], res["loss_single"], rel_tol=2e-2)):
                    raise AssertionError(f"{name} rank {r['rank']}: {res}")
            elif not res["identical"]:
                raise AssertionError(f"{name} rank {r['rank']}: {res['pixels_differ']} pixels "
                                     f"differ from the single-process render")
        res = results[0]["cases"][name]
        what = (f"loss {res['loss_sharded']:.6f} vs {res['loss_single']:.6f} single, parameter "
                f"changes within {res['delta_diff_over_largest']:.2e} of the largest"
                if case.get("train") else f"0 pixels differ from the {res['reference']} render")
        print(f"phase 3: sharded {name} {res['mesh']} on 2 gloo ranks, one card: launches per "
              f"rank {res['launches']}, {what}; {res['seconds'] * 1e3:.2f} ms (function, not "
              f"scaling)", flush=True)
    print(f"phase 3: the two ranks took {seconds:.2f}s in all", flush=True)
    return {"launches": totals, "gloo_cuda": taken,
            "cases": {c["name"]: results[0]["cases"][c["name"]] for c in SHARDED_CASES}}


def _fit(fit: str):
    """(pick, merge) of a fit's parameters (raytpu_torch.grad.diff_render)."""
    import dataclasses

    from raytpu_torch.grad import diff_render as dr

    if fit == "material":
        return dr.material_params, dr.merge_material_params

    def pick(s):
        return {"position": s.lights.position, "mesh_positions": s.meshes.positions}

    def merge(s, p):
        s = dataclasses.replace(s, lights=dataclasses.replace(s.lights, position=p["position"]))
        return s.with_meshes(s.meshes.with_positions(p["mesh_positions"]))

    return pick, merge


def phase_grad_paths(dev, built: dict) -> dict:
    """The differentiable main paths (bench.py:50-54): train steps of SGD on
    mean((image - 0)^2) through render_soft_f32 at 640x480, on the kernels.
    One step first (not counted), then the counts are set to 0, the steps
    run, and the counts are read: K3 and K5 once a step, K6 (its walk and
    its light sum, K6sum) and K7 once a step in the light and mesh fit and
    never in a material fit, no other kernel.  The loss must fall over each fit, and every gradient be
    finite.  Each fit's steps are timed on the host clock to a synchronize,
    its peak memory read, and one more step profiled for the idle share."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render as dr

    cfg = RenderConfig(width=W, height=H)
    target = torch.zeros((H, W, 3), device=dev)
    out = []
    for name, steps, fit, payload_grad, lr in GRAD_PATHS:
        scene = built[name]
        if not dr.kernels_fit(scene):
            raise AssertionError(f"{name} does not take the differentiable path's kernels")
        pick, merge = _fit(fit)
        params = dr.trainable(pick(scene))
        step = dr.make_train_step(cfg, torch.optim.SGD(params.values(), lr=lr), merge,
                                  payload_grad=payload_grad)
        losses = [float(step(params, scene, target))]  # the first step, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        losses += [step(params, scene, target) for _ in range(steps)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [float(x) for x in losses]
        want = {k: 0 for k in counts}
        want.update(K3=steps, K5=steps)
        if fit != "material":
            want.update(K6=steps, K6sum=steps, K7=steps)  # K6: its walk and its light sum
        if counts != want:
            raise AssertionError(f"{name} {fit}: {steps} steps launched {counts}, expected {want}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"{name} {fit}: the loss did not fall: {losses}")
        for k, v in params.items():
            if v.grad is None or not torch.isfinite(v.grad).all():
                raise AssertionError(f"{name} {fit}: gradient of {k} missing or not finite")
        top = []
        acts, busy_ms = frame_breakdown(lambda: step(params, scene, target), 1, top)
        idle = None if busy_ms is None else 1.0 - busy_ms / step_ms
        line = {"scene": name, "size": f"{W}x{H}", "fit": fit, "payload_grad": payload_grad,
                "steps": steps, "lr": lr, "launches": counts,
                "launches_per_step": {k: v / steps for k, v in counts.items() if v},
                "step_ms": step_ms, "step_device_activities": acts, "step_device_busy_ms": busy_ms,
                "device_idle_share": idle, "peak_memory_bytes": peak, "losses": losses,
                "top_device_kernels_ms": top}
        print(f"phase 3: grad {name} {fit} payload_grad={payload_grad}: {steps} steps, launches "
              f"{counts}; {step_ms:.2f} ms per fwd+bwd step, {acts} device activities, busy "
              f"{busy_ms} ms, idle share {idle}; peak memory {peak / 2**30:.2f} GiB; loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; most device time: "
              + "; ".join(f"{ms:.2f} ms {name}" for ms, name in top[:3]), flush=True)
        out.append(line)
    return out


def _grads_close(name: str, got, want, rtol=2e-2, atol=3e-3) -> float:
    """tests/test_grad_fast.py:65's gradient tolerance; returns the worst
    |got - want| over the largest |want|."""
    scale = max(float(want.abs().max()), 1e-12)
    if not torch.isfinite(got).all() or bool(
            ((got - want).abs() > rtol * want.abs() + atol * scale + 1e-8).any()):
        raise AssertionError(f"{name}: kernel-route gradient differs from the eager route's "
                             f"({_rel_err(got, want):.3e} of the largest)")
    return _rel_err(got, want)


def phase_grad_vs_eager(dev, built: dict) -> dict:
    """The kernel route's image and gradients (every material, light and
    geometry parameter) against the eager route's, on optional at 160x128,
    for the loss sum(image * weights).  The eager route holds (rays x
    triangles) residuals, so it runs its rays in chunks, each rendered and
    backpropagated on its own, the gradients summed: the same gradient as
    one pass.  Images within rtol 2e-2, atol 3e-3 on >= 99% of pixels (a
    soft gate at t = tmin on a grazing ray goes either way), gradients
    within rtol 2e-2 and 3e-3 of the largest (tests/test_grad_fast.py:65)."""
    import dataclasses

    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render as dr
    from raytpu_torch.grad import fast
    from raytpu_torch.render import renderer

    name, (w, h), chunk = GRAD_VS_EAGER
    scene = built[name]
    cfg = RenderConfig(width=w, height=h, soft_shadows=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    wt = torch.rand((h, w, 3), generator=gen, device=dev)
    groups = {"material": (dr.material_params, dr.merge_material_params),
              "light": (dr.light_params, dr.merge_light_params),
              "geometry": (dr.geometry_params, dr.merge_geometry_params)}

    def merged(params):
        s = scene
        for g, (_, merge) in groups.items():
            s = merge(s, params[g])
        return s

    kp = {g: dr.trainable(pick(scene)) for g, (pick, _) in groups.items()}
    reset_launch_counts()
    img_k = dr.render_soft_f32(merged(kp), cfg, kernels=True)
    (img_k * wt).sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    ep = {g: dr.trainable(pick(scene)) for g, (pick, _) in groups.items()}
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    img_e = []
    for i in range(0, w * h, chunk):
        colors = renderer.render_pixels_f32(merged(ep), ro, rd[i:i + chunk],
                                            dataclasses.replace(cfg, ray_chunk=chunk),
                                            closest_fn=fast.detached_closest_hit)
        (colors * wt.reshape(-1, 3)[i:i + chunk]).sum().backward()
        img_e.append(colors.detach())
    img_e = torch.cat(img_e).reshape(h, w, 3)
    torch.cuda.synchronize()
    off = ((img_k.detach() - img_e).abs() > 3e-3 + 2e-2 * img_e.abs()).any(dim=-1)
    if float(off.float().mean()) > 0.01:
        raise AssertionError(f"kernel route image differs from the eager route on "
                             f"{int(off.sum())} pixels")
    worst = {}
    for g in groups:
        for k, v in ep[g].items():
            if v.grad is None:
                continue
            worst[f"{g}.{k}"] = _grads_close(f"{g}.{k}", kp[g][k].grad, v.grad)
    print(f"phase 3: kernel route vs eager route, {name} {w}x{h} ({w * h // chunk} eager chunks): "
          f"launches {counts}; image max|diff| {float((img_k.detach() - img_e).abs().max()):.3e}, "
          f"{int(off.sum())} pixels beyond the tolerance; gradients, worst diff over the largest: "
          f"{json.dumps(worst)}", flush=True)
    return {"pixels_beyond": int(off.sum()), "grad_rel_err": worst, "launches": counts}


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


def k1_tests(scene, config) -> dict:
    """The primitive tests K1 runs on this frame's data, by pass and kind:
    every ray tests every sphere, plane and triangle for its closest hit;
    each hit ray's shadow query for each light tests spheres, then planes,
    then triangles, up to its first occluder (decisions from the eager
    path, as ``count_ops`` takes them)."""
    from raytpu_torch.ops import intersect
    from raytpu_torch.render.renderer import generate_rays, shadow_query_inputs

    S, P, T, L = scene.spheres.count, scene.planes.count, scene.triangles.count, scene.lights.count
    R = config.width * config.height
    out = {"closest": {"sphere": R * S, "plane": R * P, "triangle": R * T},
           "shadow": {"sphere": 0, "plane": 0, "triangle": 0}}
    if not (config.shadows and S + P + T):
        return out
    ro, rd = generate_rays(scene.camera, config)
    rec = intersect.closest_hit(scene, ro.expand_as(rd), rd, config.ray_min)
    p_off, dirs, mags = shadow_query_inputs(scene, rec, config)
    for li in range(L):
        occ = torch.isfinite(intersect.scene_t_matrix(scene, p_off, dirs[li], config.ray_min,
                                                      mags[li], shadow_pass=True))[rec.hit]
        first = torch.where(occ.any(dim=1), occ.to(torch.int8).argmax(dim=1), S + P + T)
        for kind, lo, n in (("sphere", 0, S), ("plane", S, P), ("triangle", S + P, T)):
            out["shadow"][kind] += int(torch.clamp(first - lo + 1, 0, n).sum())
    return out


def k1_sass(scene, config) -> dict:
    """K1's primitive tests in SASS instructions (``sass_loops``): each
    pass's and kind's fewest instructions a test over its innermost loops
    (an unrolled loop and its remainder), times this frame's tests of that
    pass and kind (``k1_tests``).  A loop is the closest pass's when no
    other loop holds it, the shadow queries' when the lights' loop does; a
    sphere loop takes square roots and no division, plane and triangle
    loops a division a test and no square root, a triangle's more than 20
    FP32 operations a division.  Raygen, the hit's tail and the shading
    are not counted; a test that returns an early miss skips part of its
    loop's instructions, so the sum is an estimate of the tests' share, not
    a bound.  ``instructions`` is None when some pass and kind has no
    loop."""
    loops = sass_loops("mega_kernel")
    cost = {}
    for lp in loops:
        if lp["sqrt"] and not lp["rcp"]:
            kind, tests = "sphere", lp["sqrt"]
        elif lp["rcp"] and not lp["sqrt"]:
            kind, tests = "plane" if lp["fp32"] <= 20 * lp["rcp"] else "triangle", lp["rcp"]
        else:
            continue
        key = ("shadow" if lp["nested"] else "closest", kind)
        cost[key] = min(cost.get(key, math.inf), lp["instructions"] / tests)
    out = {"loops": loops, "instructions": None}
    if len(cost) != 6:
        return out
    tests = k1_tests(scene, config)
    per_test = {f"{p} {k}": n for (p, k), n in sorted(cost.items())}
    total = sum(n * tests[p][k] for (p, k), n in cost.items())
    out.update({"per_test": per_test, "tests": tests, "instructions": total,
                "per_ray": total / (config.width * config.height)})
    return out


def frame_breakdown(frame, n: int, top: list | None = None):
    """(device activities per frame, device-busy ms per frame) over ``n``
    calls of ``frame`` under torch.profiler, or (None, None) when the
    profiler records no device activity.  ``top``, if given, receives the
    six device kernels with the most time per frame, as (ms, name)."""
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
    if top is not None:
        by_name = {}
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        top.extend(sorted(((ms, name[:90]) for name, ms in by_name.items()), reverse=True)[:6])
    return len(dev) / n, sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n


def _bound(ops: float, nbytes: float) -> dict:
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def ptxas_usage(entry: str) -> dict:
    """Registers and spill bytes that ptxas printed in phase 1's build for
    the first kernel entry whose mangled name holds ``entry``."""
    import re

    from raytpu_torch.render import build

    lines = build.last_build_log.splitlines()
    i = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln and entry in ln)
    spill = next(ln for ln in lines[i:] if "spill stores" in ln)
    regs = next(ln for ln in lines[i:] if "registers" in ln and "Used" in ln)
    stores, loads = (int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", spill))
    return {"registers": int(re.search(r"Used (\d+) registers", regs).group(1)),
            "spill_store_bytes": stores, "spill_load_bytes": loads}


_SASS = {}


def sass_loops(entry: str) -> list:
    """The innermost loops of the first kernel in the built library whose
    mangled name holds ``entry``, from ``cuobjdump -sass``: a loop runs
    from a backward branch's target to the last branch back to it.  Per
    loop: its instructions (NOPs left out), MUFU.RCP (one a division or
    reciprocal), MUFU.RSQ and MUFU.SQRT (one a square root), FP32 adds,
    multiplies and fused multiply-adds, and whether another loop holds it."""
    import re

    from raytpu_torch.render import build

    if "dump" not in _SASS:
        tool = Path(build.nvcc_path()).with_name("cuobjdump")
        _SASS["dump"] = subprocess.run([str(tool), "-sass", str(build.BUILD_DIR / build.LIB_NAME)],
                                       capture_output=True, text=True, check=True,
                                       timeout=300).stdout
    funcs = re.split(r"\n\s*Function : ", _SASS["dump"])
    body = next(f for f in funcs[1:] if entry in f.split("\n", 1)[0])
    insts, labels, pending = [], {}, []
    for ln in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2).strip()
        for lab in pending:
            labels[lab] = addr
        pending = []
        words = text.split()
        op = words[1] if words[0].startswith("@") else words[0]
        insts.append((addr, op, text))
    heads = {}
    for addr, op, text in insts:
        if op.startswith("BRA"):
            m = re.search(r"\((\.L_x_\d+)\)", text) or re.search(r"(0x[0-9a-f]+)", text)
            target = labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)
            if target is not None and target <= addr:
                heads[target] = max(heads.get(target, 0), addr)
    loops = sorted(heads.items())
    inner = [(a, b) for a, b in loops
             if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b) for a2, b2 in loops)]
    out = []
    for a, b in inner:
        ops = [op for addr, op, _ in insts if a <= addr <= b and op != "NOP"]
        out.append({"start": a, "instructions": len(ops),
                    "nested": any(a2 <= a and b <= b2 and (a2, b2) != (a, b) for a2, b2 in loops),
                    "rcp": sum(op.startswith("MUFU.RCP") for op in ops),
                    "sqrt": sum(op.startswith(("MUFU.RSQ", "MUFU.SQRT")) for op in ops),
                    "fp32": sum(op.split(".")[0] in ("FADD", "FMUL", "FFMA") for op in ops)})
    return out


def time_frames(spec, scene, config, frames: int, dev, render=None):
    """(frame ms, primary rays/s, device activities and busy ms per frame,
    idle share): animated frames through ``render`` (default render_image),
    as a user's loop."""
    from raytpu_torch.render import render_image
    from raytpu_torch.utils.profiling import device_ms

    render = render or render_image
    ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)
    frame_i = [0]

    def frame():
        render(spec.animate(scene, ts[frame_i[0] % frames]), config)
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
    issue_rate = FP32_LANES * _sm_clock_hz()
    usage = ptxas_usage("mega_kernel")
    sass = k1_sass(scene, config)
    issue_ms = bound["ops"] / issue_rate * 1e3
    sass_ms = None if sass["instructions"] is None else sass["instructions"] / issue_rate * 1e3
    # the tests' instructions each counted whole: an early miss skips part of one
    print(f"phase 4: K1 reference: kernel {kernel_ms:.4f} ms, frame {frame_ms:.4f} ms "
          f"({rays_per_s:.4e} primary rays/s), plain {plain_ms:.3f} ms at {W}x{H}; "
          f"{bound['ops']:.4e} FP32 ops -> {bound['ops_ms']:.4f} ms at 67 TFLOP/s, "
          f"{issue_ms:.4f} ms at the non-FMA issue rate ({issue_rate:.4e} op/s), "
          f"{bound['bytes']} B -> {bound['bytes_ms']:.6f} ms at 3.35 TB/s; SASS: "
          f"{sass.get('per_ray')} test instructions a ray, each test counted whole -> "
          f"{sass_ms} ms at the issue rate "
          f"(per test {json.dumps(sass.get('per_test'))}; loops {json.dumps(sass['loops'])}); "
          f"ptxas {json.dumps(usage)}; per frame {acts} device activities, busy {busy_ms} ms, "
          f"idle share {idle}; {env['nvidia_smi']}", flush=True)
    kernel = {"name": "mega", "id": "K1", "route": "cuda",
              "source": "raytpu_torch/render/csrc/mega.cu",
              "replaces": "raytpu/render/pallas_kernel.py:879", "launches": main["launches"],
              "max_abs_err": worst["max_abs_diff"], "max_abs_diff": worst["max_abs_diff"],
              "flip_frac": worst["flip_frac"], "ms": kernel_ms, "plain_ms": plain_ms,
              "plain_size": f"{W}x{H}", "library_ms": None, **bound, **usage,
              "issue_bound_ms": issue_ms, "sass_test_instructions_per_ray": sass.get("per_ray"),
              "sass_tests_ms": sass_ms}
    line = {"scene": "reference", "size": f"{W}x{H}", "frames": FRAMES, "route": "mega",
            "launches": {"K1": main["launches"]}, "kernel_ms": {"K1": kernel_ms},
            "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
            "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
            "device_idle_share": idle, "golden_t0": main["golden_t0"],
            "golden_t1.25": main["golden_t1.25"], "card": env["nvidia_smi"]}
    return kernel, line


def _group_tris(T: int, dev, group: int = 8):
    """Triangles in each group of ``group`` (the last one may hold fewer)."""
    ng = -(-T // group)
    return torch.clamp(T - group * torch.arange(ng, device=dev), max=group).to(torch.float64)


def _worklist_tris(wl, cnt, T: int, group: int = 8):
    """Triangles each worklist row walks: its passing groups' sizes summed."""
    used = torch.arange(wl.shape[-1], device=wl.device) < cnt[..., None]
    return torch.where(used, _group_tris(T, wl.device, group)[wl.long()], 0.0).sum(dim=-1)


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


def shadow_box_stats(p, dirs, mags, queried, wl, cnt, boxes, T: int, occ, S: int, P: int,
                     chunk: int = 8, soft_ops=None, frame: dict | None = None, slots=None):
    """What the box tests leave of each light's shadow worklists, for the
    queries of a kernel on the shadow walk (K4, K11b, K10, K5): origins
    ``p`` (R, 3) in tile order, ``dirs`` (L, R, 3), ``mags`` (L, R),
    ``queried`` (R,) the rays the kernel asks about, ``wl`` (nt, L, n) and
    ``cnt`` (nt, L) the worklists, of 8-triangle groups or, with ``chunk`` =
    128, of chunks that the walk expands to their 16 groups (K10), ``boxes``
    the box records (8 columns, or the normal records), ``occ`` (L, R) the
    answers, or None for the soft walk (K5), which has no occluded
    shortcut and costs ``soft_ops`` = (per sphere, per plane, per triangle)
    operations.  Per light: groups listed per query; groups whose padded
    box the query's segment crosses (``accel.tight_segment_box_test``) and
    whose box widened for the ray does (``accel.segment_box_test``, the
    kernels' test); for the normal records also kappa's widening of the same
    boxes (what the kappa walk would leave) and the share of (query, listed
    group) pairs whose widening the triangles' normals narrow;
    the union of the widened groups over each of the kernels' warps
    (``slots`` (32, 32), the tile slot of each warp's lanes, by default
    ``accel.warp_slots``; K9's warps take 32 consecutive rays); the
    occluded share; and the box-culled count of
    FP32 operations: every sphere and plane, and the triangle test on every
    triangle of every group whose padded box the segment crosses, for a
    query that finds no occluder, one test for one that does (where it is
    found is not counted).  No box test is counted, and the triangles are
    counted per ray, not per warp, with the padded box and not the wider one
    the kernels need for the triangle test's rounding: a lower bound for
    any walk over these groups.  ``frame``, if given, receives the union
    over every light: ``listed_groups``, the groups some queried row lists
    (each record the walk reads), and ``crossed_groups`` with
    ``crossed_group_tris``, the groups whose padded box some query's
    segment crosses and their triangles (each triangle record the walk
    must read), for the bound's bytes."""
    from raytpu_torch.ops import accel

    L, R = dirs.shape[:2]
    normals = boxes.shape[1] == accel.NORMAL_COLS
    nt, step, dev = -(-R // 1024), 1 if normals else 4, p.device
    ng, k_exp = boxes.shape[0], chunk // accel.GROUP
    group_tris = _group_tris(T, dev)
    slots = (accel.warp_slots(dev) if slots is None else slots).flatten()
    tri_ops, sp_ops = ((soft_ops[2], S * soft_ops[0] + P * soft_ops[1]) if soft_ops
                       else (OPS_TRI_SHADOW, S * OPS_SPHERE + P * OPS_PLANE))
    listed_g = torch.zeros((ng,), dtype=torch.bool, device=dev)
    crossed_g = torch.zeros((ng,), dtype=torch.bool, device=dev)
    out = []
    for li in range(L):
        inv = accel.inv_dir(dirs[li])
        acc = dict.fromkeys(("listed", "crossed", "widened", "kappa", "narrowed", "tris", "union",
                             "warps", "ops"), 0.0)
        for t0 in range(0, nt, step):
            t1 = min(nt, t0 + step)
            k, r0, r1 = t1 - t0, t0 * 1024, min(t1 * 1024, R)
            c = cnt[t0:t1, li].long()
            cmax = int(c.max())

            def tiles(x, fill):
                pad = k * 1024 - (r1 - r0)
                x = torch.cat([x[r0:r1], x.new_full((pad, *x.shape[1:]), fill)])
                return x.reshape(k, 1024, *x.shape[1:])

            q = tiles(queried, False)
            live = q if occ is None else q & ~tiles(occ[li], True)
            if cmax == 0:
                continue
            # the walk's entries: each listed group, or each chunk's 16 groups
            e = torch.arange(cmax * k_exp, device=dev)
            g = wl[t0:t1, li, :cmax].long().repeat_interleave(k_exp, dim=1) * k_exp + e % k_exp
            used = (e // k_exp < c[:, None]) & (g < ng)
            g = torch.where(used, g, 0)
            acc["listed"] += float((used.sum(dim=1).to(torch.float64) * q.sum(dim=1)).sum())
            d = tiles(dirs[li], 0.0)
            args = (tiles(p, 0.0), tiles(inv, 1.0), tiles(mags[li], 0.0), boxes[g])
            keep = used[:, None, :] & q[..., None]
            cross = accel.tight_segment_box_test(*args) & keep
            wide = accel.segment_box_test(*args, d=d) & keep
            listed_g[g[used & q.any(dim=1)[:, None]]] = True
            crossed_g[g[:, None, :].expand_as(cross)[cross]] = True
            if normals:
                acc["kappa"] += float((accel.segment_box_test(*args[:3], boxes[g][..., :8])
                                       & keep).sum())
                acc["narrowed"] += float((accel.narrowed(d, boxes[g]) & keep).sum())
            tris = (cross.to(torch.float64) * group_tris[g][:, None, :]).sum(dim=-1)
            acc["crossed"] += float(cross.sum())
            acc["widened"] += float(wide.sum())
            acc["tris"] += float(tris[q].sum())
            acc["ops"] += float(tris[live].sum()) * tri_ops
            warp_q = q[:, slots].reshape(k, 32, 32).any(dim=2)
            acc["union"] += float(wide[:, slots].reshape(k, 32, 32, -1).any(dim=2).sum())
            acc["warps"] += float(warp_q.sum())
        n_q = float(queried.sum())
        n_occ = 0.0 if occ is None else float((occ[li] & queried).sum())
        acc["ops"] += (n_q - n_occ) * sp_ops + n_occ * OPS_PLANE
        per_q = max(n_q, 1.0)
        st = {"listed_per_query": acc["listed"] / per_q, "crossed_per_query": acc["crossed"] / per_q,
              "widened_per_query": acc["widened"] / per_q,
              "crossed_tris_per_query": acc["tris"] / per_q,
              "union_per_warp": acc["union"] / max(acc["warps"], 1.0),
              "occluded_share": n_occ / per_q, "ops": acc["ops"]}
        if normals:
            st["kappa_widened_per_query"] = acc["kappa"] / per_q
            st["narrowed_share"] = acc["narrowed"] / max(acc["listed"], 1.0)
        out.append(st)
    if frame is not None:
        frame.update(listed_groups=int(listed_g.sum()), crossed_groups=int(crossed_g.sum()),
                     crossed_group_tris=float(group_tris[crossed_g].sum()))
    return out


def closest_box_stats(ro, rd, t_final, queried, wl, cnt, boxes, T: int, chunk: int = 8) -> dict:
    """What the closest walk's box tests leave of each tile's worklist, for
    K3's, K11a's or K8's rays: ``ro``, ``rd`` (R, 3) in tile order,
    ``t_final`` (R,) their closest hits (inf on a miss), ``queried`` (R,)
    the rays the kernel answers, ``wl`` (nt, n) and ``cnt`` (nt,) the
    worklists, of 8-triangle groups or, with ``chunk`` = 128, of chunks
    that the walk expands to their 16 groups (K8), ``boxes`` the walk's
    records.  Per ray: groups listed; groups whose
    record, widened for the ray (``accel.segment_box_test``), its segment
    [0, t_final] crosses, and the triangles in them; groups that its whole
    line (mag = inf) crosses; the union of the former over each of the
    kernels' warps (``accel.warp_slots``); and ``tris``, the triangles of
    the groups crossed up to t_final summed over the rays: the box-culled
    count of triangle tests, no box tests, a lower bound for a walk that
    meets a ray's hit only after its t falls (the walk tests the segment up
    to the current t, never shorter than t_final).  Over the frame:
    ``listed_groups``, the groups some worklist lists (each record the walk
    reads), and ``crossed_groups`` with ``crossed_group_tris``, the groups
    some ray crosses up to t_final and their triangles (each triangle
    record it must read), for the bound's bytes."""
    from raytpu_torch.ops import accel

    R, dev = rd.shape[0], rd.device
    nt, step = -(-R // 1024), 2
    ng, k_exp = boxes.shape[0], chunk // accel.GROUP
    group_tris = _group_tris(T, dev)
    slots = accel.warp_slots(dev).flatten()
    inv = accel.inv_dir(rd)
    acc = dict.fromkeys(("listed", "crossed", "line", "tris", "union", "warps"), 0.0)
    listed_g = torch.zeros((ng,), dtype=torch.bool, device=dev)
    crossed_g = torch.zeros((ng,), dtype=torch.bool, device=dev)
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        k, r0, r1 = t1 - t0, t0 * 1024, min(t1 * 1024, R)
        c = cnt[t0:t1].long()
        cmax = int(c.max())

        def tiles(x, fill):
            pad = k * 1024 - (r1 - r0)
            x = torch.cat([x[r0:r1], x.new_full((pad, *x.shape[1:]), fill)])
            return x.reshape(k, 1024, *x.shape[1:])

        q = tiles(queried, False)
        if cmax == 0:
            continue
        e = torch.arange(cmax * k_exp, device=dev)
        g = wl[t0:t1, :cmax].long().repeat_interleave(k_exp, dim=1) * k_exp + e % k_exp
        used = (e // k_exp < c[:, None]) & (g >= 0) & (g < ng)
        g = torch.where(used, g, 0)
        keep = used[:, None, :] & q[..., None]
        o, iv, d = tiles(ro, 0.0), tiles(inv, 1.0), tiles(rd, 0.0)
        cross = accel.segment_box_test(o, iv, tiles(t_final, 0.0), boxes[g], d=d) & keep
        line = accel.segment_box_test(o, iv, torch.full_like(tiles(t_final, 0.0), float("inf")),
                                      boxes[g], d=d) & keep
        listed_g[g[used & q.any(dim=1)[:, None]]] = True
        crossed_g[g[:, None, :].expand_as(cross)[cross]] = True
        acc["listed"] += float((used.sum(dim=1).to(torch.float64) * q.sum(dim=1)).sum())
        acc["crossed"] += float(cross.sum())
        acc["line"] += float(line.sum())
        acc["tris"] += float((cross.to(torch.float64) * group_tris[g][:, None, :]).sum())
        acc["union"] += float(cross[:, slots].reshape(k, 32, 32, -1).any(dim=2).sum())
        acc["warps"] += float(q[:, slots].reshape(k, 32, 32).any(dim=2).sum())
    n_q = max(float(queried.sum()), 1.0)
    return {"listed_per_ray": acc["listed"] / n_q, "crossed_per_ray": acc["crossed"] / n_q,
            "line_per_ray": acc["line"] / n_q, "crossed_tris_per_ray": acc["tris"] / n_q,
            "union_per_warp": acc["union"] / max(acc["warps"], 1.0), "tris": acc["tris"],
            "listed_groups": int(listed_g.sum()), "crossed_groups": int(crossed_g.sum()),
            "crossed_group_tris": float(group_tris[crossed_g].sum())}


def _print_closest_stats(key: str, name: str, st: dict) -> None:
    print(f"phase 4: {key} {name} boxes: {st['listed_per_ray']:.1f} groups listed per ray, "
          f"{st['crossed_per_ray']:.2f} whose record, widened for the ray, its segment up to the "
          f"closest hit crosses ({st['crossed_tris_per_ray']:.1f} triangles), "
          f"{st['line_per_ray']:.2f} that its whole line crosses, {st['union_per_warp']:.1f} "
          f"crossed up to the hit in the union over a warp; over the frame "
          f"{st['listed_groups']} groups listed, {st['crossed_groups']} crossed up to a hit "
          f"({st['crossed_group_tris']:.0f} triangles)", flush=True)


def _box_bound(ops: float, ops_listed: float, nbytes: float, stats: list,
               nbytes_listed: float | None = None) -> dict:
    """A walk kernel's bound from its box-culled count ``ops`` and bytes
    ``nbytes``, with the count of every listed triangle (``ops_listed``,
    Queue 2's yardstick, over ``nbytes_listed``, default ``nbytes``) beside
    it as ``bound_ms_listed``, and the box statistics."""
    listed = _bound(ops_listed, nbytes if nbytes_listed is None else nbytes_listed)
    return {**_bound(ops, nbytes), "bound_ms_listed": listed["bound_ms"],
            "ops_listed": ops_listed, "box_stats": stats}


def _listed_note(e: dict) -> str:
    return (f"; counting every listed triangle {e['bound_ms_listed']:.4f} ms "
            f"({e['ops_listed']:.4e} FP32 ops)" if "bound_ms_listed" in e else "")


def _print_frame_groups(key: str, name: str, frame: dict) -> None:
    print(f"phase 4: {key} {name} boxes over the frame: {frame['listed_groups']} groups listed, "
          f"{frame['crossed_groups']} whose padded box some query crosses "
          f"({frame['crossed_group_tris']:.0f} triangles)", flush=True)


def _print_box_stats(key: str, name: str, stats: list) -> None:
    for li, st in enumerate(stats):
        kappa = (f" (kappa's widening: {st['kappa_widened_per_query']:.2f}; narrowed on "
                 f"{st['narrowed_share']:.4f} of listed pairs)" if "narrowed_share" in st else "")
        print(f"phase 4: {key} {name} boxes, light {li}: {st['listed_per_query']:.1f} groups "
              f"listed per query, {st['crossed_per_query']:.2f} whose padded box the segment "
              f"crosses ({st['crossed_tris_per_query']:.1f} triangles), "
              f"{st['widened_per_query']:.2f} widened for the ray (the kernels' test){kappa}, "
              f"{st['union_per_warp']:.1f} of those in the union over a warp, occluded share "
              f"{st['occluded_share']:.4f}", flush=True)


def time_mega2(dev, built: dict, name: str, k11: bool = False, plain_size=(W, H)):
    """K2a's and K2b's times at 640x480 beside their bounds, box-culled
    from this frame's worklists and records (every listed triangle beside
    them), and with ``k11`` K11a's and K11b's on the same frame (the same
    work, so the same bounds); the plain versions' times at
    ``plain_size``, the size they see whole."""
    from raytpu_torch.core import math3d
    from raytpu_torch.core.types import LightKind, RenderConfig
    from raytpu_torch.ops import accel, shading
    from raytpu_torch.render import mega2, mega3, packed, plain
    from raytpu_torch.utils.profiling import device_ms

    scene = built[name]
    cfg = RenderConfig(width=W, height=H)
    buf, counts = plain.mega_pack(scene, cfg)
    S, P, T, L = counts
    glo, ghi, records = accel.normal_boxes(scene.triangles)  # as the routes build them
    wl, cnt = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
    acc, bounds = mega2.mega2_closest(buf, counts, records, wl, cnt, cfg)
    wl_s, cnt_s = mega2.shadow_worklists(scene, cfg, bounds, (glo, ghi))
    iters = 50 if T < 10000 else 5
    ms = {"K2a": device_ms(lambda: mega2.mega2_closest(buf, counts, records, wl, cnt, cfg),
                           iters=iters, warmup=3),
          "K2b": device_ms(lambda: mega2.mega2_shade(buf, counts, records, wl_s, cnt_s, acc, cfg),
                           iters=iters, warmup=3)}
    if k11:
        boxes = packed.shadow_records(records)
        blob = mega3.pack_groups(buf, counts)
        ms["K11a"] = device_ms(lambda: mega3.mega3_closest(buf, counts, blob, records, wl, cnt,
                                                           cfg), iters=iters, warmup=3)
        ms["K11b"] = device_ms(lambda: mega3.mega3_shade(buf, counts, blob, boxes, wl_s, cnt_s, acc,
                                                         cfg), iters=iters, warmup=3)
    cfg_p = RenderConfig(width=plain_size[0], height=plain_size[1])
    buf_p, counts_p = plain.mega_pack(scene, cfg_p)
    acc_p = acc if cfg_p == cfg else mega2.mega2_closest_plain(buf_p, counts_p, cfg_p)[0]
    plain_a = device_ms(lambda: mega2.mega2_closest_plain(buf_p, counts_p, cfg_p), iters=1,
                        warmup=0)
    plain_b = device_ms(lambda: mega2.mega2_shade_plain(buf_p, counts_p, acc_p, cfg_p), iters=1,
                        warmup=0)

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
    bounds_of = {"a": _bound(ops_a, bytes_a), "b": _bound(ops_b, bytes_b)}
    shadow_listed = sum(_shadow_ops(S, P, occ[li], hit, tris_s[:, li], nt) for li in range(L))
    # K2b tests the normal records of 8-triangle groups: its count is the
    # box-culled one, its bytes the scene buffer but its triangles, the
    # triangle records of the groups some query crosses and the records of
    # the listed groups, besides the worklists, the buffer in and the image
    # out; every listed triangle and the whole scene buffer in brackets
    frame_b = {}
    stats_b = shadow_box_stats(p_off, dirs, mags, hit, wl_s, cnt_s, records, T, occ, S, P,
                               frame=frame_b)
    _print_box_stats("K2b", name, stats_b)
    _print_frame_groups("K2b", name, frame_b)
    bytes_b_box = (bytes_b - T * plain.TRI_COLS * 4 + frame_b["crossed_group_tris"] * plain.TRI_COLS
                   * 4 + frame_b["listed_groups"] * records.shape[1] * 4)
    bounds_of["K2b"] = _box_bound(ops_b - shadow_listed + sum(st["ops"] for st in stats_b), ops_b,
                                  bytes_b_box, stats_b, bytes_b + records.numel() * 4)
    # K2a and K11a, one closest pass, test the normal records up to each
    # ray's current closest hit: their count is the box-culled one, every
    # listed triangle in brackets
    st = closest_box_stats(torch.stack(ro)[None, :].expand_as(rd), rd, acc[0], valid, wl, cnt,
                           records, T)
    _print_closest_stats("K2a, K11a", name, st)
    ops_box = ops_a - float((tile_rays * _worklist_tris(wl, cnt, T)).sum()) * OPS_TRI
    # bytes: the scene buffer but its triangles, the triangle records of the
    # groups some ray crosses up to its hit, the records of the listed
    # groups, the worklists and the answers
    bytes_box = (bytes_a - T * plain.TRI_COLS * 4 + st["crossed_group_tris"] * plain.TRI_COLS * 4
                 + st["listed_groups"] * records.shape[1] * 4)
    bounds_of["a"] = _box_bound(ops_box + st["tris"] * OPS_TRI, ops_a, bytes_box, [st],
                                bytes_a + records.numel() * 4)
    if k11:  # K11b tests kappa's records: its count is the box-culled one
        stats = shadow_box_stats(p_off, dirs, mags, hit, wl_s, cnt_s, boxes, T, occ, S, P)
        _print_box_stats("K11b", name, stats)
        bounds_of["K11b"] = _box_bound(ops_b - shadow_listed + sum(st["ops"] for st in stats),
                                       ops_b, bytes_b + boxes.numel() * 4, stats)
    for key in ms:
        plain_ms = plain_a if key.endswith("a") else plain_b
        bound = bounds_of.get(key, bounds_of[key[-1]])
        out[key] = {"ms": ms[key], "plain_ms": plain_ms,
                    "plain_size": f"{plain_size[0]}x{plain_size[1]}", **bound}
        if key.startswith("K11"):
            out[key]["k2_ms"] = ms["K2" + key[-1]]
        print(f"phase 4: {key} {name}: {ms[key]:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
              f"{bound['bound_by']} ({bound['ops']:.4e} FP32 ops, {bound['bytes']} B)"
              + _listed_note(bound) + f", plain {plain_ms:.2f} ms at "
              f"{plain_size[0]}x{plain_size[1]}"
              + (f"; K2{key[-1]} on the same frame {ms['K2' + key[-1]]:.4f} ms"
                 if key.startswith("K11") else ""), flush=True)
    out["tests_per_ray"] = float((tile_rays * _worklist_tris(wl, cnt, T)).sum()) / rays
    out["occluded_share"] = float((occ & hit[None]).sum()) / max(n_hit * L, 1.0)
    return out


def time_packed(dev, built: dict, name: str):
    """K3's and K4's times at 640x480 beside their bounds, counted from this
    frame's worklists; the plain versions' times on the first whole frame
    they were compared at (PACKED_PLAIN_SIZE)."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.ops import accel
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
        glo, ghi, records = accel.normal_boxes(scene.triangles)
        wl, cnt = packed.closest_worklists(scene, ro, rd, tmin, group_bounds=(glo, ghi))
        t, idx, normal, mat = packed.winner_search(ro, rd, *blobs, records, wl, cnt, tmin)
        ms3 = device_ms(lambda: packed.winner_search(ro, rd, *blobs, records, wl, cnt, tmin),
                        iters=20, warmup=2)
        rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
        p_off, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
        p_off, dirs, mags = p_off.contiguous(), dirs.contiguous(), mags.contiguous()
        boxes = packed.shadow_records(records)
        wl4, cnt4 = packed.shadow_worklists(scene, p_off, dirs, mags, tmin,
                                            group_bounds=(glo, ghi))
        occ = packed.any_hit_lights(p_off, dirs, mags, *blobs, boxes, wl4, cnt4, tmin)
        ms4 = device_ms(lambda: packed.any_hit_lights(p_off, dirs, mags, *blobs, boxes, wl4,
                                                      cnt4, tmin), iters=20, warmup=2)
        tile_rays = torch.full((nt,), 1024.0, dtype=torch.float64, device=dev)
        tile_rays[-1] = R - 1024 * (nt - 1)
        tris3 = _worklist_tris(wl, cnt, T)
        ops3 = R * (S * OPS_SPHERE + P * OPS_PLANE) + float((tile_rays * tris3).sum()) * OPS_TRI
        blob_bytes = sum(b.numel() for b in blobs) * 4
        bytes3 = (R * 24 + blob_bytes + records.numel() * 4 + (int(cnt.sum()) + cnt.numel()) * 4
                  + R * 24)
        st3 = closest_box_stats(ro, rd, t, torch.ones((R,), dtype=torch.bool, device=dev), wl,
                                cnt, records, T)
        _print_closest_stats("K3", name, st3)
        tris4 = _worklist_tris(wl4, cnt4, T)
        every = torch.ones((R,), dtype=torch.bool, device=dev)
        ops4 = sum(_shadow_ops(S, P, occ[li], every, tris4[:, li], nt) for li in range(L))
        stats = shadow_box_stats(p_off, dirs, mags, every, wl4, cnt4, boxes, T, occ, S, P)
        _print_box_stats("K4", name, stats)
        bytes4 = (R * 12 + L * R * 16 + blob_bytes + boxes.numel() * 4
                  + (int(cnt4.sum()) + cnt4.numel()) * 4 + L * R)
        size = f"{plain_size[0]}x{plain_size[1]}"
        # bytes: rays in, answers out, spheres and planes, the triangle
        # records of the groups some ray crosses up to its hit, the records
        # of the listed groups and the worklists
        bytes3_box = (bytes3 - blobs[2].numel() * 4 - records.numel() * 4
                      + st3["crossed_group_tris"] * blobs[2].shape[1] * 4
                      + st3["listed_groups"] * records.shape[1] * 4)
        out["K3"] = {"ms": ms3, "plain_size": size,
                     **_box_bound(R * (S * OPS_SPHERE + P * OPS_PLANE) + st3["tris"] * OPS_TRI,
                                  ops3, bytes3_box, [st3], bytes3)}
        out["K4"] = {"ms": ms4, "plain_size": size,
                     **_box_bound(sum(st["ops"] for st in stats), ops4, bytes4, stats)}
        out["tests_per_ray"] = float((tile_rays * tris3).sum()) / R
        out["occluded_share"] = float(occ.float().mean())
    for key in ("K3", "K4"):
        e = out[key]
        print(f"phase 4: {key} {name}: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']} ({e['ops']:.4e} FP32 ops, {e['bytes']} B)"
              + _listed_note(e) + f", plain {e['plain_ms']:.2f} ms at {e['plain_size']}",
              flush=True)
    return out


# FP32 operations of soft.cu per test, counted from its source as above (an
# fmaf counts 2, expf 1): tri_soft 65, and K5's multiply into the product 2;
# sphere_soft 28 + 2, plane_soft 24 + 2.  K6 and K7 do tri_soft's 65 on every
# test and their gradient arithmetic only where the sigmoid is live, which
# is not counted: their operation bounds are lower bounds.
OPS_SOFT_TRI = 65
OPS_SOFT_MUL = 2
OPS_SOFT_SPHERE, OPS_SOFT_PLANE = 28, 24


def time_soft(dev, built: dict, name: str, plain: bool):
    """K5's, K6's and K7's times at 640x480 on the differentiable main
    path's soft shadow queries, beside their bounds, counted from the
    queries' worklists (K5's box-culled, with the soft records: every
    sphere and plane, and each triangle of each group whose soft-padded box
    the segment crosses, with the count of every listed triangle beside
    it; K7's likewise with the gradient records, no sphere or plane; K6's
    with the gradient records and every sphere and plane); the plain
    versions' times on the same whole frame when ``plain``."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import packed, soft
    from raytpu_torch.utils.profiling import device_ms

    scene = built[name]
    cfg = RenderConfig(width=W, height=H, soft_shadows=True)
    tmin, beta = cfg.ray_min, cfg.soft_beta
    p, dirs, mags = _soft_queries(scene, cfg)
    blobs = packed.soft_packs(scene)
    S, P, T = (b.shape[0] for b in blobs)
    L, R = mags.shape
    trans, (_, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, tmin, beta)
    boxes = soft.soft_boxes(scene, p, dirs, mags, tmin, beta)[0]
    grad_boxes = soft.grad_boxes(scene, beta)
    g = torch.rand(trans.shape, generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev) * 2.0 - 1.0
    calls = {
        "K5": (lambda: soft.soft_trans_lights_cuda(p, dirs, mags, *blobs, boxes, wl, cnt, tmin,
                                                   beta),
               lambda: soft.soft_trans_plain(p, dirs, mags, *blobs, tmin, beta)),
        "K6": (lambda: soft.soft_dray(p, dirs, mags, g, trans, *blobs, wl, cnt, tmin, beta,
                                      grad_boxes),
               lambda: soft.soft_dray_plain(p, dirs, mags, g, trans, *blobs, tmin, beta)),
        "K7": (lambda: soft.soft_dprim(p, dirs, mags, g, trans, blobs[2], wl, cnt, tmin, beta,
                                       grad_boxes),
               lambda: soft.soft_dprim_plain(p, dirs, mags, g, trans, blobs[2], tmin, beta))}
    nt = cnt.shape[0]
    tile_rays = torch.full((nt,), 1024.0, dtype=torch.float64, device=dev)
    tile_rays[-1] = R - 1024 * (nt - 1)
    tests = float((tile_rays[:, None] * _worklist_tris(wl, cnt, T)).sum())
    sp_ops = L * R * (S * OPS_SOFT_SPHERE + P * OPS_SOFT_PLANE)
    blob_bytes = sum(b.numel() for b in blobs) * 4
    wl_bytes = (int(cnt.sum()) + cnt.numel()) * 4
    rays_in = R * 12 + L * R * 16
    every = torch.ones((R,), dtype=torch.bool, device=dev)
    stats = shadow_box_stats(p, dirs, mags, every, wl, cnt, boxes, T, None, S, P, soft_ops=(
        OPS_SOFT_SPHERE + OPS_SOFT_MUL, OPS_SOFT_PLANE + OPS_SOFT_MUL, OPS_SOFT_TRI + OPS_SOFT_MUL))
    _print_box_stats("K5", name, stats)
    # K7's and K6's box-culled count: the triangles of each group whose
    # gradient record's padded box the segment crosses, tri_soft's
    # operations each (their gradient arithmetic, only where the sigmoid is
    # live, not counted); K6 adds every sphere and plane
    frame7 = {}
    stats7 = shadow_box_stats(p, dirs, mags, every, wl, cnt, grad_boxes, T, None, S, P,
                              soft_ops=(0, 0, OPS_SOFT_TRI), frame=frame7)
    _print_box_stats("K7", name, stats7)
    _print_frame_groups("K6, K7", name, frame7)
    # K6's bytes: rays, g and trans in, the answers out, the spheres and
    # planes, the worklists, the records of the listed groups and the
    # triangle records of the groups some query crosses (every triangle
    # record and no records in brackets)
    k6_io = rays_in + L * R * 8 + (blobs[0].numel() + blobs[1].numel()) * 4 + wl_bytes \
        + R * 12 + L * R * 16
    bounds = {
        "K5": _box_bound(sum(st["ops"] for st in stats),
                         sp_ops + L * R * (S + P) * OPS_SOFT_MUL
                         + tests * (OPS_SOFT_TRI + OPS_SOFT_MUL),
                         rays_in + blob_bytes + boxes.numel() * 4 + wl_bytes + L * R * 4, stats),
        "K6": _box_bound(sp_ops + sum(st["ops"] for st in stats7), sp_ops + tests * OPS_SOFT_TRI,
                         k6_io + frame7["crossed_group_tris"] * blobs[2].shape[1] * 4
                         + frame7["listed_groups"] * grad_boxes.shape[1] * 4, stats7,
                         k6_io + blobs[2].numel() * 4),
        "K7": _box_bound(sum(st["ops"] for st in stats7), tests * OPS_SOFT_TRI,
                         rays_in + L * R * 8 + T * 14 * 4 + grad_boxes.numel() * 4 + wl_bytes
                         + T * 9 * 4, stats7,
                         rays_in + L * R * 8 + T * 14 * 4 + wl_bytes + T * 9 * 4)}
    # K6's time covers its two kernels; its bound counts the function's bytes,
    # not the (L, R, 3) scratch its walk writes and its light sum reads
    bounds["K6"]["scratch_bytes"] = 2 * L * R * 12
    out = {"tests_per_query": tests / (L * R), "queries": L * R}
    for key, (kernel, plain_fn) in calls.items():
        ms = device_ms(kernel, iters=5, warmup=1)
        plain_ms = device_ms(plain_fn, iters=1, warmup=0) if plain else None
        out[key] = {"ms": ms, "plain_ms": plain_ms, "plain_size": f"{W}x{H}" if plain else None,
                    **bounds[key]}
        e = out[key]
        print(f"phase 4: {key} {name}: {ms:.4f} ms, bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']} ({e['ops']:.4e} FP32 ops, {e['bytes']} B)" + _listed_note(e)
              + (f"; scratch not in the bound {e['scratch_bytes']} B" if key == "K6" else "")
              + f", plain {plain_ms if plain_ms is None else round(plain_ms, 2)} ms; "
              f"{out['tests_per_query']:.1f} triangle tests per (shadow ray, light)", flush=True)
    return out


def _tile_rays(R: int, dev):
    """Rays in each 1024-ray tile (the last one may hold fewer)."""
    nt = -(-R // 1024)
    tile_rays = torch.full((nt,), 1024.0, dtype=torch.float64, device=dev)
    tile_rays[-1] = R - 1024 * (nt - 1)
    return tile_rays


OPS_K10_TAIL = 5  # the shadow factor's three multiplies and MaxToOne's two max


def time_chunked(dev, built: dict, name: str):
    """K8's (closest mode), K9's and K10's times at 640x480 on the route's
    camera rays and their shadow queries, beside their bounds, counted from
    this frame's worklists as for K3 and K4 (a shadow query that finds an
    occluder counts one plane test: a lower bound).  K9 is timed on the
    shadow queries of the unfolded, row-major camera rays, the order of its
    callers (``shade_rays``, the stage profiler); its time on the folded
    queries, K10's, stands beside it (``ms_folded``).  K9's and K10's
    bounds are box-culled, as K4's, with the count of every listed triangle
    beside them, and their box statistics are printed; the plain versions'
    times on the whole frame at CHUNKED_PLAIN_SIZE."""
    from raytpu_torch.core.types import LightKind, RenderConfig
    from raytpu_torch.render import chunked, packed, plain, renderer
    from raytpu_torch.utils.profiling import device_ms

    scene = built[name]
    S, P, T, L = (scene.spheres.count, scene.planes.count, scene.triangles.count,
                  scene.lights.count)
    blobs = packed.soft_packs(scene)
    lights, mats = plain.pack_lights(scene.lights), plain.material_table(scene.materials)
    out = {}
    for w, h in ((W, H), CHUNKED_PLAIN_SIZE):
        cfg = RenderConfig(width=w, height=h)
        tmin = cfg.ray_min
        ro, rd = _folded_rays(scene, cfg)
        R = rd.shape[0]
        rec = chunked.closest_hit_chunked(scene, ro, rd, tmin)
        p_off, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
        k10_args = (rec.hit, rec.normal.contiguous(), rec.point.contiguous(), rec.material, rd,
                    p_off, dirs, mags, lights, mats, *blobs)
        ro_r, rd_r = renderer.generate_rays(scene.camera, cfg)  # shade_rays' order
        ro_r = ro_r.expand_as(rd_r).contiguous()
        p_r, dirs_r, mags_r = (x.contiguous() for x in renderer.shadow_query_inputs(
            scene, chunked.closest_hit_chunked(scene, ro_r, rd_r, tmin), cfg))
        if (w, h) == CHUNKED_PLAIN_SIZE:
            out["K8"]["plain_ms"] = device_ms(
                lambda: plain.chunked_min_t_plain(ro, rd, None, *blobs, tmin, False), 1, 0)
            out["K9"]["plain_ms"] = device_ms(
                lambda: packed.any_hit_lights_plain(p_r, dirs_r, mags_r, *blobs, tmin), 1, 0)
            out["K10"]["plain_ms"] = device_ms(
                lambda: plain.shadow_shade_plain(*k10_args, cfg), 1, 0)
            continue
        records = chunked.frame_records(scene)  # as the route builds them
        wl, cnt = packed.closest_worklists(scene, ro, rd, tmin, group=chunked.CHUNK,
                                           group_bounds=None if records is None else records[:2])
        boxes, wl_s, cnt_s = chunked.shadow_inputs(scene, p_off, dirs, mags, tmin, records)
        ms8 = device_ms(lambda: chunked.chunked_min_t(ro, rd, None, *blobs, wl, cnt, tmin, False,
                                                      boxes), iters=20, warmup=2)
        occ = chunked.any_hit_lights(p_off, dirs, mags, *blobs, boxes, wl_s, cnt_s, tmin)
        ms9_folded = device_ms(lambda: chunked.any_hit_lights(p_off, dirs, mags, *blobs, boxes,
                                                              wl_s, cnt_s, tmin),
                               iters=20, warmup=2)
        ms10 = device_ms(lambda: chunked.shadow_shade(*k10_args, boxes, wl_s, cnt_s, cfg),
                         iters=20, warmup=2)
        boxes_r, wl_r, cnt_r = chunked.shadow_inputs(scene, p_r, dirs_r, mags_r, tmin)
        args9 = (p_r, dirs_r, mags_r, *blobs, boxes_r, wl_r, cnt_r, tmin)
        occ_r = chunked.any_hit_lights(*args9)
        ms9 = device_ms(lambda: chunked.any_hit_lights(*args9), iters=20, warmup=2)
        tile_rays = _tile_rays(R, dev)
        tris8 = _worklist_tris(wl, cnt, T, chunked.CHUNK)
        n_hit = float(rec.hit.sum())
        # the tests only: the winner's payload is not counted (a lower bound)
        ops8 = R * (S * OPS_SPHERE + P * OPS_PLANE) + float((tile_rays * tris8).sum()) * OPS_TRI
        blob_bytes = sum(b.numel() for b in blobs) * 4
        bytes8 = R * 24 + blob_bytes + (int(cnt.sum()) + cnt.numel()) * 4 + R * 24
        tris_s = _worklist_tris(wl_s, cnt_s, T, chunked.CHUNK)
        tris_r = _worklist_tris(wl_r, cnt_r, T, chunked.CHUNK)
        every = torch.ones((R,), dtype=torch.bool, device=dev)
        # K9 answers every query, a miss's from the camera too
        ops9 = sum(_shadow_ops(S, P, occ_r[li], every, tris_r[:, li], len(tile_rays))
                   for li in range(L))
        bytes9 = R * 12 + L * R * 16 + blob_bytes + (int(cnt_r.sum()) + cnt_r.numel()) * 4 + L * R
        wl_s_bytes = (int(cnt_s.sum()) + cnt_s.numel()) * 4
        kind = mats[rec.material.long(), 0]
        metal = mats[rec.material.long(), 4] != 0.0
        ops10 = ops_shade = n_hit * OPS_K10_TAIL
        for li in range(L):
            is_point = int(scene.lights.kind[li]) == int(LightKind.POINT)
            ops10 += _shadow_ops(S, P, occ[li], rec.hit, tris_s[:, li], len(tile_rays))
            shade = float(_shade_ops(cfg, is_point, kind, metal)[rec.hit & ~occ[li]].sum())
            ops10 += shade
            ops_shade += shade
        bytes10 = (R * (1 + 12 + 12 + 4 + 12 + 12) + L * R * 16 + lights.numel() * 4
                   + mats.numel() * 4 + blob_bytes + wl_s_bytes + R * 12)
        size = f"{CHUNKED_PLAIN_SIZE[0]}x{CHUNKED_PLAIN_SIZE[1]}"
        if boxes is None:  # a scene of a few groups: K8 tests every listed triangle
            out["K8"] = {"ms": ms8, "plain_size": size, **_bound(ops8, bytes8)}
        else:  # K8's closest walk over the chunks' groups, bounded as K3's
            st8 = closest_box_stats(ro, rd, rec.t, torch.ones((R,), dtype=torch.bool, device=dev),
                                    wl, cnt, boxes, T, chunk=chunked.CHUNK)
            _print_closest_stats("K8", name, st8)
            bytes8_box = (bytes8 - blobs[2].numel() * 4
                          + st8["crossed_group_tris"] * blobs[2].shape[1] * 4
                          + st8["listed_groups"] * boxes.shape[1] * 4)
            out["K8"] = {"ms": ms8, "plain_size": size,
                         **_box_bound(R * (S * OPS_SPHERE + P * OPS_PLANE) + st8["tris"] * OPS_TRI,
                                      ops8, bytes8_box, [st8], bytes8 + boxes.numel() * 4)}
        if boxes is None:  # a scene of a few groups: K9 and K10 test every listed triangle
            out["K9"] = {"ms": ms9, "plain_size": size, **_bound(ops9, bytes9)}
            out["K10"] = {"ms": ms10, "plain_size": size, **_bound(ops10, bytes10)}
        else:  # K9 and K10 walk the chunks' groups with the normal records (chunk -> 16)
            # K9's bytes count the triangle records of the groups some query
            # crosses and the records of the listed groups, besides rays in,
            # answers out, spheres, planes and worklists; every record in
            # brackets.  Its warps take 32 consecutive rays.
            frame9 = {}
            stats9 = shadow_box_stats(p_r, dirs_r, mags_r, every, wl_r, cnt_r, boxes_r, T, occ_r,
                                      S, P, chunk=chunked.CHUNK, frame=frame9,
                                      slots=torch.arange(1024, device=dev).reshape(32, 32))
            _print_box_stats("K9", name, stats9)
            _print_frame_groups("K9", name, frame9)
            bytes9_box = (bytes9 - blobs[2].numel() * 4
                          + frame9["crossed_group_tris"] * blobs[2].shape[1] * 4
                          + frame9["listed_groups"] * boxes_r.shape[1] * 4)
            out["K9"] = {"ms": ms9, "plain_size": size,
                         **_box_bound(sum(st["ops"] for st in stats9), ops9, bytes9_box, stats9,
                                      bytes9 + boxes_r.numel() * 4)}
            stats = shadow_box_stats(p_off, dirs, mags, rec.hit, wl_s, cnt_s, boxes, T, occ, S,
                                     P, chunk=chunked.CHUNK)
            _print_box_stats("K10", name, stats)
            out["K10"] = {"ms": ms10, "plain_size": size,
                          **_box_bound(ops_shade + sum(st["ops"] for st in stats), ops10,
                                       bytes10 + boxes.numel() * 4, stats)}
        out["K9"]["ms_folded"] = ms9_folded
        out["tests_per_ray"] = float((tile_rays * tris8).sum()) / R
        out["shadow_tests_per_query"] = float((tile_rays[:, None] * tris_s).sum()) / (L * R)
        out["occluded_share"] = float((occ & rec.hit[None]).sum()) / max(n_hit * L, 1.0)
    for key in ("K8", "K9", "K10"):
        e = out[key]
        print(f"phase 4: {key} {name}: {e['ms']:.4f} ms"
              + (" on row-major queries" if key == "K9" else "")
              + f", bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']} ({e['ops']:.4e} FP32 ops, {e['bytes']} B)" + _listed_note(e)
              + f", plain {e['plain_ms']:.2f} ms at {e['plain_size']}"
              + (f"; on the folded queries {e['ms_folded']:.4f} ms" if key == "K9" else ""),
              flush=True)
    print(f"phase 4: {name}: {out['tests_per_ray']:.1f} triangle tests per camera ray, "
          f"{out['shadow_tests_per_query']:.1f} per (shadow ray, light) before any stop, "
          f"occluded share {out['occluded_share']:.4f}", flush=True)
    return out


KERNEL_INFO = {
    "K2a": ("mega2_closest", "raytpu_torch/render/csrc/mega2.cu", "raytpu/render/pallas_kernel.py:1192"),
    "K2b": ("mega2_shade", "raytpu_torch/render/csrc/mega2.cu", "raytpu/render/pallas_kernel.py:1300"),
    "K3": ("packed_closest", "raytpu_torch/render/csrc/packed.cu", "raytpu/render/pallas_soft.py:1033"),
    "K4": ("packed_anyhit", "raytpu_torch/render/csrc/packed.cu", "raytpu/render/pallas_soft.py:822"),
    "K5": ("soft_trans", "raytpu_torch/render/csrc/soft.cu", "raytpu/render/pallas_soft.py:598"),
    "K6": ("soft_dray", "raytpu_torch/render/csrc/soft.cu", "raytpu/render/pallas_soft.py:1351"),
    "K7": ("soft_dprim", "raytpu_torch/render/csrc/soft.cu", "raytpu/render/pallas_soft.py:1584"),
    "K8": ("chunked_min_t", "raytpu_torch/render/csrc/chunked.cu",
           "raytpu/render/pallas_kernel.py:230"),
    "K9": ("chunked_anyhit_lights", "raytpu_torch/render/csrc/chunked.cu",
           "raytpu/render/pallas_kernel.py:338"),
    "K10": ("chunked_shadow_shade", "raytpu_torch/render/csrc/chunked.cu",
            "raytpu/render/pallas_kernel.py:476"),
    "K11a": ("mega3_closest", "raytpu_torch/render/csrc/mega3.cu",
             "raytpu/render/pallas_kernel.py:1911"),
    "K11b": ("mega3_shade", "raytpu_torch/render/csrc/mega3.cu",
             "raytpu/render/pallas_kernel.py:1986"),
}
#: the scene whose numbers head each kernel's entry: the largest it serves on
#: the forward routes, the slice's scene for the soft kernels
HEADLINE = {"K2a": "optional", "K2b": "optional", "K3": "bunny300k", "K4": "bunny300k",
            "K5": "optional", "K6": "optional", "K7": "optional", "K8": "bunny18k_l12",
            "K9": "bunny18k_l12", "K10": "bunny18k_l12", "K11a": "bunny300k",
            "K11b": "bunny300k"}
#: the scenes whose soft kernels are timed; the plain versions on the first
SOFT_TIMED = ("optional", "bunny50k", "bunny300k")


def phase_times(dev, env: dict, built: dict, worst: dict, main: dict, big: dict,
                grad: list, chunked_paths: dict, mega3_paths: dict, sharded: dict,
                probes: list) -> None:
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import mega3

    k1, k1_line = time_k1(dev, env, built, worst["K1"], main)
    config = RenderConfig(width=W, height=H)
    per_scene, lines = {}, [k1_line]
    mega3_names = [n for n, _ in MEGA3_PATHS]
    for name, frames, route in BIG_PATHS:
        if route == "mega2":
            timed = time_mega2(dev, built, name, k11=name in mega3_names)
        else:
            timed = time_packed(dev, built, name)
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
    for name, frames in MEGA3_PATHS:
        if "K11a" not in per_scene[name]:  # on the packed route: K2 and K11 timed here
            timed = time_mega2(dev, built, name, k11=True, plain_size=MEGA3_PLAIN_SIZE)
            per_scene[name].update({k: timed[k] for k in ("K2a", "K2b", "K11a", "K11b")})
        frame_ms, rays_per_s, acts, busy_ms, idle = time_frames(
            scenes.get(name), built[name], config, frames, dev,
            render=lambda s, c: math3d.quantize_u8(mega3.render_image_mega3_f32(s, c)))
        kernels = ROUTE_KERNELS["mega3"]
        lines.append({"scene": name, "size": f"{W}x{H}", "frames": frames, "route": "mega3",
                      "launches": {k: mega3_paths[name]["launches"][k] for k in kernels},
                      "kernel_ms": {k: per_scene[name][k]["ms"] for k in kernels},
                      "k2_ms_same_frame": {k: per_scene[name][k]["k2_ms"] for k in kernels},
                      "bound_ms": {k: per_scene[name][k]["bound_ms"] for k in kernels},
                      "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
                      "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
                      "device_idle_share": idle, "card": env["nvidia_smi"]})
        print(f"phase 4: {name} through mega3: frame {frame_ms:.4f} ms ({rays_per_s:.4e} primary "
              f"rays/s); per frame {acts} device activities, busy {busy_ms} ms, idle share "
              f"{idle}", flush=True)
    for name, res in sharded["cases"].items():
        lines.append({"sharded": name, "mesh": res["mesh"], "ranks_on_one_card": 2,
                      "seconds": res["seconds"], "launches_per_rank": res["launches"],
                      "note": "two gloo ranks share one card: function, not scaling",
                      "card": env["nvidia_smi"]})
    for name in SOFT_TIMED:
        timed = time_soft(dev, built, name, plain=name == SOFT_TIMED[0])
        for key in ("K5", "K6", "K7"):
            per_scene.setdefault(name, {})[key] = timed[key]
    for name, frames, _, base in CHUNKED_PATHS:
        timed = time_chunked(dev, built, name)
        per_scene[name] = timed
        frame_ms, rays_per_s, acts, busy_ms, idle = time_frames(scenes.get(base), built[name],
                                                                config, frames, dev)
        launches = chunked_paths[name]["launches"]
        lines.append({"scene": name, "size": f"{W}x{H}", "frames": frames, "route": "chunked",
                      "launches": {k: launches[k] for k in ROUTE_KERNELS["chunked"]},
                      "launches_per_frame": {k: launches[k] / frames
                                             for k in ROUTE_KERNELS["chunked"]},
                      "kernel_ms": {k: timed[k]["ms"] for k in ("K8", "K9", "K10")},
                      "bound_ms": {k: timed[k]["bound_ms"] for k in ("K8", "K9", "K10")},
                      "triangle_tests_per_ray": timed["tests_per_ray"],
                      "shadow_tests_per_query": timed["shadow_tests_per_query"],
                      "occluded_share": timed["occluded_share"],
                      "frame_ms": frame_ms, "primary_rays_per_s": rays_per_s,
                      "frame_device_activities": acts, "frame_device_busy_ms": busy_ms,
                      "device_idle_share": idle, "card": env["nvidia_smi"]})
        print(f"phase 4: {name}: frame {frame_ms:.4f} ms ({rays_per_s:.4e} primary rays/s); per "
              f"frame {acts} device activities, busy {busy_ms} ms, idle share {idle}", flush=True)
    for line in grad:
        lines.append({"grad_path": line, "card": env["nvidia_smi"]})
    main_launches = ([v["launches"] for v in big.values()] + [v["launches"] for v in grad]
                     + [chunked_paths[n]["launches"] for n, _, _, _ in CHUNKED_PATHS]
                     + [chunked_paths["shade_rays"]["launches"]]
                     + [v["launches"] for v in mega3_paths.values()])
    k1["launches"] += sharded["launches"].get("K1", 0)
    entries = [k1]
    for key, (kname, source, replaces) in KERNEL_INFO.items():
        head = per_scene[HEADLINE[key]][key]
        cmp = worst[key]
        entries.append({
            "name": kname, "id": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (sum(c[key] for c in main_launches)
                         + sharded["launches"].get(key, 0)),
            "max_abs_err": cmp["max_abs_diff"], "max_abs_diff": cmp["max_abs_diff"],
            "flip_frac": cmp.get("flip_frac"), "max_rel_err": cmp.get("max_rel_err"),
            "scene": HEADLINE[key], "library_ms": None,
            **({"sum_launches": sum(c["K6sum"] for c in main_launches)} if key == "K6" else {}),
            **head,
            "per_scene": {n: v[key] for n, v in per_scene.items() if key in v}})
    entries += probes
    for line in lines:
        print(json.dumps(line if "grad_path" in line or "sharded" in line
                         else {"main_path": line}))
    print(json.dumps({"kernels": entries}))


def phase_compare_probes(dev) -> dict:
    """P1 and P2 against their plain versions on the card.  P1: all four
    variants at each of P1_TS over P1_TILES tiles, on raytpu's uniform
    triangles (every ray misses) and on triangles placed in front of the
    rays; bit-equal, since both sides round every operation on its own
    (probes.cu -fmad=false, plain: one torch op each) and divide IEEE.  P2 at
    raytpu's shape equal to numpy's float64 sum, at cnt 0 and 3 equal to the
    plain version, and at the timed shape bit-equal to it (same additions in
    the same order)."""
    from raytpu_torch.probes import probe_dma_smem as pd
    from raytpu_torch.probes import probe_smem as ps

    worst = {"P1": {"max_abs_diff": 0.0, "differing": 0},
             "P2": {"max_abs_diff": 0.0, "differing": 0}}
    for T in P1_TS:
        for front in (False, True):
            tri = torch.from_numpy(ps.make_triangles(T, 0, front)).to(dev)
            wl = torch.from_numpy(ps.make_worklist(T, 0)).to(dev)
            for worklist in (False, True):
                ref = ps.smem_fold_plain(tri, wl, P1_TILES, worklist)
                hits = float((ref < 1e30).float().mean())
                line = []
                for staged in (True, False):
                    got = ps.smem_fold(tri, wl, P1_TILES, worklist, staged)
                    differ = int((got != ref).sum())
                    diff = float((got - ref).abs().max())
                    if differ or got.shape != (8 * P1_TILES, 128):
                        raise AssertionError(f"P1 T={T} front={front} worklist={worklist} "
                                             f"staged={staged}: {differ} rays differ, max {diff}")
                    worst["P1"]["max_abs_diff"] = max(worst["P1"]["max_abs_diff"], diff)
                    line.append(f"staged={int(staged)} {differ} differ")
                print(f"phase 2: P1 T={T} {'front' if front else 'uniform'} worklist="
                      f"{int(worklist)}: hit share {hits:.5f}; " + ", ".join(line), flush=True)
    blob, wl, cnt, blocks = pd.raytpu_shape(dev)
    for c in (pd.RAYTPU_CNT, 0, 3):
        cnt_c = torch.full((1,), c, dtype=torch.int32, device=dev)
        got = pd.dma_ring_sum(blob, wl, cnt_c, blocks)
        ref = pd.dma_ring_sum_plain(blob, wl, cnt_c, blocks)
        want = pd.expected(wl.cpu().numpy(), c)
        if not (bool((got == ref).all()) and bool((got == want).all())):
            raise AssertionError(f"P2 at raytpu's shape, cnt {c}: {float(got[0, 0])}, plain "
                                 f"{float(ref[0, 0])}, numpy {want}")
        print(f"phase 2: P2 raytpu's shape cnt={c}: {float(got[0, 0])} == numpy {want} == plain",
              flush=True)
    blob, wl, cnt = pd.timed_shape(dev, P2_BLOCKS, P2_PER_BLOCK)
    got = pd.dma_ring_sum(blob, wl, cnt, P2_BLOCKS)
    ref = pd.dma_ring_sum_plain(blob, wl, cnt, P2_BLOCKS)
    differ = int((got != ref).sum())
    if differ:
        raise AssertionError(f"P2 timed shape: {differ} outputs differ from the plain version")
    worst["P2"]["max_abs_diff"] = float((got - ref).abs().max())
    print(f"phase 2: P2 timed shape {P2_BLOCKS} blocks x {P2_PER_BLOCK} row-blocks "
          f"({blob.numel() * 4 / 1e6:.1f} MB): equal to the plain version", flush=True)
    return worst


def _quiet_main(fn, argv) -> tuple:
    """(return value, standard output) of an entry point's ``main(argv)``
    (or ``run(argv)``) called in this process; its output is printed too."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    return rc, buf.getvalue()


def phase_probe_paths(dev) -> dict:
    """The probes' entry points: ``main()`` of each, in this process, with the
    launch counts set to 0 just before and read just after (P1 12 variants x
    (1 + 3 x 8) launches; P2 raytpu's shape once, the timed shape 1 + 3 x 20);
    then ``python -m`` of each, as a user runs them, both at once."""
    from raytpu_torch.probes import probe_dma_smem as pd
    from raytpu_torch.probes import probe_smem as ps

    out = {}
    for key, mod, want in (("P1", ps, 12 * (1 + 3 * ps.DISPATCHES)), ("P2", pd, 1 + 1 + 3 * 20)):
        reset_launch_counts()
        rc, text = _quiet_main(mod.main, [])
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {k: 0 for k in counts}
        expect[key] = want
        if rc != 0 or counts != expect or (key == "P2" and "match=True" not in text):
            raise AssertionError(f"{key} main returned {rc}, launched {counts}, expected {expect}")
        print(f"phase 3: {mod.__name__}.main(): launches {counts}", flush=True)
        out[key] = {"launches": counts[key]}
    procs = [subprocess.Popen([sys.executable, "-m", mod], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for mod in ("raytpu_torch.probes.probe_smem", "raytpu_torch.probes.probe_dma_smem")]
    for proc in procs:
        text = proc.communicate(timeout=300)[0]
        if proc.returncode != 0 or "match=False" in text:
            raise AssertionError(f"{proc.args}: rc {proc.returncode}\n{text[-2000:]}")
        print(f"phase 3: {' '.join(proc.args[1:])}: rc 0, {len(text.splitlines())} lines, last: "
              f"{text.splitlines()[-1]}", flush=True)
    return out


def _cli_run(argv, profile_copies: bool = False) -> tuple:
    """(launch counts, stdout, device-to-host copies or None) of one CLI run,
    counts set to 0 just before it."""
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.app import cli

    reset_launch_counts()
    if profile_copies:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rc, text = _quiet_main(cli.main, argv)
            torch.cuda.synchronize()
        d2h = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
    else:
        rc, text = _quiet_main(cli.main, argv)
        d2h = None
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"CLI {argv} returned {rc}")
    return launch_counts(), text, d2h


def phase_app_paths(dev, built: dict) -> dict:
    """The app shell on the card: the CLI's --ssaa 2 through K1 on reference
    at 320x240 against the committed golden (its one timed frame at t = 0;
    one K1 a frame, the warm-up's included); --frames 10
    --frames-per-dispatch 4 on reference at 640x480, exactly 10 frames
    counted, 10 K1 launches and 3 device-to-host copies beside the warm-up's
    one each; the viewer's FramePipeline over PIPELINE_FRAMES frames of
    bunny with a moving fly camera, equal frame for frame to the
    synchronous loop, one K2a and one K2b a frame."""
    import re

    from raytpu_torch.app.interactive import FramePipeline
    from raytpu_torch.core import math3d, scenes
    from raytpu_torch.core.camera import CameraInput, FlyCamera
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import render_image
    from raytpu_torch.utils import image as image_io

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        shot = Path(tmp) / "ssaa.png"
        counts, _, _ = _cli_run(["--scene", "reference", "--size", "320x240", "--ssaa", "2",
                                 "--frames", "1", "--screenshot", str(shot)])
        want = {k: 0 for k in counts}
        want["K1"] = 2
        if counts != want:
            raise AssertionError(f"--ssaa 2 launched {counts}, expected {want}")
        g = close_u8(image_io.read_png(str(shot)),
                     image_io.read_png(str(GOLDEN / "reference_ssaa2_320x240.png")), 0.002, 0.1)
        print(f"phase 3: CLI --ssaa 2 reference 320x240 through K1: launches {counts}; golden "
              f"flips {g[0]:.5f} mean {g[1]:.5f}", flush=True)
        out["ssaa"] = {"launches": counts, "golden": g}
    counts, text, d2h = _cli_run(["--scene", "reference", "--size", f"{W}x{H}", "--frames", "10",
                                  "--frames-per-dispatch", "4"], profile_copies=True)
    m = re.search(r"frames=(\d+) dispatches=(\d+) avg_ms=([\d.]+)", text)
    want = {k: 0 for k in counts}
    want["K1"] = 1 + 10
    if not m or (int(m[1]), int(m[2])) != (10, 3) or counts != want or d2h != 1 + 3:
        raise AssertionError(f"--frames 10 --frames-per-dispatch 4: {m and m[0]}, launches "
                             f"{counts} (expected {want}), {d2h} device-to-host copies "
                             "(expected 1 + 3)")
    print(f"phase 3: CLI --frames 10 --frames-per-dispatch 4 reference {W}x{H}: {m[0]}; K1 "
          f"launches 1 + 10, device-to-host copies 1 + 3 (warm-up + dispatches)", flush=True)
    out["frames_per_dispatch"] = {"frames": 10, "dispatches": 3, "avg_ms": float(m[3]),
                                  "launches": counts, "d2h": d2h}

    spec, scene = scenes.get(PIPELINE_SCENE), built[PIPELINE_SCENE]
    config = RenderConfig(width=W, height=H)
    rng = np.random.default_rng(0)
    fly = FlyCamera(origin=tuple(scene.camera.origin.tolist()),
                    fov_degrees=float(np.degrees(2 * np.arctan(float(scene.camera.fov_scale)))))
    scene_seq = []
    for i in range(PIPELINE_FRAMES):
        fly = fly.update(CameraInput(forward=bool(i % 3), right=i % 4 == 1, shift=i % 5 == 0,
                                     mouse_dx=float(rng.normal(0, 3)), mouse_dy=float(rng.normal(0, 2)),
                                     rmb=True), 1 / 60)
        scene_seq.append((i / 60, fly))

    def frame_scene(t, cam):
        return spec.animate(scene, math3d.scalar(t, dev)).with_camera(cam.camera(dev))

    t0 = time.perf_counter()
    sync = [render_image(frame_scene(t, cam), config).cpu().numpy() for t, cam in scene_seq]
    sync_ms = (time.perf_counter() - t0) * 1e3 / PIPELINE_FRAMES
    pipe = FramePipeline(render_image)
    reset_launch_counts()
    t0 = time.perf_counter()
    shown = [pipe.step(frame_scene(t, cam), config) for t, cam in scene_seq]
    pipe_ms = (time.perf_counter() - t0) * 1e3 / PIPELINE_FRAMES
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(K2a=PIPELINE_FRAMES, K2b=PIPELINE_FRAMES)
    if counts != want:
        raise AssertionError(f"FramePipeline launched {counts}, expected {want}")
    # the pipeline shows frame N at step N + 1, and frame 0 at steps 0 and 1
    pairs = [(shown[0], sync[0])] + list(zip(shown[1:], sync[:-1]))
    differ = sum(int((a != b).any(axis=-1).sum()) for a, b in pairs)
    if differ or any(not a.any() for a in shown):
        raise AssertionError(f"FramePipeline: {differ} pixels differ from the synchronous loop")
    print(f"phase 3: FramePipeline {PIPELINE_SCENE} {W}x{H}, {PIPELINE_FRAMES} frames with a "
          f"moving fly camera: launches {counts}; equal to the synchronous loop frame for frame; "
          f"wall {pipe_ms:.2f} ms a frame pipelined, {sync_ms:.2f} synchronous", flush=True)
    out["pipeline"] = {"launches": counts, "pipelined_ms": pipe_ms, "sync_ms": sync_ms}
    return out


def _expect_counts(what: str, counts: dict, **want) -> None:
    """The launch counts are ``want`` and 0 for every other kernel."""
    full = {k: 0 for k in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{what}: launched {counts}, expected {full}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _examples():
    """The port's example modules (examples/torch_*.py)."""
    if str(REPO / "examples") not in sys.path:
        sys.path.insert(0, str(REPO / "examples"))
    import torch_geometry_fit
    import torch_inverse_rendering

    return torch_geometry_fit, torch_inverse_rendering


def tools_geometry_fit(dev, tmp: str, size=(W, H), steps: int = GEOMETRY_FIT_STEPS) -> dict:
    """9a: examples/torch_geometry_fit.py on bunny, ``steps`` steps: K3 and
    K5 once a step and once for each of its three renders (target, start,
    final), K6 (walk and light sum) and K7 once a step; the loss falls."""
    geometry_fit, _ = _examples()
    t0 = time.perf_counter()
    reset_launch_counts()
    res, _ = _quiet_main(geometry_fit.run, [
        "--steps", str(steps), "--size", f"{size[0]}x{size[1]}", "--noise", "0.15",
        "--device", dev.type, "--out", f"{tmp}/geometry_fit.png"])
    _sync(dev)
    counts = launch_counts()
    _expect_counts("torch_geometry_fit", counts, K3=steps + 3, K5=steps + 3, K6=steps,
                   K6sum=steps, K7=steps)
    losses = res["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"torch_geometry_fit: the loss did not fall: {losses}")
    out = {"launches": counts, "losses": losses, "rc": res["rc"],
           "vertex_rmse": res["vertex_rmse"], "seconds": time.perf_counter() - t0}
    print(f"phase 3: 9a torch_geometry_fit bunny {size[0]}x{size[1]}, {steps} steps: launches "
          f"{counts}; loss {losses[0]:.6f} -> {losses[-1]:.6f}; vertex RMSE "
          f"{res['vertex_rmse'][0]:.4f} -> {res['vertex_rmse'][1]:.4f} (rc {res['rc']}: 0 once "
          f"the loss halves); {out['seconds']:.1f}s", flush=True)
    return out


def tools_inverse_rendering(dev, tmp: str, size=(W, H)) -> dict:
    """9b: examples/torch_inverse_rendering.py on w3_test (spheres and
    planes: the eager soft path, no kernel), INVERSE_STEPS steps saving a
    checkpoint every INVERSE_EVERY, resumed to INVERSE_RESUME_TO ("resumed
    from checkpoint step 10"), its final loss within INVERSE_RTOL of an
    uninterrupted run's."""
    _, inverse = _examples()
    t0 = time.perf_counter()
    base = ["--size", f"{size[0]}x{size[1]}", "--device", dev.type, "--out", f"{tmp}/inverse.png"]
    ckpt = ["--checkpoint-dir", f"{tmp}/ckpt", "--checkpoint-every", str(INVERSE_EVERY)]
    reset_launch_counts()
    first, _ = _quiet_main(inverse.run, ["--steps", str(INVERSE_STEPS), *base, *ckpt])
    resumed, text = _quiet_main(inverse.run, ["--steps", str(INVERSE_RESUME_TO), *base, *ckpt])
    whole, _ = _quiet_main(inverse.run, ["--steps", str(INVERSE_RESUME_TO), *base])
    _sync(dev)
    counts = launch_counts()
    _expect_counts("torch_inverse_rendering (eager soft path)", counts)
    if f"resumed from checkpoint step {INVERSE_STEPS}" not in text or not (
            first["rc"] == resumed["rc"] == whole["rc"] == 0):
        raise AssertionError(f"torch_inverse_rendering: rc {first['rc']}, {resumed['rc']}, "
                             f"{whole['rc']}; the second run printed:\n{text}")
    got, want = resumed["losses"][-1], whole["losses"][-1]
    rel = abs(got - want) / abs(want)
    if not (rel <= INVERSE_RTOL and math.isfinite(got)):
        raise AssertionError(f"torch_inverse_rendering: resumed final loss {got!r} against "
                             f"{want!r} uninterrupted ({rel:.3e} relative)")
    out = {"final_loss_resumed": got, "final_loss_uninterrupted": want, "relative": rel,
           "seconds": time.perf_counter() - t0}
    print(f"phase 3: 9b torch_inverse_rendering w3_test {size[0]}x{size[1]}: {INVERSE_STEPS} "
          f"steps, resumed from checkpoint step {resumed['start_step']} to {INVERSE_RESUME_TO}: "
          f"final loss {got!r} against {want!r} uninterrupted ({rel:.3e} relative, limit "
          f"{INVERSE_RTOL}); launches {counts}; {out['seconds']:.1f}s", flush=True)
    return out


def tools_oracle(dev, scene) -> dict:
    """9c: the port's oracle against K1 on reference at ORACLE_SIZE, under
    tests/test_render_vs_oracle.py:_compare's budget (<= 1% of pixels off
    by more than one step, mean <= 0.5)."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.oracle import render_oracle
    from raytpu_torch.render import render_image

    t0 = time.perf_counter()
    cfg = RenderConfig(width=ORACLE_SIZE[0], height=ORACLE_SIZE[1])
    reset_launch_counts()
    img = render_image(scene, cfg).cpu().numpy()
    counts = launch_counts()
    _expect_counts("K1 at 64x48", counts, K1=1)
    flips, mean = close_u8(img, render_oracle(scene, cfg), 0.01, 0.5)
    print(f"phase 3: 9c the port's oracle against K1 on reference {cfg.width}x{cfg.height}: "
          f"flips {flips:.5f} (budget 0.01), mean {mean:.5f} (0.5); launches {counts}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"flips": flips, "mean": mean}


def _native_t(native, tri, o, d, tmin) -> float:
    """t at which the native closest hit's arithmetic meets the one triangle
    ``tri`` (3, 3): its traversal over a one-leaf tree."""
    box = np.concatenate([tri.min(axis=0), tri.max(axis=0)])[None].astype(np.float32)
    return native.bvh_closest_hit(tri[None], box, np.array([[0, 1, -1]], np.int32),
                                  np.zeros(1, np.int32), o, d, tmin)[1]


def tools_bvh_vs_k3(dev, scene, rays: int = BVH_RAYS, size=(W, H)) -> dict:
    """9d: the native BVH closest hit (``native.bvh_closest_hit``, a CPU
    traversal of the SAH tree, no culling) against K3's winner search
    (``packed.scene_min_t_mega2``, one launch over the frame's camera rays)
    on ``rays`` of them, drawn with a seed, half among those whose K3
    winner is a triangle: there the native hit is the same triangle or one
    at the same t (a tie), and t agrees within 1e-5 relative; where K3's
    winner is a plane or a miss, no triangle lies in front of it."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.native import runtime as native
    from raytpu_torch.render import packed, renderer

    t0 = time.perf_counter()
    tris = scene.triangles
    tv = torch.stack([tris.v0, tris.v1, tris.v2], dim=1).cpu().numpy()
    nb, nm, order = native.build_bvh(tv)
    ro, rd = renderer.generate_rays(scene.camera, RenderConfig(width=size[0], height=size[1]))
    tmin = float(RenderConfig().ray_min)
    reset_launch_counts()
    t_all, idx_all, _, _ = packed.scene_min_t_mega2(scene, ro.reshape(1, 3), rd, tmin)
    _sync(dev)
    counts = launch_counts()
    _expect_counts("K3 on the frame's camera rays", counts, K3=1)
    first_tri = scene.spheres.count + scene.planes.count
    t_all, idx_all = t_all.cpu().numpy(), idx_all.cpu().numpy()
    on_tri = (idx_all >= first_tri) & np.isfinite(t_all)
    rng = np.random.default_rng(0)
    pick = np.sort(np.concatenate([
        rng.choice(np.flatnonzero(on_tri), rays // 2, replace=False),
        rng.choice(np.flatnonzero(~on_tri), rays - rays // 2, replace=False)]))
    t_k3, idx_k3 = t_all[pick], idx_all[pick]
    o, dirs = ro.reshape(3).cpu().numpy(), rd.cpu().numpy()[pick]
    tri_hits = ties = other = 0
    for r in range(rays):
        tid, t = native.bvh_closest_hit(tv, nb, nm, order, o, dirs[r], tmin)
        k3_tri = int(idx_k3[r]) - first_tri
        if k3_tri >= 0 and math.isfinite(t_k3[r]):
            tri_hits += 1
            if not abs(t - t_k3[r]) <= 1e-5 * abs(t_k3[r]):
                raise AssertionError(f"ray {pick[r]}: native t {t!r} (triangle {tid}), K3 "
                                     f"{t_k3[r]!r} (triangle {k3_tri})")
            if tid != k3_tri:
                k3_t = _native_t(native, tv[k3_tri], o, dirs[r], tmin)
                if k3_t != t:
                    raise AssertionError(f"ray {pick[r]}: native triangle {tid} at t {t!r}, K3 "
                                         f"triangle {k3_tri} at {k3_t!r}: no tie")
                ties += 1
        elif tid >= 0 and t < t_k3[r] * (1.0 - 1e-5):
            raise AssertionError(f"ray {pick[r]}: native triangle {tid} at t {t!r} in front of "
                                 f"K3's winner {idx_k3[r]} at {t_k3[r]!r}")
        else:
            other += 1
    print(f"phase 3: 9d native.bvh_closest_hit against K3 on {rays} camera rays of bunny50k "
          f"({tris.count} triangles, {nm.shape[0]} BVH nodes): {tri_hits} triangle hits agree "
          f"(t within 1e-5, {ties} ties on another triangle at the same t), {other} plane or "
          f"miss with no triangle in front; launches {counts}; {time.perf_counter() - t0:.1f}s",
          flush=True)
    return {"rays": rays, "triangle_hits": tri_hits, "ties": ties, "plane_or_miss": other}


def tools_trace(dev, scene) -> dict:
    """9e: ``utils.profiling.trace`` around one 640x480 bunny frame: its
    Chrome trace names K2a's and K2b's kernel symbols."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import render_image
    from raytpu_torch.utils import profiling

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        with profiling.trace(tmp) as tr:
            render_image(scene, RenderConfig(width=W, height=H))
        counts = launch_counts()
        with open(tr["path"]) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    named = {sym: [k for k in kernels if sym in k]
             for sym in ("mega2_closest_kernel", "mega2_shade_kernel")}
    _expect_counts("the traced bunny frame", counts, K2a=1, K2b=1)
    if not all(named.values()):
        raise AssertionError(f"the trace names no K2a or K2b symbol: {named}; kernels {kernels}")
    out = {"kernel_names": len(kernels), "K2a": named["mega2_closest_kernel"][0],
           "K2b": named["mega2_shade_kernel"][0]}
    print(f"phase 3: 9e profiling.trace of one bunny {W}x{H} frame: {len(events)} events, "
          f"{len(kernels)} kernel names, K2a as {out['K2a']!r}, K2b as {out['K2b']!r}; "
          f"launches {counts}; {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def tools_nan_check(dev, scene, size=(W, H)) -> dict:
    """9f: ``utils.debug.nan_check`` around one geometry-fit step: nothing
    raised (K3, K5, K6, K7 launched once); with one NaN vertex,
    FloatingPointError."""
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render as dr
    from raytpu_torch.utils import debug

    geometry_fit, _ = _examples()
    t0 = time.perf_counter()
    cfg = RenderConfig(width=size[0], height=size[1], soft_shadows=True, soft_beta=60.0)
    with torch.no_grad():
        target = dr.render_soft(scene, cfg)
    params = dr.trainable({"positions": scene.meshes.positions + 0.01})
    step = dr.make_train_step(cfg, torch.optim.Adam(params.values(), lr=5e-3),
                              geometry_fit.with_positions)
    reset_launch_counts()
    with debug.nan_check():
        loss = float(step(params, scene, target))
    counts = launch_counts()
    _expect_counts("the nan_check step", counts, K3=1, K5=1, K6=1, K6sum=1, K7=1)
    with torch.no_grad():
        params["positions"][0, 0] = float("nan")
    try:
        with debug.nan_check():
            step(params, scene, target)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("nan_check let a step with a NaN vertex through")
    print(f"phase 3: 9f debug.nan_check around a geometry-fit step at {size[0]}x{size[1]}: clean, "
          f"loss {loss:.6f}, launches {counts}; with a NaN vertex: FloatingPointError({raised!r}); "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return {"clean_loss": loss, "raised": raised}


def phase_tools_examples(dev, built: dict) -> dict:
    """Phase 3 (tools and examples): 9a-9f, each with the launch counts set
    to 0 just before it and read just after."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"geometry_fit": tools_geometry_fit(dev, tmp),
               "inverse_rendering": tools_inverse_rendering(dev, tmp)}
    out["oracle_vs_k1"] = tools_oracle(dev, built["reference"])
    out["bvh_vs_k3"] = tools_bvh_vs_k3(dev, built["bunny50k"])
    out["trace"] = tools_trace(dev, built["bunny"])
    out["nan_check"] = tools_nan_check(dev, built["bunny"])
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 3: tools and examples took {out['seconds']:.1f}s", flush=True)
    return out


def _sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def time_probes(dev, env: dict, worst: dict, paths: dict) -> list:
    """P1's and P2's entries of the kernels line, with their times: P1 in each
    variant and T on raytpu's draw (ms per launch, ns per (tile, triangle),
    tests/s), its bound the FP32 operations over 67 TFLOP/s, beside the same
    count over the card's non-FMA issue rate; P2 at the timed shape in bytes/s
    against 3.35 TB/s."""
    from raytpu_torch.probes import probe_dma_smem as pd
    from raytpu_torch.probes import probe_smem as ps
    from raytpu_torch.utils.profiling import device_ms

    issue_rate = FP32_LANES * _sm_clock_hz()
    # the in-order staged instance's fold loop: its instructions a test
    usage = ptxas_usage("smem_fold_kernelILb1ELb0E")
    loops = sass_loops("smem_fold_kernelILb1ELb0E")
    fold = max(loops, key=lambda lp: lp["rcp"])
    per_test = fold["instructions"] / fold["rcp"]
    print(f"phase 4: P1 SASS (staged, in order): {per_test:.2f} instructions a test (loop of "
          f"{fold['instructions']} with {fold['rcp']} tests; loops {json.dumps(loops)}); ptxas "
          f"{json.dumps(usage)}", flush=True)
    variants = {}
    for T in P1_TS:
        tri = torch.from_numpy(ps.make_triangles(T, 0)).to(dev)
        wl = torch.from_numpy(ps.make_worklist(T, 0)).to(dev)
        plain_ms = device_ms(lambda: ps.smem_fold_plain(tri, wl, P1_TILES), iters=1)
        for worklist in (False, True):
            for staged in (True, False):
                r = ps.run(T, P1_TILES, worklist, staged, reps=3, device=dev)
                ops = OPS_P1_TEST * P1_TILES * ps.TILE * T
                bound = _bound(ops, 4 * T * (ps.TRI_COLS + int(worklist)) + 4 * ps.TILE * P1_TILES)
                issue_ms = ops / issue_rate * 1e3
                sass_ms = per_test * P1_TILES * ps.TILE * T / issue_rate * 1e3
                key = f"T={T} worklist={int(worklist)} staged={int(staged)}"
                variants[key] = {"ms": r["ms"], "ns_per_tile_tri": r["ns_per_tile_tri"],
                                 "tests_per_s": r["tests_per_s"], "plain_ms": plain_ms,
                                 "issue_bound_ms": issue_ms, "sass_bound_ms": sass_ms, **bound}
                print(f"phase 4: P1 {key}: {r['ms']:.4f} ms, {r['ns_per_tile_tri']:.3f} ns/(tile,"
                      f"tri), {r['tests_per_s']:.4e} tests/s; bound {bound['bound_ms']:.4f} ms "
                      f"({ops:.4e} FP32 ops at 67 TFLOP/s), {issue_ms:.4f} ms at the non-FMA "
                      f"issue rate ({issue_rate:.4e} op/s), {sass_ms:.4f} ms at {per_test:.2f} "
                      f"SASS instructions a test; plain {plain_ms:.2f} ms; {env['nvidia_smi']}",
                      flush=True)
    head = variants[f"T={P1_TS[-1]} worklist=1 staged=1"]
    p1 = {"name": "probe_smem_fold", "id": "P1", "route": "cuda",
          "source": "raytpu_torch/render/csrc/probes.cu", "replaces": "probes/probe_smem.py:17",
          "launches": paths["P1"]["launches"], "max_abs_err": worst["P1"]["max_abs_diff"],
          "max_abs_diff": worst["P1"]["max_abs_diff"], "library_ms": None,
          "shape": f"T={P1_TS[-1]} worklist=1 staged=1, {P1_TILES} tiles", **head, **usage,
          "sass_instructions_per_test": per_test, "variants": variants}
    blob, wl, cnt = pd.timed_shape(dev, P2_BLOCKS, P2_PER_BLOCK)
    ms = pd.time_ms(blob, wl, cnt, P2_BLOCKS)
    plain_ms = device_ms(lambda: pd.dma_ring_sum_plain(blob, wl, cnt, P2_BLOCKS), iters=3)
    nbytes = blob.numel() * 4 + wl.numel() * 4 + cnt.numel() * 4 + 4 * ps.TILE * P2_BLOCKS
    bound = _bound(2 * wl.numel(), nbytes)
    rate = nbytes / (ms / 1e3)
    print(f"phase 4: P2 timed shape {P2_BLOCKS} blocks x {P2_PER_BLOCK} row-blocks: {ms:.4f} ms, "
          f"{rate / 1e9:.1f} GB/s ({rate / PEAK_BYTES_PER_S:.4f} of 3.35 TB/s); bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}; plain {plain_ms:.3f} ms; "
          f"{env['nvidia_smi']}", flush=True)
    p2 = {"name": "probe_dma_ring", "id": "P2", "route": "cuda",
          "source": "raytpu_torch/render/csrc/probes.cu", "replaces": "probes/probe_dma_smem.py:33",
          "launches": paths["P2"]["launches"], "max_abs_err": worst["P2"]["max_abs_diff"],
          "max_abs_diff": worst["P2"]["max_abs_diff"], "library_ms": None, "ms": ms,
          "plain_ms": plain_ms, "bytes_per_s": rate,
          "shape": f"{P2_BLOCKS} blocks x {P2_PER_BLOCK} row-blocks of 8 KB", **bound}
    return [p1, p2]


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
    soft_cmp = timed("phase 2 (K5, K6, K7)", phase_compare_soft, dev, built)
    chunked_cmp = timed("phase 2 (K8, K9, K10)", phase_compare_chunked, dev, built)
    mega3_cmp = timed("phase 2 (K11a, K11b, tile ranges)", phase_compare_mega3, dev, built)
    probes_cmp = timed("phase 2 (P1, P2)", phase_compare_probes, dev)
    worst.update({"K2a": mega2_worst["K2a"], "K2b": mega2_worst["K2b"], "K3": packed_cmp["K3"],
                  "K4": packed_cmp["K4"], "K5": soft_cmp["K5"], "K6": soft_cmp["K6"],
                  "K7": soft_cmp["K7"], **chunked_cmp, **mega3_cmp})
    main_path = timed("phase 3 (reference)", phase_main_path, dev, built)
    big = timed("phase 3 (big meshes)", phase_big_paths, dev, built)
    grad = timed("phase 3 (grad)", phase_grad_paths, dev, built)
    vs_eager = timed("phase 3 (grad vs eager)", phase_grad_vs_eager, dev, built)
    chunked_paths = timed("phase 3 (chunked)", phase_chunked_paths, dev, built)
    mega3_paths = timed("phase 3 (mega3)", phase_mega3_paths, dev, built)
    sharded = timed("phase 3 (sharded)", phase_sharded, dev, built)
    probe_paths = timed("phase 3 (probes)", phase_probe_paths, dev)
    app = timed("phase 3 (app shell)", phase_app_paths, dev, built)
    tools = timed("phase 3 (tools and examples)", phase_tools_examples, dev, built)
    probes = timed("phase 4 (probes)", time_probes, dev, env, probes_cmp, probe_paths)
    timed("phase 4 (times)", phase_times, dev, env, built, worst, main_path, big, grad,
          chunked_paths, mega3_paths, sharded, probes)
    print(json.dumps({"phase_seconds": seconds,
                      "packed_vs_eager_160x128": packed_cmp["packed_vs_eager"],
                      "mega2_route_vs_plain": mega2_worst["route"],
                      "k7_run_to_run_max_abs": soft_cmp["K7_run_to_run"],
                      "soft_function_vs_autograd": soft_cmp["function_vs_autograd"],
                      "grad_kernel_vs_eager_160x128": vs_eager,
                      "chunked_vs_eager_160x128": {
                          n: chunked_paths[n]["pixels_differing_vs_eager"]
                          for n, _, _, _ in CHUNKED_PATHS},
                      "stage_reports": chunked_paths["stages"],
                      "gloo_on_cuda_tensors": sharded["gloo_cuda"],
                      "app_shell": app, "tools_and_examples": tools,
                      "card": env["nvidia_smi"]}))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s "
          f"on {env['nvidia_smi']}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
