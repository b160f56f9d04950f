"""Frame times of raytpu_torch's routes, with host-to-device copies per frame,
and the shadow-walk kernels' times and answers, for comparing two trees of
the repo on one CUDA card.

    python3 frame_ab.py [--out DIR] [--kernels K6 K2a]  # from the root of a tree; one JSON line
    python3 frame_ab.py --compare DIR [--kernels K6 K2a]  # the trees' answers, kernel by kernel

It times animated 640x480 frames through ``render_image`` with CUDA events,
as ``chip_smoke.py`` phase 4 does: reference (64 frames), bunny and
optional (16), bunny50k (4) and bunny300k (2), and, where the tree's
``chip_smoke.py`` builds them, the chunked route's fixtures optional_l12
(16), bunny18k_l12 (4) and reference_s106 (16); then the mega3 route's
frames (``render_image_mega3_f32``) of optional (16), bunny50k (4) and
bunny300k (2); each REPEATS times, with the median, the least and the
most.  For each route frame it counts, under torch.profiler, the ``Memcpy
HtoD`` activities of one frame: each copies from pageable host memory and
so waits for every kernel queued before it.  Then it times optional's
material train step at 640x480 (chip_smoke.py's first grad path: SGD,
payload_grad True) on the host clock to a synchronize, STEPS steps REPEATS
times, and its light and mesh step (chip_smoke.py's third grad path, the one
that runs K6 and K7) LIGHT_MESH_STEPS steps REPEATS times, with the device's
busy ms of one profiled step, and one warm call of each of chip_smoke.py's sharded cases in
SHARDED_WALL on two ranks sharing the card.  Last, on frame 0 of bunny50k and bunny300k at 640x480, it times K4
(``packed.any_hit_lights``, on the shadow queries of K3's hits) and K11b
(``mega3.mega3_shade``, on K11a's buffer) alone, REPEATS runs of KERNEL_ITERS
launches each; with ``--out DIR`` it saves K4's (L, R) answer there, one
file per tree and scene, with a digest of its inputs.  Likewise K10
(``chunked.shadow_shade``, on the shadow queries of K8's hits) on frame 0
of optional_l12, bunny18k_l12 and reference_s106 (K10_SCENES), saving its
(R, 3) colors,
and K5 (``soft.soft_trans_lights_cuda``, on the soft shadow queries of
K3's hits, as the differentiable path forms them) on optional, bunny50k
and bunny300k (K5_SCENES), saving its (L, R) transmittance; K3
(``packed.winner_search``) on frame 0's folded camera rays of bunny50k and
bunny300k (K3_SCENES), saving its (t, idx, normal, material); and K11a
(``mega3.mega3_closest``) on frame 0 of optional, bunny50k and bunny300k
(K11A_SCENES), saving its buffer and tile boxes; K9
(``chunked.any_hit_lights``) on the shadow queries of K8's hits of
optional_l12, bunny18k_l12 and reference_s106, of the camera rays in 32x32
blocks and, for the first two, row-major (``chunked.shade_rays``' order)
(K9_SCENES), saving its (L, R) answer; K2b (``mega2.mega2_shade``) on
K2a's buffer of bunny and optional (K2B_SCENES), saving its image; K8
(``chunked.scene_min_t``) on the same camera rays as K9's queries (K8_SCENES),
closest mode, and shadow mode on every light's shadow queries of its hits
flattened into one batch, saving its (t, idx, normal, material) and the
shadow mode's t; and K7 (``soft.soft_dprim``) on K5's queries, worklists
and transmittance of optional, bunny50k and bunny300k (K7_SCENES) with a
seeded random cotangent, saving its (T, 9) sums; K6 (``soft.soft_dray``)
on the same inputs (K6_SCENES), saving its g_p, g_dirs and g_mags; and K2a
(``mega2.mega2_closest``) on frame 0 of bunny and optional and on the
second rank's tile range of the pixel-sharded bunny render ("bunny px1",
K2A_SCENES), saving its buffer and tile boxes and recording whether they
equal K11a's on the same worklists bit for bit; K1 (``cuda_kernel.launch_mega``)
on chip_smoke.py phase 2's frames (K1_SCENES: reference in each lighting
mode, without shadows, at t = 1.25 and at 50x37, w2, w3_test, w1, a
directional light, w4_test), saving its image; and P1 (``probe_smem.smem_fold``) in each
of its twelve cases (P1_CASES: T, worklist, staged) over 300 tiles, timed
on raytpu's uniform draw, saving its output on that draw and on the draw
in front of the rays.  Each wrapper is called
with the box records where the tree's takes them, built as the tree's
route builds them.  ``--kernels`` keeps the frames and the steps and
times and saves only the kernels it names (K4 and K11b are timed
together).

An A/B compares two trees in one call on one card, in turns, with the
other tree unpacked under ``_work/`` (``git archive <commit> | tar -x -C
_work/parent``), then counts the (light, ray) pairs of K4, K5 and K9, the
(pixel, channel) entries of K10 and K2b and the words of K3's, K11a's,
K8's, K6's, K2a's, K1's and P1's answers in which the trees' answers differ, and for
K7, whose atomic sums move in their last bits from run to run, and K6's
g_p, which a tree may sum over the lights in another order, the largest
difference over the largest magnitude, which must stay within K7_TOL and
K6_TOL:

    for t in _work/parent . . _work/parent; do (cd $t && python3 $OLDPWD/frame_ab.py \
        --out $OLDPWD/_work/ab); done; python3 frame_ab.py --compare _work/ab
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

sys.path.insert(0, os.getcwd())


REPEATS = 5
STEPS = 8
LIGHT_MESH_STEPS = 4
#: K4's and K11b's launches per timed run
KERNEL_ITERS = 5
#: the scenes on which K4 and K11b are timed and K4's answers saved
KERNEL_SCENES = ("bunny50k", "bunny300k")
#: the chunked fixtures on which K10 is timed and its colors saved
K10_SCENES = ("optional_l12", "bunny18k_l12", "reference_s106")
#: the scenes on which K5 is timed and its transmittance saved
K5_SCENES = ("optional", "bunny50k", "bunny300k")
#: the scenes on which K3 is timed and its answers saved
K3_SCENES = ("bunny50k", "bunny300k")
#: the scenes on which K11a is timed and its buffer and boxes saved
K11A_SCENES = ("optional", "bunny50k", "bunny300k")
#: the chunked fixtures on which K9 is timed and its answers saved: of the
#: camera rays in 32x32 blocks, and (" rows") row-major
K9_SCENES = ("optional_l12", "bunny18k_l12", "reference_s106", "optional_l12 rows",
             "bunny18k_l12 rows")
#: the scenes on which K2b is timed and its image saved
K2B_SCENES = ("bunny", "optional")
#: the chunked fixtures on which K8 is timed and its answers saved, as K9's
K8_SCENES = K9_SCENES
#: the scenes on which K7 is timed and its sums saved
K7_SCENES = ("optional", "bunny50k", "bunny300k")
#: K7's trees agree within this share of the largest magnitude
K7_TOL = 1e-4
#: the scenes on which K6 is timed and its three outputs saved
K6_SCENES = K7_SCENES
#: K6's outputs, each saved and compared on its own: g_p, which a tree may
#: sum over the lights in another order (within K6_TOL of its largest), and
#: g_dirs and g_mags (bit for bit)
K6_PARTS = ("k6_gp", "k6_gdirs", "k6_gmags")
K6_TOL = 1e-4
#: the frames on which K2a is timed and its buffer and boxes saved: bunny's
#: and optional's, and (" px1") the tiles of the second of two px ranks
K2A_SCENES = ("bunny", "optional", "bunny px1")
#: the frames on which K1 is timed and its image saved, chip_smoke.py phase
#: 2's cases: reference (32x32 pixel tiles at 640x480) in each lighting
#: mode, without shadows, at t = 1.25 and at 50x37 (row-major rays); w2,
#: w3_test, w1 (no lights), a directional light (chip_smoke.py's scene) and
#: w4_test (OBJ)
K1_SCENES = ("reference", "reference observed_area", "reference radiance", "reference brdf",
             "reference no-shadows", "reference t=1.25", "reference 50x37", "w2", "w3_test", "w1",
             "directional", "w4_test")
#: K1's launches per timed run: a launch takes tens of microseconds
K1_ITERS = 200
#: P1's cases, each timed on raytpu's uniform draw and saved on both draws:
#: triangles, worklist, staged
P1_CASES = tuple(f"T{T}-wl{wl}-st{st}" for T in (64, 384, 1024) for wl in (0, 1) for st in (1, 0))
#: every kernel this script times, in its order; K4 and K11b together
KERNELS = ("K4", "K11b", "K10", "K5", "K3", "K11a", "K9", "K2b", "K8", "K7", "K6", "K2a", "K1",
           "P1")
#: the mega3 route's frames: scene and frame count, chip_smoke.py's MEGA3_PATHS
MEGA3_FRAMES = (("optional", 16), ("bunny50k", 4), ("bunny300k", 2))
#: chip_smoke.py's sharded cases whose wall time is taken: K4 on each
#: triangle shard, and K11 on each rank's tile range
SHARDED_WALL = ("bunny50k_prim", "bunny50k_mega3_px")


def _spread(xs: list) -> dict:
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1], "all": xs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the kernels' answers, one file per tree, "
                    "kernel and scene")
    ap.add_argument("--compare", metavar="DIR", help="compare the trees' answers in DIR")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS),
                    help="the kernels to time and save or compare (default: all)")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare, args.kernels)
    want = set(args.kernels)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import mega3, render_image
    from raytpu_torch.utils.profiling import device_ms

    if not torch.cuda.is_available():
        print("frame_ab: this needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = RenderConfig()
    built = {n: scenes.get(n).build(dev)
             for n in ("reference", "bunny", "optional", "bunny50k", "bunny300k")}
    cases = [("reference", "reference", 64), ("bunny", "bunny", 16), ("optional", "optional", 16),
             ("bunny50k", "bunny50k", 4), ("bunny300k", "bunny300k", 2)]
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
    tree = os.path.basename(os.getcwd())
    out = {"tree": tree, "card": smi}
    mega3_cases = [(name + "_mega3", name, frames, mega3.render_image_mega3_f32)
                   for name, frames in MEGA3_FRAMES]
    for name, base, frames, render in [c + (render_image,) for c in cases] + mega3_cases:
        spec, scene = scenes.get(base), built[base if name.endswith("_mega3") else name]
        ts = torch.linspace(0.0, 2.0 * np.pi, frames, device=dev)
        i = [0]

        def frame():
            render(spec.animate(scene, ts[i[0] % frames]), cfg)
            i[0] += 1

        ms = [device_ms(frame, iters=frames, warmup=2) for _ in range(REPEATS)]
        out[name] = {"frame_ms": _spread(ms)}
        if render is render_image:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                frame()
                torch.cuda.synchronize()
            out[name]["h2d_per_frame"] = sum(e.count for e in prof.key_averages()
                                             if e.key.startswith("Memcpy HtoD"))
    out["optional_material_step_ms"] = _spread(_material_steps(built["optional"], dev))
    if hasattr(cs, "_fit"):  # the light and mesh fit, the one step that runs K6 and K7
        ms, busy = _light_mesh_steps(built["optional"], dev, cs)
        out["optional_light_mesh_step_ms"] = _spread(ms)
        out["optional_light_mesh_step_device_busy_ms"] = busy
    if hasattr(cs, "SHARDED_CASES"):
        out["sharded_wall_ms"] = _sharded(cs.SHARDED_CASES)
    for name in KERNEL_SCENES if want & {"K4", "K11b"} else ():
        out[name + "_kernels"] = _shadow_kernels(built[name], cfg, tree, name, args.out)
    for name in K10_SCENES if "K10" in want else ():
        if name in built:
            out[name + "_K10"] = _k10(built[name], cfg, tree, name, args.out)
    for name in K5_SCENES if "K5" in want else ():
        out[name + "_K5"] = _k5(built[name], cfg, tree, name, args.out)
    for name in K3_SCENES if "K3" in want else ():
        out[name + "_K3"] = _k3(built[name], cfg, tree, name, args.out)
    for name in K11A_SCENES if "K11a" in want else ():
        out[name + "_K11a"] = _k11a(built[name], cfg, tree, name, args.out)
    for key in K9_SCENES if "K9" in want else ():
        name, *order = key.split()
        if name in built:
            out["-".join(key.split()) + "_K9"] = _k9(built[name], cfg, tree, key, args.out,
                                                     rows=bool(order))
    for name in K2B_SCENES if "K2b" in want else ():
        out[name + "_K2b"] = _k2b(built[name], cfg, tree, name, args.out)
    for key in K8_SCENES if "K8" in want else ():
        name, *order = key.split()
        if name in built:
            out["-".join(key.split()) + "_K8"] = _k8(built[name], cfg, tree, key, args.out,
                                                     rows=bool(order))
    for name in K7_SCENES if "K7" in want else ():
        out[name + "_K7"] = _k7(built[name], cfg, tree, name, args.out)
    for name in K6_SCENES if "K6" in want else ():
        out[name + "_K6"] = _k6(built[name], cfg, tree, name, args.out)
    for key in K2A_SCENES if "K2a" in want else ():
        out["-".join(key.split()) + "_K2a"] = _k2a(built[key.split()[0]], cfg, tree, key,
                                                   args.out)
    for key in K1_SCENES if "K1" in want else ():
        name = key.split()[0]
        if name not in built:
            built[name] = (cs._directional_scene(dev) if name == "directional"
                           else scenes.get(name).build(dev))
        out["-".join(key.split()) + "_K1"] = _k1(built[name], cfg, tree, key, args.out)
    for key in P1_CASES if "P1" in want else ():
        out[key + "_P1"] = _p1(dev, tree, key, args.out)
    print(json.dumps(out), flush=True)
    return 0


def _save(outdir, kernel: str, name: str, tree: str, x, inputs) -> dict:
    """Times aside, what a kernel's run leaves: the digest of its inputs, and
    with ``outdir`` its answer ``x`` saved as ``{kernel}_{name}_{tree}.npz``
    (compared with this tree's earlier run when there is one)."""
    import numpy as np

    digest = hashlib.sha256()
    for t in inputs:
        digest.update(t.cpu().numpy().tobytes())
    res = {"inputs_sha256": digest.hexdigest()}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{kernel}_{'-'.join(name.split())}_{tree}.npz")
        a = x.cpu().numpy()
        if os.path.exists(path):  # this tree's earlier run: the kernel answers the same each run
            res["entries_differ_from_earlier_run"] = int((np.load(path)["x"] != a).sum())
        np.savez(path, x=a, sha=res["inputs_sha256"])
    return res


def _k10(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K10's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's
    unanimated frame through the chunked route's glue, its colors saved."""
    import torch

    from raytpu_torch.render import chunked, packed, plain, renderer
    from raytpu_torch.utils.profiling import device_ms

    W, H, tmin = cfg.width, cfg.height, cfg.ray_min
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    rec = chunked.closest_hit_chunked(scene, ro, rd, tmin)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    args = [rec.hit, rec.normal.contiguous(), rec.point.contiguous(), rec.material, rd, p, dirs,
            mags, plain.pack_lights(scene.lights), plain.material_table(scene.materials),
            *packed.soft_packs(scene)]
    if hasattr(chunked, "shadow_inputs"):  # the tree's K10 takes its box records
        args += chunked.shadow_inputs(scene, p, dirs, mags, tmin)
    else:
        args += packed.shadow_worklists(scene, p, dirs, mags, tmin, group=chunked.CHUNK)
    args.append(cfg)
    colors = chunked.shadow_shade(*args)
    res = {"K10_ms": _spread([device_ms(lambda: chunked.shadow_shade(*args), iters=KERNEL_ITERS,
                                        warmup=1) for _ in range(REPEATS)])}
    torch.cuda.synchronize()
    return {**res, **_save(outdir, "k10", name, tree, colors, (rec.hit, rec.normal, p, dirs, mags))}


def _k9(scene, cfg, tree: str, name: str, outdir, rows: bool = False) -> dict:
    """K9's ms (REPEATS runs of KERNEL_ITERS launches) on the shadow queries
    of K8's hits of the scene's unanimated frame, its camera rays in 32x32
    blocks or with ``rows`` row-major, through the chunked route's glue;
    its (L, R) answer saved as bytes."""
    import torch

    from raytpu_torch.render import chunked, packed, renderer
    from raytpu_torch.utils.profiling import device_ms

    W, H, tmin = cfg.width, cfg.height, cfg.ray_min
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if not rows:
        rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    rec = chunked.closest_hit_chunked(scene, ro, rd, tmin)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    args = [p, dirs, mags, *packed.soft_packs(scene)]
    if "boxes" in inspect.signature(chunked.any_hit_lights).parameters:  # K9 walks the records
        args += chunked.shadow_inputs(scene, p, dirs, mags, tmin)
    else:
        args += packed.shadow_worklists(scene, p, dirs, mags, tmin, group=chunked.CHUNK)
    args.append(tmin)
    occ = chunked.any_hit_lights(*args)
    res = {"K9_ms": _spread([device_ms(lambda: chunked.any_hit_lights(*args),
                                       iters=KERNEL_ITERS, warmup=1) for _ in range(REPEATS)])}
    torch.cuda.synchronize()
    return {**res, **_save(outdir, "k9", name, tree, occ.to(torch.uint8), (p, dirs, mags))}


def _k8(scene, cfg, tree: str, name: str, outdir, rows: bool = False) -> dict:
    """K8's ms (REPEATS runs of KERNEL_ITERS launches) in both modes: the
    closest mode on the scene's unanimated camera rays, in 32x32 blocks or
    with ``rows`` row-major, and the shadow mode on every light's shadow
    queries of its hits flattened into one batch, each with the worklists
    (and the records, where the tree's K8 takes them) the tree's route
    builds; its closest-mode words and shadow-mode t saved as one row."""
    import torch

    from raytpu_torch.render import chunked, packed, renderer
    from raytpu_torch.utils.profiling import device_ms

    W, H, tmin = cfg.width, cfg.height, cfg.ray_min
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if not rows:
        rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    rec = chunked.closest_hit_chunked(scene, ro, rd, tmin)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    L = dirs.shape[0]
    ps, ds, ms = p.repeat(L, 1), dirs.reshape(-1, 3), mags.reshape(-1).contiguous()
    blobs = packed.soft_packs(scene)
    walks = "boxes" in inspect.signature(chunked.chunked_min_t).parameters
    records = chunked.frame_records(scene) if walks else None
    bounds = None if records is None else records[:2]
    extra = [None if records is None else records[2]] if walks else []
    calls = []
    for o, d, tmax, shadow in ((ro, rd, None, False), (ps, ds, ms, True)):
        wl, cnt = packed.closest_worklists(scene, o, d, tmin,
                                           float("inf") if tmax is None else tmax,
                                           group=chunked.CHUNK, group_bounds=bounds)
        calls.append([o, d, tmax, *blobs, wl, cnt, tmin, shadow, *extra])
    t, idx, normal, mat = chunked.chunked_min_t(*calls[0])
    t_s = chunked.chunked_min_t(*calls[1])[0]
    res = {f"K8_{mode}_ms": _spread([device_ms(lambda: chunked.chunked_min_t(*a),
                                               iters=KERNEL_ITERS, warmup=1)
                                     for _ in range(REPEATS)])
           for mode, a in (("closest", calls[0]), ("shadow", calls[1]))}
    torch.cuda.synchronize()
    words = torch.cat([t, idx.view(torch.float32), normal.flatten(), mat.view(torch.float32),
                       t_s])
    return {**res, **_save(outdir, "k8", name, tree, words, (ro, rd, ps, ds, ms))}


def _k7(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K7's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's soft
    shadow queries at 640x480 as the differentiable path forms them, K5's
    worklists and transmittance and a cotangent drawn from a seeded
    generator (``_soft_inputs``), with the gradient records where the
    tree's K7 takes them; its (T, 9) sums saved."""
    import dataclasses

    from raytpu_torch.render import soft
    from raytpu_torch.utils.profiling import device_ms

    cfg = dataclasses.replace(cfg, soft_shadows=True)
    p, dirs, mags, g, trans, blobs, wl, cnt = _soft_inputs(scene, cfg)
    args = [p, dirs, mags, g, trans, blobs[2], wl, cnt, cfg.ray_min, cfg.soft_beta]
    if "boxes" in inspect.signature(soft.soft_dprim).parameters:
        args.append(soft.grad_boxes(scene, cfg.soft_beta))
    out = soft.soft_dprim(*args)
    res = {"K7_ms": _spread([device_ms(lambda: soft.soft_dprim(*args), iters=KERNEL_ITERS,
                                       warmup=1) for _ in range(REPEATS)])}
    return {**res, **_save(outdir, "k7", name, tree, out, (p, dirs, mags, g, trans))}


def _soft_inputs(scene, cfg):
    """The soft shadow queries of the scene's unanimated frame at 640x480 as
    the differentiable path forms them, K5's worklists and transmittance
    and a cotangent drawn from a seeded generator: ``(p, dirs, mags, g,
    trans, blobs, wl, cnt)``."""
    import torch

    from raytpu_torch.render import packed, renderer, soft

    W, H, tmin, beta = cfg.width, cfg.height, cfg.ray_min, cfg.soft_beta
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    trans, (blobs, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, tmin, beta)
    g = torch.rand(trans.shape, generator=torch.Generator(device=trans.device).manual_seed(2),
                   device=trans.device) * 2.0 - 1.0
    return p, dirs, mags, g, trans, blobs, wl, cnt


def _k6(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K6's ms (REPEATS runs of KERNEL_ITERS launches) on K7's inputs
    (``_soft_inputs``), with the gradient records where the tree's K6
    takes them; its g_p, g_dirs and g_mags saved, one file each
    (K6_PARTS)."""
    import dataclasses

    import torch

    from raytpu_torch.render import soft
    from raytpu_torch.utils.profiling import device_ms

    cfg = dataclasses.replace(cfg, soft_shadows=True)
    p, dirs, mags, g, trans, blobs, wl, cnt = _soft_inputs(scene, cfg)
    args = [p, dirs, mags, g, trans, *blobs, wl, cnt, cfg.ray_min, cfg.soft_beta]
    if "boxes" in inspect.signature(soft.soft_dray).parameters:
        args.append(soft.grad_boxes(scene, cfg.soft_beta))
    outs = soft.soft_dray(*args)
    res = {"K6_ms": _spread([device_ms(lambda: soft.soft_dray(*args), iters=KERNEL_ITERS,
                                       warmup=1) for _ in range(REPEATS)])}
    for part, x in zip(K6_PARTS, outs):
        res[part] = _save(outdir, part, name, tree, x, (p, dirs, mags, g, trans))
    return res


def _k2a(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K2a's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's
    unanimated frame, or with ``name`` "... px1" on the tiles of the second
    of two px ranks, its inputs built as the tree's mega2 route builds
    them; its buffer and tile boxes saved as one row, and whether they
    equal K11a's on the same worklists and records bit for bit."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, plain
    from raytpu_torch.utils.profiling import device_ms

    buf, counts = plain.mega_pack(scene, cfg)
    tile0, tiles = 0, None
    if name.endswith("px1"):
        tiles = -(-mega2.num_tiles(cfg) // 2)
        tile0 = tiles
    glo, ghi, records = accel.normal_boxes(scene.triangles)
    wl, cnt = mega2.primary_worklists(scene, cfg, tile0, tiles, (glo, ghi))
    walks = "boxes" in inspect.signature(mega2.mega2_closest).parameters
    args = [buf, counts, *([records] if walks else []), wl, cnt, cfg, tile0, tiles]
    acc, bounds = mega2.mega2_closest(*args)
    res = {"K2a_ms": _spread([device_ms(lambda: mega2.mega2_closest(*args), iters=KERNEL_ITERS,
                                        warmup=1) for _ in range(REPEATS)])}
    if "boxes" in inspect.signature(mega3.mega3_closest).parameters:
        acc11, bounds11 = mega3.mega3_closest(buf, counts, mega3.pack_groups(buf, counts),
                                              records, wl, cnt, cfg, tile0, tiles)
        res["equal_to_k11a"] = bool(torch.equal(acc.view(torch.int32), acc11.view(torch.int32))
                                    and torch.equal(bounds.view(torch.int32),
                                                    bounds11.view(torch.int32)))
    return {**res, **_save(outdir, "k2a", name, tree,
                           torch.cat([acc.flatten(), bounds.flatten()]), (buf, wl, cnt))}


def _k1(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K1's ms (REPEATS runs of K1_ITERS launches) on the scene's frame
    that ``name`` (K1_SCENES) names: unanimated at 640x480 unless it names
    a lighting mode, no shadows, t = 1.25 or a size; through ``launch_mega``
    on ``mega_pack``'s buffer; the median, least and most of K1_ITERS more
    launches' device times under torch.profiler; its image saved."""
    import dataclasses

    import torch

    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import LightingMode
    from raytpu_torch.render import cuda_kernel as ck
    from raytpu_torch.utils.profiling import device_ms

    for mod in name.split()[1:]:
        if mod.upper() in LightingMode.__members__:
            cfg = dataclasses.replace(cfg, lighting_mode=LightingMode[mod.upper()])
        elif mod == "no-shadows":
            cfg = dataclasses.replace(cfg, shadows=False)
        elif mod.startswith("t="):
            scene = scenes.get(name.split()[0]).animate(scene, float(mod[2:]))
        else:
            w, h = (int(v) for v in mod.split("x"))
            cfg = dataclasses.replace(cfg, width=w, height=h)
    buf, counts = ck.mega_pack(scene, cfg)
    out = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32, device=buf.device)
    ck.launch_mega(buf, counts, cfg, out)
    img = out.clone()
    res = {"K1_ms": _spread([device_ms(lambda: ck.launch_mega(buf, counts, cfg, out),
                                       iters=K1_ITERS, warmup=10) for _ in range(REPEATS)])}
    # a launch can be shorter than the host's call: the kernels' own device
    # time, from the profiler, is the comparison that does not wait on the host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(K1_ITERS):
            ck.launch_mega(buf, counts, cfg, out)
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and "mega_kernel" in e.name)
    if us:
        res["K1_device_ms"] = {"median": us[len(us) // 2] / 1e3, "min": us[0] / 1e3,
                               "max": us[-1] / 1e3, "launches": len(us)}
    return {**res, **_save(outdir, "k1", name, tree, img, (buf,))}


def _p1(dev, tree: str, key: str, outdir) -> dict:
    """P1's ms (REPEATS runs of the probe's DISPATCHES launches) in case
    ``key`` (``P1_CASES``) over 300 tiles of raytpu's uniform draw, as its
    ``main`` times it; its output on that draw and on the draw in front of
    the rays saved as one row."""
    import torch

    from raytpu_torch.probes import probe_smem as ps
    from raytpu_torch.utils.profiling import device_ms

    T, worklist, staged = (int(part.lstrip("Twlst")) for part in key.split("-"))
    wl = torch.from_numpy(ps.make_worklist(T, 0)).to(dev)
    tris = [torch.from_numpy(ps.make_triangles(T, 0, front)).to(dev) for front in (False, True)]
    outs = [ps.smem_fold(tri, wl, 300, bool(worklist), bool(staged)).flatten() for tri in tris]
    res = {"P1_ms": _spread([device_ms(lambda: ps.smem_fold(tris[0], wl, 300, bool(worklist),
                                                            bool(staged)),
                                       iters=ps.DISPATCHES, warmup=1) for _ in range(REPEATS)])}
    return {**res, **_save(outdir, "p1", key, tree, torch.cat(outs), (*tris, wl))}


def _k2b(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K2b's ms (REPEATS runs of KERNEL_ITERS launches) on K2a's buffer of
    the scene's unanimated frame, its inputs built as the tree's mega2
    route builds them; its image saved."""
    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, plain
    from raytpu_torch.utils.profiling import device_ms

    buf, counts = plain.mega_pack(scene, cfg)
    if "boxes" in inspect.signature(mega2.mega2_shade).parameters:  # K2b walks the records
        glo, ghi, boxes = accel.normal_boxes(scene.triangles)
        wl, cnt = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
        k2a_boxes = [boxes] if "boxes" in inspect.signature(mega2.mega2_closest).parameters else []
        acc, bounds = mega2.mega2_closest(buf, counts, *k2a_boxes, wl, cnt, cfg)
        args = [buf, counts, boxes, *mega2.shadow_worklists(scene, cfg, bounds, (glo, ghi)), acc,
                cfg]
    else:
        wl, cnt = mega2.primary_worklists(scene, cfg)
        acc, bounds = mega2.mega2_closest(buf, counts, wl, cnt, cfg)
        args = [buf, counts, *mega2.shadow_worklists(scene, cfg, bounds), acc, cfg]
    img = mega2.mega2_shade(*args)
    res = {"K2b_ms": _spread([device_ms(lambda: mega2.mega2_shade(*args), iters=KERNEL_ITERS,
                                        warmup=1) for _ in range(REPEATS)])}
    return {**res, **_save(outdir, "k2b", name, tree, img, (buf, acc))}


def _k5(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K5's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's soft
    shadow queries at 640x480 as the differentiable path forms them, its
    transmittance saved."""
    import dataclasses

    from raytpu_torch.render import packed, renderer, soft
    from raytpu_torch.utils.profiling import device_ms

    cfg = dataclasses.replace(cfg, soft_shadows=True)
    W, H, tmin, beta = cfg.width, cfg.height, cfg.ray_min, cfg.soft_beta
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    args = [p, dirs, mags, *packed.soft_packs(scene)]
    if "boxes" in inspect.signature(soft.soft_trans_lights_cuda).parameters:
        args += soft.soft_boxes(scene, p, dirs, mags, tmin, beta)
    else:
        args += soft.soft_worklists(scene, p, dirs, mags, tmin, beta)
    args += [tmin, beta]
    trans = soft.soft_trans_lights_cuda(*args)
    res = {"K5_ms": _spread([device_ms(lambda: soft.soft_trans_lights_cuda(*args),
                                       iters=KERNEL_ITERS, warmup=1) for _ in range(REPEATS)])}
    return {**res, **_save(outdir, "k5", name, tree, trans, (p, dirs, mags))}


def _k3(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K3's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's
    folded camera rays of frame 0, its (t, idx, normal, material) saved as
    one row of words."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, renderer
    from raytpu_torch.utils.profiling import device_ms

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    blobs = packed.soft_packs(scene)
    if "boxes" in inspect.signature(packed.winner_search).parameters:  # K3 walks the records
        glo, ghi, boxes = accel.normal_boxes(scene.triangles)
        wl, cnt = packed.closest_worklists(scene, ro, rd, cfg.ray_min, group_bounds=(glo, ghi))
        args = [ro, rd, *blobs, boxes, wl, cnt, cfg.ray_min]
    else:
        args = [ro, rd, *blobs, *packed.closest_worklists(scene, ro, rd, cfg.ray_min),
                cfg.ray_min]
    t, idx, normal, mat = packed.winner_search(*args)
    res = {"K3_ms": _spread([device_ms(lambda: packed.winner_search(*args), iters=KERNEL_ITERS,
                                       warmup=1) for _ in range(REPEATS)])}
    words = torch.cat([t, idx.view(torch.float32), normal.flatten(), mat.view(torch.float32)])
    return {**res, **_save(outdir, "k3", name, tree, words, (ro, rd))}


def _k11a(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K11a's ms (REPEATS runs of KERNEL_ITERS launches) on the scene's
    unanimated frame, its buffer and tile boxes saved as one row."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, plain
    from raytpu_torch.utils.profiling import device_ms

    buf, counts = plain.mega_pack(scene, cfg)
    blob = mega3.pack_groups(buf, counts)
    wl, cnt = mega2.primary_worklists(scene, cfg)
    args = [buf, counts, blob, wl, cnt, cfg]
    if "boxes" in inspect.signature(mega3.mega3_closest).parameters:
        args.insert(3, accel.normal_boxes(scene.triangles)[2])
    acc, bounds = mega3.mega3_closest(*args)
    res = {"K11a_ms": _spread([device_ms(lambda: mega3.mega3_closest(*args),
                                         iters=KERNEL_ITERS, warmup=1) for _ in range(REPEATS)])}
    return {**res, **_save(outdir, "k11a", name, tree,
                           torch.cat([acc.flatten(), bounds.flatten()]), (buf, wl, cnt))}


def _sharded(cases) -> dict:
    """Wall ms of one warm sharded call (two gloo ranks sharing the card,
    the slower rank's) of each of chip_smoke.py's SHARDED_WALL cases."""
    import tempfile

    from raytpu_torch.parallel import launch

    cases = [c for c in cases if c["name"] in SHARDED_WALL]
    with tempfile.TemporaryDirectory() as outdir:
        results = launch.spawn(2, outdir, "cuda", cases, timeout=600.0)
    return {c["name"]: max(r["cases"][c["name"]]["seconds"] for r in results) * 1e3
            for c in cases}


def _shadow_kernels(scene, cfg, tree: str, name: str, outdir) -> dict:
    """K4's and K11b's ms (REPEATS runs of KERNEL_ITERS launches, CUDA
    events) on the scene's unanimated frame; K4's answer saved in
    ``outdir`` with the digest of its inputs.  Each kernel is called with
    the boxes where the tree's wrapper takes them."""
    import numpy as np
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, packed, plain, renderer
    from raytpu_torch.utils.profiling import device_ms

    W, H, tmin = cfg.width, cfg.height, cfg.ray_min
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, H, W)
    ro = ro.expand_as(rd).contiguous()
    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
    blobs = packed.soft_packs(scene)
    wl, cnt = packed.shadow_worklists(scene, p, dirs, mags, tmin)
    k4_args = [p, dirs, mags, *blobs, wl, cnt, tmin]
    buf, counts = plain.mega_pack(scene, cfg)
    blob = mega3.pack_groups(buf, counts)
    k11a_args = [buf, counts, blob, *mega2.primary_worklists(scene, cfg), cfg]
    if "boxes" in inspect.signature(mega3.mega3_closest).parameters:
        k11a_args.insert(3, accel.normal_boxes(scene.triangles)[2])
    acc, bounds = mega3.mega3_closest(*k11a_args)
    k11b_args = [buf, counts, blob, *mega2.shadow_worklists(scene, cfg, bounds), acc, cfg]
    if "boxes" in inspect.signature(packed.any_hit_lights).parameters:
        if hasattr(packed, "shadow_records"):  # the route's: the normal records' first 8 columns
            boxes = packed.shadow_records(accel.normal_boxes(scene.triangles)[2])
        else:  # a tree before shadow_records
            boxes = accel.group_boxes(scene.triangles)[2]
        k4_args.insert(6, boxes)
        k11b_args.insert(3, boxes)
    occ = packed.any_hit_lights(*k4_args)
    res = {}
    for key, fn, a in (("K4", packed.any_hit_lights, k4_args),
                       ("K11b", mega3.mega3_shade, k11b_args)):
        res[key + "_ms"] = _spread([device_ms(lambda: fn(*a), iters=KERNEL_ITERS, warmup=1)
                                    for _ in range(REPEATS)])
    digest = hashlib.sha256()
    for x in (p, dirs, mags):
        digest.update(x.cpu().numpy().tobytes())
    res["k4_inputs_sha256"] = digest.hexdigest()
    res["k4_occluded"] = int(occ.sum())
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"k4_{name}_{tree}.npz")
        bits = np.packbits(occ.cpu().numpy())
        if os.path.exists(path):  # this tree's earlier run: K4 answers the same each run
            before = np.load(path)["bits"]
            res["k4_pairs_differ_from_earlier_run"] = int(
                np.unpackbits(before ^ bits).sum())
        np.savez(path, bits=bits, shape=np.asarray(occ.shape), sha=res["k4_inputs_sha256"])
    return res


def compare(outdir: str, kernels=KERNELS) -> int:
    """Count the entries in which two trees' answers differ, kernel by
    kernel and scene by scene, from the files ``--out`` wrote, for the
    ``kernels`` named: K4's, K5's and K9's (light, ray) pairs, K10's and
    K2b's (pixel, channel) entries, K3's, K11a's, K8's, K6's, K2a's, K1's
    and P1's words; for K7 and K6's g_p also the largest difference over the
    largest magnitude.  Non-zero unless every kernel and scene has both
    trees' answers, on the same inputs, and none differ (K7: none beyond
    K7_TOL of the largest; K6's g_p: K6_TOL)."""
    import glob

    import numpy as np

    ok, out = True, {}
    for kernel, names in (("k4", KERNEL_SCENES), ("k10", K10_SCENES), ("k5", K5_SCENES),
                          ("k3", K3_SCENES), ("k11a", K11A_SCENES), ("k9", K9_SCENES),
                          ("k2b", K2B_SCENES), ("k8", K8_SCENES), ("k7", K7_SCENES),
                          *((part, K6_SCENES) for part in K6_PARTS), ("k2a", K2A_SCENES),
                          ("k1", K1_SCENES), ("p1", P1_CASES)):
        stem = kernel.split("_")[0]  # k6_gp -> k6
        if not any(k.lower() == stem or (stem, k) == ("k4", "K11b") for k in kernels):
            continue
        for name in names:
            name = "-".join(name.split())  # "optional_l12 rows" -> optional_l12-rows
            prefix = os.path.join(outdir, f"{kernel}_{name}_")
            runs = {f[len(prefix):-4]: np.load(f) for f in sorted(glob.glob(prefix + "*.npz"))}
            key = f"{kernel.upper()} {name}"
            if len(runs) != 2:
                out[key] = f"{len(runs)} trees' answers, not 2"
                ok = False
                continue
            (ta, a), (tb, b) = sorted(runs.items())
            same_inputs = str(a["sha"]) == str(b["sha"])
            if kernel == "k4":
                entries = int(np.prod(a["shape"]))
                differ = int(np.unpackbits(a["bits"] ^ b["bits"]).sum())
            else:  # bit for bit: the float32 patterns, or K9's bytes
                entries = int(a["x"].size)
                word = np.uint32 if a["x"].dtype.itemsize == 4 else np.uint8
                differ = int((a["x"].view(word) != b["x"].view(word)).sum())
            out[key] = {"trees": [ta, tb], "entries": entries, "entries_differ": differ,
                        "same_inputs": same_inputs}
            if kernel in ("k7", "k6_gp"):  # atomic sums, or lights in another order
                rel = float(np.abs(a["x"] - b["x"]).max()) / max(float(np.abs(b["x"]).max()), 1e-30)
                out[key]["max_diff_over_largest"] = rel
                ok = ok and same_inputs and rel <= (K7_TOL if kernel == "k7" else K6_TOL)
                continue
            ok = ok and same_inputs and differ == 0
    print(json.dumps({"answers": out, "equal": ok}), flush=True)
    return 0 if ok else 1


def _light_mesh_steps(scene, dev, cs) -> tuple:
    """ms per step of REPEATS runs of LIGHT_MESH_STEPS light and mesh train
    steps (``cs._fit``, the tree's chip_smoke.py), and the device's busy
    ms in one more step under torch.profiler."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.grad import diff_render as dr

    cfg = RenderConfig()
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    pick, merge = cs._fit("light+mesh")
    params = dr.trainable(pick(scene))
    step = dr.make_train_step(cfg, torch.optim.SGD(params.values(), lr=1e-1), merge,
                              payload_grad=True)
    step(params, scene, target)  # the first step, not counted
    out = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LIGHT_MESH_STEPS):
            step(params, scene, target)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / LIGHT_MESH_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, scene, target)
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, busy


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
