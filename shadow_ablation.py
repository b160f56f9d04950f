"""The group walk's kernels K4, K10, K5, K3, K11a, K9, K2b, K8 and K7 on one
CUDA card with parts of their design taken out: what each part of the walk
(raytpu_torch/render/csrc/shadow.cuh) buys.

    python3 shadow_ablation.py               # prints one JSON line
    python3 shadow_ablation.py --kernels K9  # only K9's cases and variants

Each variant is the kernels' sources built with one change to shadow.cuh,
packed.cu, chunked.cu, soft.cu, mega3.cu or mega2.cu (nvcc, the package's
flags, one library per variant under raytpu_torch/_build/ablation, all
compiled at once).  The kernels run on frame 0 at 640x480, their inputs
formed as chip_smoke.py phase 4 forms them: K4 on the shadow queries of
bunny50k and bunny300k, K10 on those of optional_l12, bunny18k_l12 and
reference_s106 (the chunked route), K5 on the soft shadow queries of
optional, bunny50k and bunny300k, K3 on the camera rays of bunny50k and
bunny300k (the packed route's), K11a on the frames of optional, bunny50k
and bunny300k (the mega3 route's), K9 on the shadow queries of
optional_l12 and bunny18k_l12, of the camera rays in 32x32 blocks (as
K10's) and row-major ("rows", ``chunked.shade_rays``' order), K2b on
K2a's buffer of bunny and optional (the mega2 route's), K9 also on the
folded queries of reference_s106 (no records: the few-groups kernel), K8
(closest mode) on the camera rays of optional_l12, bunny18k_l12 and
reference_s106 in 32x32 blocks (the route's) and of the first two
row-major (``chunked.shade_rays``'), K7 on the soft shadow queries of
optional, bunny50k and bunny300k with a random cotangent; each is timed
with CUDA events (REPEATS runs of ITERS launches), and each variant's
answer (K4's, K9's and K5's (L, R), K10's (R, 3) colors, K3's and K8's
(t, idx, normal, material), K11a's buffer and tile boxes, K2b's image)
must equal the design's bit for bit, K7's (T, 9) sums within 1e-4 of the
largest (its atomics add in another order each run; its variant
soft_records, which is not exact, is timed only, its difference
printed), and the design's the package wrapper's on the
same inputs (``packed.any_hit_lights``, ``chunked.shadow_shade``,
``soft.soft_trans_lights_cuda``, ``packed.winner_search``,
``mega3.mega3_closest``, ``chunked.any_hit_lights``,
``mega2.mega2_shade``, ``chunked.chunked_min_t``, ``soft.soft_dprim``):

  design        the kernels as committed;
  no_bundle     (K4) no test of the warp's bundle: every listed entry goes
                to each ray's box test;
  no_ray_box    (K4, K10, K5, K3, K11a, K9, K2b, K8, K7) no per-ray box
                test: a warp visits a group's triangles for every live
                lane wherever the bundle test passes;
  no_boxes      (K4, K8, K7) neither test: every listed triangle, with the
                warp-granular exit, 128-thread blocks and 8x4 pixel warps
                kept;
  no_warp_exit  (K4) a warp walks its whole row even when every lane is
                resolved;
  rows          (K4) each warp takes a row of 32 pixels, not an 8x4 block;
  warp_slot     (K9) each warp takes the 8x4 pixel block of warp_slot, not
                32 consecutive rays;
  k8_rows       (K8) each warp takes 32 consecutive rays, not warp_slot's
                8x4 pixel block;
  atomics       (K7) each lane adds its own nonzero partials with
                atomicAdd as it visits, not the warp's sums after each group;
  soft_records  (K7) K5's soft records (support 20) instead of the
                gradient records: not exact (it drops partials that are
                small but not 0), timed only;
  block1024     (K4, K10, K5, K3, K11a, K9, K2b, K8, K7) one 1024-thread
                block per (tile, light) (K4, K5, K9, K7) or per tile (K10,
                K3, K11a, K2b, K8), not eight of 128;
  kappa_records (K3, K11a, K9, K2b, K8) kappa's 8-float records
                (``packed.shadow_records``) instead of the 32-float normal
                records;
  whole_line    (K3, K11a, K8) each ray's box test on the whole line (mag =
                inf), not on the segment up to its current closest hit;
  kappa         (K10, K5) the normal records' widening replaced by kappa's
                (K4's widening on the same records): the triangles'
                normals taken out;
  no_pretest    (K10, K5) the normal records' tests without kappa's
                cheaper test before them;
  no_direct     (K10, K9, K8) a scene of a few groups (reference_s106) is
                given the normal records too, so it takes the walk's
                kernel, not the one that tests every listed triangle;
  regs64        (K10, K5, K2b, K8, K7) at most 64 registers a thread
                (launch bounds of 8 blocks of 128 an SM, not 4);
  bounds4       (K9) launch bounds of 4 blocks of 128 an SM, not 8 (at most
                128 registers a thread, not 64);
  bounds2       (K9, K2b, K8, K7) launch bounds of 2 blocks of 128 an SM,
                not 8 or 4 (at most 255 registers a thread).

Beside the kernels' times the line holds, per K10 and K5 scene, the
milliseconds a frame or step spends building the records
(``accel.normal_boxes``) and all of the kernel's per-frame inputs
(records and worklists: ``chunked.shadow_inputs``, ``soft.soft_boxes``),
CUDA events around back-to-back calls, which on these host-bound calls
is the host's time to issue them.

The variants are replacements of exact lines of the committed sources: the
script raises when one of those lines has changed, and the variants must
then be restated against the new sources.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
REPEATS, ITERS = 3, 5
K4_SCENES = ("bunny50k", "bunny300k")
K10_SCENES = ("optional_l12", "bunny18k_l12", "reference_s106")
K5_SCENES = ("optional", "bunny50k", "bunny300k")
#: K9's: each fixture's queries of camera rays in 32x32 blocks, and of
#: row-major ones (" rows")
K9_SCENES = ("optional_l12", "bunny18k_l12", "optional_l12 rows", "bunny18k_l12 rows",
             "reference_s106")
K2B_SCENES = ("bunny", "optional")
#: K8's: the route's camera rays in 32x32 blocks, and row-major (" rows")
K8_SCENES = ("optional_l12", "bunny18k_l12", "reference_s106", "optional_l12 rows",
             "bunny18k_l12 rows")
K7_SCENES = ("optional", "bunny50k", "bunny300k")
K8_BOUNDS = "__launch_bounds__(kShadeBlock, 4) chunked_min_t_kernel"
K8_SLOT = "const int rid = tile * kTile + warp_slot(warp, lane);"
K7_BOUNDS = "__launch_bounds__(kBlock, 4) soft_dprim_kernel"
#: K7's sums add in another order each run: within this share of the
#: largest magnitude, as chip_smoke.py phase 2 holds them
K7_TOL = 1e-4
#: K7's visit for the variant atomics: each lane adds its own nonzero
#: partials with atomicAdd as it visits, no warp sum
K7_ATOMICS = """    for (int k = k0; k < k1; ++k) {
      float part[9];
      if (!dprim_partials(tri + (size_t)k * kRec, ox, oy, oz, dx, dy, dz, tmin, mag, beta, gob,
                          part))
        continue;
      for (int j = 0; j < 9; ++j)
        if (part[j] != 0.0f) atomicAdd(out + (size_t)k * 9 + j, part[j]);
    }"""
#: variants timed only, their answers' difference printed (not exact)
INEXACT = ("soft_records",)
K9_WALK = "shadow_walk<kTr, kNormalCols, kChunk / 8>"
K2B_WALK = "shadow_walk<kTri, kNormalCols>"
K9_BOUNDS = "__launch_bounds__(kShadeBlock, 8) chunked_anyhit_kernel"
K2B_BOUNDS = "__launch_bounds__(kShadeBlock, 4) mega2_shade_kernel"
RAY_BOX = ("const bool pass = live && seg_box<kNormals>(bj, boxes + kCols * (size_t)gj, o, inv, d,\n"
           "                                                  seg_end(visit, mag));")
BUNDLE = "cand = bundle_box<kNormals>(q, b, boxes + kCols * (size_t)g);"
CLOSEST_WALK = ("group_walk<kRec, kNormalCols, kExpand>(tri, T, boxes, w, c, live, o, d, INFINITY, "
                "visit);")
#: variant -> (the kernels it applies to, [(file, text in the design, text in the variant)])
VARIANTS = {
    "design": ("K4 K10 K5 K3 K11a K9 K2b K8 K7", []),
    "no_bundle": ("K4", [("shadow.cuh", BUNDLE, "cand = true;")]),
    "no_ray_box": ("K4 K10 K5 K3 K11a K9 K2b K8 K7",
                   [("shadow.cuh", RAY_BOX, "const bool pass = live;")]),
    "no_boxes": ("K4 K8 K7", [("shadow.cuh", BUNDLE, "cand = true;"),
                              ("shadow.cuh", RAY_BOX, "const bool pass = live;")]),
    "no_warp_exit": ("K4", [("shadow.cuh", "if (__all_sync(kFullWarp, !live)) return;", "")]),
    "rows": ("K4", [("shadow.cuh",
                     "return ((warp / 4) * 4 + lane / 8) * 32 + (warp % 4) * 8 + lane % 8;",
                     "return warp * 32 + lane;")]),
    "warp_slot": ("K9", [("chunked.cu", "const int rid = tile * kTile + warp * 32 + lane;",
                          "const int rid = tile * kTile + warp_slot(warp, lane);")]),
    "k8_rows": ("K8", [("chunked.cu", K8_SLOT,
                        "const int rid = tile * kTile + warp * 32 + lane;")]),
    "atomics": ("K7", [("soft.cu", "static constexpr bool kReduces = true;",
                        "static constexpr bool kReduces = false;"),
                       ("soft.cu", "    pending = true;  // reduce computes this lane's partials",
                        K7_ATOMICS)]),
    # the same library, given K5's soft records (k7_launcher)
    "soft_records": ("K7", []),
    "block1024": ("K4 K10 K5 K3 K11a K9 K2b K8 K7", [
        ("packed.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 1024;"),
        ("packed.cu", "__launch_bounds__(kBlock, 4) packed_anyhit_kernel",
         "__launch_bounds__(kBlock, 1) packed_anyhit_kernel"),
        ("packed.cu", "__launch_bounds__(kBlock, 4) packed_closest_kernel",
         "__launch_bounds__(kBlock, 1) packed_closest_kernel"),
        ("mega3.cu", "constexpr int kShadeBlock = 128;", "constexpr int kShadeBlock = 1024;"),
        ("mega3.cu", "__launch_bounds__(kShadeBlock, 4) mega3_closest_kernel",
         "__launch_bounds__(kShadeBlock, 1) mega3_closest_kernel"),
        ("mega3.cu", "__launch_bounds__(kShadeBlock, 4) mega3_shade_kernel",
         "__launch_bounds__(kShadeBlock, 1) mega3_shade_kernel"),
        ("chunked.cu", "constexpr int kShadeBlock = 128;", "constexpr int kShadeBlock = 1024;"),
        ("chunked.cu", "__launch_bounds__(kShadeBlock, kWalk ? 4 : 8) chunked_shadow_shade_kernel",
         "__launch_bounds__(kShadeBlock, 1) chunked_shadow_shade_kernel"),
        ("soft.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 1024;"),
        ("soft.cu", "__launch_bounds__(kBlock, 4) soft_trans_kernel",
         "__launch_bounds__(kBlock, 1) soft_trans_kernel"),
        ("chunked.cu", K9_BOUNDS, K9_BOUNDS.replace(", 8)", ", 1)")),
        ("mega2.cu", "constexpr int kShadeBlock = 128;", "constexpr int kShadeBlock = 1024;"),
        ("mega2.cu", K2B_BOUNDS, K2B_BOUNDS.replace(", 4)", ", 1)")),
        ("chunked.cu", K8_BOUNDS, K8_BOUNDS.replace(", 4)", ", 1)")),
        ("soft.cu", K7_BOUNDS, K7_BOUNDS.replace(", 4)", ", 1)"))]),
    "kappa": ("K10 K5", [
        ("shadow.cuh", "widen_scaled(b, dd[0] + dd[1] + dd[2], ray_scale(b, rec, d), lo, hi);",
         "widen(b, dd[0] + dd[1] + dd[2], lo, hi);"),
        ("shadow.cuh", "widen_scaled(b, d[0] + d[1] + d[2], least_scale(b, least), lo, hi);",
         "widen(b, d[0] + d[1] + d[2], lo, hi);")]),
    "no_pretest": ("K10 K5", [
        ("shadow.cuh", "if (!seg_box<false>(b, rec, o, inv, d, mag)) return false;", ""),
        ("shadow.cuh", "if (!bundle_box<false>(q, b, rec)) return false;", "")]),
    # the same library, given the normal records (k10_launcher, k9_launcher,
    # k8_launcher)
    "no_direct": ("K10 K9 K8", []),
    # the launchers pass kappa's records to this variant (k3_launcher,
    # k11a_launcher, k9_launcher, k2b_launcher, k8_launcher)
    "kappa_records": ("K3 K11a K9 K2b K8", [
        ("shadow.cuh", CLOSEST_WALK, CLOSEST_WALK.replace("kNormalCols", "kBoxCols")),
        ("chunked.cu", K9_WALK, K9_WALK.replace("kNormalCols", "kBoxCols")),
        ("mega2.cu", K2B_WALK, K2B_WALK.replace("kNormalCols", "kBoxCols"))]),
    "whole_line": ("K3 K11a K8", [("shadow.cuh", "    return visit.t;", "    return INFINITY;")]),
    "regs64": ("K10 K5 K2b K8 K7", [
        ("chunked.cu", "__launch_bounds__(kShadeBlock, kWalk ? 4 : 8) chunked_shadow_shade_kernel",
         "__launch_bounds__(kShadeBlock, 8) chunked_shadow_shade_kernel"),
        ("soft.cu", "__launch_bounds__(kBlock, 4) soft_trans_kernel",
         "__launch_bounds__(kBlock, 8) soft_trans_kernel"),
        ("mega2.cu", K2B_BOUNDS, K2B_BOUNDS.replace(", 4)", ", 8)")),
        ("chunked.cu", K8_BOUNDS, K8_BOUNDS.replace(", 4)", ", 8)")),
        ("soft.cu", K7_BOUNDS, K7_BOUNDS.replace(", 4)", ", 8)"))]),
    "bounds4": ("K9", [("chunked.cu", K9_BOUNDS, K9_BOUNDS.replace(", 8)", ", 4)"))]),
    "bounds2": ("K9 K2b K8 K7", [("chunked.cu", K9_BOUNDS, K9_BOUNDS.replace(", 8)", ", 2)")),
                                 ("mega2.cu", K2B_BOUNDS, K2B_BOUNDS.replace(", 4)", ", 2)")),
                                 ("chunked.cu", K8_BOUNDS, K8_BOUNDS.replace(", 4)", ", 2)")),
                                 ("soft.cu", K7_BOUNDS, K7_BOUNDS.replace(", 4)", ", 2)"))]),
}
#: each kernel's source and the kernel entry whose ptxas line is kept
SOURCES = {"K4": ("packed.cu", "packed_anyhit"),
           "K10": ("chunked.cu", "chunked_shadow_shade_kernelILb1E"),  # the walk's instance
           "K5": ("soft.cu", "soft_trans"),
           "K3": ("packed.cu", "packed_closest"),
           "K11a": ("mega3.cu", "mega3_closest"),
           "K9": ("chunked.cu", "chunked_anyhit_kernelILb1E"),  # the walk's instance
           "K2b": ("mega2.cu", "mega2_shade"),
           "K8": ("chunked.cu", "chunked_min_t_kernelILb1ELb0E"),  # the closest walk's instance
           "K7": ("soft.cu", "soft_dprim")}
K3_SCENES = ("bunny50k", "bunny300k")
K11A_SCENES = ("optional", "bunny50k", "bunny300k")


def build_variants(out: Path, keys: list) -> dict:
    """{variant: (library path, {kernel: ptxas registers line})}, every
    variant of the kernels ``keys`` compiled at once, each from the sources
    of those of them it applies to."""
    from raytpu_torch.render import build

    csrc = REPO / "raytpu_torch" / "render" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for name, (applies, patches) in VARIANTS.items():
        kernels = " ".join(k for k in applies.split() if k in keys)
        if not kernels:
            continue
        src = out / name
        src.mkdir(parents=True)
        for f in ("common.cuh", "shadow.cuh", "packed.cu", "chunked.cu", "soft.cu", "mega3.cu",
                  "mega2.cu"):
            shutil.copy(csrc / f, src / f)
        for f, old, new in patches:
            text = (src / f).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {f} no longer holds {old!r}")
            (src / f).write_text(text.replace(old, new))
        lib = src / "libwalk.so"
        files = sorted({str(src / SOURCES[k][0]) for k in kernels.split()})
        procs[name] = (lib, kernels.split(), subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", *files, "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, kernels, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        regs = {}
        for k in kernels:  # ptxas's spill line and registers line of the kernel
            entry = next(i for i, ln in enumerate(lines)
                         if "Compiling entry" in ln and SOURCES[k][1] in ln)
            regs[k] = " | ".join(next(ln.strip() for ln in lines[entry:] if word in ln)
                                 for word in ("spill", "registers"))
        libs[name] = (lib, regs)
    return libs


def _frame_queries(scene, cfg, closest, fold=True):
    """Shadow queries ``(p, dirs, mags)`` of frame 0's camera rays, folded
    into 32x32 blocks or with ``fold`` False row-major, and the hit records
    ``closest(scene, ro, rd, tmin)`` gives."""
    from raytpu_torch.render import packed, renderer

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if fold:
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    rec = closest(scene, ro, rd, cfg.ray_min)
    return rd, rec, tuple(x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))


def _packed_closest(scene, ro, rd, tmin):
    from raytpu_torch.render import packed

    t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, tmin)
    return packed.hit_records_from_payload(ro, rd, t, normal, mat)


def k4_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K4 on the scene's frame 0."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed

    _, _, (p, dirs, mags) = _frame_queries(scene, cfg, _packed_closest)
    glo, ghi, records = accel.normal_boxes(scene.triangles)
    boxes = packed.shadow_records(records)
    wl, cnt = packed.shadow_worklists(scene, p, dirs, mags, cfg.ray_min, group_bounds=(glo, ghi))
    sph, pln, tri = packed.soft_packs(scene)
    L, R = dirs.shape[:2]

    def launch(lib, out, variant):
        return lib.raytpu_packed_anyhit(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), sph.shape[0],
            pln.data_ptr(), pln.shape[0], tri.data_ptr(), tri.shape[0], boxes.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    want = packed.any_hit_lights(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, cfg.ray_min)
    return torch.empty((L, R), dtype=torch.uint8, device=dev), launch, None, want.to(torch.uint8)


def k10_launcher(scene, cfg, dev):
    """(output, launch(fn, out, variant), {what: ms}, the package's answer)
    for K10 on the chunked route's frame 0, with the records
    ``chunked.shadow_inputs`` chooses, or for the variant no_direct always
    the normal records; the ms to build the records and all of K10's
    inputs."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked, packed, plain

    rd, rec, (p, dirs, mags) = _frame_queries(scene, cfg, chunked.closest_hit_chunked)
    boxes, wl, cnt = chunked.shadow_inputs(scene, p, dirs, mags, cfg.ray_min)
    records = accel.normal_boxes(scene.triangles)[2]
    glue = glue_ms(lambda: accel.normal_boxes(scene.triangles),
                   lambda: chunked.shadow_inputs(scene, p, dirs, mags, cfg.ray_min))
    sph, pln, tri = packed.soft_packs(scene)
    lights, mats = plain.pack_lights(scene.lights), plain.material_table(scene.materials)
    hit, normal, point = rec.hit, rec.normal.contiguous(), rec.point.contiguous()
    mat = rec.material.contiguous()
    L, R = dirs.shape[:2]

    def launch(lib, out, variant):
        b = records if variant == "no_direct" or boxes is not None else None
        return lib.raytpu_chunked_shadow_shade(
            hit.data_ptr(), normal.data_ptr(), point.data_ptr(), mat.data_ptr(), rd.data_ptr(),
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, lights.data_ptr(),
            mats.data_ptr(), mats.shape[0], sph.data_ptr(), sph.shape[0], pln.data_ptr(),
            pln.shape[0], tri.data_ptr(), tri.shape[0], None if b is None else b.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min),
            int(cfg.lighting_mode), 1, float(cfg.shadow_dim), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    want = chunked.shadow_shade(hit, normal, point, mat, rd, p, dirs, mags, lights, mats, sph, pln,
                                tri, boxes, wl, cnt, cfg)
    return torch.empty((R, 3), dtype=torch.float32, device=dev), launch, glue, want


def k5_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), {what: ms}, the package's answer)
    for K5 on the soft shadow queries of the differentiable path's frame 0;
    the ms to build the soft records and all of K5's inputs."""
    import dataclasses

    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, soft

    cfg = dataclasses.replace(cfg, soft_shadows=True)
    _, _, (p, dirs, mags) = _frame_queries(scene, cfg, _packed_closest)
    boxes, wl, cnt = soft.soft_boxes(scene, p, dirs, mags, cfg.ray_min, cfg.soft_beta)
    glue = glue_ms(lambda: accel.normal_boxes(scene.triangles, soft_beta=cfg.soft_beta),
                   lambda: soft.soft_boxes(scene, p, dirs, mags, cfg.ray_min, cfg.soft_beta))
    sph, pln, tri = packed.soft_packs(scene)
    L, R = dirs.shape[:2]

    def launch(lib, out, variant):
        return lib.raytpu_soft_trans(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), sph.shape[0],
            pln.data_ptr(), pln.shape[0], tri.data_ptr(), tri.shape[0], boxes.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min),
            float(cfg.soft_beta), out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    want = soft.soft_trans_lights_cuda(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, cfg.ray_min,
                                       cfg.soft_beta)
    return torch.empty((L, R), dtype=torch.float32, device=dev), launch, glue, want


def k3_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K3 on the scene's folded camera rays of frame 0: the answer flat, t,
    idx, normal (R, 3), material, each R or 3R words.  The variant
    kappa_records gets kappa's records."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import packed, renderer

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)
    kappa = packed.shadow_records(boxes)
    wl, cnt = packed.closest_worklists(scene, ro, rd, cfg.ray_min, group_bounds=(glo, ghi))
    sph, pln, tri = packed.soft_packs(scene)
    R = rd.shape[0]

    def launch(lib, out, variant):
        b = kappa if variant == "kappa_records" else boxes
        ptr = out.data_ptr()
        return lib.raytpu_packed_closest(
            ro.data_ptr(), rd.data_ptr(), R, sph.data_ptr(), sph.shape[0], pln.data_ptr(),
            pln.shape[0], tri.data_ptr(), tri.shape[0], b.data_ptr(), wl.data_ptr(),
            cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min), ptr, ptr + 4 * R, ptr + 8 * R,
            ptr + 20 * R, torch.cuda.current_stream().cuda_stream)

    t, idx, normal, mat = packed.winner_search(ro, rd, sph, pln, tri, boxes, wl, cnt, cfg.ray_min)
    want = torch.cat([t, idx.view(torch.float32), normal.flatten(), mat.view(torch.float32)])
    return torch.empty((6 * R,), dtype=torch.float32, device=dev), launch, None, want


def k11a_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K11a on the scene's frame 0: the buffer (11, nt * 1024) and the tile
    boxes (nt, 6), flat.  The variant kappa_records gets kappa's
    records."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, mega3, packed, plain

    buf, counts = plain.mega_pack(scene, cfg)
    S, P, T, _ = counts
    blob = mega3.pack_groups(buf, counts)
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)
    kappa = packed.shadow_records(boxes)
    wl, cnt = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
    nt = wl.shape[0]
    part = torch.empty((nt * 8, 6), dtype=torch.float32, device=dev)
    done = torch.zeros((nt,), dtype=torch.int32, device=dev)  # the tiles' block counts
    n_acc = mega2.ACC_ROWS * nt * mega2.TILE

    def launch(lib, out, variant):
        b = kappa if variant == "kappa_records" else boxes
        done.zero_()  # as the wrapper's fresh zeros
        return lib.raytpu_mega3_closest(
            buf.data_ptr(), S, P, T, blob.data_ptr(), b.data_ptr(), wl.data_ptr(),
            cnt.data_ptr(), wl.shape[1], cfg.width, cfg.height, int(mega2.is_tiled(cfg)), 0, nt,
            float(cfg.ray_min), float(cfg.normal_offset), out.data_ptr(), part.data_ptr(),
            done.data_ptr(), out.data_ptr() + 4 * n_acc, torch.cuda.current_stream().cuda_stream)

    acc, bounds = mega3.mega3_closest(buf, counts, blob, boxes, wl, cnt, cfg)
    want = torch.cat([acc.flatten(), bounds.flatten()])
    return torch.empty((n_acc + nt * 6,), dtype=torch.float32, device=dev), launch, None, want


def k9_launcher(scene, cfg, dev, order="folded"):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K9 on the shadow queries of K8's hits of frame 0's camera rays, in
    32x32 blocks or ``order`` "rows" row-major, with the inputs of
    ``chunked.shadow_inputs``.  The variant kappa_records gets kappa's
    records, no_direct the normal records on every scene."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked, packed

    _, _, (p, dirs, mags) = _frame_queries(scene, cfg, chunked.closest_hit_chunked,
                                           fold=order != "rows")
    boxes, wl, cnt = chunked.shadow_inputs(scene, p, dirs, mags, cfg.ray_min)
    records = accel.normal_boxes(scene.triangles)[2]
    kappa = packed.shadow_records(records)
    sph, pln, tri = packed.soft_packs(scene)
    L, R = dirs.shape[:2]

    def launch(lib, out, variant):
        b = {"kappa_records": kappa, "no_direct": records}.get(variant, boxes)
        return lib.raytpu_chunked_anyhit_lights(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), sph.shape[0],
            pln.data_ptr(), pln.shape[0], tri.data_ptr(), tri.shape[0],
            None if b is None else b.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    want = chunked.any_hit_lights(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, cfg.ray_min)
    return torch.empty((L, R), dtype=torch.uint8, device=dev), launch, None, want.to(torch.uint8)


def k2b_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K2b on K2a's buffer of the scene's frame 0, its inputs built as the
    mega2 route builds them.  The variant kappa_records gets kappa's
    records."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, packed, plain

    buf, counts = plain.mega_pack(scene, cfg)
    S, P, T, L = counts
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)
    kappa = packed.shadow_records(boxes)
    wl, cnt = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
    acc, bounds = mega2.mega2_closest(buf, counts, wl, cnt, cfg)
    wl_s, cnt_s = mega2.shadow_worklists(scene, cfg, bounds, (glo, ghi))
    nt = wl_s.shape[0]

    def launch(lib, out, variant):
        b = kappa if variant == "kappa_records" else boxes
        return lib.raytpu_mega2_shade(
            buf.data_ptr(), S, P, T, L, b.data_ptr(), wl_s.data_ptr(), cnt_s.data_ptr(),
            wl_s.shape[2], cfg.width, cfg.height, int(mega2.is_tiled(cfg)), 0, nt, 0,
            int(cfg.lighting_mode), 1, float(cfg.ray_min), float(cfg.normal_offset),
            float(cfg.shadow_dim), acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    want = mega2.mega2_shade(buf, counts, boxes, wl_s, cnt_s, acc, cfg)
    return torch.empty_like(want), launch, None, want


def k8_launcher(scene, cfg, dev, order="folded"):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K8's closest mode on frame 0's camera rays, in 32x32 blocks or with
    ``order`` "rows" row-major, with the records and worklists the route
    builds (``chunked.frame_records``): the answer flat, t, idx, normal
    (R, 3), material.  The variant kappa_records gets kappa's records,
    no_direct the normal records on every scene."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import chunked, packed, renderer

    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if order != "rows":
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    records = chunked.frame_records(scene)
    normal = accel.normal_boxes(scene.triangles)
    wl, cnt = packed.closest_worklists(scene, ro, rd, cfg.ray_min, group=chunked.CHUNK,
                                       group_bounds=normal[:2])
    boxes = None if records is None else records[2]
    kappa = packed.shadow_records(normal[2])
    sph, pln, tri = packed.soft_packs(scene)
    R = rd.shape[0]

    def launch(lib, out, variant):
        b = {"kappa_records": kappa, "no_direct": normal[2]}.get(variant, boxes)
        ptr = out.data_ptr()
        return lib.raytpu_chunked_min_t(
            ro.data_ptr(), rd.data_ptr(), None, R, sph.data_ptr(), sph.shape[0], pln.data_ptr(),
            pln.shape[0], tri.data_ptr(), tri.shape[0], None if b is None else b.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(cfg.ray_min), 0, ptr,
            ptr + 4 * R, ptr + 8 * R, ptr + 20 * R, torch.cuda.current_stream().cuda_stream)

    t, idx, nrm, mat = chunked.chunked_min_t(ro, rd, None, sph, pln, tri, wl, cnt, cfg.ray_min,
                                             False, boxes)
    want = torch.cat([t, idx.view(torch.float32), nrm.flatten(), mat.view(torch.float32)])
    return torch.empty((6 * R,), dtype=torch.float32, device=dev), launch, None, want


def k7_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K7 on the soft shadow queries of the differentiable path's frame 0, K5's
    worklists and transmittance and a random cotangent, with the gradient
    records (``soft.grad_boxes``); the variant soft_records gets K5's soft
    records.  Each launch zeroes its (T, 9) output first, as the wrapper's
    fresh zeros."""
    import dataclasses

    import torch

    from raytpu_torch.render import packed, soft

    cfg = dataclasses.replace(cfg, soft_shadows=True)
    tmin, beta = cfg.ray_min, cfg.soft_beta
    _, _, (p, dirs, mags) = _frame_queries(scene, cfg, _packed_closest)
    trans, (blobs, wl, cnt) = soft.soft_trans_lights_kernel(scene, p, dirs, mags, tmin, beta)
    soft_rec = soft.soft_boxes(scene, p, dirs, mags, tmin, beta)[0]
    boxes = soft.grad_boxes(scene, beta)
    g = torch.rand(trans.shape, generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev) * 2.0 - 1.0
    tri = blobs[2]
    L, R = dirs.shape[:2]

    def launch(lib, out, variant):
        b = soft_rec if variant == "soft_records" else boxes
        out.zero_()
        return lib.raytpu_soft_dprim(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, tri.data_ptr(), tri.shape[0],
            b.data_ptr(), wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(tmin), float(beta),
            g.data_ptr(), trans.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    want = soft.soft_dprim(p, dirs, mags, g, trans, tri, wl, cnt, tmin, beta, boxes)
    return torch.empty_like(want), launch, None, want


def glue_ms(records, inputs) -> dict:
    """The median ms of REPEATS timings of ITERS back-to-back calls of
    ``records()`` and of ``inputs()``."""
    from raytpu_torch.utils.profiling import device_ms

    return {what: sorted(device_ms(fn, iters=ITERS, warmup=1) for _ in range(REPEATS))[REPEATS // 2]
            for what, fn in (("records_ms", records), ("inputs_ms", inputs))}


def _bind(lib_path: str, kernels: list):
    """The variant's library with the C signatures of its kernels set."""
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib = ctypes.CDLL(lib_path)
    sp_tri = [c_ptr, c_int, c_ptr, c_int, c_ptr, c_int]
    if "K4" in kernels:
        lib.raytpu_packed_anyhit.argtypes = ([c_ptr, c_ptr, c_ptr, c_int, c_int] + sp_tri
                                             + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_ptr, c_ptr])
    if "K10" in kernels:
        lib.raytpu_chunked_shadow_shade.argtypes = (
            [c_ptr] * 8 + [c_int, c_int, c_ptr, c_ptr, c_int] + sp_tri
            + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_int, c_int, c_float, c_ptr, c_ptr])
    if "K5" in kernels:
        lib.raytpu_soft_trans.argtypes = ([c_ptr, c_ptr, c_ptr, c_int, c_int] + sp_tri
                                          + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_float, c_ptr,
                                             c_ptr])
    if "K3" in kernels:
        lib.raytpu_packed_closest.argtypes = ([c_ptr, c_ptr, c_int] + sp_tri
                                              + [c_ptr, c_ptr, c_ptr, c_int, c_float]
                                              + [c_ptr] * 5)
    if "K11a" in kernels:
        lib.raytpu_mega3_closest.argtypes = ([c_ptr, c_int, c_int, c_int, c_ptr, c_ptr, c_ptr,
                                              c_ptr] + [c_int] * 6 + [c_float, c_float]
                                             + [c_ptr] * 5)
    if "K9" in kernels:
        lib.raytpu_chunked_anyhit_lights.argtypes = ([c_ptr, c_ptr, c_ptr, c_int, c_int] + sp_tri
                                                     + [c_ptr, c_ptr, c_ptr, c_int, c_float,
                                                        c_ptr, c_ptr])
    if "K2b" in kernels:
        lib.raytpu_mega2_shade.argtypes = ([c_ptr, c_int, c_int, c_int, c_int, c_ptr, c_ptr, c_ptr]
                                           + [c_int] * 9 + [c_float] * 3 + [c_ptr] * 3)
    if "K8" in kernels:
        lib.raytpu_chunked_min_t.argtypes = ([c_ptr, c_ptr, c_ptr, c_int] + sp_tri
                                             + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_int]
                                             + [c_ptr] * 5)
    if "K7" in kernels:
        lib.raytpu_soft_dprim.argtypes = ([c_ptr, c_ptr, c_ptr, c_int, c_int, c_ptr, c_int, c_ptr,
                                           c_ptr, c_ptr, c_int, c_float, c_float] + [c_ptr] * 4)
    return lib


def main(argv=None) -> int:
    import argparse

    import torch

    from raytpu_torch.core import scenes
    from raytpu_torch.core.types import RenderConfig
    from raytpu_torch.render import build
    from raytpu_torch.utils.profiling import device_ms

    every = list(SOURCES)
    ap = argparse.ArgumentParser(description="the group walk's kernels with parts taken out")
    ap.add_argument("--kernels", nargs="+", choices=every, default=every,
                    help="the kernels to build and time (default: all)")
    keys = ap.parse_args(argv).kernels
    if not torch.cuda.is_available():
        print("shadow_ablation: this needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    libs = build_variants(build.BUILD_DIR / "ablation", keys)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = RenderConfig()
    out = {"card": smi, "registers": {n: r for n, (_, r) in libs.items()}, "ms": {},
           "records": {}}
    bound = {n: _bind(str(lib), list(regs)) for n, (lib, regs) in libs.items()}

    def scene(name):
        if name == "optional_l12":
            return cs.nine_lights(scenes.get("optional").build(dev))
        if name == "bunny18k_l12":
            return cs.nine_lights(scenes.scene_bunny_subdiv(3, device=dev))
        if name == "reference_s106":
            return cs.sphere_grid(scenes.get("reference").build(dev))
        return scenes.get(name).build(dev)

    for key, names, make in (("K4", K4_SCENES, k4_launcher), ("K10", K10_SCENES, k10_launcher),
                             ("K5", K5_SCENES, k5_launcher), ("K3", K3_SCENES, k3_launcher),
                             ("K11a", K11A_SCENES, k11a_launcher),
                             ("K9", K9_SCENES, k9_launcher), ("K2b", K2B_SCENES, k2b_launcher),
                             ("K8", K8_SCENES, k8_launcher), ("K7", K7_SCENES, k7_launcher)):
        if key not in keys:
            continue
        variants = [n for n, (kernels, _) in VARIANTS.items() if key in kernels.split()]
        for scene_name in names:
            name, *order = scene_name.split()  # "rows": K9 on row-major queries
            template, launch, glue, want = make(scene(name), cfg, dev, *order)
            answers, ms = {}, {}
            for name in variants:
                lib, res = bound[name], template.clone()

                def run():
                    err = launch(lib, res, name)
                    if err:
                        raise RuntimeError(f"{key} {name}: launch failed ({err})")

                run()
                torch.cuda.synchronize()
                answers[name] = res.clone()
                ms[name] = sorted(device_ms(run, iters=ITERS, warmup=1) for _ in range(REPEATS))
            if key == "K7":  # atomic sums: within K7_TOL of the largest
                def differ(a, b):
                    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

                diffs = {n: differ(a, answers["design"]) for n, a in answers.items()}
                out["k7_diff_to_design"] = out.get("k7_diff_to_design", {})
                out["k7_diff_to_design"][scene_name] = diffs
                bad = {n: v for n, v in diffs.items() if n not in INEXACT and v > K7_TOL}
                if differ(answers["design"], want) > K7_TOL or bad:
                    raise AssertionError(f"K7 {scene_name}: beyond {K7_TOL} of the largest: "
                                         f"{bad}, or the design against the package's")
            else:
                differ = int((answers["design"].view(torch.uint8) != want.view(torch.uint8)).sum())
                if differ:
                    raise AssertionError(f"{key} {scene_name}: the design's answer differs from "
                                         f"the package's in {differ} bytes")
                for name, ans in answers.items():
                    differ = int((ans.view(torch.uint8)
                                  != answers["design"].view(torch.uint8)).sum())
                    if differ:
                        raise AssertionError(f"{key} {scene_name} {name}: {differ} bytes differ "
                                             f"from the design's answer")
            out["ms"][f"{key} {scene_name}"] = {
                n: {"median": v[len(v) // 2], "min": v[0], "max": v[-1]} for n, v in ms.items()}
            if glue is not None:
                out["records"][f"{key} {scene_name}"] = glue
    out["answers_equal_to_design"] = True
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
