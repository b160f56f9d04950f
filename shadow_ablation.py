"""The group walk's kernels K4, K10, K5, K3, K11a, K9, K2b, K8, K7, K6 and
K2a, the whole-frame megakernel K1 and the fold probe P1 on one CUDA card
with parts of their design taken out: what each part of the walk
(raytpu_torch/render/csrc/shadow.cuh) and of K1's and P1's layouts buys.

    python3 shadow_ablation.py               # prints one JSON line
    python3 shadow_ablation.py --kernels K9  # only K9's cases and variants
    python3 shadow_ablation.py --kernels K1 P1

Each variant is the kernels' sources built with one change to shadow.cuh,
closest.cuh, packed.cu, chunked.cu, soft.cu, mega3.cu, mega2.cu, mega.cu or
probes.cu (nvcc,
the package's flags, one library per variant under
raytpu_torch/_build/ablation, all compiled at once).  The kernels run on
frame 0 at 640x480, their inputs formed as chip_smoke.py phase 4 forms
them: K4 on the shadow queries of bunny50k and bunny300k, K10 on those of
optional_l12, bunny18k_l12 and reference_s106 (the chunked route), K5 on
the soft shadow queries of
optional, bunny50k and bunny300k, K3 on the camera rays of bunny50k and
bunny300k (the packed route's), K11a on the frames of optional, bunny50k
and bunny300k (the mega3 route's), K9 on the shadow queries of
optional_l12 and bunny18k_l12, of the camera rays in 32x32 blocks (as
K10's) and row-major ("rows", ``chunked.shade_rays``' order), K2b on
K2a's buffer of bunny and optional (the mega2 route's), K9 also on the
folded queries of reference_s106 (no records: the few-groups kernel), K8
(closest mode) on the camera rays of optional_l12, bunny18k_l12 and
reference_s106 in 32x32 blocks (the route's) and of the first two
row-major (``chunked.shade_rays``'), K7 and K6 on the soft shadow
queries of optional, bunny50k and bunny300k with a random cotangent, K2a
on the frames of bunny and optional (the mega2 route's), K1 on the frames
of reference and w4_test at 640x480 and of reference at 50x37 (where a
launch takes less than the host's call, so its times measure the host),
160x120, 320x240 and 1920x1080 (row-major rays, H no multiple of 32),
P1 in its twelve cases (T = 64, 384, 1024; in order or through the
worklist; staged or not) over 300 tiles of the draw in front of the rays;
each is timed
with CUDA events (REPEATS runs of ITERS launches), and each variant's
answer (K4's, K9's and K5's (L, R), K10's (R, 3) colors, K3's and K8's
(t, idx, normal, material), K11a's and K2a's buffer and tile boxes, K2b's
image, K6's g_p, g_dirs and g_mags, K1's image, P1's output) must equal
the design's bit for bit,
K7's (T, 9) sums within 1e-4 of the largest (its atomics add in another
order each run) and K6's per_ray and fold1024 within 1e-4 of each
output's largest (they add the lights in another order); the variant
soft_records, which is
not exact, is timed only, its difference printed, and for K6 the (query,
triangle) pairs with a nonzero partial that it drops are counted
(``dropped_partials``); the design's answer must equal the package
wrapper's on the same inputs (``packed.any_hit_lights``,
``chunked.shadow_shade``, ``soft.soft_trans_lights_cuda``,
``packed.winner_search``, ``mega3.mega3_closest``,
``chunked.any_hit_lights``, ``mega2.mega2_shade``,
``chunked.chunked_min_t``, ``soft.soft_dprim``, ``soft.soft_dray``,
``mega2.mega2_closest``, ``cuda_kernel.render_image_mega_f32``,
``probe_smem.smem_fold``):

  design        the kernels as committed;
  first_port    (K1, P1) the first port's layout: K1 in 256-thread blocks
                on row-major rays, its tests without the early miss; P1
                a thread a ray in 1024-thread blocks, the triangle's
                twelve floats read one by one;
  mask          (K1) every light's shadow query into one bit of a mask
                before the shading, as K2b, not each right before its
                light's shading;
  no_early      (K1) the tests without common.cuh's kEarly: each runs to
                its end;
  k1_rows       (K1) row-major rays on the whole frame, not warp_slot's
                8x4 pixel blocks of 32x32 tiles;
  unroll1, unroll2, unroll4
                (K1) ``#pragma unroll`` 1, 2 or 4 on the closest-hit
                loops, not nvcc's own choice;
  persistent    (K1) a grid of 8 blocks an SM, each staging the scene once
                and looping over 128-ray blocks of slots;
  readonly      (K1) no staging: the scene read from device memory through
                the read-only path;
  block256      (K1, P1) 256-thread blocks, not 128 (launch bounds of 4);
  block64       (P1) 64-thread blocks (launch bounds of 16);
  rays1, rays2, rays8
                (P1) a thread folds 1, 2 or 8 rays, not 4 (rays8 at launch
                bounds of 4 blocks);
  bounds12      (K1) launch bounds of 12 blocks of 128 an SM, not 8;
  no_bundle     (K4) no test of the warp's bundle: every listed entry goes
                to each ray's box test;
  no_ray_box    (K4, K10, K5, K3, K11a, K9, K2b, K8, K7, K6, K2a) no
                per-ray box test: a warp visits a group's triangles for
                every live lane wherever the bundle test passes;
  no_boxes      (K4, K8, K7, K6, K2a) neither test: every listed triangle,
                with the warp-granular exit, 128-thread blocks and 8x4
                pixel warps kept;
  fold1024      (K6, K2a) the parent's layout: neither test, one
                1024-thread block a tile, K6's thread taking its ray's
                lights in a loop;
  per_ray       (K6) the other form of K6: a thread per ray, its lights in
                a loop, g_p summed in registers across them, no second
                kernel;
  no_warp_exit  (K4) a warp walks its whole row even when every lane is
                resolved;
  rows          (K4) each warp takes a row of 32 pixels, not an 8x4 block;
  warp_slot     (K9) each warp takes the 8x4 pixel block of warp_slot, not
                32 consecutive rays;
  k8_rows       (K8) each warp takes 32 consecutive rays, not warp_slot's
                8x4 pixel block;
  atomics       (K7) each lane adds its own nonzero partials with
                atomicAdd as it visits, not the warp's sums after each group;
  soft_records  (K7, K6) K5's soft records (support 20) instead of the
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
  regs64        (K10, K5, K2b, K8, K7, K6, K2a) at most 64 registers a
                thread (launch bounds of 8 blocks of 128 an SM, not 4);
  bounds4       (K9, K1, P1) launch bounds of 4 blocks of 128 an SM, not 8
                (at most 128 registers a thread, not 64);
  bounds2       (K9, K2b, K8, K7, K1) launch bounds of 2 blocks of 128 an
                SM, not 8 or 4 (at most 255 registers a thread).

K1's launches are also timed on the device, one by one under
torch.profiler (``device_ms``: the median of K1_ITERS), since at 50x37 a
launch is shorter than the host's call.  Beside the kernels' times the
line holds, per K10 and K5 scene, the
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
#: K1's launches per timed run: one takes tens of microseconds
K1_ITERS = 200
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
K6_SCENES = K7_SCENES
K2A_SCENES = ("bunny", "optional")
K8_BOUNDS = "__launch_bounds__(kShadeBlock, 4) chunked_min_t_kernel"
K8_SLOT = "const int rid = tile * kTile + warp_slot(warp, lane);"
K7_BOUNDS = "__launch_bounds__(kBlock, 4) soft_dprim_kernel"
K6_BOUNDS = "__launch_bounds__(kBlock, 4) soft_dray_kernel"
K2A_BOUNDS = "__launch_bounds__(kClosestBlock, 4) mega2_closest_kernel"
K11A_BOUNDS = "__launch_bounds__(kClosestBlock, 4) mega3_closest_kernel"
CLOSEST_BLOCK = "constexpr int kClosestBlock = 128;"
#: K7's sums add in another order each run, and K6's other form sums its
#: lights in another order: within this share of each output's largest
#: magnitude, as chip_smoke.py phase 2 holds them
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
#: K6's other form for the variants per_ray and fold1024: a thread per ray
#: taking its lights in a loop, g_p summed in registers across them and
#: written once, one kernel and no light sum; (file, design text, variant
#: text) each
K6_PER_RAY = [
    ("soft.cu", """  const int l = blockIdx.y;
  const size_t lr = (size_t)l * R + rid;
  float gmag = 0.0f;
""", """  for (int l = 0; l < L; ++l) {
  const size_t lr = (size_t)l * R + rid;
  float gmag = 0.0f;
  v.glx = v.gly = v.glz = 0.0f;
"""),
    ("soft.cu", """    g_p[3 * lr] = v.gpx;  // this light's g_p, into the scratch (L, R, 3)
    g_p[3 * lr + 1] = v.gpy;
    g_p[3 * lr + 2] = v.gpz;
  }
}
""", """  }
  }
  if (valid) {
    g_p[3 * rid] = v.gpx;
    g_p[3 * rid + 1] = v.gpy;
    g_p[3 * rid + 2] = v.gpz;
  }
}
"""),
    ("soft.cu", """    const dim3 grid(tiles * (kTile / kBlock), L);
    soft_dray_kernel<<<grid, kBlock, smem, st>>>(p, dirs, mags, R, L, sph, S, pln, P, tri, T,
                                                 boxes, wl, cnt, wl_cols, tmin, beta, g, trans,
                                                 scratch, g_dirs, g_mags);
  }
  soft_dray_sum_kernel<<<(3 * R + 255) / 256, 256, 0, st>>>(scratch, R, L, g_p);
""", """    soft_dray_kernel<<<tiles * (kTile / kBlock), kBlock, smem, st>>>(
        p, dirs, mags, R, L, sph, S, pln, P, tri, T, boxes, wl, cnt, wl_cols, tmin, beta, g,
        trans, g_p, g_dirs, g_mags);
  }
""")]
#: variants timed only, their answers' difference printed (not exact)
INEXACT = ("soft_records",)
#: K6's variants that add its sums in another order: within K7_TOL
K6_REORDERED = ("per_ray", "fold1024")
K9_WALK = "shadow_walk<kTr, kNormalCols, kChunk / 8>"
K2B_WALK = "shadow_walk<kTri, kNormalCols>"
K9_BOUNDS = "__launch_bounds__(kShadeBlock, 8) chunked_anyhit_kernel"
K2B_BOUNDS = "__launch_bounds__(kShadeBlock, 4) mega2_shade_kernel"
RAY_BOX = ("const bool pass = live && seg_box<kNormals>(bj, boxes + kCols * (size_t)gj, o, inv, d,\n"
           "                                                  seg_end(visit, mag));")
BUNDLE = "cand = bundle_box<kNormals>(q, b, boxes + kCols * (size_t)g);"
CLOSEST_WALK = ("group_walk<kRec, kNormalCols, kExpand>(tri, T, boxes, w, c, live, o, d, INFINITY, "
                "visit);")
K1_SCENES = ("reference", "w4_test", "reference 50x37", "reference 160x120", "reference 320x240",
             "reference 1920x1080")
#: P1's cases: triangles, worklist, staged, on the draw in front of the rays
P1_CASES = tuple(f"T{T}-wl{wl}-st{st}" for T in (64, 384, 1024) for wl in (0, 1) for st in (1, 0))
K1_BOUNDS = "__launch_bounds__(kBlock, 8) mega_kernel"
P1_BOUNDS = "__launch_bounds__(kFoldBlock, 8) smem_fold_kernel"
#: K1's three closest-hit loops, which the variants unroll2 and unroll4
#: unroll by hand and unroll1 not at all (the design leaves it to nvcc)
K1_LOOPS = ("  for (int s = 0; s < S; ++s) {\n    const float* r = sph",
            "  for (int p = 0; p < P; ++p) {\n    const float* r = pln",
            "  for (int k = 0; k < T; ++k) {\n    const float* r = tri")


def k1_unroll(n: int) -> list:
    """The patches that put ``#pragma unroll n`` before K1's closest loops."""
    return [("mega.cu", loop, f"#pragma unroll {n}\n" + loop) for loop in K1_LOOPS]


K1_TILED = "  const int tiled = tile0 == 0 &&"
#: K1's order, each light's shadow query inside shade_hit's light loop
#: right before that light's shading, and the variant mask's: every
#: light's query into one bit of a mask first, then the shading (K2b's)
K1_MASK = """  unsigned occ = 0u;
  if (shadows) {
    const float ox = fmaf(nx, normal_offset, fmaf(t, rdx, rox));
    const float oy = fmaf(ny, normal_offset, fmaf(t, rdy, roy));
    const float oz = fmaf(nz, normal_offset, fmaf(t, rdz, roz));
    for (int l = 0; l < L; ++l) {
      float lx, ly, lz, mag;
      light_dir(lit + l * kLight, ox, oy, oz, &lx, &ly, &lz, &mag);
      if (occluded(sph, S, pln, P, tri, T, ox, oy, oz, lx, ly, lz, tmin, mag)) occ |= 1u << l;
    }
  }
  shade_hit(lit, L, mode, shadows != 0, normal_offset, shadow_dim, rox, roy, roz, rdx, rdy, rdz,
            t, nx, ny, nz, mat,
            [&](int l, float, float, float, float, float, float, float) {
              return ((occ >> l) & 1u) != 0u;
            },
            o);"""
K1_INTERLEAVED = """  shade_hit(lit, L, mode, shadows != 0, normal_offset, shadow_dim, rox, roy, roz, rdx, rdy, rdz,
            t, nx, ny, nz, mat,
            [&](int, float ox, float oy, float oz, float lx, float ly, float lz, float mag) {
              return occluded(sph, S, pln, P, tri, T, ox, oy, oz, lx, ly, lz, tmin, mag);
            },
            o);"""
K1_ONE_SLOT = """  const int slot = blockIdx.x * kBlock + threadIdx.x;
  if (slot < n_out)
    render_ray(sm, S, P, T, L, W, H, mode, shadows, tmin, normal_offset, shadow_dim, tiled, tile0,
               slot, out);"""
K1_GRID = "  const int blocks = (n_out + kBlock - 1) / kBlock;"
K1_STAGING = """  extern __shared__ float sm[];
  const int n = kCam + S * kSph + P * kPln + T * kTri + L * kLight;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = scene[i];
  __syncthreads();"""
K1_SMEM = ("  const size_t smem = sizeof(float) * (kCam + S * kSph + P * kPln + T * kTri + "
           "L * kLight);")
#: K1's first port: 256-thread blocks, row-major rays, no early miss
K1_FIRST_PORT = [
    ("mega.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),
    ("mega.cu", K1_BOUNDS, K1_BOUNDS.replace(", 8)", ")")),
    ("mega.cu", K1_TILED, "  const int tiled = 0 && tile0 == 0 &&"),
    ("mega.cu", "<true>", "")]
P1_LOADS = "    const float4 a = tris[3 * jj], b = tris[3 * jj + 1], c = tris[3 * jj + 2];"
#: P1's first port: a thread a ray, 1024-thread blocks, the triangle's
#: twelve floats read one by one
P1_FIRST_PORT = [
    ("probes.cu", "constexpr int kFoldRays = 4;", "constexpr int kFoldRays = 1;"),
    ("probes.cu", "constexpr int kFoldBlock = 128;", "constexpr int kFoldBlock = 1024;"),
    ("probes.cu", P1_BOUNDS, P1_BOUNDS.replace(", 8)", ")")),
    ("probes.cu", P1_LOADS, """    const float* v = reinterpret_cast<const float*>(tris) + jj * kTriFloats;
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = make_float4(v[4], v[5], v[6], v[7]);
    const float4 c = make_float4(v[8], v[9], v[10], v[11]);""")]
#: variant -> (the kernels it applies to, [(file, text in the design, text in the variant)])
VARIANTS = {
    "design": ("K4 K10 K5 K3 K11a K9 K2b K8 K7 K6 K2a K1 P1", []),
    "first_port": ("K1 P1", K1_FIRST_PORT + P1_FIRST_PORT),
    "mask": ("K1", [("mega.cu", K1_INTERLEAVED, K1_MASK)]),
    "no_early": ("K1", [("mega.cu", "<true>", "")]),
    "k1_rows": ("K1", [("mega.cu", K1_TILED, "  const int tiled = 0 && tile0 == 0 &&")]),
    "block256": ("K1 P1", [
        ("mega.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),
        ("mega.cu", K1_BOUNDS, K1_BOUNDS.replace(", 8)", ", 4)")),
        ("probes.cu", "constexpr int kFoldBlock = 128;", "constexpr int kFoldBlock = 256;"),
        ("probes.cu", P1_BOUNDS, P1_BOUNDS.replace(", 8)", ", 4)"))]),
    "block64": ("P1", [
        ("probes.cu", "constexpr int kFoldBlock = 128;", "constexpr int kFoldBlock = 64;"),
        ("probes.cu", P1_BOUNDS, P1_BOUNDS.replace(", 8)", ", 16)"))]),
    "unroll1": ("K1", k1_unroll(1)),
    "unroll2": ("K1", k1_unroll(2)),
    "unroll4": ("K1", k1_unroll(4)),
    "persistent": ("K1", [
        ("mega.cu", K1_ONE_SLOT, """  for (int b = blockIdx.x; b * kBlock < n_out; b += gridDim.x) {
    const int slot = b * kBlock + threadIdx.x;
    if (slot < n_out)
      render_ray(sm, S, P, T, L, W, H, mode, shadows, tmin, normal_offset, shadow_dim, tiled,
                 tile0, slot, out);
  }"""),
        ("mega.cu", K1_GRID, """  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = min((n_out + kBlock - 1) / kBlock, sms * 8);""")]),
    "readonly": ("K1", [("mega.cu", K1_STAGING, "  const float* sm = scene;"),
                        ("mega.cu", K1_SMEM, "  const size_t smem = 0;")]),
    "rays2": ("P1", [("probes.cu", "constexpr int kFoldRays = 4;",
                      "constexpr int kFoldRays = 2;")]),
    "rays1": ("P1", [("probes.cu", "constexpr int kFoldRays = 4;",
                      "constexpr int kFoldRays = 1;")]),
    "rays8": ("P1", [("probes.cu", "constexpr int kFoldRays = 4;", "constexpr int kFoldRays = 8;"),
                     ("probes.cu", P1_BOUNDS, P1_BOUNDS.replace(", 8)", ", 4)"))]),
    "bounds12": ("K1", [("mega.cu", K1_BOUNDS, K1_BOUNDS.replace(", 8)", ", 12)"))]),
    "no_bundle": ("K4", [("shadow.cuh", BUNDLE, "cand = true;")]),
    "no_ray_box": ("K4 K10 K5 K3 K11a K9 K2b K8 K7 K6 K2a",
                   [("shadow.cuh", RAY_BOX, "const bool pass = live;")]),
    "no_boxes": ("K4 K8 K7 K6 K2a", [("shadow.cuh", BUNDLE, "cand = true;"),
                                     ("shadow.cuh", RAY_BOX, "const bool pass = live;")]),
    "fold1024": ("K6 K2a", [
        ("shadow.cuh", BUNDLE, "cand = true;"), ("shadow.cuh", RAY_BOX, "const bool pass = live;"),
        ("soft.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 1024;"),
        *K6_PER_RAY,
        ("soft.cu", K6_BOUNDS, K6_BOUNDS.replace(", 4)", ", 1)")),
        ("soft.cu", "__launch_bounds__(kBlock, 4) soft_trans_kernel",
         "__launch_bounds__(kBlock, 1) soft_trans_kernel"),
        ("soft.cu", K7_BOUNDS, K7_BOUNDS.replace(", 4)", ", 1)")),
        ("closest.cuh", CLOSEST_BLOCK, CLOSEST_BLOCK.replace("128", "1024")),
        ("mega2.cu", K2A_BOUNDS, K2A_BOUNDS.replace(", 4)", ", 1)"))]),
    "per_ray": ("K6", K6_PER_RAY),
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
    # the same library, given K5's soft records (k7_launcher, k6_launcher)
    "soft_records": ("K7 K6", []),
    "block1024": ("K4 K10 K5 K3 K11a K9 K2b K8 K7", [
        ("packed.cu", "constexpr int kBlock = 128;", "constexpr int kBlock = 1024;"),
        ("packed.cu", "__launch_bounds__(kBlock, 4) packed_anyhit_kernel",
         "__launch_bounds__(kBlock, 1) packed_anyhit_kernel"),
        ("packed.cu", "__launch_bounds__(kBlock, 4) packed_closest_kernel",
         "__launch_bounds__(kBlock, 1) packed_closest_kernel"),
        ("mega3.cu", "constexpr int kShadeBlock = 128;", "constexpr int kShadeBlock = 1024;"),
        ("closest.cuh", CLOSEST_BLOCK, CLOSEST_BLOCK.replace("128", "1024")),
        ("mega3.cu", K11A_BOUNDS, K11A_BOUNDS.replace(", 4)", ", 1)")),
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
    "regs64": ("K10 K5 K2b K8 K7 K6 K2a", [
        ("chunked.cu", "__launch_bounds__(kShadeBlock, kWalk ? 4 : 8) chunked_shadow_shade_kernel",
         "__launch_bounds__(kShadeBlock, 8) chunked_shadow_shade_kernel"),
        ("soft.cu", "__launch_bounds__(kBlock, 4) soft_trans_kernel",
         "__launch_bounds__(kBlock, 8) soft_trans_kernel"),
        ("mega2.cu", K2B_BOUNDS, K2B_BOUNDS.replace(", 4)", ", 8)")),
        ("chunked.cu", K8_BOUNDS, K8_BOUNDS.replace(", 4)", ", 8)")),
        ("soft.cu", K7_BOUNDS, K7_BOUNDS.replace(", 4)", ", 8)")),
        ("soft.cu", K6_BOUNDS, K6_BOUNDS.replace(", 4)", ", 8)")),
        ("mega2.cu", K2A_BOUNDS, K2A_BOUNDS.replace(", 4)", ", 8)"))]),
    "bounds4": ("K9 K1 P1", [("chunked.cu", K9_BOUNDS, K9_BOUNDS.replace(", 8)", ", 4)")),
                            ("mega.cu", K1_BOUNDS, K1_BOUNDS.replace(", 8)", ", 4)")),
                            ("probes.cu", P1_BOUNDS, P1_BOUNDS.replace(", 8)", ", 4)"))]),
    "bounds2": ("K9 K2b K8 K7 K1", [("chunked.cu", K9_BOUNDS, K9_BOUNDS.replace(", 8)", ", 2)")),
                                    ("mega.cu", K1_BOUNDS, K1_BOUNDS.replace(", 8)", ", 2)")),
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
           "K7": ("soft.cu", "soft_dprim"),
           "K6": ("soft.cu", "soft_dray_kernel"),
           "K2a": ("mega2.cu", "mega2_closest"),
           "K1": ("mega.cu", "mega_kernel"),
           "P1": ("probes.cu", "smem_fold_kernelILb1ELb0E")}  # staged, in order
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
        for f in ("common.cuh", "shadow.cuh", "closest.cuh", "packed.cu", "chunked.cu", "soft.cu",
                  "mega3.cu", "mega2.cu", "mega.cu", "probes.cu"):
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
    scratch = {}  # each variant's part and done, sized by its library's blocks a tile
    n_acc = mega2.ACC_ROWS * nt * mega2.TILE

    def launch(lib, out, variant):
        b = kappa if variant == "kappa_records" else boxes
        if variant not in scratch:
            scratch[variant] = mega2.closest_scratch(lib, nt, dev)
        part, done = scratch[variant]
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
    acc, bounds = mega2.mega2_closest(buf, counts, boxes, wl, cnt, cfg)
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


def k6_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), {what: count}, the package's
    answer) for K6 on K7's inputs (``k7_launcher``), with the gradient
    records; the variant soft_records gets K5's soft records, and the count
    is of the (query, triangle) pairs with a nonzero partial of K6 that
    those records drop (``dropped_partials``).  The answer flat: g_p (R,
    3), g_dirs (L, R, 3), g_mags (L, R); ``launch.parts`` their sizes.
    Every launch gets an (L, R, 3) scratch, which the form with a thread
    per (ray, light) needs."""
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
    sph, pln, tri = blobs
    L, R = dirs.shape[:2]
    scratch = torch.empty((L * R * 3,), dtype=torch.float32, device=dev)

    def launch(lib, out, variant):
        b = soft_rec if variant == "soft_records" else boxes
        ptr = out.data_ptr()
        return lib.raytpu_soft_dray(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), sph.shape[0],
            pln.data_ptr(), pln.shape[0], tri.data_ptr(), tri.shape[0], b.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(tmin), float(beta), g.data_ptr(),
            trans.data_ptr(), ptr, ptr + 12 * R, ptr + 12 * R * (L + 1), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    launch.parts = (3 * R, 3 * L * R, L * R)
    want = torch.cat([x.flatten() for x in soft.soft_dray(p, dirs, mags, g, trans, sph, pln, tri,
                                                          wl, cnt, tmin, beta, boxes)])
    dropped = dropped_partials(p, dirs, mags, g, trans, tri, wl, cnt, soft_rec, boxes, tmin, beta)
    return torch.empty_like(want), launch, {"soft_records_drop": dropped}, want


def dropped_partials(p, dirs, mags, g, trans, tri, wl, cnt, narrow, wide, tmin, beta) -> dict:
    """The (query, triangle) pairs of the worklists whose group the records
    ``wide`` pass for the query's segment and ``narrow`` reject
    (``accel.segment_box_test``), and of those the pairs with a K6 partial
    (g_p or g_dirs, ``soft._tri_soft``'s arithmetic) other than 0.0f: what
    a walk over ``narrow`` drops that one over ``wide`` adds."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import soft

    L, R = dirs.shape[:2]
    T, ng = tri.shape[0], wide.shape[0]
    out = {"pairs": 0, "nonzero": 0}
    for li in range(L):
        inv = accel.inv_dir(dirs[li])
        for t0 in range(cnt.shape[0]):
            r0, r1 = t0 * 1024, min((t0 + 1) * 1024, R)
            c = int(cnt[t0, li])
            if c == 0:
                continue
            grp = wl[t0, li, :c].long()
            grp = grp[(grp >= 0) & (grp < ng)]
            o, iv, mg, d = p[r0:r1], inv[r0:r1], mags[li, r0:r1], dirs[li, r0:r1]
            ring = (accel.segment_box_test(o, iv, mg, wide[grp], d=d)
                    & ~accel.segment_box_test(o, iv, mg, narrow[grp], d=d))  # (rays, groups)
            ray, col = ring.nonzero(as_tuple=True)
            if ray.numel() == 0:
                continue
            k = (grp[col][:, None] * accel.GROUP + torch.arange(accel.GROUP, device=p.device))
            ray = (ray[:, None] + r0).expand_as(k)[k < T]
            k = k[k < T]
            out["pairs"] += int(k.numel())
            rows = soft._rows(tri[k], 13)
            rows = tuple(x[0] for x in rows)
            oo = tuple(p[ray, i] for i in range(3))
            dd = tuple(dirs[li, ray, i] for i in range(3))
            occ, docc, u, v, w, inv_a, h, s, q = soft._tri_soft(rows, oo, dd, tmin,
                                                                 mags[li, ray], beta)
            gob = -g[li, ray] * trans[li, ray]
            g_nu, g_nv, g_a = soft._tri_grad(u, v, w, inv_a, gob / (1.0 - occ) * docc)
            e1d = soft._cross3(rows[3], rows[4], rows[5], *dd)
            e2s = soft._cross3(rows[6], rows[7], rows[8], *s)
            e21 = soft._cross3(rows[6], rows[7], rows[8], rows[3], rows[4], rows[5])
            parts = ([g_nu * h[i] + g_nv * e1d[i] for i in range(3)]
                     + [g_nu * e2s[i] + g_nv * q[i] + g_a * e21[i] for i in range(3)])
            out["nonzero"] += int(torch.stack(parts).ne(0.0).any(dim=0).sum())
    return out


def k2a_launcher(scene, cfg, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K2a on the scene's frame 0, its inputs built as the mega2 route builds
    them: the buffer (11, nt * 1024) and the tile boxes (nt, 6), flat."""
    import torch

    from raytpu_torch.ops import accel
    from raytpu_torch.render import mega2, plain

    buf, counts = plain.mega_pack(scene, cfg)
    S, P, T, _ = counts
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)
    wl, cnt = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
    nt = wl.shape[0]
    scratch = {}  # each variant's part and done, sized by its library's blocks a tile
    n_acc = mega2.ACC_ROWS * nt * mega2.TILE

    def launch(lib, out, variant):
        if variant not in scratch:
            scratch[variant] = mega2.closest_scratch(lib, nt, dev)
        part, done = scratch[variant]
        done.zero_()  # as the wrapper's fresh zeros
        return lib.raytpu_mega2_closest(
            buf.data_ptr(), S, P, T, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[1], cfg.width, cfg.height, int(mega2.is_tiled(cfg)), 0, nt,
            float(cfg.ray_min), float(cfg.normal_offset), out.data_ptr(), part.data_ptr(),
            done.data_ptr(), out.data_ptr() + 4 * n_acc, torch.cuda.current_stream().cuda_stream)

    acc, bounds = mega2.mega2_closest(buf, counts, boxes, wl, cnt, cfg)
    want = torch.cat([acc.flatten(), bounds.flatten()])
    return torch.empty((n_acc + nt * 6,), dtype=torch.float32, device=dev), launch, None, want


def k1_launcher(scene, cfg, dev, size=None):
    """(output, launch(lib, out, variant), None, the package's answer) for
    K1 on the scene's frame 0 at 640x480 or ``size`` ("50x37"), through
    ``mega_pack``'s buffer: the (H, W, 3) image, flat.  A launch takes tens
    of microseconds, so each timed run holds K1_ITERS of them."""
    import dataclasses

    import torch

    from raytpu_torch.render import cuda_kernel as ck

    if size:
        w, h = (int(v) for v in size.split("x"))
        cfg = dataclasses.replace(cfg, width=w, height=h)
    buf, counts = ck.mega_pack(scene, cfg)
    S, P, T, L = counts
    W, H = cfg.width, cfg.height

    def launch(lib, out, variant):
        return lib.raytpu_mega_render(
            buf.data_ptr(), S, P, T, L, W, H, int(cfg.lighting_mode), int(bool(cfg.shadows)),
            float(cfg.ray_min), float(cfg.normal_offset), float(cfg.shadow_dim), 0, W * H,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    launch.iters = K1_ITERS
    want = ck.render_image_mega_f32(scene, cfg).flatten()
    return torch.empty((W * H * 3,), dtype=torch.float32, device=dev), launch, None, want


def p1_launcher(case, dev):
    """(output, launch(lib, out, variant), None, the package's answer) for
    P1 in ``case`` (P1_CASES) over 300 tiles of the draw in front of the
    rays, whose rays hit: the (2400, 128) output, flat."""
    import torch

    from raytpu_torch.probes import probe_smem as ps

    T, worklist, staged = (int(part.lstrip("Twlst")) for part in case.split("-"))
    tri = torch.from_numpy(ps.make_triangles(T, 0, front=True)).to(dev)
    wl = torch.from_numpy(ps.make_worklist(T, 0)).to(dev)

    def launch(lib, out, variant):
        return lib.raytpu_probe_smem_fold(tri.data_ptr(), wl.data_ptr(), T, 300, worklist, staged,
                                          out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    want = ps.smem_fold(tri, wl, 300, bool(worklist), bool(staged)).flatten()
    return torch.empty((300 * ps.TILE,), dtype=torch.float32, device=dev), launch, None, want


def k1_device_ms(run, iters: int) -> float:
    """The median device time of ``iters`` launches of K1 by ``run()``,
    from torch.profiler's kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and "mega_kernel" in e.name)
    return us[len(us) // 2] / 1e3


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
    if "K6" in kernels:
        lib.raytpu_soft_dray.argtypes = ([c_ptr, c_ptr, c_ptr, c_int, c_int] + sp_tri
                                         + [c_ptr, c_ptr, c_ptr, c_int, c_float, c_float]
                                         + [c_ptr] * 7)
    if "K11a" in kernels or "K2a" in kernels:
        lib.raytpu_closest_blocks_per_tile.argtypes = []
        lib.raytpu_closest_blocks_per_tile.restype = c_int
    if "K2a" in kernels:
        lib.raytpu_mega2_closest.argtypes = ([c_ptr, c_int, c_int, c_int, c_ptr, c_ptr, c_ptr]
                                             + [c_int] * 6 + [c_float, c_float] + [c_ptr] * 5)
    if "K1" in kernels:
        lib.raytpu_mega_render.argtypes = ([c_ptr] + [c_int] * 8 + [c_float] * 3 + [c_int] * 2
                                           + [c_ptr] * 2)
    if "P1" in kernels:
        lib.raytpu_probe_smem_fold.argtypes = [c_ptr, c_ptr] + [c_int] * 4 + [c_ptr, c_ptr]
    return lib


def _same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _k6_differ(a, b, parts) -> float:
    """The largest of K6's three outputs' max |a - b| over the largest |b|
    (0.0 where equal bit for bit), ``parts`` their sizes in the flat
    answers."""
    if _same_bits(a, b):
        return 0.0
    worst, i = 0.0, 0
    for n in parts:
        x, y = a[i:i + n], b[i:i + n]
        worst = max(worst, float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
        i += n
    return max(worst, 1e-38)  # not bit for bit


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
           "device_ms": {}, "records": {}, "k6_dropped": {}}
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
                             ("K8", K8_SCENES, k8_launcher), ("K7", K7_SCENES, k7_launcher),
                             ("K6", K6_SCENES, k6_launcher), ("K2a", K2A_SCENES, k2a_launcher),
                             ("K1", K1_SCENES, k1_launcher), ("P1", P1_CASES, p1_launcher)):
        if key not in keys:
            continue
        variants = [n for n, (kernels, _) in VARIANTS.items() if key in kernels.split()]
        for scene_name in names:
            name, *order = scene_name.split()  # "rows": K9 on row-major queries
            template, launch, glue, want = (make(scene_name, dev) if key == "P1"
                                            else make(scene(name), cfg, dev, *order))
            iters = getattr(launch, "iters", ITERS)
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
                ms[name] = sorted(device_ms(run, iters=iters, warmup=1) for _ in range(REPEATS))
                if key == "K1":  # shorter than the host's call at 50x37: the device's own time
                    out["device_ms"].setdefault(f"{key} {scene_name}", {})[name] = k1_device_ms(
                        run, iters)
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
            elif key == "K6":  # bit for bit but where the lights add in another order
                diffs = {n: _k6_differ(a, answers["design"], launch.parts)
                         for n, a in answers.items()}
                out["k6_diff_to_design"] = out.get("k6_diff_to_design", {})
                out["k6_diff_to_design"][scene_name] = diffs
                bad = {n: v for n, v in diffs.items() if n not in INEXACT
                       and v > (K7_TOL if n in K6_REORDERED else 0.0)}
                if not _same_bits(answers["design"], want) or bad:
                    raise AssertionError(f"K6 {scene_name}: {bad} differ from the design's "
                                         f"answer, or the design from the package's")
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
                out["records" if key != "K6" else "k6_dropped"][f"{key} {scene_name}"] = glue
    out["answers_equal_to_design"] = True
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
