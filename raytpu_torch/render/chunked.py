"""The chunked route, for scenes past the other routes' caps (more than 16
spheres or planes, or more than 8 lights) with at most 32,768 triangles:
K8 and K10, and K9 for any ray batch.

Counterpart of the chunked part of ``raytpu/render/pallas_kernel.py``:
``scene_min_t``, ``closest_hit_pallas``, ``any_hit_pallas``,
``any_hit_lights_pallas``, ``shadow_shade_pallas``, ``shade_rays`` and the
chunked branch of ``render_image_f32``.  The kernels are
``csrc/chunked.cu``:

  * K8 (``chunked_min_t``): the minimum t of arbitrary rays over every
    sphere and plane and the 128-triangle chunks of each 1024-ray tile's
    worklist, with the winner's index, normal and material (closest mode,
    the closest walk), or the first occluder's t (shadow mode, triangle
    culling inverted, the first-occluder walk);
  * K9 (``any_hit_lights``): every light's occlusion for the shadow rays,
    culled per (tile, light), at most 24 lights as in raytpu;
  * K10 (``shadow_shade``): after K8, every light's shadow query, the
    shading, the dim per occluded light and MaxToOne, in one launch.

The three kernels walk the 8-triangle groups of their chunks with
``csrc/shadow.cuh``'s box tests and the normal records of
``accel.normal_boxes``, built once a frame (``frame_records``) for K8's
worklists, K8 and K10 (or K8 and K9 in ``shade_rays``); a scene of at most
FEW_GROUPS groups takes none, and its kernels fold every listed triangle.

The worklists come from ``ops/accel.py`` through ``packed``'s worklist
helpers, with raytpu's 128-triangle chunks; a scene under 256 triangles
(``CULL_MIN_TRIS``) walks every chunk.  Camera rays go in 32x32 pixel
blocks when W and H are multiples of 32 (``packed.mega2_fold``).  Each
wrapper takes its plain version (``plain.py``) only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.ops import accel
from raytpu_torch.render import build, packed, plain, renderer

TILE = packed.TILE
CHUNK = 128  #: triangles per worklist chunk (raytpu's CT), culled from two on
MAX_LIGHTS = 24  #: raytpu's bitmask cap (pallas_kernel.py:395, 566)
MAX_TRIS = 32768  #: the route's triangle cap (pallas_kernel.py:MAX_VMEM_TRIS)
#: K8, K9 and K10 on a scene of at most this many 8-triangle groups
#: (reference_s106: one) take no box records: their kernels then test every
#: listed triangle, without the walk's box tests, which cost more there
#: than they skip (csrc/chunked.cu; shadow_ablation.py's no_direct).  With
#: the records, reference_s106 takes 1.11x K9's time (both kernels at 8
#: blocks of 128 an SM) and 1.29x K10's (whose kernel without records also
#: runs at twice the walk's occupancy); the walks are faster at hundreds of
#: groups (optional_l12, bunny18k_l12).  Where between them they start to
#: pay is not measured, so 8 is a guess inside that range.
FEW_GROUPS = 8

#: Launches of K8, K9 and K10, counted where the wrappers launch them.
CHUNKED_MIN_T_LAUNCHES = 0
CHUNKED_ANYHIT_LAUNCHES = 0
CHUNKED_SHADE_LAUNCHES = 0


def _check_lights(L: int, what: str) -> None:
    if L > MAX_LIGHTS:
        raise ValueError(f"{what} takes at most {MAX_LIGHTS} lights (got {L}), as raytpu's does")


def frame_records(scene: Scene):
    """The frame's ``accel.normal_boxes(scene.triangles)``, ``(glo, ghi,
    boxes)``, which serve K8's and the shadow queries' worklists and the
    walks of K8, K9 and K10; None for a scene of at most FEW_GROUPS groups,
    whose kernels fold every listed triangle."""
    if -(-scene.triangles.count // accel.GROUP) <= FEW_GROUPS:
        return None
    return accel.normal_boxes(scene.triangles)


def _bounds_and_boxes(scene: Scene, records):
    """``(group_bounds, boxes)`` for the worklist helpers and the kernels
    from ``records`` (``frame_records``, computed here when not given)."""
    records = frame_records(scene) if records is None else records
    return (None, None) if records is None else (records[:2], records[2])


def scene_min_t(scene: Scene, ro, rd, tmin, tmax=None, shadow: bool = False, records=None):
    """K8 over rays ``ro`` (broadcast against ``rd`` (R,3)) up to ``tmax``
    ((R,), or None for no bound): ``(t, idx, normal, material)`` as
    ``chunked_min_t`` returns them (pallas_kernel.py:scene_min_t).
    ``records``: the frame's ``frame_records`` where the caller has them."""
    ro, rd = ro.expand_as(rd).contiguous(), rd.contiguous()
    tmax = None if tmax is None else tmax.contiguous()
    bounds, boxes = _bounds_and_boxes(scene, records)
    wl, cnt = packed.closest_worklists(scene, ro, rd, tmin,
                                       float("inf") if tmax is None else tmax, group=CHUNK,
                                       group_bounds=bounds)
    return chunked_min_t(ro, rd, tmax, *packed.soft_packs(scene), wl, cnt, float(tmin), shadow,
                         boxes)


def chunked_min_t(ro, rd, tmax, sph, pln, tri, wl, cnt, tmin, shadow: bool, boxes=None):
    """K8 over rays ``ro``, ``rd`` (R,3), ``tmax`` (R,) or None, and the
    records of ``packed.soft_packs``, walking each 1024-ray tile's chunk
    worklist ``wl`` (nt, n) int32 up to ``cnt`` (nt,) int32, with the
    normal records ``boxes`` (ceil(T/8), 32) of ``accel.normal_boxes``, or
    None to test every listed triangle (``frame_records`` chooses).
    Closest mode: ``(t, idx int32, normal, material int32)``; shadow mode:
    ``(t, None, None, None)`` (``plain.chunked_min_t_plain`` says what each
    holds).  CPU tensors take that plain version, which needs no boxes."""
    global CHUNKED_MIN_T_LAUNCHES
    if not shadow and tmax is not None:
        raise ValueError("K8's closest mode is unbounded: tmax must be None")
    if rd.device.type == "cpu":
        return plain.chunked_min_t_plain(ro, rd, tmax, sph, pln, tri, tmin, shadow)
    R, S, P, T = rd.shape[0], sph.shape[0], pln.shape[0], tri.shape[0]
    nt = -(-R // TILE)
    tensors = {"ro": (ro, torch.float32, (R, 3)), "rd": (rd, torch.float32, (R, 3)),
               "spheres": (sph, torch.float32, (S, packed.SP_COLS)),
               "planes": (pln, torch.float32, (P, packed.SP_COLS)),
               "triangles": (tri, torch.float32, (T, packed.TRI_COLS)),
               "wl": (wl, torch.int32, (nt, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt,))}
    if tmax is not None:
        tensors["tmax"] = (tmax, torch.float32, (R,))
    if boxes is not None:
        tensors["boxes"] = (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))
    build.check_tensors("K8", rd.device, tensors)
    if boxes is not None:
        build.check_aligned("K8", "boxes", boxes, 16)
    dev = rd.device
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = normal = mat = None
    if not shadow:
        idx = torch.empty((R,), dtype=torch.int32, device=dev)
        normal = torch.empty((R, 3), dtype=torch.float32, device=dev)
        mat = torch.empty((R,), dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.raytpu_chunked_min_t(
            ro.data_ptr(), rd.data_ptr(), None if tmax is None else tmax.data_ptr(), R,
            sph.data_ptr(), S, pln.data_ptr(), P, tri.data_ptr(), T,
            None if boxes is None else boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[-1], float(tmin), int(shadow), t.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (idx, normal, mat)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K8 launch failed: {build.cuda_error_name(lib, err)}")
    CHUNKED_MIN_T_LAUNCHES += 1
    return t, idx, normal, mat


def closest_hit_chunked(scene: Scene, ro, rd, tmin, records=None):
    """HitRecords from K8's closest mode (pallas_kernel.py:closest_hit_pallas):
    sphere normals normalized here, the point ``fma(t, rd, ro)``, a miss at
    t = inf with the point at ``ro``.  ``records``: as ``scene_min_t``."""
    ro_b = ro.expand_as(rd)
    t, idx, normal, mat = scene_min_t(scene, ro_b, rd, tmin, records=records)
    is_sphere = idx < scene.spheres.count  # a miss has idx 2^30
    normal = torch.where(is_sphere[:, None], math3d.normalize_safe(normal), normal)
    return packed.hit_records_from_payload(ro_b, rd, t, normal, mat)


def any_hit_chunked(scene: Scene, ro, rd, tmin, tmax, records=None):
    """(R,) bool: K8's shadow mode along ``rd`` up to ``tmax`` (R,)
    (pallas_kernel.py:any_hit_pallas).  ``records``: as ``scene_min_t``."""
    t, *_ = scene_min_t(scene, ro, rd, tmin, tmax.expand(rd.shape[0]), shadow=True,
                        records=records)
    return torch.isfinite(t)


def any_hit_lights_chunked(scene: Scene, p, dirs, mags, tmin, records=None):
    """(L, R) bool occlusion for every light (pallas_kernel.py:
    any_hit_lights_pallas): shadow origins ``p`` (R,3), directions ``dirs``
    (L,R,3), segment lengths ``mags`` (L,R), at most 24 lights.  The records
    and the worklists come from ``shadow_inputs``, as K10's."""
    _check_lights(dirs.shape[0], "K9")
    p, dirs, mags = p.contiguous(), dirs.contiguous(), mags.contiguous()
    boxes, wl, cnt = shadow_inputs(scene, p, dirs, mags, tmin, records)
    return any_hit_lights(p, dirs, mags, *packed.soft_packs(scene), boxes, wl, cnt, float(tmin))


def any_hit_lights(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, tmin):
    """K9 over shadow rays and the records of ``packed.soft_packs``, walking
    each (tile, light) chunk worklist ``wl`` (nt, L, n) int32 up to ``cnt``
    (nt, L) int32 -> (L, R) bool, with the normal records ``boxes``
    (ceil(T/8), 32) of ``accel.normal_boxes``, or None to test every listed
    triangle (``shadow_inputs`` chooses).  CPU tensors take K4's plain
    version, ``packed.any_hit_lights_plain``: the two kernels compute one
    function over groups of different sizes."""
    global CHUNKED_ANYHIT_LAUNCHES
    L, R, S, P, T = dirs.shape[0], p.shape[0], sph.shape[0], pln.shape[0], tri.shape[0]
    _check_lights(L, "K9")
    if p.device.type == "cpu":
        return packed.any_hit_lights_plain(p, dirs, mags, sph, pln, tri, tmin)
    nt = -(-R // TILE)
    build.check_tensors("K9", p.device, {
        "p": (p, torch.float32, (R, 3)), "dirs": (dirs, torch.float32, (L, R, 3)),
        "mags": (mags, torch.float32, (L, R)),
        "spheres": (sph, torch.float32, (S, packed.SP_COLS)),
        "planes": (pln, torch.float32, (P, packed.SP_COLS)),
        "triangles": (tri, torch.float32, (T, packed.TRI_COLS)),
        "wl": (wl, torch.int32, (nt, L, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt, L))})
    if boxes is not None:
        build.check_tensors("K9", p.device, {
            "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))})
        build.check_aligned("K9", "boxes", boxes, 16)
    occ = torch.empty((L, R), dtype=torch.bool, device=p.device)  # one byte, 0 or 1
    lib = build.load()
    with torch.cuda.device(p.device):
        err = lib.raytpu_chunked_anyhit_lights(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), S,
            pln.data_ptr(), P, tri.data_ptr(), T, None if boxes is None else boxes.data_ptr(),
            wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(tmin), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K9 launch failed: {build.cuda_error_name(lib, err)}")
    CHUNKED_ANYHIT_LAUNCHES += 1
    return occ


def shadow_shade_chunked(scene: Scene, rec, rd, config: RenderConfig, records=None):
    """(R,3) tone-mapped colors of the hit records ``rec`` of rays ``rd``
    through K10 (pallas_kernel.py:shadow_shade_pallas): a scene without
    lights is black, with more than 24 it raises.  ``records``: the
    frame's ``frame_records`` where the caller has them."""
    L = scene.lights.count
    if L == 0:
        return torch.zeros((rd.shape[0], 3), dtype=torch.float32, device=rd.device)
    _check_lights(L, "K10")
    p_off, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, config))
    if config.shadows:
        boxes, wl, cnt = shadow_inputs(scene, p_off, dirs, mags, config.ray_min, records)
    else:  # no shadow query: K10 reads no worklist and no box
        nt = -(-rd.shape[0] // TILE)
        boxes = None
        wl = torch.zeros((nt, L, 0), dtype=torch.int32, device=rd.device)
        cnt = torch.zeros((nt, L), dtype=torch.int32, device=rd.device)
    return shadow_shade(rec.hit, rec.normal.contiguous(), rec.point.contiguous(),
                        rec.material.contiguous(), rd.contiguous(), p_off, dirs, mags,
                        plain.pack_lights(scene.lights).contiguous(),
                        plain.material_table(scene.materials).contiguous(),
                        *packed.soft_packs(scene), boxes, wl, cnt, config)


def shadow_inputs(scene: Scene, p_off, dirs, mags, tmin, records=None):
    """K9's and K10's shadow inputs for the queries ``p_off``, ``dirs``,
    ``mags``: ``(boxes, wl, cnt)``, the normal records of
    ``accel.normal_boxes`` (None for a scene of at most FEW_GROUPS groups)
    and each (tile, light) worklist of 128-triangle chunks, from one set of
    group bounds: ``records`` (``frame_records``), computed here when not
    given."""
    bounds, boxes = _bounds_and_boxes(scene, records)
    return (boxes, *packed.shadow_worklists(scene, p_off, dirs, mags, tmin, group=CHUNK,
                                            group_bounds=bounds))


def shadow_shade(hit, normal, point, mat, rd, p_off, dirs, mags, lights, mats, sph, pln, tri,
                 boxes, wl, cnt, config: RenderConfig):
    """K10 over hit records (``hit`` (R,) bool, ``normal``, ``point`` (R,3),
    ``mat`` (R,) int32) of rays ``rd``, their shadow queries ``p_off``,
    ``dirs``, ``mags``, the tables ``lights`` (L,8) and ``mats`` (M,7), the
    records of ``packed.soft_packs``, the normal records ``boxes``
    (ceil(T/8), 32) of ``accel.normal_boxes``, or None to test every listed
    triangle (``shadow_inputs`` chooses), and each (tile, light) worklist of
    128-triangle chunks -> (R,3) colors.  CPU tensors take
    ``plain.shadow_shade_plain``, which needs no boxes."""
    global CHUNKED_SHADE_LAUNCHES
    L, R, M = lights.shape[0], rd.shape[0], mats.shape[0]
    S, P, T = sph.shape[0], pln.shape[0], tri.shape[0]
    _check_lights(L, "K10")
    if rd.device.type == "cpu":
        return plain.shadow_shade_plain(hit, normal, point, mat, rd, p_off, dirs, mags, lights,
                                        mats, sph, pln, tri, config)
    if config.soft_shadows:
        raise ValueError("K10 renders hard shadows only")
    nt = -(-R // TILE)
    build.check_tensors("K10", rd.device, {
        "hit": (hit, torch.bool, (R,)), "normal": (normal, torch.float32, (R, 3)),
        "point": (point, torch.float32, (R, 3)), "mat": (mat, torch.int32, (R,)),
        "rd": (rd, torch.float32, (R, 3)), "p_off": (p_off, torch.float32, (R, 3)),
        "dirs": (dirs, torch.float32, (L, R, 3)), "mags": (mags, torch.float32, (L, R)),
        "lights": (lights, torch.float32, (L, plain.LIGHT_COLS)),
        "mats": (mats, torch.float32, (M, 7)),
        "spheres": (sph, torch.float32, (S, packed.SP_COLS)),
        "planes": (pln, torch.float32, (P, packed.SP_COLS)),
        "triangles": (tri, torch.float32, (T, packed.TRI_COLS)),
        "wl": (wl, torch.int32, (nt, L, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt, L))})
    if boxes is not None:
        build.check_tensors("K10", rd.device, {
            "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS))})
        build.check_aligned("K10", "boxes", boxes, 16)
    if M == 0:
        raise ValueError("K10 needs a material table")
    out = torch.empty((R, 3), dtype=torch.float32, device=rd.device)
    lib = build.load()
    with torch.cuda.device(rd.device):
        err = lib.raytpu_chunked_shadow_shade(
            hit.data_ptr(), normal.data_ptr(), point.data_ptr(), mat.data_ptr(), rd.data_ptr(),
            p_off.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, lights.data_ptr(),
            mats.data_ptr(), M, sph.data_ptr(), S, pln.data_ptr(), P, tri.data_ptr(), T,
            None if boxes is None else boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[-1], float(config.ray_min),
            int(config.lighting_mode), int(bool(config.shadows)), float(config.shadow_dim),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: {build.cuda_error_name(lib, err)}")
    CHUNKED_SHADE_LAUNCHES += 1
    return out


def shade_rays(scene: Scene, ro, rd, config: RenderConfig):
    """Closest hit, shadows, shading and tone map of any ray batch through
    K8 and K9 (pallas_kernel.py:shade_rays): the eager shade tail with K9
    answering every light's shadow query, both on one ``frame_records``."""
    records = frame_records(scene)

    def closest_fn(s, ro_b, rd_b, tmin):
        return closest_hit_chunked(s, ro_b, rd_b, tmin, records)

    def any_fn(s, p, d, tmin, mag):
        return any_hit_chunked(s, p, d, tmin, mag, records)

    def any_multi_fn(s, p, dirs, mags, tmin):
        return any_hit_lights_chunked(s, p, dirs, mags, tmin, records)

    return renderer.shade_rays(scene, ro, rd, config, closest_fn=closest_fn, any_fn=any_fn,
                               any_multi_fn=any_multi_fn)


def render_image_chunked_f32(scene: Scene, config: RenderConfig):
    """Chunked render -> (H, W, 3) float32: K8 over the camera rays, then
    K10 (the chunked branch of pallas_kernel.py:render_image_f32)."""
    if config.soft_shadows:
        raise ValueError("the chunked route renders hard shadows only")
    _check_lights(scene.lights.count, "the chunked route")
    W, H = config.width, config.height
    ro, rd = renderer.generate_rays(scene.camera, config)
    tiled = W % 32 == 0 and H % 32 == 0
    if tiled:
        rd = packed.mega2_fold(rd, H, W)  # 32x32 pixel tiles: tight per-tile cones
    records = frame_records(scene)  # K8's worklists, K8 and K10
    rec = closest_hit_chunked(scene, ro, rd, config.ray_min, records)
    colors = shadow_shade_chunked(scene, rec, rd, config, records)
    if tiled:
        colors = packed.mega2_unfold_rows(colors, H, W)
    return colors.reshape(H, W, 3)
