"""The packed route for 9,600 to 1,048,576 triangles: K3 and K4 around the
eager shade tail.

Counterpart of ``raytpu/render/pallas_kernel.py:render_image_packed_f32``
and of the parts of ``raytpu/render/pallas_soft.py`` it runs:
``_soft_packs``, ``scene_min_t_mega2(payload=True)``,
``hit_records_from_payload`` and ``any_hit_lights_mega2``.  The kernels are
``csrc/packed.cu``:

  * K3 (``winner_search``): the closest hit of arbitrary rays, culled by
    per-tile worklists and, ray by ray, by the normal records
    (``accel.normal_boxes``) widened for the ray up to its current closest
    hit -> t, the
    winner's global index, its unit normal and material id;
  * K4 (``any_hit_lights``): every light's occlusion for the shadow rays,
    culled by per-(tile, light) worklists and, ray by ray, by the padded
    group boxes widened for the ray (``accel.shadow_boxes``), triangle
    culling inverted.

Camera rays go in 32x32 pixel blocks when W and H are multiples of 32
(``mega2_fold``), so that a tile's directions form a tight cone.  The shade
tail is ``renderer.shade_from_records``, the eager path's, so the route
renders what the eager path renders wherever K3's winners are the eager
argmin's.  Each wrapper takes its plain version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import LightKind, RenderConfig, Scene
from raytpu_torch.ops import accel, intersect
from raytpu_torch.render import build, plain, renderer

TILE = 1024
SP_COLS = 5  #: sphere / plane record: 4 geometry columns + material id
TRI_COLS = 14  #: triangle record: 13 geometry columns + material id

#: Launches of K3 and of K4, counted where the wrappers launch them.
PACKED_CLOSEST_LAUNCHES = 0
PACKED_ANYHIT_LAUNCHES = 0


def soft_packs(scene: Scene):
    """The kernels' records: spheres (S, 5), planes (P, 5), triangles
    (T, 14), each with a trailing material id (pallas_soft.py:_soft_packs)."""
    sph, pln, tr = scene.spheres, scene.planes, scene.triangles
    sph_blob = torch.cat([sph.center, (sph.radius * sph.radius)[:, None],
                          sph.material.to(torch.float32)[:, None]], dim=1)
    pl_blob = torch.cat([pln.normal, math3d.dot(pln.origin, pln.normal)[:, None],
                         pln.material.to(torch.float32)[:, None]], dim=1)
    tri_blob = torch.cat([tr.v0, tr.v1 - tr.v0, tr.v2 - tr.v0, tr.normal,
                          tr.cull.to(torch.float32)[:, None],
                          tr.material.to(torch.float32)[:, None]], dim=1)
    return sph_blob.contiguous(), pl_blob.contiguous(), tri_blob.contiguous()


def mega2_fold(x, h: int, w: int):
    """Row-major (H*W, C) -> 32x32 pixel blocks in row-major block order,
    each block row-major: tile i of 1024 rays is block i."""
    c = x.shape[-1]
    return x.reshape(h // 32, 32, w // 32, 32, c).permute(0, 2, 1, 3, 4).reshape(-1, c)


def mega2_unfold_rows(x, h: int, w: int):
    """Inverse of ``mega2_fold``."""
    c = x.shape[-1]
    return x.reshape(h // 32, w // 32, 32, 32, c).permute(0, 2, 1, 3, 4).reshape(h * w, c)


def shadow_records(boxes):
    """K4's and K11b's 8-float box records (``accel.shadow_boxes``) from
    the normal records (``accel.normal_boxes``) of K3 and K11a: their
    first columns."""
    return boxes[:, :accel.BOX_COLS].contiguous()


def closest_worklists(scene: Scene, ro, rd, tmin, tmax=float("inf"), group=accel.GROUP,
                      group_bounds=None):
    """K3's worklists ``(wl (nt, ng) int32, cnt (nt,) int32)`` for rays
    ``ro``, ``rd`` (R,3) up to ``tmax`` (a number or (R,)): each 1024-ray
    tile's groups of ``group`` triangles that its rays may hit, in
    ascending order.  K8 takes 128-triangle chunks.  ``group_bounds`` is
    the 8-triangle groups' ``(glo, ghi)`` where the caller has them."""
    nt = -(-rd.shape[0] // TILE)
    if not accel.culls_groups(scene.triangles, group):
        return accel.full_worklist(nt, scene.triangles, group)
    if group_bounds is None:
        glo, ghi = accel.chunk_bounds(scene.triangles, group)
    else:
        glo, ghi = accel.merge_bounds(*group_bounds, group // accel.GROUP)
    rb = accel.ray_tile_bounds(ro, rd, tmax, tile=TILE)
    return accel.chunk_worklist(accel.cull_matrix(rb, glo, ghi, float(tmin)))


def shadow_worklists(scene: Scene, p, dirs, mags, tmin, soft_beta=None, group=accel.GROUP,
                     group_bounds=None):
    """The shadow rays' worklists ``(wl (nt, L, ng) int32, cnt (nt, L)
    int32)``: each light's groups of ``group`` triangles that a shadow ray
    of the tile may hit, from the shadow rays themselves
    (``accel.shadow_cull_matrix``).  K4 passes no ``soft_beta``; the soft
    kernels K5-K7 pass theirs, which widens every group's box by
    ``accel.chunk_soft_slack`` (pallas_soft.py:_padded_group_bounds).  K9
    and K10 take 128-triangle chunks.  ``group_bounds`` is the 8-triangle
    groups' ``accel.chunk_bounds(scene.triangles)`` where the caller has
    it; the bounds of larger groups are merged from it
    (``accel.merge_bounds``), not taken in a second pass over the
    triangles."""
    L, nt = dirs.shape[0], -(-p.shape[0] // TILE)
    if not accel.culls_groups(scene.triangles, group):
        wl, cnt = accel.full_worklist(nt * L, scene.triangles, group)
        return wl.reshape(nt, L, -1), cnt.reshape(nt, L)
    if group_bounds is None:
        glo, ghi = accel.chunk_bounds(scene.triangles, group)
    else:
        glo, ghi = accel.merge_bounds(*group_bounds, group // accel.GROUP)
    if soft_beta is not None:
        slack = accel.chunk_soft_slack(scene.triangles, float(soft_beta), group)[:, None]
        glo, ghi = glo - slack, ghi + slack
    lights = scene.lights
    per_light = [accel.chunk_worklist(accel.shadow_cull_matrix(
        p, dirs[li], mags[li], lights.position[li], lights.kind[li] == LightKind.POINT,
        glo, ghi, float(tmin), tile=TILE)) for li in range(L)]
    return (torch.stack([w for w, _ in per_light], dim=1).contiguous(),
            torch.stack([c for _, c in per_light], dim=1).contiguous())


def scene_min_t_mega2(scene: Scene, ro, rd, tmin, records=None):
    """Closest-hit winner search for arbitrary rays with its payload:
    ``(t (R,), idx (R,) i32, normal (R,3), material (R,) i32)``, t = inf
    and zeros on a miss, idx over spheres -> planes -> triangles
    (reference: source/Scene.cpp:29-66).  ``ro`` broadcasts against ``rd``
    (R,3).  A tie goes to the first primitive.  ``records`` is
    ``accel.normal_boxes(scene.triangles)`` where the caller has it."""
    ro_b, rd = ro.expand_as(rd).contiguous(), rd.contiguous()
    glo, ghi, boxes = accel.normal_boxes(scene.triangles) if records is None else records
    wl, cnt = closest_worklists(scene, ro_b, rd, tmin, group_bounds=(glo, ghi))
    return winner_search(ro_b, rd, *soft_packs(scene), boxes, wl, cnt, float(tmin))


def winner_search(ro, rd, sph, pln, tri, boxes, wl, cnt, tmin):
    """K3 over rays ``ro``, ``rd`` (R,3) and the records of ``soft_packs``,
    walking each 1024-ray tile's worklist ``wl`` (nt, n) int32 up to ``cnt``
    (nt,) int32 and testing each ray's segment up to its current closest
    hit against ``boxes`` (ceil(T/8), NORMAL_COLS) float32, the normal
    records (``accel.normal_boxes``), before a group's triangles -> ``(t, idx, normal,
    material)`` as ``scene_min_t_mega2`` returns them.  CPU tensors take
    ``winner_search_plain``, which needs no boxes."""
    global PACKED_CLOSEST_LAUNCHES
    if rd.device.type == "cpu":
        return winner_search_plain(ro, rd, sph, pln, tri, tmin)
    R, S, P, T = rd.shape[0], sph.shape[0], pln.shape[0], tri.shape[0]
    nt = -(-R // TILE)
    build.check_tensors("K3", rd.device, {
        "ro": (ro, torch.float32, (R, 3)), "rd": (rd, torch.float32, (R, 3)),
        "spheres": (sph, torch.float32, (S, SP_COLS)), "planes": (pln, torch.float32, (P, SP_COLS)),
        "triangles": (tri, torch.float32, (T, TRI_COLS)),
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.NORMAL_COLS)),
        "wl": (wl, torch.int32, (nt, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt,))})
    build.check_aligned("K3", "boxes", boxes, 16)
    dev = rd.device
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    idx = torch.empty((R,), dtype=torch.int32, device=dev)
    normal = torch.empty((R, 3), dtype=torch.float32, device=dev)
    mat = torch.empty((R,), dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.raytpu_packed_closest(
            ro.data_ptr(), rd.data_ptr(), R, sph.data_ptr(), S, pln.data_ptr(), P, tri.data_ptr(),
            T, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(), wl.shape[-1], float(tmin),
            t.data_ptr(),
            idx.data_ptr(), normal.data_ptr(), mat.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: {build.cuda_error_name(lib, err)}")
    PACKED_CLOSEST_LAUNCHES += 1
    return t, idx, normal, mat


def winner_search_plain(ro, rd, sph, pln, tri, tmin):
    """What K3 computes, over every primitive (``plain``'s docstring says
    how it rounds)."""
    t, idx = plain.closest_plain(sph, pln, tri, ro.unbind(1), rd.unbind(1), float(tmin))
    return winner_payload(ro, rd, sph, pln, tri, t, idx)


def winner_payload(ro, rd, sph, pln, tri, t, idx):
    """``(t, idx, normal, material)`` of the winners ``t``, ``idx`` (R,) of
    a winner search over the records of ``soft_packs``, the payload formed
    as ``intersect.assemble_hit_records`` forms it (K3's, after its walk)."""
    ro3, rd3 = ro.unbind(1), rd.unbind(1)
    hit = t < plain.INF
    pay = torch.cat([sph[:, [0, 1, 2, 4]], pln[:, [0, 1, 2, 4]], tri[:, [9, 10, 11, 13]]])
    if pay.shape[0] == 0:
        return t, idx.to(torch.int32), torch.zeros_like(rd), torch.zeros_like(idx, dtype=torch.int32)
    g = torch.where(hit[:, None], pay[idx], 0.0)
    ts = torch.where(hit, t, 0.0)
    c = [math3d.fma(ts, rd3[i], ro3[i]) - g[:, i] for i in range(3)]
    n_len = torch.sqrt(torch.clamp(math3d.dot3(*c, *c), min=1e-20))
    is_sph = hit & (idx < sph.shape[0])
    normal = torch.stack([torch.where(is_sph, c[i] / n_len, g[:, i]) for i in range(3)], dim=1)
    return t, idx.to(torch.int32), normal, g[:, 3].to(torch.int32)


def hit_records_from_payload(ro_b, rd, t, normal, mat):
    """HitRecords from the winner search's payload, formed as
    ``intersect.assemble_hit_records`` forms them."""
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 0.0)
    return intersect.HitRecords(hit=hit, t=torch.where(hit, t, plain.INF),
                                point=math3d.fma(rd, t_safe[:, None], ro_b), normal=normal,
                                material=mat)


def any_hit_lights_mega2(scene: Scene, p, dirs, mags, tmin, records=None):
    """(L, R) bool occlusion for every light: shadow origins ``p`` (R,3),
    directions ``dirs`` (L,R,3), segment lengths ``mags`` (L,R); shadow rays
    invert triangle culling (reference: source/Utils.h:114-127).  The group
    bounds and normal records (``records``, ``accel.normal_boxes`` of the
    scene's triangles where the caller has them) serve the worklists and
    K4's per-ray test (the records' first columns)."""
    p, dirs, mags = p.contiguous(), dirs.contiguous(), mags.contiguous()
    glo, ghi, boxes = accel.normal_boxes(scene.triangles) if records is None else records
    wl, cnt = shadow_worklists(scene, p, dirs, mags, tmin, group_bounds=(glo, ghi))
    return any_hit_lights(p, dirs, mags, *soft_packs(scene), shadow_records(boxes), wl, cnt,
                          float(tmin))


def any_hit_lights(p, dirs, mags, sph, pln, tri, boxes, wl, cnt, tmin):
    """K4 over shadow rays and the records of ``soft_packs``, walking each
    (tile, light) worklist ``wl`` (nt, L, n) int32 up to ``cnt`` (nt, L)
    int32 and testing each ray's segment against ``boxes`` (ceil(T/8), 8)
    float32 (``accel.shadow_boxes``) before a group's triangles -> (L, R)
    bool.  CPU tensors take ``any_hit_lights_plain``, which needs no
    boxes."""
    global PACKED_ANYHIT_LAUNCHES
    if p.device.type == "cpu":
        return any_hit_lights_plain(p, dirs, mags, sph, pln, tri, tmin)
    L, R, S, P, T = dirs.shape[0], p.shape[0], sph.shape[0], pln.shape[0], tri.shape[0]
    nt = -(-R // TILE)
    build.check_tensors("K4", p.device, {
        "p": (p, torch.float32, (R, 3)), "dirs": (dirs, torch.float32, (L, R, 3)),
        "mags": (mags, torch.float32, (L, R)),
        "spheres": (sph, torch.float32, (S, SP_COLS)), "planes": (pln, torch.float32, (P, SP_COLS)),
        "triangles": (tri, torch.float32, (T, TRI_COLS)),
        "boxes": (boxes, torch.float32, (-(-T // accel.GROUP), accel.BOX_COLS)),
        "wl": (wl, torch.int32, (nt, L, wl.shape[-1])), "cnt": (cnt, torch.int32, (nt, L))})
    build.check_aligned("K4", "boxes", boxes, 16)
    occ = torch.empty((L, R), dtype=torch.bool, device=p.device)  # one byte, 0 or 1
    lib = build.load()
    with torch.cuda.device(p.device):
        err = lib.raytpu_packed_anyhit(
            p.data_ptr(), dirs.data_ptr(), mags.data_ptr(), R, L, sph.data_ptr(), S,
            pln.data_ptr(), P, tri.data_ptr(), T, boxes.data_ptr(), wl.data_ptr(), cnt.data_ptr(),
            wl.shape[-1], float(tmin), occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: {build.cuda_error_name(lib, err)}")
    PACKED_ANYHIT_LAUNCHES += 1
    return occ


def any_hit_lights_plain(p, dirs, mags, sph, pln, tri, tmin):
    """What K4 computes, over every primitive."""
    o = p.unbind(1)
    return torch.stack([plain.any_hit_plain(sph, pln, tri, o, dirs[li].unbind(1), float(tmin),
                                            mags[li]) for li in range(dirs.shape[0])])


def render_image_packed_f32(scene: Scene, config: RenderConfig):
    """Packed render -> (H, W, 3) float32: K3 over the camera rays, the
    eager shade tail with K4 for every light's occlusion.  The group bounds
    and records are computed once, for both kernels and their worklists."""
    if config.soft_shadows:
        raise ValueError("the packed route renders hard shadows only")
    W, H = config.width, config.height
    ro, rd = renderer.generate_rays(scene.camera, config)
    tiled = W % 32 == 0 and H % 32 == 0
    if tiled:
        rd = mega2_fold(rd, H, W)  # 32x32 pixel tiles: tight per-tile cones
    ro_b = ro.expand_as(rd).contiguous()
    records = accel.normal_boxes(scene.triangles)
    t, _, normal, mat = scene_min_t_mega2(scene, ro_b, rd, config.ray_min, records)
    rec = hit_records_from_payload(ro_b, rd, t, normal, mat)
    colors = renderer.shade_from_records(
        scene, rec, rd, config,
        any_multi_fn=functools.partial(any_hit_lights_mega2, records=records))
    if tiled:
        colors = mega2_unfold_rows(colors, H, W)
    return colors.reshape(H, W, 3)
