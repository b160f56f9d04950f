"""Spatial triangle order and the conservative group culls.

Counterpart of ``raytpu/ops/accel.py`` and of ``chunk_worklist``
(``raytpu/render/pallas_kernel.py``), as eager tensor glue around the
kernels:

  * meshes over 256 faces are reordered once, at build, by the leaf order of
    the native binned-SAH builder, so that each 8-triangle group is
    spatially tight (``reorder_scene_triangles``);
  * per frame, each group gets an AABB (``chunk_bounds``), each 1024-ray
    tile gets conservative ray bounds (``camera_tile_bounds`` for camera
    rays, ``ray_tile_bounds`` for any rays, ``light_shadow_cull_from_aabb``
    for the shadow rays of a tile's hit points), and ``cull_matrix`` tests
    every (tile, group) pair;
  * ``chunk_worklist`` turns a cull matrix into per-tile lists of passing
    groups in ascending order, which the kernels walk.

Every cull is conservative: a group it drops cannot be hit by any ray of
the tile, so a kernel that walks the worklist renders the same image as one
that tests every triangle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytpu_torch.core import math3d
from raytpu_torch.core.types import Scene, Triangles

CHUNK = 128  # raytpu's default cull-chunk size
GROUP = 8  #: triangles per cull group of the big-mesh kernels (raytpu's MEGA2_G)
SAH_LEAF = GROUP  # builder leaf size == the cull-group size: every group is a SAH box
#: (tile x group x axis) elements per step of ``cull_matrix``'s loop over
#: groups; bounds its temporaries at large group counts
CULL_STEP_ELEMS = 1 << 22
BIG = 3.0e38
#: the soft sigmoid's tail is cut where beta * margin < -SOFT_SUPPORT, an
#: occlusion below ~2e-9 (raytpu/render/pallas_soft.py:38)
SOFT_SUPPORT = 20.0


def spatial_permutation(tri_verts: np.ndarray) -> np.ndarray:
    """Leaf order of the native binned-SAH builder over a (T,3,3) triangle
    soup.  raytpu falls back to Morton order when its library is missing;
    this raises instead (``raytpu_torch.native.runtime.load``), since
    another order would change the scene's tie-breaks without a word."""
    from raytpu_torch.native import runtime

    _, _, order = runtime.build_bvh(tri_verts, leaf_size=SAH_LEAF, bins=8)
    return order


def reorder_scene_triangles(scene: Scene) -> Scene:
    """Reorder the triangle soup, and the mesh face tables that generate it,
    by SAH leaf order, PER MESH: each mesh's faces stay contiguous, so a
    group never spans two independently moving meshes and stays tight under
    rigid animation (raytpu/ops/accel.py says more).  Reordering changes the
    iteration-order tie-break only between exactly coincident surfaces."""
    tr = scene.triangles
    if tr.count == 0:
        return scene
    tv = torch.stack([tr.v0, tr.v1, tr.v2], dim=1).cpu().numpy()
    meshes = scene.meshes
    if meshes.num_faces == tr.count and meshes.num_meshes > 1:
        fm = meshes.face_mesh.cpu().numpy()
        perm = np.empty(tr.count, np.int32)
        base = 0
        for mid in range(meshes.num_meshes):
            sel = np.flatnonzero(fm == mid).astype(np.int32)
            perm[base:base + len(sel)] = sel[spatial_permutation(tv[sel])]
            base += len(sel)
    else:
        perm = spatial_permutation(tv)
    p = torch.as_tensor(perm, dtype=torch.long, device=scene.device)
    tri2 = Triangles(v0=tr.v0[p], v1=tr.v1[p], v2=tr.v2[p], normal=tr.normal[p],
                     cull=tr.cull[p], material=tr.material[p])
    if meshes.num_faces == tr.count:
        meshes = dataclasses.replace(meshes, face_vertex=meshes.face_vertex[p],
                                     face_normal=meshes.face_normal[p],
                                     face_mesh=meshes.face_mesh[p])
    return dataclasses.replace(scene, triangles=tri2, meshes=meshes)


def chunk_bounds(tris: Triangles, chunk: int = CHUNK):
    """Per-chunk AABBs ``(lo (nc,3), hi (nc,3))`` of consecutive runs of
    ``chunk`` triangles; the last chunk's bounds cover its real triangles
    only.  Recomputed per frame (the analog of the reference's per-frame
    BVH refit)."""
    T = tris.count
    nc = -(-T // chunk)
    pad = nc * chunk - T
    lo = torch.minimum(torch.minimum(tris.v0, tris.v1), tris.v2)
    hi = torch.maximum(torch.maximum(tris.v0, tris.v1), tris.v2)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=float("-inf"))
    return lo.reshape(nc, chunk, 3).amin(dim=1), hi.reshape(nc, chunk, 3).amax(dim=1)


def chunk_soft_slack(tris: Triangles, beta: float, chunk: int = CHUNK,
                     support: float = SOFT_SUPPORT):
    """(nc,) widening of each chunk's box that covers the soft sigmoid's
    support (raytpu/ops/accel.py:161).  A ray passing a distance ``d``
    outside a triangle of extent ``E`` has a barycentric margin of about
    ``-d/E``, so clipping where ``beta * margin < -support`` needs the box
    widened by ``support / beta`` times the chunk's largest triangle
    extent, here each triangle's box diagonal."""
    T = tris.count
    nc = -(-T // chunk)
    lo = torch.minimum(torch.minimum(tris.v0, tris.v1), tris.v2)
    hi = torch.maximum(torch.maximum(tris.v0, tris.v1), tris.v2)
    diag = torch.sqrt(((hi - lo) ** 2).sum(dim=1))
    diag = torch.nn.functional.pad(diag, (0, nc * chunk - T), value=0.0)
    return (support / beta) * diag.reshape(nc, chunk).amax(dim=1)


def cull_matrix(rb, chunk_lo, chunk_hi, tmin):
    """(nr, nc) float32: 1.0 where ray tile i may hit chunk j, else 0.0.

    ``rb`` (nr, 20) holds each tile's bounds as ``ray_tile_bounds`` lays
    them out.  Two conservative tests: the interval slab test of the
    origin box x direction box against the chunk box, and, where the tile's
    segments end (``seg_valid``), the overlap of the chunk box with the box
    of all segments.  The loop over chunks bounds the temporaries: raytpu
    stacks all eight slab candidates of every pair, which is ~1.1 GB per
    call at 300 tiles x 37,376 groups."""
    nr, nc = rb.shape[0], chunk_lo.shape[0]
    out = torch.empty((nr, nc), dtype=torch.float32, device=rb.device)
    omin, omax = rb[:, None, 0:3], rb[:, None, 3:6]
    dmin, dmax = rb[:, None, 6:9], rb[:, None, 9:12]
    tmax_t = rb[:, None, 12]
    seg_valid = rb[:, None, 13] > 0.0
    emin, emax = rb[:, None, 14:17], rb[:, None, 17:20]
    sign_safe = (dmin > 0.0) | (dmax < 0.0)
    inv1 = 1.0 / dmin
    inv2 = 1.0 / dmax
    s_lo = torch.minimum(omin, emin)
    s_hi = torch.maximum(omax, emax)
    step = max(1, CULL_STEP_ELEMS // max(3 * nr, 1))
    for j in range(0, nc, step):
        lo, hi = chunk_lo[None, j:j + step], chunk_hi[None, j:j + step]  # (1,c,3)
        ax_lo = ax_hi = None
        for b in (lo, hi):
            for o in (omin, omax):
                for inv in (inv1, inv2):
                    c = (b - o) * inv
                    ax_lo = c if ax_lo is None else torch.minimum(ax_lo, c)
                    ax_hi = c if ax_hi is None else torch.maximum(ax_hi, c)
        ax_lo = torch.where(sign_safe, ax_lo, -BIG)
        ax_hi = torch.where(sign_safe, ax_hi, BIG)
        t_lo = torch.clamp(ax_lo.amax(dim=-1), min=tmin)
        t_hi = torch.minimum(ax_hi.amin(dim=-1), tmax_t)
        slab_ok = t_hi >= t_lo
        seg_ok = ((s_lo <= hi) & (s_hi >= lo)).all(dim=-1) | ~seg_valid
        out[:, j:j + step] = (slab_ok & seg_ok).to(torch.float32)
    return out


def shadow_cull_matrix(ro, ld, mag, light_pos, is_point, lo, hi, tmin, tile: int = 1024):
    """Per-(tile, group) cull for the shadow rays toward ONE light: the
    forward slab/segment test on the actual rays, and for point lights the
    light-anchored reversed slab test {light -> origin box, t in [0, 1]},
    which has no origin-box slack.  ``is_point`` is a bool tensor or bool."""
    rb = ray_tile_bounds(ro, ld, mag, tile=tile)
    cull = cull_matrix(rb, lo, hi, tmin)
    rd_rev = ro - light_pos[None, :]
    rb_rev = ray_tile_bounds(light_pos.expand_as(ro), rd_rev,
                             torch.ones((ro.shape[0],), dtype=ro.dtype, device=ro.device), tile=tile)
    rev = cull_matrix(rb_rev, lo, hi, 0.0)
    return cull * torch.where(torch.as_tensor(is_point, device=ro.device), rev, torch.ones_like(rev))


def tile_pixels(W: int, H: int, tiled: bool, device, tile: int = 1024):
    """(px, py, valid), each (nt*tile,): the pixel of every ray slot in
    tile order.  ``tiled``: tile i is the i-th 32x32 pixel block in row-major
    block order, its rays row-major within the block; otherwise tile i is
    rays [i*tile, (i+1)*tile) of the row-major frame, and slots past the
    frame are not valid."""
    nt = -(-(W * H) // tile)
    slot = torch.arange(nt * tile, device=device)
    if tiled:
        i, j = slot // tile, slot % tile
        TX = W // 32
        px = (i % TX) * 32 + j % 32
        py = (i // TX) * 32 + j // 32
        return px, py, torch.ones_like(slot, dtype=torch.bool)
    valid = slot < W * H
    rid = torch.where(valid, slot, 0)
    return rid % W, rid // W, valid


def camera_tile_bounds(camera, W: int, H: int, tiled: bool, tile: int = 1024):
    """Per-tile PRIMARY ray bounds (nt, 20), from the camera alone: the
    unnormalized direction ``cx*right + cy*up + fwd`` is bilinear in the
    pixel coordinates, so its extrema over a pixel rectangle lie at the
    corners, and ``|d|^2 = 1 + cx^2 + cy^2`` for an orthonormal basis.
    Normalized bounds follow by interval division, widened by 1e-6
    relative.  Same layout as ``ray_tile_bounds``."""
    dev = camera.origin.device
    nt = -(-(W * H) // tile)
    i = torch.arange(nt, dtype=torch.float32, device=dev)
    if tiled:
        TX = W // 32
        tx = torch.remainder(i, TX)
        ty = torch.div(i, TX, rounding_mode="floor")
        px0, px1 = tx * 32.0, tx * 32.0 + 31.0
        py0, py1 = ty * 32.0, ty * 32.0 + 31.0
    else:
        rid0 = i * tile
        rid1 = torch.clamp(rid0 + tile - 1, max=float(W * H - 1))
        full_rows = (rid1 - rid0 + 1.0) >= W  # spans at least one full row
        px0 = torch.where(full_rows, 0.0, torch.remainder(rid0, W))
        px1 = torch.where(full_rows, float(W - 1), torch.remainder(rid1, W))
        # tiles shorter than a row that still wrap a row boundary span all columns
        wraps = (~full_rows) & (px1 < px0)
        px0 = torch.where(wraps, 0.0, px0)
        px1 = torch.where(wraps, float(W - 1), px1)
        py0 = torch.div(rid0, W, rounding_mode="floor")
        py1 = torch.div(rid1, W, rounding_mode="floor")

    fov = camera.fov_scale
    aspect = math3d.scalar(np.float32(W / H), dev)
    w_, h_ = math3d.scalar(W, dev), math3d.scalar(H, dev)
    cx0 = (2.0 * (px0 + 0.5) / w_ - 1.0) * aspect * fov
    cx1 = (2.0 * (px1 + 0.5) / w_ - 1.0) * aspect * fov
    cy1 = (1.0 - 2.0 * (py0 + 0.5) / h_) * fov  # py0 -> larger cy
    cy0 = (1.0 - 2.0 * (py1 + 0.5) / h_) * fov
    cx_lo, cx_hi = torch.minimum(cx0, cx1), torch.maximum(cx0, cx1)
    cy_lo, cy_hi = torch.minimum(cy0, cy1), torch.maximum(cy0, cy1)

    right, up, fwd = camera.onb()
    d_lo, d_hi = [], []
    for k in range(3):
        r, u, f = right[k], up[k], fwd[k]
        d_lo.append(torch.minimum(cx_lo * r, cx_hi * r) + torch.minimum(cy_lo * u, cy_hi * u) + f)
        d_hi.append(torch.maximum(cx_lo * r, cx_hi * r) + torch.maximum(cy_lo * u, cy_hi * u) + f)
    d_lo, d_hi = torch.stack(d_lo, dim=1), torch.stack(d_hi, dim=1)

    def minabs(lo, hi):
        return torch.where((lo <= 0.0) & (hi >= 0.0), 0.0, torch.minimum(lo.abs(), hi.abs()))

    n2_lo = 1.0 + minabs(cx_lo, cx_hi) ** 2 + minabs(cy_lo, cy_hi) ** 2
    n2_hi = 1.0 + torch.maximum(cx_lo ** 2, cx_hi ** 2) + torch.maximum(cy_lo ** 2, cy_hi ** 2)
    dmin, dmax = _div_interval(d_lo, d_hi, n2_lo[:, None], n2_hi[:, None])

    o = camera.origin[None, :].expand(nt, 3)
    z3 = torch.zeros((nt, 3), dtype=torch.float32, device=dev)
    return torch.cat([o, o, dmin, dmax, torch.full((nt, 1), BIG, device=dev),
                      torch.zeros((nt, 1), device=dev), z3, z3], dim=1)


def _div_interval(v_lo, v_hi, n2_lo, n2_hi, eps: float = 1e-6):
    """[v_lo, v_hi] / sqrt([n2_lo, n2_hi]) as a conservative interval,
    widened by ``eps`` relative (inputs broadcast; norms positive)."""
    inv_lo = torch.rsqrt(torch.clamp(n2_hi, min=1e-30))
    inv_hi = torch.rsqrt(torch.clamp(n2_lo, min=1e-30))
    lo = torch.minimum(v_lo * inv_lo, v_lo * inv_hi)
    hi = torch.maximum(v_hi * inv_lo, v_hi * inv_hi)
    margin = eps * torch.maximum(lo.abs(), hi.abs()) + 1e-12
    return lo - margin, hi + margin


def light_shadow_cull_from_aabb(aabb_lo, aabb_hi, light_pos, light_dir, is_point, glo, ghi, tmin):
    """Per-(tile, group) shadow cull for ONE light from per-TILE boxes of
    the shadow origins (the offset hit points the closest-hit kernel
    emits).  The bounds are supersets of the per-ray ones, so the render is
    unchanged.  Point lights: direction interval ``(L - box)/|L - p|`` by
    interval division, segment union = box with L, and the light-anchored
    reversed slab.  Directional lights: one exact direction.  An empty box
    (a tile whose rays all miss) culls every group."""
    nt = aabb_lo.shape[0]
    dev = aabb_lo.device
    z3 = torch.zeros((nt, 3), dtype=torch.float32, device=dev)
    o_lo, o_hi = aabb_lo, aabb_hi
    empty = ~(o_lo[:, 0] <= o_hi[:, 0])
    is_pt = torch.as_tensor(is_point, device=dev)

    L = light_pos[None, :].expand(nt, 3)
    diff_lo = light_pos[None, :] - o_hi
    diff_hi = light_pos[None, :] - o_lo
    straddle = (diff_lo <= 0.0) & (diff_hi >= 0.0)
    mina = torch.where(straddle, 0.0, torch.minimum(diff_lo.abs(), diff_hi.abs()))
    maxa = torch.maximum(diff_lo.abs(), diff_hi.abs())
    n2_lo = (mina ** 2).sum(dim=1, keepdim=True)
    n2_hi = (maxa ** 2).sum(dim=1, keepdim=True)
    p_dmin, p_dmax = _div_interval(diff_lo, diff_hi, n2_lo, n2_hi)
    p_dmin = torch.clamp(p_dmin, -1.0, 1.0)
    p_dmax = torch.clamp(p_dmax, -1.0, 1.0)
    p_tmx = torch.sqrt(n2_hi) * (1.0 + 1e-6)

    dm = (-light_dir)[None, :].expand(nt, 3)
    one, zero = torch.ones((nt, 1), device=dev), torch.zeros((nt, 1), device=dev)

    def sel(a, b):
        return torch.where(is_pt, a, b)

    rb = torch.cat([o_lo, o_hi, sel(p_dmin, dm), sel(p_dmax, dm),
                    sel(p_tmx, torch.full((nt, 1), BIG, device=dev)), sel(one, zero),
                    sel(L, z3), sel(L, z3)], dim=1)
    cull = cull_matrix(rb, glo, ghi, tmin)
    rb_rev = torch.cat([L, L, -diff_hi, -diff_lo, one, one, o_lo, o_hi], dim=1)
    rev = cull_matrix(rb_rev, glo, ghi, 0.0)
    cull = cull * torch.where(is_pt, rev, torch.ones_like(rev))
    return torch.where(empty[:, None], 0.0, cull)


def ray_tile_bounds(ro, rd, tmax, tile: int = 128):
    """Per-tile conservative bounds (nr, 20) of consecutive runs of ``tile``
    rays: ``[omin3, omax3, dmin3, dmax3, tmax_max, seg_valid, emin3,
    emax3]``.  ``seg_valid`` is 0 when the segments' endpoints are unbounded
    (primary rays, directional lights).  ``ro`` broadcasts against ``rd``;
    ``tmax`` is a scalar or (R,)."""
    R = rd.shape[0]
    nr = -(-R // tile)
    pad = nr * tile - R
    dev = rd.device

    def p3(x, v):
        return torch.nn.functional.pad(x, (0, 0, 0, pad), value=v).reshape(nr, tile, 3)

    ro_b = ro.expand_as(rd)
    tmax_b = (tmax.to(torch.float32) if isinstance(tmax, torch.Tensor)
              else math3d.scalar(tmax, dev)).expand(R)
    omin = p3(ro_b, float("inf")).amin(dim=1)
    omax = p3(ro_b, float("-inf")).amax(dim=1)
    dmin = p3(rd, float("inf")).amin(dim=1)
    dmax = p3(rd, float("-inf")).amax(dim=1)
    tmx = torch.nn.functional.pad(tmax_b, (0, pad), value=0.0).reshape(nr, tile).amax(dim=1)
    endpoint = ro_b + rd * torch.clamp(tmax_b, max=3.0e37)[:, None]
    emin = p3(endpoint, float("inf")).amin(dim=1)
    emax = p3(endpoint, float("-inf")).amax(dim=1)
    seg_valid = (torch.isfinite(emin).all(dim=1) & torch.isfinite(emax).all(dim=1)
                 & (emax.abs().amax(dim=1) < 1e30) & (emin.abs().amax(dim=1) < 1e30))
    return torch.cat([omin, omax, dmin, dmax, tmx[:, None], seg_valid.to(torch.float32)[:, None],
                      emin, emax], dim=1)


# ---------------------------------------------------------------------------
# The per-ray group-box test of the shadow any-hit kernels (K4, K11b)
# ---------------------------------------------------------------------------
#
# A kernel may skip a group's triangles for a shadow ray only if tri_t
# (common.cuh, plain.tri_t) reports no hit in any of them.  A hit that tri_t
# reports is not always where the segment meets the triangle: it solves
# o + t d = v0 + u e1 + v e2 by Cramer's rule in float32, and the point
# X = v0 + u e1 + v e2 of the triangle that its (t, u, v) name lies within
# |r| of the point Y = o + t d of the segment, where
#
#     |a| |r| <= |ea| |s| + |eu| |e1| + |ev| |e2| + |et|   (s = o - v0),
#
# ea, eu, ev, et being the rounding errors of the determinant a and of the
# numerators of u, v and t, plus a few ulps of |e1|, |e2| and t.  With
# fused dots and crosses each is at most 7 u |s| |e1| |e2| for a unit
# direction (u = 2^-24; ea has no |s|), and tri_t rejects |a| < FLT_EPSILON
# = 2u, so |r| <= 13.2 |e1| |e2| |s|.  For a ray nearly parallel to the
# triangle's plane that is far more than a few ulps: a grazing segment that
# passes a group's box at 1e-3 of the scene can get a hit from a triangle
# in it (tests/test_torch_shadow_boxes.py builds such rays).  So each ray
# tests group g's box widened by
#
#     w = HIT_SLACK * E_g * (|o - c_g|_1 + h_g),
#
# E_g the largest |e1| |e2| of the group's triangles, c_g the box's centre
# and h_g its half diagonal: |s| <= |o - c_g| + h_g for every vertex of the
# group.  The fixed pad (BOX_PAD_REL, BOX_PAD_ABS) covers the few ulps, the
# records' e1 = v1 - v0 rounding and the slab test's own rounding for
# origins within a few hundred box extents of the box.

#: each group box is widened on every side by BOX_PAD_REL times the largest
#: coordinate magnitude of the box plus BOX_PAD_ABS (``shadow_boxes``)
BOX_PAD_REL, BOX_PAD_ABS = 1e-4, 1e-4
#: bound on tri_t's hit-point error per unit |e1| |e2| |s| (13.2, above),
#: with room for the rounding of the widening itself
HIT_SLACK = 14.0
#: direction components smaller than this in magnitude take it, sign kept,
#: before their reciprocal (shadow.cuh:inv_dir): the reciprocal stays finite,
#: so no (box face - origin) * (1 / 0) = 0 * inf = NaN
DIR_FLOOR = 1e-30
#: floats of one box record: lo(3), hi(3), kappa, kappa * h
BOX_COLS = 8


def group_boxes(tris: Triangles, group: int = GROUP):
    """``(glo, ghi, boxes)``: the group AABBs of ``chunk_bounds``, which the
    worklist culls take, and the shadow kernels' box records built from
    them (``shadow_boxes``)."""
    glo, ghi = chunk_bounds(tris, group)
    e = (torch.linalg.vector_norm((tris.v1 - tris.v0).double(), dim=1)
         * torch.linalg.vector_norm((tris.v2 - tris.v0).double(), dim=1))
    e = torch.nn.functional.pad(e, (0, glo.shape[0] * group - e.shape[0]))
    return glo, ghi, shadow_boxes(glo, ghi, e.reshape(-1, group).amax(dim=1))


def shadow_boxes(glo, ghi, edge_product):
    """The kernels' box records, (ng, 8) float32 ``[lo(3), hi(3), kappa,
    kappa * h]``: the AABBs ``glo``, ``ghi`` padded by ``BOX_PAD_REL *
    max|coord| + BOX_PAD_ABS`` on every side, ``kappa = HIT_SLACK *
    edge_product`` (each group's largest |e1| |e2|) and ``h`` the padded
    box's half diagonal, both rounded up, for the per-ray widening
    ``kappa * |o - c|_1 + kappa * h`` (``segment_box_test``)."""
    pad = BOX_PAD_REL * torch.maximum(glo.abs(), ghi.abs()).amax(dim=1, keepdim=True) + BOX_PAD_ABS
    lo, hi = glo - pad, ghi + pad
    up = 1.0 + 2.0 ** -20  # float32 rounding is within 2^-24: rounded up
    kappa = HIT_SLACK * edge_product.double() * up
    h = 0.5 * torch.linalg.vector_norm((hi - lo).double(), dim=1) * up
    return torch.cat([lo, hi, kappa[:, None].float(), (kappa * h * up)[:, None].float()],
                     dim=1).contiguous()


def inv_dir(d):
    """Per-component reciprocal of directions, components below DIR_FLOOR
    in magnitude raised to it with their sign (shadow.cuh:inv_dir)."""
    floor = torch.full_like(d, DIR_FLOOR)
    return 1.0 / torch.where(d.abs() < DIR_FLOOR, torch.copysign(floor, d), d)


def _faces(boxes, dist):
    """A box's faces widened by ``kappa * dist + kappa * h`` (shadow.cuh:
    widen): ``lo``, ``hi`` (..., 3) for ``boxes`` (..., 8) and ``dist``
    (...)."""
    w = (boxes[..., 6] * dist + boxes[..., 7])[..., None]
    return boxes[..., 0:3] - w, boxes[..., 3:6] + w


def _centre(boxes):
    return (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5


def segment_box_test(o, inv, mag, boxes):
    """(..., R, ng) bool: ray r's segment ``o + t d``, t in [0, mag],
    crosses box g widened for it: the slab test of ``shadow.cuh:seg_box``,
    rounded as it rounds.  ``o`` (..., R, 3), ``inv`` (..., R, 3) from
    ``inv_dir``, ``mag`` (..., R), ``boxes`` (..., ng, 8) from
    ``shadow_boxes``.  A NaN in the origin or the length crosses nothing
    (tri_t finds no hit for such a ray either)."""
    o, inv = o[..., :, None, :], inv[..., :, None, :]
    boxes = boxes[..., None, :, :]
    d = (o - _centre(boxes)).abs()
    lo, hi = _faces(boxes, d[..., 0] + d[..., 1] + d[..., 2])
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    tn = torch.fmin(t1, t2)
    tf = torch.fmax(t1, t2)
    tn = torch.fmax(torch.fmax(tn[..., 0], tn[..., 1]), tn[..., 2])
    tf = torch.fmin(torch.fmin(tf[..., 0], tf[..., 1]), tf[..., 2])
    return (tn <= tf) & (tf >= 0.0) & (tn <= mag[..., None])


def tight_segment_box_test(o, inv, mag, boxes):
    """``segment_box_test`` without the per-ray widening: the segment
    crosses the padded box itself.  What a query needs of the groups
    whatever the walk (chip_smoke.py counts the triangles of these groups
    for K4's and K11b's bounds)."""
    flat = torch.cat([boxes[..., 0:6], torch.zeros_like(boxes[..., 6:8])], dim=-1)
    return segment_box_test(o, inv, mag, flat)


def warp_slots(device=None):
    """(32, 32) long: the slot in a 1024-ray tile of lane j of warp w in K4
    and K11b (shadow.cuh:warp_slot): warp w takes the 8x4 pixel block at
    rows 4(w // 4).. and columns 8(w % 4).. of the tile's 32x32 layout."""
    w = torch.arange(32, device=device)[:, None]
    lane = torch.arange(32, device=device)[None, :]
    return ((w // 4) * 4 + lane // 8) * 32 + (w % 4) * 8 + lane % 8


def bundle_bounds(o, inv, mag, live):
    """The bounds of bundles of rays that ``bundle_box_test`` takes, over
    the ``live`` ones (shadow.cuh:warp_bundle): ``o``, ``inv`` (..., n, 3),
    ``mag`` and ``live`` (..., n) -> ``(olo, ohi, ilo, ihi)`` (..., 3) and
    ``tmax`` (...,); inf and -inf where no ray is live."""
    big = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    m = live[..., None]
    return (torch.where(m, o, big).amin(dim=-2), torch.where(m, o, -big).amax(dim=-2),
            torch.where(m, inv, big).amin(dim=-2), torch.where(m, inv, -big).amax(dim=-2),
            torch.where(live, mag, -big).amax(dim=-1))


def bundle_box_test(olo, ohi, ilo, ihi, tmax, boxes):
    """(..., ng) bool: some ray of a bundle, with origin in [olo, ohi],
    reciprocal direction in [ilo, ihi] and length at most ``tmax`` (the
    bounds of ``bundle_bounds``), may cross box g of ``boxes`` (ng, 8)
    (shadow.cuh:bundle_box).  The box is widened for the bundle's farthest
    origin, per axis the larger of |olo - c| and |ohi - c|, so at least as
    much as for any of its rays; each (face - origin) * reciprocal of a ray
    of the bundle lies between the products at the corners, in float32 too
    (each rounding is monotone), so a box that ``segment_box_test`` passes
    for a ray of the bundle passes here."""
    olo, ohi, ilo, ihi = (x[..., None, :] for x in (olo, ohi, ilo, ihi))
    c = _centre(boxes)
    d = torch.fmax((olo - c).abs(), (ohi - c).abs())
    lo, hi = _faces(boxes, d[..., 0] + d[..., 1] + d[..., 2])
    prods = [(face - o) * i for face in (lo, hi) for o in (ohi, olo) for i in (ilo, ihi)]
    tn = torch.stack(prods).amin(dim=0).amax(dim=-1)
    tf = torch.stack(prods).amax(dim=0).amin(dim=-1)
    return (tn <= tf) & (tf >= 0.0) & (tn <= tmax[..., None])


def culls_groups(tris: Triangles, group: int = GROUP) -> bool:
    """raytpu culls from two groups on (``CULL_MIN_TRIS`` is two 128-triangle
    chunks); below that every tile takes every group."""
    return tris.count >= 2 * group


def full_worklist(rows: int, tris: Triangles, group: int = GROUP):
    """The worklists of no cull: every group of ``group`` triangles of
    ``tris`` for each of ``rows`` rows, as ``chunk_worklist`` lays them out."""
    ng = -(-tris.count // group)
    wl = torch.arange(ng, dtype=torch.int32, device=tris.v0.device).expand(rows, ng).contiguous()
    return wl, torch.full((rows,), ng, dtype=torch.int32, device=tris.v0.device)


def chunk_worklist(cull):
    """(nr, nc) cull matrix -> ``(worklist (nr, nc) i32, count (nr,) i32)``:
    each row's passing chunk ids first, in ascending order (a stable sort),
    which keeps the first-primitive tie-break across chunks; the rest of
    the row is the failing ids, which no kernel reads."""
    order = torch.argsort(-cull, dim=1, stable=True).to(torch.int32)
    return order.contiguous(), (cull > 0.0).sum(dim=1).to(torch.int32)
