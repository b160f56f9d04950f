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
#: past beta * margin < -GRAD_SUPPORT the soft sigmoid and its derivative
#: are exactly 0.0f in float32, so every partial of the soft VJP is
#: (the gradient records, ``normal_boxes``; derived below)
GRAD_SUPPORT = 90.0


def spatial_permutation(tri_verts: np.ndarray) -> np.ndarray:
    """Leaf order of the native binned-SAH builder over a (T,3,3) triangle
    soup.  raytpu falls back to Morton order when its library is missing;
    this raises instead (``raytpu_torch.native.runtime.load``), since
    another order would change the scene's tie-breaks without a word."""
    from raytpu_torch.native import runtime

    _, _, order = runtime.build_bvh(tri_verts, leaf_size=SAH_LEAF, bins=8)
    return order


def morton_permutation(tri_verts: np.ndarray) -> np.ndarray:
    """Morton order of a (T,3,3) triangle soup, through the native library
    (raises where it does not build).  No route takes it: the SAH leaf
    order (``spatial_permutation``) is the only triangle order the port
    renders with."""
    from raytpu_torch.native import runtime

    return runtime.morton_order(tri_verts)


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
#
# Nothing above depends on the segment's length: a hit that tri_t reports
# at any t lies within |r| of the segment's point at that t, and the length
# mag enters the slab test only in its last comparison, tn <= mag, which
# every tn passes when mag = inf.  So the bound holds for every mag, inf
# included, and the closest walk of K3 and K11a may test each group against
# the segment [0, t_cur] up to the ray's current closest hit (inf before
# its first): a group holding a hit at tc < t_cur passes, as do the normal
# records' narrowed boxes below, which do not depend on mag either
# (tests/test_torch_shadow_boxes.py tests each closest hit at mag = its
# own t, the shortest segment that must pass).

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


# ---------------------------------------------------------------------------
# A widening bounded by each ray's determinant (K10, K5)
# ---------------------------------------------------------------------------
#
# The bound above, |a| |r| <= 26.4 u E |s|, holds with |a| the computed
# determinant; kappa divides it by the least |a| that tri_t accepts, 2u,
# the grazing worst case.  A ray that meets a group's triangles at an angle
# has a larger determinant, and a lower bound a_lo of |a| over the group's
# triangles for that ray bounds |r| by 13.2 E |s| (2u / a_lo): kappa's
# widening scaled by 2u / a_lo <= 1.  The normal records
# (``normal_boxes``) carry each group's eight triangle normals, and each
# step of a_lo rounds down:
#
#   1. Exactly, a_k = e1 . (d x e2) = -n_k . d with n_k = e1 x e2 of
#      triangle k's float32 edges (the records' e1, e2), so |a_k| = |n_k .
#      d|.  The record stores n_k rounded to float32 from the exact
#      product: within u |n_k| of it.
#   2. c_k = |(n_k0 d0 + n_k1 d1) + n_k2 d2| in float32 is within 3u |n_k|
#      |d| of the stored normal's exact dot product, |d| <= 1 + 2u for a
#      normalized direction: with step 1, within 5u |n_k| <= 5u E of |a_k|
#      (|n_k| <= |e1| |e2| <= E).
#   3. The computed determinant is within 7u E of a_k (above), so |a| >=
#      min_k c_k - 12u E over the group.  The kernel forms a_lo = min_k c_k
#      - ea in float32, ea = kappa * TRI_SLACK: kappa >= HIT_SLACK E, so ea
#      >= 16u E after its rounding; the min is exact, and the rounding of
#      the difference, a relative u, is within HIT_SLACK's room (14 against
#      13.2), as are the roundings of 2u / a_lo and of the scaled widening.
#   4. Where a_lo <= 2u the scale 2u / max(a_lo, 2u) is exactly 1: the
#      widening is kappa's, the grazing worst case.  A triangle parallel to
#      the ray, or degenerate (n_k = 0), brings a group there.
#
# The bundle test bounds each |n_k . d| from below over a warp's
# directions by interval arithmetic on their per-component bounds (0 where
# the interval holds 0); every rounding above is monotone, so its scale is
# at least each ray's, and it still implies the per-ray test.
#
# The soft records (K5).  K5 may skip a triangle only where plain float32
# tri_soft gives occ < 2^-25, since then 1 - occ rounds to 1.0f exactly and
# the product is unchanged bit for bit.  With m = SOFT_SUPPORT / beta, a
# margin below -m gives occ below sigmoid(-20) ~ 2.1e-9, 14 times under
# 2^-25, room for the rounding of beta * margin and of w = 1 - u - v.
# tri_soft solves for (t, u, v) with tri_t's very roundings, so the point
# v0 + u e1 + v e2 that its (u, v) name lies within |r| of the segment's
# point at its t, where |r| is bounded as above plus 2u (|u| |e1| + |v|
# |e2|) for the quotients' rounding; while the margin is at least -m, |u|
# and |v| are at most 1 + 2m, so that term is at most 4u (1 + 2m) l, with
# l the group's longest edge.  A point of the plane whose barycentrics are
# all at least -m lies in the triangle scaled by 1 + 3m about its
# centroid, which lies within 2 m l of the triangle (each vertex moves by
# 3m times its distance to the centroid, two thirds of a median, at most
# l).  So a group whose box, padded by (2m + 8u (1 + 2m)) l and widened as
# above, the segment misses holds no triangle with a margin of -m or more:
# every factor it would multiply in is exactly 1.0f.
#
# The gradient records (K7, and K6 next).  K5's records do not serve the
# soft VJP: past K5's support occ is below 2^-25, so 1 - occ rounds to
# 1.0f, but docc = beta sig (1 - sig) is still about beta e^-20, not 0.
# A partial of K7 is 0.0f wherever docc is, and docc is 0.0f wherever
# the gate is shut, sig reaches the clamp, or sig = 1 / (1 + expf(-beta
# margin)) is exactly 0: where expf overflows, at -beta margin above
# ln(FLT_MAX) = 88.7228.  CUDA's expf is within 2 ulp, which moves that
# threshold by under 1e-6; the rounding of beta * margin moves it by a
# relative u; w = 1 - u - v rounds by under 2u (1 + |u| + |v|), under
# 1e-6 while |u|, |v| <= 1 + 2m.  With m = GRAD_SUPPORT / beta, 90 / beta,
# a margin below -m gives -beta margin above 89.9 after its rounding,
# where expf is inf on the card and on the CPU, and the 1.4% between 88.73
# and 90 holds those roundings with room.  So the records padded as
# above with this m leave out only groups whose every partial is exactly
# 0.0f for the ray: a walk over them adds the same nonzero partials.  At
# beta = 300, m = 0.3 and the pad is about 0.6 of the group's longest edge.

#: twice the float32 unit roundoff: the least |determinant| tri_t accepts
TWO_U = 2.0 ** -23
#: ea per unit of the record's kappa (step 3 above): 1.25 u, exact in
#: float32, against the 16u / HIT_SLACK = 1.14 u that ea needs
TRI_SLACK = 1.25 * 2.0 ** -24
#: floats of one normal record: lo(3), hi(3), kappa, kappa * h, then the
#: group's eight normals n_k(3) (the last triangle's repeated past the
#: scene's end)
NORMAL_COLS = 32


def merge_bounds(glo, ghi, k: int):
    """Bounds of runs of ``k`` consecutive groups from the groups' bounds
    ``glo``, ``ghi`` (ng, 3): with ``k = CHUNK // GROUP`` exactly
    ``chunk_bounds(tris, CHUNK)``, without a second pass over the
    triangles (a min of mins is the min)."""
    ng = glo.shape[0]
    pad = -ng % k
    lo = torch.nn.functional.pad(glo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(ghi, (0, 0, 0, pad), value=float("-inf"))
    return lo.reshape(-1, k, 3).amin(dim=1), hi.reshape(-1, k, 3).amax(dim=1)


def normal_boxes(tris: Triangles, group: int = GROUP, soft_beta=None,
                 support: float = SOFT_SUPPORT):
    """``(glo, ghi, boxes)``: the group AABBs of ``chunk_bounds``, which the
    worklist culls take, and the normal records (ng, NORMAL_COLS) float32
    of K10 and K5: ``shadow_boxes``'s eight columns, then the group's
    triangles' normals e1 x e2 of their float32 edges, rounded to float32
    (above).  With ``soft_beta`` each box is first padded by (2m + 8u
    (1 + 2m)) l, m = ``support`` / beta and l the group's longest edge:
    with SOFT_SUPPORT (K5) a segment that misses it meets no triangle whose
    soft factor differs from 1.0f, with GRAD_SUPPORT (K7, the gradient
    records) none with a partial of the soft VJP other than 0.0f
    (above)."""
    glo, ghi = chunk_bounds(tris, group)
    ng, T = glo.shape[0], tris.count
    # the records' float32 edges, the last triangle repeated past the end,
    # which changes no group's largest |e1| |e2| or longest edge
    last = torch.arange(ng * group, device=glo.device).clamp_(max=T - 1)
    e = (torch.stack([tris.v1, tris.v2]) - tris.v0)[:, last].double()
    length = torch.linalg.vector_norm(e, dim=2)
    if soft_beta is not None:
        m = float(support) / float(soft_beta)
        longest = torch.maximum(length.amax(dim=0), torch.linalg.vector_norm(e[1] - e[0], dim=1))
        pad = ((2.0 * m + 8.0 * 2.0 ** -24 * (1.0 + 2.0 * m)) * (1.0 + 2.0 ** -20)
               * longest.reshape(ng, group).amax(dim=1)).float()[:, None]
        lo, hi = glo - pad, ghi + pad
    else:
        lo, hi = glo, ghi
    normals = torch.linalg.cross(e[0], e[1], dim=1).float().reshape(ng, 3 * group)
    edge = (length[0] * length[1]).reshape(ng, group).amax(dim=1)
    return glo, ghi, torch.cat([shadow_boxes(lo, hi, edge), normals], dim=1)


def inv_dir(d):
    """Per-component reciprocal of directions, components below DIR_FLOOR
    in magnitude raised to it with their sign (shadow.cuh:inv_dir)."""
    floor = torch.full_like(d, DIR_FLOOR)
    return 1.0 / torch.where(d.abs() < DIR_FLOOR, torch.copysign(floor, d), d)


def _faces(boxes, dist, scale=None):
    """A box's faces widened by ``kappa * dist + kappa * h`` (shadow.cuh:
    widen), times ``scale`` for the normal records: ``lo``, ``hi`` (..., 3)
    for ``boxes`` (..., 8 or NORMAL_COLS), ``dist`` and ``scale`` (...)."""
    w = boxes[..., 6] * dist + boxes[..., 7]
    if scale is not None:
        w = w * scale
    return boxes[..., 0:3] - w[..., None], boxes[..., 3:6] + w[..., None]


def open_normal_boxes(ng: int, device=None):
    """(ng, NORMAL_COLS) normal records that every segment crosses, boxes
    of +-3e38 with no widening: a walk over them visits every listed group
    (the kernels' tests hold K10 and K5 to it bit for bit)."""
    boxes = torch.zeros((ng, NORMAL_COLS), dtype=torch.float32, device=device)
    boxes[:, 0:3], boxes[:, 3:6] = -3.0e38, 3.0e38
    return boxes


def _scale(a_lo):
    return TWO_U / torch.fmax(a_lo, torch.tensor(TWO_U, dtype=a_lo.dtype))


def _dots(n, d):
    """(n0 d0 + n1 d1) + n2 d2 in float32, as the kernels round it."""
    return (n[..., 0] * d[..., 0] + n[..., 1] * d[..., 1]) + n[..., 2] * d[..., 2]


def _normals(boxes):
    return boxes[..., BOX_COLS:NORMAL_COLS].reshape(*boxes.shape[:-1], GROUP, 3)


def _scale_of_least(boxes, least):
    """2u / a_lo for ``least`` the least |n_k . d| of the records' normals,
    a_lo = least - kappa * TRI_SLACK (steps 3 and 4 above), in float32 as
    the kernel rounds them."""
    return _scale(least - boxes[..., 6] * TRI_SLACK)


def _ray_scale(boxes, d):
    """The normal records' scale for rays of direction ``d`` (..., 3),
    broadcast against ``boxes`` (shadow.cuh:ray_scale); None for the
    8-column records."""
    if boxes.shape[-1] != NORMAL_COLS:
        return None
    if d is None:
        raise ValueError("the normal records widen by the ray's direction: pass d")
    return _scale_of_least(boxes, _dots(_normals(boxes), d[..., None, :]).abs().amin(dim=-1))


def _centre(boxes):
    return (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5


def segment_box_test(o, inv, mag, boxes, d=None):
    """(..., R, ng) bool: ray r's segment ``o + t d``, t in [0, mag],
    crosses box g widened for it: the slab test of ``shadow.cuh:seg_box``,
    rounded as it rounds.  ``o`` (..., R, 3), ``inv`` (..., R, 3) from
    ``inv_dir``, ``mag`` (..., R), ``boxes`` (..., ng, 8) from
    ``shadow_boxes`` or (..., ng, NORMAL_COLS) from ``normal_boxes``, whose widening
    also takes the directions ``d`` (..., R, 3).  A NaN in the origin or
    the length crosses nothing (tri_t finds no hit for such a ray
    either)."""
    o, inv = o[..., :, None, :], inv[..., :, None, :]
    boxes = boxes[..., None, :, :]
    scale = _ray_scale(boxes, None if d is None else d[..., :, None, :])
    dist = (o - _centre(boxes)).abs()
    lo, hi = _faces(boxes, dist[..., 0] + dist[..., 1] + dist[..., 2], scale)
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


def narrowed(d, boxes):
    """(..., R, ng) bool: the normal records' scale is below 1 for rays of
    direction ``d`` (..., R, 3), so their widening is narrower than
    kappa's (chip_smoke.py counts these per query)."""
    return _ray_scale(boxes[..., None, :, :], d[..., :, None, :]) < 1.0


def warp_slots(device=None):
    """(32, 32) long: the slot in a 1024-ray tile of lane j of warp w in K4
    and K11b (shadow.cuh:warp_slot): warp w takes the 8x4 pixel block at
    rows 4(w // 4).. and columns 8(w % 4).. of the tile's 32x32 layout."""
    w = torch.arange(32, device=device)[:, None]
    lane = torch.arange(32, device=device)[None, :]
    return ((w // 4) * 4 + lane // 8) * 32 + (w % 4) * 8 + lane % 8


def bundle_bounds(o, inv, mag, live, d=None):
    """The bounds of bundles of rays that ``bundle_box_test`` takes, over
    the ``live`` ones (shadow.cuh:warp_bundle): ``o``, ``inv`` (..., n, 3),
    ``mag`` and ``live`` (..., n) -> ``(olo, ohi, ilo, ihi)`` (..., 3) and
    ``tmax`` (...,), then with the directions ``d`` (..., n, 3), which the
    normal records take, ``(dlo, dhi)`` (..., 3); inf and -inf where no ray
    is live."""
    big = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    m = live[..., None]
    out = (torch.where(m, o, big).amin(dim=-2), torch.where(m, o, -big).amax(dim=-2),
           torch.where(m, inv, big).amin(dim=-2), torch.where(m, inv, -big).amax(dim=-2),
           torch.where(live, mag, -big).amax(dim=-1))
    if d is None:
        return out
    return out + (torch.where(m, d, big).amin(dim=-2), torch.where(m, d, -big).amax(dim=-2))


def _least_abs_dot(n, dlo, dhi):
    """The least |(n0 d0 + n1 d1) + n2 d2| over directions in [dlo, dhi]
    (shadow.cuh:least_abs_dot): the interval from the products at both
    ends of each component, its least magnitude, 0 where it holds 0."""
    lo = hi = None
    for a in range(3):
        p, q = n[..., a] * dlo[..., a], n[..., a] * dhi[..., a]
        pl, ph = torch.fmin(p, q), torch.fmax(p, q)
        lo, hi = (pl, ph) if lo is None else (lo + pl, hi + ph)
    return torch.where((lo <= 0.0) & (hi >= 0.0), 0.0, torch.fmin(lo.abs(), hi.abs()))


def _bundle_scale(boxes, dlo, dhi):
    """The normal records' scale for a bundle whose directions lie in [dlo,
    dhi] (shadow.cuh:bundle_box): ``_ray_scale`` with each |n_k . d|
    bounded from below over the bundle by ``_least_abs_dot``."""
    dots = _least_abs_dot(_normals(boxes), dlo[..., None, :], dhi[..., None, :])
    return _scale_of_least(boxes, dots.amin(dim=-1))


def bundle_box_test(olo, ohi, ilo, ihi, tmax, boxes, dlo=None, dhi=None):
    """(..., ng) bool: some ray of a bundle, with origin in [olo, ohi],
    reciprocal direction in [ilo, ihi] and length at most ``tmax`` (the
    bounds of ``bundle_bounds``), may cross box g of ``boxes`` (ng, 8), or
    of the normal records (ng, NORMAL_COLS) for directions in [dlo, dhi]
    (shadow.cuh:bundle_box).  The box is widened for the bundle's farthest
    origin, per axis the larger of |olo - c| and |ohi - c|, and for the
    normal records by the bundle's least bound of each |n_k . d|, so at least as
    much as for any of its rays; each (face - origin) * reciprocal of a ray
    of the bundle lies between the products at the corners, in float32 too
    (each rounding is monotone), so a box that ``segment_box_test`` passes
    for a ray of the bundle passes here."""
    scale = None
    if boxes.shape[-1] == NORMAL_COLS:
        if dlo is None:
            raise ValueError("the normal records widen by the rays' directions: pass dlo, dhi")
        scale = _bundle_scale(boxes, dlo[..., None, :], dhi[..., None, :])
    olo, ohi, ilo, ihi = (x[..., None, :] for x in (olo, ohi, ilo, ihi))
    c = _centre(boxes)
    d = torch.fmax((olo - c).abs(), (ohi - c).abs())
    lo, hi = _faces(boxes, d[..., 0] + d[..., 1] + d[..., 2], scale)
    prods = [(face - o) * i for face in (lo, hi) for o in (ohi, olo) for i in (ilo, ihi)]
    tn = torch.stack(prods).amin(dim=0).amax(dim=-1)
    tf = torch.stack(prods).amax(dim=0).amin(dim=-1)
    return (tn <= tf) & (tf >= 0.0) & (tn <= tmax[..., None])


def chunk_groups(chunks, T: int, chunk: int = CHUNK):
    """The 8-triangle groups of the chunk ids ``chunks`` (n,), in order, as
    K10's walk expands a worklist row (shadow.cuh:group_walk): chunk c
    gives groups (chunk / GROUP) c + j, j ascending, past the scene's last
    group dropped."""
    k = chunk // GROUP
    g = (chunks.long()[:, None] * k + torch.arange(k, device=chunks.device)).flatten()
    return g[g < -(-T // GROUP)]


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
