"""The group-box test of the shadow any-hit kernels K4 and K11b
(``render/csrc/shadow.cuh``), through its torch twins in ``ops/accel.py``.

A kernel skips a group's triangles for a shadow ray whose segment misses the
group's padded box widened for the ray (``accel.segment_box_test``), and
skips a worklist entry for a whole warp when the box misses the bounds of
the warp's 32 rays (``accel.bundle_box_test``).  That keeps the kernels'
occlusion exactly the plain version's only if neither test ever rejects a
group in which the plain triangle test reports a hit in [tmin, mag).  These
tests check that on real shadow queries (bunny and optional at 64x48, every
triangle; 640x480 tiles of bunny50k, every triangle of the tiles'
worklists, which the kernels walk), on adversarial rays (axis-parallel
directions, origins on box faces and corners, grazing segments through
triangle edges, segments that end exactly at a triangle on a box face) and
on rays so nearly parallel to a triangle's plane that the triangle test's
float32 solve names hit points outside the padded box, and that the
occlusion with box culling equals ``packed.any_hit_lights_plain`` bit for
bit.  Torch only.  The test marked ``cuda`` holds K4 and K11b against their
plain versions on a card (``pytest -m cuda tests/test_torch_shadow_boxes.py``).
"""

import numpy as np
import pytest
import torch

from raytpu_torch.core import scenes
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.ops import accel
from raytpu_torch.render import packed, plain, renderer

torch.set_num_threads(2)

TMIN = RenderConfig().ray_min
#: bunny50k's 640x480 tiles: one on the bunny whose shadow worklists list
#: 1,290-2,391 of its 9,344 groups, and one of floor beside it
BUNNY50K_TILES = (171, 285)
#: the kernels' warps whose queries are checked in each of those tiles (of
#: 32, ``accel.warp_slots``): 8x4 pixel blocks on a diagonal
BUNNY50K_WARPS = (0, 13, 18, 31)


def _hits(tri, p, d, mag):
    """(R, T) bool: the plain triangle test reports a hit in [TMIN, mag),
    in plain's chunks of triangles."""
    o3 = tuple(x[:, None] for x in p.unbind(1))
    d3 = tuple(x[:, None] for x in d.unbind(1))
    return torch.cat([plain.tri_t(plain._rows(tri[a:b], 13), o3, d3, TMIN, mag[:, None],
                                  shadow=True) < plain.INF
                      for a, b in plain._tri_chunks(tri.shape[0], p.shape[0], p.device)], dim=1)


def _sphere_plane_occ(sph, pln, p, d, mag):
    empty = torch.zeros((0, packed.TRI_COLS))
    return plain.any_hit_plain(sph, pln, empty, p.unbind(1), d.unbind(1), TMIN, mag)


def _check_queries(sph, pln, tri, tri_ids, p, d, mag, boxes):
    """``packed.any_hit_lights_plain`` of the queries over the triangles
    ``tri_ids`` (rows of the scene's records ``tri``), checked against the
    box tests: every hit of one of those triangles by a live query (not
    occluded by a sphere or plane) passes the per-ray and the bundle test
    of its group, each 32 consecutive queries a bundle, so the occlusion
    with box culling (spheres, planes, then the triangles of the groups
    the per-ray test passes) is the plain version's.  Returns the plain
    version's occlusion."""
    R = p.shape[0]
    want = packed.any_hit_lights_plain(p, d[None], mag[None], sph, pln, tri[tri_ids], TMIN)[0]
    live = ~_sphere_plane_occ(sph, pln, p, d, mag)
    rays = torch.nonzero(want & live).flatten()  # only these hit a triangle
    if rays.numel() == 0:
        return want
    hits = _hits(tri[tri_ids], p[rays], d[rays], mag[rays])  # (n rays, n triangles)
    groups, col = torch.unique(tri_ids // accel.GROUP, return_inverse=True)
    inv = accel.inv_dir(d)
    seg = accel.segment_box_test(p[rays], inv[rays], mag[rays], boxes[groups])[:, col]
    assert bool(seg[hits].all()), "the per-ray box test rejected a group that a ray hits"
    culled = want & ~live
    culled[rays] = (hits & seg).any(dim=1)
    assert torch.equal(culled, want)
    pad = (-R) % 32  # bundles of 32 queries; padding queries are not live

    def bundles(x, fill):
        return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)]).reshape(-1, 32, *x.shape[1:])

    q = accel.bundle_bounds(bundles(p, 0.0), bundles(inv, 1.0), bundles(mag, 0.0),
                            bundles(live, False))
    hit_groups = torch.zeros((R + pad, groups.numel()), dtype=torch.bool)
    hit_groups[rays] = torch.zeros((rays.numel(), groups.numel())).index_add_(
        1, col, hits.float()) > 0
    passed = accel.bundle_box_test(*q, boxes[groups])  # (bundles, groups)
    assert bool(passed[hit_groups.reshape(-1, 32, groups.numel()).any(dim=1)].all()), \
        "the bundle test rejected a group that a ray of the warp hits"
    return want


def _tile_queries(scene, cfg, tiles=None):
    """Shadow queries ``(p, dirs, mags)`` of the packed route's camera rays
    (32x32 blocks when they fit) in the 1024-ray ``tiles`` given, or in all,
    the closest hit over the triangles their worklists list, and the
    queries' shadow worklists ``(wl, cnt)`` as K4 gets them."""
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if cfg.width % 32 == 0 and cfg.height % 32 == 0:
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    if tiles is not None:
        rays = (torch.as_tensor(tiles)[:, None] * 1024 + torch.arange(1024)).flatten()
        ro, rd = ro[rays], rd[rays]
    sph, pln, tri = packed.soft_packs(scene)
    ids = _listed(*packed.closest_worklists(scene, ro, rd, TMIN), tri.shape[0])
    t, _, normal, mat = packed.winner_search_plain(ro, rd, sph, pln, tri[ids], TMIN)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    p, dirs, mags = renderer.shadow_query_inputs(scene, rec, cfg)
    return p, dirs, mags, packed.shadow_worklists(scene, p, dirs, mags, TMIN)


def _listed(wl, cnt, T):
    """The triangle ids of every group the worklist rows list, ascending."""
    used = torch.arange(wl.shape[-1]) < cnt[..., None]
    g = torch.unique(wl[used].long())
    return (g[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten().clamp(max=T - 1).unique()


def _check_frame(name, size, tiles=None, warps=range(32)):
    """``_check_queries`` on ``name``'s queries at ``size`` (the 1024-ray
    ``tiles`` given, or all), those of each tile's ``warps`` (the kernels'
    warps, ``accel.warp_slots``) against the triangles of their shadow
    worklist rows, which K4 and K11b walk: no shadow ray of the tile
    reaches another (the glue's cull is conservative).  Returns the (L, R)
    occlusion, False for the queries not checked."""
    scene = scenes.get(name).build("cpu")
    p, dirs, mags, (wl, cnt) = _tile_queries(scene, RenderConfig(width=size[0], height=size[1]),
                                             tiles)
    sph, pln, tri = packed.soft_packs(scene)
    boxes = accel.group_boxes(scene.triangles)[2]
    out = torch.zeros((dirs.shape[0], p.shape[0]), dtype=torch.bool)
    for ti in range(wl.shape[0]):
        r = ti * 1024 + accel.warp_slots()[list(warps)].flatten()
        r = r[r < p.shape[0]]
        for li in range(dirs.shape[0]):
            ids = _listed(wl[ti, li], cnt[ti, li], tri.shape[0])
            out[li, r] = _check_queries(sph, pln, tri, ids, p[r], dirs[li, r], mags[li, r], boxes)
    return out


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_box_test_passes_every_hit_at_64x48(name):
    """Every shadow query of the frame against every triangle its (tile,
    light) worklist lists, which K4 and K11b walk."""
    got = _check_frame(name, (64, 48))
    assert bool(got.any()) and not bool(got.all())


def test_box_test_passes_every_hit_on_bunny50k_tiles():
    """640x480 tiles of bunny50k, as above, the queries of a few warps."""
    got = _check_frame("bunny50k", (640, 480), BUNNY50K_TILES, BUNNY50K_WARPS)
    assert int(got.sum()) > 100


def _adversarial_rays(tri, glo, ghi, rng):
    """(p, d, mag) of rays made to stress the box test against the records
    ``tri`` and their unpadded group boxes ``glo``, ``ghi``: axis-parallel
    rays through triangle points, some from origins in the plane of a box
    face; rays from a vertex (on its group box's
    faces) and from points on a triangle; grazing rays through points on
    triangle edges at angles of 1e-4 to 0.3 radians; rays whose segment
    ends exactly at the triangle point they aim at."""
    T = tri.shape[0]
    v0, e1, e2, n = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], tri[:, 9:12]

    def point(k, u, v):
        return v0[k] + u[:, None] * e1[k] + v[:, None] * e2[k]

    def bary(m):
        u, v = rng.random(m), rng.random(m)
        flip = u + v > 1.0
        u, v = np.where(flip, 1.0 - u, u), np.where(flip, 1.0 - v, v)
        return torch.as_tensor(u, dtype=torch.float32), torch.as_tensor(v, dtype=torch.float32)

    ps, ds, ms = [], [], []
    # axis-parallel: +-x, +-y, +-z through random triangle points, origins
    # 0.5 away; half of them moved into the plane of their group box's face
    m = 96
    k = torch.as_tensor(rng.integers(0, T, m))
    target = point(k, *bary(m))
    axis = torch.zeros((m, 3))
    axis[torch.arange(m), torch.as_tensor(rng.integers(0, 3, m))] = torch.as_tensor(
        rng.choice([-1.0, 1.0], m), dtype=torch.float32)
    o = target - 0.5 * axis
    lo, hi = glo[k // accel.GROUP], ghi[k // accel.GROUP]
    other = (axis == 0).float()
    face = torch.where(torch.as_tensor(rng.random((m, 1)) < 0.5), lo, hi)
    on_face = torch.as_tensor(rng.random(m) < 0.5)[:, None] & (other > 0) & torch.as_tensor(
        rng.random((m, 3)) < 0.5)
    ps.append(torch.where(on_face, face, o))
    ds.append(axis)
    ms.append(torch.full((m,), 1.0))
    # from a vertex (a corner or face point of its group's box) or a point
    # on a triangle, toward a point of a triangle of the same or a nearby group
    m = 256
    k = torch.as_tensor(rng.integers(0, T, m))
    k2 = torch.clamp(k + torch.as_tensor(rng.integers(-16, 17, m)), 0, T - 1)
    start = torch.where(torch.as_tensor(rng.random((m, 1)) < 0.5), v0[k], point(k, *bary(m)))
    to = point(k2, *bary(m)) - start
    dist = torch.linalg.vector_norm(to, dim=1).clamp(min=1e-12)
    ps.append(start)
    ds.append(to / dist[:, None])
    ms.append(dist * 1.5)
    # grazing: through points on an edge (u = 0, v = 0 or u + v = 1) at small
    # angles to the triangle's plane, from 0.01 to 10 away
    m = 512
    k = torch.as_tensor(rng.integers(0, T, m))
    u, v = bary(m)
    edge = torch.as_tensor(rng.integers(0, 3, m))
    u = torch.where(edge == 0, 0.0, torch.where(edge == 2, 1.0 - v, u))
    v = torch.where(edge == 1, 0.0, v)
    target = point(k, u, v)
    nn = torch.nn.functional.normalize(n[k], dim=1)
    inplane = torch.nn.functional.normalize(torch.linalg.cross(nn, torch.as_tensor(
        rng.normal(size=(m, 3)), dtype=torch.float32), dim=1), dim=1)
    ang = torch.as_tensor(10.0 ** rng.uniform(-4.0, -0.5, m), dtype=torch.float32)
    sgn = torch.as_tensor(rng.choice([-1.0, 1.0], m), dtype=torch.float32)
    d = torch.nn.functional.normalize(inplane * torch.cos(ang)[:, None]
                                      + (sgn * torch.sin(ang))[:, None] * nn, dim=1)
    dist = torch.as_tensor(10.0 ** rng.uniform(-2.0, 1.0, m), dtype=torch.float32)
    ps.append(target - d * dist[:, None])
    ds.append(d)
    ms.append(dist * 2.0)
    # segments that end exactly at the point they aim at: a point of the
    # triangle near the vertex that attains its group box's largest x
    m = 128
    k = torch.as_tensor(rng.integers(0, T, m))
    verts = torch.stack([v0[k], v0[k] + e1[k], v0[k] + e2[k]], dim=1)
    corner = verts[torch.arange(m), verts[:, :, 0].argmax(dim=1)]
    centroid = verts.mean(dim=1)
    target = corner + 1e-3 * (centroid - corner)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(m, 3)),
                                                      dtype=torch.float32), dim=1)
    d = torch.where((d * n[k]).sum(dim=1, keepdim=True) > 0.0, d, -d)
    o = target - d
    t = plain.tri_t(tuple(tri[k, c] for c in range(13)), o.unbind(1), d.unbind(1), 0.0,
                    torch.full((m,), 2.0), shadow=True)
    t = torch.where(torch.isfinite(t), t, 1.0)
    ps.append(o)
    ds.append(d)
    ms.append(torch.nextafter(t, torch.full_like(t, 3.0)))
    return torch.cat(ps), torch.cat(ds), torch.cat(ms)


def _grazing_rays(tri, boxes, rng, m):
    """(p, d, mag, k) of ``m`` rays nearly parallel to the plane of triangle
    ``k``, at angles whose |e1 . (d x e2)| is a multiple of FLT_EPSILON, the
    least that tri_t accepts, where its float32 solve is least accurate.
    Half pass a point of the plane outside the padded box of ``k``'s group:
    ``k`` holds the group's largest vertex coordinate on a random axis, and
    the ray passes that vertex, 1 to 4 pads beyond the padded face, from 3
    to 30 away.  Half start from points of the plane of one of the 16
    largest triangles.  Both at 1 to 100 times FLT_EPSILON."""
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    T = tri.shape[0]
    big = torch.linalg.vector_norm(torch.linalg.cross(e1, e2, dim=1), dim=1)
    h = m // 2

    def unit(x):
        return torch.nn.functional.normalize(x, dim=1)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    def log_uniform(lo, hi, n):
        return torch.as_tensor(10.0 ** rng.uniform(lo, hi, n), dtype=torch.float32)

    # first kind: past the vertex that attains the group's largest
    # coordinate on a random axis, in its triangle's plane, beyond the face
    ng = boxes.shape[0]
    g = torch.as_tensor(rng.choice(ng, min(48, ng), replace=False))[
        torch.as_tensor(rng.integers(0, min(48, ng), h))]
    ax = torch.as_tensor(rng.integers(0, 3, h))
    rows = torch.arange(h)
    ids = (g[:, None] * accel.GROUP + torch.arange(accel.GROUP)).clamp(max=T - 1)  # (h, 8)
    verts = torch.stack([v0[ids], v0[ids] + e1[ids], v0[ids] + e2[ids]], dim=2)  # (h, 8, 3, 3)
    coord = verts[rows, :, :, ax].reshape(h, -1)
    top = coord.argmax(dim=1)
    k1 = ids[rows, top // 3]
    vert = verts[rows, top // 3, top % 3]
    own = verts[rows, top // 3]
    nn1 = unit(torch.linalg.cross(e1[k1], e2[k1], dim=1))
    out = unit(vert - own.mean(dim=1))  # in the plane, away from the triangle
    out_ax = out[rows, ax].clamp(min=0.05)
    pad = boxes[g, 3 + ax] - vert[rows, ax]  # the vertex to the padded face
    beyond = torch.as_tensor(rng.uniform(1.0, 4.0, h), dtype=torch.float32) * pad
    target = vert + ((pad + beyond) / out_ax)[:, None] * out
    along = unit(torch.linalg.cross(nn1, out, dim=1) + 0.3 * rnd(h, 1) * out)
    sin1 = torch.clamp(plain.FLT_EPSILON / big[k1], min=plain.FLT_EPSILON) * log_uniform(
        0.0, 2.0, h)
    sgn = torch.as_tensor(rng.choice([-1.0, 1.0], h), dtype=torch.float32)
    d1 = unit(along * torch.sqrt(1.0 - sin1 * sin1)[:, None] + (sgn * sin1)[:, None] * nn1)
    dist = log_uniform(0.5, 1.5, h)
    # second kind: from the plane of a large triangle, |det| just above FLT_EPSILON
    k2 = torch.argsort(big, descending=True)[:16][torch.as_tensor(rng.integers(0, 16, m - h))]
    n2 = unit(torch.linalg.cross(e1[k2], e2[k2], dim=1))
    a_, b_ = (torch.as_tensor(rng.uniform(-3.0, 4.0, m - h), dtype=torch.float32) for _ in "ab")
    off = torch.as_tensor(rng.normal(size=m - h) * 10.0 ** rng.uniform(-9.0, -5.0, m - h),
                          dtype=torch.float32)
    o2 = v0[k2] + a_[:, None] * e1[k2] + b_[:, None] * e2[k2] + off[:, None] * n2
    along2 = unit(torch.linalg.cross(n2, rnd(m - h, 3), dim=1))
    sin = torch.clamp(plain.FLT_EPSILON / big[k2], min=plain.FLT_EPSILON) * log_uniform(
        0.0, 2.0, m - h)
    sgn2 = torch.as_tensor(rng.choice([-1.0, 1.0], m - h), dtype=torch.float32)
    d2 = unit(along2 * torch.sqrt(1.0 - sin * sin)[:, None] + (sgn2 * sin)[:, None] * n2)
    mag2 = log_uniform(-1.0, 1.5, m - h)
    return (torch.cat([target - d1 * dist[:, None], o2]), torch.cat([d1, d2]),
            torch.cat([2.0 * dist, mag2]), torch.cat([k1, k2]))


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_box_test_passes_every_hit_of_grazing_rays(name):
    """Rays that graze a triangle's plane (``_grazing_rays``): tri_t's hit
    point may lie far off the segment there, and the per-ray widening of the
    box (``accel.shadow_boxes``) must still take in every hit.  Some of
    these hits lie outside the padded box without the widening, so the
    check has teeth."""
    scene = scenes.get(name).build("cpu")
    _, _, tri = packed.soft_packs(scene)
    boxes = accel.group_boxes(scene.triangles)[2]
    p, d, mag, k = _grazing_rays(tri, boxes, np.random.default_rng(11), 4096)
    hit = plain.tri_t(tuple(tri[k, c] for c in range(13)), p.unbind(1), d.unbind(1), TMIN, mag,
                      shadow=True) < plain.INF
    own = boxes[k // accel.GROUP][:, None]
    tight = accel.tight_segment_box_test(p[:, None], accel.inv_dir(d)[:, None], mag[:, None],
                                         own)[:, 0, 0]
    assert int((hit & ~tight).sum()) > 0
    groups = torch.unique(k // accel.GROUP)
    ids = (groups[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten()
    ids = ids[ids < tri.shape[0]]
    empty = torch.zeros((0, packed.SP_COLS))
    occ = _check_queries(empty, empty, tri, ids, p, d, mag, boxes)
    assert bool(occ[hit].all())


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_box_test_passes_every_hit_of_adversarial_rays(name):
    scene = scenes.get(name).build("cpu")
    sph, pln, tri = packed.soft_packs(scene)
    empty = torch.zeros((0, packed.SP_COLS))
    glo, ghi, boxes = accel.group_boxes(scene.triangles)
    p, d, mag = _adversarial_rays(tri, glo, ghi, np.random.default_rng(7))
    occ = _check_queries(empty, empty, tri, torch.arange(tri.shape[0]), p, d, mag, boxes)
    assert int(occ.sum()) > p.shape[0] // 2


def test_zero_direction_components_and_origins_on_faces():
    """A zero direction component gives a finite reciprocal (no 0 * inf =
    NaN).  Against the padded unit box: rays along a face, an edge or a
    corner of the unit box (origins on its faces, as shadow origins sit on
    the mesh) cross it; a ray parallel to a face outside the padded slab and
    an all-NaN origin cross nothing; a segment that ends exactly on the padded
    face crosses it, one that ends before it does not."""
    boxes = accel.shadow_boxes(torch.zeros((1, 3)), torch.ones((1, 3)), torch.zeros(1))
    pad = float(boxes[0, 3]) - 1.0
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, -0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0],
                      [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    o = torch.tensor([[-1.0, 0.0, 0.5], [-1.0, 1.0, 1.0], [1.0, 1.0, -2.0], [0.0, 3.0, 1.0],
                      [-1.0, 1.5, 0.5], [float("nan")] * 3])
    inv = accel.inv_dir(d)
    assert bool(torch.isfinite(inv).all())
    got = accel.segment_box_test(o, inv, torch.full((6,), 4.0), boxes)[:, 0]
    assert got.tolist() == [True, True, True, True, False, False]
    near = float(boxes[0, 0]) + 1.0  # the distance to the padded near face
    ends = torch.tensor([near, float(np.nextafter(np.float32(near), np.float32(0.0)))])
    got = accel.segment_box_test(o[:1].expand(2, 3), inv[:1].expand(2, 3), ends, boxes)[:, 0]
    assert got.tolist() == [True, False] and pad > 0.0
    q = accel.bundle_bounds(o[:4], inv[:4], torch.full((4,), 4.0), torch.ones(4, dtype=torch.bool))
    assert bool(accel.bundle_box_test(*q, boxes)[0])


def test_shadow_boxes_pad_every_side():
    """The fixed pad on every side; kappa = HIT_SLACK * the largest |e1| |e2|
    and kappa * h (h the padded box's half diagonal), rounded up, and the
    widening they give a ray: ``group_boxes`` takes |e1| |e2| per group."""
    glo = torch.tensor([[1.0, -2.0, 0.0]])
    ghi = torch.tensor([[3.0, -1.0, 0.0]])
    b = accel.shadow_boxes(glo, ghi, torch.tensor([0.25]))
    pad = np.float32(accel.BOX_PAD_REL) * np.float32(3.0) + np.float32(accel.BOX_PAD_ABS)
    want = np.array([[1.0 - pad, -2.0 - pad, -pad, 3.0 + pad, -1.0 + pad, pad]], np.float32)
    np.testing.assert_allclose(b[:, :6].numpy(), want, rtol=1e-6)
    kappa = accel.HIT_SLACK * 0.25
    h = 0.5 * float(np.linalg.norm(want[0, 3:] - want[0, :3]))
    assert float(b[0, 6]) >= kappa and float(b[0, 7]) >= kappa * h
    np.testing.assert_allclose(b[0, 6:].numpy(), [kappa, kappa * h], rtol=1e-5)
    # a ray from 1 past the box's centre on x along +y misses the padded box,
    # and crosses it widened by kappa * (|o - c|_1 + h)
    o = torch.tensor([[3.0 + 1.0, -3.0, 0.0]])
    inv = accel.inv_dir(torch.tensor([[0.0, 1.0, 0.0]]))
    mag = torch.tensor([4.0])
    assert not bool(accel.tight_segment_box_test(o, inv, mag, b)[0, 0])
    assert bool(accel.segment_box_test(o, inv, mag, b)[0, 0])
    tris = scenes.get("bunny").build("cpu").triangles
    glo, ghi, boxes = accel.group_boxes(tris)
    e = (torch.linalg.vector_norm((tris.v1 - tris.v0).double(), dim=1)
         * torch.linalg.vector_norm((tris.v2 - tris.v0).double(), dim=1))
    assert boxes.shape == (glo.shape[0], accel.BOX_COLS)
    assert bool((boxes[:, 6].double() >= accel.HIT_SLACK * e[::accel.GROUP]).all())


@pytest.mark.cuda
def test_k4_and_k11b_match_plain_versions_on_the_card():
    """K4 on bunny50k's and bunny's shadow queries at 160x128 and 50x37
    equal to its plain version on every (light, ray) pair, and K11b's image
    equal to K2b's bit for bit.
    Run on a machine with a card with
    ``pytest -m cuda tests/test_torch_shadow_boxes.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from raytpu_torch.render import mega2, mega3

    dev = torch.device("cuda")
    for name in ("bunny50k", "bunny"):
        scene = scenes.get(name).build(dev)
        blobs = packed.soft_packs(scene)
        for w, h in ((160, 128), (50, 37)):
            cfg = RenderConfig(width=w, height=h)
            ro, rd = renderer.generate_rays(scene.camera, cfg)
            if w % 32 == 0 and h % 32 == 0:
                rd = packed.mega2_fold(rd, h, w)
            ro = ro.expand_as(rd).contiguous()
            t, _, normal, mat = packed.scene_min_t_mega2(scene, ro, rd, TMIN)
            rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
            p, dirs, mags = (x.contiguous() for x in renderer.shadow_query_inputs(scene, rec, cfg))
            before = packed.PACKED_ANYHIT_LAUNCHES
            occ = packed.any_hit_lights_mega2(scene, p, dirs, mags, TMIN)
            assert packed.PACKED_ANYHIT_LAUNCHES == before + 1
            want = packed.any_hit_lights_plain(p, dirs, mags, *blobs, TMIN)
            assert int((occ != want).sum()) == 0
            img = mega3.render_image_mega3_f32(scene, cfg)
            assert torch.equal(img, mega2.render_image_mega2_f32(scene, cfg))
