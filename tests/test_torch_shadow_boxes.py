"""The group-box tests of the group walk (``render/csrc/shadow.cuh``),
through their torch twins in ``ops/accel.py``, for its four kinds of query
and box record: kappa (``packed.shadow_records``, K4 and K11b), cone
(``accel.normal_boxes``, the normal records of K10, K9 and K2b), soft
(``accel.normal_boxes`` with beta, K5) and closest (K3's and K11a's
``accel.normal_boxes``, tested up to each ray's current closest hit).

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
bit.  The normal records narrow that widening by a bound of each ray's
determinant (never past kappa's); the soft records must pass every group
holding a triangle whose soft factor ``1 - occ`` is not exactly 1.0f, so
that K5's product equals the walk over every listed group bit for bit.
The closest walk skips a group only where the ray's segment up to its
current closest hit misses the group's record widened for the ray: every
group holding a hit of the plain triangle test at t must pass the test
with mag = t (then it passes for every current t above it), and a torch
twin of the walk (groups ascending, the strict < update) must equal
``packed.winner_search_plain`` bit for bit on grazing, adversarial and
scene rays, and raytpu's ``scene_min_t_mega2`` (interpret mode, in a
worker process started with the module) within the tolerance of
tests/test_torch_bigmesh.py: the same winner on every ray, t within 1e-6
relative, the normal within 1e-6.  The tests marked ``cuda`` hold K4,
K11b, K3 and K11a against their plain versions on a card (``pytest -m
cuda tests/test_torch_shadow_boxes.py``).
"""

import functools

import numpy as np
import pytest
import torch
import torch_jobs

from raytpu_torch.core import scenes
from raytpu_torch.core.types import RenderConfig, Triangles
from raytpu_torch.ops import accel
from raytpu_torch.render import chunked, mega2, packed, plain, renderer, soft

torch.set_num_threads(2)

TMIN = RenderConfig().ray_min
BETA = RenderConfig().soft_beta
#: the box records: K4's and K11b's (kappa), K10's normal records (cone),
#: K5's (soft), K3's and K11a's (closest: the normal records too, tested up
#: to each ray's current closest hit)
KINDS = ("kappa", "cone", "soft", "closest")
#: the kinds whose worklists list 128-triangle chunks: K10's (cone) and K9's
CHUNKED_KINDS = ("cone", "k9")
#: the scene rays: camera rays at this size, each 1024-ray tile walking its
#: closest-hit worklist
SCENE_SIZE = (64, 48)
#: raytpu's reference compiles at XLA's lowest backend optimization level
FAST_COMPILE = {"xla_backend_optimization_level": 0}
_JOBS = {}


def _boxes(tris, kind):
    """(glo, ghi, boxes) of ``kind`` for the triangles ``tris``."""
    glo, ghi, boxes = accel.normal_boxes(tris, soft_beta=BETA if kind == "soft" else None)
    return glo, ghi, packed.shadow_records(boxes) if kind == "kappa" else boxes


# -- raytpu's winner search, computed in a worker process ----------------------


def _raytpu_closest(name):
    """raytpu's ``scene_min_t_mega2`` with its payload (its Pallas kernel in
    interpret mode) on ``name``'s camera rays at SCENE_SIZE, as numpy."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytpu.core import types as jtypes
    from raytpu.render import pallas_soft
    from raytpu_torch.core import convert

    scene, ro, rd, _, _ = _camera_rays(name)
    arrays = convert.scene_to_arrays(scene)
    js = jtypes.Scene(**{g: getattr(jtypes, cls.__name__)(**{
        f.name: jnp.asarray(arrays[f"{g}.{f.name}"]) for f in dataclasses.fields(cls)})
        for g, cls in convert.GROUPS.items()})
    o, d = jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())
    fn = jax.jit(lambda s, o, d: pallas_soft.scene_min_t_mega2(s, o, d, TMIN, payload=True))
    out = fn.lower(js, o, d).compile(compiler_options=FAST_COMPILE)(js, o, d)
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module", autouse=True)
def _raytpu_jobs(request):
    """Submit raytpu's winner searches to worker processes as the module
    starts (the port-only tests run meanwhile), unless no selected test of
    the module needs them; stop the workers when it ends."""
    mine = [i for i in request.session.items if i.module is request.module]
    if not any("matches_raytpu" in i.name for i in mine):
        yield
        return
    ex = torch_jobs.pool(2)
    _JOBS.update({name: ex.submit(_raytpu_closest, name) for name in ("optional", "bunny")})
    try:
        yield
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
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
    seg = accel.segment_box_test(p[rays], inv[rays], mag[rays], boxes[groups], d=d[rays])[:, col]
    assert bool(seg[hits].all()), "the per-ray box test rejected a group that a ray hits"
    culled = want & ~live
    culled[rays] = (hits & seg).any(dim=1)
    assert torch.equal(culled, want)
    hit_groups = torch.zeros((R, groups.numel()), dtype=torch.bool)
    hit_groups[rays] = torch.zeros((rays.numel(), groups.numel())).index_add_(
        1, col, hits.float()) > 0
    _check_bundles(p, d, mag, live, boxes[groups], hit_groups)
    return want


def _check_bundles(p, d, mag, live, boxes, need):
    """Each 32 consecutive queries a bundle (padding queries not live): the
    bundle test passes every group that ``need`` (R, groups) asks of one of
    its queries."""
    pad = (-p.shape[0]) % 32

    def bundles(x, fill):
        return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)]).reshape(-1, 32, *x.shape[1:])

    q = accel.bundle_bounds(bundles(p, 0.0), bundles(accel.inv_dir(d), 1.0), bundles(mag, 0.0),
                            bundles(live, False), d=bundles(d, 0.0))
    passed = accel.bundle_box_test(*q[:5], boxes, *q[5:])  # (bundles, groups)
    assert bool(passed[bundles(need, False).any(dim=1)].all()), \
        "the bundle test rejected a group that a ray of the warp needs"


def _factors(tri, p, d, mag):
    """(R, T) float32 soft factors ``1 - occ`` of plain ``tri_soft`` (K5's
    arithmetic), in plain's chunks of triangles."""
    o3 = tuple(x[:, None] for x in p.unbind(1))
    d3 = tuple(x[:, None] for x in d.unbind(1))
    return torch.cat([1.0 - soft._tri_soft(soft._rows(tri[a:b], 13), o3, d3, TMIN, mag[:, None],
                                           BETA)[0]
                      for a, b in plain._tri_chunks(tri.shape[0], p.shape[0], p.device)], dim=1)


def _soft_walk(factors, passed):
    """K5's product over triangles in their order, as its soft visit forms
    it: each ray multiplies the factors of the triangles ``passed`` lets it
    visit, one at a time."""
    tr = torch.ones(factors.shape[0])
    for k in range(factors.shape[1]):
        tr = torch.where(passed[:, k], tr * factors[:, k], tr)
    return tr


def _check_soft(tri, tri_ids, p, d, mag, boxes):
    """The soft records against the soft factors of the triangles
    ``tri_ids`` (ascending) for the queries: every group holding a factor
    other than exactly 1.0f passes the per-ray and the bundle test, so the
    twin of K5's walk with the per-ray test equals, bit for bit, the walk
    over every listed triangle.  Returns the (R, n) factors."""
    if tri_ids.numel() == 0:
        return torch.ones((p.shape[0], 0))
    f = _factors(tri[tri_ids], p, d, mag)
    groups, col = torch.unique(tri_ids // accel.GROUP, return_inverse=True)
    seg = accel.segment_box_test(p, accel.inv_dir(d), mag, boxes[groups], d=d)[:, col]
    assert bool(seg[f != 1.0].all()), "the soft test rejected a group whose factor is not 1"
    assert torch.equal(_soft_walk(f, seg), _soft_walk(f, torch.ones_like(seg)))
    need = torch.zeros((p.shape[0], groups.numel())).index_add_(1, col, (f != 1.0).float()) > 0
    _check_bundles(p, d, mag, torch.ones(p.shape[0], dtype=torch.bool), boxes[groups], need)
    return f


def _closest_t(tri, ro, rd):
    """(R, T) float32: t of the plain closest-hit triangle test (culling
    not inverted, [TMIN, inf)), inf where it reports no hit, in plain's
    chunks of triangles."""
    o3 = tuple(x[:, None] for x in ro.unbind(1))
    d3 = tuple(x[:, None] for x in rd.unbind(1))
    return torch.cat([plain.tri_t(plain._rows(tri[a:b], 13), o3, d3, TMIN, plain.INF,
                                  shadow=False)
                      for a, b in plain._tri_chunks(tri.shape[0], ro.shape[0], ro.device)], dim=1)


def _check_closest(tri, tri_ids, ro, rd, boxes):
    """The closest walk's box tests against the plain triangle test of the
    triangles ``tri_ids`` (ascending): every group holding a hit at t of
    some ray passes that ray's test with mag = t (``segment_box_test``;
    the test can only pass more as mag grows, so a group is never skipped
    while the ray's current t lies above its hit, and no group that the
    test rejects for [0, t_final] holds a t below t_final), and the bundle
    test of each 32 consecutive rays, with each ray's t_final, passes the
    group of each ray's winner.  Returns the (ray, group) hits that the
    padded box, without the widening, misses at mag = t: the widening is
    needed where that count is not 0."""
    t = _closest_t(tri[tri_ids], ro, rd)
    groups, col = torch.unique(tri_ids // accel.GROUP, return_inverse=True)
    tg = torch.full((ro.shape[0], groups.numel()), float("inf")).scatter_reduce(
        1, col.expand(ro.shape[0], -1), t, "amin")
    r, gi = torch.nonzero(torch.isfinite(tg), as_tuple=True)
    inv = accel.inv_dir(rd)
    args = (ro[r][:, None], inv[r][:, None], tg[r, gi][:, None])
    own = boxes[groups[gi]][:, None]
    assert bool(accel.segment_box_test(*args, own, d=rd[r][:, None]).all()), \
        "the closest walk's box test rejected a group holding a hit below the ray's t"
    t_final = tg.amin(dim=1)
    _check_bundles(ro, rd, t_final, torch.ones(ro.shape[0], dtype=torch.bool), boxes[groups],
                   tg == t_final[:, None])
    return int((~accel.tight_segment_box_test(*args, own)).sum())


def _closest_walk(sph, pln, tri, ro, rd, boxes, groups):
    """The torch twin of K3's and K11a's closest walk (shadow.cuh:
    ClosestVisit through group_walk) for rays ``ro``, ``rd`` (R, 3) over
    the groups ``groups`` (ascending): spheres and planes folded first
    (``plain.closest_plain``), then each group whose record, widened for
    the ray, its segment up to its current closest hit crosses
    (``segment_box_test`` with mag = the current t), its triangles in order
    with the strict < update.  Returns ``(t, idx)`` as
    ``plain.closest_plain`` does and the (ray, group) visits."""
    S, P, T = sph.shape[0], pln.shape[0], tri.shape[0]
    t, idx = plain.closest_plain(sph, pln, tri[:0], ro.unbind(1), rd.unbind(1), TMIN)
    inv = accel.inv_dir(rd)
    visits = 0
    for g in groups.tolist():
        live = accel.segment_box_test(ro, inv, t, boxes[g:g + 1], d=rd)[:, 0]
        visits += int(live.sum())
        k0 = g * accel.GROUP
        tc = torch.where(live[:, None], _closest_t(tri[k0:k0 + accel.GROUP], ro, rd), plain.INF)
        m, j = tc.min(dim=1)  # the first minimum: the strict < fold in order
        better = m < t
        t = torch.where(better, m, t)
        idx = torch.where(better, S + P + k0 + j, idx)
    return t, idx, visits


def _closest_rays(name, rays):
    """``(scene, ro, rd, rows)`` of ``name``'s ``rays``: "grazing" and
    "adversarial" (``_scene_rays``, as closest-hit rays: their segment
    lengths dropped) each walking every group of the scene, "scene" its
    camera rays at SCENE_SIZE (``_camera_rays``) each tile walking its
    worklist, "chunks" the same rays each tile walking K8's worklist of
    128-triangle chunks, each chunk expanded to its 16 groups in ascending
    order (K8's closest walk, kExpand 16); ``rows`` lists (ray slice,
    groups in the walk's order)."""
    if rays == "scene":
        scene, ro, rd, wl, cnt = _camera_rays(name)
        rows = [(slice(i * 1024, (i + 1) * 1024), wl[i, :cnt[i]].long().sort().values)
                for i in range(wl.shape[0])]
        return scene, ro, rd, rows
    if rays == "chunks":
        scene, ro, rd, _, _ = _camera_rays(name)
        wl, cnt = packed.closest_worklists(scene, ro, rd, TMIN, group=chunked.CHUNK)
        T = scene.triangles.count
        rows = [(slice(i * 1024, (i + 1) * 1024), accel.chunk_groups(wl[i, :cnt[i]], T))
                for i in range(wl.shape[0])]
        assert all(bool((g[1:] > g[:-1]).all()) for _, g in rows)  # ascending, as walked
        return scene, ro, rd, rows
    scene, tri, _, grazing, adversarial = _scene_rays(name)
    p, d = (grazing if rays == "grazing" else adversarial)[:2]
    return scene, p, d, [(slice(None), torch.arange(-(-tri.shape[0] // accel.GROUP)))]


def _twin_answers(name, rays):
    """The twin walk's ``(t, idx, normal, material)`` on ``name``'s
    ``rays``, with the payload formed as K3 forms it
    (``packed.winner_payload``), the plain version's, and the share of
    (ray, listed group) pairs the twin visited."""
    scene, ro, rd, rows = _closest_rays(name, rays)
    sph, pln, tri = packed.soft_packs(scene)
    boxes = _boxes(scene.triangles, "closest")[2]
    t = torch.empty(ro.shape[0])
    idx = torch.empty(ro.shape[0], dtype=torch.long)
    visits = listed = 0
    for sl, groups in rows:
        t[sl], idx[sl], v = _closest_walk(sph, pln, tri, ro[sl], rd[sl], boxes, groups)
        visits += v
        listed += groups.numel() * ro[sl].shape[0]
    got = packed.winner_payload(ro, rd, sph, pln, tri, t, idx)
    return got, packed.winner_search_plain(ro, rd, sph, pln, tri, TMIN), visits / listed


def _first_hit_walk(sph, pln, tri, p, d, mag, boxes, groups):
    """The torch twin of K8's first-occluder walk (shadow.cuh: FirstHitVisit
    through group_walk) for queries ``p``, ``d`` (R, 3) up to ``mag`` (R,)
    over the groups ``groups`` in the walk's order: the first occluder among
    spheres, then planes (``plain.chunked_min_t_plain`` without triangles),
    then, for a query still unoccluded, each group whose record, widened for
    it, its segment crosses, its triangles in order, stopping at the first
    that tri_t reports.  Returns the occluder's t (inf where none) and the
    (query, group) visits."""
    t = plain.chunked_min_t_plain(p, d, mag, sph, pln, tri[:0], TMIN, True)[0]
    inv = accel.inv_dir(d)
    o3 = tuple(x[:, None] for x in p.unbind(1))
    d3 = tuple(x[:, None] for x in d.unbind(1))
    visits = 0
    for g in groups.tolist():
        live = (t == plain.INF) & accel.segment_box_test(p, inv, mag, boxes[g:g + 1], d=d)[:, 0]
        visits += int(live.sum())
        k0 = g * accel.GROUP
        tc = plain.tri_t(plain._rows(tri[k0:k0 + accel.GROUP], 13), o3, d3, TMIN, mag[:, None],
                         shadow=True)
        found = tc < plain.INF
        first = tc.gather(1, found.to(torch.int8).argmax(dim=1, keepdim=True))[:, 0]
        t = torch.where(live & found.any(dim=1), first, t)
    return t, visits


@functools.lru_cache(maxsize=None)
def _camera_rays(name, size=SCENE_SIZE, tiles=None):
    """``name``'s scene, the packed route's camera rays ``ro``, ``rd`` at
    ``size`` (32x32 blocks when they fit) in the 1024-ray ``tiles`` given,
    or in all, and their closest-hit worklists ``wl``, ``cnt``.  The shadow
    and the closest cases share them."""
    scene = scenes.get(name).build("cpu")
    cfg = RenderConfig(width=size[0], height=size[1])
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    if cfg.width % 32 == 0 and cfg.height % 32 == 0:
        rd = packed.mega2_fold(rd, cfg.height, cfg.width)
    ro = ro.expand_as(rd).contiguous()
    if tiles is not None:
        rays = (torch.as_tensor(tiles)[:, None] * 1024 + torch.arange(1024)).flatten()
        ro, rd = ro[rays], rd[rays]
    return (scene, ro, rd, *packed.closest_worklists(scene, ro, rd, TMIN))


@functools.lru_cache(maxsize=None)
def _tile_queries(name, size, tiles=None, misses=False):
    """``name``'s scene and the shadow queries ``(p, dirs, mags)`` of the
    packed route's camera rays at ``size`` in the 1024-ray ``tiles`` given,
    or in all (``_camera_rays``), the closest hit over the triangles their
    worklists list.  Each kind's cases share them.  With ``misses`` (K9's
    case; the registry scenes' rooms leave no camera ray without a hit) the
    rays of the frame's top right corner, x >= 5/8 W and y < H/3, are taken
    as misses, t = inf and no normal, as K8 reports them: their queries
    start at the camera, as ``shade_rays``' do, and the warps on the
    corner's left edge mix them with surface hits."""
    scene, ro, rd, wl, cnt = _camera_rays(name, size, tiles)
    cfg = RenderConfig(width=size[0], height=size[1])
    sph, pln, tri = packed.soft_packs(scene)
    ids = _listed(wl, cnt, tri.shape[0])
    t, _, normal, mat = packed.winner_search_plain(ro, rd, sph, pln, tri[ids], TMIN)
    if misses:
        pix = torch.arange(ro.shape[0])
        miss = (pix % size[0] >= size[0] * 5 // 8) & (pix // size[0] < size[1] // 3)
        t = torch.where(miss, plain.INF, t)
        normal = torch.where(miss[:, None], 0.0, normal)
    rec = packed.hit_records_from_payload(ro, rd, t, normal, mat)
    return (scene, *renderer.shadow_query_inputs(scene, rec, cfg))


def _worklists(scene, p, dirs, mags, kind, glo, ghi):
    """The queries' shadow worklists as each kind's kernel gets them: K4's
    and K11b's of 8-triangle groups, K10's and K9's of 128-triangle chunks,
    K5's soft ones, K2b's of 8-triangle groups from each tile's box of
    shadow origins (``mega2.shadow_worklists``, the boxes as K2a forms
    them)."""
    if kind == "soft":
        return soft.soft_worklists(scene, p, dirs, mags, TMIN, BETA, group_bounds=(glo, ghi))
    if kind == "k2b":
        assert p.shape[0] % 1024 == 0  # whole tiles
        tiles = p.reshape(-1, 1024, 3)
        return mega2.shadow_worklists(scene, RenderConfig(), torch.cat(
            [tiles.amin(dim=1), tiles.amax(dim=1)], dim=1), (glo, ghi))
    group = chunked.CHUNK if kind in CHUNKED_KINDS else accel.GROUP
    return packed.shadow_worklists(scene, p, dirs, mags, TMIN, group=group,
                                   group_bounds=(glo, ghi))


def _listed(wl, cnt, T, group=accel.GROUP):
    """The triangle ids of every entry the worklist rows list, ascending:
    of each group, or with ``group`` = 128 of each chunk's groups as K10
    expands them (``accel.chunk_groups``)."""
    used = torch.arange(wl.shape[-1]) < cnt[..., None]
    g = torch.unique(wl[used].long())
    if group != accel.GROUP:
        g = accel.chunk_groups(g, T, group)
    return (g[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten().clamp(max=T - 1).unique()


def _check_frame(name, size, kind, tiles=None, warps=range(32)):
    """``_check_queries`` (``_check_soft`` for the soft records) on
    ``name``'s queries at ``size`` (the 1024-ray ``tiles`` given, or all),
    those of each tile's ``warps`` (the kernels' warps,
    ``accel.warp_slots``) against the triangles of their shadow worklist
    rows, which the kernels walk: no shadow ray of the tile reaches another
    (the glue's cull is conservative).  Returns the (L, R) occlusion, or
    for the soft records whether a factor is not 1, False for the queries
    not checked."""
    scene, p, dirs, mags = _tile_queries(name, size, tiles, misses=kind == "k9")
    sph, pln, tri = packed.soft_packs(scene)
    glo, ghi, boxes = _boxes(scene.triangles, kind)
    wl, cnt = _worklists(scene, p, dirs, mags, kind, glo, ghi)
    group = chunked.CHUNK if kind in CHUNKED_KINDS else accel.GROUP
    # the kernels' warps: K9's take 32 consecutive queries, the others'
    # the 8x4 pixel blocks of warp_slot
    slots = torch.arange(1024).reshape(32, 32) if kind == "k9" else accel.warp_slots()
    out = torch.zeros((dirs.shape[0], p.shape[0]), dtype=torch.bool)
    for ti in range(wl.shape[0]):
        r = ti * 1024 + slots[list(warps)].flatten()
        r = r[r < p.shape[0]]
        for li in range(dirs.shape[0]):
            ids = _listed(wl[ti, li], cnt[ti, li], tri.shape[0], group)
            if kind == "soft":
                out[li, r] = (_check_soft(tri, ids, p[r], dirs[li, r], mags[li, r], boxes)
                              != 1.0).any(dim=1)
            else:
                out[li, r] = _check_queries(sph, pln, tri, ids, p[r], dirs[li, r], mags[li, r],
                                            boxes)
    return out


@pytest.mark.parametrize("name,kind", [("bunny", "kappa"), ("optional", "kappa"),
                                       ("bunny", "cone"), ("optional", "cone"),
                                       ("bunny", "soft"), ("bunny", "k2b"), ("bunny", "k9")])
def test_box_test_passes_every_hit_at_64x48(name, kind):
    """Every shadow query of the frame against every triangle its (tile,
    light) worklist lists, which K4 and K11b (kappa), K10 (cone, 128-triangle
    chunks) and K5 (soft) walk; and the normal records over K2b's worklists
    of 8-triangle groups (k2b), and over K9's of 128-triangle chunks on the
    frame's row-major queries with camera-origin misses, its warps 32
    consecutive queries (k9): the twin of each walk's occlusion equals the
    plain any-hit over every listed triangle, bit for bit."""
    got = _check_frame(name, (64, 48), kind)
    assert bool(got.any()) and not bool(got.all())


def test_box_test_passes_every_hit_on_bunny50k_tiles():
    """640x480 tiles of bunny50k, as above, the queries of a few warps."""
    got = _check_frame("bunny50k", (640, 480), "kappa", BUNNY50K_TILES, BUNNY50K_WARPS)
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


@functools.lru_cache(maxsize=None)
def _scene_rays(name):
    """``name``'s scene, its triangle records, kappa's records, and the
    grazing and the adversarial rays against them: each kind's cases share
    them."""
    scene = scenes.get(name).build("cpu")
    _, _, tri = packed.soft_packs(scene)
    glo, ghi, boxes = accel.normal_boxes(scene.triangles)
    kappa = packed.shadow_records(boxes)
    return (scene, tri, kappa, _grazing_rays(tri, kappa, np.random.default_rng(11), 4096),
            _adversarial_rays(tri, glo, ghi, np.random.default_rng(7)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_box_test_passes_every_hit_of_grazing_rays(name, kind):
    """Rays that graze a triangle's plane (``_grazing_rays``): tri_t's hit
    point may lie far off the segment there, and the per-ray widening of the
    box (``accel.shadow_boxes``) must still take in every hit.  Some of
    these hits lie outside the padded box without the widening, so the
    check has teeth.  The normal records never widen past kappa's; the soft
    records pass every group whose soft factor is not 1; the closest
    records pass every group holding a closest-hit t below the ray's
    current t (``_check_closest``), and here too some of those hits lie
    outside the padded box."""
    scene, tri, kappa, (p, d, mag, k), _ = _scene_rays(name)
    boxes = _boxes(scene.triangles, kind)[2]
    groups = torch.unique(k // accel.GROUP)
    ids = (groups[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten()
    ids = ids[ids < tri.shape[0]]
    if kind == "closest":
        assert _check_closest(tri, ids, p, d, boxes) > 0
        return
    if kind == "soft":
        assert bool((_check_soft(tri, ids, p, d, mag, boxes) != 1.0).any())
        return
    hit = plain.tri_t(tuple(tri[k, c] for c in range(13)), p.unbind(1), d.unbind(1), TMIN, mag,
                      shadow=True) < plain.INF
    own = boxes[k // accel.GROUP][:, None]
    tight = accel.tight_segment_box_test(p[:, None], accel.inv_dir(d)[:, None], mag[:, None],
                                         own)[:, 0, 0]
    assert int((hit & ~tight).sum()) > 0
    empty = torch.zeros((0, packed.SP_COLS))
    occ = _check_queries(empty, empty, tri, ids, p, d, mag, boxes)
    assert bool(occ[hit].all())
    if kind == "cone":  # never wider than kappa's widening
        inv = accel.inv_dir(d)
        wide = accel.segment_box_test(p, inv, mag, kappa[groups])
        assert bool((wide | ~accel.segment_box_test(p, inv, mag, boxes[groups], d=d)).all())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_box_test_passes_every_hit_of_adversarial_rays(name, kind):
    """The adversarial rays against every triangle of the scene; the normal
    records narrow the widening for most of them (the check has teeth) and
    never past kappa's; for the closest records, as closest-hit rays."""
    scene, tri, _, _, (p, d, mag) = _scene_rays(name)
    empty = torch.zeros((0, packed.SP_COLS))
    boxes = _boxes(scene.triangles, kind)[2]
    every = torch.arange(tri.shape[0])
    if kind == "closest":
        _check_closest(tri, every, p, d, boxes)
        return
    if kind == "soft":
        assert bool((_check_soft(tri, every, p, d, mag, boxes) != 1.0).any())
        return
    occ = _check_queries(empty, empty, tri, every, p, d, mag, boxes)
    assert int(occ.sum()) > p.shape[0] // 2
    if kind == "cone":
        inv = accel.inv_dir(d)
        narrow = accel.segment_box_test(p, inv, mag, boxes, d=d)
        assert bool((accel.segment_box_test(p, inv, mag, boxes[:, :8]) | ~narrow).all())
        assert float(accel.narrowed(d, boxes).float().mean()) > 0.5


def _margin_rays(tri, rng, m, support=accel.SOFT_SUPPORT):
    """(p, d, mag) of ``m`` rays that cross the plane of a random triangle
    at a point whose least barycentric coordinate is -f ``support`` / beta,
    f from 0.5 to 1.5: at SOFT_SUPPORT the soft factor is not 1 below f ~
    0.87, and exactly 1 above it; at GRAD_SUPPORT the soft VJP's partials
    are not all 0 below f ~ 0.99, and all 0 above it.  The rays meet the
    plane at 0 to 80 degrees from its normal, from 0.05 to 2 away, and end
    as far past it."""
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    k = torch.as_tensor(rng.integers(0, tri.shape[0], m))
    neg = -torch.as_tensor(rng.uniform(0.5, 1.5, m), dtype=torch.float32) * (support / BETA)
    share = torch.as_tensor(rng.random(m), dtype=torch.float32) * (1.0 - neg)
    lam = torch.stack([neg, share, 1.0 - neg - share], dim=1)
    perm = torch.as_tensor(np.argsort(rng.random((m, 3)), axis=1))
    lam = torch.gather(lam, 1, perm)  # the negative coordinate on a random vertex
    x = v0[k] + lam[:, 1:2] * e1[k] + lam[:, 2:3] * e2[k]
    n = torch.nn.functional.normalize(torch.linalg.cross(e1[k], e2[k], dim=1), dim=1)
    side = torch.nn.functional.normalize(torch.linalg.cross(n, torch.as_tensor(
        rng.normal(size=(m, 3)), dtype=torch.float32), dim=1), dim=1)
    ang = torch.as_tensor(rng.uniform(0.0, np.radians(80.0), m), dtype=torch.float32)
    d = torch.nn.functional.normalize(n * torch.cos(ang)[:, None]
                                      + side * torch.sin(ang)[:, None], dim=1)
    dist = torch.as_tensor(10.0 ** rng.uniform(np.log10(0.05), np.log10(2.0), m),
                           dtype=torch.float32)
    return x - d * dist[:, None], d, 2.0 * dist


def _slivers(rng, n=64):
    """Triangle records (n, 14) of slivers: an edge of 0.5 to 2 and a third
    vertex 1e-4 to 1e-2 off it, near its middle or near an end, culling
    none, scattered in a 4-unit cube; and their Triangles."""
    v0 = torch.as_tensor(rng.uniform(-2.0, 2.0, (n, 3)), dtype=torch.float32)
    edge = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(n, 3)),
                                                         dtype=torch.float32), dim=1)
    edge = edge * torch.as_tensor(rng.uniform(0.5, 2.0, (n, 1)), dtype=torch.float32)
    off = torch.nn.functional.normalize(torch.linalg.cross(edge, torch.as_tensor(
        rng.normal(size=(n, 3)), dtype=torch.float32), dim=1), dim=1)
    at = torch.as_tensor(rng.choice([0.02, 0.5, 0.98], (n, 1)), dtype=torch.float32)
    thin = torch.as_tensor(10.0 ** rng.uniform(-4.0, -2.0, (n, 1)), dtype=torch.float32)
    v1, v2 = v0 + edge, v0 + at * edge + thin * off
    normal = torch.nn.functional.normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=1), dim=1)
    zeros = torch.zeros(n, dtype=torch.int32)
    tris = Triangles(v0=v0, v1=v1, v2=v2, normal=normal, cull=zeros + 2, material=zeros)
    rec = torch.cat([v0, v1 - v0, v2 - v0, normal, torch.full((n, 1), 2.0),
                     torch.zeros((n, 1))], dim=1)
    return rec, tris


@pytest.mark.parametrize("name", ["bunny", "slivers"])
def test_soft_records_pass_every_factor_below_one(name):
    """Rays crossing triangles' planes just inside and just outside the
    sigmoid's support (``_margin_rays``), on bunny and on sliver triangles:
    every group holding a soft factor other than exactly 1.0f passes both
    soft tests, so K5's walk twin with the per-ray test equals the walk over
    every listed triangle bit for bit.  Some of those factors belong to
    groups whose padded box, without the soft padding and the widening,
    the segment misses: the padding is needed."""
    rng = np.random.default_rng(5)
    if name == "slivers":
        tri, tris = _slivers(rng)
    else:
        scene = scenes.get(name).build("cpu")
        tri, tris = packed.soft_packs(scene)[2], scene.triangles
    boxes = accel.normal_boxes(tris, soft_beta=BETA)[2]
    p, d, mag = _margin_rays(tri, rng, 2048)
    f = _check_soft(tri, torch.arange(tri.shape[0]), p, d, mag, boxes)
    assert bool((f != 1.0).any()) and bool((f == 1.0).any())
    bare = accel.normal_boxes(tris)[2]
    seg = accel.tight_segment_box_test(p, accel.inv_dir(d), mag, bare)
    outside = (f != 1.0) & ~seg[:, torch.arange(tri.shape[0]) // accel.GROUP]
    assert int(outside.sum()) > 0


def test_cone_records_reduce_to_kappa():
    """The normal records' scale is exactly 1 (kappa's widening) for a ray
    parallel to one of the group's triangles, whose determinant is 0, and
    for every ray where a triangle is degenerate; across the folded group a
    ray narrows it far, and over a flat group the scale falls as the ray
    turns from the plane.  A bundle's scale is at least each of its rays'."""
    def record(verts):
        v = verts.reshape(-1, 3, 3)
        n = torch.nn.functional.normalize(torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                                                             dim=1), dim=1)
        zeros = torch.zeros(v.shape[0], dtype=torch.int32)
        tris = Triangles(v0=v[:, 0], v1=v[:, 1], v2=v[:, 2], normal=n, cull=zeros + 2,
                         material=zeros)
        boxes = accel.normal_boxes(tris)[2]
        assert boxes.shape == (1, accel.NORMAL_COLS)
        return boxes

    folded = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],  # z-facing
                           [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],  # y-facing
                           [2.0, 0.0, 0.0], [2.0, 1.0, 0.0], [2.0, 0.0, 1.0]])  # x-facing
    d = torch.tensor([[1.0, 0.0, 0.0], [0.6, 0.0, 0.8], [0.57735, 0.57735, 0.57735]])
    got = accel._ray_scale(record(folded), d)
    assert got[0] == 1.0 and got[1] == 1.0 and float(got[2]) < 1e-5
    degenerate = torch.cat([folded[3:], torch.tensor([[3.0, 0.0, 0.0], [4.0, 1.0, 1.0],
                                                      [3.0, 0.0, 0.0]])])
    assert bool((accel._ray_scale(record(degenerate), d) == 1.0).all())
    flat = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).repeat(3, 1) + (
        torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [1.0, 0.0, 0.0]]).repeat_interleave(3, 0))
    c = torch.linspace(0.0, 1.0, 11)
    turn = torch.stack([torch.sqrt(1.0 - c * c), torch.zeros(11), c], dim=1)
    boxes = record(flat)
    scale = accel._ray_scale(boxes, turn)
    assert float(scale[0]) == 1.0 and float(scale[-1]) < 1e-5
    assert bool((scale[1:] <= scale[:-1]).all())
    for a, b in ((1, 4), (4, 8), (8, 11)):
        bundle = accel._bundle_scale(boxes, turn[a:b].amin(dim=0), turn[a:b].amax(dim=0))
        assert bool((bundle >= scale[a:b]).all())


def test_chunk_groups_expand_every_listed_chunk():
    """K10's walk expands each listed 128-triangle chunk into its 16
    groups, in ascending order, dropping groups past the scene's end: the
    groups of a worklist row cover exactly the triangles of its chunks."""
    T = 1000  # 8 chunks, the last one of 104 triangles (13 groups)
    chunks = torch.tensor([0, 3, 7], dtype=torch.int32)
    g = accel.chunk_groups(chunks, T)
    assert bool((g[1:] > g[:-1]).all()) and g.numel() == 16 + 16 + 13
    tris = (g[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten()
    want = torch.cat([torch.arange(c * 128, min(c * 128 + 128, T)) for c in chunks.tolist()])
    assert torch.equal(tris[tris < T], want)
    scene = scenes.get("optional").build("cpu")
    glo, ghi = accel.chunk_bounds(scene.triangles, accel.GROUP)
    merged = accel.merge_bounds(glo, ghi, chunked.CHUNK // accel.GROUP)
    for a, b in zip(merged, accel.chunk_bounds(scene.triangles, chunked.CHUNK)):
        assert torch.equal(a, b)


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
    widening they give a ray: K4's and K11b's records (``packed.shadow_records``
    of ``accel.normal_boxes``) take |e1| |e2| per group."""
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
    glo, ghi, boxes = accel.normal_boxes(tris)
    boxes = packed.shadow_records(boxes)
    e = (torch.linalg.vector_norm((tris.v1 - tris.v0).double(), dim=1)
         * torch.linalg.vector_norm((tris.v2 - tris.v0).double(), dim=1))
    assert boxes.shape == (glo.shape[0], accel.BOX_COLS)
    assert bool((boxes[:, 6].double() >= accel.HIT_SLACK * e[::accel.GROUP]).all())


@pytest.mark.parametrize("name,rays", [
    ("bunny", "grazing"), ("bunny", "adversarial"), ("bunny", "scene"),
    ("optional", "grazing"), ("optional", "adversarial"), ("optional", "scene"),
    ("optional", "chunks")])
def test_closest_walk_twin_equals_plain_version(name, rays):
    """The twin of the closest walk (``_closest_walk``) against
    ``packed.winner_search_plain``: (t, idx, normal, material) equal bit
    for bit.  On the scene rays it visits a small share of the listed
    (ray, group) pairs: the test skips groups.  The chunks case walks K8's
    worklists of 128-triangle chunks, each expanded to its 16 groups."""
    got, want, share = _twin_answers(name, rays)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool(torch.isfinite(want[0]).any())
    if rays in ("scene", "chunks"):
        assert share < 0.5


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_closest_walk_twin_matches_raytpu(name):
    """The twin of the closest walk on the scene rays against raytpu's
    ``scene_min_t_mega2`` with its payload (interpret mode, in a worker):
    the same winner and material on every ray, t within 1e-6 relative, the
    normal within 1e-6 (tests/test_torch_bigmesh.py's K3 tolerance)."""
    (t, idx, normal, mat), _, _ = _twin_answers(name, "scene")
    t_r, idx_r, n_r, m_r = _JOBS[name].result()
    hit = np.isfinite(t_r)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(torch.isfinite(t).numpy(), hit)
    np.testing.assert_array_equal(idx.numpy()[hit], idx_r[hit])
    np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(normal.numpy(), n_r, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mat.numpy(), m_r)


@pytest.mark.parametrize("rays", ["grazing", "adversarial", "scene"])
def test_first_hit_walk_twin_equals_plain_shadow_mode(rays):
    """The twin of K8's first-occluder walk (``_first_hit_walk``) on
    optional's queries against the plain shadow mode
    (``plain.chunked_min_t_plain`` with ``shadow``): the first occluder's t
    equal bit for bit, inf where none.  The grazing and adversarial rays
    walk every group; the scene queries, every light's shadow rays of the
    64x48 frame's closest hits, walk K8's worklists of 128-triangle chunks
    (each chunk's 16 groups in order) and visit a small share of the listed
    (query, group) pairs."""
    scene, tri, _, grazing, adversarial = _scene_rays("optional")
    sph, pln, _ = packed.soft_packs(scene)
    boxes = _boxes(scene.triangles, "cone")[2]
    every = torch.arange(-(-tri.shape[0] // accel.GROUP))
    if rays == "scene":
        _, p, dirs, mags = _tile_queries("optional", SCENE_SIZE)
        L = dirs.shape[0]
        p, d, mag = p.repeat(L, 1), dirs.reshape(-1, 3), mags.reshape(-1)
        wl, cnt = packed.closest_worklists(scene, p, d, TMIN, mag, group=chunked.CHUNK)
        rows = [(slice(i * 1024, (i + 1) * 1024), accel.chunk_groups(wl[i, :cnt[i]], tri.shape[0]))
                for i in range(wl.shape[0])]
    else:
        p, d, mag = (grazing if rays == "grazing" else adversarial)[:3]
        rows = [(slice(None), every)]
    t = torch.empty(p.shape[0])
    visits = listed = 0
    for sl, groups in rows:
        t[sl], v = _first_hit_walk(sph, pln, tri, p[sl], d[sl], mag[sl], boxes, groups)
        visits += v
        listed += groups.numel() * p[sl].shape[0]
    want = plain.chunked_min_t_plain(p, d, mag, sph, pln, tri, TMIN, True)[0]
    assert torch.equal(t.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isfinite(want).any()) and not bool(torch.isfinite(want).all())
    if rays == "scene":
        assert visits < 0.5 * listed


def _bound_rays(tri, boxes, rng, m):
    """(p, d, mag, k) of the rays among ``m`` candidates that tri_t reports
    hitting triangle ``k``, made so that their hits need much of the normal
    records' widening: as ``_grazing_rays``' first kind, past the vertex
    holding the group's largest coordinate on a random axis, 1 to 4 pads
    beyond the padded face, in ``k``'s plane, but from 5 to 50 away and at
    a determinant that puts the group's a_lo (``accel._scale_of_least``)
    10 to 10^4 times 2u above kappa's ea, where the widening is narrowed by
    2u / a_lo.  tri_t's error there is a few hundredths of the bound for
    some of them: a bound 10^3 times too optimistic misses their hits."""
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    T = tri.shape[0]

    def unit(x):
        return torch.nn.functional.normalize(x, dim=1)

    def uniform(lo, hi, log=False):
        x = rng.uniform(np.log10(lo), np.log10(hi), m) if log else rng.uniform(lo, hi, m)
        return torch.as_tensor(10.0 ** x if log else x, dtype=torch.float32)

    g = torch.as_tensor(rng.integers(0, boxes.shape[0], m))
    ax = torch.as_tensor(rng.integers(0, 3, m))
    rows = torch.arange(m)
    ids = (g[:, None] * accel.GROUP + torch.arange(accel.GROUP)).clamp(max=T - 1)
    verts = torch.stack([v0[ids], v0[ids] + e1[ids], v0[ids] + e2[ids]], dim=2)
    top = verts[rows, :, :, ax].reshape(m, -1).argmax(dim=1)
    k = ids[rows, top // 3]
    vert, own = verts[rows, top // 3, top % 3], verts[rows, top // 3]
    normal = torch.linalg.cross(e1[k], e2[k], dim=1)
    n = unit(normal)
    out = unit(vert - own.mean(dim=1))
    pad = boxes[g, 3 + ax] - vert[rows, ax]
    target = vert + ((pad + uniform(1.0, 4.0) * pad) / out[rows, ax].clamp(min=0.05))[:, None] * out
    along = unit(torch.linalg.cross(n, out, dim=1)
                 + 0.3 * torch.as_tensor(rng.normal(size=(m, 1)), dtype=torch.float32) * out)
    a = boxes[g, 6] * accel.TRI_SLACK + accel.TWO_U * uniform(10.0, 1e4, log=True)
    sin = torch.clamp(a / torch.linalg.vector_norm(normal, dim=1), max=0.3)
    sgn = torch.as_tensor(rng.choice([-1.0, 1.0], m), dtype=torch.float32)
    d = unit(along * torch.sqrt(1.0 - sin * sin)[:, None] + (sgn * sin)[:, None] * n)
    dist = uniform(5.0, 50.0, log=True)
    p, mag = target - d * dist[:, None], 2.0 * dist
    hit = plain.tri_t(tuple(tri[k, c] for c in range(13)), p.unbind(1), d.unbind(1), TMIN, mag,
                      shadow=True) < plain.INF
    return p[hit], d[hit], mag[hit], k[hit]


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_normal_records_widen_enough_at_the_determinant_bound(name):
    """Rays whose hits need much of the normal records' narrowed widening
    (``_bound_rays``, a ray's determinant well above the grazing limit):
    every hit passes both box tests of its group (``_check_queries``), and
    some of them lie outside the box widened by a thousandth of the ray's
    widening (the records with kappa and kappa h scaled by 1e-3), so a
    bound of the determinant 10^3 times too optimistic fails this test."""
    scene, tri, _, _, _ = _scene_rays(name)
    boxes = _boxes(scene.triangles, "cone")[2]
    p, d, mag, k = _bound_rays(tri, boxes, np.random.default_rng(13), 100_000)
    groups = torch.unique(k // accel.GROUP)
    ids = (groups[:, None] * accel.GROUP + torch.arange(accel.GROUP)).flatten()
    empty = torch.zeros((0, packed.SP_COLS))
    occ = _check_queries(empty, empty, tri, ids[ids < tri.shape[0]], p, d, mag, boxes)
    assert bool(occ.all()) and p.shape[0] > 100
    thin = boxes[k // accel.GROUP].clone()
    thin[:, 6:8] *= 1e-3
    inv = accel.inv_dir(d)
    near = accel.segment_box_test(p[:, None], inv[:, None], mag[:, None], thin[:, None],
                                  d=d[:, None])[:, 0, 0]
    assert int((~near).sum()) > 0


def _grad_nonzero(tri, p, d, mag, g):
    """(R, T) bool: some of the nine partials of plain ``soft_dprim``
    (K7's arithmetic, ``soft._tri_soft`` and ``soft._tri_grad``) or of
    the six triangle partials of plain ``soft_dray`` (K6's: g_p, whose
    terms are K7's g_s, and g_dirs) for query r, triangle k and cotangent
    ``g`` (R,) (trans taken as 1) is not 0.0f, in plain's chunks of
    triangles."""
    o3 = tuple(x[:, None] for x in p.unbind(1))
    d3 = tuple(x[:, None] for x in d.unbind(1))
    out = []
    for a, b in plain._tri_chunks(tri.shape[0], p.shape[0], p.device):
        k = soft._rows(tri[a:b], 13)
        occ, docc, u, v, w, inv_a, h, s, q = soft._tri_soft(k, o3, d3, TMIN, mag[:, None], BETA)
        g_m = (-g)[:, None] / (1.0 - occ) * docc
        g_nu, g_nv, g_a = soft._tri_grad(u, v, w, inv_a, g_m)
        e1d = soft._cross3(k[3], k[4], k[5], *d3)
        ds = soft._cross3(*d3, *s)
        e2s = soft._cross3(k[6], k[7], k[8], *s)
        e21 = soft._cross3(k[6], k[7], k[8], k[3], k[4], k[5])
        parts = ([g_nu * h[c] + g_nv * e1d[c] for c in range(3)]
                 + [g_nv * ds[c] + g_a * h[c] for c in range(3)]
                 + [-g_nu * ds[c] + g_a * e1d[c] for c in range(3)]
                 + [g_nu * e2s[c] + g_nv * q[c] + g_a * e21[c] for c in range(3)])
        out.append(torch.stack(parts).ne(0.0).any(dim=0))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("name", ["bunny", "slivers", "grazing"])
def test_grad_records_pass_every_nonzero_partial(name):
    """The gradient records (``soft.grad_boxes``: ``accel.normal_boxes`` at
    ``accel.GRAD_SUPPORT``) against K7's and K6's plain partials: on rays
    crossing the triangles' planes just inside and just outside the
    gradient's support (``_margin_rays`` at GRAD_SUPPORT), on bunny and on
    sliver triangles, and on bunny's grazing rays, every (query, triangle)
    pair with a partial other than 0.0f passes the per-ray and the bundle
    test of its group, so K7's and K6's walks add every nonzero partial of
    the walk over every listed group.  On bunny some of those pairs lie
    outside K5's soft records (support 20): they would drop partials that
    are small but not 0."""
    rng = np.random.default_rng(17)
    if name == "slivers":
        tri, tris = _slivers(rng)
    else:
        scene = scenes.get("bunny").build("cpu")
        tri, tris = packed.soft_packs(scene)[2], scene.triangles
    if name == "grazing":
        p, d, mag = _scene_rays("bunny")[3][:3]
    else:
        p, d, mag = _margin_rays(tri, rng, 2048, accel.GRAD_SUPPORT)
    g = torch.as_tensor(rng.uniform(0.5, 1.0, p.shape[0]) * rng.choice([-1.0, 1.0], p.shape[0]),
                        dtype=torch.float32)
    nz = _grad_nonzero(tri, p, d, mag, g)
    assert bool(nz.any()) and not bool(nz.all())
    col = torch.arange(tri.shape[0]) // accel.GROUP
    inv = accel.inv_dir(d)
    boxes = accel.normal_boxes(tris, soft_beta=BETA, support=accel.GRAD_SUPPORT)[2]
    seg = accel.segment_box_test(p, inv, mag, boxes, d=d)[:, col]
    assert bool(seg[nz].all()), "a gradient record rejected a group holding a nonzero partial"
    need = torch.zeros((p.shape[0], boxes.shape[0])).index_add_(1, col, nz.float()) > 0
    _check_bundles(p, d, mag, torch.ones(p.shape[0], dtype=torch.bool), boxes, need)
    if name == "bunny":  # the slivers' groups span their whole cube
        soft_rec = accel.normal_boxes(tris, soft_beta=BETA)[2]
        outside = nz & ~accel.segment_box_test(p, inv, mag, soft_rec, d=d)[:, col]
        assert int(outside.sum()) > 0


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


@pytest.mark.cuda
def test_k3_and_k11a_match_plain_versions_on_the_card():
    """K3 on bunny50k's and bunny's camera rays at 160x128 and 50x37: the
    plain version's winner on >= 99.99% of rays, and its own launch over
    records that pass every group bit for bit; K11a's buffer and tile boxes
    equal K2a's and its own launch over open records, bit for bit.
    Run on a machine with a card with
    ``pytest -m cuda tests/test_torch_shadow_boxes.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from raytpu_torch.render import mega2, mega3

    dev = torch.device("cuda")
    for name in ("bunny50k", "bunny"):
        scene = scenes.get(name).build(dev)
        blobs = packed.soft_packs(scene)
        glo, ghi, records = accel.normal_boxes(scene.triangles)
        opened = accel.open_normal_boxes(records.shape[0], dev)[:, :records.shape[1]].contiguous()
        for w, h in ((160, 128), (50, 37)):
            cfg = RenderConfig(width=w, height=h)
            ro, rd = renderer.generate_rays(scene.camera, cfg)
            if w % 32 == 0 and h % 32 == 0:
                rd = packed.mega2_fold(rd, h, w)
            ro = ro.expand_as(rd).contiguous()
            wl, cnt = packed.closest_worklists(scene, ro, rd, TMIN, group_bounds=(glo, ghi))
            got = packed.winner_search(ro, rd, *blobs, records, wl, cnt, TMIN)
            every = packed.winner_search(ro, rd, *blobs, opened, wl, cnt, TMIN)
            want = packed.winner_search_plain(ro, rd, *blobs, TMIN)
            assert float((got[1] == want[1]).float().mean()) >= 0.9999
            for a, b in zip(got, every):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            buf, counts = plain.mega_pack(scene, cfg)
            blob = mega3.pack_groups(buf, counts)
            wl2, cnt2 = mega2.primary_worklists(scene, cfg, group_bounds=(glo, ghi))
            acc, bounds = mega3.mega3_closest(buf, counts, blob, records, wl2, cnt2, cfg)
            acc_o, bounds_o = mega3.mega3_closest(buf, counts, blob, opened, wl2, cnt2, cfg)
            acc2, bounds2 = mega2.mega2_closest(buf, counts, records, wl2, cnt2, cfg)
            for a, b in ((acc, acc2), (bounds, bounds2), (acc, acc_o), (bounds, bounds_o)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
